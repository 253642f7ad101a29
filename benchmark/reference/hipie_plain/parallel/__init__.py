"""The port's parallel helpers at one rank: the benchmark runs one process a card."""
