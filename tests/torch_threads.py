"""Torch's CPU thread pool under pytest-xdist: each worker takes its share of
the cores.

torch sizes its intra-op pool to all cores in every process. Six workers on
eight cores then run 48 busy-waiting OpenMP threads, and a CPU training step
that takes 2 s alone takes three minutes. The port's test files import this
module first; run alone, a file keeps torch's default.
"""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
THREADS = max(1, (os.cpu_count() or 1) // WORKERS) if WORKERS > 1 else None

if THREADS:
    torch.set_num_threads(THREADS)


def subprocess_env(env: dict) -> dict:
    """``env`` with OMP_NUM_THREADS set to this worker's share, for the
    interpreters a test starts."""
    return {**env, "OMP_NUM_THREADS": str(THREADS)} if THREADS else env
