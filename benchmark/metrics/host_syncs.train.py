"""host_syncs.train (syncs/step): the matchers' host convergence checks per
step (``hipie_torch.losses.matcher.HOST_SYNCS``, one device-to-host sync
each), counted over the traced window's steps."""


def read(run):
    n = run.counters.get("host_syncs")
    if n is None or not run.steps:
        return None
    return n / run.steps
