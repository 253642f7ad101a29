"""idle_share.serve (%): the share of the traced window in which nothing ran on
the card: 100 x (1 - union of the device's kernel, copy and memset intervals /
the window), from torch.profiler over the whole window (harness/trace.py): the
same arithmetic as the result's ``device`` fields busy_s and window_s."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
