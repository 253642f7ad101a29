"""Every blocking sync of a cell's request or step, against the program's
``host_sync.*`` counters (hipie_torch/utils/trace.py), on one card.

    python3 benchmark/sync_audit.py --workload vith_serve_coco,vith_train_coco [--seed 1]

For each cell: the program set up as the cell sets it up (``harness.serve``,
``harness.train``), warmed by one request or by a step on each pool batch,
then one request or one step under ``torch.cuda.set_sync_debug_mode("warn")``.
Each warning it gives is placed at the innermost frame of hipie_torch/ on the
stack when it was raised (warnings that C++ raises outside any Python call go
to standard error; they are counted there as "outside Python"). The counters'
growth over the same request or step is placed by ``SITES``. Prints both by
place, and one JSON line per cell; exits 1 when any place's counts differ. The
benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse                  # noqa: E402
import collections               # noqa: E402
import contextlib                # noqa: E402
import json                      # noqa: E402
import os                        # noqa: E402
import sys                       # noqa: E402
import tempfile                  # noqa: E402
import traceback                 # noqa: E402
import warnings                  # noqa: E402
from pathlib import Path         # noqa: E402

_BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(_BENCH), str(_BENCH / "reference"), str(_BENCH.parent)]

from harness import common, main, serve, traffic   # noqa: E402

# each counter's place: (file under hipie_torch/, function)
SITES = {
    "host_sync.normalize": ("models/hipie.py", "normalize"),
    "host_sync.proposal_wh": ("models/transformer.py", "two_stage_proposals"),
    "host_sync.msda_normalizer": ("models/msda_module.py", "forward"),
    "host_sync.nms_to_host": ("ops/nms.py", "nms_keep_mask"),
    "host_sync.nms_to_device": ("ops/nms.py", "nms_keep_mask"),
    "host_sync.matcher_done": ("losses/matcher.py", "_done"),
    "host_sync.auction_neg_inf": ("losses/matcher.py", "auction_assignment"),
    "host_sync.drop_path_rates": ("models/backbone/vit.py", "draw_drop_masks"),
    "host_sync.pos_resize": ("models/backbone/vit.py", "resize_abs_pos"),
}
OUTSIDE = ("(outside Python)", "")
MARK = "synchronizing CUDA operation"


@contextlib.contextmanager
def flagged_syncs(places: collections.Counter):
    """Counts into ``places`` each sync the sync debug mode flags inside."""
    import torch

    def show(message, category, filename, lineno, file=None, line=None):
        if MARK not in str(message):
            return
        frames = [f for f in traceback.extract_stack() if "/hipie_torch/" in f.filename]
        if frames:
            f = frames[-1]
            places[(f.filename.split("/hipie_torch/")[-1], f.name)] += 1
        else:
            places[(f"{filename}:{lineno}", "")] += 1

    err = tempfile.TemporaryFile(mode="w+b")
    saved_fd = os.dup(2)
    torch.cuda.synchronize()
    sys.stderr.flush()
    os.dup2(err.fileno(), 2)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        torch.cuda.synchronize()
        sys.stderr.flush()
        os.dup2(saved_fd, 2)
        os.close(saved_fd)
        err.seek(0)
        text = err.read().decode(errors="replace")
        if text:
            sys.stderr.write(text)
        n = sum(MARK in line for line in text.splitlines())
        if n:
            places[OUTSIDE] += n


def counted(before, after) -> collections.Counter:
    places = collections.Counter()
    for name, n in after.items():
        d = n - before.get(name, 0)
        if d and name.startswith("host_sync."):
            places[SITES.get(name, (name, "(no place in SITES)"))] += d
    return places


def audit_serve(cell, seed, dev):
    import torch

    from hipie_torch.utils import trace

    side = serve.program_side(cell, seed, dev)
    pool = traffic.serve_pool(cell.traffic, seed, pin=True)
    batches = serve.request_batches(cell.traffic, pool)

    def request(k):
        x = batches[k % len(batches)].to(dev, non_blocking=True)
        side.post(side.forward(x))

    with torch.inference_mode():
        side.encode()
        request(len(batches) - 1)
        torch.cuda.synchronize()
        flagged = collections.Counter()
        before = dict(trace.COUNTS)
        with flagged_syncs(flagged):
            request(0)
        return flagged, counted(before, dict(trace.COUNTS)), cell.traffic["batch"]


def audit_train(cell, seed, dev):
    import torch

    import hipie_torch.losses.criterion as crit_mod
    import hipie_torch.train.step as step_mod
    from hipie_torch.utils import trace
    from hipie_torch.utils.rng import GeneratorKeys

    from harness import train

    mix = cell.traffic
    cfg, state, step = train.program_state(cell, seed, dev, [])
    mc = cfg.model
    pool = traffic.train_pool(mix, seed, mc.text.max_query_len, mc.text.vocab_size,
                              mc.num_classes, dev)
    batches = [train.wrap_batch(b, step_mod, crit_mod) for b in pool]
    keys = GeneratorKeys(torch.Generator(device=dev).manual_seed(train.key_seed(seed)))
    for batch in batches:
        step(state, batch, keys)
    torch.cuda.synchronize()
    flagged = collections.Counter()
    before = dict(trace.COUNTS)
    with flagged_syncs(flagged):
        step(state, batches[0], keys)
    return flagged, counted(before, dict(trace.COUNTS)), mix["batch"]


def run(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="cells, comma-separated")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    common.set_cache_dirs()
    import torch

    dev = torch.device("cuda", 0)
    bad = 0
    for name in args.workload.split(","):
        cell = common.load_cell(name)
        main.require_cards(cell.chips)
        kind = cell.traffic["kind"]
        flagged, got, images = (audit_serve if kind == "serve" else audit_train)(cell, args.seed,
                                                                                 dev)
        places = sorted(set(flagged) | set(got))
        rows = []
        for place in places:
            ok = flagged[place] == got[place]
            bad += not ok
            rows.append({"place": " ".join(place), "flagged": flagged[place],
                         "counted": got[place], "ok": ok})
            common.log(f"[audit] {name} {' '.join(place):60s} flagged {flagged[place]:4d} "
                       f"counted {got[place]:4d} {'ok' if ok else 'DIFFERS'}")
        print(json.dumps({"workload": name, "kind": kind, "images": images,
                          "flagged": sum(flagged.values()), "counted": sum(got.values()),
                          "places": rows, "card": common.smi(),
                          "seconds": time.perf_counter() - T0}), flush=True)
        import gc

        gc.collect()
        torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
