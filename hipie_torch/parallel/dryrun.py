"""A data-parallel training step on the CPU: the port's twin of
``__graft_entry__.dryrun_multichip``.

    python3 -m hipie_torch.parallel.dryrun [N]

``dryrun_multigpu(n)`` spawns n gloo ranks on the host (one thread each;
rendezvous through a file in a temporary directory, so that parallel runs do
not share a port), at
``dryrun_config()`` (every module at one layer): each rank builds the same
training state, takes its image of a global batch of n (JAX's dryrun batch:
4 GT slots, three things and one stuff, at 128x128) and runs ONE full train
step (CDN, the fg/bg/gt and MaskDINO criterion passes, the gradient
all-reduce, clipped AdamW). It fails unless the loss is finite and every rank
ends with the same parameters and AdamW state, bit for bit, then prints
``dryrun_multigpu OK: n ranks ...``.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
from typing import Callable, Optional

import numpy as np
import torch

# JAX's dryrun batch is 64x64; there the stride-64 level is 1x1, where
# torch's training GroupNorm refuses one value a group, so 128x128 here
H = W = 128
L = 16
N = 4


def _batch(n: int, rank: int):
    """Rank ``rank``'s image of the global batch of ``n`` (JAX's dryrun batch)."""
    from hipie_torch.losses.criterion import Targets
    from hipie_torch.train.step import TrainBatch

    rng = np.random.RandomState(0)
    boxes = np.concatenate([rng.rand(n, N, 2) * 0.5 + 0.25, rng.rand(n, N, 2) * 0.2 + 0.1],
                           -1).astype(np.float32)
    masks = (rng.rand(n, N, H // 4, W // 4) > 0.5).astype(np.float32)
    one = lambda x: torch.from_numpy(np.ascontiguousarray(x[rank:rank + 1]))
    t = Targets(labels=torch.zeros(1, N, dtype=torch.long), boxes=one(boxes), masks=one(masks),
                positive_map=torch.eye(N, L)[None], is_thing=torch.tensor([[True] * 3 + [False]]),
                valid=torch.ones(1, N, dtype=torch.bool))
    return TrainBatch(images=torch.full((1, H, W, 3), 127.0),
                      pad_mask=torch.zeros(1, H, W, dtype=torch.bool),
                      input_ids=(torch.arange(L) % 16)[None],
                      lang_mask=torch.ones(1, L, dtype=torch.long),
                      image_sizes=torch.tensor([[H, W]]), targets=t)


def tensor_digest(tensors) -> str:
    """sha256 over the bytes of ``tensors``, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def state_digest(state) -> str:
    """sha256 over the parameters, buffers and AdamW state of a TrainState."""
    tensors = list(state.model.state_dict().values())
    for st in state.optimizer.opt.state_dict()["state"].values():
        tensors += [v for v in st.values() if torch.is_tensor(v)]
    return tensor_digest(tensors)


def _rank(rank: int, n: int, url: str, out: str, then: Optional[Callable[[int], None]]) -> None:
    from hipie_torch.config import dryrun_config
    from hipie_torch.parallel.mesh import (COLLECTIVES, broadcast_module, init_distributed,
                                           shutdown_distributed)
    from hipie_torch.parallel.multihost import all_gather_objects, reduce_metrics
    from hipie_torch.train.step import create_train_state, make_train_step
    from hipie_torch.utils.rng import GeneratorKeys

    torch.set_num_threads(1)
    init_distributed("gloo", url, rank=rank, world_size=n)
    try:
        cfg = dryrun_config()
        state = create_train_state(cfg, seed=0, device="cpu")
        broadcast_module(state.model)
        step = make_train_step(cfg, state, device="cpu")
        COLLECTIVES.clear()
        keys = GeneratorKeys(torch.Generator().manual_seed(1))
        state, metrics = step(state, _batch(n, rank), keys)
        collectives = sum(COLLECTIVES.values())
        local = float(metrics["total_loss"])
        total = reduce_metrics({"total_loss": local})["total_loss"]
        digests = all_gather_objects(state_digest(state))
        if not np.isfinite(total) or len(set(digests)) != 1:
            raise AssertionError(f"dryrun_multigpu: loss {total}, rank states {digests}")
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"loss": total, "collectives": collectives,
                           "digest": digests[0]}, f)
        if then is not None:
            then(rank)
    finally:
        shutdown_distributed()


def dryrun_multigpu(n: int = 2, then: Optional[Callable[[int], None]] = None) -> dict:
    """One data-parallel train step on ``n`` gloo ranks; prints the OK line and
    returns rank 0's record (mean loss, collectives a step, state digest).
    ``then(rank)``, if given, runs on every rank after the step with the
    group still up (picklable: the ranks are spawned); the CPU tests run
    their data-parallel checks there, in the one spawn."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="hipie_dryrun_") as tmp:
        out = os.path.join(tmp, "rank0.json")
        mp.start_processes(_rank, args=(n, f"file://{os.path.join(tmp, 'rendezvous')}", out,
                                        then), nprocs=n, start_method="spawn")
        with open(out) as f:
            rec = json.load(f)
    print(f"dryrun_multigpu OK: {n} ranks (gloo, dp={n}), loss={rec['loss']:.3f}, "
          f"{rec['collectives']} collectives a step, ranks bit-identical", flush=True)
    return rec


if __name__ == "__main__":
    dryrun_multigpu(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
