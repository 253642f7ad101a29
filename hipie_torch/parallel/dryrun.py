"""A dp x tp training step on the CPU: the port's twin of
``__graft_entry__.dryrun_multichip``.

    python3 -m hipie_torch.parallel.dryrun [N]

``dryrun_multigpu(n)`` spawns n gloo ranks on the host (one thread each;
rendezvous through a file in a temporary directory, so that parallel runs do
not share a port) on JAX's grid: tp = 2 where n is even, dp = n / tp. At
``dryrun_config()`` (every module at one layer) each rank builds the same
training state, cut to its model rank's shard, takes its data rank's image of
a global batch of dp (JAX's dryrun batch: 4 GT slots, three things and one
stuff, at 128x128) and runs ONE full train step (CDN, the fg/bg/gt and
MaskDINO criterion passes, the model group's and the data group's gradient
reductions, clipped AdamW). It fails unless the loss is finite and every rank
ends with the same whole parameters and AdamW state (the shards gathered), bit
for bit. Where tp > 1 it then runs JAX's other two legs: the same step from
the same state with ``transformer.shard_tokens`` (its loss within 1e-3
relative of the dense step's: the mask losses' uncertain points may swap on
near ties), and the sharded model's forward and ``hipie_inference`` on the
rank's image against an unsharded copy of the same weights (JAX's limits,
rtol 1e-3 / atol 2e-4). It prints ``dryrun_multigpu OK: n ranks ...``.
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
    """sha256 over the whole parameters, buffers and AdamW state of a
    TrainState (a tensor-parallel rank's shards gathered: a collective)."""
    from hipie_torch.train.checkpoint import full_state

    model_sd, opt_sd = full_state(state)
    tensors = list(model_sd.values())
    for st in opt_sd["adamw"]["state"].values():
        tensors += [v for v in st.values() if torch.is_tensor(v)]
    return tensor_digest(tensors)


def _class_maps(dev):
    """JAX's dryrun class maps: 5 classes on odd tokens, 3 of them things."""
    from hipie_torch.models.postprocess import ClassMaps

    mw = torch.zeros(5, L)
    tm = torch.zeros(5, L, dtype=torch.bool)
    for c in range(5):
        mw[c, 2 * c + 1] = 1.0
        tm[c, 2 * c + 1] = True
    return ClassMaps(mw.to(dev), tm.to(dev), (torch.arange(5) < 3).to(dev))


def _inference_leg(cfg, state, batch) -> float:
    """The sharded model's forward + hipie_inference against an unsharded copy
    of the same whole weights on this rank; returns the top score."""
    from hipie_torch.models.hipie import HIPIEModel, hipie_inference
    from hipie_torch.train.checkpoint import full_state

    whole = HIPIEModel(cfg.model, train=True)
    whole.load_state_dict(full_state(state)[0])
    maps = _class_maps(batch.images.device)
    res = []
    for model in (state.model, whole):
        model.eval()
        with torch.inference_mode():
            out = model(batch.images, batch.pad_mask, batch.input_ids, batch.lang_mask,
                        batch.image_sizes)
            res.append(hipie_inference(out, maps, cfg.test, cfg.model,
                                       pad_mask_s4=batch.pad_mask[0][::4, ::4]))
        model.train()
    for name in ("scores", "boxes", "sem_seg"):
        np.testing.assert_allclose(getattr(res[0], name).numpy(), getattr(res[1], name).numpy(),
                                   rtol=1e-3, atol=2e-4, err_msg=f"sharded inference: {name}")
    return float(res[0].scores[0])


def _rank(rank: int, n: int, url: str, out: str, then: Optional[Callable[[int], None]]) -> None:
    from hipie_torch.config import apply_overrides, dryrun_config
    from hipie_torch.parallel.mesh import (COLLECTIVES, broadcast_module, create_mesh,
                                           data_rank, init_distributed, shutdown_distributed)
    from hipie_torch.parallel.multihost import all_gather_objects, reduce_metrics
    from hipie_torch.train.step import create_train_state, make_train_step
    from hipie_torch.utils.rng import GeneratorKeys

    torch.set_num_threads(1)
    init_distributed("gloo", url, rank=rank, world_size=n)
    try:
        mesh = create_mesh(tp=2 if n % 2 == 0 else 1)
        cfg = dryrun_config()
        batch = _batch(mesh.dp, data_rank())

        def step_once(cfg):
            state = create_train_state(cfg, seed=0, device="cpu")
            broadcast_module(state.model)
            step = make_train_step(cfg, state, device="cpu")
            COLLECTIVES.clear()
            state, metrics = step(state, batch, GeneratorKeys(torch.Generator().manual_seed(1)))
            return state, sum(COLLECTIVES.values()), float(metrics["total_loss"])

        state, collectives, local = step_once(cfg)
        total = reduce_metrics({"total_loss": local})["total_loss"]
        digests = all_gather_objects(state_digest(state))
        if not np.isfinite(total) or len(set(digests)) != 1:
            raise AssertionError(f"dryrun_multigpu: loss {total}, rank states {digests}")
        rec = {"loss": total, "collectives": collectives, "digest": digests[0],
               "dp": mesh.dp, "tp": mesh.tp}
        if mesh.tp > 1:
            cfg_sp = apply_overrides(cfg, {"model.transformer.shard_tokens": True})
            _, _, sp_local = step_once(cfg_sp)
            sp = reduce_metrics({"total_loss": sp_local})["total_loss"]
            if not abs(sp - total) <= 1e-3 * abs(total):
                raise AssertionError(f"dryrun_multigpu: SP loss {sp}, dense {total}")
            rec["sp_loss"] = sp
            rec["top_score"] = _inference_leg(cfg, state, batch)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(rec, f)
        if then is not None:
            create_mesh()           # the checks that follow are data-parallel
            then(rank)
    finally:
        shutdown_distributed()


def dryrun_multigpu(n: int = 2, then: Optional[Callable[[int], None]] = None) -> dict:
    """One dp x tp train step on ``n`` gloo ranks, and where tp > 1 the SP and
    sharded-inference legs; prints the OK line and returns rank 0's record
    (mean loss, collectives a step, state digest, grid, the SP loss and the
    top score). ``then(rank)``, if given, runs on every rank after the legs
    with the group still up as one data-parallel group (picklable: the ranks
    are spawned); the CPU tests run their data-parallel checks there, in the
    one spawn."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="hipie_dryrun_") as tmp:
        out = os.path.join(tmp, "rank0.json")
        mp.start_processes(_rank, args=(n, f"file://{os.path.join(tmp, 'rendezvous')}", out,
                                        then), nprocs=n, start_method="spawn")
        with open(out) as f:
            rec = json.load(f)
    print(f"dryrun_multigpu OK: {n} ranks (gloo, dp={rec['dp']}, tp={rec['tp']}), "
          f"loss={rec['loss']:.3f}, {rec['collectives']} collectives a step, ranks "
          f"bit-identical", flush=True)
    if rec["tp"] > 1:
        print(f"dryrun_multigpu SP OK: shard_tokens over tp={rec['tp']}, "
              f"loss={rec['sp_loss']:.3f} (dense {rec['loss']:.3f}); inference OK: the "
              f"sharded forward + postprocess matches the whole model (top score "
              f"{rec['top_score']:.4f})", flush=True)
    return rec


if __name__ == "__main__":
    dryrun_multigpu(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
