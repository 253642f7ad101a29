"""Data and tensor parallelism across GPUs: the process group and its
(dp, tp) grid, the counts a step shares across the data axis, and the
gradient all-reduce.

Counterpart of hipie_tpu/parallel/mesh.py. JAX runs one SPMD program over a
("data", "model") mesh: the batch is split over "data" and XLA psums the
gradients; the TP rules shard the big matmuls over "model". The port runs one
process per card, as the reference's detectron2 launch does, and makes both
axes explicit:

  * ``init_distributed`` joins the process group (NCCL on the cards; gloo only
    when the caller names it: on the CPU, or for two ranks on one card) and
    sets the rank's device; ``launch`` runs an entry point on N local ranks
    (the reference's launch.py), or on the ranks torchrun started;
  * ``global_count`` / ``global_max`` give a step the counts over the global
    batch: a loss normaliser is the global count divided by the data group's size
    (DETR's rule), so that the mean of the ranks' gradients is the global
    batch's gradient; ``count_unit`` is one global count in those units, the
    floor a normaliser clamps to;
  * ``gather_batch`` and ``global_sum`` serve the one part of the forward that
    pools over the whole batch (language-derived bg queries, shared by every
    image);
  * ``reduce_gradients`` is XLA's psum over "data": a bucketed all-reduce of
    the trainable gradients after the backward, divided by the group's size;
  * ``broadcast_module`` gives every rank rank 0's parameters and buffers.

``create_mesh(dp, tp)`` lays the world out as JAX's mesh does,
``reshape(dp, tp)`` with a rank's model peers adjacent: rank = d * tp + m. The
data group holds the ranks of one model index m (they see different images),
the model group those of one data index d (they see the same images and hold
different shards of the TP-sharded parameters, hipie_torch/parallel/tensor.py).
Every function above runs on the data group, so that TP does not multiply the
batch; ``model_rank``, ``model_size`` and ``model_group`` name the other axis.
Without ``create_mesh`` the data group is the whole world and there is no
model axis.

Every function is the identity when no process group is initialised, so the
single-process step runs exactly as before. ``COLLECTIVES`` counts the
collectives run, by kind.
"""

from __future__ import annotations

import os
import socket
from collections import Counter
from datetime import timedelta
from typing import Any, Callable, Iterable, List, NamedTuple, Optional

import torch
import torch.distributed as dist

COLLECTIVES: Counter = Counter()

# gradients are all-reduced in flat buckets of at most this many bytes
BUCKET_BYTES = 64 << 20


def _env_int(name: str, value: Optional[int]) -> int:
    if value is not None:
        return int(value)
    if name not in os.environ:
        raise RuntimeError(f"init_distributed: {name} is neither given nor in the environment")
    return int(os.environ[name])


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     local_rank: Optional[int] = None, device=None,
                     timeout_s: float = 600.0) -> torch.device:
    """Join the data-parallel process group and return this rank's device.

    ``rank``, ``world_size`` and ``local_rank`` default to torchrun's RANK,
    WORLD_SIZE and LOCAL_RANK; ``init_method`` to ``env://`` (MASTER_ADDR and
    MASTER_PORT). ``backend`` defaults to NCCL, one card a rank
    (``cuda:local_rank``), and raises where the node has fewer cards than
    ranks. gloo is taken only when named: its ranks run on the CPU unless
    ``device`` names a card (two ranks may share one card under gloo, which
    NCCL refuses). A failed rendezvous raises; there is no single-process
    fallback."""
    backend = backend or "nccl"
    rank = _env_int("RANK", rank)
    world_size = _env_int("WORLD_SIZE", world_size)
    local_rank = local_rank if local_rank is not None else int(os.environ.get("LOCAL_RANK", rank))
    if backend == "nccl":
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        if local_world > n_cards or local_rank >= n_cards:
            raise RuntimeError(f"init_distributed: {local_world} NCCL ranks on this node need "
                               f"as many cards, and it has {n_cards}")
        dev = torch.device("cuda", local_rank)
    elif backend == "gloo":
        dev = torch.device(device if device is not None else "cpu")
    else:
        raise ValueError(f"init_distributed: backend {backend!r} is neither nccl nor gloo")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device for a rank on the card")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=timedelta(seconds=timeout_s))
    return dev


def shutdown_distributed() -> None:
    """Leave the process group (a no-op without one) and forget its mesh."""
    _GRID.update(data=None, model=None)
    if dist.is_initialized():
        dist.destroy_process_group()


def local_url() -> str:
    """A tcp:// rendezvous on a free localhost port."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def _launched(rank: int, fn: Callable, n: int, url: str, device: str, args: Any) -> None:
    dev = init_distributed("gloo" if device == "cpu" else "nccl", url, rank=rank,
                           world_size=n, local_rank=rank)
    try:
        fn(args, dev)
    finally:
        shutdown_distributed()


def launch(fn: Callable[[Any, torch.device], Any], num_ranks: int = 1, dist_url: str = "",
           device: str = "cuda", args: Any = None) -> Any:
    """Run ``fn(args, device)`` data-parallel (the reference's launch.py).

    Under torchrun (WORLD_SIZE in the environment) this process is one rank:
    it joins the group from the environment. Else ``num_ranks`` > 1 spawns
    that many processes on this machine, one card each under NCCL (``device``
    "cpu": gloo ranks on the host), meeting at ``dist_url`` (default a free
    localhost port), and returns None; one rank is ``fn`` in this process,
    without a group, and returns its result. ``fn`` must be importable by name
    (the ranks are spawned)."""
    if "WORLD_SIZE" in os.environ:
        dev = init_distributed("gloo" if device == "cpu" else "nccl", "env://")
        try:
            return fn(args, dev)
        finally:
            shutdown_distributed()
    if num_ranks == 1:
        return fn(args, torch.device(device))
    if device != "cpu":
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if num_ranks > n_cards:
            raise RuntimeError(f"launch: {num_ranks} ranks need as many cards, this machine "
                               f"has {n_cards}")
    import torch.multiprocessing as mp

    mp.start_processes(_launched, args=(fn, num_ranks, dist_url or local_url(), device, args),
                       nprocs=num_ranks, start_method="spawn")
    return None


class Mesh(NamedTuple):
    """The rank's two groups of a (dp, tp) grid; ``model`` is None at tp = 1."""
    data: Any
    model: Any
    dp: int
    tp: int


# the groups create_mesh made: None is the whole world for "data", no axis for "model"
_GRID = {"data": None, "model": None}


def create_mesh(dp: int = -1, tp: int = 1) -> Optional[Mesh]:
    """The (dp, tp) grid of the process group (``dp`` -1: world // tp), or None
    in a single process. Every rank must call it, with the same arguments (each
    subgroup is made by all ranks). Raises where tp does not divide the world,
    dp * tp is not the world, or tp > 1 has no process group to run on."""
    if tp < 1:
        raise ValueError(f"create_mesh: tp={tp} < 1")
    if not dist.is_initialized():
        if tp != 1:
            raise RuntimeError(f"create_mesh: tp={tp} needs a process group of tp ranks "
                               f"(init_distributed first); one process holds no shards")
        if dp not in (-1, 1):
            raise ValueError(f"create_mesh: dp={dp}, but there is no process group")
        return None
    n = dist.get_world_size()
    check_grid(n, tp)
    if dp not in (-1, n // tp):
        raise ValueError(f"create_mesh: dp={dp} x tp={tp}, but the process group has {n} ranks")
    dp = n // tp
    data = model = None
    if tp > 1:
        rank = dist.get_rank()
        for d in range(dp):             # model groups: one data index, adjacent ranks
            g = dist.new_group(list(range(d * tp, (d + 1) * tp)))
            model = g if rank // tp == d else model
        for m in range(tp):             # data groups: one model index
            g = dist.new_group(list(range(m, n, tp)))
            data = g if rank % tp == m else data
    _GRID.update(data=data, model=model)
    return Mesh(data if data is not None else dist.group.WORLD, model, dp, tp)


def check_grid(n_ranks: int, tp: int) -> None:
    """Raise, before any rank starts, where tp cannot lay out ``n_ranks``."""
    if tp < 1 or n_ranks % tp:
        raise ValueError(f"create_mesh: tp={tp} does not divide the {n_ranks} ranks")


def model_group():
    """The tensor-parallel group (None: no model axis)."""
    return _GRID["model"]


def data_rank() -> int:
    return dist.get_rank(_GRID["data"]) if dist.is_initialized() else 0


def data_size() -> int:
    return dist.get_world_size(_GRID["data"]) if dist.is_initialized() else 1


def model_rank() -> int:
    return dist.get_rank(_GRID["model"]) if _GRID["model"] is not None else 0


def model_size() -> int:
    return dist.get_world_size(_GRID["model"]) if _GRID["model"] is not None else 1


def _data_src() -> int:
    """The global rank of the data group's first rank."""
    g = _GRID["data"]
    return 0 if g is None else dist.get_global_rank(g, 0)


def count_unit() -> float:
    """One count of the global batch in ``global_count``'s units."""
    return 1.0 / data_size()


def _all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM, group: Any = "data") -> torch.Tensor:
    dist.all_reduce(x, op=op, group=_GRID["data"] if group == "data" else group)
    COLLECTIVES["all_reduce"] += 1
    return x


def global_count(x: torch.Tensor) -> torch.Tensor:
    """A count (any shape) summed over the data group and divided by its size:
    a loss normalised by it on every rank averages to the global batch's
    loss. ``x`` itself without a group."""
    if not dist.is_initialized():
        return x
    return _all_reduce(x.detach().float().clone()) / data_size()


def global_max(x: torch.Tensor) -> torch.Tensor:
    """The largest value of ``x`` over the data group (``x`` without one)."""
    if not dist.is_initialized():
        return x
    return _all_reduce(x.detach().clone(), dist.ReduceOp.MAX)


def shard_rows(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's share of a tensor that holds the global batch along
    ``axis``, the ranks' shares in rank order."""
    n = data_size()
    if n == 1:
        return x
    rows = x.shape[axis] // n
    return x.narrow(axis, data_rank() * rows, rows)


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """The global batch of a per-rank tensor (the ranks' batches concatenated
    along axis 0 in rank order); by an all-reduce of a zero-padded buffer, so
    that it runs wherever all_reduce does (gloo takes card tensors only for
    all_reduce and broadcast)."""
    n = data_size()
    if n == 1:
        return x
    dtype = torch.uint8 if x.dtype == torch.bool else x.dtype
    buf = torch.zeros((n,) + tuple(x.shape), dtype=dtype, device=x.device)
    buf[data_rank()] = x
    return _all_reduce(buf).to(x.dtype).reshape((n * x.shape[0],) + tuple(x.shape[1:]))


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        # every rank's loss reads the sum, so each rank's share gets the sum
        # of the ranks' cotangents
        return _all_reduce(g.contiguous().clone())


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data group, differentiably (``x`` without one)."""
    if not dist.is_initialized():
        return x
    return _GlobalSum.apply(x)


def _buckets(tensors: List[torch.Tensor]) -> Iterable[List[torch.Tensor]]:
    """Consecutive runs of same-dtype tensors of at most BUCKET_BYTES (a larger
    tensor alone)."""
    run, size = [], 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        if run and (size + nb > BUCKET_BYTES or t.dtype != run[0].dtype):
            yield run
            run, size = [], 0
        run.append(t)
        size += nb
    if run:
        yield run


@torch.no_grad()
def reduce_gradients(params: List[torch.nn.Parameter]) -> int:
    """The mean of the data group's ``.grad`` on every rank, in place; returns
    the collectives run (0 without a group).

    A has-gradient flag per parameter is summed first: a parameter no rank
    has a gradient for keeps ``None`` everywhere, and one some ranks lack gets
    zeros there, so that every rank reduces the same buckets."""
    if not dist.is_initialized():
        return 0
    n = data_size()
    dev = next((p.grad.device for p in params if p.grad is not None), params[0].device)
    flags = torch.tensor([p.grad is not None for p in params], dtype=torch.float32, device=dev)
    _all_reduce(flags)
    has = flags.cpu().tolist()
    grads = []
    for p, h in zip(params, has):
        if h == 0:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    count = 1
    for run in _buckets(grads):
        flat = torch.cat([g.reshape(-1) for g in run])
        _all_reduce(flat)
        flat.div_(n)
        torch._foreach_copy_(run, [f.view_as(g) for f, g in zip(flat.split(
            [g.numel() for g in run]), run)])
        count += 1
    return count


@torch.no_grad()
def broadcast_module(module: torch.nn.Module) -> int:
    """The data group's first rank's parameters and buffers on every rank of
    the data group, in place (under TP each model index keeps its shards);
    returns the collectives run (0 without a group)."""
    if not dist.is_initialized():
        return 0
    tensors = [t for t in list(module.parameters()) + list(module.buffers()) if t.numel()]
    count = 0
    for run in _buckets(tensors):
        flat = torch.cat([t.detach().reshape(-1) for t in run])
        dist.broadcast(flat, _data_src(), group=_GRID["data"])
        COLLECTIVES["broadcast"] += 1
        torch._foreach_copy_(run, [f.view_as(t) for f, t in zip(flat.split(
            [t.numel() for t in run]), run)])
        count += 1
    return count
