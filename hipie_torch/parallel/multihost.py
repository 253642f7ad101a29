"""Cross-process helpers: who is the main process, gathering objects (to every
process or to the main one), broadcasting one, mean metrics and a barrier.

Counterpart of hipie_tpu/parallel/multihost.py (the reference's
detectron2/utils/comm.py: all_gather, gather, reduce_dict, synchronize) on
torch.distributed; ``gather_to_main`` and ``broadcast_from_main`` serve the
sharded evaluation. In a single process every function is a passthrough, as
comm.py's world_size == 1 short-circuits are.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def num_processes() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _device() -> torch.device:
    """Where the group's collectives take tensors: the rank's card under
    NCCL, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_objects(obj: Any) -> List[Any]:
    """Every process's picklable ``obj``, in rank order (comm.all_gather).

    Two phases, as JAX's is: the pickled sizes, then the payloads padded to
    the largest, so ragged per-rank lists (an evaluator's predictions) go
    through."""
    if num_processes() == 1:
        return [obj]
    out: List[Any] = [None] * num_processes()
    dist.all_gather_object(out, obj)
    return out


def gather_to_main(obj: Any) -> Optional[List[Any]]:
    """Every process's picklable ``obj``, in rank order, on the main process;
    None on the others (comm.gather to rank 0)."""
    if num_processes() == 1:
        return [obj]
    out: Optional[List[Any]] = [None] * num_processes() if is_main_process() else None
    dist.gather_object(obj, out, dst=0)
    return out


def broadcast_from_main(obj: Any) -> Any:
    """The main process's picklable ``obj`` on every process."""
    if num_processes() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def reduce_metrics(metrics: Dict[str, float]) -> Dict[str, float]:
    """The mean of each scalar metric over the processes (comm.reduce_dict)."""
    if num_processes() == 1:
        return metrics
    keys = sorted(metrics)
    vals = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64,
                        device=_device())
    dist.all_reduce(vals)
    vals = (vals / num_processes()).cpu().tolist()
    return {k: float(v) for k, v in zip(keys, vals)}


def sync() -> None:
    """A barrier over the processes (comm.synchronize)."""
    if num_processes() > 1:
        dist.barrier()
