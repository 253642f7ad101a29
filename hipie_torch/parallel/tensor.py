"""Tensor and sequence parallelism over the mesh's model axis.

Counterpart of hipie_tpu/parallel/mesh.py's ``_TP_RULES``, ``param_spec`` and
``shard_params``, and of ``model.transformer.shard_tokens``
(hipie_tpu/models/transformer.py ``_shard_tokens``). JAX states where each
parameter lives and XLA inserts the collectives; the port shards a loaded full
model in place (``shard_module_``) and its modules run the collectives
themselves, Megatron-style:

  * a column-parallel linear (JAX: kernel sharded by output) holds its rank's
    output rows and takes its input through ``copy_to_model`` (the identity,
    whose backward all-reduces the input's gradient over the model group);
  * a row-parallel linear (by input) holds its rank's input columns; its
    partial output goes through ``reduce_from_model`` (an all-reduce, whose
    backward is the identity), then the replicated bias is added.

Each TP module declares its split where it is built (``tp_layout``, a
``TPLayout``): its column- and row-parallel linears and the whole parameters
whose gradient is then partial on each rank (the ViT's rel-pos tables, which
meet only the rank's heads of q). ``build_plan`` shards a module's linears
exactly where JAX's ``param_spec`` shards their counterparts, along the same
logical dimension, and keeps them whole where that dimension does not divide
by tp. JAX's BERT rules are anchored at ``text_encoder/`` while the tree it
shards is rooted at ``params/``, so they match nothing, and BERT stays
replicated in both packages; the Swin backbone's MLPs match no rule either.
One layout differs: JAX shards the ViT's fused qkv output contiguously and
lets XLA route the heads; a Megatron rank needs its own heads of q, k and v
(the attention reshapes to (3, heads, head_dim)), so the port takes the
rank's share of each of the three blocks.

Sequence parallelism (``shard_tokens``): each model rank holds a contiguous
share of the S flattened encoder tokens (``TokenShards``; uneven where tp
does not divide S) between ``split_tokens`` and ``gather_tokens_replicated``.
Token-wise work runs on the share; a TP-sharded block takes the whole
sequence through ``gather_tokens`` and gives its share back through
``scatter_tokens`` (Megatron-SP); MSDA gathers its value table. The
parameters that see only the rank's tokens (``token_local_parameters`` of the
encoder's modules) get partial gradients, which the train step sums over the
model group with the declared ones (``reduce_model_gradients``).

Every collective is an all-reduce (a gather is an all-reduce of a zero-padded
buffer, a reduce-scatter an all-reduce and a slice): gloo, which runs two
ranks on one card, takes only all-reduce and broadcast for card tensors.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from hipie_torch.parallel.mesh import (COLLECTIVES, _buckets, model_group, model_rank,
                                       model_size)


class TPLayout(NamedTuple):
    """How a module splits over the model group: its column-parallel linears
    (name: blocks along the output, of which a rank takes its share of each),
    its row-parallel linears, the parameters it keeps whole whose gradient is
    partial on each rank (the ranks' sum is the gradient), and the elements of
    the torch dim per index of the dim JAX shards (JAX's VL kernels are (in,
    heads, head_dim), sharded by heads). nn.Linear stores (out, in): JAX's
    "by output" is dim 0, "by input" dim 1."""

    columns: Dict[str, int]
    rows: Tuple[str, ...]
    partial: Tuple[str, ...] = ()
    unit: int = 1

    def specs(self) -> Dict[str, Tuple[int, int]]:
        """The sharded parameters, by name in the module: (torch dim, blocks)."""
        out = {f"{c}.{w}": (0, b) for c, b in self.columns.items() for w in ("weight", "bias")}
        return {**out, **{f"{r}.weight": (1, 1) for r in self.rows}}


def tp_layouts(model: nn.Module) -> Iterator[Tuple[str, nn.Module, TPLayout]]:
    """(name, module, layout) of every module of ``model`` that declares one."""
    for name, module in model.named_modules():
        layout = getattr(module, "tp_layout", None)
        if layout is not None:
            yield name, module, layout


def build_plan(model: nn.Module, tp: int) -> Dict[str, Tuple[int, int]]:
    """The parameters a tp-way model group shards, by name: (torch dim,
    blocks). A module is sharded where JAX's sharded dim of each of its linears
    divides by tp and kept whole where none does; a split between the two, or
    heads that tp does not divide where JAX shards them, raises (a Megatron
    rank cannot follow)."""
    plan: Dict[str, Tuple[int, int]] = {}
    if tp <= 1:
        return plan
    for mname, module, layout in tp_layouts(model):
        params = dict(module.named_parameters())
        specs = layout.specs()
        divides = [params[n].shape[d] // layout.unit % tp == 0 for n, (d, _) in specs.items()]
        if not any(divides):
            continue
        if not all(divides) or getattr(module, "num_heads", tp) % tp:
            raise ValueError(f"build_plan: JAX shards {mname} at tp={tp} in a way a "
                             f"Megatron split cannot follow")
        plan.update({f"{mname}.{n}": s for n, s in specs.items()})
    return plan


def take_shard(t: torch.Tensor, dim: int, blocks: int, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s share of ``t`` along ``dim``: its 1/size of each of the
    ``blocks`` equal blocks, in order."""
    u = t.unflatten(dim, (blocks, t.shape[dim] // blocks))
    k = u.shape[dim + 1] // size
    return u.narrow(dim + 1, rank * k, k).flatten(dim, dim + 1)


def tp_plan(model: nn.Module) -> Dict[str, Tuple[int, int]]:
    """The sharded parameters of a model ``shard_module_`` sliced, by name:
    (dim, blocks). Empty for a whole model."""
    return getattr(model, "_tp_plan", {})


@torch.no_grad()
def shard_module_(model: nn.Module) -> Dict[str, Tuple[int, int]]:
    """Slice a loaded full model in place to this rank's shard of the model
    group (a no-op at tp = 1) by ``build_plan`` and mark its sharded TP
    modules (``tp``); returns the plan."""
    tp, rank = model_size(), model_rank()
    if tp == 1:
        return {}
    if tp_plan(model):
        raise RuntimeError("shard_module_: the model is sharded already")
    plan = build_plan(model, tp)
    for mname, module, layout in tp_layouts(model):
        if f"{mname}.{next(iter(layout.specs()))}" in plan:
            module.tp = tp
    for name, (dim, blocks) in plan.items():
        owner, attr = name.rsplit(".", 1)
        mod = model.get_submodule(owner)
        p = getattr(mod, attr)
        setattr(mod, attr, nn.Parameter(take_shard(p.data, dim, blocks, rank, tp).clone(),
                                        requires_grad=p.requires_grad))
    model._tp_plan = plan
    return plan


def shard_state_dict(sd: Dict[str, torch.Tensor], plan: Dict[str, Tuple[int, int]]
                     ) -> Dict[str, torch.Tensor]:
    """A full state dict cut to this rank's shards (the plan's entries; one
    whose sharded dim does not divide is left for a shape check to refuse)."""
    tp, rank = model_size(), model_rank()
    cut = lambda v, dim, blocks: (take_shard(v, dim, blocks, rank, tp).clone()
                                  if v.dim() > dim and v.shape[dim] % (blocks * tp) == 0 else v)
    return {k: (cut(v, *plan[k]) if k in plan else v) for k, v in sd.items()}


def gather_shard(t: torch.Tensor, dim: int, blocks: int) -> torch.Tensor:
    """The full tensor of every model rank's shard ``t`` (the inverse of
    take_shard), bit for bit: an all_gather of host copies under gloo, of
    card tensors under NCCL."""
    group = model_group()
    on = t.device if dist.get_backend(group) == "nccl" else torch.device("cpu")
    src = t.detach().to(on).contiguous()
    parts = [torch.empty_like(src) for _ in range(model_size())]
    dist.all_gather(parts, src, group=group)
    COLLECTIVES["all_gather"] += 1
    us = [p.unflatten(dim, (blocks, p.shape[dim] // blocks)) for p in parts]
    return torch.cat(us, dim + 1).flatten(dim, dim + 1).to(t.device)


# ---- the model group's collectives as autograd Functions ---------------------

def _reduce(x: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(x, group=model_group())
    COLLECTIVES["all_reduce_model"] += 1
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.contiguous().clone())


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel linear: the identity, whose backward sums
    the ranks' partial input gradients."""
    return _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The partial output of a row-parallel linear summed over the model group."""
    return _ReduceFromModel.apply(x)


def row_linear(linear: nn.Linear, x: torch.Tensor, tokens: Optional["TokenShards"] = None
               ) -> torch.Tensor:
    """A row-parallel ``linear`` on its input shard: the partial products
    summed over the model group (the rank's token share of the sum, under SP),
    then the bias, in the product's dtype (nn.Linear's under autocast)."""
    y = F.linear(x, linear.weight)
    y = reduce_from_model(y) if tokens is None else scatter_tokens(y, tokens)
    return y + linear.bias.to(y.dtype)


def column_input(x: torch.Tensor, tokens: Optional["TokenShards"] = None) -> torch.Tensor:
    """The input of a column-parallel block: ``x`` itself, or under SP the
    whole sequence of the ranks' token shares."""
    return copy_to_model(x) if tokens is None else gather_tokens(x, tokens)


def ffn(linear1: nn.Linear, linear2: nn.Linear, x: torch.Tensor, tp: int,
        tokens: Optional["TokenShards"] = None, act=F.relu) -> torch.Tensor:
    """linear2(act(linear1(x))): whole (token-wise, so on a token share as
    well) at tp = 1, column- then row-parallel above."""
    if tp == 1:
        return linear2(act(linear1(x)))
    return row_linear(linear2, act(linear1(column_input(x, tokens))), tokens)


# ---- sequence parallelism ------------------------------------------------------

class TokenShards(NamedTuple):
    """Each model rank's contiguous share of S tokens (torch.tensor_split's:
    the first S % tp ranks one token more) and this rank's index."""
    sizes: Tuple[int, ...]
    rank: int

    @property
    def start(self) -> int:
        return sum(self.sizes[:self.rank])

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's share of ``x`` along dim 1 (no gradient routing)."""
        return x.narrow(1, self.start, self.sizes[self.rank])


def token_shards(n_tokens: int) -> Optional[TokenShards]:
    """The shares of ``n_tokens`` over the model group; None without one."""
    tp = model_size()
    if tp == 1:
        return None
    sizes = tuple(n_tokens // tp + (r < n_tokens % tp) for r in range(tp))
    return TokenShards(sizes, model_rank())


def _all_gather_tokens(x: torch.Tensor, t: TokenShards) -> torch.Tensor:
    full = x.new_zeros((x.shape[0], sum(t.sizes)) + tuple(x.shape[2:]))
    full.narrow(1, t.start, t.sizes[t.rank]).copy_(x)
    return _reduce(full)


def _slice_tokens(x: torch.Tensor, t: TokenShards) -> torch.Tensor:
    return t.local(x).contiguous()


class _GatherTokens(torch.autograd.Function):
    """all-gather; backward: the ranks' partial gradients summed, then sliced."""

    @staticmethod
    def forward(ctx, x, t):
        ctx.t = t
        return _all_gather_tokens(x, t)

    @staticmethod
    def backward(ctx, g):
        return _slice_tokens(_reduce(g.contiguous().clone()), ctx.t), None


class _ScatterTokens(torch.autograd.Function):
    """reduce-scatter (sum, then this rank's share); backward: all-gather."""

    @staticmethod
    def forward(ctx, x, t):
        ctx.t = t
        return _slice_tokens(_reduce(x.contiguous().clone()), t)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_tokens(g, ctx.t), None


class _SplitTokens(torch.autograd.Function):
    """this rank's share of a replicated sequence; backward: all-gather."""

    @staticmethod
    def forward(ctx, x, t):
        ctx.t = t
        return _slice_tokens(x, t)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_tokens(g, ctx.t), None


class _GatherTokensReplicated(torch.autograd.Function):
    """all-gather into replicated work; backward: this rank's share."""

    @staticmethod
    def forward(ctx, x, t):
        ctx.t = t
        return _all_gather_tokens(x, t)

    @staticmethod
    def backward(ctx, g):
        return _slice_tokens(g, ctx.t), None


def gather_tokens(x: torch.Tensor, t: TokenShards) -> torch.Tensor:
    """The whole sequence of the ranks' shares (B, S_r, ...) -> (B, S, ...), for
    work whose gradient is partial on each rank (a column-parallel block, MSDA's
    value table read by the rank's queries)."""
    return _GatherTokens.apply(x, t)


def scatter_tokens(x: torch.Tensor, t: TokenShards) -> torch.Tensor:
    """This rank's share of the sum of the ranks' (B, S, ...) partial outputs."""
    return _ScatterTokens.apply(x, t)


def split_tokens(x: torch.Tensor, t: TokenShards) -> torch.Tensor:
    """This rank's share of a sequence every rank holds whole."""
    return _SplitTokens.apply(x, t)


def gather_tokens_replicated(x: torch.Tensor, t: TokenShards) -> torch.Tensor:
    """The whole sequence, for work every rank then does whole."""
    return _GatherTokensReplicated.apply(x, t)


# ---- gradients -------------------------------------------------------------------

def token_local_parameters(model: nn.Module) -> List[nn.Parameter]:
    """The parameters that see only the rank's tokens under SP: those of the
    encoders ``shard_tokens`` splits (``SHARDS_TOKENS``), in module order."""
    return [p for module in model.modules() if getattr(module, "SHARDS_TOKENS", False)
            for p in module.token_local_parameters()]


def partial_parameters(model: nn.Module, sequence_parallel: bool) -> List[nn.Parameter]:
    """The whole parameters whose gradient is partial on each rank of the
    model group: those the sharded TP modules declare (``TPLayout.partial``)
    and, under SP, the token-local ones."""
    out = [getattr(m, n) for _, m, layout in tp_layouts(model) if m.tp > 1
           for n in layout.partial]
    return out + (token_local_parameters(model) if sequence_parallel else [])


@torch.no_grad()
def reduce_model_gradients(model: nn.Module, params: Iterable[nn.Parameter],
                           sequence_parallel: bool) -> int:
    """Make the model group's gradients of the whole parameters one: the
    partial ones (``partial_parameters``) summed over the group, the others
    taken from the group's first rank (their ranks computed the same gradient,
    up to the kernels' order of float adds). The sharded ones stay. Returns
    the collectives run (0 at tp = 1)."""
    if model_size() == 1:
        return 0
    sharded = {id(p) for n, p in model.named_parameters() if n in tp_plan(model)}
    partial = {id(p) for p in partial_parameters(model, sequence_parallel)}
    summed, copied = [], []
    for p in params:
        if p.grad is None or id(p) in sharded:
            continue
        (summed if id(p) in partial else copied).append(p.grad)
    group = model_group()
    src = dist.get_global_rank(group, 0)
    count = 0
    for grads, sum_ in ((summed, True), (copied, False)):
        for run in _buckets(grads):
            flat = torch.cat([g.reshape(-1) for g in run])
            if sum_:
                _reduce(flat)
            else:
                dist.broadcast(flat, src, group=group)
                COLLECTIVES["broadcast_model"] += 1
            torch._foreach_copy_(run, [f.view_as(g) for f, g in zip(flat.split(
                [g.numel() for g in run]), run)])
            count += 1
    return count


def sharded_mask(model: nn.Module, params: Iterable[nn.Parameter]) -> List[bool]:
    """Which of ``params`` are TP-sharded (a global norm sums their squares
    over the model group and counts the others once)."""
    sharded = {id(p) for n, p in model.named_parameters() if n in tp_plan(model)}
    return [id(p) in sharded for p in params]


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model group (no gradient)."""
    return _reduce(x)
