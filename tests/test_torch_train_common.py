"""Shared inputs of the training parity tests (tests/test_torch_train_*.py):
the tiny training config in both packages, a synthetic batch from a numpy seed,
JAX keys wrapped in the port's key interface, and the JAX train state carried
into the port."""

from __future__ import annotations

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import torch

import hipie_tpu.config as jconfig
import hipie_torch.config as tconfig
from hipie_torch.utils.rng import Keys

# tiny_test_config with an 18-layer ResNet (bottleneck blocks 2-2-2-2), exact
# top-k in the point picks, and a 4-step warmup so that one update has a
# non-trivial lr
OVERRIDES = {"model.backbone.resnet_depth": 18, "model.loss.exact_topk": True,
             "solver.warmup_iters": 4, "model.max_matched_masks": 8}
B, H, W, L, N = 2, 96, 96, 16, 6


def train_config(pkg=tconfig, **extra):
    return pkg.apply_overrides(pkg.tiny_test_config(), {**OVERRIDES, **extra})


def batch_arrays(seed: int = 0, n_valid=(4, 2)):
    """A numpy batch: B images (the second padded at the right), N GT slots of
    which n_valid[i] are valid (things and stuff), masks at stride 4."""
    r = np.random.RandomState(seed)
    img = r.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    pad = np.zeros((B, H, W), bool)
    pad[1, :, 72:] = True
    sizes = np.array([[H, W], [H, 72]], np.int32)
    ids = ((np.arange(L)[None] * 7 + np.arange(B)[:, None]) % 100 + 1).astype(np.int32)
    lang = np.ones((B, L), np.int32)
    lang[1, 12:] = 0
    hm, wm = H // 4, W // 4
    masks = np.zeros((B, N, hm, wm), np.float32)
    boxes = np.zeros((B, N, 4), np.float32)
    labels = np.zeros((B, N), np.int32)
    pm = np.zeros((B, N, L), np.float32)
    is_thing = np.zeros((B, N), bool)
    valid = np.zeros((B, N), bool)
    for b in range(B):
        w_valid = int(sizes[b, 1]) // 4
        for n in range(n_valid[b]):
            y0, x0 = r.randint(0, hm - 4), r.randint(0, w_valid - 4)
            y1, x1 = y0 + r.randint(3, hm - y0 + 1), x0 + r.randint(3, w_valid - x0 + 1)
            masks[b, n, y0:y1, x0:x1] = 1.0
            boxes[b, n] = [(x0 + x1) / 2 / wm, (y0 + y1) / 2 / hm, (x1 - x0) / wm, (y1 - y0) / hm]
            labels[b, n] = r.randint(0, 80)
            toks = r.choice(np.arange(1, 11), r.randint(1, 3), replace=False)
            pm[b, n, toks] = 1.0 / len(toks)
            is_thing[b, n] = n % 3 != 2
            valid[b, n] = True
    return dict(images=img, pad_mask=pad, input_ids=ids, lang_mask=lang, image_sizes=sizes,
                targets=dict(labels=labels, boxes=boxes, masks=masks, positive_map=pm,
                             is_thing=is_thing, valid=valid))


def rank_rows(arrays, rank):
    """Image ``rank`` of a batch from ``batch_arrays``, as a batch of one."""
    take = lambda v: np.ascontiguousarray(v[rank:rank + 1])
    return {k: ({kk: take(vv) for kk, vv in v.items()} if isinstance(v, dict) else take(v))
            for k, v in arrays.items()}


def jax_batch(arrays):
    import jax.numpy as jnp

    from hipie_tpu.losses.criterion import Targets as JTargets
    from hipie_tpu.train.step import TrainBatch as JBatch

    t = JTargets(**{k: jnp.asarray(v) for k, v in arrays["targets"].items()})
    return JBatch(**{k: jnp.asarray(v) for k, v in arrays.items() if k != "targets"}, targets=t)


def torch_batch(arrays, device="cpu"):
    from hipie_torch.losses.criterion import Targets
    from hipie_torch.train.step import TrainBatch

    conv = lambda v: torch.from_numpy(np.asarray(v)).to(device)
    t = Targets(**{k: conv(v) for k, v in arrays["targets"].items()})
    return TrainBatch(images=conv(arrays["images"]), pad_mask=conv(arrays["pad_mask"]),
                      input_ids=conv(arrays["input_ids"]).long(),
                      lang_mask=conv(arrays["lang_mask"]),
                      image_sizes=conv(arrays["image_sizes"]), targets=t)


class JaxKeys(Keys):
    """The port's key interface over a jax.random key: every draw is JAX's."""

    def __init__(self, key):
        self.key = key

    def split(self, n):
        import jax

        return [JaxKeys(k) for k in jax.random.split(self.key, n)]

    def fold_in(self, data):
        import jax

        return JaxKeys(jax.random.fold_in(self.key, data))

    def uniform(self, shape, device=None):
        import jax

        return torch.from_numpy(np.array(jax.random.uniform(self.key, tuple(shape))))

    def randint(self, low, high, shape, device=None):
        import jax

        return torch.from_numpy(np.array(jax.random.randint(self.key, tuple(shape), low, high))
                                ).long()


def to_numpy_tree(tree):
    import jax

    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _fill(path: str, shape, r: np.random.RandomState) -> np.ndarray:
    """A random value for one JAX parameter leaf, by its name: unit-variance
    fan-in scaled kernels (so that the sampling offsets put MSDA's samples off
    the pixel lattice, where bilinear interpolation has one derivative), norms
    near 1, FrozenBN statistics with a positive variance."""
    name = path.rsplit("/", 1)[-1]
    n = lambda s=1.0: (r.standard_normal(shape) * s).astype(np.float32)
    if name == "kernel":
        return n(np.prod(shape[:-1]) ** -0.5)
    if name in ("scale", "weight"):
        return 1.0 + n(0.1)
    if name == "running_var":
        return r.uniform(0.5, 1.5, shape).astype(np.float32)
    if name in ("running_mean",) or (name == "bias" and "_norm" in path):
        return n(0.1)
    if name == "log_scale":
        return np.zeros(shape, np.float32)
    if name == "bias0":
        return -4.6 + n(0.1)
    if name in ("gamma_v", "gamma_l"):
        return 0.1 + n(0.01)
    if name in ("embedding", "level_embed", "tgt_embed", "tgt_embed_bg", "bg_query_refs"):
        return n()
    return n(0.02)


def jax_train_state(arrays, seed: int = 0, **overrides):
    """(JAX model, params, cfg): the parameter tree ``create_train_state``
    builds (its shapes by jax.eval_shape, which traces it without running the
    init), filled from a numpy seed by ``_fill``; ``overrides`` go on top of
    the training config."""
    import jax

    from hipie_tpu.models.hipie import HIPIEModel as JModel
    from hipie_tpu.train.step import create_train_state

    jcfg = train_config(jconfig, **overrides)
    model = JModel(jcfg.model)
    shapes = jax.eval_shape(
        lambda: create_train_state(model, jcfg, jax.random.PRNGKey(seed),
                                   jax_batch(arrays))[0].params)
    r = np.random.RandomState(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda kp, s: _fill("/".join(str(getattr(k, "key", k)) for k in kp), s.shape, r),
        shapes)
    return model, params, jcfg


def port_model_from_jax(params, cfg=None):
    """The port's training model with the JAX training parameters, strictly loaded."""
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.utils.weights import load_from_jax

    cfg = cfg or train_config()
    model = HIPIEModel(cfg.model, train=True)
    load_from_jax(model, to_numpy_tree(params["params"]), cfg)
    return model.train(), cfg


def jax_loss_record(arrays, key_seed: int = 1, **overrides):
    """(record, params): JAX's record of one training loss and its gradient at
    the training config with ``overrides``, from ``jax_train_state``'s
    parameters and the key ``key_seed``, under jax.value_and_grad. The mask
    losses' uncertainty-picked point coordinates are recorded ("coords"), and
    JAX's ``bilinear_sample_fastgrad`` (bf16 image gradient) is swapped for its
    f32 twin. The record holds "total", "grads" (reference names), "terms"
    (each weighted loss dict), "assign" (every matcher assignment) and
    "coords"."""
    import jax

    import hipie_tpu.losses.criterion as jcrit
    import hipie_tpu.ops.bilinear as jbil
    import hipie_tpu.train.step as jstep
    from hipie_torch.utils.export import export_hipie_checkpoint, export_lang_layers

    jmodel, params, jcfg = jax_train_state(arrays, **overrides)
    rec = {"coords": [], "terms": [], "assign": []}
    saved = (jcrit.uncertain_point_coords, jcrit.gather_targets, jstep.apply_weight_dict,
             jbil.bilinear_sample_fastgrad)
    cb = lambda name: (lambda x: rec[name].append(jax.tree_util.tree_map(np.asarray, x)))

    def coords(*a, **k):
        c = saved[0](*a, **k)
        jax.debug.callback(cb("coords"), c, ordered=True)
        return c

    def gather(t, assign):
        jax.debug.callback(cb("assign"), assign, ordered=True)
        return saved[1](t, assign)

    def weights(losses, cfg):
        jax.debug.callback(cb("terms"), losses, ordered=True)
        return saved[2](losses, cfg)

    jcrit.uncertain_point_coords, jcrit.gather_targets, jstep.apply_weight_dict = (
        coords, gather, weights)
    jbil.bilinear_sample_fastgrad = jbil.bilinear_sample
    try:
        key = jax.random.PRNGKey(key_seed)
        args = (params, jax_batch(arrays), key)
        # XLA's cheaper CPU pipeline halves the compile, the bulk of the time
        (total, _), grads = jax.jit(jax.value_and_grad(
            jstep.make_loss_fn(jmodel, jcfg), has_aux=True)).lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 0,
                              "xla_llvm_disable_expensive_passes": True})(*args)
        jax.effects_barrier()
    finally:
        (jcrit.uncertain_point_coords, jcrit.gather_targets, jstep.apply_weight_dict,
         jbil.bilinear_sample_fastgrad) = saved
    cfg = train_config(**overrides)
    grads_np = to_numpy_tree(grads)["params"]
    return {"total": float(total), **rec,
            "grads": {**export_hipie_checkpoint(grads_np, cfg),
                      **export_lang_layers(grads_np, cfg)}}, params


def loss_records(arrays, key_seed: int = 1, **overrides):
    """(JAX record, port record) of one training loss and its gradient from the
    same parameters and batch, at the training config with ``overrides``.

    The JAX record is ``jax_loss_record``'s; the port's ``loss_fn`` runs under
    autograd from the same parameters, draws from the same JAX key (through
    ``JaxKeys``) and replays JAX's point coordinates. Its record holds "total",
    "grads" (the port's ``p.grad``, None where none flowed), "terms",
    "assign", "labels" (optimizer groups), "replayed" and "model"."""
    import jax

    import hipie_torch.losses.criterion as tcrit
    import hipie_torch.train.step as tstep
    from hipie_torch.train.optimizer import freeze_

    want, params = jax_loss_record(arrays, key_seed, **overrides)
    key = jax.random.PRNGKey(key_seed)
    model, cfg = port_model_from_jax(params, train_config(**overrides))
    labels = freeze_(model)
    got = {"coords": [], "terms": [], "assign": []}
    replay = list(want["coords"])
    tsaved = (tcrit.uncertain_point_coords, tcrit.gather_targets, tstep.apply_weight_dict)

    def tgather(t, assign):
        got["assign"].append(assign.numpy().copy())
        return tsaved[1](t, assign)

    def tweights(losses, c):
        got["terms"].append({k: float(v.detach()) for k, v in losses.items()})
        return tsaved[2](losses, c)

    tcrit.uncertain_point_coords = lambda *a, **k: torch.from_numpy(np.array(replay.pop(0)))
    tcrit.gather_targets, tstep.apply_weight_dict = tgather, tweights
    try:
        total, _ = tstep.make_loss_fn(model, cfg)(torch_batch(arrays), JaxKeys(key))
        total.backward()
    finally:
        tcrit.uncertain_point_coords, tcrit.gather_targets, tstep.apply_weight_dict = tsaved
    got.update(total=float(total.detach()), replayed=len(want["coords"]) - len(replay),
               grads={n: p.grad for n, p in model.named_parameters()}, labels=labels,
               model=model)
    return want, got
