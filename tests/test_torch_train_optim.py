"""The port's optimizer and training loop on the CPU: two AdamW updates
against optax from the tiny training config's parameters, with and without
gradient accumulation (optax.MultiSteps), the lr schedule against JAX's, the
bf16 first moment (mu_dtype) against optax on a small module, and the Trainer
over make_train_step.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import copy

import numpy as np
import pytest
import jax
import torch

from test_torch_train_common import (batch_arrays, jax_train_state, port_model_from_jax,
                                     to_numpy_tree, torch_batch, train_config)
import hipie_tpu.config as jconfig


@pytest.fixture(scope="module")
def jax_state():
    arrays = batch_arrays()
    model, params, jcfg = jax_train_state(arrays)
    return arrays, model, params, jcfg


@pytest.fixture(scope="module")
def port_model(jax_state):
    """The port's training model with the JAX parameters, built once; each test
    takes a deep copy."""
    return port_model_from_jax(jax_state[2])[0]


def _adamw_against_optax(jax_state, port_model, grad_accum: int):
    """Two optimizer updates of the port against optax's from the same
    parameters and gradients (random for the trainable leaves, zero for the
    frozen ones, as stop_gradient leaves them), each update made of
    ``grad_accum`` micro-steps: each parameter's update equals optax's
    (clip_by_global_norm + multi_transform AdamW groups with the warmup
    schedule, in optax.MultiSteps when grad_accum > 1). The port steps in
    f64, so that its update (1e-10 of a parameter at the first warmup step of
    the text encoder's group) is not lost to the rounding of params + update;
    optax's f32 update is the reference. Limits, relative in norm: 1e-5 for
    the first update; 3e-5 for the second, where optax's own f32 bias
    correction 1 - 0.999^2 = 0.001999 cancels to ~3e-5 relative (half of it
    reaching the update through the square root)."""
    import dataclasses

    from hipie_tpu.train.optimizer import build_optimizer, param_labels as jlabels

    from hipie_torch.train.optimizer import GroupedAdamW
    from hipie_torch.utils.export import export_hipie_checkpoint

    _, _, params, jcfg = jax_state
    jsolver = dataclasses.replace(jcfg.solver, grad_accum=grad_accum)
    r = np.random.RandomState(5 + grad_accum)
    labels = jlabels(params)
    grads = [jax.tree_util.tree_map(
        lambda p, lab: np.zeros(p.shape, np.float32) if lab == "frozen"
        else r.randn(*p.shape).astype(np.float32) * 1e-2, params, labels)
        for _ in range(2 * grad_accum)]
    tx = build_optimizer(jsolver, params)
    update = jax.jit(tx.update)
    st = jax.jit(tx.init)(params)
    cfg = train_config(**{"solver.grad_accum": grad_accum})
    p, want_steps = params, []
    for i, g in enumerate(grads):
        upd, st = update(g, st, p)
        # optax.apply_updates' f32 sum, in numpy (eager JAX compiles per leaf)
        p = jax.tree_util.tree_map(lambda a, b: np.asarray(a) + np.asarray(b), p, upd)
        if (i + 1) % grad_accum == 0:
            want_steps.append(export_hipie_checkpoint(to_numpy_tree(upd)["params"], cfg))
    model = copy.deepcopy(port_model).double()
    opt = GroupedAdamW(cfg.solver, model)
    for step, (want, tol) in enumerate(zip(want_steps, (1e-5, 3e-5))):
        before = {n: q.detach().clone() for n, q in model.named_parameters()}
        for i, g in enumerate(grads[step * grad_accum:(step + 1) * grad_accum]):
            sd = export_hipie_checkpoint(to_numpy_tree(g)["params"], cfg)
            for n, q in model.named_parameters():
                q.grad = torch.from_numpy(sd[n].astype(np.float64)) if q.requires_grad else None
            applied = opt.step()
            assert (applied is not None) == (i == grad_accum - 1), (step, i)
        moved = 0
        for n, q in model.named_parameters():
            got = (q.detach() - before[n]).numpy()
            w = want[n].astype(np.float64)
            if opt.labels[n] == "frozen":
                assert not got.any() and not w.any(), n
                continue
            err = np.linalg.norm(got - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= tol, (step, n, err)
            moved += 1
        assert moved > 100
    assert opt.updates == 2


def test_adamw_steps_match_optax(jax_state, port_model):
    """Two AdamW steps against optax's (see _adamw_against_optax)."""
    _adamw_against_optax(jax_state, port_model, 1)


def test_grad_accum_matches_optax_multisteps(jax_state, port_model):
    """grad_accum = 2: four micro-steps, two updates, against
    optax.MultiSteps(every_k_schedule=2) around the same chain: the running
    mean of the micro-steps' gradients, clipped after the mean, and the
    schedule counted in updates, not micro-steps."""
    _adamw_against_optax(jax_state, port_model, 2)


def test_lr_schedule_matches_jax():
    from hipie_tpu.train.optimizer import lr_schedule as jlr
    from hipie_torch.train.optimizer import lr_schedule

    for ov in ({}, {"solver.warmup_iters": 0}, {"solver.lr_decay_steps": (5, 9)}):
        tcfg, jcfg = train_config(**ov).solver, train_config(jconfig, **ov).solver
        tf, jf = lr_schedule(tcfg, 1e-4), jlr(jcfg, 1e-4)
        for step in (0, 1, 3, 4, 5, 9, 10, 1000, 76658, 80000):
            assert tf(step) == pytest.approx(float(jf(step)), rel=1e-6), (ov, step)


def test_mu_dtype_bf16_is_not_ported():
    """Of the first moment's dtypes, the port takes f32 and bf16 (optax's
    mu_dtype); any other is not ported and raises."""
    from hipie_torch.train.optimizer import GroupedAdamW

    for dtype in ("float16", "float64"):
        with pytest.raises(NotImplementedError, match="mu_dtype"):
            GroupedAdamW(train_config(**{"solver.mu_dtype": dtype}).solver,
                         torch.nn.Linear(2, 2))


# (port name, JAX path, shape): one leaf of each of the optimizer's six labels
# (frozen, lang, vl, backbone, offsets, base) under both packages' naming rules
LABEL_LEAVES = [
    ("detr.backbone.stem.weight", "backbone/stem_conv1/kernel", (3, 4)),
    ("text_encoder.dense.weight", "text_encoder/dense/kernel", (6, 5)),
    ("detr.vl_layers.0.weight", "transformer/vl_layers_0/v_proj/kernel", (4, 4)),
    ("detr.backbone.res3.weight", "backbone/res3_0/conv1/kernel", (8, 3)),
    ("detr.backbone.res3.bias", "backbone/res3_0/conv1/bias", (3,)),
    ("detr.sampling_offsets.weight", "transformer/sampling_offsets/kernel", (5, 7)),
    ("detr.class_embed.weight", "class_embed/kernel", (7, 9)),
    ("detr.class_embed.bias", "class_embed/bias", (9,)),
]


def _labelled_module(values):
    """A module whose parameters carry LABEL_LEAVES' port names."""
    root = torch.nn.Module()
    for (name, _, _), v in zip(LABEL_LEAVES, values):
        *path, leaf = name.split(".")
        m = root
        for part in path:
            if not hasattr(m, part):
                m.add_module(part, torch.nn.Module())
            m = getattr(m, part)
        m.register_parameter(leaf, torch.nn.Parameter(torch.from_numpy(v.copy())))
    return root


def test_mu_dtype_bf16_matches_optax(tmp_path):
    """solver.mu_dtype = "bfloat16" against JAX's build_optimizer (optax
    scale_by_adam(mu_dtype=bfloat16) in each group's chain, clipping,
    multi_transform) on one leaf of every label, five updates from the same
    gradients: the stored first moment bf16 and equal to optax's bit for bit
    after the first update, the parameters within 1e-6 (1 + |p|) after the
    fifth; then with grad_accum 2 (optax.MultiSteps), two updates of two
    micro-steps each at the same limit; and a checkpoint of the state
    round-trips bit-equal, its first moment still bf16."""
    import optax

    from hipie_tpu.train.optimizer import build_optimizer, param_labels as jlabels

    from hipie_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from hipie_torch.train.optimizer import GroupedAdamW
    from hipie_torch.train.step import TrainState

    def nest(flat):
        tree = {}
        for (_, path, _), v in zip(LABEL_LEAVES, flat):
            *dirs, leaf = path.split("/")
            d = tree
            for part in dirs:
                d = d.setdefault(part, {})
            d[leaf] = v
        return tree

    def leaves(tree):
        out = []
        for _, path, _ in LABEL_LEAVES:
            d = tree
            for part in path.split("/"):
                d = d[part]
            out.append(d)
        return out

    r = np.random.RandomState(0)
    values = [r.randn(*shape).astype(np.float32) for _, _, shape in LABEL_LEAVES]
    grads = [[r.randn(*shape).astype(np.float32) * 0.05 for _, _, shape in LABEL_LEAVES]
             for _ in range(5)]
    overrides = {"solver.mu_dtype": "bfloat16", "solver.base_lr": 1e-3, "solver.lang_lr": 1e-3,
                 "solver.vl_lr": 1e-3}
    jtree = nest([jax.numpy.asarray(v) for v in values])
    assert sorted(set(leaves(jlabels(jtree)))) == ["backbone", "base", "frozen", "lang",
                                                   "offsets", "vl"]
    for accum in (1, 2):
        cfg_over = {**overrides, "solver.grad_accum": accum}
        jsolver = train_config(jconfig, **cfg_over).solver
        tx = build_optimizer(jsolver, jtree)
        st, p = tx.init(jtree), jtree
        model = _labelled_module(values)
        opt = GroupedAdamW(train_config(**cfg_over).solver, model)
        assert set(opt.labels.values()) == {"backbone", "base", "frozen", "lang", "offsets", "vl"}
        params = dict(model.named_parameters())
        for i, g in enumerate(grads[:5 if accum == 1 else 4]):
            frozen = [opt.labels[n] == "frozen" for n, _, _ in LABEL_LEAVES]
            g = [np.zeros_like(x) if f else x for x, f in zip(g, frozen)]
            upd, st = tx.update(nest([jax.numpy.asarray(x) for x in g]), st, p)
            p = optax.apply_updates(p, upd)
            for (n, _, _), x in zip(LABEL_LEAVES, g):
                params[n].grad = None if opt.labels[n] == "frozen" else torch.from_numpy(x)
            opt.step()
            if i == 0 and accum == 1:
                adam = [s for s in jax.tree_util.tree_leaves(
                    st, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
                    if isinstance(s, optax.ScaleByAdamState)]
                for (n, _, _), f in zip(LABEL_LEAVES, frozen):
                    if f:
                        continue
                    mu = opt.opt.state[params[n]]["exp_avg"]
                    want = [leaves(a.mu)[[x for x, _, _ in LABEL_LEAVES].index(n)] for a in adam]
                    want = [w for w in want if not isinstance(w, optax.MaskedNode)]
                    assert mu.dtype == torch.bfloat16 and len(want) == 1, n
                    assert want[0].dtype == jax.numpy.bfloat16
                    assert np.array_equal(mu.view(torch.int16).numpy(),
                                          np.asarray(want[0]).view(np.int16)), n
        assert opt.updates == (5 if accum == 1 else 2)
        for (n, _, _), w in zip(LABEL_LEAVES, leaves(p)):
            w = np.asarray(w)
            got = params[n].detach().numpy()
            assert not np.array_equal(got, values[[x for x, _, _ in LABEL_LEAVES].index(n)]) \
                or opt.labels[n] == "frozen", n
            np.testing.assert_array_less(np.abs(got - w), 1e-6 * (1 + np.abs(w)), err_msg=n)
    path = save_checkpoint(str(tmp_path), TrainState(model, opt, 4), 4)
    fresh_model = _labelled_module(values)
    fresh = TrainState(fresh_model, GroupedAdamW(train_config(**cfg_over).solver, fresh_model), 0)
    fresh = restore_checkpoint(path, fresh)
    before, after = opt.opt.state_dict()["state"], fresh.optimizer.opt.state_dict()["state"]
    assert before.keys() == after.keys() and fresh.optimizer.updates == 2
    for k in before:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            x, y = before[k][key], after[k][key]
            assert x.dtype == y.dtype and (key != "exp_avg" or y.dtype == torch.bfloat16)
            assert torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), fresh_model.parameters()))


def test_grad_accum_applies_the_mean_every_kth_step():
    """grad_accum = 2 (optax.MultiSteps): the first call only accumulates; the
    second applies one update from the mean gradient, the same as one step
    with that mean."""
    from hipie_torch.train.optimizer import GroupedAdamW

    torch.manual_seed(0)
    acc, one = torch.nn.Linear(4, 3), torch.nn.Linear(4, 3)
    one.load_state_dict(acc.state_dict())
    opt_acc = GroupedAdamW(train_config(**{"solver.grad_accum": 2}).solver, acc)
    opt_one = GroupedAdamW(train_config().solver, one)
    g1, g2 = [torch.randn(3, 4), torch.randn(3)], [torch.randn(3, 4), torch.randn(3)]
    start = [p.detach().clone() for p in acc.parameters()]
    for p, g in zip(acc.parameters(), g1):
        p.grad = g.clone()
    assert opt_acc.step() is None and opt_acc.updates == 0
    assert all(torch.equal(p, s) for p, s in zip(acc.parameters(), start))
    for p, g in zip(acc.parameters(), g2):
        p.grad = g.clone()
    assert opt_acc.step() is not None and opt_acc.updates == 1
    for p, a, b in zip(one.parameters(), g1, g2):
        p.grad = (a + b) / 2
    opt_one.step()
    for p, q in zip(acc.parameters(), one.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-9)


def test_trainer_takes_steps_on_the_cpu(port_model, tmp_path):
    """Trainer over make_train_step with device="cpu" (the shared model's
    copy): the lr follows the schedule, every trainable parameter gets a finite
    gradient and the frozen ones none, and the parameters move."""
    import dataclasses

    from hipie_torch.train.optimizer import lr_schedule
    from hipie_torch.train.step import create_train_state, make_train_step
    from hipie_torch.train.trainer import Trainer

    cfg = dataclasses.replace(train_config(), output_dir=str(tmp_path))
    state = create_train_state(cfg, device="cpu", model=copy.deepcopy(port_model))
    start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    batches = [torch_batch(batch_arrays(seed)) for seed in range(3)]
    trainer = Trainer(cfg, state, make_train_step(cfg, state, device="cpu"), iter(batches),
                      device="cpu")
    state = trainer.train(max_iter=3)
    assert state.step == 3 and state.optimizer.updates == 3
    sched = lr_schedule(cfg.solver, cfg.solver.base_lr)
    assert [h["lr"] for h in trainer.history] == [sched(i) for i in range(3)]
    assert all(np.isfinite(h["total_loss"]) for h in trainer.history)
    for n, p in state.model.named_parameters():
        if state.optimizer.labels[n] == "frozen":
            assert p.grad is None and torch.equal(p, start[n]), n
        else:
            assert p.grad is not None and torch.isfinite(p.grad).all(), n
    assert sum(not torch.equal(p, start[n]) for n, p in state.model.named_parameters()) > 200
    assert (tmp_path / "metrics.json").is_file()
