"""The port's optimizer and training loop on the CPU: two AdamW updates
against optax from the tiny training config's parameters, with and without
gradient accumulation (optax.MultiSteps), the lr schedule against JAX's, the
bf16-moment option refused, and the Trainer over make_train_step.
"""

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


def _adamw_against_optax(jax_state, grad_accum: int):
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
    model, _ = port_model_from_jax(params)
    model.double()
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


def test_adamw_steps_match_optax(jax_state):
    """Two AdamW steps against optax's (see _adamw_against_optax)."""
    _adamw_against_optax(jax_state, 1)


def test_grad_accum_matches_optax_multisteps(jax_state):
    """grad_accum = 2: four micro-steps, two updates, against
    optax.MultiSteps(every_k_schedule=2) around the same chain: the running
    mean of the micro-steps' gradients, clipped after the mean, and the
    schedule counted in updates, not micro-steps."""
    _adamw_against_optax(jax_state, 2)


def test_lr_schedule_matches_jax():
    from hipie_tpu.train.optimizer import lr_schedule as jlr
    from hipie_torch.train.optimizer import lr_schedule

    for ov in ({}, {"solver.warmup_iters": 0}, {"solver.lr_decay_steps": (5, 9)}):
        tcfg, jcfg = train_config(**ov).solver, train_config(jconfig, **ov).solver
        tf, jf = lr_schedule(tcfg, 1e-4), jlr(jcfg, 1e-4)
        for step in (0, 1, 3, 4, 5, 9, 10, 1000, 76658, 80000):
            assert tf(step) == pytest.approx(float(jf(step)), rel=1e-6), (ov, step)


def test_mu_dtype_bf16_is_not_ported():
    from hipie_torch.train.optimizer import GroupedAdamW

    cfg = train_config(**{"solver.mu_dtype": "bfloat16"})
    with pytest.raises(NotImplementedError):
        GroupedAdamW(cfg.solver, torch.nn.Linear(2, 2))


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


def test_trainer_takes_steps_on_the_cpu(tmp_path):
    """Trainer over make_train_step with device="cpu": the lr follows the
    schedule, every trainable parameter gets a finite gradient and the frozen
    ones none, and the parameters move."""
    import dataclasses

    from hipie_torch.train.optimizer import lr_schedule
    from hipie_torch.train.step import create_train_state, make_train_step
    from hipie_torch.train.trainer import Trainer

    cfg = dataclasses.replace(train_config(), output_dir=str(tmp_path))
    state = create_train_state(cfg, seed=0, device="cpu")
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
