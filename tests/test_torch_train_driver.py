"""The port's training driver on the CPU: checkpoints (hipie_torch/train/
checkpoint.py), the Trainer's tasks, periodic saves and evaluation, and the
train_net / eval_net entry points, at tiny_test_config with a ResNet-18.

Checkpoints must round-trip bit for bit (model, AdamW moments and step counts,
the schedule's update count, the step), and a step taken after a resume must
equal, bit for bit, the step the live state takes on the same batch with the
same keys. A JAX parameter tree exported with ``export_hipie_checkpoint`` and
saved as a .pth loads through ``--weights`` under the same names.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import dataclasses
import os

import numpy as np
import pytest
import torch

from test_torch_train_common import batch_arrays, train_config, torch_batch

from hipie_torch.train.checkpoint import (latest_checkpoint, load_weights, resume_or_load,
                                          save_checkpoint)
from hipie_torch.train.step import TrainState, create_train_state, make_train_step
from hipie_torch.train.trainer import Trainer
from hipie_torch.utils.rng import GeneratorKeys


def _keys(seed=0):
    return GeneratorKeys(torch.Generator().manual_seed(seed))


def _bits_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)), k
        elif isinstance(x, dict):
            _bits_equal(x, y)
        elif isinstance(x, list):
            assert len(x) == len(y), k
            for i, (u, v) in enumerate(zip(x, y)):
                _bits_equal({i: u}, {i: v})
        else:
            assert x == y, k


def _opt_state(opt):
    sd = opt.state_dict()
    return {"state": sd["adamw"]["state"], "updates": sd["updates"], "micro": sd["micro"],
            "acc": sd["acc"]}


@pytest.fixture(scope="module")
def trained():
    """A tiny training state after one step (AdamW's moments set), its config
    and its step function."""
    cfg = train_config()
    state = create_train_state(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, state, device="cpu")
    state, _ = step(state, torch_batch(batch_arrays(0)), _keys(1))
    return cfg, state, step


def test_checkpoint_round_trip_is_bit_equal(trained, tmp_path):
    cfg, state, _ = trained
    path = save_checkpoint(str(tmp_path), state, state.step)
    assert os.path.basename(path) == "model_0000001.pth" == latest_checkpoint(str(tmp_path))[-17:]
    fresh = create_train_state(cfg, seed=5, device="cpu")
    fresh, resumed = resume_or_load(str(tmp_path), fresh)
    assert resumed and fresh.step == 1 and fresh.optimizer.updates == 1
    _bits_equal(fresh.model.state_dict(), state.model.state_dict())
    _bits_equal(_opt_state(fresh.optimizer), _opt_state(state.optimizer))


def test_step_after_resume_equals_the_live_step(trained, tmp_path):
    cfg, state, step = trained
    save_checkpoint(str(tmp_path), state, state.step)
    fresh, _ = resume_or_load(str(tmp_path), create_train_state(cfg, seed=9, device="cpu"))
    batch = torch_batch(batch_arrays(7))
    fresh, m_resumed = make_train_step(cfg, fresh, device="cpu")(fresh, batch, _keys(3))
    live = dataclasses.replace(state)
    live, m_live = step(live, batch, _keys(3))
    assert fresh.step == live.step == 2
    assert float(m_resumed["total_loss"]) == float(m_live["total_loss"])
    _bits_equal(fresh.model.state_dict(), live.model.state_dict())
    _bits_equal(_opt_state(fresh.optimizer), _opt_state(live.optimizer))


def test_interrupted_save_recovery_and_model_best(trained, tmp_path, capsys):
    """A save cut between its renames leaves .old (the previous file) or .tmp
    (the new one, whole): latest_checkpoint finds either. model_best is saved
    under its own name and leaves the marker alone."""
    _, state, _ = trained
    d = str(tmp_path)
    path = save_checkpoint(d, state, 2)
    best = save_checkpoint(d, state, 2, name="model_best", update_marker=False)
    assert os.path.basename(best) == "model_best.pth" and latest_checkpoint(d) == path
    os.replace(path, path + ".old")
    assert latest_checkpoint(d) == path + ".old"
    os.replace(path + ".old", path + ".tmp")
    assert latest_checkpoint(d) == path + ".tmp"
    assert "interrupted save" in capsys.readouterr().out
    os.remove(path + ".tmp")
    assert latest_checkpoint(d) is None
    save_checkpoint(d, state, 2)                # over an existing file: no .old left
    save_checkpoint(d, state, 2)
    assert sorted(os.listdir(d)) == ["last_checkpoint", "model_0000002.pth", "model_best.pth"]


def test_weights_skip_mismatched_shapes_and_bad_paths_raise(trained, tmp_path, capsys):
    cfg, state, _ = trained
    sd = {k: v.clone() + 1 for k, v in state.model.state_dict().items()}
    name = next(k for k, v in sd.items() if v.ndim == 2)
    sd[name] = torch.zeros(3, 3)
    good = str(tmp_path / "w.pth")
    torch.save(sd, good)
    target = TrainState(create_train_state(cfg, seed=4, device="cpu").model, None)
    copied, skipped = load_weights(good, target)
    assert skipped == [name] and len(copied) == len(sd) - 1
    assert name in capsys.readouterr().out
    own = target.model.state_dict()
    assert all(torch.equal(own[k], sd[k]) for k in copied)
    with pytest.raises(FileNotFoundError):
        load_weights(str(tmp_path / "missing.pth"), target)
    torch.save([1, 2], str(tmp_path / "list.pth"))
    with pytest.raises(ValueError, match="not a state_dict"):
        load_weights(str(tmp_path / "list.pth"), target)
    with pytest.raises(NotImplementedError):
        load_weights(str(tmp_path / "R-50.pkl"), target)


def test_trainer_tasks_periodic_saves_and_eval(tmp_path):
    """(task, batch) pairs dispatch to a dict of steps; saves every
    checkpoint_period and at max_iter; eval_fn every eval_period with the
    best value kept as model_best, which a resumed trainer reads back."""
    cfg = dataclasses.replace(
        train_config(**{"solver.checkpoint_period": 2, "test.eval_period": 2}),
        output_dir=str(tmp_path))
    state = create_train_state(cfg, seed=0, device="cpu")
    ran = []

    def fake_step(task):
        # the real steps are held against JAX elsewhere; here only the dispatch
        def step(st, batch, keys):
            ran.append((task, batch.images.device.type))
            st.step += 1
            st.optimizer.updates += 1
            return st, {"total_loss": torch.tensor(float(len(ran)))}
        return step

    steps = {t: fake_step(t) for t in ("detection", "grounding")}
    tasks = ["detection", "grounding", "detection"]
    batches = iter([(t, torch_batch(batch_arrays(i))) for i, t in enumerate(tasks)])
    seen = []

    def eval_fn(model):
        seen.append(model)
        return {"score": 10.0 - len(seen)}

    trainer = Trainer(cfg, state, steps, batches, eval_fn=eval_fn, device="cpu")
    state = trainer.train(max_iter=3)
    assert [h["task"] for h in trainer.history] == tasks and state.step == 3
    assert ran == [(t, "cpu") for t in tasks]
    assert all("total_loss_detection" in h or "total_loss_grounding" in h
               for h in trainer.history)
    assert seen == [state.model] and trainer.history[1]["eval"] == {"score": 9.0}
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".pth")) == [
        "model_0000002.pth", "model_0000003.pth", "model_best.pth"]
    with open(tmp_path / "best_checkpoint") as f:
        assert f.read().strip() == "model_best iter=2 score=9.0"
    again = Trainer(cfg, create_train_state(cfg, seed=1, device="cpu"), steps, iter([]),
                    device="cpu")
    assert again.resume_or_load() and again.state.step == 3 and again._best_metric == 9.0


def _tiny_yaml(path, **extra):
    """tiny_test_config (ResNet-18) as a YAML file the entry points read."""
    from hipie_torch.config import HIPIEConfig

    def diff(a, b):
        out = {}
        for k, v in a.items():
            if isinstance(v, dict):
                d = diff(v, b[k])
                if d:
                    out[k] = d
            elif v != b[k]:
                out[k] = v
        return out

    def lines(d, ind=0):
        for k, v in d.items():
            if isinstance(v, dict):
                yield " " * ind + f"{k}:"
                yield from lines(v, ind + 2)
            elif isinstance(v, (list, tuple)):
                yield " " * ind + f"{k}: [{', '.join(str(x) for x in v)}]"
            else:
                yield " " * ind + f"{k}: {v}"

    cfg = train_config(**{"data.crop_size": 128, "data.max_text_len": 16,
                          "data.min_size_test": 96, "data.max_size_test": 128,
                          "data.test_dataset": "coco_panoptic_val", "test.test_size": [128, 128],
                          "solver.ims_per_batch": 2, **extra})
    d = diff(dataclasses.asdict(cfg), dataclasses.asdict(HIPIEConfig()))
    path.write_text("\n".join(lines(d)) + "\n")
    return str(path)


def test_train_net_and_eval_net_on_the_cpu(tmp_path_factory):
    """train_net for two steps of detection and grounding (a checkpoint and an
    inline evaluation at step 2, --tensorboard on), then eval_net of that
    checkpoint, from the run that test_torch_nojax.py reads too
    (tests/torch_tools_run.py)."""
    from torch_tools_run import tools_run

    run = tools_run(tmp_path_factory)
    assert run["step"] == 2 and run["tasks"] == ["detection", "grounding"]
    assert all(np.isfinite(h["total_loss"]) for h in run["history"])
    assert "panoptic/PQ" in run["last_eval"]
    assert run["checkpoint"] == "model_0000002.pth"
    assert run["panoptic"]["images"] == 2 and np.isfinite(run["panoptic"]["panoptic/PQ"])
    assert '"panoptic/PQ"' in run["stdout"]
    # --tensorboard: scalars mirrored where torch.utils.tensorboard imports,
    # one line saying so where it does not
    if run["tensorboard"]:
        assert any(f.startswith("events.out.tfevents") for f in run["tb_files"])
    else:
        assert "torch.utils.tensorboard does not import" in run["stdout"]


def test_tensorboard_off_says_so_and_carries_on(tmp_path, monkeypatch, capsys):
    """Where torch.utils.tensorboard does not import, train_net --tensorboard
    says so in one line and builds the trainer without it (the storage, JAX's
    copy, turns it off silently)."""
    import sys

    from hipie_torch.tools import train_net

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg_file = _tiny_yaml(tmp_path / "tiny.yaml", **{"data.train_datasets": ["coco_panoptic_train"],
                                                     "data.dataset_ratios": [1.0]})
    monkeypatch.setattr("hipie_torch.data.loader.TrainLoader.__init__",
                        lambda self, *a, **k: setattr(self, "tasks", ["detection"]))
    trainer, _ = train_net.build_trainer(["--config-file", cfg_file, "--device", "cpu",
                                          "--tensorboard", "--no-eval", "output_dir",
                                          str(tmp_path / "run")])
    assert trainer.storage._tb is None
    assert capsys.readouterr().out.splitlines() == [
        "[train_net] --tensorboard: torch.utils.tensorboard does not import; training without it"]


def test_jax_export_loads_through_weights(tmp_path):
    """A JAX training parameter tree (shapes from jax.eval_shape, values from a
    numpy seed), exported and saved as a .pth, loads through --weights into
    every tensor of the port's training model."""
    from test_torch_train_common import jax_train_state, to_numpy_tree

    from hipie_torch.utils.export import export_hipie_checkpoint

    _, params, _ = jax_train_state(batch_arrays(0), seed=3)
    cfg = train_config()
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          export_hipie_checkpoint(to_numpy_tree(params["params"]), cfg).items()}
    path = str(tmp_path / "jax_export.pth")
    torch.save(sd, path)
    state = create_train_state(cfg, seed=0, device="cpu")
    state, resumed = resume_or_load(str(tmp_path / "none"), state, path)
    own = state.model.state_dict()
    assert not resumed and set(sd) == set(own)
    assert all(torch.equal(own[k], sd[k].to(own[k].dtype)) for k in sd)
