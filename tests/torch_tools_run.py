"""One run of the port's entry points on the CPU, shared by the tests that read
it (test_torch_train_driver.py, test_torch_nojax.py).

In a fresh interpreter with JAX, the JAX package and the host libraries the card's
machine lacks (cv2, PIL, PyYAML, torchvision) blocked: ``make_tiny_coco`` (128
x 128, with the refcoco splits), ``train_net --tensorboard`` for two steps of
detection and grounding at tiny_test_config with a ResNet-18 (a checkpoint and
an inline evaluation at step 2), then ``eval_net`` of that checkpoint on the
panoptic val split (2 images) and on a referring split (1 image). The run
writes what each test asserts into ``result.json``.

Under pytest-xdist the two test files may sit on different workers: the first
to ask makes the run under a file lock in the session's shared temporary
directory, the other reads it.
"""

from __future__ import annotations

import fcntl
import json
import os
import subprocess
import sys
from pathlib import Path

from torch_threads import subprocess_env

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
# any import of the JAX package, of JAX (which TensorBoard's TensorFlow would
# take where it finds it) or of a host library the card's machine lacks fails
for name in ("hipie_tpu", "jax", "jaxlib", "flax", "optax", "cv2", "PIL", "yaml", "torchvision"):
    sys.modules[name] = None
import contextlib, dataclasses, io, json, os
import numpy as np
from hipie_torch.config import HIPIEConfig, apply_overrides, tiny_test_config
from hipie_torch.tools import eval_net, make_tiny_coco, train_net
from hipie_torch.train.checkpoint import latest_checkpoint

work = sys.argv[1]
root = os.path.join(work, "data")
make_tiny_coco.main(["--root", root, "--n-train", "6", "--n-val", "4", "--size", "128",
                     "--refcoco"])
os.environ["HIPIE_DATASETS"] = root
cfg = apply_overrides(tiny_test_config(), {
    "model.backbone.resnet_depth": 18, "model.loss.exact_topk": True,
    "solver.warmup_iters": 4, "model.max_matched_masks": 8, "data.crop_size": 128,
    "data.max_text_len": 16, "data.min_size_test": 96, "data.max_size_test": 128,
    "data.test_dataset": "coco_panoptic_val", "test.test_size": [128, 128],
    "data.train_datasets": ["coco_panoptic_train", "refcoco-mixed"],
    "data.dataset_ratios": [1.0, 1.0], "solver.ims_per_batch": 2, "solver.max_iter": 2,
    "solver.checkpoint_period": 2, "test.eval_period": 2, "test.eval_max_images": 1})

def diff(a, b):
    return {k: (diff(v, b[k]) if isinstance(v, dict) else v) for k, v in a.items()
            if v != b[k]}

def lines(d, ind=0):
    for k, v in d.items():
        if isinstance(v, dict):
            yield " " * ind + f"{k}:"
            yield from lines(v, ind + 2)
        elif isinstance(v, (list, tuple)):
            yield " " * ind + f"{k}: [{', '.join(str(x) for x in v)}]"
        else:
            yield " " * ind + f"{k}: {v}"

cfg_file = os.path.join(work, "tiny.yaml")
with open(cfg_file, "w") as f:
    f.write("\n".join(lines(diff(dataclasses.asdict(cfg), dataclasses.asdict(HIPIEConfig())))))
run = os.path.join(work, "run")
out = io.StringIO()
with contextlib.redirect_stdout(out):
    trainer = train_net.main(["--config-file", cfg_file, "--device", "cpu", "--tensorboard",
                              "output_dir", run])
    ckpt = latest_checkpoint(run)
    pano = eval_net.main(["--config-file", cfg_file, "--device", "cpu", "--weights", ckpt,
                          "--dataset", "coco_panoptic_val", "--max-images", "2"])
    ref = eval_net.main(["--config-file", cfg_file, "--device", "cpu", "--weights", ckpt,
                         "--dataset", "refcoco-unc-val", "--max-images", "1"])
tb = os.path.join(run, "tb")
result = {
    "step": trainer.state.step, "tasks": sorted(trainer.train_step),
    "history": [{"task": h["task"], "total_loss": float(h["total_loss"])}
                for h in trainer.history],
    "last_eval": sorted(trainer.history[-1].get("eval", {})),
    "checkpoint": os.path.basename(ckpt), "panoptic": pano, "refcoco": ref,
    "tensorboard": trainer.storage._tb is not None,
    "tb_files": sorted(os.listdir(tb)) if os.path.isdir(tb) else [],
    "stdout": out.getvalue(),
    "leaked": [m for m in sys.modules if m.split(".")[0] in (
        "hipie_tpu", "jax", "jaxlib", "flax", "optax", "cv2", "PIL", "yaml", "torchvision")
        and sys.modules[m] is not None],
}
with open(os.path.join(work, "result.json"), "w") as f:
    json.dump(result, f, default=float)
print("TOOLS_RUN_OK")
"""


def _shared_dir(tmp_path_factory) -> Path:
    """The session's directory that every xdist worker sees (the workers'
    base directories sit in it); without xdist, this process's own."""
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


def tools_run(tmp_path_factory) -> dict:
    """The shared run's result (see the module docstring), made on first use."""
    work = _shared_dir(tmp_path_factory) / "torch_tools_run"
    work.mkdir(exist_ok=True)
    with open(work / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        result = work / "result.json"
        if not result.exists():
            env = subprocess_env(dict(os.environ))
            env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
            r = subprocess.run([sys.executable, "-c", SCRIPT, str(work)], cwd=REPO, env=env,
                               capture_output=True, text=True, timeout=600)
            assert r.returncode == 0 and "TOOLS_RUN_OK" in r.stdout, r.stderr[-3000:]
        return json.loads(result.read_text())
