"""The port stands alone: it runs without JAX and without the JAX package,
imports neither anywhere, serves and trains on the card by default, and
chip_smoke.py refuses to run without a card.

The runs are in fresh interpreters, so nothing this test process imported
leaks in; there ``sys.modules["hipie_tpu"] = None`` makes any import of the JAX
package fail.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("hipie_tpu", "jax", "flax")

BLOCK_JAX_PACKAGE = r"""
import sys
sys.modules["hipie_tpu"] = None        # any import of the JAX package now fails
"""

TINY_SLICE = BLOCK_JAX_PACKAGE + r"""
import numpy as np
import torch
from hipie_torch.config import apply_overrides, tiny_test_config
from hipie_torch.models.backbone.vit import VIT_VARIANTS
from hipie_torch.models.hipie import HIPIEModel, hipie_inference
from hipie_torch.models.postprocess import ClassMaps
from hipie_torch.utils.weights import random_init_

VIT_VARIANTS["vit_narrow"] = (64, 4, 4, 0.0)
cfg = apply_overrides(tiny_test_config(), {
    "model.backbone.name": "vit_narrow", "model.backbone.vit_img_size": 128,
    "model.backbone.vit_window_size": 4, "model.still_cls_for_encoder": True})
model = HIPIEModel(cfg.model).eval()
random_init_(model, torch.Generator().manual_seed(0))
L, C = cfg.model.text.max_query_len, 5
maps = ClassMaps(torch.eye(C, L), torch.eye(C, L, dtype=torch.bool), torch.arange(C) < 3)
ids = torch.arange(L)[None] % 16
am = torch.ones(1, L, dtype=torch.long)
pad = torch.zeros(1, 128, 128, dtype=torch.bool)
with torch.inference_mode():
    hidden = model.encode_text(ids, am)
    img = torch.randint(0, 256, (1, 128, 128, 3), dtype=torch.uint8)
    out = model(img, pad, ids, am, torch.tensor([[128, 128]]), lang_hidden=hidden)
    res = hipie_inference(out, maps, cfg.test, cfg.model, pad_mask_s4=pad[0][::4, ::4])
assert res.sem_seg.shape == (C, 32, 32) and torch.isfinite(res.sem_seg).all()
assert not [m for m in sys.modules if m.startswith(("jax", "flax"))
            or (m.startswith("hipie_tpu") and sys.modules[m] is not None)]
print("NOJAX_OK")
"""

# The predictor on the tiny config (a ResNet-50 backbone), with the port's own
# config, tokenizer and prompt builders.
PREDICTOR = BLOCK_JAX_PACKAGE + r"""
import numpy as np
import torch
from hipie_torch.config import apply_overrides, tiny_test_config
from hipie_torch.models.text.tokenizer import WordPieceTokenizer
from hipie_torch.models.hipie import HIPIEModel
from hipie_torch.predictor import HIPIEPredictor, PartSegmDemo
from hipie_torch.utils.weights import random_init_

cfg = apply_overrides(tiny_test_config(), {
    "data.min_size_test": 48, "data.max_size_test": 96,
    "data.max_text_len": 16, "model.text.max_query_len": 16})
model = HIPIEModel(cfg.model).eval()
random_init_(model, torch.Generator().manual_seed(0))
tok = WordPieceTokenizer.toy(words=["person", "dog", "sky", "head"])
pred = HIPIEPredictor(cfg, model, tok, bucket=(64, 96), device="cpu")
img = np.random.RandomState(0).randint(0, 256, (50, 80, 3)).astype(np.uint8)
res = PartSegmDemo(pred, ["head"]).forward_panoptic(img, ["person", "dog"], ["sky"], do_part=True)
assert res["panoptic_seg"][0].shape == (50, 80) and res["parts"]["part_sem_seg"].shape == (50, 80)
res = pred(img, task="grounding", expressions="the dog")
assert res["instances"]["masks"].shape == (1, 50, 80)
assert not [m for m in sys.modules if m.startswith(("jax", "flax", "cv2"))
            or (m.startswith("hipie_tpu") and sys.modules[m] is not None)]
print("NOJAX_OK")
"""

# Two training steps on the tiny config through the port's own step, optimizer,
# criterion, matchers, CDN and Trainer, on the CPU.
TRAIN = BLOCK_JAX_PACKAGE + r"""
import dataclasses, tempfile
import numpy as np
import torch
from hipie_torch.config import apply_overrides, tiny_test_config
from hipie_torch.losses.criterion import Targets
from hipie_torch.train.step import TrainBatch, create_train_state, make_train_step
from hipie_torch.train.trainer import Trainer

cfg = apply_overrides(tiny_test_config(), {"model.backbone.resnet_depth": 18})
cfg = dataclasses.replace(cfg, output_dir=tempfile.mkdtemp())
state = create_train_state(cfg, seed=0, device="cpu")
b, n, L = 1, 4, cfg.model.text.max_query_len
masks = torch.zeros(b, n, 24, 24)
masks[0, 0, 3:13, 5:18] = 1.0
masks[0, 1, 12:24, 0:9] = 1.0
t = Targets(torch.tensor([[3, 7, 0, 0]]), torch.tensor([[[0.47, 0.34, 0.56, 0.44],
                                                         [0.19, 0.75, 0.38, 0.5]] + [[0.5] * 4] * 2]),
            masks, torch.eye(n, L)[None], torch.tensor([[True, False, True, True]]),
            torch.tensor([[True, True, False, False]]))
batch = TrainBatch(torch.randint(0, 256, (b, 96, 96, 3)), torch.zeros(b, 96, 96, dtype=torch.bool),
                   torch.arange(L)[None] % 16, torch.ones(b, L, dtype=torch.long),
                   torch.tensor([[96, 96]]), t)
trainer = Trainer(cfg, state, make_train_step(cfg, state, device="cpu"), iter([batch] * 2),
                  device="cpu")
state = trainer.train(max_iter=2)
assert state.step == 2 and all(np.isfinite(h["total_loss"]) for h in trainer.history)
assert not [m for m in sys.modules if m.startswith(("jax", "flax", "optax"))
            or (m.startswith("hipie_tpu") and sys.modules[m] is not None)]
print("NOJAX_OK")
"""


# One training step of a narrow ViT with drop path and activation checkpointing
# (backbone and transformer), on the CPU.
TRAIN_VIT = BLOCK_JAX_PACKAGE + r"""
import dataclasses, tempfile
import torch
from hipie_torch.config import apply_overrides, tiny_test_config
from hipie_torch.models.backbone.vit import VIT_VARIANTS
from hipie_torch.train.step import create_train_state, make_train_step
from hipie_torch.train.synthetic import train_batches
from hipie_torch.utils.rng import GeneratorKeys

VIT_VARIANTS["vit_narrow"] = (64, 4, 4, 0.5)
cfg = apply_overrides(tiny_test_config(), {
    "model.backbone.name": "vit_narrow", "model.backbone.vit_img_size": 128,
    "model.backbone.vit_window_size": 4, "model.still_cls_for_encoder": True,
    "model.backbone.vit_remat": True, "model.transformer.remat": True})
cfg = dataclasses.replace(cfg, output_dir=tempfile.mkdtemp())
state = create_train_state(cfg, seed=0, device="cpu")
step = make_train_step(cfg, state, device="cpu")
batch = train_batches(cfg, 1, 0, img=128, slots=6, batch=2)[0]
state, metrics = step(state, batch, GeneratorKeys(torch.Generator().manual_seed(0)))
assert state.step == 1 and torch.isfinite(metrics["total_loss"])
assert not [m for m in sys.modules if m.startswith(("jax", "flax", "optax"))
            or (m.startswith("hipie_tpu") and sys.modules[m] is not None)]
print("NOJAX_OK")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_without_jax(script):
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX_OK" in r.stdout


def test_tiny_slice_runs_without_jax():
    _run_without_jax(TINY_SLICE)


def test_predictor_runs_without_jax():
    _run_without_jax(PREDICTOR)


def test_training_runs_without_jax():
    _run_without_jax(TRAIN)


def test_vit_training_runs_without_jax():
    _run_without_jax(TRAIN_VIT)


def _port_sources():
    return sorted((REPO / "hipie_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "profile_serve.py", REPO / "msda_bench.py",
        REPO / "vit_bwd_bench.py", REPO / "msda_bwd_bench.py"]


def _forbidden_imports(path):
    """(line, module) of every import of hipie_tpu, jax or flax in one file."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [(node.lineno, n) for n in names if n.split(".")[0] in FORBIDDEN]
    return found


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """Every import statement of hipie_torch/, chip_smoke.py, profile_serve.py and
    the kernel benches (msda_bench.py, vit_bwd_bench.py, msda_bwd_bench.py), at any
    depth (inside functions too), stays out of hipie_tpu, jax and flax."""
    sources = _port_sources()
    assert len(sources) > 30 and REPO / "hipie_torch" / "config.py" in sources
    bad = {str(p.relative_to(REPO)): f for p in sources if (f := _forbidden_imports(p))}
    assert not bad, bad


def test_the_import_check_sees_nested_and_aliased_imports(tmp_path):
    src = tmp_path / "probe.py"
    src.write_text("import os\nimport jax.numpy as jnp\n\ndef f():\n"
                   "    from hipie_tpu.config import tiny_test_config\n"
                   "    import flax.linen, numpy\n    from . import hipie_tpu\n")
    assert _forbidden_imports(src) == [(2, "jax.numpy"), (5, "hipie_tpu.config"),
                                       (6, "flax.linen")]


def test_predictor_defaults_to_the_card():
    """device defaults to "cuda"; without a card, building a predictor raises
    instead of serving on the CPU, and device="cpu" is the way to ask for it."""
    import inspect

    import torch
    from hipie_torch.config import tiny_test_config
    from hipie_torch.models.text.tokenizer import WordPieceTokenizer
    from hipie_torch.predictor import HIPIEPredictor

    default = inspect.signature(HIPIEPredictor).parameters["device"].default
    assert torch.device(default).type == "cuda"
    cfg, tok = tiny_test_config(), WordPieceTokenizer.toy()
    model = torch.nn.Linear(2, 2)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card refusal")
    with pytest.raises((RuntimeError, AssertionError)):
        HIPIEPredictor(cfg, model, tok)
    pred = HIPIEPredictor(cfg, model, tok, device="cpu")
    assert pred.device.type == "cpu" and model.weight.device.type == "cpu"


@pytest.mark.parametrize("entry", ["create_train_state", "make_train_step", "Trainer"])
def test_training_defaults_to_the_card(entry):
    """The training entry points take device="cuda" by default and, without a
    card, raise instead of training on the CPU."""
    import inspect

    import torch
    from hipie_torch.config import tiny_test_config
    from hipie_torch.train import step, trainer

    fn = getattr(trainer if entry == "Trainer" else step, entry)
    assert torch.device(inspect.signature(fn).parameters["device"].default).type == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card refusal")
    cfg = tiny_test_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "create_train_state":
            fn(cfg)
        elif entry == "make_train_step":
            fn(cfg, None)
        else:
            fn(cfg, None, None, iter([]))


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Here torch finds no CUDA device: the script must exit non-zero and print
    no result line, both from the repo and alone in an empty directory."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card refusal")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        env = _env() if cwd == REPO else {k: v for k, v in os.environ.items()
                                          if k != "PYTHONPATH"}
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0, (cwd, r.stdout[-2000:])
        assert '"ok": true' not in r.stdout
