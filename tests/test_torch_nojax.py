"""The port runs without JAX, and chip_smoke.py refuses to run without a card.

Both run in fresh interpreters, so nothing this test process imported leaks in.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

TINY_SLICE = r"""
import sys
import numpy as np
import torch
from hipie_tpu.config import apply_overrides, tiny_test_config
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
assert "jax" not in sys.modules and "flax" not in sys.modules, sorted(
    m for m in sys.modules if m.startswith(("jax", "flax")))
print("NOJAX_OK")
"""

# The predictor on the tiny config (a ResNet-50 backbone): the host side uses
# the JAX package's numpy prompt builders and tokenizer, which import no JAX.
PREDICTOR = r"""
import sys
import numpy as np
import torch
from hipie_tpu.config import apply_overrides, tiny_test_config
from hipie_tpu.models.text.tokenizer import WordPieceTokenizer
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
assert "jax" not in sys.modules and "flax" not in sys.modules and "cv2" not in sys.modules, sorted(
    m for m in sys.modules if m.startswith(("jax", "flax", "cv2")))
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


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Here torch finds no CUDA device: the script must exit non-zero and print
    no result line, both from the repo and alone in an empty directory."""
    import torch

    if torch.cuda.is_available():
        import pytest

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
