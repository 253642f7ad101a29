"""The port's demo CLI (hipie_torch/tools/demo.py) on the CPU at the tiny
config: a JPEG written by cv2 in, the instance overlay (JPEG) and the panoptic
map (PNG) out, both read back by cv2; the overlay and palette drawn as JAX's
tools/demo.py draws them (its ``colorize`` and per-instance colours).
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import importlib.util
from pathlib import Path

import cv2
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _jax_demo():
    spec = importlib.util.spec_from_file_location("jax_demo", REPO / "tools" / "demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("task", ["detection", "grounding"])
def test_demo_writes_the_jax_tools_files_on_the_cpu(task, tmp_path, monkeypatch):
    import hipie_torch.presets as presets
    from hipie_torch.config import apply_overrides, tiny_test_config
    from hipie_torch.tools import demo

    cfg = apply_overrides(tiny_test_config(), {
        "data.min_size_test": 48, "data.max_size_test": 96, "data.max_text_len": 16,
        "model.text.max_query_len": 16})
    monkeypatch.setattr(presets, "tiny_demo", lambda: cfg, raising=False)
    y, x = np.mgrid[0:50, 0:80]
    img = np.stack([128 + 90 * np.sin(x / 9.0 + c) * np.cos(y / 7.0) for c in range(3)],
                   -1).astype(np.uint8)
    src = str(tmp_path / "in.jpg")
    cv2.imwrite(src, img[..., ::-1])
    extra = (["--expression", "the circle"] if task == "grounding"
             else ["--categories", "circle,square,sky:stuff", "--confidence", "-1"])
    out = demo.main(["--input", src, "--preset", "tiny_demo", "--device", "cpu",
                     "--task", task, *extra])
    res, written = out["result"], out["written"]
    assert written["vis"] == str(tmp_path / "in_vis.jpg")
    vis = cv2.imread(written["vis"], cv2.IMREAD_COLOR)[..., ::-1]
    assert vis.shape == (50, 80, 3)
    masks = res["instances"]["masks"]
    assert len(masks) >= 1
    # the overlay as JAX's tool draws it, through the JPEG's rounding
    want = cv2.imread(src, cv2.IMREAD_COLOR)[..., ::-1].astype(np.float32)
    for i, m in enumerate(masks):
        want[m] = 0.5 * want[m] + 0.5 * np.random.RandomState(i).randint(0, 255, 3)
    assert np.abs(vis.astype(np.float32) - want.astype(np.uint8)).mean() < 3.0
    jax_demo = _jax_demo()
    if task == "detection":
        pan, _ = res["panoptic_seg"]
        got = cv2.imread(written["pan"], cv2.IMREAD_COLOR)[..., ::-1]
        assert written["pan"] == str(tmp_path / "in_vis_pan.png")
        np.testing.assert_array_equal(got, jax_demo.colorize(np.asarray(pan)))
        np.testing.assert_array_equal(demo.colorize(np.asarray(pan)),
                                      jax_demo.colorize(np.asarray(pan)))
    else:
        assert "pan" not in written or Path(written["pan"]).is_file()
