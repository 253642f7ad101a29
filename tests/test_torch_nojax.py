"""The port stands alone: it runs without JAX and without the JAX package,
imports neither anywhere, serves and trains on the card by default, and
chip_smoke.py refuses to run without a card. It also runs without the host
libraries the card's machine lacks (cv2, PIL, PyYAML, torchvision): none is
imported anywhere in the port or chip_smoke.py, but for PIL inside
``hipie_torch/data/image_io.py::load_image``, for images other than PNG and
JPEG (JPEG has the port's own decoder).

The runs are in fresh interpreters, so nothing this test process imported
leaks in; there ``sys.modules["hipie_tpu"] = None`` makes any import of the JAX
package fail.
"""

from torch_threads import subprocess_env  # first: sizes torch's CPU threads
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("hipie_tpu", "jax", "flax")
HOST_LIBS = ("cv2", "PIL", "yaml", "torchvision")
# the one import of a host library the port makes, at call time, for images
# other than PNG and JPEG: (file, function, module)
HOST_LIB_ALLOWED = {("hipie_torch/data/image_io.py", "load_image", "PIL")}

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

# A training step on the tiny config through the port's own step, optimizer,
# criterion, matchers, CDN and Trainer, on the CPU, with the data-parallel
# modules (hipie_torch/parallel/, tensor parallelism too) imported.
TRAIN = BLOCK_JAX_PACKAGE + r"""
import dataclasses, tempfile
import numpy as np
import torch
from hipie_torch.parallel import dryrun, mesh, multihost, tensor
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
trainer = Trainer(cfg, state, make_train_step(cfg, state, device="cpu"), iter([batch]),
                  device="cpu")
state = trainer.train(max_iter=1)
assert state.step == 1 and all(np.isfinite(h["total_loss"]) for h in trainer.history)
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


# Open-vocab serving on the tiny config: a prompt past BERT's positions
# (chunked), CLIP on with narrow random towers, the Swin and ConvNeXt backbones
# (narrow variants), on the CPU.
OPEN_VOCAB = BLOCK_JAX_PACKAGE + r"""
import numpy as np
import torch
from hipie_torch.config import apply_overrides, tiny_test_config
from hipie_torch.models.backbone.convnext import CONVNEXT_VARIANTS
from hipie_torch.models.backbone.swin import SWIN_VARIANTS
from hipie_torch.models.clip import CLIPText, CLIPVisual
from hipie_torch.models.hipie import HIPIEModel
from hipie_torch.models.postprocess_clip import CLIPScorer
from hipie_torch.models.text.clip_tokenizer import CLIPTokenizer
from hipie_torch.models.text.tokenizer import WordPieceTokenizer
from hipie_torch.predictor import HIPIEPredictor
from hipie_torch.utils.weights import random_init_

SWIN_VARIANTS["swin_narrow"] = (16, (2, 2, 2, 2), (2, 2, 4, 4), 4)
CONVNEXT_VARIANTS["narrow"] = ((1, 1, 2, 1), (8, 16, 32, 64))
tok = WordPieceTokenizer.toy(words=["person", "dog", "sky"])
img = np.random.RandomState(0).randint(0, 256, (50, 80, 3)).astype(np.uint8)
cats = [f"{w}{i}" + (":stuff" if i % 3 == 0 else "") for i in range(100)
        for w in ("person", "dog")]
for name in ("resnet_tiny", "swin_narrow", "convnext_narrow"):
    cfg = apply_overrides(tiny_test_config(), {
        "data.min_size_test": 48, "data.max_size_test": 96, "data.max_text_len": 640,
        "model.clip.enabled": True, "test.max_pool_tokens": True,
        "test.bg_cls_agnostic": True, "test.use_bg_for_pano": False,
        "model.backbone.name": name})
    model = HIPIEModel(cfg.model, sep_token_id=tok.dot_token_id).eval()
    random_init_(model, torch.Generator().manual_seed(0))
    scorer = CLIPScorer(cfg.model.clip, CLIPTokenizer.toy(), visual=CLIPVisual(32, 8, 32, 2, 2, 16),
                        text=CLIPText(600, 77, 32, 2, 2, 16), device="cpu")
    pred = HIPIEPredictor(cfg, model, tok, bucket=(64, 96), device="cpu", clip_scorer=scorer)
    res = pred(img, test_categories=cats, score_thresh=-1.0)
    assert res["sem_seg"].shape == (50, 80) and np.isfinite(res["instances"]["scores"]).all()
assert not [m for m in sys.modules if m.startswith(("jax", "flax"))
            or (m.startswith("hipie_tpu") and sys.modules[m] is not None)]
print("NOJAX_OK")
"""


def _env():
    env = subprocess_env(dict(os.environ))
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


def test_open_vocab_and_new_backbones_run_without_jax():
    _run_without_jax(OPEN_VOCAB)


def test_train_net_and_eval_net_run_without_jax_or_host_libraries(tmp_path_factory):
    """The fixture, train_net (two steps with an inline evaluation) and eval_net
    on a panoptic and a referring split, with the JAX package and the host
    libraries the card's machine lacks all blocked: the run
    test_torch_train_driver.py reads too (tests/torch_tools_run.py)."""
    from torch_tools_run import tools_run

    run = tools_run(tmp_path_factory)
    assert run["step"] == 2 and "panoptic/PQ" in run["last_eval"]
    assert run["refcoco"]["images"] == 1 and run["panoptic"]["images"] == 2
    assert not run["leaked"], run["leaked"]


def _port_sources():
    return sorted((REPO / "hipie_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "msda_bench.py", REPO / "vit_bwd_bench.py",
        REPO / "msda_bwd_bench.py"]


def _imports(path):
    """(line, module, enclosing function or None) of every import in one file."""
    found = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                found.extend((child.lineno, a.name, func) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                found.append((child.lineno, child.module, func))
            visit(child, child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func)

    visit(ast.parse(path.read_text(), filename=str(path)), None)
    return found


def _forbidden_imports(path):
    """(line, module) of every import of hipie_tpu, jax or flax in one file."""
    return [(line, n) for line, n, _ in _imports(path) if n.split(".")[0] in FORBIDDEN]


def _host_lib_imports(path, rel=None):
    """(line, module, function) of every import of cv2, PIL, yaml or
    torchvision in one file (``rel``: its path in the repo), but for the
    allowed one."""
    rel = rel or str(path.relative_to(REPO))
    return [(line, n, f) for line, n, f in _imports(path) if n.split(".")[0] in HOST_LIBS
            and (rel, f, n.split(".")[0]) not in HOST_LIB_ALLOWED]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """Every import statement of hipie_torch/, chip_smoke.py and
    the kernel benches (msda_bench.py, vit_bwd_bench.py, msda_bwd_bench.py), at any
    depth (inside functions too), stays out of hipie_tpu, jax and flax."""
    sources = _port_sources()
    assert len(sources) > 30 and REPO / "hipie_torch" / "config.py" in sources
    assert {REPO / "hipie_torch" / "parallel" / f"{m}.py"
            for m in ("mesh", "multihost", "dryrun", "tensor")} <= set(sources)
    assert {REPO / "hipie_torch" / "tools" / f"{m}.py"
            for m in ("demo", "convert_refcoco")} <= set(sources)
    bad = {str(p.relative_to(REPO)): f for p in sources if (f := _forbidden_imports(p))}
    assert not bad, bad


def test_port_imports_no_host_library_the_card_lacks():
    """No import of cv2, PIL, yaml or torchvision anywhere in the port or
    chip_smoke.py, at module level or inside a function, but for the one the
    port needs: PIL inside image_io.load_image, for images other than PNG and JPEG."""
    sources = _port_sources()
    bad = {str(p.relative_to(REPO)): f for p in sources if (f := _host_lib_imports(p))}
    assert not bad, bad
    allowed = [(n, f) for line, n, f in _imports(REPO / "hipie_torch/data/image_io.py")
               if n.split(".")[0] in HOST_LIBS]
    assert allowed == [("PIL", "load_image")]


def test_the_host_library_check_sees_function_level_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import yaml\n\ndef load_image():\n    import cv2\n"
                     "    from PIL import Image\n")
    assert _host_lib_imports(probe, "hipie_torch/data/probe.py") == [
        (1, "yaml", None), (4, "cv2", "load_image"), (5, "PIL", "load_image")]
    assert _host_lib_imports(probe, "hipie_torch/data/image_io.py") == [
        (1, "yaml", None), (4, "cv2", "load_image")]


@pytest.mark.parametrize("tool", ["train_net", "eval_net", "demo"])
def test_entry_points_default_to_the_card(tool):
    """train_net, eval_net and demo run on the card unless --device cpu is
    given; without a card they raise before any work."""
    import torch

    from hipie_torch.tools import demo, eval_net, train_net

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card refusal")
    main = {"train_net": train_net.main, "eval_net": eval_net.main, "demo": demo.main}[tool]
    extra = ["--input", str(REPO / "tests" / "data" / "jpeg" / "baseline_420.jpg")] \
        if tool == "demo" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config-file", str(REPO / "configs" / "smoke_tiny_coco.yaml"), *extra])


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
