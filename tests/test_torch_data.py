"""The port's data path (hipie_torch/data/, hipie_torch/config.py's YAML reader)
against cv2, PyYAML and the JAX package's data path.

One fixture per module: the port's make_tiny_coco writes 6 train and 4 val
128x128 PNG images with their panoptic PNGs and the refcoco splits into a
temporary directory, and both packages' registries are pointed at it, so both
pipelines read the same files (cv2 reads PNG too).

Limits: the PNG reader, nearest resize, RLE decode, records, masks, targets,
ids and the sampler are exact. The uint8 bilinear resize is within 1 of
cv2.INTER_LINEAR per channel (cv2 rounds 11-bit fixed-point weights); on float
images, as the mapper resizes them, the two agree to f32 round-off (1e-3 on
values up to 255). A polygon fill differs from cv2.fillPoly only on pixels
within one pixel of the outline, and its IoU with cv2's is at least 0.98.
"""

import dataclasses
import glob
import os
from pathlib import Path

import cv2
import numpy as np
import pytest
import yaml

import hipie_tpu.config as jconfig
import hipie_torch.config as tconfig
from hipie_torch.data import image_io
from hipie_torch.models.text.tokenizer import WordPieceTokenizer

REPO = Path(__file__).resolve().parent.parent
SPLITS = ["coco_panoptic_train", "coco_panoptic_val", "refcoco-mixed", "refcoco-unc-val"]
WORDS = ["circle", "square", "triangle", "sky", "grass", "the", "at", "top", "bottom", "left",
         "right", "middle", "on", "side", "near", "big", "small"]
OVERRIDES = {"data.crop_size": 128, "data.max_text_len": 16, "model.text.max_query_len": 16,
             "data.min_size_test": 96, "data.max_size_test": 160,
             "data.train_datasets": ("coco_panoptic_train", "refcoco-mixed"),
             "data.dataset_ratios": (2.0, 1.0)}
RESIZES = [(37, 53, 80, 120), (100, 90, 33, 47), (64, 64, 32, 32), (256, 256, 179, 200),
           (50, 80, 48, 77)]


def _cfgs():
    return (tconfig.apply_overrides(tconfig.tiny_test_config(), OVERRIDES),
            jconfig.apply_overrides(jconfig.tiny_test_config(), OVERRIDES))


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """The fixture on disk, both registries rooted there."""
    import hipie_tpu.data.datasets as jds
    import hipie_torch.data.datasets as tds
    from hipie_torch.tools import make_tiny_coco

    root = str(tmp_path_factory.mktemp("tiny_coco"))
    make_tiny_coco.main(["--root", root, "--n-train", "6", "--n-val", "4", "--size", "128",
                         "--refcoco"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HIPIE_DATASETS", root)
        jds._register_builtin()
        tds._register_builtin()
        yield root
    jds._register_builtin()
    tds._register_builtin()


# -- image_io against cv2 ----------------------------------------------------

@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("png_filter", ["NONE", "SUB", "UP", "AVG", "PAETH"])
def test_png_reader_equals_cv2(channels, png_filter):
    """A PNG cv2 wrote with one scanline filter reads as cv2 reads it (cv2
    keeps BGR(A) order, the file and the reader RGB(A))."""
    rng = np.random.RandomState(channels)
    shape = (37, 53) if channels == 1 else (37, 53, channels)
    img = rng.randint(0, 256, shape).astype(np.uint8)
    img[5:20, 10:30] = 77                      # flat areas next to noise
    ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_FILTER,
                                         getattr(cv2, f"IMWRITE_PNG_FILTER_{png_filter}")])
    want = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
    if channels > 1:
        want = want[:, :, [2, 1, 0, 3][:channels]]
    np.testing.assert_array_equal(image_io.read_png(buf.tobytes()), want)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_writer_reads_back_in_cv2(channels, tmp_path):
    rng = np.random.RandomState(10 + channels)
    img = rng.randint(0, 256, (40, 61) if channels == 1 else (40, 61, channels)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    image_io.write_png(path, img)
    got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if channels > 1:
        got = got[:, :, [2, 1, 0, 3][:channels]]
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(image_io.read_png(path), img)
    if channels == 3:
        np.testing.assert_array_equal(image_io.load_image(path),
                                      cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1])


@pytest.mark.parametrize("shapes", RESIZES)
def test_resizes_against_cv2(shapes):
    """Bilinear: uint8 within 1, float to f32 round-off; nearest: exact."""
    H, W, h, w = shapes
    rng = np.random.RandomState(H * W)
    img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    got = image_io.resize_bilinear(img, (h, w))
    want = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    assert got.dtype == np.uint8 and np.abs(got.astype(int) - want).max() <= 1
    got_f = image_io.resize_bilinear(img.astype(np.float32), (h, w))
    want_f = cv2.resize(img.astype(np.float32), (w, h), interpolation=cv2.INTER_LINEAR)
    assert got_f.dtype == np.float32 and np.abs(got_f - want_f).max() <= 1e-3
    mask = rng.randint(0, 2, (H, W)).astype(np.uint8)
    np.testing.assert_array_equal(image_io.resize_nearest(mask, (h, w)),
                                  cv2.resize(mask, (w, h), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("seed", range(4))
def test_polygon_fill_against_cv2(seed):
    """Star-shaped polygons of 3-8 vertices, radius 20-60 pixels: differences
    only within one pixel of the outline, IoU >= 0.98."""
    rng = np.random.RandomState(seed)
    for _ in range(5):
        n = rng.randint(3, 9)
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(20, 60, n)
        c = rng.uniform(40, 88, 2)
        pts = np.round(np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1)).astype(
            np.int32)
        want = np.zeros((128, 128), np.uint8)
        cv2.fillPoly(want, [pts], 1)
        got = image_io.fill_polygon(np.zeros((128, 128), np.uint8), [pts])
        outline = np.zeros_like(want)
        cv2.polylines(outline, [pts], True, 1, 1)
        near = cv2.dilate(outline, np.ones((3, 3), np.uint8)) > 0
        assert not ((got != want) & ~near).any()
        assert (got & want).sum() / (got | want).sum() >= 0.98


def test_decode_segmentation_rle_is_exact():
    import hipie_tpu.data.datasets as jds
    import hipie_torch.data.datasets as tds
    from hipie_torch.evaluation.rle import rle_encode

    rng = np.random.RandomState(3)
    for shape in [(17, 29), (64, 48), (1, 5)]:
        m = (rng.rand(*shape) > 0.6).astype(np.uint8)
        ann = {"segmentation_raw": rle_encode(m)}
        np.testing.assert_array_equal(tds.decode_segmentation(ann, *shape), m)
        np.testing.assert_array_equal(jds.decode_segmentation(ann, *shape), m)


def test_load_image_other_formats_go_through_pil(tmp_path, monkeypatch):
    """A JPEG is read by PIL (imported at call time); without PIL the error
    names the file and its format."""
    import builtins

    from PIL import Image

    path = str(tmp_path / "a.jpg")
    Image.fromarray(np.random.RandomState(0).randint(0, 256, (20, 30, 3)).astype(
        np.uint8)).save(path)
    np.testing.assert_array_equal(image_io.load_image(path),
                                  np.asarray(Image.open(path).convert("RGB")))
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(RuntimeError, match=r"a\.jpg: JPEG images need PIL"):
        image_io.load_image(path)


# -- YAML ----------------------------------------------------------------------

@pytest.mark.parametrize("path", sorted(glob.glob(str(REPO / "configs" / "*.yaml"))),
                         ids=os.path.basename)
def test_yaml_reader_equals_safe_load(path):
    text = Path(path).read_text()
    assert tconfig.parse_yaml(text) == yaml.safe_load(text)
    assert dataclasses.asdict(tconfig.load_config(path)) == dataclasses.asdict(
        jconfig.load_config(path))


def test_yaml_reader_scalars_and_lists():
    text = ("a:\n  - 1\n  - 2.0\n  - \"x y\"\nb: [yes, No, ~, 1e-4, 0.5e-3, .5, 'it''s']\n"
            "c:\nd: '#x' # comment\ne: -3  # int\n")
    assert tconfig.parse_yaml(text) == yaml.safe_load(text)
    with pytest.raises(ValueError):
        tconfig.parse_yaml("a: 1\n   b: 2\n")


# -- the pipeline on the fixture -------------------------------------------------

def _assert_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("name", SPLITS)
def test_records_and_materialized_equal_jax(fixture_root, name):
    import hipie_tpu.data.datasets as jds
    import hipie_torch.data.datasets as tds

    jrec, trec = jds.get_dataset(name), tds.get_dataset(name)
    assert len(jrec) == len(trec) > 0
    _assert_equal(trec, jrec)
    for a, b in zip(trec[:4], jrec[:4]):
        _assert_equal(tds.materialize_record(a), jds.materialize_record(b))


def _mapper_outputs_equal(got, want):
    """Images within the float resize limit; every other field exact."""
    assert np.abs(got.image - want.image).max() <= 1e-3
    assert got.image_size == want.image_size and got.orig_size == want.orig_size
    for k in ("pad_mask", "input_ids", "attention_mask", "labels", "boxes", "masks",
              "positive_map", "is_thing", "valid"):
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "test"])
def test_mapper_equals_jax(fixture_root, is_train):
    import hipie_tpu.data.datasets as jds
    from hipie_tpu.data.mapper import HIPIEMapper as JMapper
    from hipie_tpu.models.text.tokenizer import WordPieceTokenizer as JTok
    from hipie_torch.data.mapper import HIPIEMapper

    cfg, jcfg = _cfgs()
    tm = HIPIEMapper(cfg.data, WordPieceTokenizer.toy(words=WORDS), is_train=is_train,
                     max_gt=10, seed=3)
    jm = JMapper(jcfg.data, JTok.toy(words=WORDS), is_train=is_train, max_gt=10, seed=3)
    bucket = (128, 128) if is_train else None
    for name in ("coco_panoptic_train", "refcoco-mixed"):
        for rec in jds.get_dataset(name)[:4]:
            rec = jds.materialize_record(rec)
            _mapper_outputs_equal(tm(rec, bucket=bucket), jm(rec, bucket=bucket))


def test_train_loader_first_batches_equal_jax(fixture_root):
    """Three batches from each package's TrainLoader, same seed: the same
    task sequence and the same batches (images within the resize limit)."""
    from hipie_tpu.data.loader import TrainLoader as JLoader
    from hipie_tpu.data.mapper import HIPIEMapper as JMapper
    from hipie_tpu.models.text.tokenizer import WordPieceTokenizer as JTok
    from hipie_torch.data.loader import TrainLoader
    from hipie_torch.data.mapper import HIPIEMapper
    from hipie_torch.train.step import TrainBatch

    cfg, jcfg = _cfgs()
    tl = TrainLoader(cfg.data, HIPIEMapper(cfg.data, WordPieceTokenizer.toy(words=WORDS),
                                           max_gt=10, seed=5), 2, seed=7)
    jl = JLoader(jcfg.data, JMapper(jcfg.data, JTok.toy(words=WORDS), max_gt=10, seed=5), 2,
                 seed=7)
    assert tl.tasks == jl.tasks == ["detection", "grounding"]
    tasks = []
    for (ttask, tb), (jtask, jb) in zip(iter(tl), iter(jl)):
        assert ttask == jtask and isinstance(tb, TrainBatch)
        tasks.append(ttask)
        assert np.abs(tb.images.numpy() - jb["images"]).max() <= 1e-3
        for k in ("pad_mask", "input_ids", "lang_mask", "image_sizes"):
            assert np.array_equal(getattr(tb, k).numpy(), jb[k]), k
        for k, v in tb.targets._asdict().items():
            assert np.array_equal(v.numpy(), getattr(jb["targets"], k)), k
        if len(tasks) == 3:
            break
    assert len(tasks) == 3


def test_repeat_factors_and_sampler_equal_jax(fixture_root):
    import hipie_tpu.data.datasets as jds
    from hipie_tpu.data.loader import MultiDatasetSampler as JSampler
    from hipie_tpu.data.loader import rfs_repeat_factors as jrfs
    from hipie_torch.data.loader import MultiDatasetSampler, rfs_repeat_factors

    records = [jds.materialize_record(r) for r in jds.get_dataset("coco_panoptic_train")]
    for t in (0.001, 0.3, 0.9):
        np.testing.assert_array_equal(rfs_repeat_factors(records, t), jrfs(records, t))
    rf = [rfs_repeat_factors(records, 0.9), None]
    ts = iter(MultiDatasetSampler([6, 9], [2.0, 1.0], seed=4, repeat_factors=rf))
    js = iter(JSampler([6, 9], [2.0, 1.0], seed=4, repeat_factors=rf))
    assert [next(ts) for _ in range(64)] == [next(js) for _ in range(64)]
