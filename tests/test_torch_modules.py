"""Port modules that hold a kernel, and BERT, against their JAX modules.

Each test builds the flax module, replaces every parameter with seeded numpy
noise (the flax inits zero the MSDA offsets and the rel-pos tables, which
would leave the paths under test idle), carries the weights across with the
JAX package's own export functions (the same names ``load_from_jax`` uses),
loads them strictly and feeds both sides the same numpy inputs. f32 throughout
unless a test says otherwise; tolerances are f32 round-off over the depth of
the module.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from hipie_tpu.utils import export as ex


@pytest.fixture(autouse=True)
def _no_trace_overrides(monkeypatch):
    for var in ("HIPIE_MSDA_METHOD", "HIPIE_GELU", "HIPIE_VIT_FLASH", "HIPIE_VIT_ATTN"):
        monkeypatch.delenv(var, raising=False)


def _randomize(params, seed, std=0.2):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (std * rng.randn(*np.shape(x))).astype(np.float32), jax.device_get(params))


def _load(module, sd, prefix=""):
    module.load_state_dict({k[len(prefix):]: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in sd.items()}, strict=True)


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_msdeformattn_matches_jax(ref_dim):
    from hipie_tpu.models.msda_module import MSDeformAttn as JMSDA
    from hipie_torch.models.msda_module import MSDeformAttn

    shapes = ((8, 6), (4, 3), (2, 2))
    s = sum(h * w for h, w in shapes)
    b, q, c = 2, 11, 32
    r = np.random.RandomState(ref_dim)
    query = r.randn(b, q, c).astype(np.float32)
    value = r.randn(b, s, c).astype(np.float32)
    ref = r.uniform(0.05, 0.95, (b, q, len(shapes), ref_dim)).astype(np.float32)
    if ref_dim == 4:
        ref[..., 2:] *= 0.5
    pad = np.zeros((b, s), bool)
    pad[1, -5:] = True

    jm = JMSDA(c, len(shapes), 4, 3)
    params = _randomize(jm.init(jax.random.PRNGKey(0), query, ref, value, shapes, pad)["params"],
                        seed=ref_dim)
    want = np.asarray(jm.apply({"params": params}, query, ref, value, shapes, pad))

    tm = MSDeformAttn(c, len(shapes), 4, 3)
    sd = {}
    ex.inv_msda(params, "m", sd)
    _load(tm, sd, "m.")
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (query, ref, value)), shapes, torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _image_1024():
    return np.random.RandomState(2).randn(1, 512, 512, 3).astype(np.float32)


@pytest.fixture(scope="module")
def vit_pair():
    """Narrow ViTDet: 4 blocks (0, 1, 3 windowed at 4, block 2 global), 8x8 tokens.
    img_size 256 makes the global block's rel-pos tables (31 rows) resize to 15,
    and the 14x14 pretrain pos embed resizes bicubically to 8x8. want["res4_1024"]
    is the res4 map of a 512x512 image: 32x32 = 1024 tokens, where JAX's
    global block takes its kernel in bf16."""
    from hipie_tpu.models.backbone.vit import ViTDet as JViT

    kw = dict(img_size=256, patch_size=16, embed_dim=64, depth=4, num_heads=4, window_size=4)
    img = np.random.RandomState(0).randn(1, 128, 128, 3).astype(np.float32)
    jm = JViT(**kw)
    params = _randomize(jm.init(jax.random.PRNGKey(0), img)["params"], seed=1)
    want = {k: np.asarray(v) for k, v in jm.apply({"params": params}, img).items()}
    want["res4_1024"] = np.asarray(jm.apply({"params": params}, _image_1024())["res4"])
    sd = {}
    ex.inv_vit(params, "", sd)
    return kw, img, sd, want


def test_vitdet_matches_jax(vit_pair):
    from hipie_torch.models.backbone.vit import ViTDet

    kw, img, sd, want = vit_pair
    tm = ViTDet(**kw)
    assert [b.window_size for b in tm.blocks] == [4, 4, 0, 4]
    _load(tm, sd)
    with torch.no_grad():
        got = tm(torch.from_numpy(img))
    for name in ("res3", "res4", "res5"):
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_vitdet_bf16_global_block_through_wrapper(vit_pair, monkeypatch):
    """bf16 sends the global block through vit_global_attention (its plain
    version on the CPU) where JAX takes its kernel: 1024 tokens (a 512x512
    image), not the 64 of the 128x128 one. Against the f32 JAX output, bf16
    rounding over 4 blocks stays within 5% of the output scale."""
    from hipie_torch.models.backbone import vit as tvit

    calls = []
    real = tvit.vit_global_attention
    monkeypatch.setattr(tvit, "vit_global_attention", lambda *a: calls.append(1) or real(*a))
    kw, img, sd, want = vit_pair
    tm = tvit.ViTDet(**kw)
    _load(tm, sd)
    tm.to(torch.bfloat16)
    with torch.no_grad():
        tm(torch.from_numpy(img))
        assert calls == []                   # N = 64 < 1024: the plain block, as in JAX
        got = tm(torch.from_numpy(_image_1024()))["res4"].float().numpy()
    assert calls == [1]
    scale = np.abs(want["res4_1024"]).max()
    np.testing.assert_allclose(got, want["res4_1024"], rtol=0, atol=5e-2 * scale)


def test_resize_abs_pos_matches_jax_bicubic():
    from hipie_tpu.models.backbone.vit import resize_abs_pos as jresize
    from hipie_torch.models.backbone.vit import resize_abs_pos

    pos = np.random.RandomState(3).randn(1, 197, 8).astype(np.float32)
    for hw in ((64, 64), (8, 8), (14, 20)):
        want = np.asarray(jresize(jnp.asarray(pos), True, hw))
        got = resize_abs_pos(torch.from_numpy(pos), True, hw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=str(hw))


@pytest.mark.parametrize("block", [False, True])
def test_bert_matches_jax(block):
    from hipie_tpu.models.text.bert import BertModel as JBert
    from hipie_tpu.models.text.bert import parallel_det_block_mask as jmask
    from hipie_torch.models.text.bert import BertModel, parallel_det_block_mask

    kw = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
    r = np.random.RandomState(4)
    ids = r.randint(1, 64, (2, 12)).astype(np.int32)
    ids[:, 0] = 2                                    # "cls"
    ids[:, 4] = ids[:, 8] = 3                        # separators
    am = np.ones((2, 12), np.int32)
    am[1, 9:] = 0
    ids[1, 9:] = 0
    bm = np.asarray(jmask(jnp.asarray(ids), 3, 2, 0)) if block else None
    if block:
        tbm = parallel_det_block_mask(torch.from_numpy(ids).long(), 3, 2, 0)
        np.testing.assert_array_equal(tbm.numpy(), bm)
    jm = JBert(**kw)
    params = _randomize(jm.init(jax.random.PRNGKey(0), ids, am, bm)["params"], seed=5)
    want = np.asarray(jm.apply({"params": params}, ids, am, bm))
    sd = {}
    ex.inv_hf_bert(params, "", sd)
    tm = BertModel(**kw)
    _load(tm, sd)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), torch.from_numpy(am),
                 None if bm is None else torch.from_numpy(bm))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
