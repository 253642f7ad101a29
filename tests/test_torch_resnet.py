"""The port's ResNet-50 and FrozenBatchNorm against the JAX package's.

The flax parameters are replaced by seeded numpy values: convolutions at He
scale (std sqrt(2 / fan_in), so 16 bottleneck blocks keep finite activations),
FrozenBN weight, bias and mean as noise and running_var in [0.5, 1.5]. They
cross to the port through ``inv_d2_resnet``, the export function that
``load_from_jax`` applies to a ResNet backbone, and load with strict=True.
Inputs have sizes that no stride divides (72x104 and 65x97), so the stem's
padding, the max-pool's and every strided 3x3 ``conv2`` see odd maps. f32:
the tolerance is f32 round-off through 50 layers, 1e-4 of each output's
largest magnitude.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest
import jax
import torch

from hipie_tpu.utils import export as ex

OUT = ("res2", "res3", "res4", "res5")


def _randomize_resnet(params, seed):
    rng = np.random.RandomState(seed)

    def fill(path, x):
        name = path[-1].key
        shape = np.shape(x)
        if name == "kernel":
            return (np.sqrt(2.0 / np.prod(shape[:3])) * rng.randn(*shape)).astype(np.float32)
        if name == "running_var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.2 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.device_get(params))


@pytest.fixture(scope="module")
def resnet_params():
    from hipie_tpu.models.backbone.resnet import ResNet as JResNet

    jm = JResNet(depth=50, out_features=OUT)
    params = jm.init(jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32))["params"]
    return jm, _randomize_resnet(params, seed=0)


@pytest.mark.parametrize("hw", [(72, 104), (65, 97)])
def test_resnet50_matches_jax(resnet_params, hw):
    from hipie_torch.models.backbone.resnet import ResNet

    jm, params = resnet_params
    img = np.random.RandomState(hw[0]).randn(1, *hw, 3).astype(np.float32)
    want = {k: np.asarray(v) for k, v in jax.jit(jm.apply)({"params": params}, img).items()}
    sd = {}
    ex.inv_d2_resnet(params, "", sd)
    tm = ResNet(depth=50, out_features=OUT).eval()
    tm.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(img))
    assert set(got) == set(OUT)
    for name in OUT:
        assert got[name].shape == want[name].shape, name
        scale = np.abs(want[name]).max()
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


def test_resnet50_module_names():
    """Stride on the 3x3 conv2, a strided 1x1 shortcut on each stage's block 0."""
    from hipie_torch.models.backbone.resnet import ResNet

    tm = ResNet(depth=50)
    assert [len(getattr(tm, f"res{i}")) for i in range(2, 6)] == [3, 4, 6, 3]
    blk = tm.res3[0]
    assert blk.conv1.stride == (1, 1) and blk.conv2.stride == (2, 2)
    assert blk.shortcut.stride == (2, 2) and tm.res3[1].shortcut is None
    sd = tm.state_dict()
    for key in ("stem.conv1.weight", "stem.conv1.norm.running_var", "res2.0.shortcut.norm.bias",
                "res5.2.conv3.norm.running_mean"):
        assert key in sd, key
    buffers = dict(tm.named_buffers())
    assert "res4.1.conv2.norm.weight" in buffers
    assert not any(".norm." in n for n, _ in tm.named_parameters())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frozen_batchnorm_matches_jax(dtype):
    """The folded scale and shift in f32, applied in the input's dtype (f32:
    1e-6; bf16: both round the product and the sum to bf16, one ulp apart at
    most, 2^-7 of the output scale)."""
    import jax.numpy as jnp
    from hipie_tpu.layers import FrozenBatchNorm as JFBN
    from hipie_torch.layers import FrozenBatchNorm

    r = np.random.RandomState(3)
    c = 6
    x = r.randn(2, 5, 7, c).astype(np.float32)
    bufs = {"weight": r.randn(c), "bias": r.randn(c), "running_mean": r.randn(c),
            "running_var": r.uniform(0.1, 2.0, c)}
    bufs = {k: v.astype(np.float32) for k, v in bufs.items()}
    jdt = getattr(jnp, dtype)
    xj = jnp.asarray(x, jdt)
    want = np.asarray(JFBN(c, dtype=jdt).apply({"params": bufs}, xj).astype(jnp.float32))
    tm = FrozenBatchNorm(c)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in bufs.items()}, strict=True)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tm(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float().numpy()
    tol = 1e-6 if dtype == "float32" else 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_build_backbone_takes_every_resnet_name():
    """JAX tests name.startswith("resnet") first: "resnet_tiny" (the tiny test
    config's) builds a ResNet of resnet_depth in both packages, same channels."""
    import jax.numpy as jnp
    from hipie_tpu.config import tiny_test_config as j_tiny
    from hipie_tpu.models.backbone import build_backbone as j_build
    from hipie_torch.config import tiny_test_config
    from hipie_torch.models.backbone import build_backbone
    from hipie_torch.models.backbone.resnet import ResNet

    bc = tiny_test_config().model.backbone
    assert bc.name == "resnet_tiny"
    mod, chans = build_backbone(bc)
    jmod, jchans = j_build(j_tiny().model.backbone, jnp.float32)
    assert isinstance(mod, ResNet) and type(jmod).__name__ == "ResNet"
    assert chans == jchans == {"res3": 512, "res4": 1024, "res5": 2048}
