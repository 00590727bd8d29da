"""The port's ``ResNetV1``/``ResFCN256Cls`` and ``ResEncoder`` backbones,
the ``BACKBONES`` registry, ``utils/weight_init.py``, ``utils/analysis.py``,
``utils/misc.py`` and ``version.py`` against the JAX package's, on the CPU.

- The backbones run on flax params carried over by ``utils/from_flax.py``:
  outputs agree to 1e-5 and every parameter's gradient (under one seeded
  cotangent) to 1e-4, relative to the largest magnitude of the JAX value
  (measured 4e-6 and 2e-6 on the 32x32 ResFCN256Cls depth).
- ``weight_init``: the bits cannot be JAX's, so each ``type``'s std and
  bounds from 10^5 draws agree with JAX's draws and with the analytic value
  within 2%, the fans of conv and dense leaves are flax's, and a
  ``layer_pattern`` re-draws the same set of leaves as JAX's.
- ``get_model_complexity_info``: the FLOPs of a matmul stack and of a
  VALID conv equal XLA's count (a SAME conv differs: XLA leaves out the
  taps on the zero padding).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deep3dmap_tpu.models.backbones import encoder as jencoder
from deep3dmap_tpu.models.backbones import resnet_v1 as jresnet
from deep3dmap_tpu.utils import analysis as janalysis
from deep3dmap_tpu.utils import weight_init as jwinit
from deep3dmap_tpu_torch.models.backbones import encoder, resnet_v1
from deep3dmap_tpu_torch.utils import analysis, weight_init
from deep3dmap_tpu_torch.utils.from_flax import load_flax_params, to_flax_grads

torch.set_num_threads(2)


def close(got, want, tol):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * scale)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, p) if isinstance(v, dict) else {p: np.asarray(v)})
    return out


def _parity(jmodel, tmodel, x):
    """The JAX forward and VJP in one jitted call (eager flax is slow)."""
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    load_flax_params(tmodel, params)

    @jax.jit
    def fwd_vjp(p, v, c):
        out, pull = jax.vjp(lambda q: jmodel.apply({"params": q}, v), p)
        return out, pull(c)[0]

    tout = tmodel(torch.from_numpy(x))
    cot = np.random.RandomState(1).randn(*tout.shape).astype(np.float32)
    tout.backward(torch.from_numpy(cot))
    jout, jgrad = fwd_vjp(params, jnp.asarray(x), jnp.asarray(cot))
    close(tout.detach(), jout, 1e-5)
    jg, tg = _flat(jax.device_get(jgrad)), _flat(to_flax_grads(tmodel))
    assert set(jg) == set(tg)
    for k in jg:
        close(tg[k], jg[k], 1e-4)


@pytest.mark.parametrize("block,layers,size", [("bottleneck", (2, 1), 15)])
def test_resnet_v1(block, layers, size):
    """Bottleneck blocks at an odd size (``test_resfcn256_cls`` runs the
    basic ones at an even size)."""
    x = np.random.RandomState(0).rand(2, size, size, 3).astype(np.float32)
    _parity(jresnet.ResNetV1(block=block, layers=layers, num_classes=5, stem_ch=8),
            resnet_v1.ResNetV1(block, layers, num_classes=5, stem_ch=8), x)


def test_resfcn256_cls():
    x = np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32)
    _parity(jresnet.ResFCN256Cls(num_classes=6), resnet_v1.ResFCN256Cls(num_classes=6), x)


@pytest.mark.parametrize("size,activation", [(128, "tanh")])
def test_res_encoder(size, activation):
    x = np.random.RandomState(3).rand(2, size, size, 3).astype(np.float32)
    _parity(jencoder.ResEncoder(cout=10, nf=4, size=size, activation=activation),
            encoder.ResEncoder(10, 4, size, activation), x)


def test_backbones_registry_has_jax_names():
    import deep3dmap_tpu.models  # noqa: F401  (register)
    import deep3dmap_tpu.models.modulars.inversion_net  # noqa: F401
    import deep3dmap_tpu.models.parsing  # noqa: F401
    from deep3dmap_tpu.models.builder import BACKBONES as JB
    from deep3dmap_tpu_torch.models.builder import BACKBONES, MODELS, build_backbone

    net = build_backbone(dict(type="ResFCN256Cls", num_classes=3))
    assert isinstance(net, resnet_v1.ResFCN256Cls)
    assert set(JB.module_dict) <= set(BACKBONES.module_dict)
    assert BACKBONES.parent is MODELS and MODELS.get("resfcn256_std") is BACKBONES.get("ResFCN256")


# ------------------------------------------------------------ weight_init --
N_DRAWS = 100_000
CONV = (3, 3, 16, 8)                       # flax kernel layout (kh, kw, in, out)


@pytest.mark.parametrize("cfg,std,bound", [
    (dict(type="Normal", std=0.3), 0.3, None),
    (dict(type="TruncNormal", std=0.3), 0.3 * 0.87962566, 0.6),
    (dict(type="Uniform", a=-0.5, b=1.5), 2 / 12 ** 0.5, 1.5),
    (dict(type="Xavier"), (2 / (9 * 24)) ** 0.5, (6 / (9 * 24)) ** 0.5),
    (dict(type="Xavier", distribution="normal"), (2 / (9 * 24)) ** 0.5,
     2 * (2 / (9 * 24)) ** 0.5 / 0.87962566),
    (dict(type="Kaiming"), (2 / (9 * 16)) ** 0.5, 2 * (2 / (9 * 16)) ** 0.5 / 0.87962566),
    (dict(type="Kaiming", distribution="uniform"), (2 / (9 * 16)) ** 0.5, (6 / (9 * 16)) ** 0.5),
])
def test_initializer_distributions(cfg, std, bound):
    """10^5 draws of a (3, 3, 16, 8)-shaped conv leaf, repeated to size:
    the fans are flax's (in 16 x 3 x 3, out 8 x 3 x 3)."""
    reps = N_DRAWS // int(np.prod(CONV)) + 1
    gen = torch.Generator().manual_seed(0)
    init = weight_init.build_initializer(cfg)
    got = torch.cat([init(gen, CONV).reshape(-1) for _ in range(reps)]).numpy()
    jinit = jwinit.build_initializer(cfg)
    keys = jax.random.split(jax.random.PRNGKey(0), reps)
    want = np.concatenate([np.asarray(jinit(k, CONV, jnp.float32)).reshape(-1) for k in keys])
    for a in (got, want):
        assert abs(a.std() - std) < 0.02 * std
    if bound is not None:
        lo, hi = (-0.5, 1.5) if cfg["type"] == "Uniform" else (-bound, bound)
        assert got.min() >= lo and got.max() <= hi
        assert abs(got.max() - want.max()) < 0.02 * abs(hi)
        assert abs(got.min() - want.min()) < 0.02 * abs(lo if lo else hi)


def test_constant_and_rank1_leaves():
    gen = torch.Generator().manual_seed(0)
    assert (weight_init.build_initializer(dict(type="Constant", val=0.7))(gen, (4, 2)) ==
            np.float32(0.7)).all()
    with pytest.raises(ValueError):
        weight_init.build_initializer(dict(type="Kaiming"))(gen, (5,))
    with pytest.raises(ValueError):
        jwinit.build_initializer(dict(type="Kaiming"))(jax.random.PRNGKey(0), (5,))


def test_module_leaves_take_flax_fans():
    """On a module the fans come from the flax layout of each leaf: a dense
    (out, in) weight has fan_in = in, a conv (out, in, kh, kw) weight
    kh * kw * in; the draws' bounds and stds match JAX's on the flax shape."""
    from deep3dmap_tpu_torch.models.layers import Conv, Dense

    gen = torch.Generator().manual_seed(3)
    dense = weight_init.apply_init_cfg(Dense(512, 256), dict(
        type="Kaiming", distribution="uniform", layer_pattern="kernel"), gen)
    w = dense.weight.detach().numpy()
    want = np.asarray(jwinit.build_initializer(dict(type="Kaiming", distribution="uniform"))(
        jax.random.PRNGKey(0), (512, 256), jnp.float32))
    bound = (6 / 512) ** 0.5
    assert np.abs(w).max() <= bound and abs(np.abs(w).max() - np.abs(want).max()) < 0.02 * bound
    conv = weight_init.apply_init_cfg(Conv(16, 8, (3, 3)),
                                      dict(type="Kaiming", layer_pattern="kernel"), gen)
    std = conv.weight.detach().numpy().std()
    assert abs(std - (2 / 144) ** 0.5) < 0.05 * (2 / 144) ** 0.5


def test_apply_init_cfg_layer_pattern():
    """The same leaves change as in JAX, on a module and on a flax tree;
    the dense fan is flax's (in, out)."""
    jm = jresnet.ResNetV1(block="basic", layers=(1, 1), num_classes=4, stem_ch=8)
    x = jnp.zeros((1, 16, 16, 3))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), x)["params"]
    cfg = [dict(type="Constant", val=0.0, layer_pattern=r"Dense_0/bias"),
           dict(type="Kaiming", layer_pattern=r"BasicBlock_1/Conv_\d/kernel"),
           dict(type="Normal", std=0.5, layer_pattern=r"^Conv_0")]
    before = _flat(jax.device_get(params))
    jafter = _flat(jax.device_get(jwinit.apply_init_cfg(params, cfg, jax.random.PRNGKey(1))))
    jchanged = {k for k in before if not np.array_equal(before[k], jafter[k])}
    gen = torch.Generator().manual_seed(1)
    tree = weight_init.apply_init_cfg(jax.device_get(params), cfg, gen)
    tafter = _flat({k: v for k, v in tree.items()})
    assert {k for k in before if not np.array_equal(before[k], tafter[k])} == jchanged
    tm = resnet_v1.ResNetV1("basic", (1, 1), 4, 8)
    load_flax_params(tm, params)
    from deep3dmap_tpu_torch.utils.from_flax import to_flax_params
    weight_init.apply_init_cfg(tm, cfg, gen)
    mafter = _flat(to_flax_params(tm))
    assert {k for k in before if not np.array_equal(before[k], mafter[k])} == jchanged
    assert (mafter["Dense_0/bias"] == 0).all() and mafter["Dense_0/kernel"].shape == (32, 4)


# --------------------------------------------------------------- analysis --
def test_complexity_matches_xla_on_matmuls_and_valid_conv():
    rs = np.random.RandomState(4)
    p = {"w1": rs.randn(16, 32).astype(np.float32), "w2": rs.randn(32, 8).astype(np.float32)}
    x = rs.randn(4, 16).astype(np.float32)
    want = janalysis.get_model_complexity_info(lambda q, v: (v @ q["w1"]) @ q["w2"], p, x)
    got = analysis.get_model_complexity_info(
        lambda q, v: (v @ q["w1"]) @ q["w2"], {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x))
    assert got["flops"] == want["flops"] == 2 * 4 * 16 * 32 + 2 * 4 * 32 * 8
    assert got["params"] == want["params"] == 16 * 32 + 32 * 8
    assert set(got) == set(want) and got["flops_readable"] == want["flops_readable"]
    k = rs.randn(3, 3, 5, 7).astype(np.float32)
    img = rs.randn(2, 10, 12, 5).astype(np.float32)
    want = janalysis.get_model_complexity_info(
        lambda kk, v: jax.lax.conv_general_dilated(v, kk, (1, 1), "VALID",
                                                   dimension_numbers=("NHWC", "HWIO", "NHWC")),
        k, img)
    got = analysis.get_model_complexity_info(
        lambda kk, v: torch.nn.functional.conv2d(v, kk),
        torch.from_numpy(k).permute(3, 2, 0, 1), torch.from_numpy(img).permute(0, 3, 1, 2))
    assert got["flops"] == want["flops"] == 2 * 2 * 8 * 10 * 7 * 3 * 3 * 5
    net = resnet_v1.ResFCN256Cls(num_classes=3)
    info = analysis.get_model_complexity_info(lambda m, v: m(v), net, torch.zeros(1, 32, 32, 3))
    assert info["params"] == sum(q.numel() for q in net.parameters()) and info["flops"] > 0


def test_misc_and_version():
    from deep3dmap_tpu.utils.misc import machine_cache_dir as jcache
    from deep3dmap_tpu.version import __version__ as jversion
    from deep3dmap_tpu_torch.utils.misc import machine_cache_dir
    from deep3dmap_tpu_torch.version import __version__

    assert machine_cache_dir("/tmp/x") == jcache("/tmp/x") and __version__ == jversion
