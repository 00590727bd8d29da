"""The port's ``tools/import_weights.py`` kinds ``stylegan2``, ``stylegan2_g``,
``stylegan2_d``, ``vgg16`` and ``bisenet`` against the JAX tool on the same
seeded checkpoints in the published layouts
(``datasets/synthetic.py::seeded_stylegan2_state_dict``,
``seeded_vgg16_state_dict``, ``seeded_bisenet_state_dict``), then each
consumer's forward on the imported weights against JAX's.

- The ``.npz`` files: the same entries, the same tree paths and shapes;
  the leaves bit-equal where the import is a transpose (StyleGAN2, VGG16)
  and within 1e-6 where BatchNorm is folded (BiSeNet; both fold in numpy
  float32).
- The consumers, the weights loaded through ``utils/from_flax.py``: the
  StyleGAN2 generator (16², explicit noise) and discriminator, the VGG
  features and BiSeNet, against their flax twins within
  ``tests/test_torch_stylegan2.py``'s 2e-5 (outputs of order one; BiSeNet's
  logits and VGG's deep stages scaled by their largest value).
- The discriminator's flatten order: the torch map ``W @ feat.reshape(-1)``
  over (C, 4, 4) equals the imported map over (4, 4, C), as the JAX test
  ``tests/test_torch_import.py`` checks its own.
"""
import os
import runpy
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep3dmap_tpu_torch.datasets.synthetic import (seeded_bisenet_state_dict,
                                                    seeded_stylegan2_state_dict,
                                                    seeded_vgg16_state_dict)
from deep3dmap_tpu_torch.tools import import_weights as port_tool
from deep3dmap_tpu_torch.utils.from_flax import load_flax_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, STYLE, NMLP, CM = 16, 64, 2, 1
ATOL = 2e-5
FOLD_ATOL = 1e-6
GAN_FLAGS = ["--size", str(SIZE), "--n-mlp", str(NMLP), "--channel-multiplier", str(CM),
             "--style-dim", str(STYLE)]


def _save(obj, path):
    def tens(d):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    torch.save({k: tens(v) for k, v in obj.items()} if "d" in obj else tens(obj), path)


def _jax_tool(argv):
    old = sys.argv
    sys.argv = ["import_weights.py"] + argv
    try:
        runpy.run_path(os.path.join(ROOT, "tools", "import_weights.py"), run_name="__main__")
    finally:
        sys.argv = old


def _load(path):
    with np.load(path, allow_pickle=True) as f:
        return {k: f[k].item() for k in f.files}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Each kind's ``.npz`` from both tools, and the checkpoints."""
    d = tmp_path_factory.mktemp("importers")
    ckpts = {"stylegan2": seeded_stylegan2_state_dict(0, size=SIZE, style_dim=STYLE,
                                                      n_mlp=NMLP, channel_multiplier=CM),
             "vgg16": seeded_vgg16_state_dict(1), "bisenet": seeded_bisenet_state_dict(2)}
    out = {}
    for kind in ("stylegan2", "stylegan2_g", "stylegan2_d", "vgg16", "bisenet"):
        src = d / f"{kind.split('_')[0]}.pth"
        if not src.exists():
            _save(ckpts[kind.split("_")[0]], src)
        flags = GAN_FLAGS if kind.startswith("stylegan2") else []
        port_tool.main([kind, str(src), str(d / f"{kind}_port.npz")] + flags)
        _jax_tool([kind, str(src), str(d / f"{kind}_jax.npz")] + flags)
        out[kind] = (_load(d / f"{kind}_port.npz"), _load(d / f"{kind}_jax.npz"))
    return out, ckpts


@pytest.mark.parametrize("kind", ["stylegan2", "stylegan2_g", "stylegan2_d", "vgg16",
                                  "bisenet"])
def test_npz_equals_jax_tool(files, kind):
    port, want = files[0][kind]
    assert sorted(port) == sorted(want) == {
        "stylegan2": ["d", "g"], "stylegan2_g": ["g"], "stylegan2_d": ["d"]}.get(kind, ["params"])
    for entry in want:
        a, b = _leaves(port[entry]), _leaves(want[entry])
        assert sorted(a) == sorted(b) and len(a) > 10
        for path in b:
            assert a[path].shape == b[path].shape and a[path].dtype == np.float32, path
            if kind == "bisenet":
                np.testing.assert_allclose(a[path], b[path], atol=FOLD_ATOL, rtol=0,
                                           err_msg=path)
            else:
                np.testing.assert_array_equal(a[path], b[path], err_msg=path)


def test_stylegan2_consumers_match_jax(files):
    from deep3dmap_tpu.models.modulars import stylegan2 as J
    from deep3dmap_tpu_torch.models.modulars import stylegan2 as T

    port, want = files[0]["stylegan2"]
    rs = np.random.RandomState(3)
    z = rs.randn(2, STYLE).astype(np.float32)
    noise = [rs.randn(2, r, r, 1).astype(np.float32) for r in (4, 8, 8, 16, 16)]
    jg = J.Generator(size=SIZE, style_dim=STYLE, n_mlp=NMLP, channel_multiplier=CM)
    tg = load_flax_params(T.Generator(SIZE, STYLE, NMLP, CM, device="cpu"), port["g"])
    jy = jg.apply(jax.tree_util.tree_map(jnp.asarray, want["g"]), jnp.asarray(z),
                  noise=[jnp.asarray(n) for n in noise])
    ty = tg(torch.from_numpy(z), noise=[torch.from_numpy(n) for n in noise]).detach().numpy()
    assert ty.shape == (2, SIZE, SIZE, 3) and np.isfinite(ty).all() and ty.std() > 1e-3
    np.testing.assert_allclose(ty, np.asarray(jy), atol=ATOL * max(1.0, np.abs(ty).max()),
                               rtol=0)

    x = rs.randn(2, SIZE, SIZE, 3).astype(np.float32)
    jd = J.StyleDiscriminator(size=SIZE, channel_multiplier=CM)
    td = load_flax_params(T.StyleDiscriminator(SIZE, CM, device="cpu"), port["d"])
    js = np.asarray(jd.apply(jax.tree_util.tree_map(jnp.asarray, want["d"]), jnp.asarray(x)))
    ts = td(torch.from_numpy(x)).detach().numpy()
    assert ts.shape == (2, 1) and np.isfinite(ts).all()
    np.testing.assert_allclose(ts, js, atol=ATOL * max(1.0, np.abs(js).max()), rtol=0)


def test_discriminator_flatten_order(files):
    port, _ = files[0]["stylegan2_d"]
    sd = files[1]["stylegan2"]["d"]
    w_t = sd["final_linear.0.weight"]                      # over torch's (C, 4, 4)
    w_f = port["d"]["params"]["final_dense"]["weight"]     # over (4, 4, C)
    feat = np.random.RandomState(4).randn(w_t.shape[0], 4, 4).astype(np.float32)
    np.testing.assert_allclose(feat.transpose(1, 2, 0).reshape(-1) @ w_f,
                               w_t @ feat.reshape(-1), rtol=1e-4, atol=1e-4)


def test_vgg16_and_bisenet_consumers_match_jax(files, tmp_path):
    from deep3dmap_tpu.models.losses.perceptual_loss import _VGGFeatures as JVGG
    from deep3dmap_tpu.models.parsing.bisenet_fp import BiSeNetFP as JBiSeNet
    from deep3dmap_tpu_torch.models.losses.perceptual_loss import PerceptualLoss
    from deep3dmap_tpu_torch.models.parsing.bisenet_fp import BiSeNetFP

    rs = np.random.RandomState(5)
    port, want = files[0]["vgg16"]
    np.savez(tmp_path / "vgg.npz", **{k: np.array(v, dtype=object) for k, v in port.items()})
    loss = PerceptualLoss(weights_path=str(tmp_path / "vgg.npz"), device="cpu")
    x = rs.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jf = JVGG().apply(jax.tree_util.tree_map(jnp.asarray, want["params"]), jnp.asarray(x))
    tf = loss.net(torch.from_numpy(x))
    for a, b in zip(tf, jf):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, atol=ATOL * max(1.0, np.abs(b).max()),
                                   rtol=0)

    port, want = files[0]["bisenet"]
    x = rs.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    jl = np.asarray(JBiSeNet(n_classes=19).apply(
        jax.tree_util.tree_map(jnp.asarray, want["params"]), jnp.asarray(x)))
    tl = load_flax_params(BiSeNetFP(19), port["params"])(torch.from_numpy(x)).detach().numpy()
    assert tl.shape == (1, 64, 64, 19) and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, atol=ATOL * max(1.0, np.abs(jl).max()), rtol=0)


def test_unknown_kind_and_missing_key_raise():
    from deep3dmap_tpu_torch.utils import torch_import

    with pytest.raises(ValueError, match="unknown import kind"):
        torch_import.import_npz_entries("resnet", {})
    sd = seeded_stylegan2_state_dict(0, size=SIZE, style_dim=STYLE, n_mlp=NMLP,
                                     channel_multiplier=CM)["g_ema"]
    del sd["conv1.noise.weight"]
    with pytest.raises(KeyError):
        torch_import.import_stylegan2_generator(sd, size=SIZE, n_mlp=NMLP)
    with pytest.raises(ValueError, match="from_flax"):     # a mapping deeper than the net
        torch_import.import_npz_entries("stylegan2_g", {"g_ema": seeded_stylegan2_state_dict(
            0, size=SIZE, style_dim=STYLE, n_mlp=NMLP + 1, channel_multiplier=CM)["g_ema"]},
            size=SIZE, n_mlp=NMLP + 1, channel_multiplier=CM, style_dim=STYLE + 1)
