"""The spatially sharded volume on the CPU: the port's ranks are 4 gloo
processes (``torch_dist.run_ranks``, started once for the file); JAX's side
runs on the conftest's 8-device CPU mesh.

- ``halo_pad`` over 4 ranks against JAX's under ``shard_map``;
- ``conv_gru3d_halo`` at 4 ranks and at 2 (the ``model`` axis of a (2, 2)
  mesh), forward against JAX's ``conv_gru3d_halo`` and the unsharded
  flax cell, within JAX's own 2e-5 (``tests/test_halo_fusion.py``):
  measured 3.6e-7 at most; its gradients (the halo's backward and the
  weights' sum over the ranks) against the port's unsharded cell under
  autograd, measured 5.1e-7 of the largest entry;
- NeuralRecon's spatial path on a (data, model) = (2, 2) mesh: the global
  volumes in X slabs whose windows straddle the ranks (a scene origin
  offset by 4 / 2 / 1 voxels), two steps with the state carried, against
  one rank on the same global batch: losses, gradients and the volumes
  written back.  Measured: losses 1.3e-7 relative, the whole gradient
  3.4e-5 relative, volumes 2.9e-5 absolute at the finest level, as much
  against a one-sample reference (the CPU's 3D convs round a halo-padded
  slab differently from the whole window, ~1e-6 at the coarse levels,
  and the finer levels' nets carry it on).  Each rank holds half the
  volumes' bytes.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from deep3dmap_tpu.datasets.builder import _stack_samples
from deep3dmap_tpu.datasets.synthetic import make_fragment_sample
from deep3dmap_tpu.models.modulars.conv_gru3d import ConvGRU3D as JaxGRU
from deep3dmap_tpu.parallel.spatial import conv_gru3d_halo as jax_halo_gru
from deep3dmap_tpu.parallel.spatial import halo_pad as jax_halo_pad
from deep3dmap_tpu_torch.models.frameworks.neuralrecon import NeuralRecon
from deep3dmap_tpu_torch.models.modulars.conv_gru3d import ConvGRU3D
from deep3dmap_tpu_torch.utils.from_flax import load_flax_params, to_flax_grads, \
    to_flax_params
from torch_dist import run_ranks, save_inputs

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

torch.set_num_threads(2)

TOL_GRU = 2e-5           # JAX's bound, tests/test_halo_fusion.py:48-50
TOL_GRU_GRAD = 2e-5      # of the largest gradient entry
TOL_LOSS = 1e-5
TOL_GRAD = 1e-4          # the whole gradient, relative
TOL_VOLUME = 1e-4         # absolute: GRU outputs in [-1, 1]
GXS = (8, 16)
OFFSET = np.array([4.0, 2.0, 0.0], np.float32)   # finest-level voxels
CFG = dict(N_LAYER=3, VOXEL_SIZE=0.08, FUSION=dict(FUSION_ON=True, FULL=True),
           LW=[1.0, 0.8, 0.64], THRESHOLDS=[0, 0, 0], POS_WEIGHT=1.5,
           BACKBONE2D=dict(ARC="fpn-mnas-0.5", MODE="batch"), N_VOX=[16, 16, 16],
           GLOBAL_DIMS=[8, 16, 32])


def _fragments():
    frags = []
    for k in range(2):
        b = _stack_samples([make_fragment_sample(seed=2 * k + j, n_views=2,
                                                 img_size=(32, 32), n_vox=16,
                                                 voxel_size=0.08) for j in range(2)])
        b["scene_reset"] = np.full(2, 1.0 if k == 0 else 0.0, np.float32)
        b["vol_origin"] = b["vol_origin_partial"] - OFFSET * 0.08
        frags.append(b)
    return frags


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("halo")
    rs = np.random.RandomState(0)
    gru_cases = []
    for gx in GXS:
        h = rs.randn(2, gx, 4, 4, 6).astype(np.float32)
        x = rs.randn(2, gx, 4, 4, 3).astype(np.float32)
        params = JaxGRU(hidden_dim=6).init(jax.random.PRNGKey(0), jnp.asarray(h),
                                           jnp.asarray(x))
        gru_cases.append(dict(gx=gx, ch=6, cx=3, h=h, x=x,
                              ct=rs.randn(2, gx, 4, 4, 6).astype(np.float32),
                              params=jax.tree_util.tree_map(np.asarray, params)))
    frags = _fragments()
    fw = NeuralRecon(CFG, device="cpu")
    net, _ = fw.init(0, frags[0])
    path = save_inputs(tmp, "halo_in.pt", dict(gru=gru_cases, cfg=CFG, batches=frags,
                                               params=to_flax_params(net)))
    ranks = run_ranks(4, "halo", tmp, inputs=path)
    return gru_cases, frags, fw, net, ranks


def test_halo_pad_against_jax(runs):
    *_, ranks = runs
    mesh = Mesh(np.array(jax.devices()[:4]), ("model",))
    x = jnp.arange(8, dtype=jnp.float32).reshape(1, 8, 1, 1, 1)
    want = shard_map(lambda b: jax_halo_pad(b, "model", 1), mesh=mesh,
                     in_specs=P(None, "model"), out_specs=P(None, "model"))(x)
    want = np.asarray(want).reshape(4, 4)
    got = np.stack([r["halo_pad"].reshape(4) for r in ranks])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], [1, 2, 3, 4])
    assert got[0, 0] == 0.0 and got[3, -1] == 0.0


@pytest.mark.parametrize("gx", GXS)
@pytest.mark.parametrize("n", [2, 4])
def test_conv_gru3d_halo_against_jax(runs, gx, n):
    cases, *_, ranks = runs
    case = next(c for c in cases if c["gx"] == gx)
    # rank order: on the (2, 2) mesh ranks 0-1 are data row 0's model axis
    slabs = [ranks[r][f"gru_{gx}_{n}"] for r in range(n)]
    got = np.concatenate([s["y"] for s in slabs], axis=1)
    mesh = Mesh(np.array(jax.devices()[:n]), ("model",))
    h, x = jnp.asarray(case["h"]), jnp.asarray(case["x"])
    want = np.asarray(jax_halo_gru(case["params"], h, x, mesh, axis="model"))
    ref = np.asarray(JaxGRU(hidden_dim=6).apply(case["params"], h, x))
    np.testing.assert_allclose(got, want, rtol=TOL_GRU, atol=TOL_GRU)
    np.testing.assert_allclose(got, ref, rtol=TOL_GRU, atol=TOL_GRU)

    # the gradients against the port's unsharded cell
    gru = ConvGRU3D(6, 3)
    load_flax_params(gru, case["params"])
    th = torch.tensor(case["h"], requires_grad=True)
    tx = torch.tensor(case["x"], requires_grad=True)
    (gru(th, tx) * torch.tensor(case["ct"])).sum().backward()
    for key, want_g in (("dh", th.grad), ("dx", tx.grad)):
        g = np.concatenate([s[key] for s in slabs], axis=1)
        scale = float(want_g.abs().max())
        assert np.abs(g - want_g.numpy()).max() <= TOL_GRU_GRAD * scale, key
    for name, p in gru.named_parameters():
        scale = float(p.grad.abs().max())
        for s in slabs:      # every rank holds the summed gradient
            assert np.abs(s["dw"][name] - p.grad.numpy()).max() <= TOL_GRU_GRAD * scale, name


def _flat(tree):
    return np.concatenate([np.ravel(v) if not isinstance(v, dict) else _flat(v)
                           for _, v in sorted(tree.items())])


def test_spatial_neuralrecon_step_against_one_rank(runs):
    _, frags, fw, net, ranks = runs
    ms = fw.init_state(2)
    ref = []
    for b in frags:
        net.zero_grad()
        loss, aux = fw.loss_fn(net, ms, b)
        loss.backward()
        ms = aux["model_state"]
        ref.append(dict(loss=float(loss), grads=_flat(to_flax_grads(net)),
                        volumes=[v.detach().numpy() for v in ms["global_hidden"].volumes]))
    for step, want in enumerate(ref):
        for r, rank in enumerate(ranks):
            got = rank["spatial"][step]
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL_LOSS)
            g = _flat(got["grads"])
            assert np.linalg.norm(g - want["grads"]) <= TOL_GRAD * np.linalg.norm(
                want["grads"]), (step, r)
        # rank (d, m) holds sample d's X slab m of each volume
        for lv, w in enumerate(want["volumes"]):
            k = w.shape[1] // 2
            for r, rank in enumerate(ranks):
                d, m = divmod(r, 2)
                got = rank["spatial"][step]["volumes"][lv]
                assert got.shape == (1, k) + w.shape[2:]
                np.testing.assert_allclose(got[0], w[d, m * k:(m + 1) * k],
                                           atol=TOL_VOLUME, rtol=0)
    whole = sum(v[:1].nbytes for v in ref[-1]["volumes"])
    assert all(rank["volume_bytes"] * 2 == whole for rank in ranks)
