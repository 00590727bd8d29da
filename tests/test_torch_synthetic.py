"""Port parity: the synthetic fragment generator and the TSDF fusion that
builds its ground truth, against the JAX package's.

The numpy parts (sphere tracing, poses, projections) are copies and agree
exactly.  The GT TSDF goes through float32 projections in both frameworks;
``round`` is half-to-even in both, so pixel lookups agree and the fused
volumes agree to float32 rounding (atol 1e-5).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deep3dmap_tpu.core.tsdf import fusion as JF
from deep3dmap_tpu.datasets.builder import _stack_samples as jstack
from deep3dmap_tpu.datasets.synthetic import make_fragment_sample as jmake
from deep3dmap_tpu_torch.core.tsdf import fusion as TF
from deep3dmap_tpu_torch.datasets.builder import _stack_samples as tstack
from deep3dmap_tpu_torch.datasets.synthetic import make_fragment_sample as tmake

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def samples():
    kw = dict(seed=5, n_views=3, img_size=(32, 48), n_vox=16, voxel_size=0.08)
    return jmake(**kw), tmake(**kw, device="cpu")


def test_fragment_sample_matches(samples):
    js, ts = samples
    assert js.keys() == ts.keys()
    for k in js:
        if k in ("tsdf_list", "occ_list"):
            continue
        np.testing.assert_array_equal(np.asarray(js[k]), np.asarray(ts[k]), err_msg=k)
    for a, b in zip(js["tsdf_list"], ts["tsdf_list"]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    for a, b in zip(js["occ_list"], ts["occ_list"]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert ts["occ_list"][0].sum() > 0


def test_stack_samples_matches(samples):
    js, ts = samples
    jb, tb = jstack([js, js]), tstack([ts, ts])
    assert jb.keys() == tb.keys()
    assert tb["imgs"].shape == (2, 3, 32, 48, 3)
    assert len(tb["tsdf_list"]) == 3 and tb["tsdf_list"][0].shape == (2, 16, 16, 16)


def test_tsdf_integrate_half_pixel_rounding():
    """A pixel coordinate of exactly k + 0.5 rounds to even in both."""
    depth = np.linspace(0.5, 2.0, 8 * 8, dtype=np.float32).reshape(8, 8)
    K = np.array([[4, 0, 3.5], [0, 4, 3.5], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    origin = np.array([-0.5, -0.5, 0.5], np.float32)
    p = (4, 4, 4)
    jt, jw = JF.tsdf_integrate(jnp.ones(p), jnp.zeros(p), jnp.asarray(depth),
                               jnp.asarray(K), jnp.asarray(pose),
                               jnp.asarray(origin), JF.TSDFParams(p, 0.25))
    tt, tw = TF.tsdf_integrate(torch.ones(p), torch.zeros(p),
                               torch.from_numpy(depth), torch.from_numpy(K),
                               torch.from_numpy(pose), torch.from_numpy(origin),
                               TF.TSDFParams(p, 0.25))
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    np.testing.assert_allclose(np.asarray(jt), tt.numpy(), atol=1e-6)
    assert tw.sum() > 0
