"""LERF's whole model in the port against JAX, on the CPU: ``loss_fn`` and
every gradient leaf against ``jax.value_and_grad`` for both RGB fields,
``forward_test``'s relevancy and best scales with two positives set, and
``top_k``'s rule among equal weights.

Both sides take the same weights (``from_flax``), the same batch and the
same uniforms (JAX's own, from its key).  The MLP path's importance samples
are shared (the port's handed to JAX): ``sample_pdf`` jumps where a bin's
cdf step meets its eps, and with random weights a few rays sit there, so
an ulp of summation order moves a sample by a bin and the first layer's
gradient by ~2e-3; JAX stops their gradient, so sharing them leaves the
rest of the step intact.  The hash-grid path is continuous (the proposal
weights carry +1e-5 before the eps) and shares nothing: its samples carry
their gradient to the proposal field, which is held here too.

Tolerances: losses to ``LOSS_RTOL`` 1e-5, each gradient leaf to
``GRAD_RTOL`` 1e-4 of its norm (measured: 2.3e-6 for the MLP with the
samples shared, 3.8e-6 for the hash grid, both against JAX's jitted
step); maps to 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deep3dmap_tpu.models.frameworks.lerf as jlerf
import deep3dmap_tpu_torch.models.frameworks.lerf as tlerf
from deep3dmap_tpu.models.modulars.clip_encoder import CLIPEncoder as JEnc
from deep3dmap_tpu_torch.datasets.lerf_rays import LERFRayDataset
from deep3dmap_tpu_torch.utils.from_flax import load_flax_params, to_flax_grads

torch.set_num_threads(2)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
CFG = dict(clip_n_dims=64, dino_n_dims=32, N_samples=8, N_importance=8,
           num_lerf_samples=4, fc_depth=2, fc_dim=32, grid_layers=(2, 2),
           grid_sizes=(10, 10), grid_resolutions=((4, 16), (16, 32)), hidden=32,
           n_scales=5)
HASH = dict(CFG, rgb_field_type="hashgrid", N_proposal=16, N_importance=16,
            rgb_grid_levels=4, rgb_grid_log2=10, rgb_grid_end=64, rgb_hidden=32)
N_RAYS = 64
PHRASES = ["blue sphere", "red chair"]


def _draws(jfw, key, n):
    r1, r2 = jax.random.split(key)
    out = {"u_pdf": torch.from_numpy(np.array(jax.random.uniform(r1, (n, jfw.n_importance))))}
    if jfw.rgb_field_type == "hashgrid":
        out["u_prop"] = torch.from_numpy(
            np.array(jax.random.uniform(r2, (n, jfw.n_prop_samples))))
    return out


def leaf_errors(jgrads, net) -> dict:
    got = dict((jax.tree_util.keystr(k), v) for k, v in
               jax.tree_util.tree_leaves_with_path(to_flax_grads(net)))
    out = {}
    for k, a in jax.tree_util.tree_leaves_with_path(jgrads):
        a = np.asarray(a)
        out[jax.tree_util.keystr(k)] = (float(np.linalg.norm(got[jax.tree_util.keystr(k)] - a))
                                        / max(float(np.linalg.norm(a)), 1e-12))
    assert set(out) == set(got)
    return out


class Shared:
    """Records the port's ``sample_pdf`` results and replays them, in call
    order, to JAX's framework module."""

    def __init__(self, monkeypatch):
        self.mp, self.z = monkeypatch, []

    def record(self):
        orig = tlerf.sample_pdf

        def rec(*a, **kw):
            self.z.append(orig(*a, **kw))
            return self.z[-1]
        self.mp.setattr(tlerf, "sample_pdf", rec)

    def replay(self):
        queue = [jnp.asarray(z.numpy()) for z in self.z]
        self.mp.setattr(jlerf, "sample_pdf", lambda *a, **kw: queue.pop(0))


@pytest.fixture(scope="module")
def clip_npz(tmp_path_factory):
    j = JEnc(embed_dim=64, seed=2)
    path = str(tmp_path_factory.mktemp("lerf") / "clip.npz")
    tree = lambda x: np.array(jax.tree_util.tree_map(np.asarray, x), dtype=object)  # noqa: E731
    np.savez(path, image=tree(j.image_params), text=tree(j.text_params))
    return path


def _setup(cfg, clip_npz):
    cfg = dict(cfg, clip_weights=clip_npz)
    fw = tlerf.LERFModel(cfg, device="cpu")
    batch = next(iter(LERFRayDataset(rays_per_batch=N_RAYS, n_batches=1, clip_n_dims=64,
                                     dino_n_dims=32, image_encoder=fw.image_encoder,
                                     device="cpu")))
    jfw = jlerf.LERFModel(cfg)
    params, _ = jfw.init(jax.random.PRNGKey(0), batch)
    net, _ = fw.init(0, batch)
    load_flax_params(net, jax.tree_util.tree_map(np.asarray, params))
    return fw, jfw, net, params, batch


@pytest.mark.parametrize("cfg", [CFG, HASH], ids=["mlp", "hashgrid"])
def test_loss_and_every_gradient(cfg, clip_npz, monkeypatch):
    fw, jfw, net, params, batch = _setup(cfg, clip_npz)
    key = jax.random.PRNGKey(1)
    shared = Shared(monkeypatch)
    if cfg is CFG:
        shared.record()
    loss, aux = fw.loss_fn(net, {}, batch, draws=_draws(jfw, key, N_RAYS))
    loss.backward()
    if cfg is CFG:
        assert len(shared.z) == 1
        shared.replay()
    (jloss, jaux), g = jax.jit(jax.value_and_grad(
        lambda p: jfw.loss_fn(p, {}, batch, key), has_aux=True))(params)
    assert set(aux["log_vars"]) == set(jaux["log_vars"])
    for k, v in jaux["log_vars"].items():
        assert float(aux["log_vars"][k]) == pytest.approx(float(v), rel=LOSS_RTOL, abs=1e-7), k
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    errs = leaf_errors(g, net)
    worst = max(errs, key=errs.get)
    assert errs[worst] < GRAD_RTOL, (worst, errs[worst])
    if cfg is HASH:
        # the proposal field's gradient: nonzero, and it needs the samples'
        # gradient (without it, from the RGB and CLIP losses, it is another)
        assert "prop_loss" in aux["log_vars"]
        prop = {k: v for k, v in errs.items() if k.startswith("['proposal']")}
        assert prop and all(np.abs(np.asarray(x)).sum() > 0 for x in
                            jax.tree_util.tree_leaves(g["proposal"]))
        net.zero_grad(set_to_none=True)
        monkeypatch.setattr(tlerf, "sample_pdf_differentiable",
                            lambda *a, **kw: tlerf.sample_pdf(*a, **kw))
        fw.loss_fn(net, {}, batch, draws=_draws(jfw, key, N_RAYS))[0].backward()
        stopped = leaf_errors(g, net)
        assert max(stopped[k] for k in prop) > 1e-2, stopped


@pytest.mark.parametrize("cfg", [CFG, HASH], ids=["mlp", "hashgrid"])
def test_forward_test_relevancy(cfg, clip_npz, monkeypatch):
    fw, jfw, net, params, batch = _setup(cfg, clip_npz)
    fw.image_encoder.set_positives(PHRASES)
    jfw.image_encoder.set_positives(PHRASES)
    shared = Shared(monkeypatch)
    if cfg is CFG:
        shared.record()
    out, _ = fw.forward_test(net, {}, batch)
    if cfg is CFG:
        shared.replay()
    want, _ = jfw.forward_test(params, {}, batch)
    assert set(out) == set(want) == {"rgb", "depth", "raw_relevancy", "best_scales"}
    assert out["raw_relevancy"].shape == (2, N_RAYS)
    for k in ("rgb", "depth", "raw_relevancy"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(out["best_scales"].numpy(), np.asarray(want["best_scales"]))


def test_top_k_takes_the_lower_index_among_equal_weights(clip_npz):
    fw = tlerf.LERFModel(CFG, device="cpu")
    jfw = jlerf.LERFModel(dict(CFG))
    rs = np.random.RandomState(0)
    w = rs.rand(32, 16).astype(np.float32)
    w[:, ::2] = 0.0                       # exact zeros, as early in training
    w[:8] = 0.0
    w[8:16, 3:9] = 0.5                    # ties above zero
    z = np.sort(rs.rand(32, 16).astype(np.float32), -1)
    xyz = rs.randn(32, 16, 3).astype(np.float32)
    want = jfw._lerf_samples(jnp.asarray(w), jnp.asarray(z), jnp.asarray(xyz))
    got = fw._lerf_samples(torch.from_numpy(w), torch.from_numpy(z), torch.from_numpy(xyz))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
