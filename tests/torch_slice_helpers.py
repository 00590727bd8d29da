"""Shared runner for the whole-slice parity tests (tests/test_torch_neuralrecon_*.py).

Runs the JAX NeuralRecon and the port on the same two-fragment stream with
the same weights (the JAX init carried over by ``from_flax``):
  fragment 1 (scene reset) -> forward_test -> state 1
  fragment 2 (no reset, state 1 carried) -> forward_test -> state 2
  val_fn on fragment 2 from state 1.
Both sides record the block ids that ``select_blocks`` picks at every block
level, so a flipped occupancy bit shows as a different block set, not as a
tolerance miss.
"""
import numpy as np

import jax
import torch

import deep3dmap_tpu.models.frameworks.neuralrecon as jax_nr
import deep3dmap_tpu_torch.models.frameworks.neuralrecon as torch_nr
from deep3dmap_tpu.datasets.builder import _stack_samples
from deep3dmap_tpu.datasets.synthetic import make_fragment_sample


def two_fragments(n_views, n_vox, seeds=((0, 1), (2, 3))):
    frags = []
    for k, pair in enumerate(seeds):
        b = _stack_samples([make_fragment_sample(
            seed=s, n_views=n_views, img_size=(64, 64), n_vox=n_vox,
            voxel_size=0.08) for s in pair])
        b["scene_reset"] = np.full(len(pair), 1.0 if k == 0 else 0.0, np.float32)
        frags.append(b)
    return frags


def _recording(module, store):
    orig = module.select_blocks

    def rec(*a, **kw):
        bset = orig(*a, **kw)
        store.append(bset.ids)
        return bset
    return orig, rec


def run_jax(fw, params, frags):
    ids = []
    orig, rec = _recording(jax_nr, ids)

    def stream(p, m, b1, b2):
        o1, m1 = fw.forward_test(p, m, b1)
        o2, m2 = fw.forward_test(p, m1, b2)
        v = fw.val_fn(p, m1, b2)["log_vars"]["loss"]
        return o1, o2, m2, v, list(ids)

    jax_nr.select_blocks = rec
    try:
        out = jax.jit(stream)(params, _jax_state(fw, frags[0]), *frags)
    finally:
        jax_nr.select_blocks = orig
    o1, o2, m2, v, ids = jax.tree_util.tree_map(np.asarray, out)
    return dict(o1=o1, o2=o2, hidden=m2["global_hidden"].volumes, val=v,
                ids=ids)


def _jax_state(fw, batch):
    import jax.numpy as jnp
    from deep3dmap_tpu.models.modulars.global_volume import init_global_volumes
    gdt = jnp.dtype(fw.global_dtype) if fw.global_dtype else jnp.float32
    return {"global_hidden": init_global_volumes(
        batch["imgs"].shape[0], fw.global_dims, fw.out_channels, dtype=gdt)}


def run_torch(fw, frags):
    ids = []
    orig, rec = _recording(torch_nr, ids)
    torch_nr.select_blocks = rec
    try:
        net = fw.net
        m0 = fw.init_state(2)
        o1, m1 = fw.forward_test(net, m0, frags[0])
        o2, m2 = fw.forward_test(net, m1, frags[1])
        v = fw.val_fn(net, m1, frags[1])["log_vars"]["loss"]
    finally:
        torch_nr.select_blocks = orig
    np_ = lambda t: t.float().numpy()   # noqa: E731
    return dict(o1={k: np_(t) for k, t in o1.items()},
                o2={k: np_(t) for k, t in o2.items()},
                hidden=[np_(t) for t in m2["global_hidden"].volumes],
                val=float(v), ids=[t.numpy() for t in ids])


def build_pair(cfg, frags, seed=0):
    """JAX framework + its init, and the port with those weights (CPU)."""
    jfw = jax_nr.NeuralRecon(cfg)
    params, _ = jfw.init(jax.random.PRNGKey(seed), frags[0])
    tfw = torch_nr.NeuralRecon(cfg, device="cpu")
    tfw.load_flax(jax.tree_util.tree_map(np.asarray, params))
    return jfw, params, tfw


def compare(j, t, atol, val_rtol):
    """Identical block ids at every level, then outputs within ``atol``."""
    assert len(j["ids"]) == len(t["ids"])
    for a, b in zip(j["ids"], t["ids"]):
        np.testing.assert_array_equal(a, b)
    for frag in ("o1", "o2"):
        for k in ("tsdf", "occ", "origin"):
            np.testing.assert_allclose(np.asarray(j[frag][k], np.float32),
                                       t[frag][k], atol=atol, rtol=0,
                                       err_msg=f"{frag}/{k}")
    for a, b in zip(j["hidden"], t["hidden"]):
        np.testing.assert_allclose(np.asarray(a, np.float32), b, atol=atol,
                                   rtol=0, err_msg="hidden")
    np.testing.assert_allclose(float(j["val"]), t["val"], rtol=val_rtol)
