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


# ---------------------------------------------------------------- training --
TRAIN_LR, TRAIN_MAX_NORM = 1e-3, 1.0


def train_fragments(n_vox, n_steps, n_views=2):
    """One B = 1 fragment per step (seeds 0, 1, ...): the first resets the
    scene, the rest carry the state on."""
    frags = []
    for k in range(n_steps):
        b = _stack_samples([make_fragment_sample(
            seed=k, n_views=n_views, img_size=(64, 64), n_vox=n_vox,
            voxel_size=0.08)])
        b["scene_reset"] = np.full(1, 1.0 if k == 0 else 0.0, np.float32)
        frags.append(b)
    return frags


def run_jax_train(cfg, flax_params, frags):
    """``jax.value_and_grad(loss_fn)`` and ``optax.chain(clip_by_global_norm,
    adam)`` over ``frags``, one jitted step (compiled once), state carried.
    Returns per step the loss, the per-level losses, the block ids, and the
    first step's gradients."""
    import jax.numpy as jnp
    import optax

    fw = jax_nr.NeuralRecon(cfg)
    tx = optax.chain(optax.clip_by_global_norm(TRAIN_MAX_NORM),
                     optax.adam(TRAIN_LR))
    ids = []
    orig, rec = _recording(jax_nr, ids)

    def step(params, opt_state, mstate, batch):
        del ids[:]
        (loss, aux), grads = jax.value_and_grad(fw.loss_fn, has_aux=True)(
            params, mstate, batch, jax.random.PRNGKey(0))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state, aux["model_state"], loss,
                aux["log_vars"], grads, list(ids))

    params = jax.tree_util.tree_map(jnp.asarray, {"params": flax_params})
    opt_state = tx.init(params)
    mstate = _jax_state(fw, frags[0])
    jax_nr.select_blocks = rec
    try:
        jstep = jax.jit(step)
        steps = []
        for b in frags:
            params, opt_state, mstate, loss, logs, grads, bids = jstep(
                params, opt_state, mstate, b)
            steps.append(dict(loss=float(loss),
                              logs={k: float(v) for k, v in logs.items()},
                              ids=[np.asarray(i) for i in bids]))
            if len(steps) == 1:
                steps[0]["grads"] = jax.tree_util.tree_map(
                    np.asarray, grads)["params"]
    finally:
        jax_nr.select_blocks = orig
    return steps, jax.tree_util.tree_map(np.asarray, opt_state)


def run_torch_train(fw, frags):
    """The port over the same fragments: the first step's gradients from
    ``loss_fn`` and ``backward`` (before any clip), then ``train_step`` with
    ``build_optimizer``'s clip + Adam.  Returns per step what
    ``run_jax_train`` does, and the final ``TrainState``."""
    from deep3dmap_tpu_torch.runners.optim import build_optimizer
    from deep3dmap_tpu_torch.runners.train_state import TrainState, train_step
    from deep3dmap_tpu_torch.utils.from_flax import to_flax_grads

    net = fw.net
    state = TrainState(net=net, model_state=fw.init_state(1),
                       optimizer=build_optimizer(dict(type="Adam", lr=TRAIN_LR),
                                                 net.parameters(),
                                                 dict(max_norm=TRAIN_MAX_NORM)))
    loss, _ = fw.loss_fn(net, state.model_state, frags[0])
    loss.backward()
    grads = to_flax_grads(net)
    state.optimizer.zero_grad()
    steps = []
    for b in frags:
        ids = []
        orig, rec = _recording(torch_nr, ids)
        torch_nr.select_blocks = rec
        try:
            state, logs = train_step(fw, state, b)
        finally:
            torch_nr.select_blocks = orig
        steps.append(dict(loss=float(logs.pop("loss")),
                          grad_norm=float(logs.pop("grad_norm")),
                          logs={k: float(v) for k, v in logs.items()},
                          ids=[i.numpy() for i in ids]))
    steps[0]["grads"] = grads
    return steps, state


def leaf_rel_errors(want, got, prefix=""):
    """Per flax leaf: ||got - want|| / ||want||, by '/'-joined path."""
    out = {}
    for k, w in want.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(w, dict):
            out.update(leaf_rel_errors(w, got[k], path))
        else:
            w = np.asarray(w, np.float64)
            g = np.asarray(got[k], np.float64)
            assert w.shape == g.shape, (path, w.shape, g.shape)
            out[path] = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
    return out
