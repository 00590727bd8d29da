"""Gan2Shape training around the steps: the port against the JAX package.

The bilinear resize against ``jax.image.resize`` (forward and VJP, down,
up and ragged sizes; within 1e-6 abs), a ``gan_ckpt`` round trip through an
``.npz`` written from the JAX init's trees, and ``Gan2ShapeRunner``: one
Adam step per mode against ``optax.adam`` given the port's gradients,
heads outside ``MODE_NETS`` bitwise unchanged, step-3 pool indices equal to
those JAX's own ``fit_instance`` gives, ``reset_weight`` restoring the
heads but not Adam's state, and the mask derived by ``parse_mask`` once per
instance when ``use_mask`` is set and the instance has none.  The steps themselves are
``tests/test_torch_gan2shape_train.py``'s.
"""
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from deep3dmap_tpu.datasets.gan_faces import SyntheticGanFaceDataset as JDataset
from deep3dmap_tpu.models.frameworks import gan2shape as JG
from deep3dmap_tpu.runners import gan2shape_runner as JR
from deep3dmap_tpu_torch.models.frameworks import gan2shape as TG
from deep3dmap_tpu_torch.runners import gan2shape_runner as TR
from deep3dmap_tpu_torch.utils.from_flax import to_flax_grads, to_flax_params

torch.set_num_threads(2)
CFG = dict(image_size=32, gan_size=16, z_dim=32, n_mlp=4, nf=8, batchsize=4,
           channel_multiplier=1, F1_d=2)
HEADS = ("depth_head", "albedo_head", "view_head", "light_head", "encoder_head")
LR = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def jax_init():
    jfw = JG.Gan2Shape(CFG)
    batch = JDataset(n_samples=1, image_size=32, z_dim=32).setup_input(0)
    params, mstate = jfw.init(jax.random.PRNGKey(0), batch)
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), mstate), batch


@pytest.mark.parametrize("n_in,n_out", [(32, 16), (16, 32), (32, 32), (12, 20)])
def test_resize_matches_jax_image_resize(rng, n_in, n_out):
    x = rng.randn(2, n_in, n_in, 3).astype(np.float32)
    g = rng.randn(2, n_out, n_out, 3).astype(np.float32)
    jy, jvjp = jax.vjp(lambda a: jax.image.resize(a, (2, n_out, n_out, 3), "bilinear"),
                       jnp.asarray(x))
    tx = _t(x).requires_grad_()
    ty = TG.resize_bilinear(tx, n_out)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-6, rtol=0)
    (tg,) = torch.autograd.grad(ty, tx, _t(g))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jvjp(jnp.asarray(g))[0]),
                               atol=1e-6, rtol=0)


def test_gan_ckpt_round_trip(jax_init, tmp_path):
    """An ``.npz`` as ``tools/import_weights.py`` writes it, from the JAX
    init's trees: the port loads both trees leaf for leaf and computes the
    centres JAX computed from them.  ``parsing_ckpt`` (an ``.npz`` from a
    JAX ``FaceParser`` init) loads the same way into the parser that
    ``parse_mask`` builds on its first call."""
    mstate, batch = jax_init
    path = tmp_path / "stylegan2.npz"
    np.savez(path, g=np.array(mstate["gan_params"], dtype=object),
             d=np.array(mstate["disc_params"], dtype=object))
    tfw = TG.Gan2Shape(dict(CFG, gan_ckpt=str(path)), device="cpu")
    _, state = tfw.init(3, batch)
    for module, tree in ((tfw.generator, mstate["gan_params"]),
                         (tfw.discriminator, mstate["disc_params"])):
        got = dict(jax.tree_util.tree_leaves_with_path(to_flax_params(module)))
        want = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        assert not any(p.requires_grad for p in module.parameters())
    for k in ("center_w", "center_h"):
        np.testing.assert_allclose(state[k].numpy(), mstate[k], atol=1e-5, rtol=1e-5)
    from deep3dmap_tpu.models.parsing.bisenet_fp import FaceParser as JFaceParser
    parsing = JFaceParser().params
    ppath = tmp_path / "bisenet.npz"
    np.savez(ppath, params=np.array(jax.tree_util.tree_map(np.asarray, parsing),
                                    dtype=object))
    pfw = TG.Gan2Shape(dict(CFG, parsing_ckpt=str(ppath), use_mask=True), device="cpu")
    mask = pfw.parse_mask(batch["input_im"])
    assert mask.shape == (1, 32, 32, 1) and mask.device.type == "cpu"
    assert float(mask.min()) >= 0.0 and float(mask.max()) <= 1.0
    got = dict(jax.tree_util.tree_leaves_with_path(to_flax_params(pfw._parser.net)))
    want = dict(jax.tree_util.tree_leaves_with_path(parsing["params"]))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# -- the runner -------------------------------------------------------------
@pytest.fixture(scope="module")
def runner(jax_init):
    batch = jax_init[1]
    fw = TG.Gan2Shape(dict(CFG, raster_mode="hard"), device="cpu")
    r = TR.Gan2ShapeRunner(fw, dict(type="Adam", lr=LR), stage_iters=(1, 4, 1),
                           num_stage=1)
    r.setup(batch)
    dev = fw.batch_to_device(batch)
    b2 = dict(dev, **r._collect_canon(dev))
    return r, dev, b2


def _head_tree(net, name, grads=False):
    tree = to_flax_grads(net) if grads else to_flax_params(net)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree[name])


def test_runner_adam_step_per_mode_matches_optax(runner):
    """Each mode's step against ``optax.adam`` given the port's gradients,
    the optax state of each head carried across modes as JAX's runner
    carries ``opt_state[name]``; heads outside ``MODE_NETS`` stay bitwise."""
    r, dev, b2 = runner
    net = r.net
    tx = optax.adam(LR)
    opt = {h: tx.init(_head_tree(net, h)) for h in HEADS}
    b3 = dict(dev, proj_im=b2["input_im"].expand(4, -1, -1, -1).clone(),
              proj_mask=torch.ones(4, 32, 32, 1))
    for mode, b in (("step1", dev), ("step2", b2), ("step3", b3), ("step1", dev)):
        before = {h: _head_tree(net, h) for h in HEADS}
        raw = {n: p.detach().clone() for n, p in net.named_parameters()}
        log = r.train_step(mode, b)
        assert set(log) >= {"loss"} and all(torch.is_tensor(v) for v in log.values())
        for h in HEADS:
            if h not in TR.MODE_NETS[mode]:
                for n, p in getattr(net, h).named_parameters():
                    assert torch.equal(p, raw[f"{h}.{n}"]), (mode, h, n)
                continue
            g = _head_tree(net, h, grads=True)
            upd, opt[h] = tx.update(g, opt[h], before[h])
            want = optax.apply_updates(before[h], upd)
            got = _head_tree(net, h)
            for (path, w), a in zip(jax.tree_util.tree_leaves_with_path(want),
                                    jax.tree_util.tree_leaves(got)):
                # torch's float32 Adam against optax in float64: the update
                # to 1e-8 (1e-4 of lr; measured 1.0e-9 once a second
                # moment mixes gradients of both signs) plus one rounding
                # of the parameter
                np.testing.assert_allclose(a, w, atol=1e-8, rtol=1.2e-7,
                                           err_msg=f"{mode} {h} {path}")
            moved = sum(float(np.abs(a - b).max()) for a, b in zip(
                jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(before[h])))
            assert moved > 0, (mode, h)


class _Labelled:
    """Pool rows that name themselves: row j of the pool holds the value j."""

    def __init__(self, b):
        self.b, self.n = b, 0

    def proj(self):
        rows = np.arange(self.n, self.n + self.b, dtype=np.float32)
        self.n += self.b
        return np.broadcast_to(rows[:, None, None, None], (self.b, 2, 2, 3)).copy()


def _jax_step3_indices(monkeypatch, stage_iters, num_stage, b):
    """Pool indices that JAX's own ``Gan2ShapeRunner.fit_instance`` gives
    its step-3 batches, the steps and models stubbed out."""
    monkeypatch.setattr(JR, "shard_batch", lambda batch, mesh: batch)
    lab, seen = _Labelled(b), []

    def forward_step2(params, mstate, batch, rng):
        p = lab.proj()
        return 0.0, {}, dict(proj_im=p, mask=p[..., :1])

    def mode_step(mode):
        def step(state, batch):
            if mode == "step3":
                seen.append(batch["proj_im"][:, 0, 0, 0].astype(np.int64))
            return state, {}
        return step
    fake = types.SimpleNamespace(
        reset_weight=False, _init_params=None, mesh=None, num_stage=num_stage,
        stage_iters=dict(zip(("step1", "step2", "step3"), stage_iters)),
        state=types.SimpleNamespace(params=None, model_state=None),
        framework=types.SimpleNamespace(batchsize=b, forward_step2=forward_step2),
        _collect_canon=lambda batch: {}, _get_mode_step=mode_step,
        log_buffer=types.SimpleNamespace(update=lambda d: None))
    JR.Gan2ShapeRunner.fit_instance(fake, {"input_im": np.zeros((1, 2, 2, 3), np.float32)})
    return np.stack(seen)


def test_step3_indices_match_jax_runner(runner, monkeypatch):
    r, dev, _ = runner
    stage_iters, num_stage, b = (1, 8, 5), 2, 4
    want = _jax_step3_indices(monkeypatch, stage_iters, num_stage, b)
    assert want.shape == (num_stage * 5, b)
    # the port's loop over the same stages, its steps recorded
    lab, seen = _Labelled(b), []

    def pool(batch):
        p = torch.cat([_t(lab.proj()) for _ in range(stage_iters[1] // 4)])
        return p, p[..., :1]

    def step(mode, batch):
        if mode == "step3":
            seen.append(batch["proj_im"][:, 0, 0, 0].long().numpy())
        return {}
    fake = types.SimpleNamespace(
        framework=types.SimpleNamespace(batchsize=b, device=torch.device("cpu"),
                                        batch_to_device=lambda x: x),
        reset_weight=False, _init_params=None, num_stage=num_stage,
        stage_iters=dict(zip(("step1", "step2", "step3"), stage_iters)),
        epoch=0, logs=[], net=None, train_step=step, _collect_canon=lambda d: {},
        log_buffer=types.SimpleNamespace(update=lambda d: None),
        _collect_pool=pool, _stage_means=lambda logs, stage: {})
    TR.Gan2ShapeRunner.fit_instance(fake, {"input_im": torch.zeros(1, 2, 2, 3)})
    np.testing.assert_array_equal(np.stack(seen), want)
    for stage in range(num_stage):       # the pool restarts at each stage
        np.testing.assert_array_equal(
            TR.step3_indices(stage, 8, b, 5) + 8 * stage, want[5 * stage:5 * stage + 5])
    # a pool smaller than the batch draws with replacement, as JAX does
    rs = np.random.RandomState(0)
    np.testing.assert_array_equal(TR.step3_indices(0, 3, 4, 2),
                                  [rs.choice(3, 4, replace=True) for _ in range(2)])


def test_fit_instance_reset_weight_keeps_adam_state(runner):
    """Two instances: each starts from the initial heads (``reset_weight``);
    Adam's counts and moments run on across them, as JAX's ``opt_state``."""
    r, dev, _ = runner
    r.step = 0
    pending, starts = [], []
    orig = r.train_step

    def spy(mode, batch):
        if pending:       # the heads as the instance's first step finds them
            pending.clear()
            starts.append({n: p.detach().clone() for n, p in r.net.named_parameters()})
        return orig(mode, batch)
    r.train_step = spy
    try:
        counts = []
        for _ in range(2):
            pending.append(True)
            r.fit_instance({k: v.numpy() for k, v in dev.items()})
            for n, p in r.net.named_parameters():
                assert torch.equal(starts[-1][n], r._init_params[n]), n
                assert not torch.equal(p, r._init_params[n]), n
            counts.append({h: {int(s["step"]) for s in o.adam.state.values()}
                           for h, o in r.optimizers.items()})
    finally:
        r.train_step = orig
    assert r.step == 12 and len(r.logs) == 2
    assert {"s1_loss", "s2_loss", "s3_loss", "s3_step3_l1"} <= set(r.logs[0])
    assert all(np.isfinite(v) for v in r.logs[1].values() if isinstance(v, float))
    # step 1 and step 3 step the four shape heads, step 2 the encoder
    first, second = counts
    for h in HEADS:
        assert len(first[h]) == len(second[h]) == 1
        assert second[h].pop() - first[h].pop() in ((2,) if h != "encoder_head" else (4,))


def test_use_mask_without_input_mask_raises():
    """``use_mask`` with an instance that has no ``input_mask``: the runner
    derives it with ``parse_mask`` once per instance and fits the instance
    with it, (1, S, S, 1) on the device (JAX ``:147-154``); an instance
    with its own mask keeps it.  ``run`` without ``max_epochs`` raises."""
    fw = TG.Gan2Shape(dict(CFG, use_mask=True), device="cpu")
    r = TR.Gan2ShapeRunner(fw, stage_iters=(1, 1, 1), num_stage=1, max_epochs=2)
    data = JDataset(n_samples=2, image_size=32, z_dim=32)
    ds = types.SimpleNamespace(setup_input=data.setup_input)
    parsed, fitted = [], []
    parse = fw.parse_mask
    fw.parse_mask = lambda im: parsed.append(im) or parse(im)
    r.fit_instance = fitted.append
    r.run([ds])
    assert len(parsed) == len(fitted) == 2 and r.epoch == 2 and r.iter == 2
    for i, batch in enumerate(fitted):
        np.testing.assert_array_equal(parsed[i], data.setup_input(i)["input_im"])
        m = batch["input_mask"]
        assert torch.is_tensor(m) and m.shape == (1, 32, 32, 1) and m.dtype == torch.float32
    own = dict(data.setup_input(0), input_mask=np.ones((1, 32, 32, 1), np.float32))
    r.run([types.SimpleNamespace(setup_input=lambda i: own)], max_epochs=3)
    assert len(parsed) == 2 and fitted[-1]["input_mask"] is own["input_mask"]
    with pytest.raises(ValueError, match="max_epochs"):
        TR.Gan2ShapeRunner(fw).run([ds])
