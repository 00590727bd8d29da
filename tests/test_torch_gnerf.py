"""``GanNerf`` in the port against the JAX framework, on the CPU: every
optimize sequence's loss, logs, new model state and the gradients of the
collections it optimizes against ``jax.value_and_grad``, with JAX's draws
fed in, at ``tests/test_gnerf.py``'s small config (32², patch 16, a 2x32
MLP, 8 + 8 samples, ndf 16, inv_depth 2, B 2); ``forward_test``; the
draws' layout.

The JAX side runs op by op (not jitted): under ``jax.jit`` XLA fuses the
positional encoding's inputs (sin(2^9 x) of ``o + d * z``) with other
roundings, which moves the first layer's kernel gradient of the generator
step by 7e-3 between JAX's own eager and jitted runs.

Tolerances.  With the importance samples shared (``SharedSamples``) the
step is continuous and agrees to float32 rounding amplified by the
encoding: losses 1e-5 relative, logs 1e-4 (``d_fake`` is a mean of logits
near 0), gradients 1e-4 per leaf (measured at most 5e-5).  Unshared, each side draws its own importance
samples from the same u: ``sample_pdf`` jumps at its ``denom < eps``
branch (a bin whose cdf step is eps, about 1e-5, against rounding of 1e-7)
and at u = 1, so a few rays move a fine sample by up to a bin; the losses,
means over 512 rays, then agree to 1e-3 relative (measured 5e-5).
"""
import numpy as np
import pytest

import jax
import torch

from deep3dmap_tpu.datasets.nerf_synthetic import SyntheticNerfDataset as JDataset
from deep3dmap_tpu.models.frameworks.gnerf import GanNerf as JGanNerf
import deep3dmap_tpu_torch.models.frameworks.gnerf as TG
from deep3dmap_tpu_torch.models.frameworks.gnerf import GanNerf
from gnerf_helpers import (SEQS, SMALL_CFG, SharedSamples, jax_batch, jax_draws, leaf_errors,
                           np_tree, port_from_jax, rel)

torch.set_num_threads(2)
STEP_RTOL = 1e-5
LOG_RTOL = 1e-4
GRAD_RTOL = 1e-4
UNSHARED_RTOL = 1e-3


@pytest.fixture(scope="module")
def setup():
    jfw = JGanNerf(SMALL_CFG)
    ds = JDataset(n_images=4, img_wh=(32, 32))
    vds = JDataset(n_images=2, img_wh=(32, 32), split="val")
    jfw.set_info_from_datasets([ds, vds])
    tfw = GanNerf(SMALL_CFG, device="cpu")
    tfw.set_info_from_datasets([ds, vds])
    batch = jax_batch(jfw, ds)
    params, mstate = jax.jit(lambda k: jfw.init(k, batch))(jax.random.PRNGKey(0))
    net, tstate = port_from_jax(tfw, params, mstate, batch)
    return dict(jfw=jfw, tfw=tfw, batch=batch, params=params, mstate=mstate, net=net,
                tstate=tstate, key=jax.random.PRNGKey(2))


def _jax_step(s, seq):
    jfw, mstate, batch, key = s["jfw"], s["mstate"], s["batch"], s["key"]
    return jax.value_and_grad(
        lambda p: jfw.loss_fn(p, mstate, batch, key, state="A", opt_seq=seq), has_aux=True
    )(s["params"])


def _port_step(s, seq, draws):
    net = s["net"]
    net.zero_grad(set_to_none=True)
    loss, aux = s["tfw"].loss_fn(net, s["tstate"], s["batch"], state="A", opt_seq=seq,
                                 draws=draws)
    loss.backward()
    return loss.detach(), aux


@pytest.mark.parametrize("seq", SEQS)
def test_loss_fn_matches_jax(setup, seq, monkeypatch):
    s = setup
    draws = jax_draws(s["jfw"], s["key"], seq, 2)
    shared = SharedSamples(monkeypatch).record()
    loss, aux = _port_step(s, seq, draws)
    shared.replay()
    (jloss, jaux), jgrads = _jax_step(s, seq)
    assert rel(jloss, loss) < STEP_RTOL
    assert set(aux["log_vars"]) == set(jaux["log_vars"])
    for k, v in jaux["log_vars"].items():
        assert rel(v, aux["log_vars"][k].detach()) < LOG_RTOL, k
    jst, tst = jaux["model_state"], aux["model_state"]
    assert int(tst["it"]) == int(jst["it"]) == (1 if seq == "generator_trainstep" else 0)
    for (p, a), b in zip(jax.tree_util.tree_leaves_with_path(np_tree(jst["disc_stats"])),
                         jax.tree_util.tree_leaves(tst["disc_stats"])):
        assert rel(a, b) < LOG_RTOL, jax.tree_util.keystr(p)
    for name in s["tfw"].optseq2netnames(seq):
        errs = leaf_errors(jgrads[name], getattr(s["net"], name))
        assert max(errs.values()) < GRAD_RTOL, (name, errs)


@pytest.mark.parametrize("seq", SEQS)
def test_loss_fn_unshared_samples(setup, seq):
    s = setup
    loss, aux = _port_step(s, seq, jax_draws(s["jfw"], s["key"], seq, 2))
    (jloss, _), _ = _jax_step(s, seq)
    assert rel(jloss, loss) < UNSHARED_RTOL
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("seq", SEQS)
def test_draws_layout_matches_jax(setup, seq):
    s = setup
    want = jax_draws(s["jfw"], s["key"], seq, 2)
    got = s["tfw"].draws(torch.Generator().manual_seed(0), seq, 2)
    shape = lambda t: jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), t)  # noqa: E731
    assert shape(want) == shape({k: jax.tree_util.tree_map(np.asarray, v)
                                 for k, v in got.items()})
    assert s["tfw"].optseq2netnames(seq) == s["jfw"].optseq2netnames(seq)


def test_optimize_sequences_and_state(setup):
    s = setup
    for state in ("A", "ABAB", "B"):
        assert s["tfw"].setup_optimize_sequences(state) == \
            s["jfw"].setup_optimize_sequences(state)
    with pytest.raises(AssertionError):
        s["tfw"].setup_optimize_sequences("C")
    assert sorted(n for n, _ in s["net"].named_children()) == sorted(s["params"])
    it = torch.tensor(2500, dtype=torch.int32)
    assert float(s["tfw"]._noise_std(it)) == float(s["jfw"]._noise_std(np.int32(2500)))
    net, mstate = GanNerf(SMALL_CFG, device="cpu").init(0, s["batch"])
    assert mstate["it"].dtype == torch.int32 and int(mstate["it"]) == 0
    assert jax.tree_util.tree_structure(np_tree(s["mstate"]["disc_stats"])) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, mstate["disc_stats"]))


def test_forward_test(setup, monkeypatch):
    """Against JAX's ``forward_test`` (samples shared) and chunked against
    one batch: the render is per ray with no jitter or noise, so chunks of
    100 rays give the one batch's numbers bit for bit.  ``val_idx`` 0-3
    against 2 val poses: the clamped gather."""
    s = setup
    batch = dict(s["batch"], val_idx=np.arange(4))
    shared = SharedSamples(monkeypatch).record()
    out, _ = s["tfw"].forward_test(s["net"], s["tstate"], batch)
    shared.replay()
    jout, _ = s["jfw"].forward_test(s["params"], s["mstate"], batch)
    assert out["rgb"].shape == (4, 32, 32, 3) and out["depth"].shape == (4, 32, 32)
    assert rel(jout["rgb"], out["rgb"]) < STEP_RTOL * 10
    assert rel(jout["depth"], out["depth"]) < STEP_RTOL * 10
    monkeypatch.setattr(TG, "RENDER_CHUNK", 100)
    chunked, _ = s["tfw"].forward_test(s["net"], s["tstate"], batch)
    monkeypatch.setattr(TG, "RENDER_CHUNK", 10 ** 7)
    whole, _ = s["tfw"].forward_test(s["net"], s["tstate"], batch)
    for k in ("rgb", "depth"):
        torch.testing.assert_close(chunked[k], whole[k], rtol=0, atol=0)
