"""Shared pieces of the GNeRF parity tests (tests/test_torch_gnerf*.py).

``jax_draws`` reproduces the random numbers the JAX ``GanNerf.loss_fn``
draws from its key for one optimize sequence (its eight-way split, the
samplers', the renderer's four-way split, the discriminator's gate and
DiffAugment's keys, ``deep3dmap_tpu/models/frameworks/gnerf.py:189``), in
the layout ``deep3dmap_tpu_torch``'s ``GanNerf.draws`` gives, so the port
can be fed JAX's own draws.
"""
import numpy as np

import jax
import jax.numpy as jnp
import torch

from deep3dmap_tpu_torch.utils.from_flax import load_flax_params

SMALL_CFG = dict(img_wh=(32, 32), patch_size=16, inv_size=16, pose_mode="6d",
                 fc_depth=2, fc_dim=32, N_samples=8, N_importance=8, ndf=16,
                 inv_depth=2, n_train_images=4, n_val_images=2)
SEQS = ["generator_trainstep", "discriminator_trainstep", "inversion_net_trainstep",
        "training_pose_regularization", "val_pose_regularization",
        "training_refine_step", "val_refine_step"]


def _u(key, shape):
    return np.asarray(jax.random.uniform(key, shape))


def _patch(key, B):
    r1, r2, r3 = jax.random.split(key, 3)
    return {"scale": _u(r1, (B, 1, 1, 1)), "h_off": _u(r2, (B, 1, 1, 1)),
            "w_off": _u(r3, (B, 1, 1, 1))}


def _render(key, n_rays, S, K):
    r_pdf, r_noise_c, r_noise_f, r_perturb = jax.random.split(key, 4)
    return {"perturb": _u(r_perturb, (n_rays, S)),
            "noise_c": np.asarray(jax.random.normal(r_noise_c, (n_rays, S))),
            "pdf_u": _u(r_pdf, (n_rays, K)),
            "noise_f": np.asarray(jax.random.normal(r_noise_f, (n_rays, S + K)))}


def _disc(key, shape):
    B, H, W, _ = shape
    r_gate, rng = jax.random.split(key)
    out = {"gate": _u(r_gate, ())}
    names = ["brightness", "saturation", "contrast", "translation", "cutout"]
    for name in names:
        rng, sub = jax.random.split(rng)
        if name in ("brightness", "saturation", "contrast"):
            out[name] = _u(sub, (B, 1, 1, 1))
        elif name == "translation":
            sh, sw = int(H * 0.125 + 0.5), int(W * 0.125 + 0.5)
            r1, r2 = jax.random.split(sub)
            out["ty"] = np.asarray(jax.random.randint(r1, (B, 1, 1), -sh, sh + 1))
            out["tx"] = np.asarray(jax.random.randint(r2, (B, 1, 1), -sw, sw + 1))
        else:
            ch, cw = int(H * 0.5 + 0.5), int(W * 0.5 + 0.5)
            r1, r2 = jax.random.split(sub)
            out["oy"] = np.asarray(jax.random.randint(r1, (B, 1, 1), 0, H + (1 - ch % 2)))
            out["ox"] = np.asarray(jax.random.randint(r2, (B, 1, 1), 0, W + (1 - cw % 2)))
    return out


def jax_draws(jfw, key, opt_seq, B):
    """JAX's draws of ``jfw.loss_fn(..., key, opt_seq=opt_seq)`` at batch
    ``B`` (the default policy and a look-at-origin ray sampler)."""
    rngs = jax.random.split(key, 8)
    S, K = jfw.generator.n_samples, jfw.generator.n_importance
    P, inv = jfw.patch_size, jfw.inv_size
    out = {}
    if opt_seq in ("generator_trainstep", "discriminator_trainstep"):
        out["patch"] = _patch(rngs[0], B)
        out["poses"] = {"raes": _u(jax.random.split(rngs[1])[0], (B, 3))}
        out["render"] = _render(rngs[2], B * P * P, S, K)
        n = 1 if opt_seq == "generator_trainstep" else 2
        out["disc"] = [_disc(rngs[3 + i], (B, P, P, 3)) for i in range(n)]
    elif opt_seq == "inversion_net_trainstep":
        out["poses"] = {"raes": _u(jax.random.split(rngs[1])[0], (B, 3))}
        out["render"] = _render(rngs[2], B * inv * inv, S, K)
    elif opt_seq in ("training_refine_step", "val_refine_step"):
        out["patch"] = _patch(rngs[0], B)
        out["render"] = _render(rngs[2], B * P * P, S, K)
    return out


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def torch_state(mstate):
    """A JAX ``GanNerf`` model state as the port's (CPU tensors)."""
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), dict(mstate))


def port_from_jax(tfw, jparams, jmstate, batch):
    """The port's net and model state holding JAX's init."""
    net, _ = tfw.init(0, batch)
    load_flax_params(net, np_tree(jparams))
    return net, torch_state(jmstate)


def jax_batch(jfw, ds, n=2):
    from deep3dmap_tpu.datasets.builder import NumpyLoader
    return next(iter(NumpyLoader(ds, batch_size=n, shuffle=False)))


class SharedSamples:
    """Feeds the port's importance samples to JAX: ``record`` wraps the
    port's ``sample_pdf`` (as ``modulars/gnerf.py`` calls it) to keep each
    call's samples, ``replay`` makes JAX's renderer take them in call order.
    ``sample_pdf`` is discontinuous where a bin's cdf step is eps (its
    ``denom < eps`` branch) and at the top edge u = 1, so an ulp of
    summation order moves a sample by up to a bin; with the samples shared
    the rest of the step is continuous and agrees to float32 rounding."""

    def __init__(self, monkeypatch):
        self.mp, self.z, self.i = monkeypatch, [], 0

    def record(self):
        import deep3dmap_tpu_torch.models.modulars.gnerf as tg
        orig = tg.sample_pdf

        def rec(*a, **kw):
            z = orig(*a, **kw)
            self.z.append(z.detach().cpu().numpy())
            return z
        self.mp.setattr(tg, "sample_pdf", rec)
        return self

    def replay(self):
        import deep3dmap_tpu.models.modulars.gnerf as jg

        def rep(*a, **kw):
            z = jnp.asarray(self.z[self.i])
            self.i += 1
            return z
        self.mp.setattr(jg, "sample_pdf", rep)
        return self


def rel(want, got, floor=1e-12):
    """||got - want|| / ||want|| in float64 (``floor`` for a zero want)."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), floor))


def leaf_errors(jax_tree, torch_module, values="grad"):
    """Per-leaf ``rel`` of the port's gradients (``to_flax_grads``) or
    parameters against a JAX tree of the same layout.  A leaf whose norm is
    below 1e-2 of the largest leaf's is measured against that 1e-2 (the
    attention's key bias, whose gradient is zero up to rounding: softmax
    ignores a shift of the logits)."""
    from deep3dmap_tpu_torch.utils.from_flax import to_flax_grads, to_flax_params

    got = jax.tree_util.tree_leaves(
        (to_flax_grads if values == "grad" else to_flax_params)(torch_module))
    want = jax.tree_util.tree_leaves_with_path(np_tree(jax_tree))
    assert len(want) == len(got)
    floor = 1e-2 * max(np.linalg.norm(np.asarray(a, np.float64)) for _, a in want)
    return {jax.tree_util.keystr(p): rel(a, b, floor) for (p, a), b in zip(want, got)}
