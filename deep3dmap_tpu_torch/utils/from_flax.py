"""Carry flax params across: a JAX ``init`` param tree -> the port's modules.

The reverse of ``deep3dmap_tpu/utils/torch_import.py:50-57`` (which maps torch
state dicts into flax trees), kept as the port's own copy:

  flax Conv kernel  (*k, I, O)  -> torch weight (O, I, *k)
  (depthwise HWIO with I=1 is the same rule: (kh, kw, 1, mid) -> (mid, 1, kh, kw))
  flax Dense kernel (I, O)      -> torch Linear weight (O, I)
  flax ConvTranspose kernel (kh, kw, I, O) -> torch weight (I, O, kh, kw),
    flipped in both spatial axes (flax's ``transpose_kernel=False`` does not
    flip it; ``torch.conv_transpose2d`` does)
  GroupNorm / BlockGN scale     -> weight; every bias -> bias

The port names its submodules after flax's auto-names (``Conv_0``,
``GroupNorm_0``, ``BlockConvBlock3D_1``, ``unet2``, ``gru1.convzr``, ...), so
a torch parameter ``a.b.Conv_0.weight`` IS the flax leaf ``a/b/Conv_0/kernel``
and the conversion is a per-leaf transpose, not a rename table.  A leaf that
is unmatched or has the wrong shape, in either direction, raises.

A module whose flax twin holds raw ``self.param`` leaves instead of flax
layers (StyleGAN2's) declares them in a class attribute ``FLAX_LEAVES``:
torch parameter name -> (flax leaf name, kind), kind ``"kernel"`` for a conv
``(k, k, I, O)`` or dense ``(I, O)`` kernel stored in torch's layout and
``"plain"`` for a leaf stored as it is.  A parameter it does not declare is
stray and raises, as any parameter outside a flax-mirroring layer does.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..models.layers import Conv, ConvTranspose, Dense, GroupNorm


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _leaf_map(module: nn.Module):
    """torch param name -> (flax path, kind), kind in {"kernel",
    "kernel_t", "plain"}."""
    out = {}
    for mname, m in module.named_modules():
        if isinstance(m, (Conv, Dense)):
            names = {"weight": ("kernel", "kernel"), "bias": ("bias", "plain")}
        elif isinstance(m, ConvTranspose):
            names = {"weight": ("kernel", "kernel_t"), "bias": ("bias", "plain")}
        elif isinstance(m, GroupNorm):
            names = {"weight": ("scale", "plain"), "bias": ("bias", "plain")}
        elif hasattr(type(m), "FLAX_LEAVES"):
            names = type(m).FLAX_LEAVES
        else:
            continue
        base = tuple(mname.split(".")) if mname else ()
        for pname, p in m.named_parameters(recurse=False):
            if pname not in names:
                continue        # left stray: raises below
            flax_leaf, kind = names[pname]
            out[f"{mname}.{pname}" if mname else pname] = (base + (flax_leaf,), kind)
    own = {n for n, _ in module.named_parameters()}
    stray = own - set(out)
    if stray:
        raise ValueError(f"from_flax: torch params outside a flax-mirroring "
                         f"layer: {sorted(stray)}")
    return out


def _kernel_to_torch(k: np.ndarray) -> np.ndarray:
    n = k.ndim
    return np.transpose(k, (n - 1, n - 2) + tuple(range(n - 2)))


def _kernel_to_flax(w: np.ndarray) -> np.ndarray:
    n = w.ndim
    return np.transpose(w, tuple(range(2, n)) + (1, 0))


def _kernel_t_to_torch(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1]


def _kernel_t_to_flax(w: np.ndarray) -> np.ndarray:
    return np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1))


_TO_TORCH = {"kernel": _kernel_to_torch, "kernel_t": _kernel_t_to_torch}
_TO_FLAX = {"kernel": _kernel_to_flax, "kernel_t": _kernel_t_to_flax}


def _unwrap(flax_params: Mapping, module: nn.Module) -> Mapping:
    names = {n for n, _ in module.named_children()}
    if set(flax_params.keys()) == {"params"} and "params" not in names:
        return flax_params["params"]
    return flax_params


def load_flax_params(module: nn.Module, flax_params: Mapping) -> nn.Module:
    """Fill ``module``'s parameters from a flax param tree (nested dicts of
    arrays, optionally under a top-level ``"params"`` key).  Raises on any
    leaf missing on either side or with the wrong shape."""
    flat = _flatten(_unwrap(flax_params, module))
    leaf_map = _leaf_map(module)
    params = dict(module.named_parameters())
    wanted = {path for path, _ in leaf_map.values()}
    extra = sorted("/".join(p) for p in set(flat) - wanted)
    missing = sorted("/".join(p) for p in wanted - set(flat))
    if extra or missing:
        raise ValueError(f"from_flax: flax leaves with no torch param: {extra}; "
                         f"torch params with no flax leaf: {missing}")
    with torch.no_grad():
        for tname, (path, kind) in leaf_map.items():
            src = flat[path]
            if kind in _TO_TORCH:
                src = _TO_TORCH[kind](src)
            dst = params[tname]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"from_flax: {'/'.join(path)} has shape {tuple(src.shape)} "
                    f"after conversion, torch {tname} wants {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(src)).to(dst.dtype))
    return module


def _to_flax_tree(module: nn.Module,
                  values: Mapping[str, Optional[torch.Tensor]]) -> Dict:
    """Per-parameter tensors in torch layout (by parameter name; ``None``
    reads as zeros) -> a nested flax-layout dict of float32 numpy arrays."""
    params = dict(module.named_parameters())
    tree: Dict = {}
    for tname, (path, kind) in _leaf_map(module).items():
        v = values.get(tname)
        a = (np.zeros(tuple(params[tname].shape), np.float32) if v is None
             else v.detach().float().cpu().numpy())
        if kind in _TO_FLAX:
            a = np.ascontiguousarray(_TO_FLAX[kind](a))
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return tree


def to_flax_params(module: nn.Module) -> Dict:
    """The module's parameters as a nested flax-layout dict of numpy arrays
    (the inverse of ``load_flax_params``)."""
    return _to_flax_tree(module, dict(module.named_parameters()))


def to_flax_grads(module: nn.Module) -> Dict:
    """The parameters' ``.grad`` in flax layout; a parameter without one
    reads as zeros, as ``jax.grad`` gives for an unused leaf."""
    return _to_flax_tree(module, {n: p.grad for n, p in module.named_parameters()})


def to_flax_adam_state(module: nn.Module, adam: torch.optim.Adam) -> Dict:
    """``torch.optim.Adam``'s moments over ``module``'s parameters as optax's
    ``ScaleByAdamState`` fields: ``count`` (steps taken) and ``mu``/``nu``
    (first and second moments) in flax layout; zeros for a parameter the
    optimizer never stepped."""
    names = dict(module.named_parameters())
    state = {n: adam.state.get(p, {}) for n, p in names.items()}
    steps = {int(s["step"]) for s in state.values() if "step" in s}
    if len(steps) > 1:
        raise ValueError(f"to_flax_adam_state: parameters at different steps {steps}")
    return {"count": steps.pop() if steps else 0,
            "mu": _to_flax_tree(module, {n: s.get("exp_avg") for n, s in state.items()}),
            "nu": _to_flax_tree(module, {n: s.get("exp_avg_sq") for n, s in state.items()})}
