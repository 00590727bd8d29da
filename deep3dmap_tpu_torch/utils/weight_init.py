"""Config-driven weight initialisation (port of
``deep3dmap_tpu/utils/weight_init.py``): the ``init_cfg`` vocabulary
(Normal, TruncNormal, Uniform, Constant, Xavier, Kaiming) as flax's
initialisers, and ``apply_init_cfg``, which re-draws the leaves whose flax
path matches a config's ``layer_pattern``.

TRAP: these are flax's initialisers, not ``torch.nn.init``'s:

- ``truncnormal(std)`` cuts at +-2 std (``torch.nn.init.trunc_normal_``'s
  defaults cut at the absolute values -2 and 2);
- ``xavier`` normal and ``kaiming`` normal are ``variance_scaling`` with a
  normal truncated at +-2 and corrected by 0.8796 (its std after the cut);
  ``kaiming`` is ``variance_scaling(2, "fan_in")``, ``xavier``
  ``variance_scaling(1, "fan_avg")``;
- the fans come from flax's kernel layout: a conv kernel ``(kh, kw, in,
  out)`` has ``fan_in = kh * kw * in``, a dense kernel ``(in, out)``
  ``fan_in = in``, whatever the torch layout ``(out, in, kh, kw)``.  A leaf
  of rank < 2 has no fans and raises, as in flax.

The leaves are named and shaped by ``utils/from_flax.py``: a module's
parameter ``a.Conv_0.weight`` is the flax leaf ``a/Conv_0/kernel``.  The
draws come from an explicit ``torch.Generator``; they cannot be JAX's bits,
only its distributions.
"""
from __future__ import annotations

import math
import re
from typing import Callable, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

_TRUNC_STD = 0.87962566103423978      # std of a unit normal cut at +-2

Init = Callable[[torch.Generator, tuple, torch.dtype], torch.Tensor]


def _fans(shape):
    """flax's ``_compute_fans`` for a kernel in flax's layout."""
    if len(shape) < 2:
        raise ValueError(f"cannot compute fans of a rank-{len(shape)} leaf {tuple(shape)}")
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def _truncated(gen, shape, dtype, std):
    out = torch.empty(shape, dtype=dtype)
    return nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def _variance_scaling(scale: float, mode: str, distribution: str) -> Init:
    def init(gen, shape, dtype=torch.float32):
        fan_in, fan_out = _fans(shape)
        fan = {"fan_in": fan_in, "fan_out": fan_out, "fan_avg": (fan_in + fan_out) / 2}[mode]
        variance = scale / fan
        if distribution == "uniform":
            lim = math.sqrt(3.0 * variance)
            return torch.rand(shape, generator=gen, dtype=dtype) * (2 * lim) - lim
        return _truncated(gen, shape, dtype, math.sqrt(variance) / _TRUNC_STD)
    return init


def build_initializer(cfg: dict) -> Init:
    """``init(gen, shape, dtype)`` for a config ``dict(type=..., ...)``;
    ``shape`` is the leaf's flax shape."""
    cfg = dict(cfg)
    t = cfg.pop("type").lower()
    if t == "normal":
        std = cfg.get("std", 0.01)
        return lambda gen, shape, dtype=torch.float32: torch.randn(
            shape, generator=gen, dtype=dtype) * std
    if t == "truncnormal":
        std = cfg.get("std", 0.01)
        return lambda gen, shape, dtype=torch.float32: _truncated(gen, shape, dtype, std)
    if t == "uniform":
        a, b = cfg.get("a", 0.0), cfg.get("b", 1.0)
        return lambda gen, shape, dtype=torch.float32: torch.rand(
            shape, generator=gen, dtype=dtype) * (b - a) + a
    if t == "constant":
        val = cfg.get("val", 0.0)
        return lambda gen, shape, dtype=torch.float32: torch.full(shape, float(val),
                                                                  dtype=dtype)
    if t == "xavier":
        dist = cfg.get("distribution", "uniform")
        return _variance_scaling(1.0, "fan_avg",
                                 "uniform" if dist == "uniform" else "truncated_normal")
    if t == "kaiming":
        dist = cfg.get("distribution", "normal")
        return _variance_scaling(2.0, "fan_in",
                                 "truncated_normal" if dist == "normal" else "uniform")
    raise ValueError(f"unknown init type {t}")


def _flat(tree: Mapping, prefix=()) -> Dict[tuple, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def apply_init_cfg(target, init_cfg, gen: torch.Generator):
    """Re-draw the leaves of ``target`` whose flax path (``"/"``-joined)
    matches a config's ``layer_pattern`` regex (every leaf when it has
    none); a leaf matched by several configs takes the last.

    ``target`` is an ``nn.Module`` (its parameters are overwritten in place
    and it is returned) or a flax-layout tree of tensors or arrays (nested
    dicts, as ``utils/from_flax.py::to_flax_params`` gives; a new tree of
    tensors is returned)."""
    cfgs = list(init_cfg) if isinstance(init_cfg, (list, tuple)) else [init_cfg]
    if isinstance(target, nn.Module):
        from .from_flax import _TO_FLAX, _TO_TORCH, _leaf_map

        params = dict(target.named_parameters())
        with torch.no_grad():
            for tname, (path, kind) in _leaf_map(target).items():
                p = params[tname]
                flax_shape = tuple(_TO_FLAX[kind](p.detach().cpu().numpy()).shape
                                   if kind in _TO_FLAX else p.shape)
                new = _draw("/".join(path), flax_shape, p.dtype, cfgs, gen)
                if new is not None:
                    if kind in _TO_TORCH:
                        new = torch.from_numpy(_TO_TORCH[kind](new.numpy()).copy())
                    p.copy_(new)
        return target
    tree = {}
    for path, leaf in _flat(target).items():
        leaf = leaf if isinstance(leaf, torch.Tensor) else torch.tensor(np.asarray(leaf))
        new = _draw("/".join(path), tuple(leaf.shape), leaf.dtype, cfgs, gen)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf.clone() if new is None else new.to(leaf.device)
    return tree


def _draw(path: str, shape: tuple, dtype, cfgs, gen):
    out = None
    for cfg in cfgs:
        if re.search(cfg.get("layer_pattern", ".*"), path):
            init = build_initializer({k: v for k, v in cfg.items() if k != "layer_pattern"})
            out = init(gen, shape, dtype)
    return out
