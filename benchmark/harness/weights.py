"""Seeded weights: one draw on the device, in a few large calls, laid out
by the reference's weight tree (names, shapes, kinds).  The same seed on the
same device gives the same weights, for the program and for the reference.

Kinds: ``w`` is a lecun-normal kernel (std sqrt(1 / fan_in), cut at two
standard deviations, as flax's default, rescaled by flax's 0.8796 so the cut
keeps the variance), ``zero`` a bias, ``one`` a norm's scale."""
from __future__ import annotations

import math
from typing import Dict

import torch

_TRUNC_STD = 0.87962566103423978


def leaf_kinds(tree: torch.nn.Module) -> Dict[str, tuple]:
    """name -> (kind, fan_in) for every parameter of a reference tree."""
    out = {}
    for mname, m in tree.named_modules():
        for pname, kf in getattr(m, "kinds", {}).items():
            out[f"{mname}.{pname}" if mname else pname] = kf
    return out


def draw(tree: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device`` for every parameter of ``tree``."""
    kinds = leaf_kinds(tree)
    shapes = {n: p.shape for n, p in tree.named_parameters()}
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device).clamp_(-2.0, 2.0)
    out, off = {}, 0
    for n, size in zip(names, sizes):
        kind, fan_in = kinds[n]
        v = flat[off:off + size].view(shapes[n])
        off += size
        if kind == "w":
            out[n] = v * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)
        elif kind == "zero":
            out[n] = torch.zeros_like(v)
        else:
            out[n] = torch.ones_like(v)
    return out


@torch.no_grad()
def load(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``module`` by name; every name on both sides."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        missing = sorted(set(params) ^ set(weights))[:8]
        raise ValueError(f"weight names differ from the module's: {missing}")
    for n, p in params.items():
        p.copy_(weights[n].to(p.dtype))
