"""Mixed precision (port of ``deep3dmap_tpu/runners/amp.py``): bfloat16
compute over float32 master weights.

``amp_loss`` wraps ``loss_fn(params, *args)``, where ``params`` and ``args``
are trees (dicts, lists, tuples) of tensors: the floating leaves are cast
to ``compute_dtype`` inside the wrapped function, so autograd carries the
gradients back through the casts to the float32 masters; the loss comes
out in float32, times ``loss_scale`` when one is given.  bfloat16 has
float32's exponent range, so no loss scale is needed by default;
``unscale_grads`` and ``grads_finite`` serve float16 experiments.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def cast_floating(tree, dtype):
    """The tree with its floating tensors cast to ``dtype`` (differentiably);
    integer and bool tensors and non-tensors pass through."""
    return _tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                     and x.is_floating_point() else x, tree)


def amp_loss(loss_fn: Callable, compute_dtype=torch.bfloat16,
             loss_scale: Optional[float] = None) -> Callable:
    """``loss_fn`` with its forward in ``compute_dtype``; the loss (or the
    ``(loss, aux)`` pair's loss) in float32, scaled by ``loss_scale``."""

    @functools.wraps(loss_fn)
    def wrapped(params, *args, **kwargs):
        out = loss_fn(cast_floating(params, compute_dtype),
                      *cast_floating(args, compute_dtype), **kwargs)
        if isinstance(out, tuple):
            loss, aux = out
            loss = loss.float()
            return (loss * loss_scale if loss_scale else loss), aux
        loss = out.float()
        return loss * loss_scale if loss_scale else loss

    return wrapped


def unscale_grads(grads, loss_scale: Optional[float]):
    """Undo ``loss_scale`` on a tree of gradients."""
    if not loss_scale:
        return grads
    inv = 1.0 / loss_scale
    return _tree_map(lambda g: g * inv if isinstance(g, torch.Tensor) else g, grads)


def grads_finite(grads) -> torch.Tensor:
    """A 0-d bool tensor on the gradients' device: every element finite.
    Nothing is read to the host."""
    leaves = _leaves(grads)
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(g).all() for g in leaves]).all()
