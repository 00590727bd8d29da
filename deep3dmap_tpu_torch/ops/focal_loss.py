"""Sigmoid and softmax focal losses (port of
``deep3dmap_tpu/ops/focal_loss.py``).

Elementwise math on the logits' device; the gradients come from autograd.
Tensors stay on their device; numpy inputs go to ``resolve_device(device)``:
the card unless the caller passes ``device="cpu"``.

TRAP: the one-hot of a class id outside ``[0, C)`` is a row of zeros, as
``jax.nn.one_hot`` gives it (mmdetection's background label is ``C``);
``F.one_hot`` raises there instead.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._sampling import exact_div
from .bbox import _tensor


def _reduce(loss, weight, reduction, avg_factor=None):
    if weight is not None:
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if avg_factor is not None:
        return exact_div(loss.sum(), avg_factor)
    return loss.mean()


def sigmoid_focal_loss(pred, target, gamma: float = 2.0, alpha: float = 0.25,
                       weight=None, reduction: str = "mean", avg_factor=None,
                       device=None):
    """pred (N, C) logits, target (N,) class ids ->
    ``alpha_t * (1 - p_t)^gamma * BCE`` per class-vs-rest sigmoid."""
    pred = _tensor(pred, device)
    target = _tensor(target, dtype=torch.int64, like=pred)
    C = pred.shape[-1]
    t = (target[:, None] == torch.arange(C, device=pred.device)).to(pred.dtype)
    p = torch.sigmoid(pred)
    pt = p * t + (1.0 - p) * (1.0 - t)
    alpha_t = alpha * t + (1.0 - alpha) * (1.0 - t)
    # numerically stable BCE with logits
    bce = torch.clamp(pred, min=0) - pred * t + torch.log1p(torch.exp(-torch.abs(pred)))
    loss = alpha_t * ((1.0 - pt) ** gamma) * bce
    if weight is not None:
        weight = _tensor(weight, like=pred)
        if weight.ndim == 1:
            weight = weight[:, None]
    return _reduce(loss, weight, reduction, avg_factor)


def softmax_focal_loss(pred, target, gamma: float = 2.0, alpha: float = 0.25,
                       weight=None, reduction: str = "mean", avg_factor=None,
                       device=None):
    """``-alpha * (1 - p_target)^gamma * log(p_target)`` per row."""
    pred = _tensor(pred, device)
    target = _tensor(target, dtype=torch.int64, like=pred)
    logpt = F.log_softmax(pred, dim=-1).gather(-1, target[:, None])[:, 0]
    pt = torch.exp(logpt)
    loss = -alpha * ((1.0 - pt) ** gamma) * logpt
    if weight is not None:
        weight = _tensor(weight, like=pred)
    return _reduce(loss, weight, reduction, avg_factor)
