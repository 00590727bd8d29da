"""Elementwise regression losses (port of
``deep3dmap_tpu/models/losses/basic.py``): the functions and the classes
registered in ``LOSSES``.

``group`` (a framework's ``loss_group``, its data-parallel ranks, each
holding its shard of the batch) makes a ``"mean"`` the global batch's on
every rank (``parallel/collectives.py::global_mean``); None is one rank."""
from __future__ import annotations

from typing import Optional

import torch

from ...parallel.collectives import global_mean
from ..builder import LOSSES


def reduce_loss(loss, reduction: str = "mean", avg_factor: Optional[float] = None,
                group=None):
    """``avg_factor`` is the shard's; with a ``group`` it is summed over the
    ranks with the loss."""
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        if avg_factor is not None:
            if group is None:
                return loss.sum() / max(avg_factor, 1e-12)
            return global_mean(loss, group, torch.as_tensor(avg_factor, device=loss.device),
                               1e-12)
        return global_mean(loss, group)
    raise ValueError(f"unknown reduction {reduction}")


def l1_loss(pred, target, weight=None, reduction="mean", avg_factor=None, group=None):
    loss = torch.abs(pred - target)
    if weight is not None:
        loss = loss * weight
    return reduce_loss(loss, reduction, avg_factor, group)


def smooth_l1_loss(pred, target, weight=None, beta: float = 1.0,
                   reduction="mean", avg_factor=None, group=None):
    diff = torch.abs(pred - target)
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    if weight is not None:
        loss = loss * weight
    return reduce_loss(loss, reduction, avg_factor, group)


def mask_l1_loss(pred, target, mask, reduction="mean", group=None):
    """L1 weighted per pixel by ``mask`` (PRNet's UV loss), normalised by the
    mask's mass over the loss's shape."""
    loss = torch.abs(pred - target) * mask
    if reduction == "mean":
        return global_mean(loss, group, mask.expand(loss.shape).sum(), 1e-12)
    return reduce_loss(loss, reduction)


@LOSSES.register_module()
class L1Loss:
    def __init__(self, reduction="mean", loss_weight=1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        return self.loss_weight * l1_loss(pred, target, weight, self.reduction, avg_factor)


@LOSSES.register_module()
class SmoothL1Loss:
    def __init__(self, beta=1.0, reduction="mean", loss_weight=1.0):
        self.beta = beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        return self.loss_weight * smooth_l1_loss(pred, target, weight, self.beta,
                                                 self.reduction, avg_factor)


@LOSSES.register_module()
class MaskL1Loss:
    def __init__(self, mask=None, loss_weight=1.0):
        self.mask = mask
        self.loss_weight = loss_weight

    def __call__(self, pred, target, mask=None):
        m = mask if mask is not None else self.mask
        return self.loss_weight * mask_l1_loss(pred, target, m)
