"""Perceptual (LPIPS-style) loss on VGG features.

Port of ``deep3dmap_tpu/models/losses/perceptual_loss.py``: ``_VGGFeatures``
(13 SAME 3x3 convs with bias and ReLU in five stages of 2, 2, 3, 3, 3, a
2x2 VALID max-pool after each of the first four, the five stage outputs as
features) and ``PerceptualLoss`` (unit-normalised features, squared
distance summed over channels and averaged over space, summed over stages).
Weights come from the JAX ``PerceptualLoss.params`` tree (``Conv_0`` ..
``Conv_12`` at the top) through ``load_flax``, or from a seeded flax-default
init.  ``DiscriminatorLoss`` (Gan2Shape's step 2): the mean L1 between the
first ``ftr_num`` discriminator feature maps of the masked prediction and
the masked, detached target.
"""
from __future__ import annotations

from typing import Callable, List, Mapping, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...utils.device import DeviceLike, resolve_device
from ...utils.from_flax import load_flax_params
from ..layers import Conv, init_flax_defaults

_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class _VGGFeatures(nn.Module):
    """VGG16-ish trunk emitting 5 feature stages (NHWC)."""

    def __init__(self, cin: int = 3):
        super().__init__()
        n, c = 0, cin
        for ch, reps in _STAGES:
            for _ in range(reps):
                setattr(self, f"Conv_{n}", Conv(c, ch, (3, 3)))
                c, n = ch, n + 1

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats, n = [], 0
        for i, (_, reps) in enumerate(_STAGES):
            for _ in range(reps):
                x = F.relu(getattr(self, f"Conv_{n}")(x))
                n += 1
            feats.append(x)
            if i < 4:
                x = F.max_pool2d(x.movedim(-1, 1), 2, 2).movedim(1, -1)
        return feats


class PerceptualLoss:
    """Callable: ``loss(pred, target)`` -> (B,) distances.  ``net`` holds
    the VGG weights on ``device`` (``None``: the GPU, raising without one;
    ``"cpu"`` by name)."""

    def __init__(self, seed: int = 0, device: DeviceLike = None):
        dev = resolve_device(device)
        self.net = _VGGFeatures().eval()
        init_flax_defaults(self.net, torch.Generator().manual_seed(int(seed)))
        self.net.to(dev)

    def load_flax(self, flax_params: Mapping) -> None:
        """Load a JAX ``PerceptualLoss.params`` tree (nested numpy arrays)."""
        dev = next(self.net.parameters()).device
        load_flax_params(self.net.cpu(), flax_params)
        self.net.to(dev)

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """pred/target (B, H, W, 3) in [-1, 1].  Returns (B,) distances."""
        f_p = self.net(pred)
        f_t = self.net(target.detach())
        total = 0.0
        for a, b in zip(f_p, f_t):
            a = a / (torch.linalg.norm(a, dim=-1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.norm(b, dim=-1, keepdim=True) + 1e-10)
            total = total + ((a - b) ** 2).sum(-1).mean(dim=(1, 2))
        return total


class DiscriminatorLoss:
    """Feature matching on discriminator activations: ``loss(features_fn,
    pred, target, mask=None)`` with ``features_fn`` image -> list of
    feature maps; the mean over the first ``ftr_num`` maps of each map's
    mean absolute difference.  No gradient reaches ``target``."""

    def __init__(self, ftr_num: int = 4):
        self.ftr_num = ftr_num

    def __call__(self, features_fn: Callable[[torch.Tensor], Sequence[torch.Tensor]],
                 pred: torch.Tensor, target: torch.Tensor, mask=None) -> torch.Tensor:
        if mask is not None:
            pred = pred * mask
            target = target * mask
        f_p = features_fn(pred)
        f_t = features_fn(target.detach())
        n = min(self.ftr_num, len(f_p))
        loss = 0.0
        for a, b in zip(f_p[:n], f_t[:n]):
            loss = loss + torch.abs(a - b).mean()
        return loss / max(n, 1)
