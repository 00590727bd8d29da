"""Clip by global norm (optax's rule: scale by max_norm / norm only when
norm >= max_norm) and Adam with bias correction, in plain PyTorch."""
from __future__ import annotations

from typing import Dict, List

import torch


class ClipAdam:
    def __init__(self, params: List[torch.Tensor], lr: float, max_norm: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = params
        self.lr, self.max_norm, self.eps = lr, max_norm, eps
        self.b1, self.b2 = betas
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """One update from raw gradients; returns the clipped gradients."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        scale = torch.where(norm >= self.max_norm, self.max_norm / norm,
                            torch.ones_like(norm))
        clipped = [g * scale for g in grads]
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, clipped, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))
        return clipped


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}
