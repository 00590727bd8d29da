"""``jax.image.resize`` on channel-last tensors, for Gan2Shape, the parsing
nets and LERF (its crops, CLIP's and DINO's position embeddings).

- ``"bilinear"``: one weight matrix per axis that changes size, applied by
  ``matmul``, as ``jax.image.scale_and_translate`` computes it: samples at
  half-pixel centres, the triangle kernel widened by the scale when it
  shrinks (antialiasing), columns normalised, samples outside dropped.
  ``F.interpolate`` neither antialiases nor matches JAX's sampling.
- ``"bicubic"``: the same weights with Keys' cubic kernel at a = -0.5
  (JAX's ``"cubic"``); ``F.interpolate``'s bicubic uses a = -0.75, no
  antialiasing and other edge weights.
- ``"nearest"``: JAX's sample positions, ``floor((i + 0.5) * n_in / n_out)``
  in float32.  That is torch's ``nearest-exact``, not ``nearest``; the two
  agree at an exact 2x factor only.

An axis whose size does not change is left as it is, as JAX skips it.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

Size = Union[int, Sequence[int]]


def _hw(size: Size) -> Tuple[int, int]:
    return (size, size) if isinstance(size, int) else (int(size[0]), int(size[1]))


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x, min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel at a = -0.5, JAX's ``_fill_keys_cubic_kernel``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def resize_weights(n_in: int, n_out: int, device, method: str = "bilinear") -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize(..., method)`` on one
    axis, ``method`` ``"bilinear"`` or ``"bicubic"``."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(n_in, dtype=torch.float32,
                                                   device=device)[:, None]) / kernel_scale
    w = _KERNELS[method](x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize(x: torch.Tensor, size: Size, method: str) -> torch.Tensor:
    _, H, W, _ = x.shape
    h, w = _hw(size)
    if W != w:
        x = (x.transpose(2, 3) @ resize_weights(W, w, x.device, method)).transpose(2, 3)
    if H != h:
        x = (x.permute(0, 2, 3, 1) @ resize_weights(H, h, x.device, method)).permute(0, 3, 1, 2)
    return x


def resize_bilinear(x: torch.Tensor, size: Size) -> torch.Tensor:
    """``jax.image.resize(x, (B, H', W', C), "bilinear")`` for NHWC ``x``;
    ``size`` is ``H' = W'`` or ``(H', W')``."""
    return _resize(x, size, "bilinear")


def resize_bicubic(x: torch.Tensor, size: Size) -> torch.Tensor:
    """``jax.image.resize(x, (B, H', W', C), "bicubic")`` for NHWC ``x``."""
    return _resize(x, size, "bicubic")


def nearest_indices(n_in: int, n_out: int, device) -> torch.Tensor:
    """The source index of each output sample of JAX's ``"nearest"``."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * n_in / n_out
    return torch.floor(pos).long()


def resize_nearest(x: torch.Tensor, size: Size) -> torch.Tensor:
    """``jax.image.resize(x, (B, H', W', C), "nearest")`` for NHWC ``x``."""
    _, H, W, _ = x.shape
    h, w = _hw(size)
    if H != h:
        x = x[:, nearest_indices(H, h, x.device)]
    if W != w:
        x = x[:, :, nearest_indices(W, w, x.device)]
    return x
