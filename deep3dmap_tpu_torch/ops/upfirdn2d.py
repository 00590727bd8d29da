"""upfirdn2d and the fused bias + leaky ReLU: StyleGAN2's resampling ops.

Port of ``deep3dmap_tpu/ops/upfirdn2d.py``.  The JAX package writes them as
XLA ops (a dilated depthwise convolution), not as a Pallas kernel; here they
are plain PyTorch: zero insertion, ``F.pad`` and a depthwise ``F.conv2d``.

Layout NHWC at every function, as in the JAX package; the convolution runs
on the NCHW view of the channel-last tensor.

TRAPS kept from the JAX version:
- it *convolves* with the kernel (``jnp.flip`` before XLA's correlation),
  so a kernel that is not symmetric must be flipped for ``F.conv2d``;
- the upsample's zero insertion leaves ``up - 1`` trailing zeros on each
  axis (the reference op's ``H * up`` length), which JAX adds to ``pad1``.
Every pad the callers use is >= 0; a negative pad (a crop in the reference
op) raises rather than guessing its meaning.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def make_kernel(k: Sequence[float], device=None) -> torch.Tensor:
    """1-D taps -> their normalised outer product; a 2-D kernel normalised."""
    k = torch.as_tensor(k, dtype=torch.float32, device=device)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum()


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1,
              down: int = 1, pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """x (B, H, W, C); kernel (kh, kw).  Zero-insert upsample by ``up``, pad
    by ``pad`` = (before, after) on both spatial axes, convolve with
    ``kernel`` (depthwise), keep every ``down``-th sample."""
    pad0, pad1 = (int(p) for p in pad)
    if pad0 < 0 or pad1 < 0:
        raise ValueError(f"upfirdn2d: negative pad {pad} (a crop) is not "
                         "supported")
    B, H, W, C = x.shape
    if up > 1:
        z = x.new_zeros((B, H * up, W * up, C))
        z[:, ::up, ::up] = x
        x = z
    xc = F.pad(x.movedim(-1, 1), (pad0, pad1, pad0, pad1))
    k = torch.flip(kernel, (0, 1)).to(device=x.device, dtype=x.dtype)
    w = k[None, None].expand(C, 1, *k.shape)
    return F.conv2d(xc, w, stride=down, groups=C).movedim(1, -1)


def upsample2d(x: torch.Tensor, kernel: torch.Tensor, factor: int = 2):
    """StyleGAN2 upsample (the kernel scaled by factor², pads around)."""
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel * (factor ** 2), up=factor,
                     pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample2d(x: torch.Tensor, kernel: torch.Tensor, factor: int = 2):
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, down=factor, pad=((p + 1) // 2, p // 2))


def blur2d(x: torch.Tensor, kernel: torch.Tensor, pad: Tuple[int, int]):
    return upfirdn2d(x, kernel, pad=pad)


def fused_leaky_relu(x: torch.Tensor, bias=None, negative_slope: float = 0.2,
                     scale: float = 2 ** 0.5) -> torch.Tensor:
    """``leaky_relu(x + bias, 0.2) * sqrt(2)``, the bias on the last axis.
    Written as ``jax.nn.leaky_relu`` is (``x >= 0`` keeps x), so the
    gradient at 0 is 1 as in JAX, not torch's ``negative_slope``."""
    if bias is not None:
        x = x + bias.reshape((1,) * (x.ndim - 1) + (-1,))
    return torch.where(x >= 0, x, x * negative_slope) * scale
