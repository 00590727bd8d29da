"""flax.linen layer semantics in PyTorch: ``Conv``, ``ConvTranspose``,
``Dense``, ``DenseGeneral``, ``GroupNorm``, ``LayerNorm``,
``MultiHeadDotProductAttention``, ``spectral_normalize`` (``SpectralNorm``)
and the tanh ``gelu``.

The JAX package builds every network from ``flax.linen`` layers.  These
modules reproduce their numerics, so weights carried over by
``utils/from_flax.py`` give the same outputs:

- tensors stay channel-last (NHWC / NDHWC) at every module boundary, as in
  the JAX package.  A conv permutes to NC(D)HW for the call; on a contiguous
  channel-last tensor that permute is a ``channels_last`` view, no copy;
- weights are stored in torch's layout (conv ``(O, I/groups, *k)``, dense
  ``(O, I)``, norm ``weight``/``bias``) and ``from_flax`` owns the transposes;
- ``dtype`` follows ``flax``'s ``promote_dtype``: with ``dtype=None`` the
  compute type is the promotion of the input and the (float32) params, with
  ``dtype`` set, input, kernel and bias are cast to it and so is the output;
- init mirrors flax's defaults: lecun-normal kernels (truncated normal,
  fan-in), zero biases, norm scale 1 and bias 0, drawn from an explicit
  ``torch.Generator`` by ``init_flax_defaults``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

# flax's truncated_normal stddev correction for truncation at +-2 sigma
_TRUNC_STD = 0.87962566103423978


def _same_pads(size: int, k: int, s: int, d: int = 1):
    """flax/XLA ``SAME`` padding of one spatial dim, for a kernel of ``k``
    taps ``d`` apart (the effective kernel is ``(k - 1) * d + 1`` wide).

    TRAP: at stride 2 it is asymmetric -- k=3 on an even side pads (0, 1),
    not torch's (1, 1); k=5 pads (1, 2).  The extra row goes on the high side.
    """
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _compute_dtype(x: torch.Tensor, w: torch.Tensor, dtype):
    return dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)


class Conv(nn.Module):
    """``flax.linen.Conv`` on channel-last input, 2-D or 3-D.

    ``padding`` is ``"SAME"``, ``"VALID"`` or an explicit per-dim list of
    (lo, hi) pairs; ``dilation`` is flax's ``kernel_dilation``.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int],
                 strides: Union[int, Sequence[int]] = 1, padding="SAME",
                 groups: int = 1, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 dilation: Union[int, Sequence[int]] = 1):
        super().__init__()
        self.kernel = tuple(kernel)
        nd = len(self.kernel)
        self.strides = ((strides,) * nd if isinstance(strides, int)
                        else tuple(strides))
        self.dilation = ((dilation,) * nd if isinstance(dilation, int)
                         else tuple(dilation))
        self.padding = padding
        self.groups = groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups,
                                               *self.kernel))
        self.bias = nn.Parameter(torch.empty(out_ch)) if use_bias else None

    def forward(self, x: torch.Tensor, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``weight`` replaces ``self.weight`` (a spectral-normalised one)."""
        nd = len(self.kernel)
        dt = _compute_dtype(x, self.weight, self.dtype)
        x = x.to(dt)
        w = (self.weight if weight is None else weight).to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        if self.padding == "VALID":
            pads = [(0, 0)] * nd
        elif self.padding == "SAME":
            pads = [_same_pads(x.shape[1 + i], self.kernel[i], self.strides[i],
                               self.dilation[i]) for i in range(nd)]
        else:
            pads = [tuple(p) for p in self.padding]
        conv_pad = 0
        if all(lo == hi for lo, hi in pads):
            conv_pad = tuple(lo for lo, _ in pads)
        else:
            # asymmetric pads: pad the channel-last tensor explicitly (the
            # F.pad spec runs from the last dim: channels, then spatial
            # dims innermost first)
            spec = [0, 0]
            for lo, hi in reversed(pads):
                spec += [lo, hi]
            x = F.pad(x, spec)
        xc = x.movedim(-1, 1)
        conv = F.conv3d if nd == 3 else F.conv2d
        y = conv(xc, w, None, stride=self.strides, padding=conv_pad,
                 dilation=self.dilation, groups=self.groups).movedim(1, -1)
        # flax rounds the conv output to ``dt`` and then adds the bias in
        # ``dt``; a bias fused into the conv rounds once, which in bf16 moves
        # outputs by an ulp
        return y if b is None else y + b


class ConvTranspose(nn.Module):
    """``flax.linen.ConvTranspose`` on channel-last 2-D input, as EDDeconv
    uses it: stride 1, ``padding="VALID"``, ``transpose_kernel=False``.

    TRAP: flax does not flip the kernel: on a 1x1 input a 4x4 kernel gives
    ``out[i, j] = K[3-i, 3-j] . x``.  ``torch.conv_transpose2d`` gives
    ``w[i, j] . x``, so ``weight`` (torch layout ``(I, O, kh, kw)``) is the
    flax kernel flipped in both spatial axes; ``from_flax`` owns the flip.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int]):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, *kernel))
        self.bias = nn.Parameter(torch.empty(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(x, self.weight, None)
        y = F.conv_transpose2d(x.to(dt).movedim(-1, 1),
                               self.weight.to(dt)).movedim(1, -1)
        return y + self.bias.to(dt)


class Dense(nn.Module):
    """``flax.linen.Dense`` on the last axis."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(x, self.weight, self.dtype)
        # product rounded to ``dt`` before the bias add, as in flax (``Conv``)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


def num_groups(channels: int, max_groups: int = 8) -> int:
    """Largest group count <= max_groups that divides ``channels``."""
    g = min(max_groups, channels)
    while channels % g:
        g -= 1
    return g


class GroupNorm(nn.Module):
    """``flax.linen.GroupNorm`` on channel-last input (batch axis 0).

    TRAP: flax's default epsilon is 1e-6, not torch's 1e-5, and it uses the
    fast variance E[x^2] - E[x]^2 clipped at 0.  Statistics run in at least
    float32; the output type is the promotion of the input and the float32
    params (so a bf16 conv output leaves the norm as float32).
    """

    def __init__(self, groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, C, G = x.shape[0], x.shape[-1], self.groups
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        xg = xf.reshape(N, -1, G, C // G)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        mean2 = (xg * xg).mean(dim=(1, 3), keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(G, C // G)
        y = (xg - mean) * mul + self.bias.reshape(G, C // G)
        return y.reshape(x.shape).to(torch.promote_types(x.dtype,
                                                         self.weight.dtype))


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` over the last axis.

    TRAP: flax's epsilon is 1e-6, not torch's 1e-5, and its variance is the
    fast E[x^2] - E[x]^2 clipped at 0, as ``GroupNorm``'s."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class DenseGeneral(nn.Module):
    """``flax.linen.DenseGeneral`` from the trailing ``in_shape`` axes to
    ``out_shape``.  ``kernel`` (*in_shape, *out_shape) and ``bias``
    (*out_shape) are stored in flax's layout (no torch layout exists for
    them) and carried across as they are."""

    FLAX_LEAVES = {"kernel": ("kernel", "plain"), "bias": ("bias", "plain")}

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int]):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.kernel = nn.Parameter(torch.empty(*self.in_shape, *self.out_shape))
        self.bias = nn.Parameter(torch.empty(*self.out_shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:x.dim() - len(self.in_shape)]
        k = self.kernel.reshape(math.prod(self.in_shape), -1)
        y = x.reshape(*lead, k.shape[0]) @ k + self.bias.reshape(-1)
        return y.reshape(*lead, *self.out_shape)


class MultiHeadDotProductAttention(nn.Module):
    """``flax.linen.MultiHeadDotProductAttention`` for self-attention with
    the defaults the inversion net uses: ``query``/``key``/``value`` are
    ``DenseGeneral`` (dim -> (heads, dim // heads)), ``out`` is
    ((heads, head_dim) -> dim), the query is scaled by head_dim^-1/2, then a
    plain matmul and softmax (no mask, no dropout)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.heads, self.head_dim = num_heads, dim // num_heads
        shape = (num_heads, self.head_dim)
        self.query = DenseGeneral((dim,), shape)
        self.key = DenseGeneral((dim,), shape)
        self.value = DenseGeneral((dim,), shape)
        self.out = DenseGeneral(shape, (dim,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, L, dim) -> (B, L, dim)."""
        q = self.query(x) / math.sqrt(self.head_dim)
        k, v = self.key(x), self.value(x)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``flax.linen.gelu``: the tanh approximation (torch's default is the
    exact erf form)."""
    return F.gelu(x, approximate="tanh")


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


def spectral_normalize(weight: torch.Tensor, stats: dict, update_stats: bool,
                       n_steps: int = 1, eps: float = 1e-12):
    """``flax.linen.SpectralNorm`` of a ``Conv`` or ``Dense`` weight (torch
    layout (O, I, *k) or (O, I)).  Returns (weight / sigma, new stats).

    ``stats`` holds ``u`` (1, O) and ``sigma`` () as flax's ``batch_stats``
    do.  ``n_steps`` power steps from the stored ``u`` give ``u`` and ``v``
    (no gradient) and sigma = v^T W u, through which the gradient reaches
    the weight; the weight is divided by it (by 1 where it is 0) in both
    modes.  ``update_stats`` returns the new ``u`` and ``sigma`` (flax's
    ``update_stats=True``), else the stored ones.  flax flattens the kernel
    to (k*k*I, O); here it is (O, I*k*k), the same matrix transposed with
    its rows permuted, which gives the same ``u`` and sigma."""
    m = weight.reshape(weight.shape[0], -1)
    with torch.no_grad():
        u = stats["u"]
        md = m.detach()
        for _ in range(n_steps):
            v = _l2_normalize(u @ md, eps)
            u = _l2_normalize(v @ md.t(), eps)
    sigma = ((u @ m) @ v.t())[0, 0]
    w = weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
    new = {"u": u, "sigma": sigma.detach()} if update_stats else dict(stats)
    return w, new


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=gen)


def init_flax_defaults(module: nn.Module, gen: torch.Generator) -> None:
    """Initialise every layer below ``module`` as flax would by default.

    The draws differ from flax's (another generator); the distributions are
    the same: lecun-normal kernels, zero biases, norm scale 1 and bias 0.
    Layers are visited in registration order, so a seed fixes the weights.
    """
    for m in module.modules():
        if isinstance(m, (Conv, ConvTranspose, Dense)):
            w = m.weight
            # fan-in: I of (O, I, *k) and (O, I), I of ConvTranspose's (I, O, *k)
            fan_in = w.shape[0 if isinstance(m, ConvTranspose) else 1]
            _lecun_normal_(w, fan_in * math.prod(w.shape[2:]), gen)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()
        elif isinstance(m, DenseGeneral):
            _lecun_normal_(m.kernel, math.prod(m.in_shape), gen)
            with torch.no_grad():
                m.bias.zero_()
        elif isinstance(m, (GroupNorm, LayerNorm)):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
