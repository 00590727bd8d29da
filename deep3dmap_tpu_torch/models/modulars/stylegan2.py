"""StyleGAN2 generator and discriminator.

Port of ``deep3dmap_tpu/models/modulars/stylegan2.py``: the mapping MLP with
pixel norm and partial passes, modulated/demodulated convolutions (plain,
``up``, ``down``), noise injection, skip-connection ToRGB synthesis, the
blur-resampled residual discriminator with minibatch stddev.  Equalized
learning rate is runtime weight scaling, as in JAX.

Tensors are NHWC (logical shape (B, H, W, C)) at every module boundary and
inside, as in the JAX package; a convolution runs on the NCHW view of the
channel-last tensor.  Weights are stored in torch's layouts (conv
``(O, I, k, k)``, dense ``(O, I)``); their flax leaves are raw
``self.param``s, which each module declares in ``FLAX_LEAVES`` for
``utils/from_flax.py``.  ``init_stylegan2`` draws StyleGAN2's initializers
from an explicit ``torch.Generator``.

TRAP, kept for parity: JAX folds the batch into the channels of a grouped
convolution with ``x.reshape(1, H, W, B * Cin)`` on an NHWC tensor
(``stylegan2.py:106,121,127``).  That is a reshape of memory, not a
transpose: for B > 1, group g at pixel p reads the batch's pixel B·p + g,
so each sample's modulated kernel is applied to a mix of the batch's
pixels.  ``_fold_batch``/``_unfold_batch`` do the same reshapes, so the port
gives JAX's numbers; at B = 1 it is the per-sample convolution.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.upfirdn2d import blur2d, fused_leaky_relu, make_kernel, upsample2d
from ...utils.device import DeviceLike, resolve_device


def channels(channel_multiplier: int) -> dict:
    cm = channel_multiplier
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * cm,
            128: 128 * cm, 256: 64 * cm, 512: 32 * cm, 1024: 16 * cm}


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x ** 2, dim=-1, keepdim=True) + eps)


def _normal_(p: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """Draw on the host from ``gen`` (a CPU generator) and copy, so a seed
    gives the same weights on every device."""
    with torch.no_grad():
        p.copy_(torch.empty(p.shape).normal_(0.0, std, generator=gen))


def _zero_(*ps: torch.Tensor) -> None:
    with torch.no_grad():
        for p in ps:
            p.zero_()


class EqualDense(nn.Module):
    """Dense with weight scale ``lr_mul / sqrt(in)`` and bias ``* lr_mul``,
    optionally followed by the fused leaky ReLU."""

    FLAX_LEAVES = {"weight": ("weight", "kernel"), "bias": ("bias", "plain")}

    def __init__(self, in_features: int, features: int, lr_mul: float = 1.0,
                 use_bias: bool = True, activation: bool = False):
        super().__init__()
        self.lr_mul = lr_mul
        self.activation = activation
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        _normal_(self.weight, 1.0 / self.lr_mul, gen)
        if self.bias is not None:
            _zero_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = (1.0 / math.sqrt(self.weight.shape[1])) * self.lr_mul
        out = F.linear(x, self.weight * scale)
        b = None if self.bias is None else self.bias * self.lr_mul
        if self.activation:
            return fused_leaky_relu(out, b)
        return out if b is None else out + b


class MappingNet(nn.Module):
    """The mapping MLP; ``forward(x, depth, skip)`` runs layers
    [skip, depth) and pixel-normalises the input only when ``skip == 0``.
    All ``n_mlp`` layers exist whatever the pass, so the tree loads whole."""

    def __init__(self, style_dim: int = 512, n_mlp: int = 8, lr_mlp: float = 0.01):
        super().__init__()
        self.n_mlp = n_mlp
        for i in range(n_mlp):
            setattr(self, f"dense_{i}", EqualDense(style_dim, style_dim,
                                                   lr_mul=lr_mlp, activation=True))

    def forward(self, x: torch.Tensor, depth: Optional[int] = None,
                skip: int = 0) -> torch.Tensor:
        end = self.n_mlp if depth is None else depth
        if skip == 0:
            x = pixel_norm(x)
        for i in range(skip, end):
            x = getattr(self, f"dense_{i}")(x)
        return x


def _fold_batch(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> the (1, B*C, H, W) NCHW view of JAX's
    ``x.reshape(1, H, W, B * C)`` (a reshape of memory; see the TRAP)."""
    B, H, W, C = x.shape
    return x.reshape(1, H, W, B * C).movedim(-1, 1)


def _unfold_batch(y: torch.Tensor, B: int) -> torch.Tensor:
    """(1, B*C, H, W) -> JAX's ``y.reshape(B, H, W, C)`` of the NHWC output."""
    _, BC, H, W = y.shape
    return y.movedim(1, -1).reshape(B, H, W, BC // B)


class ModulatedConv(nn.Module):
    """Per-sample modulated (and demodulated) convolution as one grouped
    convolution.  ``up``: a stride-2 transposed convolution followed by the
    blur; ``down``: the blur followed by a stride-2 convolution."""

    FLAX_LEAVES = {"weight": ("weight", "kernel")}

    def __init__(self, in_ch: int, features: int, style_dim: int,
                 kernel: int = 3, demodulate: bool = True, up: bool = False,
                 down: bool = False, blur_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        self.kernel, self.demodulate, self.up, self.down = kernel, demodulate, up, down
        self.n_blur = len(blur_kernel)
        self.weight = nn.Parameter(torch.empty(features, in_ch, kernel, kernel))
        self.modulation = EqualDense(style_dim, in_ch, use_bias=True)
        self.register_buffer("blur", make_kernel(blur_kernel), persistent=False)

    def reset_parameters(self, gen: torch.Generator) -> None:
        _normal_(self.weight, 1.0, gen)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, Cin); style (B, style_dim)."""
        B, _, _, Cin = x.shape
        k = self.kernel
        Cout = self.weight.shape[0]
        scale = 1.0 / math.sqrt(Cin * k * k)
        s = self.modulation(style) + 1.0                                 # (B, Cin)
        w = self.weight[None] * s[:, None, :, None, None] * scale        # (B, O, I, k, k)
        if self.demodulate:
            demod = torch.rsqrt((w ** 2).sum(dim=(2, 3, 4)) + 1e-8)      # (B, O)
            w = w * demod[:, :, None, None, None]
        if self.up:
            # JAX correlates the 2x-dilated input, padded by k - 1, with the
            # spatially flipped kernel: a stride-2 transposed convolution with
            # the kernel as it is, output 2H + k - 2; then the blur
            wt = w.transpose(1, 2).reshape(B * Cin, Cout, k, k)
            y = _unfold_batch(F.conv_transpose2d(_fold_batch(x), wt, stride=2,
                                                 groups=B), B)
            p = (self.n_blur - 2) - (k - 1)
            return blur2d(y, self.blur * 4.0, pad=((p + 1) // 2 + 1, p // 2 + 1))
        wg = w.reshape(B * Cout, Cin, k, k)
        if self.down:
            p = self.n_blur - 2 + (k - 1)
            x = blur2d(x, self.blur, pad=((p + 1) // 2, p // 2))
            return _unfold_batch(F.conv2d(_fold_batch(x), wg, stride=2, groups=B), B)
        return _unfold_batch(F.conv2d(_fold_batch(x), wg, padding=k // 2,
                                      groups=B), B)


class StyledConv(nn.Module):
    """ModulatedConv, noise * ``noise_strength``, bias, fused leaky ReLU."""

    FLAX_LEAVES = {"noise_strength": ("noise_strength", "plain"),
                   "bias": ("bias", "plain")}

    def __init__(self, in_ch: int, features: int, style_dim: int,
                 kernel: int = 3, up: bool = False, demodulate: bool = True):
        super().__init__()
        self.conv = ModulatedConv(in_ch, features, style_dim, kernel, up=up,
                                  demodulate=demodulate)
        self.noise_strength = nn.Parameter(torch.empty(()))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, gen: torch.Generator) -> None:
        _zero_(self.noise_strength, self.bias)

    def forward(self, x, style, noise: Optional[torch.Tensor] = None):
        """``noise`` (B, H, W, 1); without it JAX adds strength * 0."""
        y = self.conv(x, style)
        if noise is not None:
            y = y + self.noise_strength * noise
        return fused_leaky_relu(y, self.bias)


class ToRGB(nn.Module):
    FLAX_LEAVES = {"bias": ("bias", "plain")}

    def __init__(self, in_ch: int, style_dim: int, up: bool = True):
        super().__init__()
        self.up = up
        self.conv = ModulatedConv(in_ch, 3, style_dim, 1, demodulate=False)
        self.bias = nn.Parameter(torch.empty(3))
        self.register_buffer("blur", make_kernel((1, 3, 3, 1)), persistent=False)

    def reset_parameters(self, gen: torch.Generator) -> None:
        _zero_(self.bias)

    def forward(self, x, style, skip: Optional[torch.Tensor] = None):
        y = self.conv(x, style) + self.bias
        if skip is not None:
            if self.up:
                skip = upsample2d(skip, self.blur)
            y = y + skip
        return y


class Generator(nn.Module):
    """StyleGAN2 synthesis; returns the image (B, size, size, 3) NHWC.
    Built on ``device`` (``None``: the GPU, raising without one)."""

    FLAX_LEAVES = {"input_const": ("input_const", "plain")}

    def __init__(self, size: int = 128, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2, lr_mlp: float = 0.01,
                 device: DeviceLike = None):
        super().__init__()
        self.size, self.style_dim = size, style_dim
        ch = channels(channel_multiplier)
        self.mapping = MappingNet(style_dim, n_mlp, lr_mlp)
        self.input_const = nn.Parameter(torch.empty(1, 4, 4, ch[4]))
        self.conv1 = StyledConv(ch[4], ch[4], style_dim)
        self.to_rgb1 = ToRGB(ch[4], style_dim, up=False)
        res, cin = 8, ch[4]
        while res <= size:
            setattr(self, f"conv_{res}_up", StyledConv(cin, ch[res], style_dim, up=True))
            setattr(self, f"conv_{res}", StyledConv(ch[res], ch[res], style_dim))
            setattr(self, f"to_rgb_{res}", ToRGB(ch[res], style_dim))
            cin, res = ch[res], res * 2
        self.to(resolve_device(device))

    def reset_parameters(self, gen: torch.Generator) -> None:
        _normal_(self.input_const, 1.0, gen)

    @property
    def n_latent(self) -> int:
        return int(math.log2(self.size)) * 2 - 2

    def make_noise(self, batch: int, gen: torch.Generator) -> List[torch.Tensor]:
        """Noise maps in JAX's order and resolutions [4, 8, 8, ..., size,
        size], each (batch, r, r, 1), drawn from ``gen`` on its device."""
        shapes = [4] + [r for r in (2 ** i for i in range(3, int(math.log2(self.size)) + 1))
                        for _ in range(2)]
        return [torch.randn((batch, r, r, 1), generator=gen, device=gen.device)
                for r in shapes]

    def forward(self, styles: torch.Tensor, input_is_latent: bool = False,
                noise: Optional[Sequence[torch.Tensor]] = None,
                rng: Optional[torch.Generator] = None,
                return_latents: bool = False, truncation: float = 1.0,
                truncation_latent: Optional[torch.Tensor] = None):
        """styles: (B, style_dim) z or w, or (B, n_latent, style_dim) w+.
        ``noise``: a list as ``make_noise`` returns (entries past its end
        get none); else drawn from ``rng`` (a generator seeded 0 on the
        weights' device without one, as JAX falls back to PRNGKey(0))."""
        w = styles if input_is_latent else self.mapping(styles)
        if truncation < 1.0 and truncation_latent is not None:
            w = truncation_latent + truncation * (w - truncation_latent)
        latent = w[:, None].expand(w.shape[0], self.n_latent, w.shape[1]) \
            if w.ndim == 2 else w
        B = latent.shape[0]
        if noise is None:
            if rng is None:
                rng = torch.Generator(device=self.input_const.device).manual_seed(0)
            noise = self.make_noise(B, rng)

        def nz(i):
            return noise[i] if i < len(noise) else None
        x = self.input_const.expand(B, *self.input_const.shape[1:])
        x = self.conv1(x, latent[:, 0], nz(0))
        skip = self.to_rgb1(x, latent[:, 1])
        i, res = 1, 8
        while res <= self.size:
            x = getattr(self, f"conv_{res}_up")(x, latent[:, i], nz(i))
            x = getattr(self, f"conv_{res}")(x, latent[:, i + 1], nz(i + 1))
            skip = getattr(self, f"to_rgb_{res}")(x, latent[:, i + 2], skip)
            i, res = i + 2, res * 2
        return (skip, latent) if return_latents else skip


def _equal_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                padding: Optional[int] = None) -> torch.Tensor:
    """Equalized-lr conv of NHWC ``x`` with torch-layout ``w`` (O, I, k, k);
    ``padding`` None pads k // 2 on every side, 0 is VALID."""
    _, cin, k, _ = w.shape
    pad = k // 2 if padding is None else padding
    return F.conv2d(x.movedim(-1, 1), w * (1.0 / math.sqrt(cin * k * k)),
                    stride=stride, padding=pad).movedim(1, -1)


class _DiscBlock(nn.Module):
    FLAX_LEAVES = {n: (n, "kernel" if n.endswith("_weight") else "plain")
                   for n in ("conv1_weight", "b1", "conv2_weight", "b2", "skip_weight")}

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv1_weight = nn.Parameter(torch.empty(in_ch, in_ch, 3, 3))
        self.b1 = nn.Parameter(torch.empty(in_ch))
        self.conv2_weight = nn.Parameter(torch.empty(features, in_ch, 3, 3))
        self.b2 = nn.Parameter(torch.empty(features))
        self.skip_weight = nn.Parameter(torch.empty(features, in_ch, 1, 1))
        self.register_buffer("blur", make_kernel((1, 3, 3, 1)), persistent=False)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.conv1_weight, self.conv2_weight, self.skip_weight):
            _normal_(w, 1.0, gen)
        _zero_(self.b1, self.b2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = fused_leaky_relu(_equal_conv(x, self.conv1_weight), self.b1)
        h = blur2d(h, self.blur, pad=(2, 2))          # p = (4 - 2) + (3 - 1)
        h = fused_leaky_relu(_equal_conv(h, self.conv2_weight, 2, 0), self.b2)
        skip = blur2d(x, self.blur, pad=(1, 1))       # p = (4 - 2) + (1 - 1)
        skip = _equal_conv(skip, self.skip_weight, 2, 0)
        return (h + skip) / math.sqrt(2)


class StyleDiscriminator(nn.Module):
    """Residual discriminator with minibatch stddev; built on ``device``
    (``None``: the GPU, raising without one)."""

    FLAX_LEAVES = {n: (n, "kernel" if n.endswith("_weight") else "plain")
                   for n in ("from_rgb_weight", "frgb_b", "final_conv_weight", "fc_b")}

    def __init__(self, size: int = 128, channel_multiplier: int = 2,
                 device: DeviceLike = None):
        super().__init__()
        ch = channels(channel_multiplier)
        self.size = size
        self.from_rgb_weight = nn.Parameter(torch.empty(ch[size], 3, 1, 1))
        self.frgb_b = nn.Parameter(torch.empty(ch[size]))
        res = size
        while res > 4:
            setattr(self, f"block_{res}", _DiscBlock(ch[res], ch[res // 2]))
            res //= 2
        self.final_conv_weight = nn.Parameter(torch.empty(ch[4], ch[4] + 1, 3, 3))
        self.fc_b = nn.Parameter(torch.empty(ch[4]))
        self.final_dense = EqualDense(ch[4] * 16, ch[4], activation=True)
        self.out = EqualDense(ch[4], 1)
        self.to(resolve_device(device))

    def reset_parameters(self, gen: torch.Generator) -> None:
        _normal_(self.from_rgb_weight, 1.0, gen)
        _normal_(self.final_conv_weight, 1.0, gen)
        _zero_(self.frgb_b, self.fc_b)

    def _blocks(self):
        res = self.size
        while res > 4:
            yield getattr(self, f"block_{res}")
            res //= 2

    def features(self, x: torch.Tensor, n: Optional[int] = None) -> List[torch.Tensor]:
        """The first ``n`` blocks' outputs (all without ``n``), NHWC.  Under
        ``jit`` XLA drops the head and the unused blocks when only these
        features are read (Gan2Shape's ``DiscriminatorLoss``); here they
        are simply not run."""
        h = fused_leaky_relu(_equal_conv(x, self.from_rgb_weight), self.frgb_b)
        feats = []
        for block in self._blocks():
            if n is not None and len(feats) == n:
                break
            h = block(h)
            feats.append(h)
        return feats

    def forward(self, x: torch.Tensor, return_features: bool = False):
        """x (B, size, size, 3) NHWC -> scores (B, 1) [, block features]."""
        feats = self.features(x)
        h = feats[-1]
        # minibatch stddev: population variance over groups of min(4, B)
        # samples, averaged over (H, W, C), tiled as jnp.tile does
        B, H, W, C = h.shape
        group = min(4, B)
        g = h.reshape(group, -1, H, W, C)
        stddev = torch.sqrt(g.var(dim=0, correction=0) + 1e-8).mean(dim=(1, 2, 3),
                                                                      keepdim=True)
        h = torch.cat([h, stddev.repeat(group, H, W, 1)], dim=-1)
        h = fused_leaky_relu(_equal_conv(h, self.final_conv_weight), self.fc_b)
        # flattened in NHWC order, as JAX's h.reshape(B, -1)
        out = self.out(self.final_dense(h.reshape(B, -1)))
        return (out, feats) if return_features else out


def init_stylegan2(module: nn.Module, gen: torch.Generator) -> None:
    """StyleGAN2's initializers over every submodule, in registration order:
    normal(1 / lr_mul) for ``EqualDense`` weights, normal(1) for conv
    weights and ``input_const``, zeros for biases and ``noise_strength``;
    drawn from the CPU generator ``gen`` whatever the module's device."""
    for m in module.modules():
        if hasattr(m, "reset_parameters") and hasattr(m, "FLAX_LEAVES"):
            m.reset_parameters(gen)
