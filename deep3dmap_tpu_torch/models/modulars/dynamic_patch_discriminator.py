"""GNeRF's patch discriminator (port of
``deep3dmap_tpu/models/modulars/dynamic_patch_discriminator.py``): a strided
conv stack sized by the patch side (16, 32, 64 or 128) down to 4x4, every
conv spectral-normalised (``layers.spectral_normalize``), instance norm
(``_IN``: a ``GroupNorm`` with one group per channel, eps 1e-6) after all
but the first at 64 and 128, LeakyReLU 0.2, then, when ``conditional``,
the patch scale's positional embedding concatenated and three 1x1 convs.

DiffAugment runs on half of the calls: the gate is a uniform draw above
0.5, chosen by ``torch.where`` on the device (no host read), so the
augmentation is computed on every call and kept on half.

The spectral-norm state is JAX's ``batch_stats`` tree, which the framework
keeps in ``model_state["disc_stats"]``: ``{"_SNConv_i": {"SpectralNorm_0":
{"Conv_0/kernel/u": (1, O), "Conv_0/kernel/sigma": ()}}}``.  ``forward``
returns the logits and the new tree (updated with ``train``).  Submodule
names are flax's, so weights carry across by name.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..function_utils.diff_augment import augment_draws, diff_augment
from ..layers import Conv, GroupNorm, spectral_normalize
from .embeddings import high_dim_embedding

_U, _SIGMA = "Conv_0/kernel/u", "Conv_0/kernel/sigma"


class _SNConv(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int = 4, stride: int = 2,
                 padding: int = 1):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, (kernel, kernel), strides=stride,
                           padding=[(padding, padding)] * 2, use_bias=False)

    def forward(self, x, stats: dict, train: bool):
        sn = stats["SpectralNorm_0"]
        w, new = spectral_normalize(self.Conv_0.weight, {"u": sn[_U], "sigma": sn[_SIGMA]},
                                    update_stats=train)
        return self.Conv_0(x, weight=w), {"SpectralNorm_0": {_U: new["u"],
                                                             _SIGMA: new["sigma"]}}

    def init_stats(self, gen: torch.Generator) -> dict:
        o = self.Conv_0.weight.shape[0]
        return {"SpectralNorm_0": {_U: torch.randn((1, o), generator=gen),
                                   _SIGMA: torch.ones(())}}


class _IN(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(channels, channels)

    def forward(self, x):
        return self.GroupNorm_0(x)


def disc_draws(rng: Optional[torch.Generator], shape, policy, device) -> dict:
    """One call's draws for a batch of ``shape``: the gate (a scalar) and
    the augmentation's (``augment_draws``)."""
    out = {"gate": torch.rand((), generator=rng, device=device)}
    out.update(augment_draws(rng, shape, policy, device))
    return out


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class Discriminator(nn.Module):
    def __init__(self, conditional: bool = True,
                 policy: Optional[Sequence[str]] = ("color", "translation", "cutout"),
                 ndf: int = 64, imsize: int = 64):
        super().__init__()
        assert imsize in (16, 32, 64, 128)
        self.conditional, self.policy, self.ndf, self.imsize = conditional, policy, ndf, imsize
        # (features, instance norm) of the strided convs down to 4x4
        plan = {128: [(ndf // 2, False), (ndf, True), (ndf * 2, True), (ndf * 4, True)],
                64: [(ndf, False), (ndf * 2, True), (ndf * 4, True)],
                32: [(ndf * 2, True), (ndf * 4, True)],
                16: [(ndf * 4, True)]}[imsize] + [(ndf * 8, True)]
        self.layers = []      # (conv name, norm name or None), in call order
        n_conv = n_in = 0
        ch = 3

        def conv(in_ch, out, **kw):
            nonlocal n_conv
            name = f"_SNConv_{n_conv}"
            setattr(self, name, _SNConv(in_ch, out, **kw))
            n_conv += 1
            return name

        for out, norm in plan:
            cname = conv(ch, out)
            nname = None
            if norm:
                nname = f"_IN_{n_in}"
                setattr(self, nname, _IN(out))
                n_in += 1
            self.layers.append((cname, nname))
            ch = out
        final = ndf if conditional else 1
        self.final = conv(ch, final, kernel=4, stride=1, padding=0)
        self.head = []
        if conditional:
            ch = final + 9
            for out in (ndf, ndf, 1):
                self.head.append(conv(ch, out, kernel=1, stride=1, padding=0))
                ch = out
        self.conv_names = [f"_SNConv_{i}" for i in range(n_conv)]

    def init_stats(self, gen: torch.Generator) -> dict:
        """The initial spectral-norm tree: ``u`` standard normal, sigma 1."""
        return {n: getattr(self, n).init_stats(gen) for n in self.conv_names}

    def forward(self, x, y, stats: dict, draws: Optional[dict] = None, train: bool = True):
        """x (B, imsize, imsize, 3) in [-1, 1]; y (B, 1) patch scales;
        ``draws`` (``disc_draws``) None skips the augmentation.  Returns (logits (B,), new
        spectral-norm tree)."""
        B = x.shape[0]
        if self.policy is not None and draws is not None:
            x = torch.where(draws["gate"] > 0.5, diff_augment(x, draws, self.policy), x)
        new = {}

        def sn(name, h):
            out, new[name] = getattr(self, name)(h, stats[name], train)
            return out

        h = x
        for cname, nname in self.layers:
            h = sn(cname, h)
            if nname is not None:
                h = getattr(self, nname)(h)
            h = _lrelu(h)
        h = sn(self.final, h)
        if self.conditional:
            y_emb = high_dim_embedding(y, 4)[:, None, None, :]
            h = _lrelu(torch.cat([h, y_emb.to(h.dtype)], dim=-1))
            h = _lrelu(sn(self.head[0], h))
            h = _lrelu(sn(self.head[1], h))
            h = sn(self.head[2], h)
        return h.reshape(B), new
