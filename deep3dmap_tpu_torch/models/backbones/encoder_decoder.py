"""EDDeconv -- encoder-decoder for depth/albedo prediction.

Port of ``deep3dmap_tpu/models/backbones/encoder_decoder.py::EDDeconv``: four
4x4 stride-2 SAME convs to S/16, a VALID conv over the whole remaining
extent to a (1, 1, 256) latent, a 4x4 VALID ``ConvTranspose`` to 4x4, then
nearest x2 upsampling + 3x3 conv + GroupNorm(min(8, ch), eps 1e-6) + ReLU up
to S, a 3x3 conv, a 5x5 conv and tanh.  RGB NHWC in; submodules carry flax's
auto-names (``Conv_*``, ``ConvTranspose_0``, ``GroupNorm_*``), so the conv
numbering runs encoder, latent, decoder, head as in flax.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv, ConvTranspose, GroupNorm


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsampling of (B, H, W, C) (``jnp.repeat`` on H and W)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


ZDIM = 256   # the latent width (flax EDDeconv's default, the only one used)


class EDDeconv(nn.Module):
    def __init__(self, image_size: int, cout: int = 1, nf: int = 32):
        super().__init__()
        if image_size % 16 or image_size < 16:
            raise ValueError(f"EDDeconv: image_size {image_size} must be a "
                             "multiple of 16")
        n = 0
        c = 3        # RGB input
        for ch in (nf, nf * 2, nf * 4, nf * 8):
            setattr(self, f"Conv_{n}", Conv(c, ch, (4, 4), strides=2,
                                            use_bias=False))
            c, n = ch, n + 1
        side = image_size // 16
        setattr(self, f"Conv_{n}", Conv(c, ZDIM, (side, side), padding="VALID",
                                        use_bias=False))
        n += 1
        self.ConvTranspose_0 = ConvTranspose(ZDIM, nf * 8, (4, 4))
        c = nf * 8
        chans = [nf * 8, nf * 4, nf * 2, nf, nf]
        self.n_up = 0
        res = 4
        while res < image_size:
            ch = chans[min(self.n_up, len(chans) - 1)]
            setattr(self, f"Conv_{n}", Conv(c, ch, (3, 3), use_bias=False))
            setattr(self, f"GroupNorm_{self.n_up}", GroupNorm(min(8, ch), ch))
            c, n, res, self.n_up = ch, n + 1, res * 2, self.n_up + 1
        setattr(self, f"Conv_{n}", Conv(c, nf, (3, 3)))
        setattr(self, f"Conv_{n + 1}", Conv(nf, cout, (5, 5)))
        self.n_conv = n + 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, S, S, C) -> (B, S, S, cout)."""
        h = x
        for i in range(4):
            h = F.leaky_relu(getattr(self, f"Conv_{i}")(h), 0.2)
        h = F.relu(self.Conv_4(h))                     # (B, 1, 1, ZDIM)
        h = F.relu(self.ConvTranspose_0(h))            # (B, 4, 4, nf*8)
        for u in range(self.n_up):
            h = getattr(self, f"Conv_{5 + u}")(_up2(h))
            h = F.relu(getattr(self, f"GroupNorm_{u}")(h))
        h = F.relu(getattr(self, f"Conv_{self.n_conv - 2}")(h))
        return torch.tanh(getattr(self, f"Conv_{self.n_conv - 1}")(h))
