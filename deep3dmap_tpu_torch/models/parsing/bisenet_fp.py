"""The face-parsing BiSeNet (resnet18 context path) and ``FaceParser``:
port of ``deep3dmap_tpu/models/parsing/bisenet_fp.py``.

The network is the published face-parsing architecture in inference form:
its BatchNorms are folded into the convs when the checkpoint is imported
(``tools/import_weights.py bisenet``), so every conv carries a bias and
there is no norm.  Padding is explicit and symmetric (torch's), not flax's
``SAME``; the max-pool is 3x3 at stride 2 with a -inf pad of 1.  The
context path's upsamplings are JAX's ``"nearest"``, the output's its
antialiased ``"bilinear"`` (``ops/resize.py``).  Submodules keep flax's
names (``resnet.layer2_0.downsample``, ``arm32.conv_atten``, ``ffm_conv1``),
so ``utils/from_flax.py`` carries the ``params`` tree across leaf for leaf.

``FaceParser.parse_mask`` turns images into the category region masks of
Gan2Shape (``gan2shape.py:121-136`` of the JAX framework).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.resize import resize_bilinear, resize_nearest
from ...utils.device import resolve_device
from ...utils.from_flax import load_flax_npz
from ..builder import BACKBONES
from ..layers import Conv, init_flax_defaults


def _conv(cin: int, ch: int, k: int, s: int = 1, use_bias: bool = True) -> Conv:
    p = k // 2
    return Conv(cin, ch, (k, k), s, padding=[(p, p), (p, p)], use_bias=use_bias)


class _Basic(nn.Module):
    """resnet18's BasicBlock, its BatchNorms folded into the convs."""

    def __init__(self, cin: int, ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, ch, 3, stride)
        self.conv2 = _conv(ch, ch, 3)
        self.downsample = _conv(cin, ch, 1, stride) if stride != 1 else None

    def forward(self, x):
        h = self.conv2(F.relu(self.conv1(x)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + h)


class _Resnet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        cin = 64
        for layer, ch in ((1, 64), (2, 128), (3, 256), (4, 512)):
            for b in range(2):
                stride = 2 if layer > 1 and b == 0 else 1
                self.add_module(f"layer{layer}_{b}", _Basic(cin, ch, stride))
                cin = ch

    def _layer(self, x, layer):
        return getattr(self, f"layer{layer}_1")(getattr(self, f"layer{layer}_0")(x))

    def forward(self, x):
        x = F.relu(self.conv1(x))
        # torch's MaxPool2d(3, 2, padding=1): the pad never wins the max
        x = F.max_pool2d(x.movedim(-1, 1), 3, 2, 1).movedim(1, -1)
        feat8 = self._layer(self._layer(x, 1), 2)
        feat16 = self._layer(feat8, 3)
        return feat8, feat16, self._layer(feat16, 4)


class _ARM(nn.Module):
    """Attention refinement: a conv and ReLU, then a global-pool channel gate."""

    def __init__(self, cin: int, ch: int = 128):
        super().__init__()
        self.conv = _conv(cin, ch, 3)
        self.conv_atten = _conv(ch, ch, 1)

    def forward(self, x):
        feat = F.relu(self.conv(x))
        return feat * torch.sigmoid(self.conv_atten(feat.mean(dim=(1, 2), keepdim=True)))


@BACKBONES.register_module()
class BiSeNetFP(nn.Module):
    """(B, H, W, 3) -> (B, H, W, n_classes) logits."""

    def __init__(self, n_classes: int = 19):
        super().__init__()
        self.resnet = _Resnet18()
        self.conv_avg = _conv(512, 128, 1)
        self.arm32 = _ARM(512)
        self.conv_head32 = _conv(128, 128, 3)
        self.arm16 = _ARM(256)
        self.conv_head16 = _conv(128, 128, 3)
        self.ffm_convblk = _conv(256, 256, 1)
        self.ffm_conv1 = Conv(256, 64, (1, 1), use_bias=False)
        self.ffm_conv2 = Conv(64, 256, (1, 1), use_bias=False)
        self.out_conv = _conv(256, 256, 3)
        self.out_cls = Conv(256, n_classes, (1, 1))

    def forward(self, x):
        feat8, feat16, feat32 = self.resnet(x)
        avg = F.relu(self.conv_avg(feat32.mean(dim=(1, 2), keepdim=True)))
        a32 = self.arm32(feat32) + avg.expand(*feat32.shape[:3], 128)
        a32 = F.relu(self.conv_head32(resize_nearest(a32, feat16.shape[1:3])))
        a16 = self.arm16(feat16) + a32
        a16 = F.relu(self.conv_head16(resize_nearest(a16, feat8.shape[1:3])))

        # FFM: feat8 is the spatial path (the face-parsing variant)
        feat = F.relu(self.ffm_convblk(torch.cat([feat8, a16], -1)))
        atten = F.relu(self.ffm_conv1(feat.mean(dim=(1, 2), keepdim=True)))
        feat = feat * torch.sigmoid(self.ffm_conv2(atten)) + feat

        out = self.out_cls(F.relu(self.out_conv(feat)))
        return resize_bilinear(out, x.shape[1:3])


_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
# the scene categories' class ids (VOC-21 for car/cat/horse, ADE-150 for church)
_SCENE_CLASS = {"car": 7, "cat": 8, "church": 1, "horse": 13}


def category_mask(cls: torch.Tensor, category: str) -> torch.Tensor:
    """(B, S, S) class ids -> the category's float32 region mask, as the
    reference's ``parse_mask`` defines it: ``face`` is (classes >= 1 except
    16, cloth) averaged with (classes 1..13), so 0, 0.5 or 1; ``synface``
    classes 1..14; a scene category its one class id."""
    if category == "face":
        mask_all = ((cls >= 1) & (cls != 16)).float()
        mask_face = ((cls >= 1) & (cls <= 13)).float()
        return (mask_all + mask_face) / 2.0
    if category == "synface":
        return ((cls >= 1) & (cls <= 14)).float()
    return (cls == _SCENE_CLASS[category]).float()


class RegionParser:
    """A parsing net with weights from an ``.npz`` (a ``params`` tree, as
    ``tools/import_weights.py`` writes it) or, without one, a seeded flax
    default init; its ``parse_mask``.  On the card unless ``device="cpu"``."""

    def __init__(self, net: nn.Module, weights_path: Optional[str] = None,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        if weights_path:
            load_flax_npz(net, weights_path)
        else:
            init_flax_defaults(net, torch.Generator().manual_seed(int(seed)))
        self.net = net.to(self.device).eval()
        self._mean = torch.tensor(_IMAGENET_MEAN, device=self.device)
        self._std = torch.tensor(_IMAGENET_STD, device=self.device)

    def parse_mask(self, images: torch.Tensor, category: str = "face",
                   out_size: Optional[int] = None) -> torch.Tensor:
        """images (B, H, W, 3) in [-1, 1] -> (B, S, S, 1) soft mask, S the
        parser's input size (512 for faces, 473 for scenes) or ``out_size``.
        The input is resized to S (bilinear), ImageNet-normalised for
        ``car``/``cat``, parsed, and the argmax mapped by ``category_mask``."""
        size = 512 if category in ("face", "synface") else 473
        with torch.no_grad():
            x = resize_bilinear(images.to(self.device, torch.float32), size)
            if category in ("car", "cat"):
                x = (x / 2 + 0.5 - self._mean) / self._std
            cls = torch.argmax(self.net(x), dim=-1)
            mask = category_mask(cls, category)[..., None]
            if out_size:
                mask = resize_bilinear(mask, out_size)
        return mask


class FaceParser(RegionParser):
    """The face-parsing BiSeNet behind ``parse_mask``; ``weights_path`` is
    the ``.npz`` of ``tools/import_weights.py bisenet``."""

    def __init__(self, weights_path: Optional[str] = None, n_classes: int = 19,
                 seed: int = 0, device=None):
        super().__init__(BiSeNetFP(n_classes), weights_path, seed, device)
