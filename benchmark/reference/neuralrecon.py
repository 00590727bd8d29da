"""NeuralRecon's math in plain PyTorch: the benchmark's reference.

It imports nothing of the program.  It holds the weights under the names the
port's ``NeuralReconNet`` gives them (so one seeded draw can be loaded into
both), and computes from them, channels first, in float32:

- the MnasFPN trunk (MBConv stacks, GroupNorm eps 1e-6, flax SAME padding,
  which is (0, 1) at stride 2 for k=3 and (1, 2) for k=5 on even sides);
- back-projection: bilinear taps (``grid_sample``, align_corners) of every
  view, the mean over the views that see a voxel, the mean camera depth
  standardised over the seen voxels by its norm, the view count;
- the pyramid 24³ -> 48³ -> 96³: a dense level runs the dense UNet and GRU
  over its whole window (stride-2 convs with SAME padding); a level with a
  sample budget below its size back-projects only the first ``budget``
  voxels of the upsampled occupancy (x-major order); a block level keeps the
  first ``max_blocks`` 8³ blocks (in linear order) that hold an occupied
  parent voxel and computes only on them: each 3³ conv reads its block's
  neighbourhood from the level's volume, zero outside the kept blocks and
  outside the volume, stride-2 convs centre on even voxels, GroupNorm
  (eps 1e-5) takes its statistics over the kept blocks' voxels;
- the ConvGRU fusion into the hidden windows of the global volumes;
- the masked TSDF / occupancy loss with the dynamic positive weight.

``Precision`` names where rounding to a lower type is applied.  The
reference rounds only where the model itself does, the back-projection's
gather table (``for_reference``); the control of ``correct`` runs with the
types one step below what the configuration states (``for_control``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

# --------------------------------------------------------------------------
# rounding
# --------------------------------------------------------------------------

_FP8_MAX = 448.0


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(-_FP8_MAX, _FP8_MAX).to(torch.float8_e4m3fn).to(x.dtype)


_ROUND = {"bfloat16": _round_bf16, "float8": _round_fp8, None: None}
# the next type below each stated one (TF32-enabled float32 counts as float32)
_BELOW = {"bfloat16": "float8", "float32": "bfloat16"}


class Precision:
    """Rounding per part of the net: ``trunk`` (2D convs), ``dense`` (dense
    3D nets), ``block`` (block 3D nets), ``gather`` (the back-projection's
    feature taps), ``hidden`` (the global volumes).  None: float32."""

    PARTS = ("trunk", "dense", "block", "gather", "hidden")

    def __init__(self, **parts: Optional[str]):
        self.fns: Dict[str, Optional[Callable]] = {p: _ROUND[parts.get(p)] for p in self.PARTS}

    def r(self, part: str, x: torch.Tensor) -> torch.Tensor:
        fn = self.fns[part]
        return x if fn is None else fn(x)

    @classmethod
    def for_reference(cls, stated: Dict[str, str]) -> "Precision":
        """The reference's: float32 everywhere but the gather table, which
        the model itself rounds to its stated type on every configuration
        (the JAX package's ``NeuralReconNet.bp_gather_dtype``, bfloat16, is
        a part of the net, not a compute setting)."""
        return cls(gather=None if stated["gather"] == "float32" else stated["gather"])

    @classmethod
    def for_control(cls, stated: Dict[str, str]) -> "Precision":
        """One step below each part's stated type."""
        return cls(**{p: _BELOW[stated[p]] for p in cls.PARTS})


FLOAT32 = Precision()

# --------------------------------------------------------------------------
# weights, under the port's names
# --------------------------------------------------------------------------


class Leaves(nn.Module):
    """A node of the weight tree: parameters by name and shape, and kinds
    for the seeded draw (``weights.py``): ``w`` lecun-normal with its fan-in,
    ``zero``, ``one``."""

    def __init__(self, **leaves):
        super().__init__()
        self.kinds: Dict[str, tuple] = {}
        for name, (shape, kind, fan_in) in leaves.items():
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))
            self.kinds[name] = (kind, fan_in)


def _conv(cin, cout, k, nd, bias, groups=1):
    ks = (k,) * nd
    fan = cin // groups * k ** nd
    leaves = dict(weight=((cout, cin // groups) + ks, "w", fan))
    if bias:
        leaves["bias"] = ((cout,), "zero", 0)
    return Leaves(**leaves)


def _dense(cin, cout):
    return Leaves(weight=((cout, cin), "w", cin), bias=((cout,), "zero", 0))


def _norm(c):
    return Leaves(weight=((c,), "one", 0), bias=((c,), "zero", 0))


def _node(**children) -> nn.Module:
    m = nn.Module()
    for k, v in children.items():
        setattr(m, k, v)
    return m


def num_groups(c: int, max_groups: int = 8) -> int:
    g = min(max_groups, c)
    while c % g:
        g -= 1
    return g


def mnas_depths(alpha: float) -> List[int]:
    out = []
    for d in (32, 16, 24, 40, 80, 96, 192, 320):
        v = d * alpha
        new = max(8, int(v + 4) // 8 * 8)
        out.append(new if new >= 0.9 * v else new + 8)
    return out


def unet_channels(cr: float) -> List[int]:
    return [max(int(c * cr), 8) for c in (32, 64, 128, 96, 96)]


def _trunk_tree(alpha: float) -> nn.Module:
    d = mnas_depths(alpha)

    def mb(cin, cout, k, e):
        mid = cin * e
        return _node(Conv_0=_conv(cin, mid, 1, 2, False),
                     Conv_1=_conv(mid, mid, k, 2, False, groups=mid),
                     Conv_2=_conv(mid, cout, 1, 2, False),
                     _GN_0=_node(GroupNorm_0=_norm(mid)),
                     _GN_1=_node(GroupNorm_0=_norm(mid)),
                     _GN_2=_node(GroupNorm_0=_norm(cout)))

    def stack(cin, cout, k, e):
        return _node(**{f"MBConv_{i}": mb(cin if i == 0 else cout, cout, k, e)
                        for i in range(3)})

    fpn = _node(Conv_0=_conv(3, d[0], 3, 2, False),
                Conv_1=_conv(d[0], d[0], 3, 2, False, groups=d[0]),
                Conv_2=_conv(d[0], d[1], 1, 2, False),
                _GN_0=_node(GroupNorm_0=_norm(d[0])),
                _GN_1=_node(GroupNorm_0=_norm(d[0])),
                _GN_2=_node(GroupNorm_0=_norm(d[1])),
                _Stack_0=stack(d[1], d[2], 3, 3),
                _Stack_1=stack(d[2], d[3], 5, 3),
                _Stack_2=stack(d[3], d[4], 5, 6),
                Conv_3=_conv(d[4], d[4], 1, 2, False),
                Conv_4=_conv(d[3], d[4], 1, 2, True),
                Conv_5=_conv(d[4], d[3], 3, 2, False),
                Conv_6=_conv(d[2], d[4], 1, 2, True),
                Conv_7=_conv(d[4], d[2], 3, 2, False))
    return _node(fpn=fpn)


def _unet_tree(cin, cout, cr, block: bool) -> nn.Module:
    cs = unet_channels(cr)
    if block:
        def cb(i, o):
            return _node(BlockConv3D_0=_node(Conv_0=_conv(i, o, 3, 3, False)),
                         BlockGN_0=_norm(o))

        def rb(i, o):
            m = _node(BlockConvBlock3D_0=cb(i, o),
                      BlockConv3D_0=_node(Conv_0=_conv(o, o, 3, 3, False)),
                      BlockGN_0=_norm(o))
            if i != o:
                m.Conv_0 = _conv(i, o, 1, 3, False)
            return m
        names = ("BlockConvBlock3D", "BlockResBlock3D")
    else:
        def cb(i, o):
            return _node(Conv_0=_conv(i, o, 3, 3, False), GroupNorm_0=_norm(o))

        def rb(i, o):
            m = _node(ConvBlock3D_0=cb(i, o), Conv_0=_conv(o, o, 3, 3, False),
                      GroupNorm_0=_norm(o))
            if i != o:
                m.Conv_1 = _conv(i, o, 1, 3, False)
            return m
        names = ("ConvBlock3D", "ResBlock3D")
    c, r = names
    return _node(**{f"{c}_0": cb(cin, cs[0]), f"{c}_1": cb(cs[0], cs[1]),
                    f"{r}_0": rb(cs[1], cs[1]), f"{c}_2": cb(cs[1], cs[2]),
                    f"{r}_1": rb(cs[2], cs[2]), f"{r}_2": rb(cs[2] + cs[1], cs[3]),
                    f"{r}_3": rb(cs[3] + cs[0], cs[4]),
                    "Conv_0": _conv(cs[4], cout, 1, 3, True)})


def _gru_tree(c, block: bool) -> nn.Module:
    if block:
        return _node(convzr=_node(Conv_0=_conv(2 * c, 2 * c, 3, 3, True)),
                     convq=_node(Conv_0=_conv(2 * c, c, 3, 3, True)))
    return _node(convzr=_conv(2 * c, 2 * c, 3, 3, True),
                 convq=_conv(2 * c, c, 3, 3, True))


class RefNet(nn.Module):
    """The weight tree of ``NeuralReconNet`` (names and shapes) and the
    configuration the forward reads."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = resolve(cfg)
        c = self.cfg
        self.backbone2d = _trunk_tree(c["alpha"])
        d = mnas_depths(c["alpha"])
        feat_ch = (d[2], d[3], d[4])
        for i in range(c["n_layers"]):
            cin = feat_ch[c["n_layers"] - 1 - i] + 1
            if i > 0:
                cin += c["channels"][i - 1] + 2
            cin += 3
            ch = c["channels"][i]
            block = c["block"][i]
            setattr(self, f"unet{i}", _unet_tree(cin, ch, 1.0 / 2 ** i, block))
            setattr(self, f"gru{i}", _gru_tree(ch, block))
            setattr(self, f"tsdf_pred{i}", _dense(ch, 1))
            setattr(self, f"occ_pred{i}", _dense(ch, 1))


def resolve(model_cfgs: dict) -> dict:
    """The numbers the forward needs, from a ``model_cfgs`` dict (the port's
    keys and defaults)."""
    m = dict(model_cfgs)
    n_layers = m.get("N_LAYER", 3)
    n_vox = m.get("N_VOX", [96, 96, 96])[0]
    dims = [n_vox // 2 ** (n_layers - 1 - i) for i in range(n_layers)]
    bb = dict(m.get("BACKBONE2D", {}))
    train_ns = m.get("TRAIN_NUM_SAMPLE")
    budget = [None] * n_layers
    if train_ns is not None:
        for i in range(1, n_layers):
            if len(train_ns) >= n_layers:
                budget[i] = min(int(train_ns[i]), dims[i] ** 3)
            else:
                budget[i] = min(int(train_ns[i - 1]) * 8, dims[i] ** 3)
    sparse = m.get("SPARSE_MODE", "dense")
    bs = int(m.get("BLOCK_SIZE", 8))
    max_blocks = list(m.get("MAX_BLOCKS", [None] + [
        None if budget[i] is None else -(-budget[i] // bs ** 3)
        for i in range(1, n_layers)]))
    fusion = dict(m.get("FUSION", {}))
    if not fusion.get("FUSION_ON", True) or not fusion.get("FULL", True):
        raise ValueError("the reference covers FUSION_ON with FULL fusion")
    return dict(
        n_layers=n_layers, n_vox=n_vox, dims=dims,
        voxel_size=float(m.get("VOXEL_SIZE", 0.04)),
        alpha=float(str(bb.get("ARC", "fpn-mnas-1")).split("-")[-1]),
        channels=tuple(m.get("CHANNELS", (96, 48, 24))),
        thresholds=tuple(m.get("THRESHOLDS", [0, 0, 0])),
        lw=tuple(m.get("LW", [1.0, 0.8, 0.64])),
        pos_weight=float(m.get("POS_WEIGHT", 1.0)),
        budget=budget, bs=bs,
        block=[i > 0 and sparse == "block" for i in range(n_layers)],
        max_blocks=[None if b is None else min(int(b), (dims[i] // bs) ** 3)
                    for i, b in enumerate(max_blocks)],
        global_dims=tuple(m.get("GLOBAL_DIMS", dims)),
        img_norm=tuple(m.get("IMG_NORM", (0.0, 1.0))),
    )


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def same_pads(size: int, k: int, s: int):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x, p, stride=1, groups=1, pads=None, rnd=None):
    """N-d conv of a channels-first ``x`` with leaves ``p``; ``pads`` per
    spatial dim (lo, hi), default SAME; ``rnd`` rounds the operands and the
    result."""
    w = p.weight
    nd = w.dim() - 2
    k = w.shape[-1]
    if pads is None:
        pads = [same_pads(x.shape[2 + i], k, stride) for i in range(nd)]
    spec = []
    for lo, hi in reversed(pads):
        spec += [lo, hi]
    if any(spec):
        x = F.pad(x, spec)
    b = getattr(p, "bias", None)
    if rnd is not None:
        x, w = rnd(x), rnd(w)
    fn = F.conv3d if nd == 3 else F.conv2d
    y = fn(x, w, None, stride=stride, groups=groups)
    if rnd is not None:
        y = rnd(y)
    if b is not None:
        y = y + b.reshape((1, -1) + (1,) * nd)
        if rnd is not None:
            y = rnd(y)
    return y


def group_norm(x, p, eps=1e-6):
    return F.group_norm(x, num_groups(x.shape[1]), p.weight, p.bias, eps)


def up2(x):
    """Nearest 2x on every spatial dim of a channels-first tensor."""
    for d in range(2, x.dim()):
        x = x.repeat_interleave(2, dim=d)
    return x


def slog(t):
    return torch.sign(t) * torch.log(torch.abs(t) + 1.0)


# --------------------------------------------------------------------------
# the 2D trunk
# --------------------------------------------------------------------------

def trunk(fpn, x, prec: Precision):
    """(N, 3, H, W) -> [fine 1/4, mid 1/8, coarse 1/16] feature maps."""
    r = prec.fns["trunk"]

    def gn(node, i, h):
        return group_norm(h, getattr(node, f"_GN_{i}").GroupNorm_0)

    def mbconv(m, h, k, stride, residual):
        y = F.relu(gn(m, 0, conv(h, m.Conv_0, rnd=r)))
        y = F.relu(gn(m, 1, conv(y, m.Conv_1, stride, groups=y.shape[1], rnd=r)))
        y = gn(m, 2, conv(y, m.Conv_2, rnd=r))
        return y + h if residual else y

    def stack(s, h, k):
        for i in range(3):
            m = getattr(s, f"MBConv_{i}")
            cin, cout = m.Conv_0.weight.shape[1], m.Conv_2.weight.shape[0]
            h = mbconv(m, h, k, 2 if i == 0 else 1, i > 0 and cin == cout)
        return h

    h = F.relu(gn(fpn, 0, conv(x, fpn.Conv_0, 2, rnd=r)))
    h = F.relu(gn(fpn, 1, conv(h, fpn.Conv_1, groups=h.shape[1], rnd=r)))
    h = gn(fpn, 2, conv(h, fpn.Conv_2, rnd=r))
    c0 = stack(fpn._Stack_0, h, 3)
    c1 = stack(fpn._Stack_1, c0, 5)
    c2 = stack(fpn._Stack_2, c1, 5)
    intra = conv(c2, fpn.Conv_3, rnd=r)
    coarse = intra
    intra = up2(intra) + conv(c1, fpn.Conv_4, rnd=r)
    mid = conv(intra, fpn.Conv_5, rnd=r)
    intra = up2(intra) + conv(c0, fpn.Conv_6, rnd=r)
    fine = conv(intra, fpn.Conv_7, rnd=r)
    return [fine, mid, coarse]


# --------------------------------------------------------------------------
# back-projection
# --------------------------------------------------------------------------

def voxel_world(idx, dim, voxel_size, origin, interval):
    """Linear x-major voxel ids (B, K) -> world points (B, K, 3)."""
    ijk = torch.stack([idx // (dim * dim), (idx // dim) % dim, idx % dim], -1)
    return ijk.float() * interval * voxel_size + origin[:, None, :]


def back_project(feats, proj, origin, idx, slot_valid, dim, voxel_size,
                 interval, prec: Precision):
    """feats (B, V, C, h, w); proj (B, V, 4, 4); idx, slot_valid (B, K).
    Returns features (B, K, C + 1) and view counts (B, K)."""
    B, V, C, h, w = feats.shape
    K = idx.shape[1]
    world = voxel_world(idx, dim, voxel_size, origin, interval)
    homo = torch.cat([world, torch.ones_like(world[..., :1])], -1)
    cam = torch.einsum("bvij,bkj->bvki", proj, homo)
    z = cam[..., 2]
    zs = torch.where(z.abs() > 1e-6, z, torch.full_like(z, 1e-6))
    px, py = cam[..., 0] / zs, cam[..., 1] / zs
    valid = ((px >= 0) & (px <= w - 1) & (py >= 0) & (py <= h - 1) & (z > 0)
             & slot_valid[:, None, :])
    grid = torch.stack([px / (w - 1) * 2 - 1, py / (h - 1) * 2 - 1], -1)
    grid = torch.where(valid[..., None], grid, torch.zeros_like(grid))
    src = prec.r("gather", feats).reshape(B * V, C, h, w)
    taps = F.grid_sample(src, grid.reshape(B * V, K, 1, 2), mode="bilinear",
                         padding_mode="zeros", align_corners=True)
    taps = taps.reshape(B, V, C, K) * valid[:, :, None, :].float()
    vf = valid.float()
    count = vf.sum(1)
    denom = count.clamp(min=1.0)
    mean_f = taps.sum(1) / denom[:, None, :]                     # (B, C, K)
    mean_z = (z * vf).sum(1) / denom
    seen = mean_z > 0
    zero = torch.zeros_like(mean_z)
    n_seen = seen.sum(1).clamp(min=1)
    z_mean = torch.where(seen, mean_z, zero).sum(1) / n_seen
    z_std = torch.sqrt(torch.where(seen, (mean_z - z_mean[:, None]) ** 2,
                                   zero).sum(1)) + 1e-5
    z_norm = torch.where(seen, (mean_z - z_mean[:, None]) / z_std[:, None], zero)
    return torch.cat([mean_f.transpose(1, 2), z_norm[..., None]], -1), count


def first_k(mask_flat, k):
    """Per row of (B, N) bool: the first ``k`` True positions (padded with 0)
    and which slots are real."""
    B = mask_flat.shape[0]
    idx = torch.zeros((B, k), dtype=torch.int64, device=mask_flat.device)
    valid = torch.zeros((B, k), dtype=torch.bool, device=mask_flat.device)
    for b in range(B):
        pos = torch.nonzero(mask_flat[b]).flatten()[:k]
        idx[b, :pos.numel()] = pos
        valid[b, :pos.numel()] = True
    return idx, valid


def scatter_dense(vals, idx, slot_valid, dim):
    """(B, K, C) values at linear ids -> (B, C, d, d, d), zero elsewhere."""
    B, K, C = vals.shape
    out = vals.new_zeros((B, dim ** 3, C))
    v = vals * slot_valid[..., None].to(vals.dtype)
    safe = torch.where(slot_valid, idx, torch.zeros_like(idx))
    out = out.scatter_add(1, safe[..., None].expand(B, K, C), v)
    return out.transpose(1, 2).reshape(B, C, dim, dim, dim)


# --------------------------------------------------------------------------
# dense 3D nets
# --------------------------------------------------------------------------

def dense_unet(u, x, r):
    def cb(m, h, stride=1):
        return F.relu(group_norm(conv(h, m.Conv_0, stride, rnd=r), m.GroupNorm_0))

    def rb(m, h):
        y = group_norm(conv(cb(m.ConvBlock3D_0, h), m.Conv_0, rnd=r), m.GroupNorm_0)
        if hasattr(m, "Conv_1"):
            h = conv(h, m.Conv_1, rnd=r)
        return F.relu(h + y)

    stem = cb(u.ConvBlock3D_0, x)
    d1 = rb(u.ResBlock3D_0, cb(u.ConvBlock3D_1, stem, 2))
    d2 = rb(u.ResBlock3D_1, cb(u.ConvBlock3D_2, d1, 2))
    u1 = rb(u.ResBlock3D_2, torch.cat([up2(d2)[..., :d1.shape[2], :d1.shape[3],
                                                :d1.shape[4]], d1], 1))
    u2 = rb(u.ResBlock3D_3, torch.cat([up2(u1)[..., :stem.shape[2], :stem.shape[3],
                                                :stem.shape[4]], stem], 1))
    return conv(u2, u.Conv_0, rnd=r)


def dense_gru(g, h, x, r):
    c = h.shape[1]
    zr = conv(torch.cat([h, x], 1), g.convzr, rnd=r)
    z, rr = torch.sigmoid(zr[:, :c]), torch.sigmoid(zr[:, c:])
    q = torch.tanh(conv(torch.cat([rr * h, x], 1), g.convq, rnd=r))
    return (1.0 - z) * h + z * q


# --------------------------------------------------------------------------
# block 3D nets: each op on the kept blocks only
# --------------------------------------------------------------------------

class Blocks:
    """The kept blocks of one level: batch index and block coordinates of
    each (N,), the block side ``bs`` at full resolution, the level side."""

    def __init__(self, keep: torch.Tensor, bs: int):
        B, nb = keep.shape[0], keep.shape[1]
        b, bx, by, bz = torch.nonzero(keep, as_tuple=True)
        self.b, self.x, self.y, self.z = b, bx, by, bz
        self.bs, self.nb, self.B = bs, nb, B
        self.keep = keep

    def mask(self, side: int) -> torch.Tensor:
        """(B, 1, n, n, n) float mask of the kept blocks at block side
        ``side`` (n = nb * side)."""
        m = self.keep.float()[:, None]
        for d in range(2, 5):
            m = m.repeat_interleave(side, dim=d)
        return m

    def windows(self, vol: torch.Tensor, side: int, halo: int) -> torch.Tensor:
        """(B, C, n, n, n) -> (N, C, side + 2h, ...): each kept block's region
        with a halo, zero outside the volume."""
        if halo:
            vol = F.pad(vol, (halo,) * 6)
        w = side + 2 * halo
        r = torch.arange(w, device=vol.device)
        ix = (self.x * side)[:, None] + r
        iy = (self.y * side)[:, None] + r
        iz = (self.z * side)[:, None] + r
        g = vol.permute(0, 2, 3, 4, 1)[self.b[:, None, None, None],
                                       ix[:, :, None, None], iy[:, None, :, None],
                                       iz[:, None, None, :]]
        return g.permute(0, 4, 1, 2, 3)

    def place(self, win: torch.Tensor, side: int, fill: float = 0.0) -> torch.Tensor:
        """(N, C, side, side, side) -> (B, C, n, n, n), ``fill`` elsewhere."""
        C, n = win.shape[1], self.nb * side
        out = win.new_full((self.B, n, n, n, C), fill)
        r = torch.arange(side, device=win.device)
        ix = (self.x * side)[:, None] + r
        iy = (self.y * side)[:, None] + r
        iz = (self.z * side)[:, None] + r
        out = out.index_put((self.b[:, None, None, None], ix[:, :, None, None],
                             iy[:, None, :, None], iz[:, None, None, :]),
                            win.permute(0, 2, 3, 4, 1))
        return out.permute(0, 4, 1, 2, 3)


def block_conv(blk: Blocks, x, p, side, stride=1, rnd=None):
    """A conv of ``p`` (k 3 with a 1-voxel halo, or k 1) over the kept blocks
    of ``x`` (B, C, n, n, n) at block side ``side``; zero elsewhere."""
    k = p.weight.shape[-1]
    halo = k // 2
    win = blk.windows(x, side, halo)
    y = conv(win, p, stride, pads=[(0, 0)] * 3, rnd=rnd)
    return blk.place(y, side // stride)


def block_gn(blk: Blocks, x, p, side, eps=1e-5):
    """GroupNorm with statistics over the kept blocks' voxels."""
    win = blk.windows(x, side, 0)                       # (N, C, s, s, s)
    N, C = win.shape[0], win.shape[1]
    G = num_groups(C)
    y = torch.zeros_like(win)
    for b in range(blk.B):
        sel = blk.b == b
        if not bool(sel.any()):
            continue
        v = win[sel].transpose(0, 1).reshape(G, -1)
        mean = v.mean(1, keepdim=True)
        var = ((v - mean) ** 2).mean(1, keepdim=True)
        vn = ((v - mean) * torch.rsqrt(var + eps)).reshape(C, -1, side, side, side)
        y[sel] = vn.transpose(0, 1)
    y = y * p.weight.reshape(1, -1, 1, 1, 1) + p.bias.reshape(1, -1, 1, 1, 1)
    return blk.place(y, side)


def block_unet(blk: Blocks, u, x, r):
    s = blk.bs

    def cb(m, h, side, stride=1):
        y = block_conv(blk, h, m.BlockConv3D_0.Conv_0, side, stride, r)
        return F.relu(block_gn(blk, y, m.BlockGN_0, side // stride))

    def rb(m, h, side):
        y = cb(m.BlockConvBlock3D_0, h, side)
        y = block_gn(blk, block_conv(blk, y, m.BlockConv3D_0.Conv_0, side, 1, r),
                     m.BlockGN_0, side)
        if hasattr(m, "Conv_0"):
            h = block_conv(blk, h, m.Conv_0, side, 1, r)
        return F.relu(h + y)

    stem = cb(u.BlockConvBlock3D_0, x, s)
    d1 = rb(u.BlockResBlock3D_0, cb(u.BlockConvBlock3D_1, stem, s, 2), s // 2)
    d2 = rb(u.BlockResBlock3D_1, cb(u.BlockConvBlock3D_2, d1, s // 2, 2), s // 4)
    u1 = rb(u.BlockResBlock3D_2, torch.cat([up2(d2), d1], 1), s // 2)
    u2 = rb(u.BlockResBlock3D_3, torch.cat([up2(u1), stem], 1), s)
    return block_conv(blk, u2, u.Conv_0, s, 1, r)


def block_gru(blk: Blocks, g, h, x, r):
    s, c = blk.bs, h.shape[1]
    m = blk.mask(s)
    h = h * m
    zr = block_conv(blk, torch.cat([h, x], 1), g.convzr.Conv_0, s, 1, r)
    z, rr = torch.sigmoid(zr[:, :c]), torch.sigmoid(zr[:, c:])
    q = torch.tanh(block_conv(blk, torch.cat([rr * h, x], 1), g.convq.Conv_0, s, 1, r))
    return ((1.0 - z) * h + z * q) * m


def head(p, x):
    """Dense(c, 1) on every voxel of (B, C, ...) -> (B, ...)."""
    return torch.einsum("bc...,c->b...", x, p.weight[0]) + p.bias[0]


def block_head(blk: Blocks, p, x, fill):
    win = blk.windows(x, blk.bs, 0)
    y = torch.einsum("nc...,c->n...", win, p.weight[0]) + p.bias[0]
    return blk.place(y[:, None], blk.bs, fill)[:, 0]


def any_pool(m, k):
    """(B, d, d, d) bool -> (B, d/k, d/k, d/k): any over k³ cells."""
    B, d = m.shape[0], m.shape[1]
    n = d // k
    return m.reshape(B, n, k, n, k, n, k).any(6).any(4).any(2)


# --------------------------------------------------------------------------
# the network
# --------------------------------------------------------------------------

def aligned_coords(world, w2ac, n_vox, voxel_size):
    R, t = w2ac[:, :3, :3], w2ac[:, :3, 3]
    return (torch.einsum("bkj,bij->bki", world, R) + t[:, None, :]) / (n_vox * voxel_size)


def level_sets(c: dict, i: int, prev_occupied, B: int, device):
    """The decisions of level ``i`` from the previous level's occupancy
    (B, d/2, d/2, d/2): the kept blocks (``Blocks``, block levels), the
    voxels back-projected (ids and which slots are real) and the level's
    mask (where it is supervised).  Level 0: every voxel."""
    dim = c["dims"][i]
    N = dim ** 3
    blk = kv = None
    if c["block"][i]:
        bs = c["bs"]
        bmask = any_pool(prev_occupied, bs // 2).reshape(B, -1)
        ids, ok = first_k(bmask, c["max_blocks"][i])
        nb = dim // bs
        # padding slots write to a last, dropped column
        keep = torch.zeros((B, nb ** 3 + 1), dtype=torch.bool, device=device)
        keep.scatter_(1, torch.where(ok, ids, torch.full_like(ids, nb ** 3)), True)
        blk = Blocks(keep[:, :-1].reshape(B, nb, nb, nb), bs)
        kv = blk.mask(bs)[:, 0] > 0                        # kept voxels
        idx, sv = first_k(kv.reshape(B, N), int(kv.reshape(B, N).sum(1).max()))
    elif i > 0 and c["budget"][i] is not None and c["budget"][i] < N:
        idx, sv = first_k(up2(prev_occupied[:, None])[:, 0].reshape(B, N), c["budget"][i])
    else:
        idx = torch.arange(N, device=device).expand(B, N)
        sv = torch.ones((B, N), dtype=torch.bool, device=device)
    if i > 0:
        mask = up2(prev_occupied[:, None])[:, 0]
        if kv is not None:
            mask = mask & kv
    else:
        mask = torch.ones((B, dim, dim, dim), dtype=torch.bool, device=device)
    return blk, kv, idx, sv, mask


def forward(net: RefNet, imgs, proj, origin, w2ac, hidden: List[torch.Tensor],
            prec: Precision = FLOAT32, follow: Optional[List[torch.Tensor]] = None):
    """imgs (B, V, H, W, 3) in [0, 1] units; proj (B, V, L, 4, 4); origin
    (B, 3); hidden: per level (B, C, d, d, d).  Returns per-level lists:
    ``tsdf`` and ``occ`` (B, d, d, d), ``mask`` (the loss's), ``occupied``
    and the new hidden windows.

    ``follow``: per level an occupancy (B, d, d, d) that takes the place of
    this net's own when the next level decides its voxels and blocks (the
    program's decisions, so that a threshold that rounding tips one way in
    the program and the other way here does not change what is compared)."""
    c = net.cfg
    B, V, H, W, _ = imgs.shape
    L = c["n_layers"]
    dev = imgs.device
    pyr = trunk(net.backbone2d.fpn, imgs.reshape(B * V, H, W, 3).permute(0, 3, 1, 2),
                prec)
    out = {"tsdf": [], "occ": [], "mask": [], "occupied": [], "hidden": []}
    prev = None
    for i in range(L):
        scale = L - 1 - i
        interval = 2 ** scale
        dim = c["dims"][i]
        f = pyr[scale]
        feats = f.reshape((B, V) + tuple(f.shape[1:]))
        N = dim ** 3
        prev_occ = None
        if i > 0:
            prev_occ = prev["occupied"] if follow is None else follow[i - 1]
        blk, kv, idx, sv, vox_mask = level_sets(c, i, prev_occ, B, dev)
        bp, _ = back_project(feats, proj[:, :, scale], origin, idx, sv, dim,
                             c["voxel_size"], interval, prec)
        parts = [scatter_dense(bp, idx, sv, dim)]
        if i > 0:
            parts += [up2(prev["feat"]), up2(prev["tsdf"][:, None]),
                      up2(prev["occ"][:, None])]
        grid = torch.arange(N, device=dev).expand(B, N)
        world = voxel_world(grid, dim, c["voxel_size"], origin, interval)
        coords = aligned_coords(world, w2ac, c["n_vox"], c["voxel_size"])
        parts.append(coords.transpose(1, 2).reshape(B, 3, dim, dim, dim))
        x = torch.cat(parts, 1) * vox_mask[:, None].float()
        unet = getattr(net, f"unet{i}")
        gru = getattr(net, f"gru{i}")
        if c["block"][i]:
            r_block = prec.fns["block"]
            feat = block_unet(blk, unet, x, r_block)
            feat = block_gru(blk, gru, hidden[i], feat, r_block)
            new_h = torch.where(kv[:, None], feat, hidden[i])
            tsdf = block_head(blk, getattr(net, f"tsdf_pred{i}"), feat, 1.0)
            occ = block_head(blk, getattr(net, f"occ_pred{i}"), feat, 0.0)
        else:
            r_dense = prec.fns["dense"]
            feat = dense_unet(unet, x, r_dense)
            feat = dense_gru(gru, hidden[i], feat, r_dense)
            new_h = feat
            tsdf = head(getattr(net, f"tsdf_pred{i}"), feat)
            occ = head(getattr(net, f"occ_pred{i}"), feat)
        occupied = (occ > c["thresholds"][i]) & vox_mask
        out["tsdf"].append(tsdf)
        out["occ"].append(occ)
        out["mask"].append(vox_mask)
        out["occupied"].append(occupied)
        out["hidden"].append(new_h)
        prev = dict(feat=feat, tsdf=tsdf, occ=occ, occupied=occupied)
    return out


def occupancy(c: dict, occ: List[torch.Tensor], mask: List[torch.Tensor]):
    """Per level, the voxels a forward marked occupied: logit over the
    level's threshold, inside its mask."""
    return [(o > c["thresholds"][i]) & m.bool() for i, (o, m) in enumerate(zip(occ, mask))]


def mask_mismatch(c: dict, occ: List[torch.Tensor], mask: List[torch.Tensor],
                  rows: int) -> int:
    """Voxels where a level's mask is not what the decisions of the level
    before it give: ``occ`` and ``mask`` are one forward's per-level
    occupancy logits and masks (B, d, d, d) of a batch of ``rows`` rows
    (each row the forward left out counts with all its first level's
    voxels); ``c`` is ``RefNet.cfg``."""
    B = occ[0].shape[0]
    bad = int((~mask[0].bool()).sum()) + max(rows - B, 0) * c["dims"][0] ** 3
    for i in range(1, c["n_layers"]):
        prev = (occ[i - 1] > c["thresholds"][i - 1]) & mask[i - 1].bool()
        want = level_sets(c, i, prev, B, occ[0].device)[4]
        bad += int((want != mask[i].bool()).sum())
    return bad


# --------------------------------------------------------------------------
# loss, global volumes
# --------------------------------------------------------------------------

def level_sums(t, x, tt, y, m):
    """The loss's five sums at one level: Σm, Σm·y, Σm·y·(−logσx),
    Σm·(1−y)·(−logσ(−x)), Σm·y·|slog t − slog tt|."""
    m, y = m.float(), y.float()
    my = m * y
    return torch.stack([m.sum(), my.sum(), (my * -F.logsigmoid(x)).sum(),
                        (m * (1.0 - y) * -F.logsigmoid(-x)).sum(),
                        (my * torch.abs(slog(t) - slog(tt))).sum()])


def combine(sums, counts, pos_weight):
    """A level's loss from its sums; ``counts`` gives Σm and Σm·y (those of
    the whole batch when ``sums`` is one part of it)."""
    n_all, n_p = counts[0], counts[1]
    w1 = torch.where(n_p > 0, (n_all - n_p) / n_p.clamp(min=1.0),
                     torch.zeros_like(n_p)) * pos_weight
    occ_loss = (w1 * sums[2] + sums[3]) / n_all.clamp(min=1.0)
    tsdf_loss = sums[4] / n_p.clamp(min=1.0)
    return torch.where(n_p > 0, occ_loss + tsdf_loss, torch.zeros_like(occ_loss))


def level_terms(net: RefNet, out, tsdf_list, occ_list):
    """Per level, the five sums of ``out`` against the targets (finest
    listed first)."""
    L = net.cfg["n_layers"]
    return [level_sums(out["tsdf"][i], out["occ"][i], tsdf_list[L - 1 - i],
                       occ_list[L - 1 - i], out["mask"][i]) for i in range(L)]


def loss(net: RefNet, out, tsdf_list, occ_list, counts=None):
    """Σ lw[i] · level i's loss.  ``counts``: per level the batch's (Σm,
    Σm·y) when ``out`` is one part of the batch; by default its own."""
    c = net.cfg
    terms = level_terms(net, out, tsdf_list, occ_list)
    total = 0.0
    for i, s in enumerate(terms):
        total = total + c["lw"][i] * combine(s, s if counts is None else counts[i],
                                             c["pos_weight"])
    return total


def window_starts(net: RefNet, origin, vol_origin):
    """Per level, the (B, 3) start of each sample's window in its global
    volume: the offset in that level's voxels, rounded half to even and
    clamped into the extent."""
    c = net.cfg
    L = c["n_layers"]
    out = []
    for i in range(L):
        vs = c["voxel_size"] * 2 ** (L - 1 - i)
        s = torch.round((origin - vol_origin) / vs).long()
        out.append(s.clamp(0, c["global_dims"][i] - c["dims"][i]))
    return out


def read_hidden(net: RefNet, volumes, starts):
    """Global volumes (B, C, G, G, G) -> the windows at ``starts``."""
    wins = []
    for v, s, d in zip(volumes, starts, net.cfg["dims"]):
        wins.append(torch.stack([v[b, :, s[b, 0]:s[b, 0] + d, s[b, 1]:s[b, 1] + d,
                                   s[b, 2]:s[b, 2] + d] for b in range(v.shape[0])]))
    return wins


def write_hidden(net: RefNet, volumes, starts, windows, prec: Precision):
    out = []
    for v, s, w in zip(volumes, starts, windows):
        v = v.clone()
        d = w.shape[2]
        for b in range(v.shape[0]):
            v[b, :, s[b, 0]:s[b, 0] + d, s[b, 1]:s[b, 1] + d,
              s[b, 2]:s[b, 2] + d] = prec.r("hidden", w[b].detach())
        out.append(v)
    return out


def zero_volumes(net: RefNet, batch: int, device):
    c = net.cfg
    return [torch.zeros((batch, ch, g, g, g), device=device)
            for ch, g in zip(c["channels"], c["global_dims"])]


def normalise_images(net: RefNet, imgs):
    if imgs.dtype == torch.uint8:
        mean, std = net.cfg["img_norm"]
        return (imgs.float() / 255.0 - mean) / std
    return imgs
