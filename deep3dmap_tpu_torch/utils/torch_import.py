"""Torch checkpoints -> the flax ``.npz`` layouts the port reads (port of
``deep3dmap_tpu/utils/torch_import.py``): ``import_stylegan2_generator``
and ``import_stylegan2_discriminator`` for rosinality's StyleGAN2
(Gan2Shape's ``gan_ckpt``), ``import_vgg16_features`` for torchvision's
VGG16 (``PerceptualLoss``'s ``weights_path``), ``import_bisenet`` for the
face-parsing BiSeNet (``parsing_ckpt``), ``import_clip`` for OpenAI/OpenCLIP
ViT CLIP and ``import_dino`` for DINO ViTs, with the shape-sniffing that
recovers their configs, and ``import_mnasnet_trunk`` for torchvision's
MNASNet (NeuralRecon's ``BACKBONE2D.CKPT``).  A user imports every
checkpoint the repository consumes with no JAX installed
(``tools/import_weights.py``), and the files are the JAX tool's key for
key.

Conventions (as the JAX importers'):

  torch conv weight   (O, I, kH, kW) -> flax (kH, kW, I, O)
  torch linear weight (O, I)         -> flax (I, O)
  NCHW constant tensors              -> NHWC

Each tree is checked against the port's module of the recovered config (on
the ``meta`` device, no memory): a leaf missing, extra or of another shape
raises, as the JAX importers' ``fill_like`` does.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def to_numpy(t) -> np.ndarray:
    """A torch tensor or array-like -> float32 numpy."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def conv_kernel(t) -> np.ndarray:
    """(O, I, kH, kW) -> (kH, kW, I, O)."""
    return np.transpose(to_numpy(t), (2, 3, 1, 0))


def linear_kernel(t) -> np.ndarray:
    """(O, I) -> (I, O)."""
    return to_numpy(t).T


def _strip_module(sd: Mapping) -> Dict:
    return {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}


def _nest(flat: Dict[str, np.ndarray]) -> Dict:
    """{'a/b/c': x} -> {'params': {'a': {'b': {'c': x}}}}, float32 arrays."""
    tree: Dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.array(v, np.float32)  # keeps 0-d leaves 0-d
    return {"params": tree}


def _checked(module_cls, cfg: dict, tree: Dict) -> Dict:
    from .from_flax import _torch_layout

    with torch.device("meta"):
        module = module_cls(**cfg)
    _torch_layout(module, tree)     # raises on a missing, extra or misshapen leaf
    return tree


def clip_cfg_from_state_dict(sd: Mapping) -> Tuple[dict, dict]:
    """(vision_cfg, text_cfg) of a CLIP ViT state dict, sniffed from its
    shapes as the reference's ``build_model`` does."""
    vw = sd["visual.conv1.weight"].shape
    vision_width, patch = int(vw[0]), int(vw[-1])
    vision_layers = len({k.split(".")[3] for k in sd
                         if k.startswith("visual.transformer.resblocks.")})
    grid = int(round(math.sqrt(sd["visual.positional_embedding"].shape[0] - 1)))
    embed_dim = int(sd["text_projection"].shape[1])
    text_width = int(sd["ln_final.weight"].shape[0])
    text_layers = len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")})
    vision_cfg = dict(patch=patch, width=vision_width, layers=vision_layers,
                      heads=max(vision_width // 64, 1), embed_dim=embed_dim,
                      image_size=patch * grid)
    text_cfg = dict(vocab_size=int(sd["token_embedding.weight"].shape[0]),
                    ctx_len=int(sd["positional_embedding"].shape[0]),
                    width=text_width, layers=text_layers,
                    heads=max(text_width // 64, 1), embed_dim=embed_dim)
    return vision_cfg, text_cfg


def _clip_blocks(sd: Mapping, prefix: str, layers: int, out: Dict[str, np.ndarray]) -> None:
    for i in range(layers):
        src, dst = f"{prefix}transformer.resblocks.{i}", f"resblock{i}"
        out[f"{dst}/ln_1/scale"] = to_numpy(sd[f"{src}.ln_1.weight"])
        out[f"{dst}/ln_1/bias"] = to_numpy(sd[f"{src}.ln_1.bias"])
        out[f"{dst}/attn/in_proj/kernel"] = linear_kernel(sd[f"{src}.attn.in_proj_weight"])
        out[f"{dst}/attn/in_proj/bias"] = to_numpy(sd[f"{src}.attn.in_proj_bias"])
        out[f"{dst}/attn/out_proj/kernel"] = linear_kernel(sd[f"{src}.attn.out_proj.weight"])
        out[f"{dst}/attn/out_proj/bias"] = to_numpy(sd[f"{src}.attn.out_proj.bias"])
        out[f"{dst}/ln_2/scale"] = to_numpy(sd[f"{src}.ln_2.weight"])
        out[f"{dst}/ln_2/bias"] = to_numpy(sd[f"{src}.ln_2.bias"])
        out[f"{dst}/mlp_c_fc/kernel"] = linear_kernel(sd[f"{src}.mlp.c_fc.weight"])
        out[f"{dst}/mlp_c_fc/bias"] = to_numpy(sd[f"{src}.mlp.c_fc.bias"])
        out[f"{dst}/mlp_c_proj/kernel"] = linear_kernel(sd[f"{src}.mlp.c_proj.weight"])
        out[f"{dst}/mlp_c_proj/bias"] = to_numpy(sd[f"{src}.mlp.c_proj.bias"])


def import_clip(sd: Mapping):
    """OpenAI/OpenCLIP ViT CLIP state dict -> (vision_cfg, text_cfg,
    vision_params, text_params, logit_scale) for ``CLIPViT``."""
    from ..models.modulars.clip_vit import TextTransformer, VisionTransformer

    sd = _strip_module(sd)
    vision_cfg, text_cfg = clip_cfg_from_state_dict(sd)
    v: Dict[str, np.ndarray] = {
        "class_embedding": to_numpy(sd["visual.class_embedding"]),
        "positional_embedding": to_numpy(sd["visual.positional_embedding"]),
        "conv1/kernel": conv_kernel(sd["visual.conv1.weight"]),
        "ln_pre/scale": to_numpy(sd["visual.ln_pre.weight"]),
        "ln_pre/bias": to_numpy(sd["visual.ln_pre.bias"])}
    _clip_blocks(sd, "visual.", vision_cfg["layers"], v)
    v["ln_post/scale"] = to_numpy(sd["visual.ln_post.weight"])
    v["ln_post/bias"] = to_numpy(sd["visual.ln_post.bias"])
    v["proj"] = to_numpy(sd["visual.proj"])      # stored (width, embed) already
    t: Dict[str, np.ndarray] = {
        "token_embedding/embedding": to_numpy(sd["token_embedding.weight"]),
        "positional_embedding": to_numpy(sd["positional_embedding"])}
    _clip_blocks(sd, "", text_cfg["layers"], t)
    t["ln_final/scale"] = to_numpy(sd["ln_final.weight"])
    t["ln_final/bias"] = to_numpy(sd["ln_final.bias"])
    t["text_projection"] = to_numpy(sd["text_projection"])
    vision = _checked(VisionTransformer, vision_cfg, _nest(v))
    text = _checked(TextTransformer, text_cfg, _nest(t))
    logit_scale = (float(np.exp(to_numpy(sd["logit_scale"]))) if "logit_scale" in sd
                   else 100.0)
    return vision_cfg, text_cfg, vision, text, logit_scale


def dino_cfg_from_state_dict(sd: Mapping) -> Dict[str, int]:
    """(patch_size, dim, depth, heads, mlp_ratio, base_grid) of a DINO ViT
    state dict (facebookresearch/dino's layout)."""
    w = np.asarray(sd["patch_embed.proj.weight"].shape)     # (D, 3, p, p)
    dim, patch = int(w[0]), int(w[2])
    depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    n_pos = int(sd["pos_embed"].shape[1]) - 1
    heads = {384: 6, 768: 12, 192: 3, 1024: 16}[dim]
    return dict(patch_size=patch, dim=dim, depth=depth, heads=heads, mlp_ratio=4,
                base_grid=int(round(n_pos ** 0.5)))


def import_dino(sd: Mapping):
    """DINO ViT checkpoint (dino_vits8/vits16/vitb8/vitb16) -> (cfg, params)
    for ``DinoViT``; head weights are dropped (the extractor reads backbone
    facets only)."""
    from ..models.modulars.dino_vit import DinoViT

    sd = {k: v for k, v in _strip_module(sd).items() if not k.startswith("head.")}
    cfg = dino_cfg_from_state_dict(sd)
    flat: Dict[str, np.ndarray] = {
        "cls_token": to_numpy(sd["cls_token"]), "pos_embed": to_numpy(sd["pos_embed"]),
        "patch_embed/kernel": conv_kernel(sd["patch_embed.proj.weight"]),
        "patch_embed/bias": to_numpy(sd["patch_embed.proj.bias"])}
    for i in range(cfg["depth"]):
        src, dst = f"blocks.{i}", f"block{i}"
        for a, b in (("norm1", "norm1"), ("norm2", "norm2")):
            flat[f"{dst}/{b}/scale"] = to_numpy(sd[f"{src}.{a}.weight"])
            flat[f"{dst}/{b}/bias"] = to_numpy(sd[f"{src}.{a}.bias"])
        for a, b in (("attn.qkv", "qkv"), ("attn.proj", "proj"), ("mlp.fc1", "fc1"),
                     ("mlp.fc2", "fc2")):
            flat[f"{dst}/{b}/kernel"] = linear_kernel(sd[f"{src}.{a}.weight"])
            flat[f"{dst}/{b}/bias"] = to_numpy(sd[f"{src}.{a}.bias"])
    flat["norm/scale"] = to_numpy(sd["norm.weight"])
    flat["norm/bias"] = to_numpy(sd["norm.bias"])
    return cfg, _checked(DinoViT, cfg, _nest(flat))


def _styled_conv(sd: Mapping, src: str, dst: str, out: Dict[str, np.ndarray]) -> None:
    """rosinality StyledConv ``src.*`` -> the port's StyledConv ``dst/*``."""
    w = to_numpy(sd[f"{src}.conv.weight"])  # (1, O, I, k, k)
    out[f"{dst}/conv/weight"] = np.transpose(w[0], (2, 3, 1, 0))
    out[f"{dst}/conv/modulation/weight"] = linear_kernel(sd[f"{src}.conv.modulation.weight"])
    # the modulation adds +1.0 after its bias; rosinality stores bias_init=1
    # in the bias itself -> subtract the shift once here
    out[f"{dst}/conv/modulation/bias"] = to_numpy(sd[f"{src}.conv.modulation.bias"]) - 1.0
    out[f"{dst}/noise_strength"] = to_numpy(sd[f"{src}.noise.weight"]).reshape(())
    out[f"{dst}/bias"] = to_numpy(sd[f"{src}.activate.bias"])


def _to_rgb(sd: Mapping, src: str, dst: str, out: Dict[str, np.ndarray]) -> None:
    w = to_numpy(sd[f"{src}.conv.weight"])  # (1, 3, I, 1, 1)
    out[f"{dst}/conv/weight"] = np.transpose(w[0], (2, 3, 1, 0))
    out[f"{dst}/conv/modulation/weight"] = linear_kernel(sd[f"{src}.conv.modulation.weight"])
    out[f"{dst}/conv/modulation/bias"] = to_numpy(sd[f"{src}.conv.modulation.bias"]) - 1.0
    out[f"{dst}/bias"] = to_numpy(sd[f"{src}.bias"]).reshape(3)


def import_stylegan2_generator(sd: Mapping, size: int = 128,
                               n_mlp: int = 8) -> Dict[str, np.ndarray]:
    """rosinality stylegan2-pytorch Generator state dict -> a flat dict
    keyed ``params/<module>/<leaf>`` for ``modulars/stylegan2.Generator``."""
    sd = _strip_module(sd)
    out: Dict[str, np.ndarray] = {}
    # mapping MLP: style.0 is PixelNorm (no params), style.1..n_mlp EqualLinear
    for i in range(n_mlp):
        out[f"mapping/dense_{i}/weight"] = linear_kernel(sd[f"style.{i + 1}.weight"])
        out[f"mapping/dense_{i}/bias"] = to_numpy(sd[f"style.{i + 1}.bias"])
    out["input_const"] = np.transpose(to_numpy(sd["input.input"]), (0, 2, 3, 1))
    _styled_conv(sd, "conv1", "conv1", out)
    _to_rgb(sd, "to_rgb1", "to_rgb1", out)
    for j in range(int(math.log2(size)) - 2):
        res = 8 * (2 ** j)
        _styled_conv(sd, f"convs.{2 * j}", f"conv_{res}_up", out)
        _styled_conv(sd, f"convs.{2 * j + 1}", f"conv_{res}", out)
        _to_rgb(sd, f"to_rgbs.{j}", f"to_rgb_{res}", out)
    return {"params/" + k: v for k, v in out.items()}


def import_stylegan2_discriminator(sd: Mapping, size: int = 128,
                                   channel_multiplier: int = 2) -> Dict[str, np.ndarray]:
    """rosinality Discriminator state dict -> a flat dict for
    ``modulars/stylegan2.StyleDiscriminator``."""
    sd = _strip_module(sd)
    out: Dict[str, np.ndarray] = {}
    out["from_rgb_weight"] = conv_kernel(sd["convs.0.0.weight"])
    out["frgb_b"] = to_numpy(sd["convs.0.1.bias"])
    res = size
    for i in range(1, int(math.log2(size)) - 1):
        dst = f"block_{res}"
        out[f"{dst}/conv1_weight"] = conv_kernel(sd[f"convs.{i}.conv1.0.weight"])
        out[f"{dst}/b1"] = to_numpy(sd[f"convs.{i}.conv1.1.bias"])
        out[f"{dst}/conv2_weight"] = conv_kernel(sd[f"convs.{i}.conv2.1.weight"])
        out[f"{dst}/b2"] = to_numpy(sd[f"convs.{i}.conv2.2.bias"])
        out[f"{dst}/skip_weight"] = conv_kernel(sd[f"convs.{i}.skip.1.weight"])
        res //= 2
    out["final_conv_weight"] = conv_kernel(sd["final_conv.0.weight"])
    out["fc_b"] = to_numpy(sd["final_conv.1.bias"])
    # torch flattens (C, 4, 4) row-major, the port (4, 4, C): permute rows
    w0 = to_numpy(sd["final_linear.0.weight"])  # (O, C*16)
    ch4 = w0.shape[1] // 16
    w0 = w0.reshape(-1, ch4, 4, 4).transpose(0, 2, 3, 1).reshape(w0.shape[0], -1)
    out["final_dense/weight"] = w0.T
    out["final_dense/bias"] = to_numpy(sd["final_linear.0.bias"])
    out["out/weight"] = linear_kernel(sd["final_linear.1.weight"])
    out["out/bias"] = to_numpy(sd["final_linear.1.bias"])
    return {"params/" + k: v for k, v in out.items()}


# torchvision vgg16 ``features.`` conv indices, in trunk order
_VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def import_vgg16_features(sd: Mapping) -> Dict[str, np.ndarray]:
    """torchvision vgg16 state dict (``features.N.weight/bias``) -> a flat
    dict for ``losses/perceptual_loss._VGGFeatures`` (13 convs)."""
    sd = _strip_module(sd)
    prefix = "features." if any(k.startswith("features.") for k in sd) else ""
    out: Dict[str, np.ndarray] = {}
    for n, idx in enumerate(_VGG16_CONV_IDX):
        out[f"params/Conv_{n}/kernel"] = conv_kernel(sd[f"{prefix}{idx}.weight"])
        out[f"params/Conv_{n}/bias"] = to_numpy(sd[f"{prefix}{idx}.bias"])
    return out


def import_bisenet(sd: Mapping, n_classes: int = 19) -> Dict:
    """The face-parsing BiSeNet checkpoint (Gan2Shape's face parser) -> the
    flax tree ``{"params": ...}`` of ``parsing/bisenet_fp.BiSeNetFP``.
    BatchNorms fold into the convs before them (exact in eval mode); the aux
    training heads (``conv_out16``/``conv_out32``) are dropped."""
    from ..models.parsing.bisenet_fp import BiSeNetFP

    sd = _strip_module(sd)
    out: Dict[str, np.ndarray] = {}

    def put(dst, conv_key, bn_key):
        out[f"{dst}/kernel"], out[f"{dst}/bias"] = _fold_bn(sd, conv_key, bn_key)

    put("resnet/conv1", "cp.resnet.conv1", "cp.resnet.bn1")
    for L in (1, 2, 3, 4):
        for B in range(2):
            src, dst = f"cp.resnet.layer{L}.{B}", f"resnet/layer{L}_{B}"
            put(f"{dst}/conv1", f"{src}.conv1", f"{src}.bn1")
            put(f"{dst}/conv2", f"{src}.conv2", f"{src}.bn2")
            if L > 1 and B == 0:
                put(f"{dst}/downsample", f"{src}.downsample.0", f"{src}.downsample.1")
    for arm in ("arm16", "arm32"):
        put(f"{arm}/conv", f"cp.{arm}.conv.conv", f"cp.{arm}.conv.bn")
        put(f"{arm}/conv_atten", f"cp.{arm}.conv_atten", f"cp.{arm}.bn_atten")
    put("conv_avg", "cp.conv_avg.conv", "cp.conv_avg.bn")
    put("conv_head16", "cp.conv_head16.conv", "cp.conv_head16.bn")
    put("conv_head32", "cp.conv_head32.conv", "cp.conv_head32.bn")
    put("ffm_convblk", "ffm.convblk.conv", "ffm.convblk.bn")
    out["ffm_conv1/kernel"] = conv_kernel(sd["ffm.conv1.weight"])
    out["ffm_conv2/kernel"] = conv_kernel(sd["ffm.conv2.weight"])
    put("out_conv", "conv_out.conv.conv", "conv_out.conv.bn")
    out["out_cls/kernel"] = conv_kernel(sd["conv_out.conv_out.weight"])
    out["out_cls/bias"] = (to_numpy(sd["conv_out.conv_out.bias"])
                           if "conv_out.conv_out.bias" in sd
                           else np.zeros(sd["conv_out.conv_out.weight"].shape[0], np.float32))
    return _checked(BiSeNetFP, dict(n_classes=n_classes), _nest(out))


def _unflat(flat: Dict[str, np.ndarray]) -> Dict:
    """``params/``-keyed flat dict -> the nested ``{"params": ...}`` tree."""
    return _nest({k[len("params/"):]: v for k, v in flat.items()})


def _fold_bn(sd: Mapping, conv_key: str, bn_key: str, eps: float = 1e-5):
    """Eval-mode BatchNorm folded into the conv before it: the flax-layout
    (kernel HWIO, bias), exact for inference (BN(x*w) == x*w' + b')."""
    w = conv_kernel(sd[f"{conv_key}.weight"])  # (kH, kW, I, O)
    gamma = to_numpy(sd[f"{bn_key}.weight"])
    beta = to_numpy(sd[f"{bn_key}.bias"])
    mean = to_numpy(sd[f"{bn_key}.running_mean"])
    var = to_numpy(sd[f"{bn_key}.running_var"])
    scale = gamma / np.sqrt(var + eps)
    return w * scale, beta - mean * scale


def _mnasnet_trunk_flat(sd: Mapping) -> Dict[str, np.ndarray]:
    """torchvision MNASNet ``layers[0:8]`` and stages 8/9/10, BatchNorms
    folded, under the flax paths of ``MnasFPN(norm="none")``."""
    sd = _strip_module(sd)
    # some checkpoints nest the trunk ('backbone2d.layers.0.weight'): keep
    # everything from the first 'layers.' on
    if not any(k.startswith("layers.") for k in sd):
        sd = {"layers." + k.split("layers.", 1)[1]: v for k, v in sd.items() if "layers." in k}
    out: Dict[str, np.ndarray] = {}

    def put(dst, conv_key, bn_key):
        out[f"{dst}/kernel"], out[f"{dst}/bias"] = _fold_bn(sd, conv_key, bn_key)

    # stem: layers 0/1 conv+BN, 3/4 depthwise+BN, 6/7 project+BN
    put("Conv_0", "layers.0", "layers.1")
    put("Conv_1", "layers.3", "layers.4")
    put("Conv_2", "layers.6", "layers.7")
    # stages 8/9/10 -> _Stack_0/1/2, 3 inverted residuals each, whose inner
    # Sequential is [0 expand, 1 BN, 3 depthwise, 4 BN, 6 project, 7 BN]
    for stack, layer in enumerate((8, 9, 10)):
        for block in range(3):
            src, dst = f"layers.{layer}.{block}.layers", f"_Stack_{stack}/MBConv_{block}"
            put(f"{dst}/Conv_0", f"{src}.0", f"{src}.1")
            put(f"{dst}/Conv_1", f"{src}.3", f"{src}.4")
            put(f"{dst}/Conv_2", f"{src}.6", f"{src}.7")
    return out


def import_mnasnet_trunk(sd: Mapping, alpha: float = 1.0, seed: int = 0,
                         device="cpu") -> Dict:
    """A torchvision MNASNet state dict -> the flax tree ``{"params": ...}``
    of ``MnasFPN(alpha, norm="none", torch_pad=True)``: the trunk from the
    checkpoint with its BatchNorms folded, the FPN's lateral and output
    convs (which have no torch source) from the port's seeded init on
    ``device``.  A trunk leaf of another shape raises ``ValueError``, an
    unknown one ``KeyError``, as JAX's ``merge_into`` does."""
    from ..models.backbones.fpn2d import MnasFPN
    from ..models.layers import init_flax_defaults
    from .from_flax import to_flax_params

    sd = {k: to_numpy(v) for k, v in sd.items() if hasattr(v, "shape")}
    flat = _mnasnet_trunk_flat(sd)
    module = MnasFPN(alpha=alpha, norm="none", torch_pad=True)
    init_flax_defaults(module, torch.Generator().manual_seed(int(seed)))
    tree = to_flax_params(module.to(device))
    for key, arr in flat.items():
        node, parts = tree, key.split("/")
        for k in parts[:-1]:
            if k not in node:
                raise KeyError(f"importer produced unknown parameters: {key!r}")
            node = node[k]
        if parts[-1] not in node:
            raise KeyError(f"importer produced unknown parameters: {key!r}")
        if np.shape(node[parts[-1]]) != arr.shape:
            raise ValueError(f"params/{key}: torch shape {arr.shape} != "
                             f"flax shape {np.shape(node[parts[-1]])}")
        node[parts[-1]] = np.ascontiguousarray(arr, np.float32)
    return {"params": tree}


def import_npz_entries(kind: str, sd: Mapping, **kw) -> Dict[str, np.ndarray]:
    """The ``.npz`` entries of ``tools/import_weights.py`` for ``kind``:
    ``clip`` -> ``vision``, ``text`` (flax trees) and ``meta`` (the configs,
    the logit scale); ``dino`` -> ``params`` and ``meta`` (the config);
    ``mnasnet`` -> ``params`` (``import_mnasnet_trunk``'s tree; ``kw``:
    ``alpha``, ``device``); ``stylegan2`` -> ``g`` and ``d`` from a
    checkpoint holding ``g_ema`` (or ``g``) and ``d``, ``stylegan2_g`` /
    ``stylegan2_d`` one of them (``kw``: ``size``, ``n_mlp``,
    ``channel_multiplier``, ``style_dim``); ``vgg16`` and ``bisenet`` ->
    ``params``."""
    if kind.startswith("stylegan2"):
        return _stylegan2_entries(kind, sd, **kw)
    sd = {k: to_numpy(v) for k, v in sd.items() if hasattr(v, "shape")}
    if kind == "clip":
        vision_cfg, text_cfg, vision, text, logit_scale = import_clip(sd)
        return {"vision": np.array(vision, dtype=object), "text": np.array(text, dtype=object),
                "meta": np.array(dict(vision_cfg=vision_cfg, text_cfg=text_cfg,
                                      logit_scale=logit_scale), dtype=object)}
    if kind == "dino":
        cfg, params = import_dino(sd)
        return {"params": np.array(params, dtype=object), "meta": np.array(cfg, dtype=object)}
    if kind == "mnasnet":
        return {"params": np.array(import_mnasnet_trunk(sd, **kw), dtype=object)}
    if kind == "vgg16":
        from ..models.losses.perceptual_loss import _VGGFeatures

        tree = _checked(_VGGFeatures, {}, _unflat(import_vgg16_features(sd)))
        return {"params": np.array(tree, dtype=object)}
    if kind == "bisenet":
        return {"params": np.array(import_bisenet(sd), dtype=object)}
    raise ValueError(f"unknown import kind {kind!r} "
                     "(clip, dino, mnasnet, stylegan2, stylegan2_g, stylegan2_d, vgg16, bisenet)")


def _stylegan2_entries(kind: str, raw: Mapping, size: int = 128, n_mlp: int = 8,
                       channel_multiplier: int = 2, style_dim: int = 512) -> Dict:
    from ..models.modulars.stylegan2 import Generator, StyleDiscriminator

    def host(d):
        return {k: to_numpy(v) for k, v in d.items() if hasattr(v, "shape")}

    out = {}
    if kind in ("stylegan2", "stylegan2_g"):
        flat = import_stylegan2_generator(host(raw.get("g_ema", raw.get("g", raw))),
                                          size=size, n_mlp=n_mlp)
        cfg = dict(size=size, style_dim=style_dim, n_mlp=n_mlp,
                   channel_multiplier=channel_multiplier, device="meta")
        out["g"] = np.array(_checked(Generator, cfg, _unflat(flat)), dtype=object)
    if kind in ("stylegan2", "stylegan2_d"):
        flat = import_stylegan2_discriminator(host(raw.get("d", raw)), size=size,
                                              channel_multiplier=channel_multiplier)
        cfg = dict(size=size, channel_multiplier=channel_multiplier, device="meta")
        out["d"] = np.array(_checked(StyleDiscriminator, cfg, _unflat(flat)), dtype=object)
    if not out:
        raise ValueError(f"unknown import kind {kind!r}")
    return out
