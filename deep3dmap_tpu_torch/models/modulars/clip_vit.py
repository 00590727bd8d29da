"""Full CLIP, the OpenAI architecture: ViT vision tower and causal text
transformer (port of ``deep3dmap_tpu/models/modulars/clip_vit.py``), so
released OpenAI/OpenCLIP ViT checkpoints load key for key through
``utils/torch_import.py::import_clip`` (``tools/import_weights.py clip``).

  vision: conv patch embed -> [CLS; patches] + position embedding
          (bilinear-resized, JAX's ``jax.image.resize``, for another input
          size) -> ln_pre -> L x (ln_1 -> MHA -> residual -> ln_2 ->
          MLP(QuickGELU) -> residual) -> ln_post[CLS] -> proj
  text:   token + position embedding -> causal transformer -> ln_final at
          the end token (the largest id) -> text_projection

Children are named as the flax ones (``conv1``, ``resblock{i}``,
``attn.in_proj``, ``mlp_c_fc``, ...), so a flax tree loads by name
(``utils/from_flax.py``).  ``BPETokenizer`` is CLIP's byte-pair encoder
over the public gzip vocab, which the user supplies.
"""
from __future__ import annotations

import gzip
import html
import math
import re
from functools import lru_cache
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ...ops.resize import resize_bilinear
from ...utils.device import DeviceLike, resolve_device
from ..layers import Conv, Dense, Embed, LayerNorm, init_flax_defaults


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _attend(q, k, v, heads: int, mask: Optional[torch.Tensor] = None):
    """(B, L, D) q, k, v -> (B, L, D): per-head softmax(q k^T / sqrt(hd)) v."""
    B, L, D = q.shape
    hd = D // heads

    def split(t):
        return t.reshape(B, L, heads, hd).transpose(1, 2)

    att = split(q) @ split(k).transpose(-1, -2) / math.sqrt(hd)
    if mask is not None:
        att = att + mask
    out = torch.softmax(att, -1) @ split(v)
    return out.transpose(1, 2).reshape(B, L, D), att


class MultiheadAttention(nn.Module):
    """``torch.nn.MultiheadAttention``'s factoring: fused q/k/v in-projection
    and an out-projection."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj = Dense(dim, 3 * dim)
        self.out_proj = Dense(dim, dim)

    def forward(self, x, mask=None):
        q, k, v = self.in_proj(x).chunk(3, -1)
        return self.out_proj(_attend(q, k, v, self.heads, mask)[0])


class ResidualAttentionBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.attn = MultiheadAttention(dim, heads)
        self.ln_1 = LayerNorm(dim, eps=1e-6)
        self.ln_2 = LayerNorm(dim, eps=1e-6)
        self.mlp_c_fc = Dense(dim, 4 * dim)
        self.mlp_c_proj = Dense(4 * dim, dim)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp_c_proj(quick_gelu(self.mlp_c_fc(self.ln_2(x))))


def resize_pos_embed(pos: torch.Tensor, n_new: int) -> torch.Tensor:
    """A (1 + g², w) position embedding -> (1 + g'², w): the grid part
    resized bilinearly as ``jax.image.resize`` does."""
    cls, grid = pos[:1], pos[1:]
    g = int(round(math.sqrt(grid.shape[0])))
    g_new = int(round(math.sqrt(n_new - 1)))
    grid = resize_bilinear(grid.reshape(1, g, g, -1), g_new)
    return torch.cat([cls, grid.reshape(g_new * g_new, -1)], 0)


class VisionTransformer(nn.Module):
    """img (B, H, W, 3), CLIP-normalised -> (B, embed_dim)."""

    FLAX_LEAVES = {"class_embedding": ("class_embedding", "plain"),
                   "positional_embedding": ("positional_embedding", "plain"),
                   "proj": ("proj", "plain")}

    def __init__(self, patch: int = 16, width: int = 768, layers: int = 12, heads: int = 12,
                 embed_dim: int = 512, image_size: int = 224):
        super().__init__()
        self.patch, self.width, self.layers, self.image_size = patch, width, layers, image_size
        self.conv1 = Conv(3, width, (patch, patch), strides=patch, use_bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty((image_size // patch) ** 2 + 1, width))
        self.ln_pre = LayerNorm(width)
        for i in range(layers):
            setattr(self, f"resblock{i}", ResidualAttentionBlock(width, heads))
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, embed_dim))

    def init_raw(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            for p in (self.class_embedding, self.positional_embedding, self.proj):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        B = img.shape[0]
        x = self.conv1(img).reshape(B, -1, self.width)
        x = torch.cat([self.class_embedding.to(x.dtype).expand(B, 1, self.width), x], 1)
        pos = self.positional_embedding
        if x.shape[1] != pos.shape[0]:
            pos = resize_pos_embed(pos, x.shape[1])
        x = self.ln_pre(x + pos[None].to(x.dtype))
        for i in range(self.layers):
            x = getattr(self, f"resblock{i}")(x)
        return self.ln_post(x[:, 0]) @ self.proj.to(x.dtype)


class TextTransformer(nn.Module):
    """tokens (B, L) -> (B, embed_dim), read at each row's largest id."""

    FLAX_LEAVES = {"positional_embedding": ("positional_embedding", "plain"),
                   "text_projection": ("text_projection", "plain")}

    def __init__(self, vocab_size: int = 49408, ctx_len: int = 77, width: int = 512,
                 layers: int = 12, heads: int = 8, embed_dim: int = 512):
        super().__init__()
        self.vocab_size, self.ctx_len, self.layers = vocab_size, ctx_len, layers
        self.token_embedding = Embed(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(ctx_len, width))
        for i in range(layers):
            setattr(self, f"resblock{i}", ResidualAttentionBlock(width, heads))
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    def init_raw(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            for p in (self.positional_embedding, self.text_projection):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.01)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        B, L = tokens.shape
        x = self.token_embedding(tokens) + self.positional_embedding[None, :L]
        mask = torch.triu(torch.full((L, L), float("-inf"), device=x.device), diagonal=1)
        for i in range(self.layers):
            x = getattr(self, f"resblock{i}")(x, mask)
        x = self.ln_final(x)
        x = x[torch.arange(B, device=x.device), torch.argmax(tokens, -1)]
        return x @ self.text_projection.to(x.dtype)


class CLIPViT:
    """The CLIP model on ``device`` (CUDA unless ``"cpu"``): seeded from the
    configs, or loaded from an imported ``.npz`` (``from_npz``), whose sizes
    come from its arrays (B/32, B/16, L/14, OpenCLIP ViTs)."""

    IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
    IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

    def __init__(self, vision_cfg: Dict[str, Any], text_cfg: Dict[str, Any],
                 vision_params=None, text_params=None, logit_scale: float = 100.0,
                 seed: int = 0, device: DeviceLike = None):
        from ...utils.from_flax import load_flax_params

        self.device = resolve_device(device)
        self.visual = VisionTransformer(**vision_cfg)
        self.text = TextTransformer(**text_cfg)
        self.logit_scale = float(logit_scale)
        if vision_params is None:
            gen = torch.Generator().manual_seed(int(seed))
            init_flax_defaults(self.visual, gen)
            init_flax_defaults(self.text, gen)
        else:
            load_flax_params(self.visual, vision_params)
            load_flax_params(self.text, text_params)
        self.visual.to(self.device).requires_grad_(False)
        self.text.to(self.device).requires_grad_(False)

    @classmethod
    def from_npz(cls, path: str, device: DeviceLike = None) -> "CLIPViT":
        with np.load(path, allow_pickle=True) as data:
            vision, text = data["vision"].item(), data["text"].item()
            meta = data["meta"].item()
        return cls(meta["vision_cfg"], meta["text_cfg"], vision_params=vision,
                   text_params=text, logit_scale=meta.get("logit_scale", 100.0),
                   device=device)

    def preprocess(self, imgs) -> torch.Tensor:
        """(B, H, W, 3) uint8 or [0, 1] float, numpy or a tensor -> CLIP-
        normalised float32 on the device (uint8-range input when its max
        exceeds 1.5, as JAX decides)."""
        x = torch.as_tensor(imgs).to(self.device, torch.float32)
        if float(x.max()) > 1.5:
            x = x / 255.0
        mean = torch.from_numpy(self.IMAGE_MEAN).to(self.device)
        std = torch.from_numpy(self.IMAGE_STD).to(self.device)
        return (x - mean) / std

    @torch.no_grad()
    def encode_image(self, imgs: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        z = self.visual(torch.as_tensor(imgs).to(self.device))
        return z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-9) if normalize else z

    @torch.no_grad()
    def encode_text(self, tokens, normalize: bool = True) -> torch.Tensor:
        z = self.text(torch.as_tensor(np.asarray(tokens, np.int64)).to(self.device))
        return z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-9) if normalize else z


# ---------------------------------------------------------------------------
# BPE tokenizer (the public algorithm; the vocab file comes from the user)
# ---------------------------------------------------------------------------

@lru_cache()
def bytes_to_unicode():
    """The reversible byte -> unicode map of GPT-2 and CLIP."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class BPETokenizer:
    """CLIP's lower-cased BPE tokenizer over ``bpe_simple_vocab_16e6.txt.gz``
    (not shipped).  Its word pattern is the stdlib equivalent of CLIP's
    ``regex`` one for ASCII text; other letters fall to the catch-all class
    and still tokenize byte-wise."""

    def __init__(self, bpe_path: str, ctx_len: int = 77):
        self.ctx_len = ctx_len
        self.byte_encoder = bytes_to_unicode()
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self._pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
            r"""[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""", re.IGNORECASE)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = " ".join(html.unescape(html.unescape(text)).strip().lower().split())
        ids: List[int] = []
        for tok in self._pat.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        sot, eot = self.encoder["<|startoftext|>"], self.encoder["<|endoftext|>"]
        out = np.zeros((len(texts), self.ctx_len), np.int32)
        for i, t in enumerate(texts):
            toks = [sot] + self.encode(t)[: self.ctx_len - 2] + [eot]
            out[i, :len(toks)] = toks
        return out
