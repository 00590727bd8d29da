"""Compact CLIP (image ViT and text transformer) with LERF's relevancy (port
of ``deep3dmap_tpu/models/modulars/clip_encoder.py``).

A joint image/text embedding and the relevancy of the LERF paper: a softmax
at temperature 10 over [positive, negative] cosine similarities, against
the canonical negative that is most similar.  Weights come from an
``.npz``: an imported real CLIP (``tools/import_weights.py clip``, with
``meta``) switches to the full ``CLIPViT``; an ``image``/``text`` pair of
flax trees fills the compact towers; without a file the towers are seeded.

TRAP (kept from the reference): ``simple_tokenize``, and ``CLIPViT``'s path
without a BPE vocab, hash words with Python's ``hash()``, which is salted
per process; two processes agree only under one ``PYTHONHASHSEED``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ...utils.device import DeviceLike, resolve_device
from ..layers import Dense, Embed, LayerNorm, MultiHeadDotProductAttention, gelu, init_flax_defaults

CANONICAL_NEGATIVES = ("object", "things", "stuff", "texture")


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(dim, heads)
        self.LayerNorm_1 = LayerNorm(dim)
        self.Dense_0 = Dense(dim, 4 * dim)
        self.Dense_1 = Dense(4 * dim, dim)

    def forward(self, x):
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x))
        return x + self.Dense_1(gelu(self.Dense_0(self.LayerNorm_1(x))))


class CLIPImageTower(nn.Module):
    """img (B, H, W, 3) -> (B, embed_dim) L2-normalised; the position
    embedding has the token count of the ``image_size`` it was made for
    (JAX's ``init`` at 64²)."""

    FLAX_LEAVES = {"cls": ("cls", "plain"), "pos": ("pos", "plain")}

    def __init__(self, embed_dim: int = 512, dim: int = 256, depth: int = 4, heads: int = 8,
                 patch: int = 16, image_size: int = 64):
        super().__init__()
        self.patch, self.dim, self.depth = patch, dim, depth
        self.Dense_0 = Dense(patch * patch * 3, dim)
        self.cls = nn.Parameter(torch.empty(1, 1, dim))
        self.pos = nn.Parameter(torch.empty(1, (image_size // patch) ** 2 + 1, dim))
        for i in range(depth):
            setattr(self, f"_Block_{i}", _Block(dim, heads))
        self.LayerNorm_0 = LayerNorm(dim)
        self.Dense_1 = Dense(dim, embed_dim)

    def init_raw(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.cls.zero_()
            self.pos.copy_(torch.randn(self.pos.shape, generator=gen) * 0.02)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = img.shape
        p = self.patch
        x = img.reshape(B, H // p, p, W // p, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = self.Dense_0(x.reshape(B, -1, p * p * 3))
        x = torch.cat([self.cls.expand(B, 1, self.dim), x], 1) + self.pos
        for i in range(self.depth):
            x = getattr(self, f"_Block_{i}")(x)
        x = self.Dense_1(self.LayerNorm_0(x)[:, 0])
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-9)


class CLIPTextTower(nn.Module):
    """tokens (B, L) -> (B, embed_dim) L2-normalised, read at the last token."""

    FLAX_LEAVES = {"pos": ("pos", "plain")}

    def __init__(self, embed_dim: int = 512, dim: int = 256, depth: int = 4, heads: int = 8,
                 vocab: int = 4096, ctx_len: int = 16):
        super().__init__()
        self.depth = depth
        self.Embed_0 = Embed(vocab, dim)
        self.pos = nn.Parameter(torch.empty(1, ctx_len, dim))
        for i in range(depth):
            setattr(self, f"_Block_{i}", _Block(dim, heads))
        self.LayerNorm_0 = LayerNorm(dim)
        self.Dense_0 = Dense(dim, embed_dim)

    def init_raw(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.pos.copy_(torch.randn(self.pos.shape, generator=gen) * 0.02)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        L = tokens.shape[1]
        x = self.Embed_0(tokens) + self.pos[:, :L]
        for i in range(self.depth):
            x = getattr(self, f"_Block_{i}")(x)
        x = self.Dense_0(self.LayerNorm_0(x)[:, -1])
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-9)


def simple_tokenize(text: str, vocab: int = 4096, ctx_len: int = 16) -> np.ndarray:
    """The reference's hashing tokenizer (a stand-in for BPE): word hashes
    in [2, vocab), then the end token 1."""
    toks = [hash(w) % (vocab - 2) + 2 for w in text.lower().split()][: ctx_len - 1]
    out = np.zeros(ctx_len, np.int32)
    out[:len(toks)] = toks
    out[len(toks)] = 1
    return out


class CLIPEncoder:
    """Joint image/text embedding and LERF's relevancy, on ``device`` (CUDA
    unless ``"cpu"``; raises without a GPU)."""

    def __init__(self, embed_dim: int = 512, weights_path: Optional[str] = None,
                 seed: int = 0, negatives: Sequence[str] = CANONICAL_NEGATIVES,
                 bpe_path: Optional[str] = None, device: DeviceLike = None):
        from ...utils.from_flax import load_flax_params

        self.device = resolve_device(device)
        self.embed_dim = embed_dim
        self._vit = None
        self._tokenizer = None
        trees = None
        if weights_path:
            with np.load(weights_path, allow_pickle=True) as data:
                if "meta" in data.files:
                    from .clip_vit import BPETokenizer, CLIPViT
                    self._vit = CLIPViT.from_npz(weights_path, device=self.device)
                    if bpe_path:
                        self._tokenizer = BPETokenizer(bpe_path)
                else:
                    trees = data["image"].item(), data["text"].item()
        if self._vit is None:
            self.image_tower = CLIPImageTower(embed_dim=embed_dim)
            self.text_tower = CLIPTextTower(embed_dim=embed_dim)
            if trees is None:
                gen = torch.Generator().manual_seed(int(seed))
                init_flax_defaults(self.image_tower, gen)
                init_flax_defaults(self.text_tower, gen)
            else:
                load_flax_params(self.image_tower, trees[0])
                load_flax_params(self.text_tower, trees[1])
            self.image_tower.to(self.device).requires_grad_(False)
            self.text_tower.to(self.device).requires_grad_(False)
        self.negatives = list(negatives)
        self.neg_embeds = self.encode_text(self.negatives)
        self.positives: List[str] = []
        self.pos_embeds = None

    @torch.no_grad()
    def encode_image(self, imgs: torch.Tensor) -> torch.Tensor:
        if self._vit is not None:
            return self._vit.encode_image(imgs)
        return self.image_tower(imgs.to(self.device))

    @torch.no_grad()
    def encode_text(self, texts: Sequence[str]) -> torch.Tensor:
        if self._vit is not None:
            if self._tokenizer is not None:
                toks = self._tokenizer(list(texts))
            else:
                # no BPE vocab: words hashed into the model's vocab, with the
                # true start and end ids (the end token, the largest, pools)
                ctx, vocab = self._vit.text.ctx_len, self._vit.text.vocab_size
                toks = np.zeros((len(texts), ctx), np.int32)
                for i, t in enumerate(texts):
                    ws = [hash(w) % (vocab - 3) + 1 for w in t.lower().split()][:ctx - 2]
                    toks[i, 0] = vocab - 2
                    toks[i, 1:1 + len(ws)] = ws
                    toks[i, 1 + len(ws)] = vocab - 1
            return self._vit.encode_text(toks)
        toks = torch.from_numpy(np.stack([simple_tokenize(t) for t in texts]))
        return self.text_tower(toks.to(self.device))

    def set_positives(self, phrases: Sequence[str]) -> None:
        self.positives = list(phrases)
        self.pos_embeds = self.encode_text(self.positives)

    def get_relevancy(self, embeds: torch.Tensor, positive_id: int,
                      temperature: float = 10.0) -> torch.Tensor:
        """embeds (..., D) -> (..., 2) [positive prob, negative prob]: the
        softmax of the positive against each negative, at the negative most
        similar to the embedding (the first of equals)."""
        pos = self.pos_embeds[positive_id]
        sims_pos = (embeds * pos).sum(-1)
        sims_neg = embeds @ self.neg_embeds.T
        pairs = torch.stack([sims_pos[..., None].expand_as(sims_neg), sims_neg], -1)
        probs = torch.softmax(temperature * pairs, -1)
        best = torch.argmax(sims_neg, -1)
        idx = best[..., None, None].expand(*best.shape, 1, 2)
        return torch.gather(probs, -2, idx)[..., 0, :]
