"""Multi-resolution hash-grid encoding, instant-ngp style (port of
``deep3dmap_tpu/models/modulars/hashgrid.py``).

Per level, the trilinear blend of the features stored at the 8 hashed
corners of the point's cell.  JAX loops over levels and corners; here every
level and corner is one gather from the tables flattened to
(levels x table_size, features), the index of level l offset by
l x table_size, so a field's encoding is a handful of launches.  The
gather is advanced indexing: its backward accumulates the 8 x levels x
points rows with a sorted ``index_put_(accumulate=True)`` (a fixed order on
the card), never with atomics.  The corner blend sums the 8 products with
``sum``, JAX adds them one by one: the two agree to float32 rounding.

The hash is JAX's ``uint32`` arithmetic with wraparound, done in int64: the
coordinates are masked to 32 bits and each product with a prime is taken
mod 2^32 from 16-bit halves (no int64 product exceeds 2^49), so the indices
are JAX's bit for bit for any int32 coordinates, negative ones included.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ...utils.tracing import span

_PRIMES = (1, 2654435761, 805459861)
_MASK = 0xFFFFFFFF


def _mul_u32(c: torch.Tensor, prime: int) -> torch.Tensor:
    """(c * prime) mod 2^32 for int64 c in [0, 2^32)."""
    lo = (c & 0xFFFF) * prime
    hi = ((c >> 16) * prime) & 0xFFFF
    return (lo + (hi << 16)) & _MASK


def hash_coords(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """coords (..., 3) integer -> (...,) int64 indices in [0, table_size):
    JAX's ``_hash`` (``c.astype(uint32)``, xor of the products with the
    primes, ``% table_size``)."""
    c = coords.to(torch.int64) & _MASK
    h = _mul_u32(c[..., 0], _PRIMES[0])
    h = h ^ _mul_u32(c[..., 1], _PRIMES[1])
    h = h ^ _mul_u32(c[..., 2], _PRIMES[2])
    return h % table_size


def level_resolutions(n_levels: int, base_res: int, end_res: int):
    """JAX's per-level grid resolutions (float64 on the host, floored)."""
    growth = np.exp((np.log(end_res) - np.log(base_res)) / max(n_levels - 1, 1))
    return [int(np.floor(base_res * growth ** lvl)) for lvl in range(n_levels)]


class HashGridEncoding(nn.Module):
    """``n_levels`` geometric resolutions from ``base_res`` to ``end_res``;
    ``tables`` (n_levels, 2^log2_hashmap_size, features_per_level) is the
    flax leaf of the same name, carried as it is."""

    FLAX_LEAVES = {"tables": ("tables", "plain")}

    def __init__(self, n_levels: int = 8, features_per_level: int = 8,
                 log2_hashmap_size: int = 16, base_res: int = 16, end_res: int = 128):
        super().__init__()
        self.n_levels, self.features = n_levels, features_per_level
        self.table_size = 2 ** log2_hashmap_size
        self.resolutions = level_resolutions(n_levels, base_res, end_res)
        self.tables = nn.Parameter(torch.empty(n_levels, self.table_size, features_per_level))
        corners = [[(k >> 2) & 1, (k >> 1) & 1, k & 1] for k in range(8)]
        self.register_buffer("_res", torch.tensor(self.resolutions, dtype=torch.float32)[:, None],
                             persistent=False)
        self.register_buffer("_corners", torch.tensor(corners, dtype=torch.int64),
                             persistent=False)
        self.register_buffer("_level_base", torch.arange(n_levels, dtype=torch.int64)[:, None]
                             * self.table_size, persistent=False)

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.features

    def init_raw(self, gen: torch.Generator) -> None:
        """flax's ``uniform(1e-4)``: U[0, 1e-4)."""
        with torch.no_grad():
            self.tables.copy_(torch.rand(self.tables.shape, generator=gen) * 1e-4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., 3) in [0, 1] -> (..., n_levels * features_per_level),
        level-major as JAX concatenates them; the span ``lerf.hashgrid``
        under a profiler."""
        with span("lerf.hashgrid"):
            return self._encode(x)

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        pos = x[..., None, :] * self._res                      # (..., L, 3)
        p0 = torch.floor(pos)
        frac = pos - p0
        corner = p0.to(torch.int64)[..., None, :] + self._corners    # (..., L, 8, 3)
        idx = hash_coords(corner, self.table_size) + self._level_base   # (..., L, 8)
        f = frac[..., None, :]
        # the three factors multiplied out, as JAX's prod over 3 is: autograd's
        # ``prod`` backward asks the device whether a factor is zero
        sel = torch.where(self._corners.bool(), f, 1.0 - f)
        w = sel[..., 0] * sel[..., 1] * sel[..., 2]            # (..., L, 8)
        rows = self.tables.reshape(-1, self.features)[idx]     # (..., L, 8, F)
        feats = (w[..., None] * rows).sum(-2)
        return feats.reshape(*x.shape[:-1], self.out_dim)
