"""Batch assembly (the port's copy of ``deep3dmap_tpu/datasets/builder.py``'s
``_stack_samples``)."""
from __future__ import annotations

import numpy as np


def _stack_samples(samples):
    """Stack per-sample dicts into one batch dict: arrays along a new axis 0,
    lists element-wise, anything else passed through as a list."""
    out = {}
    for k in samples[0].keys():
        v0 = samples[0][k]
        if isinstance(v0, (list, tuple)):
            out[k] = [np.stack([np.asarray(s[k][j]) for s in samples])
                      for j in range(len(v0))]
        elif isinstance(v0, np.ndarray) or np.isscalar(v0):
            out[k] = np.stack([np.asarray(s[k]) for s in samples])
        else:
            out[k] = [s[k] for s in samples]  # metadata passthrough
    return out
