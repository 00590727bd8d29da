"""Framework base (minimal port of ``deep3dmap_tpu/models/frameworks/base.py``).

A framework bundles a network with ``init`` and the step functions
(``val_fn``, ``forward_test``; ``loss_fn`` comes with training), all taking
``(params, model_state, batch)`` as the JAX package's do.  Here ``params`` is
the ``nn.Module`` that holds the weights.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch


def parse_losses(losses: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Each value's mean (values without one pass through), and the sum of
    the entries whose name holds ``loss``."""
    log_vars = {k: v.mean() if hasattr(v, "mean") else v for k, v in losses.items()}
    loss = sum(v for k, v in log_vars.items() if "loss" in k)
    return loss, log_vars


class BaseFramework:
    """Subclasses define networks and implement the step functions."""

    def init(self, seed, batch):
        raise NotImplementedError

    # optional: val_fn(params, model_state, batch) -> dict(log_vars=...)
    # optional: forward_test(params, model_state, batch) -> (outputs, state)
