"""Framework base (minimal port of ``deep3dmap_tpu/models/frameworks/base.py``).

A framework bundles a network with ``init`` and the step functions
(``val_fn``, ``forward_test``; ``loss_fn`` comes with training), all taking
``(params, model_state, batch)`` as the JAX package's do.  Here ``params`` is
the ``nn.Module`` that holds the weights.
"""
from __future__ import annotations


class BaseFramework:
    """Subclasses define networks and implement the step functions."""

    def init(self, seed, batch):
        raise NotImplementedError

    # optional: val_fn(params, model_state, batch) -> dict(log_vars=...)
    # optional: forward_test(params, model_state, batch) -> (outputs, state)
