"""The optimizer NeuralRecon's configs use: Adam after a global-norm clip.

The subset of ``deep3dmap_tpu/runners/optim.py::build_optimizer`` (:270-316)
that ``configs/neural_recon/`` asks for: ``dict(type="Adam", lr, betas, eps,
weight_decay=0)`` with ``grad_clip=dict(max_norm)``, i.e.
``optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr, b1, b2,
eps))``.  Every other optimizer, option, schedule or paramwise setting raises
``NotImplementedError``: they come with the runtime around the step.

TRAP: ``torch.nn.utils.clip_grad_norm_`` scales by ``max_norm / (norm +
1e-6)`` whenever it is called; optax scales by ``max_norm / norm`` only when
``norm >= max_norm``, with no epsilon.  ``clip_by_global_norm_`` below is
optax's rule, computed on the device without a host sync.  ``torch.optim.Adam``
(foreach) applies the same bias-corrected update as ``optax.adam``;
``tests/test_torch_optim.py`` holds both against optax.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

_LATER = ("is not ported yet (ROADMAP.md Queue 1 item 9, the runtime around "
          "the training step)")


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (``optax.global_norm``),
    a 0-d device tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))


def clip_by_global_norm_(grads: Sequence[torch.Tensor], norm: torch.Tensor,
                         max_norm: float) -> None:
    """In place, ``optax.clip_by_global_norm``: each g becomes
    ``(g / norm) * max_norm`` when ``norm >= max_norm`` and stays as it is
    otherwise (divided and multiplied by 1, exactly)."""
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(list(grads), torch.where(keep, one, norm))
    torch._foreach_mul_(list(grads), torch.where(keep, one, one * max_norm))


class ClippedAdam:
    """``optax.chain(clip_by_global_norm(max_norm), adam(...))`` over a
    module's parameters.  A parameter without a gradient is skipped, as a
    zero gradient leaves it unchanged under optax."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 max_norm: Optional[float] = None):
        self.params: List[torch.nn.Parameter] = list(params)
        self.max_norm = max_norm
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=tuple(betas),
                                     eps=eps, foreach=True)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip, then one Adam step.  Returns the global gradient norm
        before clipping (a device tensor)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if not grads:
            raise RuntimeError("ClippedAdam.step: no parameter has a gradient")
        norm = global_norm(grads)
        if self.max_norm is not None:
            clip_by_global_norm_(grads, norm, self.max_norm)
        self.adam.step()
        return norm


def build_optimizer(cfg: dict, params, grad_clip: Optional[dict] = None
                    ) -> ClippedAdam:
    """``cfg`` as in the configs, e.g. ``dict(type="Adam", lr=1e-3,
    betas=(0.9, 0.999), weight_decay=0.0)``; ``grad_clip`` e.g.
    ``dict(max_norm=1.0)``."""
    cfg = dict(cfg)
    opt_type = cfg.pop("type")
    if opt_type != "Adam":
        raise NotImplementedError(f"optimizer {opt_type!r} {_LATER}")
    lr = cfg.pop("lr")
    betas = cfg.pop("betas", (0.9, 0.999))
    eps = cfg.pop("eps", 1e-8)
    if cfg.pop("weight_decay", 0.0):
        raise NotImplementedError(f"Adam with weight_decay (optax.adamw) {_LATER}")
    if cfg:
        raise NotImplementedError(f"optimizer options {sorted(cfg)} {_LATER}")
    clip = dict(grad_clip or {})
    max_norm = clip.pop("max_norm", None)
    if clip:
        raise NotImplementedError(f"grad_clip options {sorted(clip)} {_LATER}")
    return ClippedAdam(params, lr, betas=betas, eps=eps, max_norm=max_norm)
