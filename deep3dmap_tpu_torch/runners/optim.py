"""The optimizer the ported configs use: Adam after a global-norm clip,
with the ``step`` or the ``cosineannealing`` lr policy.

The subset of ``deep3dmap_tpu/runners/optim.py::build_optimizer`` (:270-316)
that ``configs/neural_recon/`` asks for: ``dict(type="Adam", lr, betas, eps,
weight_decay=0)`` with ``grad_clip=dict(max_norm)``, i.e.
``optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr, b1, b2,
eps))``, and ``build_lr_schedule`` (:49-100) for ``policy="step"`` and
``"cosineannealing"`` (alias ``"cosine"``).  Every other optimizer, option,
policy or paramwise setting raises ``NotImplementedError``.

TRAP: ``torch.nn.utils.clip_grad_norm_`` scales by ``max_norm / (norm +
1e-6)`` whenever it is called; optax scales by ``max_norm / norm`` only when
``norm >= max_norm``, with no epsilon.  ``clip_by_global_norm_`` below is
optax's rule, computed on the device without a host sync.  ``torch.optim.Adam``
(foreach) applies the same bias-corrected update as ``optax.adam``;
``tests/test_torch_optim.py`` holds both against optax.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

_LATER = "is not ported yet (ROADMAP.md Queue 1, the runtime's leftovers)"


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


# the JAX package's policies (runners/optim.py:49-160); "step" and the cosine
# ones are ported
_POLICIES = ("fixed", "step", "exp", "poly", "inv", "cosineannealing", "cosine",
             "flatcosineannealing", "cosinerestart", "cyclic", "onecycle")


def build_lr_schedule(policy: str, base_lr: float, total_iters: int,
                      iters_per_epoch: int = 1, by_epoch: bool = True,
                      warmup: Optional[str] = None, warmup_iters: int = 0,
                      warmup_ratio: float = 0.1, **kwargs) -> Callable[[int], float]:
    """An iteration -> lr schedule, JAX's ``build_lr_schedule`` for
    ``policy="step"``: ``base_lr * gamma ** (number of bounds <= step)``,
    floored at ``min_lr``, with the bounds in epochs when ``by_epoch``;
    ``step`` is a list of bounds or an int period.  ``"cosineannealing"``
    (or ``"cosine"``): ``tgt + (base_lr - tgt) * (1 + cos(pi * frac)) / 2``
    with ``frac = min(step / total_iters, 1)`` and ``tgt`` = ``min_lr``
    (default 0) or ``base_lr * min_lr_ratio``.  Computed in float32 as JAX
    computes it: the step policy's values are JAX's bit for bit, the cosine's
    within an ulp of its cosine (XLA's float32 ``cos`` is its own)."""
    del warmup_ratio
    policy = policy.lower()
    if policy not in _POLICIES:
        raise ValueError(f"Unknown lr policy: {policy}")
    if policy not in ("step", "cosineannealing", "cosine"):
        raise NotImplementedError(f"lr policy {policy!r} {_LATER}")
    if warmup is not None and warmup_iters > 0:
        raise NotImplementedError(f"lr warmup {warmup!r} {_LATER}")
    if policy != "step":
        return _cosine(base_lr, total_iters, **kwargs)
    e = iters_per_epoch if by_epoch else 1
    steps = kwargs.pop("step")
    gamma = np.float32(kwargs.pop("gamma", 0.1))
    min_lr = kwargs.pop("min_lr", None)
    if kwargs:
        raise NotImplementedError(f"lr options {sorted(kwargs)} {_LATER}")
    if isinstance(steps, int):
        steps = list(range(steps, total_iters // e + 1, steps))
    bounds = [s * e for s in steps]
    if not bounds:      # JAX's exponent is then the Python 0.0
        return lambda step: float(base_lr)
    lr0 = np.float32(base_lr)

    def sched(step: int) -> float:
        lr = lr0 * gamma ** np.float32(sum(step >= b for b in bounds))
        if min_lr is not None:
            lr = np.maximum(lr, np.float32(min_lr))
        return float(lr)
    return sched


def _cosine(base_lr: float, total_iters: int, min_lr: float = 0.0,
            min_lr_ratio: Optional[float] = None) -> Callable[[int], float]:
    f = np.float32
    tgt = f(base_lr * min_lr_ratio if min_lr_ratio is not None else min_lr)
    half = f(0.5) * (f(base_lr) - tgt)

    def sched(step: int) -> float:
        frac = np.minimum(f(step) / f(total_iters), f(1.0))
        return float(tgt + half * (f(1.0) + np.cos(f(np.pi) * frac)))
    return sched


class ClippedAdam:
    """``optax.chain(clip_by_global_norm(max_norm), adam(...))`` over a
    module's parameters.  A parameter without a gradient is skipped, as a
    zero gradient leaves it unchanged under optax.

    ``lr`` is a number or a schedule: update k (from 0) then takes
    ``lr(k)``, as optax's ``scale_by_schedule`` reads its step count before
    incrementing it.  ``count`` is that count."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps: float = 1e-8,
                 max_norm: Optional[float] = None):
        self.params: List[torch.nn.Parameter] = list(params)
        self.max_norm = max_norm
        self.schedule = lr if callable(lr) else None
        self.fixed_lr = None if callable(lr) else float(lr)
        self.count = 0
        self.adam = torch.optim.Adam(self.params, lr=self.lr_at(0),
                                     betas=tuple(betas), eps=eps, foreach=True)

    def lr_at(self, count: int) -> float:
        """The lr of update ``count``."""
        return self.schedule(count) if self.schedule else self.fixed_lr

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
        if self.schedule is not None:
            for group in self.adam.param_groups:
                group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1
        return norm


def build_optimizer(cfg: dict, params, grad_clip: Optional[dict] = None,
                    lr_schedule: Optional[Callable[[int], float]] = None
                    ) -> ClippedAdam:
    """``cfg`` as in the configs, e.g. ``dict(type="Adam", lr=1e-3,
    betas=(0.9, 0.999), weight_decay=0.0)``; ``grad_clip`` e.g.
    ``dict(max_norm=1.0)``; ``lr_schedule`` (from ``build_lr_schedule``)
    replaces the fixed ``lr``."""
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
    return ClippedAdam(params, lr_schedule or lr, betas=betas, eps=eps,
                       max_norm=max_norm)
