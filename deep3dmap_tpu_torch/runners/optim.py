"""Optimizers and lr schedules: ``deep3dmap_tpu/runners/optim.py`` with
optax 0.2.6's formulas, on ``torch._foreach_*`` ops.

``build_lr_schedule`` has every policy of the JAX module (``fixed``,
``step``, ``exp``, ``poly``, ``inv``, ``cosineannealing``/``cosine``,
``flatcosineannealing``, ``cosinerestart``, ``cyclic``, ``onecycle``) and its
warmups (``constant``, ``linear``, ``exp``), computed in float32 as JAX
computes them op by op: equal bit for bit where only ``+ - * /``, ``min``
and ``where`` occur, within a few float32 ulps where ``cos`` or ``pow``
does.  (XLA's fused CPU code divides by a constant through its reciprocal
and an FMA, so a jitted JAX schedule can sit an ulp away, and its ``poly``
is NaN at ``step >= total_iters``: ROADMAP.md Queue 3.)

``build_optimizer`` has every entry of JAX's ``_OPTAX_FACTORY`` with the
factory's defaults, and swallows the options it swallows (``amsgrad``,
``momentum`` of Adam, ``norm_type`` of ``grad_clip``, ...):

  Adam     optax.adam; optax.adamw when weight_decay is set
  AdamW    optax.adamw (weight_decay 1e-2)
  SGD      add_decayed_weights, then optax.sgd (momentum, nesterov)
  RMSprop  add_decayed_weights, then optax.rmsprop: eps INSIDE the square
           root (torch's sits outside), the momentum trace after the lr
  Adagrad  optax.adagrad: the accumulator starts at 0.1, eps 1e-10
  Adamax   optax.adamax
  Lamb     optax.lamb: Adam (eps 1e-6), decay, the per-tensor trust ratio
  Lion     optax.lion: the sign update, betas (0.9, 0.99)

``paramwise_cfg`` (``custom_keys``, the longest match winning,
``bias_lr_mult``, ``bias_decay_mult``, ``norm_decay_mult``) decides each
parameter's multipliers from its flax path (``utils/from_flax.py``), lower
cased, as JAX decides them from its tree: the L2 decay goes into the
gradient before the optimizer, the lr multiplier onto the final update.  As
in JAX, the optimizer then gets the config without ``weight_decay``, so
``AdamW`` keeps its factory default (1e-2) on top.  ``cumulative_iters`` is
``optax.MultiSteps``: the running mean of k gradients, the inner chain
(clip, decay, optimizer, lr multiplier) on that mean at every k-th step and
no update otherwise; the inner count, and with it the lr schedule, advances
only on applied steps.

Plain Adam (no weight decay, paramwise or accumulation) stays on
``torch.optim.Adam`` (``ClippedAdam``), the same bias-corrected update.

TRAP: ``torch.nn.utils.clip_grad_norm_`` scales by ``max_norm / (norm +
1e-6)`` whenever it is called; optax scales by ``max_norm / norm`` only when
``norm >= max_norm``, with no epsilon.  ``clip_by_global_norm_`` below is
optax's rule, computed on the device without a host sync.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

f32 = np.float32


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


# ---------------------------------------------------------------------------
# lr schedules: float32 scalars on the host, in XLA's order of operations.
# Python constants combine in double first, as JAX folds weak-typed scalars.
# ---------------------------------------------------------------------------

def _clip01(x):
    return min(max(x, f32(0.0)), f32(1.0))


def _div(a, b):
    """An int32 step over an int: JAX's true_divide, both cast to float32."""
    return f32(a) / f32(b)


def _cos_half(x):
    """``1.0 + cos(pi * x)`` in float32."""
    return f32(1.0) + np.cos(f32(np.pi) * f32(x))


def _warmup_wrap(schedule: Callable, warmup: Optional[str], warmup_iters: int,
                 warmup_ratio: float) -> Callable:
    if warmup is None or warmup_iters <= 0:
        return schedule
    if warmup not in ("constant", "linear", "exp"):
        raise ValueError(f"unknown warmup {warmup}")

    def sched(step):
        regular = f32(schedule(step))
        if step >= warmup_iters:
            return float(regular)
        frac = min(_div(step, max(warmup_iters, 1)), f32(1.0))
        if warmup == "constant":
            w = f32(warmup_ratio)
        elif warmup == "linear":
            w = f32(1.0) - (f32(1.0) - frac) * f32(1.0 - warmup_ratio)
        else:
            w = f32(warmup_ratio) ** (f32(1.0) - frac)
        return float(regular * w)
    return sched


def build_lr_schedule(policy: str, base_lr: float, total_iters: int,
                      iters_per_epoch: int = 1, by_epoch: bool = True,
                      warmup: Optional[str] = None, warmup_iters: int = 0,
                      warmup_ratio: float = 0.1, **kwargs) -> Callable[[int], float]:
    """An iteration -> lr schedule (JAX's ``build_lr_schedule``).  With
    ``by_epoch`` the policy's breakpoints are epochs of ``iters_per_epoch``
    iterations, and ``exp``/``inv`` run on fractional epochs."""
    policy = policy.lower()
    e = iters_per_epoch if by_epoch else 1
    lr0 = f32(base_lr)

    if policy == "fixed":
        def sched(step):
            return float(lr0)
    elif policy == "step":
        steps = kwargs.get("step")
        gamma = f32(kwargs.get("gamma", 0.1))
        min_lr = kwargs.get("min_lr", None)
        if isinstance(steps, int):
            steps = list(range(steps, total_iters // e + 1, steps))
        bounds = [s * e for s in steps]

        def sched(step):
            if not bounds:      # JAX's exponent is then the Python 0.0
                return float(base_lr if min_lr is None else max(lr0, f32(min_lr)))
            lr = lr0 * gamma ** f32(sum(step >= b for b in bounds))
            if min_lr is not None:
                lr = max(lr, f32(min_lr))
            return float(lr)
    elif policy == "exp":
        gamma = f32(kwargs.get("gamma", 0.99))

        def sched(step):
            return float(lr0 * gamma ** (_div(step, e) if by_epoch else f32(step)))
    elif policy == "poly":
        power = f32(kwargs.get("power", 1.0))
        min_lr = kwargs.get("min_lr", 0.0)

        def sched(step):
            coeff = (f32(1.0) - _div(min(step, total_iters), total_iters)) ** power
            return float(f32(base_lr - min_lr) * coeff + f32(min_lr))
    elif policy == "inv":
        gamma = f32(kwargs.get("gamma", 0.1))
        power = f32(-kwargs.get("power", 1.0))

        def sched(step):
            x = _div(step, e) if by_epoch else f32(step)
            return float(lr0 * (f32(1.0) + gamma * x) ** power)
    elif policy in ("cosineannealing", "cosine"):
        min_lr = kwargs.get("min_lr", 0.0)
        min_lr_ratio = kwargs.get("min_lr_ratio", None)
        tgt = base_lr * min_lr_ratio if min_lr_ratio is not None else min_lr
        half = f32(0.5 * (base_lr - tgt))

        def sched(step):
            frac = min(_div(step, total_iters), f32(1.0))
            return float(f32(tgt) + half * _cos_half(frac))
    elif policy == "flatcosineannealing":
        start_percent = kwargs.get("start_percent", 0.75)
        min_lr = kwargs.get("min_lr", 0.0)
        flat_end = int(total_iters * start_percent)
        half = f32(0.5 * (base_lr - min_lr))

        def sched(step):
            if step < flat_end:
                return float(lr0)
            frac = _clip01(_div(step - flat_end, max(total_iters - flat_end, 1)))
            return float(f32(min_lr) + half * _cos_half(frac))
    elif policy == "cosinerestart":
        periods = [p * e for p in kwargs.get("periods")]
        restart_weights = kwargs.get("restart_weights", [1.0] * len(periods))
        min_lr = kwargs.get("min_lr", 0.0)
        cum = [0]
        for p in periods:
            cum.append(cum[-1] + p)

        def sched(step):
            lr = f32(min_lr)
            for i, p in enumerate(periods):
                if cum[i] <= step < cum[i + 1]:
                    frac = _clip01(_div(step - cum[i], p))
                    half = f32(0.5 * (base_lr * restart_weights[i] - min_lr))
                    lr = f32(min_lr) + half * _cos_half(frac)
            return float(f32(min_lr) if step >= cum[-1] else lr)
    elif policy == "cyclic":
        target_ratio = kwargs.get("target_ratio", (10.0, 1e-4))
        cyclic_times = kwargs.get("cyclic_times", 1)
        step_ratio_up = kwargs.get("step_ratio_up", 0.4)
        cycle_len = max(total_iters // cyclic_times, 1)
        up_len = int(cycle_len * step_ratio_up)
        hi = base_lr * target_ratio[0]
        lo = base_lr * target_ratio[1]

        def sched(step):
            pos = step % cycle_len
            if pos < up_len:
                return float(lr0 + f32(hi - base_lr) * _clip01(_div(pos, max(up_len, 1))))
            frac = _clip01(_div(pos - up_len, max(cycle_len - up_len, 1)))
            return float(f32(hi) + f32(lo - hi) * frac)
    elif policy == "onecycle":
        max_lr = kwargs.get("max_lr", base_lr * 10)
        pct_start = kwargs.get("pct_start", 0.3)
        div_factor = kwargs.get("div_factor", 25.0)
        final_div_factor = kwargs.get("final_div_factor", 1e4)
        initial = max_lr / div_factor
        final = initial / final_div_factor
        up_len = int(total_iters * pct_start)

        def anneal(start, end, frac):
            return f32(end) + f32((start - end) * 0.5) * _cos_half(frac)

        def sched(step):
            if step < up_len:
                return float(anneal(initial, max_lr, _clip01(_div(step, max(up_len, 1)))))
            return float(anneal(max_lr, final, _clip01(
                _div(step - up_len, max(total_iters - up_len, 1)))))
    else:
        raise ValueError(f"Unknown lr policy: {policy}")

    return _warmup_wrap(sched, warmup, warmup_iters, warmup_ratio)


def build_momentum_schedule(policy: str, base_momentum: float, total_iters: int,
                            **kwargs) -> Callable[[int], float]:
    """Momentum schedules: the lr policies' vocabulary on a momentum."""
    return build_lr_schedule(policy, base_momentum, total_iters, **kwargs)


# ---------------------------------------------------------------------------
# Adam on torch.optim.Adam
# ---------------------------------------------------------------------------

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

    def structure(self) -> dict:
        return dict(clip=self.max_norm is not None, schedule=self.schedule is not None)

    def state_dict(self) -> dict:
        return dict(adam=self.adam.state_dict(), count=self.count, structure=self.structure())

    def load_state_dict(self, saved: dict) -> None:
        self.adam.load_state_dict(saved["adam"])
        self.count = int(saved["count"])


# ---------------------------------------------------------------------------
# every optax chain of the JAX factory, on foreach ops
# ---------------------------------------------------------------------------

# type -> (the factory's defaults, the state buffers of its optax transform)
_FACTORY = {
    "Adam": (dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0), ("mu", "nu")),
    "AdamW": (dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2), ("mu", "nu")),
    "SGD": (dict(momentum=0.0, weight_decay=0.0, nesterov=False), ("trace",)),
    "RMSprop": (dict(alpha=0.99, eps=1e-8, momentum=0.0, weight_decay=0.0), ("nu", "trace")),
    "Adagrad": (dict(eps=1e-10), ("sum_of_squares",)),
    "Adamax": (dict(betas=(0.9, 0.999), eps=1e-8), ("mu", "nu")),
    "Lamb": (dict(weight_decay=0.0), ("mu", "nu")),
    "Lion": (dict(betas=(0.9, 0.99), weight_decay=0.0), ("mu",)),
}
OPTIMIZERS = tuple(_FACTORY)

_NORM_MARKERS = ("groupnorm", "layernorm", "batchnorm", "norm")


def _lr_mult_for(path: str, pw: dict) -> float:
    custom = pw.get("custom_keys", {})
    for key in sorted(custom, key=len, reverse=True):  # longest match wins
        if key.lower() in path:
            return float(custom[key].get("lr_mult", 1.0))
    if path.endswith("bias") and not any(m in path for m in _NORM_MARKERS):
        return float(pw.get("bias_lr_mult", 1.0))
    return 1.0


def _decay_mult_for(path: str, pw: dict) -> float:
    custom = pw.get("custom_keys", {})
    for key in sorted(custom, key=len, reverse=True):
        if key.lower() in path:
            return float(custom[key].get("decay_mult", 1.0))
    if any(m in path for m in _NORM_MARKERS):
        return float(pw.get("norm_decay_mult", 1.0))
    if path.endswith("bias"):
        return float(pw.get("bias_decay_mult", 1.0))
    return 1.0


def flax_paths(module: torch.nn.Module, collection: str = "params") -> Dict[str, str]:
    """Parameter name -> the lower-cased dotted flax path JAX's paramwise
    rules read (``collection.a.b.kernel``)."""
    from ..utils.from_flax import _leaf_map

    return {name: ".".join((collection,) + path).lower()
            for name, (path, _) in _leaf_map(module).items()}


def paramwise_mults(module: torch.nn.Module, paramwise_cfg: dict,
                    collection: str = "params"):
    """(decay multipliers, lr multipliers), one per parameter in
    ``module.parameters()`` order."""
    paths = flax_paths(module, collection)
    names = [n for n, _ in module.named_parameters()]
    return ([_decay_mult_for(paths[n], paramwise_cfg) for n in names],
            [_lr_mult_for(paths[n], paramwise_cfg) for n in names])


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in float32."""
    return float(f32(1.0) - f32(decay) ** f32(count))


class FoldedOptimizer:
    """One optax chain of the JAX factory over a list of parameters:
    [clip] [paramwise decay] optimizer [paramwise lr], wrapped in
    ``MultiSteps`` when ``every_k > 1``.  Updates are computed with
    ``torch._foreach_*`` ops over the whole list; nothing waits for the
    device.  ``count`` is optax's inner count (updates applied, the lr
    schedule's step), ``mini_step`` MultiSteps' position in its window, and
    ``buffers`` the optimizer's state by optax's field names."""

    def __init__(self, params, kind: str, lr, hyper: dict, max_norm: Optional[float] = None,
                 decay: Optional[Sequence[float]] = None,
                 lr_mults: Optional[Sequence[float]] = None, every_k: int = 1,
                 paramwise_weight_decay: float = 0.0):
        if kind not in _FACTORY:
            raise KeyError(f"optimizer {kind} not registered")
        self.params: List[torch.nn.Parameter] = list(params)
        self.kind = kind
        self.hyper = dict(hyper)
        self.max_norm = max_norm
        self.schedule = lr if callable(lr) else None
        self.fixed_lr = None if callable(lr) else float(lr)
        self.decay = None if decay is None else [float(d) for d in decay]
        self.lr_mults = None if lr_mults is None else [float(m) for m in lr_mults]
        self.paramwise_weight_decay = f32(paramwise_weight_decay)
        self.every_k = int(every_k)
        self.count = 0
        self.mini_step = 0
        self.buffers: Dict[str, List[torch.Tensor]] = {
            name: self._full(0.1 if kind == "Adagrad" else 0.0)
            for name in self._buffer_names()}
        self.acc = self._full(0.0) if self.every_k > 1 else None

    def _buffer_names(self):
        names = _FACTORY[self.kind][1]
        if "trace" in names and not self.hyper.get("momentum"):
            names = tuple(n for n in names if n != "trace")
        return names

    def _full(self, value: float) -> List[torch.Tensor]:
        return [torch.full_like(p, value, memory_format=torch.preserve_format)
                for p in self.params]

    def lr_at(self, count: int) -> float:
        """The lr of update ``count``."""
        return self.schedule(count) if self.schedule else self.fixed_lr

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _grads(self) -> List[torch.Tensor]:
        if all(p.grad is None for p in self.params):
            raise RuntimeError(f"{type(self).__name__}.step: no parameter has a gradient")
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update (or one accumulated micro-step).  Returns the global
        norm of this step's gradients (a device tensor)."""
        grads = self._grads()
        norm = global_norm(grads)
        if self.every_k > 1:
            # MultiSteps' Welford mean: acc + (g - acc) / (n + 1)
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, delta)
            if self.mini_step < self.every_k - 1:
                self.mini_step += 1
                return norm
            self.mini_step = 0
            grads = self.acc        # the inner chain runs on the mean
            inner_norm = global_norm(grads) if self.max_norm is not None else None
        else:
            inner_norm = norm
        if self.max_norm is not None:
            clip_by_global_norm_(grads, inner_norm, self.max_norm)
        wd = self.paramwise_weight_decay
        if self.decay is not None and wd:
            torch._foreach_add_(grads, torch._foreach_mul(
                self.params, [float(wd * f32(m)) for m in self.decay]))
        updates = getattr(self, f"_{self.kind.lower()}")(grads, -f32(self.lr_at(self.count)))
        if self.lr_mults is not None:
            torch._foreach_mul_(updates, self.lr_mults)
        torch._foreach_add_(self.params, updates)
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
        self.count += 1
        return norm

    # -- the optax transforms; each returns the final update (lr applied) --
    def _adam_direction(self, g, b1, b2, eps):
        mu, nu = self.buffers["mu"], self.buffers["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))
        count = self.count + 1
        u = torch._foreach_div(mu, _bias_correction(b1, count))
        den = torch._foreach_div(nu, _bias_correction(b2, count))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(u, den)
        return u

    def _add_decayed(self, u, wd):
        if wd:
            torch._foreach_add_(u, torch._foreach_mul(self.params, float(f32(wd))))

    def _adam(self, g, neg_lr):
        b1, b2 = self.hyper["betas"]
        u = self._adam_direction(g, b1, b2, self.hyper["eps"])
        self._add_decayed(u, self.hyper["weight_decay"])
        torch._foreach_mul_(u, float(neg_lr))
        return u

    _adamw = _adam

    def _sgd(self, g, neg_lr):
        self._add_decayed(g, self.hyper["weight_decay"])
        m = self.hyper["momentum"]
        if not m:
            return torch._foreach_mul(g, float(neg_lr))
        t = self.buffers["trace"]
        torch._foreach_mul_(t, m)
        torch._foreach_add_(t, g)
        if self.hyper["nesterov"]:
            u = torch._foreach_mul(t, m)
            torch._foreach_add_(u, g)
        else:
            u = [x.clone() for x in t]
        torch._foreach_mul_(u, float(neg_lr))
        return u

    def _rmsprop(self, g, neg_lr):
        self._add_decayed(g, self.hyper["weight_decay"])
        a = self.hyper["alpha"]
        nu = self.buffers["nu"]
        torch._foreach_mul_(nu, a)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - a))
        r = torch._foreach_add(nu, self.hyper["eps"])
        torch._foreach_rsqrt_(r)
        u = torch._foreach_mul(r, g)
        torch._foreach_mul_(u, float(neg_lr))
        m = self.hyper["momentum"]
        if m:
            t = self.buffers["trace"]
            torch._foreach_mul_(t, m)
            torch._foreach_add_(t, u)
            u = [x.clone() for x in t]
        return u

    def _adagrad(self, g, neg_lr):
        s = self.buffers["sum_of_squares"]
        torch._foreach_add_(s, torch._foreach_mul(g, g))
        # the accumulator starts at 0.1 and only grows: optax's ``t > 0``
        # branch always holds
        r = torch._foreach_add(s, self.hyper["eps"])
        torch._foreach_rsqrt_(r)
        u = torch._foreach_mul(r, g)
        torch._foreach_mul_(u, float(neg_lr))
        return u

    def _adamax(self, g, neg_lr):
        b1, b2 = self.hyper["betas"]
        mu, nu = self.buffers["mu"], self.buffers["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
        a = torch._foreach_abs(g)
        torch._foreach_add_(a, self.hyper["eps"])
        torch._foreach_mul_(nu, b2)
        torch._foreach_maximum_(nu, a)
        u = torch._foreach_div(mu, _bias_correction(b1, self.count + 1))
        torch._foreach_div_(u, nu)
        torch._foreach_mul_(u, float(neg_lr))
        return u

    def _lamb(self, g, neg_lr):
        u = self._adam_direction(g, 0.9, 0.999, 1e-6)
        self._add_decayed(u, self.hyper["weight_decay"])
        pn = torch.stack(torch._foreach_norm(self.params))
        un = torch.stack(torch._foreach_norm(u))
        ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
        torch._foreach_mul_(u, list(ratio.unbind()))
        torch._foreach_mul_(u, float(neg_lr))
        return u

    def _lion(self, g, neg_lr):
        b1, b2 = self.hyper["betas"]
        mu = self.buffers["mu"]
        u = torch._foreach_mul(g, 1.0 - b1)
        torch._foreach_add_(u, torch._foreach_mul(mu, b1))
        torch._foreach_sign_(u)
        torch._foreach_mul_(mu, b2)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b2))
        self._add_decayed(u, self.hyper["weight_decay"])
        torch._foreach_mul_(u, float(neg_lr))
        return u

    # -- checkpoints --------------------------------------------------------
    def structure(self) -> dict:
        return dict(type=self.kind, clip=self.max_norm is not None,
                    schedule=self.schedule is not None, paramwise=self.decay is not None,
                    every_k=self.every_k, buffers=list(self._buffer_names()))

    def state_dict(self) -> dict:
        return dict(count=self.count, mini_step=self.mini_step, buffers=self.buffers,
                    acc=self.acc, structure=self.structure())

    def load_state_dict(self, saved: dict) -> None:
        def load(dst, src):
            if len(src) != len(dst) or any(a.shape != b.shape for a, b in zip(dst, src)):
                raise ValueError("optimizer state of other shapes in the checkpoint")
            for a, b in zip(dst, src):
                a.copy_(b)
        with torch.no_grad():
            for name, bufs in self.buffers.items():
                load(bufs, saved["buffers"][name])
            if self.acc is not None:
                load(self.acc, saved["acc"])
        self.count = int(saved["count"])
        self.mini_step = int(saved["mini_step"])


def build_optimizer(cfg: dict, params, grad_clip: Optional[dict] = None,
                    lr_schedule: Optional[Callable[[int], float]] = None,
                    paramwise_cfg: Optional[dict] = None, cumulative_iters: int = 1,
                    collection: str = "params"):
    """``cfg`` as in the configs, e.g. ``dict(type="AdamW", lr=1e-3,
    weight_decay=1e-2)``; ``params`` a module (needed for ``paramwise_cfg``,
    whose rules read its flax paths under ``collection``) or an iterable of
    parameters; ``grad_clip`` e.g. ``dict(max_norm=1.0)``; ``lr_schedule``
    (from ``build_lr_schedule``) replaces the fixed ``lr``."""
    module = params if isinstance(params, torch.nn.Module) else None
    plist = list(module.parameters() if module is not None else params)
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind not in _FACTORY:
        raise KeyError(f"optimizer {kind} not registered")
    base_lr = cfg.pop("lr")
    lr = lr_schedule or base_lr
    max_norm = (grad_clip or {}).get("max_norm")
    decay = lr_mults = None
    pw_wd = 0.0
    if paramwise_cfg:
        if module is None:
            raise ValueError("paramwise_cfg needs the module (its parameters' names)")
        # the decay moves into the paramwise transform; the optimizer gets the
        # config without it (JAX's build_optimizer)
        pw_wd = float(cfg.pop("weight_decay", 0.0))
        decay, lr_mults = paramwise_mults(module, dict(paramwise_cfg), collection)
    defaults, _ = _FACTORY[kind]
    hyper = {k: cfg.get(k, v) for k, v in defaults.items()}     # the rest is swallowed
    if kind == "Adam" and not hyper["weight_decay"] and not paramwise_cfg \
            and cumulative_iters <= 1:
        return ClippedAdam(plist, lr, betas=hyper["betas"], eps=hyper["eps"],
                           max_norm=max_norm)
    return FoldedOptimizer(plist, kind, lr, hyper, max_norm=max_norm, decay=decay,
                           lr_mults=lr_mults, every_k=cumulative_iters,
                           paramwise_weight_decay=pw_wd)
