"""Spans and counters at the program's layer boundaries.

``span(name)`` is a ``torch.profiler.record_function`` range named
``"span:" + name`` while a profiler runs, and one shared null context
otherwise (a fraction of a microsecond).  The spans carry no clock or store
of their own: the profiler keeps them beside the device's kernels, on its
clock, and its exporters write them out (``runners/hooks_extra.py``'s
``ProfilerHook``, the benchmark's traced window).

``count(name, value, cap)`` adds to one registry of counters:

- a Python int is counted always (the launch counters of ``ops/`` and the
  collectives of ``parallel/collectives.py``);
- a device tensor (a per-row count such as the active blocks of a level) is
  kept by reference, and only while a profiler runs: no kernel, no wait.
  With ``cap`` (the rows' budget) its read gives ``.active`` (Σ n),
  ``.kept`` (Σ min(n, cap)), ``.slots`` (Σ cap) and ``.overflow``
  (Σ max(n - cap, 0)) over every row of every call, and ``.rows``.

``read_counters`` copies the kept tensors to the host in one transfer per
device and returns a flat dict; ``reset_counters`` clears the registry.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple, Union

import torch

_NULL = contextlib.nullcontext()
PREFIX = "span:"

_ints: Dict[str, int] = defaultdict(int)
_kept: Dict[str, List[Tuple[torch.Tensor, Optional[int]]]] = defaultdict(list)


def span(name: str):
    """A profiler range ``span:<name>`` while a profiler runs, else a no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _NULL


def count(name: str, value: Union[int, torch.Tensor] = 1, cap: Optional[int] = None) -> None:
    """Add ``value`` to counter ``name``: an int always, a tensor of per-row
    counts (rows of budget ``cap``) only while a profiler runs."""
    if isinstance(value, int):
        _ints[name] += value
    elif torch.autograd._profiler_enabled():
        _kept[name].append((value.detach(), cap))


def counter(name: str) -> int:
    """The int counter ``name`` (0 if never counted)."""
    return _ints.get(name, 0)


def read_counters(prefix: str = "") -> Dict[str, int]:
    """Every counter whose name starts with ``prefix``, as a flat dict."""
    out = {k: v for k, v in _ints.items() if k.startswith(prefix)}
    items = [(k, t, cap) for k, entries in _kept.items() if k.startswith(prefix)
             for t, cap in entries]
    by_dev = defaultdict(list)
    for k, t, cap in items:
        by_dev[t.device].append((k, t, cap))
    for group in by_dev.values():
        flat = torch.cat([t.reshape(-1).to(torch.int64) for _, t, _ in group]).cpu()
        pos = 0
        for k, t, cap in group:
            n = flat[pos:pos + t.numel()]
            pos += t.numel()
            if cap is None:
                out[k] = out.get(k, 0) + int(n.sum())
                continue
            for key, v in (("active", n.sum()), ("kept", n.clamp(max=cap).sum()),
                           ("slots", cap * n.numel()),
                           ("overflow", (n - cap).clamp(min=0).sum()), ("rows", n.numel())):
                out[f"{k}.{key}"] = out.get(f"{k}.{key}", 0) + int(v)
    return out


def reset_counters(prefix: str = "") -> None:
    """Clear every counter whose name starts with ``prefix``."""
    for reg in (_ints, _kept):
        for k in [k for k in reg if k.startswith(prefix)]:
            del reg[k]
