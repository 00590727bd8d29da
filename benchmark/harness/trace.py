"""A traced window and what is read from it.

``Traced`` runs a callable under ``torch.profiler`` (CPU and CUDA) inside a
span named ``WINDOW``, then reads the profiler's raw events (no tree is
built): the device's operations (kernels, copies, sets) and the host's
operations.  From them:

- ``busy_s``: the union of the device operations' intervals inside the
  window, and ``window_s``, the window span's length;
- ``kernels``: the device kernels (not copies or sets),
  ``(name, start_ns, duration_ns)``;
- ``device_ops``: device seconds by operation name, most first;
- ``idle_gaps``: device idle seconds inside the window by what the host was
  doing when the gap began (of the innermost host operations open then on
  each thread, the one that began last), most first.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Tuple

WINDOW = "bench.window"


def union_seconds(intervals: List[Tuple[int, int]], lo: int, hi: int) -> float:
    """Length, in seconds, of the union of ``[start, end)`` ns intervals
    clipped to ``[lo, hi)``."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-9


def gaps(intervals: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The idle stretches of ``[lo, hi)`` between the intervals."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def _innermost(gap_list, ops):
    """Per gap (sorted), the innermost op of one thread's nested ``ops``
    (start_ns, end_ns, name) open at the gap's start, or None."""
    ops = sorted(ops, key=lambda o: (o[0], -o[1]))
    found, stack, j = [], [], 0
    for s, _ in gap_list:
        while j < len(ops) and ops[j][0] <= s:
            while stack and stack[-1][1] <= ops[j][0]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][1] <= s:
            stack.pop()
        found.append(stack[-1] if stack else None)
    return found


def name_gaps(gap_list, host_ops) -> Dict[str, float]:
    """Idle seconds by what the host was doing at each gap's start: of the
    innermost ops open then on each thread, the one that began last.
    ``host_ops``: (start_ns, end_ns, name, thread)."""
    gap_list = sorted(gap_list)
    by_thread = defaultdict(list)
    for s, e, n, t in host_ops:
        by_thread[t].append((s, e, n))
    per_thread = [_innermost(gap_list, ops) for ops in by_thread.values()]
    out: Dict[str, float] = defaultdict(float)
    for k, (s, e) in enumerate(gap_list):
        open_ops = [f[k] for f in per_thread if f[k] is not None]
        name = max(open_ops)[2] if open_ops else "(no host op)"
        out[name] += (e - s) * 1e-9
    return dict(out)


def _top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


class Traced:
    def __init__(self, fn: Callable[[], None]):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                fn()
        events = prof.profiler.kineto_results.events()
        dev, host, win = [], [], None
        for e in events:
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            if str(e.device_type()).endswith("CUDA"):
                # the window's own span is mirrored on the device's timeline
                if not e.is_user_annotation() and name != WINDOW:
                    dev.append((start, end, name))
            else:
                if name == WINDOW:
                    win = (start, end, e.start_thread_id())
                host.append((start, end, name, e.start_thread_id()))
        if win is None:
            raise RuntimeError("the traced window's span is missing from the trace")
        lo, hi, _ = win
        self.window_s = (hi - lo) * 1e-9
        dev = [d for d in dev if d[1] > lo and d[0] < hi]
        intervals = [(s, e) for s, e, _ in dev]
        self.busy_s = union_seconds(intervals, lo, hi)
        # copies and sets are named Memcpy... / Memset... on the device
        self.kernels = [(n, s, e - s) for s, e, n in dev
                        if not n.startswith(("Memcpy", "Memset"))]
        by_name: Dict[str, float] = defaultdict(float)
        for s, e, n in dev:
            by_name[n] += (e - s) * 1e-9
        self.device_ops = _top(by_name)
        ops = [h for h in host if h[2] != WINDOW and h[1] > lo and h[0] < hi]
        self.idle_gaps = _top(name_gaps(gaps(intervals, lo, hi), ops))

    def kernel_seconds(self, prefixes) -> float:
        return sum(d for n, _, d in self.kernels if n.startswith(tuple(prefixes))) * 1e-9
