"""The traced window put down to the program's layers.

The program records ``span:<name>`` ranges at its layer boundaries
(``deep3dmap_tpu_torch/utils/tracing.py``) through ``torch.profiler``, so
they share kineto's clock with the device's operations.  ``attribute``
reads the profiler's raw events (no tree is built) and gives each device
operation, each device-idle gap and each host wait to one span:

- a device operation goes to the innermost program span open on the thread
  of the host op that launched it (its ``linked_correlation_id``), at that
  op's start;
- inside an autograd node (``autograd::engine::evaluate_function: ...``,
  the backward) it goes to the span of the forward op with the node's
  ``sequence_nr`` on the node's ``fwd_thread_id``: the rule of
  ``chip_smoke.py::_hash_attribution``, on raw events.  A node with no such
  forward op hands over to what encloses it;
- a thread with nothing open hands over to the other threads: of the
  innermost marks open then on each, the one that began last (the rule of
  ``trace.name_gaps``).  Each idle gap goes by that rule from its start.

Each operation and each gap counts once; what no span covers is ``(none)``.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from . import trace

PREFIX = "span:"
NODE = "autograd::engine::evaluate_function: "
NONE = "(none)"
HOST_KINDS = ("cpu_op", "user_annotation")
RUNTIME_KINDS = ("cuda_runtime", "cuda_driver")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
# the spans of the layers below the step (the rest are the step's own)
LAYER_SPANS = ("nr.", "block_sparse.", "step.optimizer", "step.grad_reduce")


@dataclass
class Ev:
    """One profiler event: ``kind`` is kineto's activity type, ``device``
    whether it ran on the card; ``corr`` its correlation id, ``linked`` the
    correlation id of the host op it belongs to; ``seq``/``fwd_tid`` the
    autograd sequence number and forward thread."""
    name: str
    kind: str
    start: int
    end: int
    thread: int = 0
    device: bool = False
    corr: int = 0
    linked: int = 0
    seq: int = -1
    fwd_tid: int = 0


def _kind(e, dev: bool) -> str:
    """kineto's activity type; from the name where the event does not say
    (older torch): the host's CUDA runtime and driver calls are ``cuda*`` /
    ``cu*``."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if dev:
        return "kernel"
    if e.is_user_annotation():
        return "user_annotation"
    return "cuda_runtime" if e.name().startswith("cu") else "cpu_op"


def from_kineto(events) -> List[Ev]:
    out = []
    for e in events:
        dev = str(e.device_type()).endswith("CUDA")
        if dev and e.is_user_annotation():
            continue                      # a span's mirror on the device's timeline
        s = e.start_ns()
        out.append(Ev(e.name(), _kind(e, dev), s, s + e.duration_ns(), e.start_thread_id(),
                      dev, e.correlation_id(), e.linked_correlation_id(), e.sequence_nr(),
                      e.fwd_thread_id()))
    return out


def _open_at(queries: List[Tuple[int, int]], marks: List[Ev]) -> List[list]:
    """For (time, index) queries sorted by time: the stack of ``marks`` (one
    thread's nested intervals) open at each time, outermost first."""
    marks = sorted(marks, key=lambda m: (m.start, -m.end))
    out, stack, j = [None] * len(queries), [], 0
    for t, k in queries:
        while j < len(marks) and marks[j].start <= t:
            while stack and stack[-1].end <= marks[j].start:
                stack.pop()
            stack.append(marks[j])
            j += 1
        while stack and stack[-1].end <= t:
            stack.pop()
        out[k] = list(stack)
    return out


class _Resolver:
    """(thread, time) -> (span, 'fwd' or 'bwd'), for many queries at once."""

    def __init__(self, host: List[Ev]):
        self.marks = defaultdict(list)
        fwd_ops = defaultdict(list)
        for e in host:
            if e.name.startswith(PREFIX) or e.name.startswith(NODE):
                self.marks[e.thread].append(e)
            elif e.seq >= 0 and e.fwd_tid == 0 and e.kind == "cpu_op":
                fwd_ops[e.thread].append(e)
        # the span of each forward op, by (sequence number, thread)
        self.fwd_span: Dict[Tuple[int, int], str] = {}
        for thread, ops in fwd_ops.items():
            spans = [m for m in self.marks[thread] if m.name.startswith(PREFIX)]
            stacks = _open_at(sorted((o.start, k) for k, o in enumerate(ops)), spans)
            for o, st in zip(ops, stacks):
                if st:
                    self.fwd_span.setdefault((o.seq, thread), st[-1].name[len(PREFIX):])

    def _from_stack(self, stack) -> Optional[Tuple[str, str, int]]:
        for m in reversed(stack):
            if m.name.startswith(PREFIX):
                return m.name[len(PREFIX):], "fwd", m.start
            name = self.fwd_span.get((m.seq, m.fwd_tid))
            if name is not None:
                return name, "bwd", m.start
        return None

    def solve(self, queries: List[Tuple[Optional[int], int]]) -> List[Tuple[str, str]]:
        """``queries``: (thread or None, time).  Each resolves on its own
        thread, else by the latest-begun rule over every thread."""
        by_thread = {th: sorted((t, k) for k, (_, t) in enumerate(queries))
                     for th in self.marks}
        found = defaultdict(dict)
        for th, qs in by_thread.items():
            for k, st in enumerate(_open_at(qs, self.marks[th])):
                r = self._from_stack(st)
                if r is not None:
                    found[k][th] = r
        out = []
        for k, (thread, _) in enumerate(queries):
            cand = found.get(k, {})
            r = cand.get(thread) if thread is not None else None
            if r is None and cand:
                r = max(cand.values(), key=lambda x: x[2])
            out.append((r[0], r[1]) if r else (NONE, "fwd"))
        return out


def _row():
    return dict(calls=0, host_ms=0.0, fwd_kernels=0, fwd_ms=0.0, bwd_kernels=0, bwd_ms=0.0,
                idle_ms=0.0)


def attribute(events: List[Ev], lo: int, hi: int, units: int) -> dict:
    """The window ``[lo, hi)`` ns by program span, per traced unit:
    ``layers`` (per span: calls, inclusive host ms, forward and backward
    kernels and device ms, idle ms), ``host_waits`` (per span: the host's
    synchronising runtime calls and device-to-host copies, [calls, ms] over
    the window), ``shares`` of the window's device and idle time, and
    ``idle_gaps`` as ``trace.name_gaps`` names them (seconds, most first)."""
    host = [e for e in events if not e.device and e.kind in HOST_KINDS]
    runtime = [e for e in events if not e.device and e.kind in RUNTIME_KINDS]
    dev = [e for e in events if e.device and e.end > lo and e.start < hi]
    op_by_corr = {e.corr: e for e in host}
    rt_by_corr = {e.corr: e for e in runtime}
    dev_by_corr = {e.corr: e for e in dev}

    found = defaultdict(int)        # how each launch point was found

    def launch_point(e: Ev):
        op = op_by_corr.get(e.linked)
        if op is not None:
            found["host_op"] += 1
            return op.thread, op.start
        rt = rt_by_corr.get(e.corr)
        found["runtime" if rt is not None else "own_start"] += 1
        return (None, rt.start) if rt is not None else (None, e.start)

    waits = [r for r in runtime if lo <= r.start < hi and (
        r.name.startswith(SYNCS) or (r.name.startswith("cudaMemcpy")
                                     and "DtoH" in getattr(dev_by_corr.get(r.corr), "name", "")))]
    intervals = [(e.start, e.end) for e in dev]
    gap_list = trace.gaps(intervals, lo, hi)
    queries = ([launch_point(e) for e in dev] + [launch_point(w) for w in waits]
               + [(None, s) for s, _ in gap_list])
    who = _Resolver(host).solve(queries)
    n_dev, n_wait = len(dev), len(waits)

    rows = defaultdict(_row)
    for e in host:
        if e.name.startswith(PREFIX) and e.end > lo and e.start < hi:
            r = rows[e.name[len(PREFIX):]]
            r["calls"] += 1
            r["host_ms"] += (e.end - e.start) * 1e-6
    for e, (name, way) in zip(dev, who[:n_dev]):
        r = rows[name]
        r[way + "_ms"] += (e.end - e.start) * 1e-6
        if not e.name.startswith(("Memcpy", "Memset")):
            r[way + "_kernels"] += 1
    host_waits = defaultdict(lambda: defaultdict(lambda: [0, 0.0]))
    for w, (name, _) in zip(waits, who[n_dev:n_dev + n_wait]):
        h = host_waits[name][w.name]
        h[0] += 1
        h[1] += (w.end - w.start) * 1e-6
    for (s, e), (name, _) in zip(gap_list, who[n_dev + n_wait:]):
        rows[name]["idle_ms"] += (e - s) * 1e-6

    dev_ms = {k: r["fwd_ms"] + r["bwd_ms"] for k, r in rows.items()}
    total_dev = sum(dev_ms.values())
    total_idle = sum(r["idle_ms"] for r in rows.values())
    named = trace.name_gaps(gap_list, [(e.start, e.end, e.name, e.thread) for e in host
                                       if e.end > lo and e.start < hi])
    shares = dict(
        busy_attributed=1.0 - dev_ms.get(NONE, 0.0) / total_dev if total_dev else None,
        idle_to_layers=(sum(r["idle_ms"] for k, r in rows.items() if k.startswith(LAYER_SPANS))
                        / total_idle if total_idle else None),
        idle_no_host_op=named.get("(no host op)", 0.0) * 1e3 / total_idle if total_idle else None)
    order = sorted(rows, key=lambda k: -(dev_ms[k] + rows[k]["idle_ms"]))
    return dict(layers={k: {f: v / units for f, v in rows[k].items()} for k in order},
                host_waits={k: dict(v) for k, v in host_waits.items()}, shares=shares,
                idle_gaps=trace._top(named), launch_points=dict(found), units=units,
                window_ms=(hi - lo) * 1e-6, busy_ms=trace.union_seconds(intervals, lo, hi) * 1e3,
                device_ms=total_dev, idle_ms=total_idle)


def window(events: List[Ev]) -> Tuple[int, int]:
    """The benchmark's traced window span, ``trace.WINDOW``."""
    for e in events:
        if not e.device and e.name == trace.WINDOW:
            return e.start, e.end
    raise RuntimeError("the traced window's span is missing from the trace")


def profile_layers(fn, units: int) -> dict:
    """``fn()`` under ``torch.profiler`` (CPU and CUDA) inside the window
    span, then ``attribute`` over the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            fn()
    events = from_kineto(prof.profiler.kineto_results.events())
    lo, hi = window(events)
    return attribute([e for e in events if e.name != trace.WINDOW], lo, hi, units)
