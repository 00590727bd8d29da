"""The collectives the port's multi-GPU paths issue, counted by kind.

Every collective of ``parallel/``, the fused loss's cross-rank sums and the
gradient reduction of ``runners/train_state.py`` goes through here, so that
``counts()`` says what a step issued (``tools/benchmark_scaling.py`` reports
it per step, in place of the HLO collective counts the JAX tool reads).

NCCL groups take CUDA tensors and gloo groups CPU tensors as they are.  A
gloo group handed CUDA tensors (two ranks sharing one card, where NCCL
refuses a second rank on the device) copies each tensor through pinned host
memory around the collective: ``_staged``, the one place that route exists.
It waits for the card on every call, so it serves checks, not speed; the
compute never leaves the card.  A failed collective raises.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from ..utils import tracing

_COUNTER = "collectives."     # the registry's counters, one per kind


def counts() -> Dict[str, int]:
    """Collective calls since the last reset, by kind."""
    return {k[len(_COUNTER):]: v for k, v in tracing.read_counters(_COUNTER).items()}


def reset_counts() -> None:
    tracing.reset_counters(_COUNTER)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(group, tensors: Sequence[torch.Tensor]) -> bool:
    """True when ``group`` is a gloo group and the tensors lie on the card:
    they then travel through pinned host copies."""
    return (any(t.is_cuda for t in tensors)
            and dist.get_backend(group) == dist.Backend.GLOO)


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu").pin_memory() if t.is_cuda else t


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place ``all_reduce`` of ``t`` over ``group``; returns ``t``."""
    tracing.count(_COUNTER + "all_reduce")
    if _staged(group, [t]):
        h = _host(t)
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
        return t
    dist.all_reduce(t, op=op, group=group)
    return t


def broadcast(t: torch.Tensor, src: int) -> torch.Tensor:
    """In-place ``broadcast`` over every rank from rank ``src``; returns ``t``."""
    tracing.count(_COUNTER + "broadcast")
    if _staged(None, [t]):
        h = _host(t)
        dist.broadcast(h, src)
        t.copy_(h)
        return t
    dist.broadcast(t, src)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along dim 0, in rank order."""
    tracing.count(_COUNTER + "all_gather")
    n = group_size(group)
    t = t.contiguous()
    if _staged(group, [t]):
        h = _host(t)
        out = torch.empty((n * h.shape[0],) + tuple(h.shape[1:]), dtype=h.dtype)
        dist.all_gather_into_tensor(out, h, group=group)
        return out.to(t.device)
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks of ``t``, split along dim 0: this rank's part."""
    tracing.count(_COUNTER + "reduce_scatter")
    n = group_size(group)
    t = t.contiguous()
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 ({t.shape[0]}) does not divide over "
                         f"{n} ranks")
    if _staged(group, [t]):
        h = _host(t)
        out = torch.empty((h.shape[0] // n,) + tuple(h.shape[1:]), dtype=h.dtype)
        dist.reduce_scatter_tensor(out, h, group=group)
        return out.to(t.device)
    out = torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.reduce_scatter_tensor(out, t, group=group)
    return out


def exchange(sends: Sequence, recvs: Sequence, group) -> List[torch.Tensor]:
    """Point-to-point in one ``batch_isend_irecv``: ``sends`` holds
    (tensor, group rank) pairs, ``recvs`` (template tensor, group rank)
    pairs; returns one received tensor per ``recvs`` entry, shaped and
    typed as its template."""
    tracing.count(_COUNTER + "send_recv")
    ts = [t for t, _ in sends] + [t for t, _ in recvs]
    staged = bool(ts) and _staged(group, ts)
    ops, outs = [], []
    for t, peer in sends:
        src = _host(t.contiguous()) if staged else t.contiguous()
        ops.append(dist.P2POp(dist.isend, src, dist.get_global_rank(group, peer), group))
    for t, peer in recvs:
        buf = (torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if staged
               else torch.empty_like(t, memory_format=torch.contiguous_format))
        outs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, peer), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    dev = ts[0].device if ts else None
    return [o.to(dev) if staged else o for o in outs]


class AllReduceSum(torch.autograd.Function):
    """``all_reduce(SUM)`` whose backward all-reduces the cotangent: the
    derivative of a sum over ranks for a loss that every rank computes."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _GlobalSums(torch.autograd.Function):
    """The ranks' sums of each 0-d ``x`` (forward, one ``all_reduce``); the
    cotangent passed to this rank's ``x`` unchanged (backward).  Every rank
    then holds the global value, and its gradient flows through its own
    shard only: summed over the ranks (``reduce_gradients``) it is the
    global gradient."""

    @staticmethod
    def forward(ctx, group, *xs):
        return tuple(all_reduce(torch.stack([x.detach() for x in xs]), group).unbind())

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + gs


def global_mean(x: torch.Tensor, group, count=None, min_count: float = 0.0):
    """A batch reduction of this rank's shard ``x`` taken over the global
    batch whose shards the ranks of ``group`` hold: ``x.mean()``, or with
    ``count`` (the shard's mask mass) ``x.sum() / max(count, min_count)``,
    the sums and counts all-reduced in one call.  At one rank (``group``
    None or of size 1) the shard's own expression, as it always was."""
    if group_size(group) <= 1:
        if count is None:
            return x.mean()
        return x.sum() / torch.clamp(count, min=min_count)
    s = x.sum()
    n = s.new_tensor(x.numel()) if count is None else count.to(s.dtype)
    s, n = _GlobalSums.apply(group, s, n)
    return s / (n if count is None else torch.clamp(n, min=min_count))


def rank_slice(tree, group):
    """This rank's contiguous share, along dim 0, of every tensor of
    ``tree`` (dicts and lists) whose leading dim divides over ``group``;
    0-d tensors stay whole.  The draws of a global batch (made alike on
    every rank from one generator) become this rank's draws."""
    n, r = group_size(group), group_rank(group)
    if n <= 1:
        return tree
    if isinstance(tree, dict):
        return {k: rank_slice(v, group) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rank_slice(v, group) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dim() and tree.shape[0] % n == 0:
        k = tree.shape[0] // n
        return tree[r * k:(r + 1) * k]
    return tree


class SumGradOver(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over ``group``.  A
    replicated weight whose use is split over the ranks (a conv on one
    slab of the volume each) gets its whole gradient this way."""

    @staticmethod
    def forward(ctx, w, group):
        ctx.group = group
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class SplitRows(torch.autograd.Function):
    """This rank's slab of a replicated ``x`` along ``dim`` (forward), the
    slabs' cotangents gathered back to the whole (backward): the
    replicated computation upstream then sees the whole gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n, r = group_size(group), group_rank(group)
        k = x.shape[dim] // n
        return x.narrow(dim, r * k, k).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_rows(g, ctx.group, ctx.dim), None, None


class GatherRows(torch.autograd.Function):
    """The ranks' slabs concatenated along ``dim`` (forward), this rank's
    slab of the cotangent (backward): every rank then computes the same
    loss from the whole, so the whole's cotangent is replicated."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_rows(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n, r = group_size(ctx.group), group_rank(ctx.group)
        k = g.shape[ctx.dim] // n
        return g.narrow(ctx.dim, r * k, k).contiguous(), None, None


def gather_rows(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``all_gather`` along ``dim`` (not differentiable)."""
    if group_size(group) == 1:
        return x
    out = all_gather(x.detach().movedim(dim, 0), group)
    return out.movedim(0, dim).contiguous()


def reduce_gradients(params, group, bucket_bytes: int = 25 * 2 ** 20) -> None:
    """``all_reduce(SUM)`` of the parameters' gradients over ``group``, in
    buckets of at most ``bucket_bytes`` per dtype, flattened in parameter
    order.  Parameters without a gradient are left out (the model's
    structure decides that, the same on every rank)."""
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault((p.grad.dtype, p.grad.device), []).append(p.grad)
    for grads in by_dtype.values():
        buckets, size = [[]], 0
        for g in grads:
            n = g.numel() * g.element_size()
            if buckets[-1] and size + n > bucket_bytes:
                buckets.append([])
                size = 0
            buckets[-1].append(g)
            size += n
        for bucket in buckets:
            flat = all_reduce(torch.cat([g.reshape(-1) for g in bucket]), group)
            for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
                g.copy_(part.view_as(g))
