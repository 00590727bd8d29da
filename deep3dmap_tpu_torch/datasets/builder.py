"""Dataset/pipeline registries, the host loader and the device prefetch
(port of ``deep3dmap_tpu/datasets/builder.py:17-227``).

The loader is a host iterator of numpy batch dicts; ``prefetch_to_device``
uploads batch N+1 from pinned host memory on a side CUDA stream while the
step of batch N runs.  Not ported: the dataset wrappers (``ConcatDataset``,
``RepeatDataset``, ...) and the samplers (distributed or grouped); asking for
them raises ``NotImplementedError``.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..utils.registry import Registry

DATASETS = Registry("dataset")
PIPELINES = Registry("pipeline")

_LATER = "is not ported yet (ROADMAP.md Queue 1, the runtime's leftovers)"
_WRAPPERS = ("ConcatDataset", "RepeatDataset", "ClassBalancedDataset",
             "MultiImageMixDataset")


def build_dataset(cfg, default_args=None):
    """The dataset a ``data.train``/``data.test`` config names."""
    from . import (face_tuple, face_uv, gan_faces, nerf_synthetic,  # noqa: F401  (register)
                   pipelines, real_files, scannet, synthetic)

    if isinstance(cfg, (list, tuple)) or cfg["type"] in _WRAPPERS:
        raise NotImplementedError(f"dataset wrappers {_LATER}")
    return DATASETS.build(dict(cfg), **(default_args or {}))


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


class NumpyLoader:
    """Batches a map-style dataset of dict samples into stacked numpy arrays,
    in the JAX loader's order: ``np.random.RandomState(seed + epoch)``
    shuffles ``arange(len)`` each epoch.  With ``num_workers > 0`` a thread
    pool builds up to ``num_workers * prefetch_factor`` batches ahead,
    yielded in order."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True, num_workers: int = 0,
                 prefetch_factor: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch_factor = max(1, prefetch_factor)
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _epoch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rs = np.random.RandomState(self.seed + self.epoch)
            rs.shuffle(idx)
        self.epoch += 1
        return idx

    def _build(self, indices):
        return _stack_samples([self.dataset[int(i)] for i in indices])

    def __iter__(self):
        idx = self._epoch_indices()
        starts = range(0, len(idx) - (self.batch_size - 1 if self.drop_last else 0),
                       self.batch_size)
        slices = [idx[s:s + self.batch_size] for s in starts]
        if self.num_workers <= 0:
            for sl in slices:
                yield self._build(sl)
            return
        depth = self.num_workers * self.prefetch_factor
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = deque()
            it = iter(slices)
            for sl in it:
                pending.append(pool.submit(self._build, sl))
                if len(pending) >= depth:
                    break
            while pending:
                batch = pending.popleft().result()
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.submit(self._build, nxt))
                yield batch


def _is_numeric(v) -> bool:
    return (isinstance(v, torch.Tensor)
            or (isinstance(v, (np.ndarray, np.generic)) and v.dtype.kind in "biuf"))


def _host_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    if a.dtype == np.float64:   # JAX canonicalises float64 to float32
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def upload_batch(batch: dict, device, non_blocking: bool = False) -> dict:
    """Numeric arrays (and lists of them) of a batch -> tensors on
    ``device``; strings and other metadata stay as they are.  With
    ``non_blocking`` on a CUDA device the host copies are pinned first."""
    dev = torch.device(device)
    pin = non_blocking and dev.type == "cuda"

    def put(v):
        t = _host_tensor(v)
        if pin and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(dev, non_blocking=non_blocking)

    out = {}
    for k, v in batch.items():
        if isinstance(v, (list, tuple)) and v and all(_is_numeric(x) for x in v):
            out[k] = [put(x) for x in v]
        elif _is_numeric(v):
            out[k] = put(v)
        else:
            out[k] = v
    return out


def prefetch_to_device(iterable, device, depth: int = 2, host_check=None):
    """Overlap host batch building and the host -> device copy with the step.

    Pulls ``depth`` batches ahead of the consumer.  Each batch is checked by
    ``host_check`` on the host (on the caller's thread, so its errors surface
    at once), then copied from pinned memory on a side CUDA stream; the
    consumer's stream waits for that copy before it gets the batch, and each
    tensor is marked as used on the consumer's stream so the allocator does
    not reuse it early.  On the CPU the batch is converted to tensors.
    """
    dev = torch.device(device)
    if dev.type != "cuda":
        for batch in iterable:
            if host_check is not None:
                host_check(batch)
            yield upload_batch(batch, dev)
        return
    side = torch.cuda.Stream(device=dev)
    buf = deque()

    def submit(batch):
        if host_check is not None:
            host_check(batch)
        with torch.cuda.stream(side):
            up = upload_batch(batch, dev, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(side)
        buf.append((up, ev))

    it = iter(iterable)
    for batch in it:
        submit(batch)
        if len(buf) >= max(1, depth):
            break
    while buf:
        up, ev = buf.popleft()
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(ev)
        for v in up.values():
            for t in (v if isinstance(v, list) else [v]):
                if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                    t.record_stream(consumer)
        nxt = next(it, None)
        if nxt is not None:
            submit(nxt)
        yield up


def build_dataloader(dataset, samples_per_gpu: int = 1, workers_per_gpu: int = 0,
                     num_gpus: int = 1, dist: bool = False, shuffle: bool = True,
                     seed: Optional[int] = None, **kwargs) -> NumpyLoader:
    """The JAX ``build_dataloader`` on one card: ``samples_per_gpu *
    num_gpus`` samples per batch, ``workers_per_gpu`` loader threads."""
    if dist or (shuffle and hasattr(dataset, "flag")):
        raise NotImplementedError(f"distributed and grouped samplers {_LATER}")
    return NumpyLoader(dataset, batch_size=samples_per_gpu * num_gpus,
                       shuffle=shuffle, seed=seed or 0,
                       num_workers=workers_per_gpu,
                       prefetch_factor=kwargs.get("prefetch_factor", 2))
