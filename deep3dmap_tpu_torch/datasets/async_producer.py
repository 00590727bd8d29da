"""Push-style async datasets: producer processes and shared-memory slots
(the port of ``deep3dmap_tpu/datasets/async_producer.py``).

N producer processes build the wrapped dataset in their own process and
fill a pool of shared-memory float32 slots with stacked batches; ``get()``
returns the next ready batch, and a free-slot queue recycles the slots.
Only slot indices and shapes cross the result queue.  This is the
``use_data_loaders=False`` path ``StateMachineRunner`` drives.

The producers import no torch: the package's exports are lazy and, in a
process without torch, ``build_dataset`` imports only the module that
registers the wrapped type (``SyntheticFaceUVDataset`` and
``ThreeHundredWLPDataset`` need no torch).
Each producer also hides the card from its process before it builds
anything, the twin of JAX's CPU pin, so a wrapped dataset that does import
torch still never opens a CUDA context.  The spawned processes
re-import the parent's main script, as ``spawn`` does: a main script that
imports torch brings torch into them.
"""
from __future__ import annotations

import ctypes
import multiprocessing as mp
from typing import Dict, List, Optional, Sequence

import numpy as np

from .builder import DATASETS

_SENTINEL = None


def _producer_loop(dataset_cfg, batch_size, keys, n_slots, arrays, result_q, free_q,
                   seed, epoch_mode, torch_flags, index):
    """Worker: build the dataset locally, fill free slots with batches."""
    import os
    import sys

    os.environ["CUDA_VISIBLE_DEVICES"] = ""   # never let a data worker claim the card

    from .builder import _stack_samples, build_dataset

    ds = build_dataset(dict(dataset_cfg))
    rs = np.random.RandomState(seed)
    views = {k: np.frombuffer(arrays[k].get_obj(), np.float32).reshape(n_slots, -1)
             for k in keys}
    order = np.arange(len(ds))
    pos = len(order)  # force an initial shuffle
    while True:
        slot = free_q.get()
        if slot is _SENTINEL:
            break
        if epoch_mode:
            if pos + batch_size > len(order):
                rs.shuffle(order)
                pos = 0
            idxs = order[pos:pos + batch_size]
            pos += batch_size
        else:
            idxs = rs.randint(0, len(ds), batch_size)
        batch = _stack_samples([ds[int(i)] for i in idxs])
        shapes = {}
        for k in keys:
            a = np.ascontiguousarray(batch[k], np.float32).ravel()
            views[k][slot, :a.size] = a
            shapes[k] = np.asarray(batch[k]).shape
        torch_flags[index] = int("torch" in sys.modules)
        result_q.put((slot, shapes))


@DATASETS.register_module()
class AsyncProducerDataset:
    """Producer-process dataset pool over any registered dataset cfg.

    get() -> dict of float32 numpy arrays (one ready batch)."""

    state = "sup"

    def __init__(self, dataset: dict, batch_size: int = 1, nthread: int = 2,
                 n_slots: int = 4, seed: int = 123, state: Optional[str] = None,
                 epoch_mode: bool = True, keys: Optional[Sequence[str]] = None):
        if state is not None:
            self.state = state
        self.batch_size = batch_size
        self._cfg = dict(dataset)

        # probe one sample in-process for keys/shapes
        from .builder import build_dataset

        probe_ds = build_dataset(dict(dataset))
        self._len = len(probe_ds)
        self.iter_size = max(1, self._len // batch_size)
        probe = probe_ds[0]
        self.keys: List[str] = list(keys) if keys else [
            k for k, v in probe.items() if isinstance(v, np.ndarray) or np.isscalar(v)]
        slot_elems = {k: int(batch_size * max(1, np.asarray(probe[k]).size))
                      for k in self.keys}

        ctx = mp.get_context("spawn")
        self._arrays = {k: ctx.Array(ctypes.c_float, n_slots * slot_elems[k])
                        for k in self.keys}
        self._views = {k: np.frombuffer(self._arrays[k].get_obj(), np.float32)
                       .reshape(n_slots, -1) for k in self.keys}
        self._result = ctx.Queue()
        self._free = ctx.Queue()
        for i in range(n_slots):
            self._free.put(i)
        # 1 where a producer's process held torch when it pushed a batch
        self._torch_flags = ctx.Array(ctypes.c_int, [-1] * nthread, lock=False)

        self._procs = []
        for i in range(nthread):
            p = ctx.Process(
                target=_producer_loop,
                args=(self._cfg, batch_size, self.keys, n_slots, self._arrays, self._result,
                      self._free, seed + i, epoch_mode, self._torch_flags, i),
                daemon=True)
            p.start()
            self._procs.append(p)

    def __len__(self):
        return self._len

    def get(self, timeout: float = 120.0) -> Dict[str, np.ndarray]:
        """Pull the next ready batch."""
        slot, shapes = self._result.get(timeout=timeout)
        out = {}
        for k in self.keys:
            size = int(np.prod(shapes[k])) if shapes[k] else 1
            arr = np.array(self._views[k][slot, :size], copy=True)
            out[k] = arr.reshape(shapes[k])
        self._free.put(slot)
        return out

    def __iter__(self):
        for _ in range(self.iter_size):
            yield self.get()

    def producers_imported_torch(self) -> List[Optional[bool]]:
        """Per producer: whether its process held torch when it last pushed a
        batch (None before its first batch)."""
        return [None if f < 0 else bool(f) for f in self._torch_flags]

    def close(self):
        for _ in self._procs:
            self._free.put(_SENTINEL)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
        self._procs = []

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:
            pass


@DATASETS.register_module()
class FaceTexUVAsyncDataset(AsyncProducerDataset):
    """Supervised face tex-UV tuples via producers."""

    state = "sup"


@DATASETS.register_module()
class FaceImagesAsyncDataset(AsyncProducerDataset):
    """Unsupervised face image tuples via producers."""

    state = "sup_unsup"
