"""Index samplers (port of ``deep3dmap_tpu/datasets/samplers.py``):
group-aware, distributed and video-sequential, numpy only.

The same ``np.random.RandomState`` draws in the same order as the JAX
package's, so the index streams are equal.  ``rank``/``num_replicas``
default to ``torch.distributed``'s when it is initialised, else (0, 1).
"""
from __future__ import annotations

import math
from typing import Iterator, List

import numpy as np


def get_dist_info():
    """``parallel.mesh.get_dist_info``, imported at the call: the samplers
    import no torch until a distributed one asks for its rank."""
    from ..parallel.mesh import get_dist_info as info

    return info()


class GroupSampler:
    """Shuffled sampler keeping each ``samples_per_gpu`` block inside one
    aspect-ratio group (``dataset.flag``)."""

    def __init__(self, dataset, samples_per_gpu: int = 1, seed: int = 0):
        assert hasattr(dataset, "flag")
        self.dataset = dataset
        self.samples_per_gpu = samples_per_gpu
        self.flag = np.asarray(dataset.flag, np.int64)
        self.group_sizes = np.bincount(self.flag)
        self.seed = seed
        self.epoch = 0
        self.num_samples = int(sum(
            math.ceil(size / samples_per_gpu) * samples_per_gpu
            for size in self.group_sizes))

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        rs = np.random.RandomState(self.seed + self.epoch)
        indices: List[np.ndarray] = []
        for i, size in enumerate(self.group_sizes):
            if size == 0:
                continue
            indice = np.where(self.flag == i)[0]
            rs.shuffle(indice)
            num_extra = int(np.ceil(size / self.samples_per_gpu)
                            ) * self.samples_per_gpu - len(indice)
            indice = np.concatenate([indice, rs.choice(indice, num_extra)])
            indices.append(indice)
        cat = np.concatenate(indices)
        blocks = cat.reshape(-1, self.samples_per_gpu)
        blocks = blocks[rs.permutation(len(blocks))]
        flat = blocks.reshape(-1).astype(np.int64)
        assert len(flat) == self.num_samples
        return iter(flat.tolist())

    def __len__(self):
        return self.num_samples


class DistributedSampler:
    """Even split of a (optionally shuffled) index permutation across ranks
    (deterministic epoch + seed shuffling)."""

    def __init__(self, dataset, num_replicas=None, rank=None,
                 shuffle: bool = True, seed: int = 0):
        _rank, _world = get_dist_info()
        self.dataset = dataset
        self.num_replicas = num_replicas if num_replicas is not None else _world
        self.rank = rank if rank is not None else _rank
        self.shuffle = shuffle
        self.seed = seed if seed is not None else 0
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.num_replicas))
        self.total_size = self.num_samples * self.num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            rs = np.random.RandomState(self.epoch + self.seed)
            indices = rs.permutation(len(self.dataset))
        else:
            indices = np.arange(len(self.dataset))
        # pad to make evenly divisible
        pad = self.total_size - len(indices)
        if pad > 0:
            indices = np.concatenate([indices, indices[:pad]])
        indices = indices[self.rank:self.total_size:self.num_replicas]
        assert len(indices) == self.num_samples
        return iter(indices.astype(np.int64).tolist())

    def __len__(self):
        return self.num_samples


class DistributedGroupSampler(DistributedSampler):
    """Group-aware distributed sampler: pads each
    flag group to a multiple of ``samples_per_gpu * num_replicas`` by cyclic
    repetition, shuffles whole sample blocks, then strides rank-contiguous
    slices."""

    def __init__(self, dataset, samples_per_gpu: int = 1, num_replicas=None,
                 rank=None, seed: int = 0):
        super().__init__(dataset, num_replicas=num_replicas, rank=rank,
                         shuffle=True, seed=seed)
        assert hasattr(dataset, "flag")
        self.samples_per_gpu = samples_per_gpu
        self.flag = np.asarray(dataset.flag, np.int64)
        self.group_sizes = np.bincount(self.flag)
        self.num_samples = int(sum(
            math.ceil(size / samples_per_gpu / self.num_replicas)
            * samples_per_gpu for size in self.group_sizes))
        self.total_size = self.num_samples * self.num_replicas

    def __iter__(self) -> Iterator[int]:
        rs = np.random.RandomState(self.epoch + self.seed)
        indices: List[int] = []
        for i, size in enumerate(self.group_sizes):
            if size == 0:
                continue
            indice = np.where(self.flag == i)[0]
            indice = indice[rs.permutation(int(size))].tolist()
            extra = int(math.ceil(
                size / self.samples_per_gpu / self.num_replicas)
            ) * self.samples_per_gpu * self.num_replicas - len(indice)
            tmp = indice.copy()
            for _ in range(extra // size):
                indice.extend(tmp)
            indice.extend(tmp[:extra % size])
            indices.extend(indice)
        assert len(indices) == self.total_size
        arr = np.asarray(indices, np.int64).reshape(-1, self.samples_per_gpu)
        arr = arr[rs.permutation(len(arr))].reshape(-1)
        offset = self.num_samples * self.rank
        out = arr[offset:offset + self.num_samples]
        assert len(out) == self.num_samples
        return iter(out.tolist())


class DistributedVideoSampler(DistributedSampler):
    """Sequential per-rank video chunks for testing: split at frame_id==0
    boundaries so no video straddles two ranks."""

    def __init__(self, dataset, num_replicas=None, rank=None,
                 shuffle: bool = False):
        super().__init__(dataset, num_replicas=num_replicas, rank=rank,
                         shuffle=shuffle)
        assert not self.shuffle, "Specific for video sequential testing."
        self.num_samples = len(dataset)
        first_frame_indices = [
            i for i, info in enumerate(dataset.data_infos)
            if info["frame_id"] == 0]
        if len(first_frame_indices) < self.num_replicas:
            raise ValueError(
                f"only {len(first_frame_indices)} videos loaded, but "
                f"{self.num_replicas} shards were given.")
        chunks = np.array_split(first_frame_indices, self.num_replicas)
        split_flags = [int(c[0]) for c in chunks] + [self.num_samples]
        self.indices = [
            list(range(split_flags[i], split_flags[i + 1]))
            for i in range(self.num_replicas)]

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices[self.rank])

    def __len__(self):
        return len(self.indices[self.rank])
