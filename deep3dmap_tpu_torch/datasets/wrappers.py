"""Dataset wrappers (port of ``deep3dmap_tpu/datasets/wrappers.py``):
Concat / Repeat / ClassBalanced / MultiImageMix, host-side composition in
plain Python and numpy, with the JAX package's semantics:

- ``ConcatDataset(separate_eval=...)``: index bisection over cumulative
  sizes, per-dataset (keys prefixed ``<i>_``) or joint ``evaluate``;
- ``RepeatDataset(times)``: modular indexing;
- ``ClassBalancedDataset(oversample_thr)``: LVIS-style repeat factors
  ``max(1, sqrt(thr / freq))`` per category;
- ``MultiImageMixDataset``: pipeline stages (built from ``PIPELINES``) may
  declare ``get_indexes(dataset)`` to pull extra samples, handed to the
  transform as ``results['mix_results']``.
"""
from __future__ import annotations

import bisect
import collections
import copy
import math
from typing import List

import numpy as np

from .builder import DATASETS, PIPELINES


@DATASETS.register_module()
class ConcatDataset:
    """Concatenation of multiple datasets with optional separate evaluation."""

    def __init__(self, datasets: List, separate_eval: bool = True):
        assert len(datasets) > 0
        self.datasets = datasets
        self.separate_eval = separate_eval
        self.cumulative_sizes = np.cumsum([len(d) for d in datasets]).tolist()
        self.CLASSES = getattr(datasets[0], "CLASSES", None)
        if hasattr(datasets[0], "flag"):
            self.flag = np.concatenate([d.flag for d in datasets])

    def __len__(self):
        return self.cumulative_sizes[-1]

    def _locate(self, idx: int):
        if idx < 0:
            if -idx > len(self):
                raise ValueError("index out of range")
            idx = len(self) + idx
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        sample_idx = idx if ds_idx == 0 else idx - self.cumulative_sizes[ds_idx - 1]
        return ds_idx, sample_idx

    def __getitem__(self, idx: int):
        ds_idx, sample_idx = self._locate(idx)
        return self.datasets[ds_idx][sample_idx]

    def get_cat_ids(self, idx: int):
        ds_idx, sample_idx = self._locate(idx)
        return self.datasets[ds_idx].get_cat_ids(sample_idx)

    def evaluate(self, results, logger=None, **kwargs):
        if self.separate_eval:
            if isinstance(results, (list, tuple)):
                assert len(results) == len(self), (
                    f"results length {len(results)} != dataset length {len(self)}")
            total_eval_results = {}
            start = 0
            for ds_idx, (ds, end) in enumerate(
                    zip(self.datasets, self.cumulative_sizes)):
                part = results[start:end] if isinstance(results, (list, tuple)) \
                    else results
                start = end
                eval_results = ds.evaluate(part, logger=logger, **kwargs)
                for name, val in eval_results.items():
                    total_eval_results[f"{ds_idx}_{name}"] = val
            return total_eval_results
        # joint eval requires homogeneous datasets (dataset_wrappers.py:102-120)
        types = {type(ds) for ds in self.datasets}
        if len(types) != 1:
            raise NotImplementedError(
                "joint evaluate needs all datasets of the same type")
        return self.datasets[0].evaluate(results, logger=logger, **kwargs)


@DATASETS.register_module()
class RepeatDataset:
    """Repeat a dataset ``times`` times by modular indexing."""

    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times
        self.CLASSES = getattr(dataset, "CLASSES", None)
        if hasattr(dataset, "flag"):
            self.flag = np.tile(dataset.flag, times)
        self._ori_len = len(dataset)

    def __getitem__(self, idx: int):
        return self.dataset[idx % self._ori_len]

    def get_cat_ids(self, idx: int):
        return self.dataset.get_cat_ids(idx % self._ori_len)

    def __len__(self):
        return self.times * self._ori_len


@DATASETS.register_module()
class ClassBalancedDataset:
    """Oversample images containing rare categories (LVIS recipe).

    repeat_factor(img) = max over its categories c of
    ``max(1, sqrt(oversample_thr / freq(c)))``.
    """

    def __init__(self, dataset, oversample_thr: float,
                 filter_empty_gt: bool = True):
        self.dataset = dataset
        self.oversample_thr = oversample_thr
        self.filter_empty_gt = filter_empty_gt
        self.CLASSES = getattr(dataset, "CLASSES", None)

        repeat_factors = self._get_repeat_factors(dataset, oversample_thr)
        repeat_indices = []
        for idx, rf in enumerate(repeat_factors):
            repeat_indices.extend([idx] * math.ceil(rf))
        self.repeat_indices = repeat_indices
        if hasattr(dataset, "flag"):
            flags = []
            for flag, rf in zip(dataset.flag, repeat_factors):
                flags.extend([flag] * math.ceil(rf))
            assert len(flags) == len(repeat_indices)
            self.flag = np.asarray(flags, dtype=np.uint8)

    def _get_repeat_factors(self, dataset, repeat_thr: float):
        category_freq: dict = collections.defaultdict(float)
        num_images = len(dataset)
        for idx in range(num_images):
            cat_ids = set(dataset.get_cat_ids(idx))
            if len(cat_ids) == 0 and not self.filter_empty_gt:
                cat_ids = {len(self.CLASSES)}  # background pseudo-class
            for cat_id in cat_ids:
                category_freq[cat_id] += 1
        for k, v in category_freq.items():
            category_freq[k] = v / num_images

        category_repeat = {
            cat_id: max(1.0, math.sqrt(repeat_thr / cat_freq))
            for cat_id, cat_freq in category_freq.items()
        }
        repeat_factors = []
        for idx in range(num_images):
            cat_ids = set(dataset.get_cat_ids(idx))
            if len(cat_ids) == 0 and not self.filter_empty_gt:
                cat_ids = {len(self.CLASSES)}
            repeat_factor = 1.0
            if len(cat_ids) > 0:
                repeat_factor = max(
                    {category_repeat[cat_id] for cat_id in cat_ids})
            repeat_factors.append(repeat_factor)
        return repeat_factors

    def __getitem__(self, idx: int):
        return self.dataset[self.repeat_indices[idx]]

    def get_cat_ids(self, idx: int):
        return self.dataset.get_cat_ids(self.repeat_indices[idx])

    def __len__(self):
        return len(self.repeat_indices)


@DATASETS.register_module()
class MultiImageMixDataset:
    """Multi-image mixing wrapper (Mosaic/MixUp-style pipelines).

    Each pipeline stage that defines ``get_indexes(dataset)`` receives the
    extra samples under ``results['mix_results']`` before being applied.
    """

    def __init__(self, dataset, pipeline, dynamic_scale=None,
                 skip_type_keys=None, max_refetch: int = 15):
        assert dynamic_scale is None, (
            "dynamic_scale moved into the resize pipeline (parity with "
            "dataset_wrappers.py:305-309)")
        if skip_type_keys is not None:
            assert all(isinstance(k, str) for k in skip_type_keys)
        self._skip_type_keys = skip_type_keys

        self.pipeline = []
        self.pipeline_types = []
        for transform in pipeline:
            if isinstance(transform, dict):
                self.pipeline_types.append(transform["type"])
                self.pipeline.append(PIPELINES.build(dict(transform)))
            else:
                self.pipeline_types.append(type(transform).__name__)
                self.pipeline.append(transform)

        self.dataset = dataset
        self.CLASSES = getattr(dataset, "CLASSES", None)
        if hasattr(dataset, "flag"):
            self.flag = dataset.flag
        self.num_samples = len(dataset)
        self.max_refetch = max_refetch

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx: int):
        results = copy.deepcopy(self.dataset[idx])
        for transform, transform_type in zip(self.pipeline,
                                             self.pipeline_types):
            if (self._skip_type_keys is not None
                    and transform_type in self._skip_type_keys):
                continue
            if hasattr(transform, "get_indexes"):
                for _ in range(self.max_refetch):
                    indexes = transform.get_indexes(self.dataset)
                    if not isinstance(indexes, collections.abc.Sequence):
                        indexes = [indexes]
                    mix_results = [
                        copy.deepcopy(self.dataset[i]) for i in indexes]
                    if None not in mix_results:
                        results["mix_results"] = mix_results
                        break
                else:
                    raise RuntimeError(
                        "max_refetch exceeded fetching mix images")
            for _ in range(self.max_refetch):
                updated = transform(copy.deepcopy(results))
                if updated is not None:
                    results = updated
                    break
            else:
                raise RuntimeError("max_refetch exceeded applying pipeline")
            results.pop("mix_results", None)
        return results

    def update_skip_type_keys(self, skip_type_keys):
        assert all(isinstance(k, str) for k in skip_type_keys)
        self._skip_type_keys = skip_type_keys
