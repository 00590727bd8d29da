"""``BaseMetric``, ``Evaluator`` and ``DepthMetric`` (the port's copy of
``deep3dmap_tpu/core/evaluation/evaluator.py``).

Metrics gather per-batch results and compute on demand; an ``Evaluator``
hands each batch to all its metrics.  With a ``torch.distributed`` process
group of more than one process, ``BaseMetric.evaluate`` gathers every
rank's results (``all_gather_object``, rank order) before computing, as the
JAX package gathers across processes; otherwise the results stay local.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from ...utils.registry import Registry

METRICS = Registry("metric")


class BaseMetric:
    default_prefix: Optional[str] = None

    def __init__(self, prefix: Optional[str] = None):
        self.prefix = prefix or self.default_prefix
        self.results: List[Any] = []

    def process(self, data_batch: dict, predictions: dict) -> None:
        raise NotImplementedError

    def compute_metrics(self, results: List[Any]) -> Dict[str, float]:
        raise NotImplementedError

    def evaluate(self) -> Dict[str, float]:
        import torch.distributed as dist

        results = self.results
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            gathered = [None] * dist.get_world_size()
            dist.all_gather_object(gathered, results)
            results = [r for rank_results in gathered for r in rank_results]
        metrics = self.compute_metrics(results)
        self.results = []
        if self.prefix:
            metrics = {f"{self.prefix}/{k}": v for k, v in metrics.items()}
        return metrics


class Evaluator:
    def __init__(self, metrics: Sequence):
        self.metrics: List[BaseMetric] = []
        for m in metrics:
            if isinstance(m, dict):
                self.metrics.append(METRICS.build(dict(m)))
            else:
                self.metrics.append(m)

    def process(self, data_batch: dict, predictions: dict):
        for m in self.metrics:
            m.process(data_batch, predictions)

    def evaluate(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for m in self.metrics:
            res = m.evaluate()
            dup = set(out) & set(res)
            if dup:
                raise ValueError(f"duplicate metric keys: {dup}")
            out.update(res)
        return out


@METRICS.register_module()
class DepthMetric(BaseMetric):
    """Per-batch depth metrics (wraps core/evaluation/depth_eval.py)."""

    default_prefix = "depth"

    def __init__(self, pred_key: str = "depth", gt_key: str = "gt_depth",
                 max_depth: float = 10.0, prefix=None):
        super().__init__(prefix)
        self.pred_key = pred_key
        self.gt_key = gt_key
        self.max_depth = max_depth

    def process(self, data_batch, predictions):
        import numpy as np

        from .depth_eval import eval_depth

        pred = np.asarray(predictions[self.pred_key])
        gt = np.asarray(data_batch[self.gt_key])
        for p, g in zip(pred.reshape((-1,) + pred.shape[-2:]),
                        gt.reshape((-1,) + gt.shape[-2:])):
            self.results.append(eval_depth(p, g, max_depth=self.max_depth))

    def compute_metrics(self, results):
        import numpy as np

        keys = results[0].keys() if results else []
        return {k: float(np.mean([r[k] for r in results])) for k in keys}
