"""Inference loops (port of ``deep3dmap_tpu/runners/forward_engine.py``):
``forward_test_loop`` streams a loader through a framework's
``forward_test`` with the recurrent state carried, and ``collect_results``
gathers per-process results (one process: its input as it is, as JAX's at
one process)."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def _host(v):
    """A tensor as a host array of its dtype (bfloat16, which numpy lacks,
    as float32)."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
    return np.asarray(v)


@torch.no_grad()
def forward_test_loop(framework, params, model_state, data_loader,
                      progress: bool = True) -> Dict[str, List[np.ndarray]]:
    """Runs ``framework.forward_test`` over ``data_loader``; returns each
    output key's per-batch host arrays."""
    outputs: Dict[str, List[np.ndarray]] = {}
    for i, batch in enumerate(data_loader):
        out, model_state = framework.forward_test(params, model_state, batch)
        for k, v in out.items():
            outputs.setdefault(k, []).append(_host(v))
        if progress:
            print(f"\rbatch {i + 1}/{len(data_loader)}", end="", flush=True)
    if progress:
        print()
    return outputs


def collect_results(results, world_size: Optional[int] = None):
    """Every process's ``results`` on every process, as a list by rank;
    with one process (or ``torch.distributed`` not initialised) the input
    itself."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() <= 1:
        return results
    gathered = [None] * (world_size or dist.get_world_size())
    dist.all_gather_object(gathered, results)
    return gathered
