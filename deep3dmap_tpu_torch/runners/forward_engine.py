"""Inference loops (port of ``deep3dmap_tpu/runners/forward_engine.py``):
``forward_test_loop`` streams a loader through a framework's
``forward_test`` with the recurrent state carried, and ``collect_results``
gathers per-process results (one process: its input as it is, as JAX's at
one process).

On a mesh (``parallel/mesh.py``) every rank streams the whole split in
order, as JAX's jitted forward does over its mesh: each batch is placed by
``shard_batch``'s rule (``local_batch``: this rank's slice where the batch
divides over ``data``, the whole batch where it does not), and the
outputs of a split batch are gathered back over ``data``
(``global_outputs``), so every rank holds the global batch's outputs, as
``jax.device_get`` returns them.  ``load_for_test`` restores a checkpoint
for inference, slicing its whole global volumes to this rank's slabs on
NeuralRecon's spatial path."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..parallel.collectives import gather_rows
from ..parallel.mesh import shard_batch, tree_leaves, tree_map


def _host(v):
    """A tensor as a host array of its dtype (bfloat16, which numpy lacks,
    as float32)."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
    return np.asarray(v)


def _on_mesh(mesh) -> bool:
    return mesh is not None and mesh.device_mesh is not None


def _splits(batch, mesh) -> bool:
    """True when ``shard_batch`` splits ``batch`` over ``data``: its leading
    dim (the first leaf's with one) divides over the axis's ranks."""
    n = mesh.shape.get("data", 1)
    dims = [np.shape(x)[0] for x in tree_leaves(batch) if np.ndim(x)]
    return n > 1 and bool(dims) and dims[0] % n == 0


def local_batch(batch, mesh=None):
    """This rank's part of a whole batch: ``shard_batch(global_batch=True)``
    on a mesh, the batch as it is without one."""
    return shard_batch(batch, mesh, global_batch=True) if _on_mesh(mesh) else batch


def global_outputs(out, batch, mesh=None):
    """``forward_test``'s outputs for the whole ``batch``: gathered over
    ``data`` in rank order where ``local_batch`` split it (every rank of
    the axis takes part), as they are where every rank ran it whole."""
    if not _on_mesh(mesh) or not _splits(batch, mesh):
        return out
    group = mesh.group("data")
    return tree_map(lambda v: gather_rows(v, group, 0)
                    if isinstance(v, torch.Tensor) and v.dim() else v, out)


def load_for_test(path: str, net, model_state, map_location, mesh=None,
                  spatial: bool = False):
    """A checkpoint's weights into ``net`` and its model state in the
    layout of ``model_state`` where the leaves match (the framework's
    initial state otherwise); returns the model state.  On the spatial
    path (``spatial``, the framework's ``set_mesh`` said so) the saved
    volumes are whole: they restore into a whole template and this rank
    keeps its slabs (every rank of the mesh calls this together)."""
    from ..parallel.spatial import gather_global_volumes, shard_global_volumes
    from .checkpoint import load_checkpoint_raw, tree_leaves as tensor_leaves, tree_unflatten

    restored = load_checkpoint_raw(path, map_location=map_location)
    net.load_state_dict(restored["net"])
    leaves = restored.get("model_state") or []
    if spatial:
        model_state = gather_global_volumes(model_state, mesh)
    if leaves and len(leaves) == len(tensor_leaves(model_state)):
        model_state = tree_unflatten(model_state, leaves)
    return shard_global_volumes(model_state, mesh) if spatial else model_state


@torch.no_grad()
def forward_test_loop(framework, params, model_state, data_loader, mesh=None,
                      progress: bool = True) -> Dict[str, List[np.ndarray]]:
    """Runs ``framework.forward_test`` over ``data_loader``; returns each
    output key's per-batch host arrays (the global batch's on a mesh)."""
    outputs: Dict[str, List[np.ndarray]] = {}
    for i, batch in enumerate(data_loader):
        out, model_state = framework.forward_test(params, model_state,
                                                  local_batch(batch, mesh))
        for k, v in global_outputs(out, batch, mesh).items():
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
