"""Checkpoints in the JAX package's layout (port of
``deep3dmap_tpu/runners/checkpoint.py``).

``work_dir/checkpoints/ckpt_<step>/`` holds ``state.pt`` and ``meta.json``
(epoch, iter); ``work_dir/checkpoints/latest`` names the newest, and
``max_keep`` keeps only the newest few.  ``state.pt`` is ``torch.save`` of a
dict of plain containers and tensors (``torch.load(weights_only=True)``
reads it):

    net          the network's ``state_dict()``
    optimizer    Adam's ``state_dict()``, the schedule's ``count`` and the
                 optimizer's ``structure`` (clip and schedule on or off)
    model_state  the recurrent model state's tensors, in tree order (dict
                 keys sorted, as ``jax.tree_util.tree_leaves`` orders them)
    step         updates taken

Loading restores into an existing ``TrainState`` (the runner's, built from
the config) with an explicit ``map_location``.  A checkpoint of another
model or optimizer structure raises, as the JAX restore does on a mismatched
``TrainState`` tree.
"""
from __future__ import annotations

import json
import os
import os.path as osp
import re
import shutil
from typing import Any, List, Optional

import torch

STATE_FILE = "state.pt"


def _ckpt_dir(work_dir: str) -> str:
    return osp.join(osp.abspath(work_dir), "checkpoints")


def tree_leaves(tree) -> List[torch.Tensor]:
    """Tensor leaves of nested dicts, lists, tuples and NamedTuples, dict
    keys sorted."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return []


def tree_unflatten(template, leaves: List[torch.Tensor]):
    """``template``'s structure with its tensor leaves replaced, in
    ``tree_leaves`` order, by ``leaves`` (cast to each template leaf's dtype
    and device)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, torch.Tensor):
            v = next(it)
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"model_state leaf of shape {tuple(v.shape)} "
                                 f"where {tuple(t.shape)} is wanted")
            return v.to(device=t.device, dtype=t.dtype)
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[build(v) for v in t])
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return t

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("model_state holds more leaves than the framework's")
    return out


def _structure(optimizer) -> dict:
    return dict(clip=optimizer.max_norm is not None,
                schedule=optimizer.schedule is not None)


def save_checkpoint(work_dir: str, state, meta: Optional[dict] = None,
                    max_keep: int = -1) -> str:
    """Save a ``TrainState`` under ``work_dir/checkpoints/ckpt_<step>``."""
    root = _ckpt_dir(work_dir)
    os.makedirs(root, exist_ok=True)
    step = int(state.step)
    path = osp.join(root, f"ckpt_{step}")
    if osp.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    opt = state.optimizer
    torch.save(dict(net=state.net.state_dict(),
                    optimizer=dict(adam=opt.adam.state_dict(), count=opt.count,
                                   structure=_structure(opt)),
                    model_state=tree_leaves(state.model_state), step=step),
               osp.join(path, STATE_FILE))
    if meta is not None:
        with open(osp.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
    with open(osp.join(root, "latest"), "w") as f:
        f.write(f"ckpt_{step}")

    if max_keep > 0:
        ckpts = sorted(
            (int(m.group(1)), name) for name in os.listdir(root)
            if (m := re.fullmatch(r"ckpt_(\d+)", name)))
        for _, name in ckpts[:-max_keep]:
            shutil.rmtree(osp.join(root, name), ignore_errors=True)
    return path


def latest_checkpoint(work_dir: str) -> Optional[str]:
    root = _ckpt_dir(work_dir)
    pointer = osp.join(root, "latest")
    if osp.exists(pointer):
        with open(pointer) as f:
            name = f.read().strip()
        path = osp.join(root, name)
        if osp.exists(path):
            return path
    return None


def load_checkpoint_raw(path: str, map_location) -> dict:
    """The saved dict, its tensors on ``map_location``."""
    return torch.load(osp.join(path, STATE_FILE), map_location=map_location,
                      weights_only=True)


def load_checkpoint(path: str, state, map_location) -> Any:
    """Restore a checkpoint into ``state`` (a ``TrainState`` whose network
    and optimizer were built from the same config) and return it.  Raises
    ``ValueError`` when the model or the optimizer's structure differs."""
    import dataclasses

    raw = load_checkpoint_raw(path, map_location)
    opt = state.optimizer
    saved = raw["optimizer"]["structure"]
    if saved != _structure(opt):
        raise ValueError(f"optimizer structure {saved} in the checkpoint, "
                         f"{_structure(opt)} in the runner")
    state.net.load_state_dict(raw["net"])
    opt.adam.load_state_dict(raw["optimizer"]["adam"])
    opt.count = int(raw["optimizer"]["count"])
    model_state = tree_unflatten(state.model_state, raw["model_state"])
    return dataclasses.replace(state, model_state=model_state,
                               step=int(raw["step"]))


def load_meta(path: str) -> dict:
    mpath = osp.join(path, "meta.json")
    if osp.exists(mpath):
        with open(mpath) as f:
            return json.load(f)
    return {}
