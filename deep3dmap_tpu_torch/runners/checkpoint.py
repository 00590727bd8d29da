"""Checkpoints in the JAX package's layout (port of
``deep3dmap_tpu/runners/checkpoint.py``).

``work_dir/checkpoints/ckpt_<step>/`` holds ``state.pt`` and ``meta.json``
(epoch, iter); ``work_dir/checkpoints/latest`` names the newest, and
``max_keep`` keeps only the newest few.  ``state.pt`` is ``torch.save`` of a
dict of plain containers and tensors (``torch.load(weights_only=True)``
reads it):

    net          the network's ``state_dict()``
    optimizer    Adam's ``state_dict()``, the schedule's ``count`` and the
                 optimizer's ``structure`` (clip and schedule on or off);
                 with one optimizer per head, a dict of those by head
    model_state  the model state's tensors, in tree order (dict keys
                 sorted, as ``jax.tree_util.tree_leaves`` orders them);
                 modules in it (Gan2Shape's frozen GAN, which comes from
                 ``gan_ckpt`` or the seeded init) are not saved
    step         updates taken
    rng          the step generator's state, where the state has one

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
from typing import Any, List, Mapping, Optional

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


def _optimizer_state(opt) -> dict:
    if isinstance(opt, Mapping):
        return {name: _optimizer_state(o) for name, o in opt.items()}
    return dict(adam=opt.adam.state_dict(), count=opt.count, structure=_structure(opt))


def _load_optimizer(opt, saved: Mapping) -> None:
    """Restore an optimizer (or a dict of them by head) from its saved
    state; raises ``ValueError`` where the structure differs."""
    if isinstance(opt, Mapping):
        if set(saved) != set(opt):
            raise ValueError(f"optimizers {sorted(saved)} in the checkpoint, "
                             f"{sorted(opt)} in the runner")
        for name, o in opt.items():
            _load_optimizer(o, saved[name])
        return
    if "structure" not in saved:
        raise ValueError("one optimizer per head in the checkpoint, one in the runner")
    if saved["structure"] != _structure(opt):
        raise ValueError(f"optimizer structure {saved['structure']} in the checkpoint, "
                         f"{_structure(opt)} in the runner")
    opt.adam.load_state_dict(saved["adam"])
    opt.count = int(saved["count"])


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
    raw = dict(net=state.net.state_dict(), optimizer=_optimizer_state(state.optimizer),
               model_state=tree_leaves(state.model_state), step=step)
    if state.rng is not None:
        raw["rng"] = state.rng.get_state()
    torch.save(raw, osp.join(path, STATE_FILE))
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
    _load_optimizer(state.optimizer, raw["optimizer"])
    if state.rng is not None:
        if "rng" not in raw:
            raise ValueError("the checkpoint holds no generator state")
        state.rng.set_state(raw["rng"].cpu())
    state.net.load_state_dict(raw["net"])
    model_state = tree_unflatten(state.model_state, raw["model_state"])
    return dataclasses.replace(state, model_state=model_state,
                               step=int(raw["step"]))


def load_meta(path: str) -> dict:
    mpath = osp.join(path, "meta.json")
    if osp.exists(mpath):
        with open(mpath) as f:
            return json.load(f)
    return {}
