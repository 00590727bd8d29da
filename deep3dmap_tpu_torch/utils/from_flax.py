"""Carry flax params across: a JAX ``init`` param tree -> the port's modules,
a JAX training checkpoint -> the port's ``TrainState``
(``load_jax_checkpoint``), and a JAX ``NamedTuple`` of arrays (the SfM
layer's problems) -> the port's twin (``from_jax_tuple``).

The reverse of ``deep3dmap_tpu/utils/torch_import.py:50-57`` (which maps torch
state dicts into flax trees), kept as the port's own copy:

  flax Conv kernel  (*k, I, O)  -> torch weight (O, I, *k)
  (depthwise HWIO with I=1 is the same rule: (kh, kw, 1, mid) -> (mid, 1, kh, kw))
  flax Dense kernel (I, O)      -> torch Linear weight (O, I)
  flax ConvTranspose kernel (kh, kw, I, O) -> torch weight (I, O, kh, kw),
    flipped in both spatial axes (flax's ``transpose_kernel=False`` does not
    flip it; ``torch.conv_transpose2d`` does)
  GroupNorm / BlockGN / LayerNorm scale -> weight; every bias -> bias
  BatchNorm (``models/modulars/norm.py``, under ``SyncBatchNorm``'s ``bn``)
    scale and bias as they are; its ``batch_stats`` mean and var are the
    module's buffers of those names
  DenseGeneral kernel and bias (the attention's query/key/value/out), raw
    leaves (``cls``, ``pos_embed``, ``poses_embed``, the hash grids'
    ``tables``, ``Embed``'s ``embedding``, CLIP's and DINO's class and
    position embeddings and projections): as they are

The port names its submodules after flax's auto-names (``Conv_0``,
``GroupNorm_0``, ``BlockConvBlock3D_1``, ``unet2``, ``gru1.convzr``, ...), so
a torch parameter ``a.b.Conv_0.weight`` IS the flax leaf ``a/b/Conv_0/kernel``
and the conversion is a per-leaf transpose, not a rename table.  A leaf that
is unmatched or has the wrong shape, in either direction, raises.

A module whose flax twin holds raw ``self.param`` leaves instead of flax
layers (StyleGAN2's) declares them in a class attribute ``FLAX_LEAVES``:
torch parameter name -> (flax leaf name, kind), kind ``"kernel"`` for a conv
``(k, k, I, O)`` or dense ``(I, O)`` kernel stored in torch's layout and
``"plain"`` for a leaf stored as it is.  A parameter it does not declare is
stray and raises, as any parameter outside a flax-mirroring layer does.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..models.layers import Conv, ConvTranspose, Dense, GroupNorm, LayerNorm
from ..models.modulars.norm import BatchNorm
from .device import resolve_device


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _leaf_map(module: nn.Module):
    """torch param name -> (flax path, kind), kind in {"kernel",
    "kernel_t", "plain"}."""
    out = {}
    for mname, m in module.named_modules():
        if isinstance(m, (Conv, Dense)):
            names = {"weight": ("kernel", "kernel"), "bias": ("bias", "plain")}
        elif isinstance(m, ConvTranspose):
            names = {"weight": ("kernel", "kernel_t"), "bias": ("bias", "plain")}
        elif isinstance(m, (GroupNorm, LayerNorm)):
            names = {"weight": ("scale", "plain"), "bias": ("bias", "plain")}
        elif isinstance(m, BatchNorm):
            names = {"scale": ("scale", "plain"), "bias": ("bias", "plain")}
        elif hasattr(type(m), "FLAX_LEAVES"):
            names = type(m).FLAX_LEAVES
        else:
            continue
        base = tuple(mname.split(".")) if mname else ()
        for pname, p in m.named_parameters(recurse=False):
            if pname not in names:
                continue        # left stray: raises below
            flax_leaf, kind = names[pname]
            out[f"{mname}.{pname}" if mname else pname] = (base + (flax_leaf,), kind)
    own = {n for n, _ in module.named_parameters()}
    stray = own - set(out)
    if stray:
        raise ValueError(f"from_flax: torch params outside a flax-mirroring "
                         f"layer: {sorted(stray)}")
    return out


def _kernel_to_torch(k: np.ndarray) -> np.ndarray:
    n = k.ndim
    return np.transpose(k, (n - 1, n - 2) + tuple(range(n - 2)))


def _kernel_to_flax(w: np.ndarray) -> np.ndarray:
    n = w.ndim
    return np.transpose(w, tuple(range(2, n)) + (1, 0))


def _kernel_t_to_torch(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1]


def _kernel_t_to_flax(w: np.ndarray) -> np.ndarray:
    return np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1))


_TO_TORCH = {"kernel": _kernel_to_torch, "kernel_t": _kernel_t_to_torch}
_TO_FLAX = {"kernel": _kernel_to_flax, "kernel_t": _kernel_t_to_flax}


def _unwrap(flax_params: Mapping, module: nn.Module) -> Mapping:
    names = {n for n, _ in module.named_children()}
    if set(flax_params.keys()) == {"params"} and "params" not in names:
        return flax_params["params"]
    return flax_params


def _torch_layout(module: nn.Module, flax_tree: Mapping) -> Dict[str, np.ndarray]:
    """A flax-layout tree over ``module``'s parameters (optionally under a
    top-level ``"params"`` key) -> torch-layout arrays by parameter name.
    Raises on any leaf missing on either side or with the wrong shape."""
    flat = _flatten(_unwrap(flax_tree, module))
    leaf_map = _leaf_map(module)
    params = dict(module.named_parameters())
    wanted = {path for path, _ in leaf_map.values()}
    extra = sorted("/".join(p) for p in set(flat) - wanted)
    missing = sorted("/".join(p) for p in wanted - set(flat))
    if extra or missing:
        raise ValueError(f"from_flax: flax leaves with no torch param: {extra}; "
                         f"torch params with no flax leaf: {missing}")
    out = {}
    for tname, (path, kind) in leaf_map.items():
        src = flat[path]
        if kind in _TO_TORCH:
            src = _TO_TORCH[kind](src)
        if tuple(src.shape) != tuple(params[tname].shape):
            raise ValueError(
                f"from_flax: {'/'.join(path)} has shape {tuple(src.shape)} "
                f"after conversion, torch {tname} wants {tuple(params[tname].shape)}")
        out[tname] = np.array(src)
    return out


def load_flax_params(module: nn.Module, flax_params: Mapping) -> nn.Module:
    """Fill ``module``'s parameters from a flax param tree (nested dicts of
    arrays, optionally under a top-level ``"params"`` key).  Raises on any
    leaf missing on either side or with the wrong shape."""
    values = _torch_layout(module, flax_params)
    with torch.no_grad():
        for tname, p in module.named_parameters():
            p.copy_(torch.from_numpy(values[tname]).to(p.dtype))
    return module


def load_flax_npz(module: nn.Module, path: str) -> nn.Module:
    """Fill ``module`` from an ``.npz`` whose ``params`` entry is a pickled
    flax param tree, the layout ``tools/import_weights.py`` writes (the
    parsing nets, VGG, MNASNet)."""
    with np.load(path, allow_pickle=True) as data:
        return load_flax_params(module, data["params"].item())


def load_jax_checkpoint(raw: Mapping, state):
    """Load a JAX ``TrainState`` checkpoint, as
    ``deep3dmap_tpu/runners/checkpoint.py::load_checkpoint_raw`` returns it
    (``params``, ``opt_state``, ``model_state``, ``step``), into the port's
    ``TrainState`` (``runners/train_state.py``) built from the same config,
    and return it.  ``runners/checkpoint.py::save_checkpoint`` then writes
    it as the port's checkpoint, so a run trained by JAX resumes in the port.

    ``opt_state`` is the optax chain of JAX's ``build_optimizer``: for plain
    Adam ``[clip state (None), [ScaleByAdamState (count, mu, nu),
    ScaleByScheduleState (count) or None]]`` with the global-norm clip, the
    Adam chain alone without it; for every other chain (SGD, AdamW, ...,
    paramwise, ``MultiSteps``) the state of the same transforms, held
    against the chain the port's optimizer stands for, its buffers, counts
    and MultiSteps accumulator carried over.  Where the port keeps
    one optimizer per head or per collection (``Gan2ShapeRunner``,
    ``StateMachineRunner``), JAX's ``opt_state`` holds one such chain per
    head, by the same names (``param_collection``).  A JAX optimizer of another
    structure than the port's (clip or schedule on one side only) raises
    ``ValueError``.  Modules in the port's model state (Gan2Shape's frozen
    generator and discriminator) take JAX's trees of the same key; the
    tensors take the remaining leaves in tree order (GNeRF's ``it`` and its
    spectral-norm ``u``/``sigma``, kept in JAX's ``batch_stats`` layout).
    GNeRF's checkpoint holds five Adam chains, one per collection; LERF's one
    (clip, Adam and the cosine schedule) over its three collections.  The step generator, if
    any, is the port's own: JAX's key does not carry across."""
    import dataclasses

    net = state.net
    load_flax_params(net, raw["params"])
    if isinstance(state.optimizer, Mapping):
        for name, opt in state.optimizer.items():
            _load_optax(param_collection(net, name), opt, raw["opt_state"][name])
    else:
        _load_optax(net, state.optimizer, raw["opt_state"])
    return dataclasses.replace(state, model_state=_load_model_state(
        state.model_state, raw["model_state"]), step=int(np.asarray(raw["step"])))


def param_collection(net: nn.Module, name: str) -> nn.Module:
    """The module that holds JAX's top-level param collection ``name``: the
    child of that name, or for ``"params"`` (a flax module's one
    collection) the whole net."""
    return net if name == "params" else getattr(net, name)


def _load_optax(module: nn.Module, opt, opt_state) -> None:
    """optax's state of the chain ``opt`` was built as, over ``module``'s
    parameters, into the port's optimizer (``runners/optim.py``)."""
    from ..runners.optim import ClippedAdam

    if isinstance(opt, ClippedAdam):
        _load_optax_adam(module, opt, opt_state)
        return
    want, got = _optax_skeleton(opt), _skeleton(opt_state)
    if want != got:
        raise ValueError(f"optimizer state {got} in the JAX checkpoint, the port's "
                         f"{opt.structure()} reads {want}")
    multi = opt_state if opt.every_k > 1 else None
    states = _state_dicts(multi["inner_opt_state"] if multi else opt_state)
    counts = [int(np.asarray(d["count"])) for d in states if "count" in d]
    if multi is not None:
        counts.append(int(np.asarray(multi["gradient_step"])))
        opt.mini_step = int(np.asarray(multi["mini_step"]))
        acc = _torch_layout(module, multi["acc_grads"])
        with torch.no_grad():
            for (name, p), a in zip(module.named_parameters(), opt.acc):
                a.copy_(torch.from_numpy(acc[name]))
    with torch.no_grad():
        for d in states:
            for key in set(d) & set(opt.buffers):
                vals = _torch_layout(module, d[key])
                for (name, p), b in zip(module.named_parameters(), opt.buffers[key]):
                    b.copy_(torch.from_numpy(vals[name]))
    opt.count = counts[0] if counts else 0


_STATE_KEYS = {"count", "mu", "nu", "trace", "sum_of_squares"}


def _skeleton(node):
    """A restored optax state with its arrays and paramwise multiplier trees
    left out: lists as lists, a state by its field names, ``"mult"``."""
    if isinstance(node, (list, tuple)):
        return [_skeleton(x) for x in node]
    if isinstance(node, Mapping):
        if "mini_step" in node:
            return {"multi": _skeleton(node["inner_opt_state"])}
        if set(node) <= _STATE_KEYS:
            return tuple(sorted(node))
        return "mult"
    return None


def _optax_skeleton(opt):
    """The ``_skeleton`` of the optax chain JAX's ``build_optimizer`` makes
    for the port's ``FoldedOptimizer`` ``opt``."""
    sched = ("count",) if opt.schedule is not None else None
    h, adam = opt.hyper, ("count", "mu", "nu")
    tx = {"Adam": [adam, None, sched] if h.get("weight_decay") else [adam, sched],
          "AdamW": [adam, None, sched],
          "SGD": [None, [("trace",) if h.get("momentum") else None, sched]],
          "RMSprop": [None, [("nu",), sched, ("trace",) if h.get("momentum") else None]],
          "Adagrad": [("sum_of_squares",), sched],
          "Adamax": [adam, sched],
          "Lamb": [adam, None, None, sched],
          "Lion": [("count", "mu"), None, sched]}[opt.kind]
    parts = (([None] if opt.max_norm is not None else [])
             + (["mult"] if opt.decay is not None else []) + [tx]
             + (["mult"] if opt.lr_mults is not None else []))
    inner = parts if len(parts) > 1 else tx
    return {"multi": inner} if opt.every_k > 1 else inner


def _state_dicts(node):
    """The optax states (dicts of ``_STATE_KEYS``) in tree order."""
    if isinstance(node, (list, tuple)):
        return [d for x in node for d in _state_dicts(x)]
    if isinstance(node, Mapping) and set(node) <= _STATE_KEYS:
        return [node]
    return []


def _load_optax_adam(module: nn.Module, opt, opt_state) -> None:
    """optax's clip + Adam (+ schedule) state over ``module``'s parameters
    into the port's ``ClippedAdam``."""
    clip = (isinstance(opt_state, (list, tuple)) and len(opt_state) == 2
            and opt_state[0] is None and isinstance(opt_state[1], (list, tuple)))
    adam_state, sched_state = opt_state[1] if clip else opt_state
    jax_structure = dict(clip=clip, schedule=sched_state is not None)
    port_structure = opt.structure()
    if jax_structure != port_structure:
        raise ValueError(f"optimizer structure {jax_structure} in the JAX checkpoint, "
                         f"{port_structure} in the port's state")
    count = int(np.asarray(adam_state["count"]))
    mu = _torch_layout(module, adam_state["mu"])
    nu = _torch_layout(module, adam_state["nu"])
    opt.adam.state.clear()
    for name, p in module.named_parameters():
        opt.adam.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.from_numpy(mu[name]).to(p.device, p.dtype),
            "exp_avg_sq": torch.from_numpy(nu[name]).to(p.device, p.dtype)}
    opt.count = int(np.asarray(sched_state["count"])) if sched_state is not None else count


def _load_model_state(template, jax_state):
    from ..runners.checkpoint import tree_unflatten

    modules = ({k: v for k, v in template.items() if isinstance(v, nn.Module)}
               if isinstance(template, Mapping) else {})
    for k, m in modules.items():
        load_flax_params(m, jax_state[k])
    rest = {k: v for k, v in jax_state.items() if k not in modules} if modules else jax_state
    leaves = [torch.from_numpy(np.asarray(v)) for v in _jax_leaves(rest)]
    return tree_unflatten(template, leaves)


def _jax_leaves(tree):
    """Array leaves of a restored pytree of dicts and lists, dict keys
    sorted, as ``jax.tree_util.tree_leaves`` orders them."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in _jax_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _jax_leaves(v)]
    return [] if tree is None else [tree]


def _to_flax_tree(module: nn.Module,
                  values: Mapping[str, Optional[torch.Tensor]]) -> Dict:
    """Per-parameter tensors in torch layout (by parameter name; ``None``
    reads as zeros) -> a nested flax-layout dict of float32 numpy arrays."""
    params = dict(module.named_parameters())
    tree: Dict = {}
    for tname, (path, kind) in _leaf_map(module).items():
        v = values.get(tname)
        a = (np.zeros(tuple(params[tname].shape), np.float32) if v is None
             else v.detach().float().cpu().numpy())
        if kind in _TO_FLAX:
            a = np.ascontiguousarray(_TO_FLAX[kind](a))
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return tree


def to_flax_params(module: nn.Module) -> Dict:
    """The module's parameters as a nested flax-layout dict of numpy arrays
    (the inverse of ``load_flax_params``)."""
    return _to_flax_tree(module, dict(module.named_parameters()))


def to_flax_state(model_state):
    """A model state's tensors as numpy arrays in the same tree (GNeRF's
    ``it`` and spectral-norm ``disc_stats``, which the port keeps in JAX's
    layout): the inverse of ``load_jax_checkpoint``'s model-state load."""
    if isinstance(model_state, Mapping):
        return {k: to_flax_state(v) for k, v in model_state.items()}
    if isinstance(model_state, (list, tuple)):
        return [to_flax_state(v) for v in model_state]
    return model_state.detach().cpu().numpy()


def to_flax_grads(module: nn.Module) -> Dict:
    """The parameters' ``.grad`` in flax layout; a parameter without one
    reads as zeros, as ``jax.grad`` gives for an unused leaf."""
    return _to_flax_tree(module, {n: p.grad for n, p in module.named_parameters()})


def to_flax_adam_state(module: nn.Module, adam: torch.optim.Adam) -> Dict:
    """``torch.optim.Adam``'s moments over ``module``'s parameters as optax's
    ``ScaleByAdamState`` fields: ``count`` (steps taken) and ``mu``/``nu``
    (first and second moments) in flax layout; zeros for a parameter the
    optimizer never stepped."""
    names = dict(module.named_parameters())
    state = {n: adam.state.get(p, {}) for n, p in names.items()}
    steps = {int(s["step"]) for s in state.values() if "step" in s}
    if len(steps) > 1:
        raise ValueError(f"to_flax_adam_state: parameters at different steps {steps}")
    return {"count": steps.pop() if steps else 0,
            "mu": _to_flax_tree(module, {n: s.get("exp_avg") for n, s in state.items()}),
            "nu": _to_flax_tree(module, {n: s.get("exp_avg_sq") for n, s in state.items()})}


def from_jax_tuple(cls, value, device=None):
    """A JAX ``NamedTuple`` of arrays (``BAProblem``, ``PoseGraph``,
    ``Keypoints``, ``Matches``, or its numpy twin) as the port's ``cls`` on
    ``device`` (``None``: the card, raising without one), field by field by
    name.  Floating and bool dtypes are kept; integer fields become int64,
    the port's index dtype."""
    dev = resolve_device(device)
    out = {}
    for name in cls._fields:
        a = torch.from_numpy(np.array(getattr(value, name)))
        if not (a.is_floating_point() or a.dtype == torch.bool):
            a = a.long()
        out[name] = a.to(dev)
    return cls(**out)
