"""BaseRunner: the host loop around the training step, on one card (port of
``deep3dmap_tpu/runners/base_runner.py``).

Hooks with priorities, ``setup`` (the framework's seeded ``init``, the lr
schedule and the optimizer chain), ``run_iter`` (``runners/train_state.py``'s
``train_step``), ``val``, checkpoints and ``resume``.  The logged values stay
on the device until a logger reads them, so no step waits for the device.
Training here is bitwise repeatable on the card (``utils/device.py``'s
``make_deterministic``).

The mesh (``parallel/mesh.py``, one process per card): ``setup`` hands it to
the framework's ``set_mesh`` before ``init`` (its batch reductions then
run over the ``data`` axis, ``loss_group``: NeuralRecon's fused loss sums,
the other frameworks' means through ``collectives.global_mean``; with a
``model`` axis NeuralRecon's spatially sharded GRU), broadcasts the weights
and the optimizer state from rank 0 and shards the global volumes
(``shard_train_state``); ``run_iter`` sums the gradients over the ``data``
axis.  A framework without ``set_mesh``, or whose ``loss_group`` stays None
(Gan2Shape's one-instance batch), is placed as JAX's ``shard_batch``
places a batch that does not divide: every rank runs the whole batch, and
nothing is reduced.  Checkpoints hold the whole state, as JAX's
``device_get``: every rank takes part in gathering the volumes' slabs
(``whole_state``), rank 0 writes, and ``resume`` slices the whole volumes
to the mesh it runs on.  ``val`` reports the global batch's loss.  Rank 0
logs.  Without a process group the mesh is one rank and nothing of this
runs.

Framework contract (as in the JAX package, with ``params`` the network
module):

    framework.init(seed, batch)                -> (net, model_state)
    framework.loss_fn(net, model_state, batch) -> (loss, aux)
        aux = {"log_vars": {...}, "model_state": ...}
    framework.val_fn(net, model_state, batch)  -> {"log_vars": {...}}
    framework.host_check_batch(batch)          [optional]
"""
from __future__ import annotations

import dataclasses
import logging
import os
import os.path as osp
import time
from typing import Callable, List, Mapping, Optional

import torch

from ..parallel.mesh import get_dist_info, make_mesh
from ..utils.device import make_deterministic
from ..utils.log_buffer import LogBuffer
from ..utils.logging import get_root_logger
from .hooks import Hook, build_hook
from .optim import build_lr_schedule, build_optimizer
from .train_state import TrainState, train_step

class BaseRunner:
    def __init__(self, framework, runner_cfgs=None, work_dir: Optional[str] = None,
                 logger: Optional[logging.Logger] = None, seed: int = 0,
                 max_epochs: Optional[int] = None, max_iters: Optional[int] = None,
                 meta: Optional[dict] = None, mesh=None):
        runner_cfgs = dict(runner_cfgs or {})
        self.framework = framework
        self.work_dir = osp.abspath(work_dir) if work_dir else None
        if self.work_dir:
            os.makedirs(self.work_dir, exist_ok=True)
        self.rank, self.world_size = get_dist_info()
        self.timestamp = time.strftime("%Y%m%d_%H%M%S", time.localtime())
        self.logger = logger or get_root_logger(
            log_file=osp.join(self.work_dir, f"{self.timestamp}.log") if self.work_dir else None,
            rank=self.rank)
        self.mesh = mesh if mesh is not None else make_mesh(
            device=getattr(framework, "device", "cpu"))
        self.meta = meta or {}

        self._max_epochs = max_epochs if max_epochs is not None else runner_cfgs.get("max_epochs")
        self._max_iters = max_iters if max_iters is not None else runner_cfgs.get("max_iters")
        self.runner_cfgs = runner_cfgs
        self.seed = seed
        self.log_buffer = LogBuffer()
        self._hooks: List[Hook] = []

        self.epoch = 0
        self.iter = 0
        self.inner_iter = 0
        self.mode = "train"
        self.cur_loader = None

        # populated by setup()
        self.state: Optional[TrainState] = None
        self.spatial = False          # the global volumes in X slabs over "model"
        self.lr_schedule = None
        self.base_lr: float = 0.0
        self.val_fn = getattr(framework, "val_fn", None)

    # -- properties --------------------------------------------------------
    @property
    def max_epochs(self):
        return self._max_epochs

    @property
    def max_iters(self):
        return self._max_iters

    def current_lr(self) -> float:
        """The lr of the next update (JAX: the schedule at ``state.step``)."""
        if self.lr_schedule is not None and self.state is not None:
            return self.lr_schedule(self.state.step)
        return self.base_lr

    # -- hooks -------------------------------------------------------------
    def register_hook(self, hook: Hook, priority: Optional[int] = None):
        if priority is not None:
            hook.PRIORITY = priority
        # insert keeping ascending priority (lower = earlier)
        idx = len(self._hooks)
        for i, h in enumerate(self._hooks):
            if hook.PRIORITY < h.PRIORITY:
                idx = i
                break
        self._hooks.insert(idx, hook)

    def register_hook_from_cfg(self, cfg: dict):
        self.register_hook(build_hook(cfg))

    def call_hook(self, fn_name: str):
        for hook in self._hooks:
            getattr(hook, fn_name)(self)

    @property
    def hooks(self):
        return self._hooks

    def register_training_hooks(self, lr_config=None, optimizer_config=None,
                                checkpoint_config=None, log_config=None,
                                timer_config=None):
        """lr and optimizer configs are consumed by ``setup``; checkpoint,
        logger and timer configs become hooks here."""
        self.register_hook(build_hook(timer_config or dict(type="IterTimerHook")))
        if checkpoint_config:
            cfg = dict(checkpoint_config)
            cfg.setdefault("type", "CheckpointHook")
            self.register_hook(build_hook(cfg))
        if log_config:
            interval = log_config.get("interval", 50)
            for h in log_config.get("hooks", [dict(type="TextLoggerHook")]):
                h = dict(h)
                h.setdefault("interval", interval)
                self.register_hook(build_hook(h))

    # -- setup -------------------------------------------------------------
    def setup(self, sample_batch, optimizer: Optional[dict] = None,
              lr_config: Optional[dict] = None, optimizer_config: Optional[dict] = None,
              iters_per_epoch: int = 1) -> TrainState:
        """Seeded weights and model state, the schedule and the optimizer;
        on a mesh the framework's ``set_mesh`` first, then the weights from
        rank 0 and the volumes sharded."""
        make_deterministic()
        make_optimizer = self._optimizer_factory(optimizer, lr_config, optimizer_config,
                                                 iters_per_epoch, dict(type="Adam", lr=1e-3))
        spatial_on = self._set_mesh()
        net, model_state = self.framework.init(self.seed, sample_batch)
        self.state = TrainState(net=net, model_state=model_state,
                                optimizer=make_optimizer(net),
                                rng=self.step_generator()
                                if hasattr(self.framework, "draws") else None)
        self._place_state(spatial_on)
        self._log_init(net)
        return self.state

    def _set_mesh(self) -> bool:
        """The mesh to the framework before ``init`` (JAX's
        ``base_runner.py:159-164``); True when it took the spatial path."""
        if not hasattr(self.framework, "set_mesh"):
            return False
        return bool(self.framework.set_mesh(self.mesh))

    def _place_state(self, spatial_on: bool) -> None:
        """On a process group: the weights and every optimizer's state
        broadcast from rank 0 and, on the spatial path, the global volumes
        as this rank's slabs."""
        self.spatial = spatial_on
        if self.mesh.device_mesh is None:
            return
        from ..parallel.mesh import replicate
        from ..parallel.spatial import shard_train_state

        self.state = shard_train_state(self.state, self.mesh,
                                       axis="model" if spatial_on else None)
        opts = self.state.optimizer
        for opt in (opts.values() if isinstance(opts, Mapping) else [opts]):
            replicate(opt.state_dict(), self.mesh)

    def step_generator(self) -> torch.Generator:
        """The generator of the steps' random draws (JAX's
        ``TrainState.rng``): on the framework's device, seeded with the
        runner's seed.  ``setup`` makes one for a framework that draws in
        its step (it has ``draws``)."""
        return torch.Generator(device=self.framework.device).manual_seed(self.seed)

    def _optimizer_factory(self, optimizer: Optional[dict], lr_config: Optional[dict],
                           optimizer_config: Optional[dict], iters_per_epoch: int,
                           default: dict) -> Callable:
        """Sets ``base_lr`` and ``lr_schedule`` from the configs and returns
        (module, collection name) -> optimizer (``runners/optim.py``), with
        the optimizer's ``paramwise_cfg`` and ``optimizer_config``'s
        ``grad_clip`` and ``cumulative_iters``."""
        optimizer = dict(optimizer or self.runner_cfgs.get("optimizer", default))
        self.base_lr = optimizer.get("lr", 1e-3)
        total_iters = (self._max_iters if self._max_iters is not None
                       else (self._max_epochs or 1) * iters_per_epoch)
        if lr_config:
            lr_cfg = dict(lr_config)
            policy = lr_cfg.pop("policy")
            self.lr_schedule = build_lr_schedule(
                policy, self.base_lr, total_iters, iters_per_epoch=iters_per_epoch, **lr_cfg)
        else:
            self.lr_schedule = None
        optimizer_config = dict(optimizer_config or {})
        paramwise_cfg = optimizer.pop("paramwise_cfg", None)
        grad_clip, schedule = optimizer_config.get("grad_clip"), self.lr_schedule
        every_k = optimizer_config.get("cumulative_iters", 1)
        return lambda module, collection="params": build_optimizer(
            optimizer, module, grad_clip, lr_schedule=schedule, paramwise_cfg=paramwise_cfg,
            cumulative_iters=every_k, collection=collection)

    def _log_init(self, net) -> None:
        n_params = sum(p.numel() for p in net.parameters())
        self.logger.info(f"Initialized {type(self.framework).__name__}: "
                         f"{n_params / 1e6:.2f}M params, device={self.framework.device}, "
                         f"mesh={self.mesh.shape}")

    # -- loops (implemented by subclasses) ---------------------------------
    def run(self, data_loaders, workflow, **kwargs):
        raise NotImplementedError

    def _on_device(self, data_batch) -> bool:
        ts = [v for v in data_batch.values() if isinstance(v, torch.Tensor)]
        return bool(ts) and all(t.device == self.framework.device for t in ts)

    def prefetch(self, loader, depth: int = 2):
        """Device-prefetching view of a host loader: batch N+1's host build,
        host checks and upload overlap step N."""
        from ..datasets.builder import prefetch_to_device

        return prefetch_to_device(
            loader, self.framework.device, depth=depth,
            host_check=getattr(self.framework, "host_check_batch", None),
            mesh=self.mesh if self.mesh.device_mesh is not None else None,
            global_batch=getattr(loader, "global_batch", False))

    def _host_checked(self, data_batch):
        """The batch, checked by the framework's ``host_check_batch`` unless
        it came through ``prefetch`` (checked there, on the device)."""
        if not self._on_device(data_batch):
            check = getattr(self.framework, "host_check_batch", None)
            if check is not None:
                check(data_batch)
        return data_batch

    def run_iter(self, data_batch):
        """One ``train_step``; its log (the JAX keys: the framework's log
        vars and ``loss``) goes to the log buffer as device tensors."""
        self.state, log_vars = train_step(self.framework, self.state,
                                          self._host_checked(data_batch))
        log_vars.pop("grad_norm")
        log_vars = dict(sorted(log_vars.items()))   # JAX's jitted dict is key-sorted
        self.log_buffer.update(log_vars)
        return log_vars

    def val(self, data_loader=None):
        if self.val_fn is None:
            return
        loader = data_loader if data_loader is not None else getattr(self, "_val_loader", None)
        if loader is None:
            return
        self.mode = "val"
        self.call_hook("before_val_epoch")
        for i, data_batch in enumerate(loader):
            self.inner_iter = i
            self.call_hook("before_val_iter")
            out = self.val_fn(self.state.net, self.state.model_state, data_batch)
            log_vars = out.get("log_vars", out) if isinstance(out, dict) else {}
            self.log_buffer.update({f"val_{k}": v for k, v in log_vars.items()})
            self.call_hook("after_val_iter")
        self.call_hook("after_val_epoch")
        self.mode = "train"

    # -- checkpointing -----------------------------------------------------
    def whole_state(self) -> TrainState:
        """The state as one rank would hold it (JAX's ``device_get``): on
        the spatial path the global volumes gathered from the ``model``
        axis's slabs, which every rank of the mesh must call together."""
        if not self.spatial:
            return self.state
        from ..parallel.spatial import gather_global_volumes

        return dataclasses.replace(self.state, model_state=gather_global_volumes(
            self.state.model_state, self.mesh))

    def save_checkpoint(self, out_dir=None, meta=None, max_keep: int = -1):
        """Every rank gathers the whole state (``whole_state``); rank 0
        saves it, the others return None."""
        from .checkpoint import save_checkpoint
        state = self.whole_state()
        if self.rank != 0:
            return None
        return save_checkpoint(out_dir or self.work_dir, state,
                               meta={**dict(epoch=self.epoch + 1, iter=self.iter),
                                     **(meta or {})}, max_keep=max_keep)

    def resume(self, checkpoint: Optional[str] = None):
        from .checkpoint import latest_checkpoint, load_checkpoint, load_meta
        path = checkpoint or latest_checkpoint(self.work_dir)
        if path is None:
            self.logger.info("No checkpoint found to resume from")
            return False
        assert self.state is not None, "call setup() before resume()"
        try:
            # the checkpoint's volumes are whole: restore into a whole
            # template, then keep this rank's slabs (JAX re-shards on restore)
            self.state = load_checkpoint(path, self.whole_state(),
                                         map_location=self.framework.device)
            if self.spatial:
                from ..parallel.spatial import shard_global_volumes

                self.state = dataclasses.replace(self.state, model_state=shard_global_volumes(
                    self.state.model_state, self.mesh))
        except (ValueError, RuntimeError, KeyError) as e:
            raise ValueError(
                f"Checkpoint at {path} does not match the current TrainState "
                f"structure. resume() requires reconstructing the runner with "
                f"the SAME model and optimizer config (including grad_clip / "
                f"lr schedule) used when the checkpoint was saved. "
                f"Original error: {e}") from e
        meta = load_meta(path)
        self.epoch = meta.get("epoch", 0)
        self.iter = meta.get("iter", self.state.step)
        self.logger.info(f"Resumed from {path} (epoch {self.epoch}, iter {self.iter})")
        return True
