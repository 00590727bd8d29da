"""BaseRunner: the host loop around the training step, on one card (port of
``deep3dmap_tpu/runners/base_runner.py``).

Hooks with priorities, ``setup`` (the framework's seeded ``init``, the lr
schedule and Adam after the clip), ``run_iter`` (``runners/train_state.py``'s
``train_step``), ``val``, checkpoints and ``resume``.  The logged values stay
on the device until a logger reads them, so no step waits for the device.
Training here is bitwise repeatable on the card (``utils/device.py``'s
``make_deterministic``).  There is no mesh: data parallelism and the spatial
GRU are ROADMAP.md Queue 1 (multi-GPU).

Framework contract (as in the JAX package, with ``params`` the network
module):

    framework.init(seed, batch)                -> (net, model_state)
    framework.loss_fn(net, model_state, batch) -> (loss, aux)
        aux = {"log_vars": {...}, "model_state": ...}
    framework.val_fn(net, model_state, batch)  -> {"log_vars": {...}}
    framework.host_check_batch(batch)          [optional]
"""
from __future__ import annotations

import logging
import os
import os.path as osp
import time
from typing import Callable, List, Optional

import torch

from ..utils.device import make_deterministic
from ..utils.log_buffer import LogBuffer
from ..utils.logging import get_root_logger
from .hooks import Hook, build_hook
from .optim import build_lr_schedule, build_optimizer
from .train_state import TrainState, train_step

_LATER = "is not ported yet (ROADMAP.md Queue 1, the runtime's leftovers)"


class BaseRunner:
    def __init__(self, framework, runner_cfgs=None, work_dir: Optional[str] = None,
                 logger: Optional[logging.Logger] = None, seed: int = 0,
                 max_epochs: Optional[int] = None, max_iters: Optional[int] = None,
                 meta: Optional[dict] = None):
        runner_cfgs = dict(runner_cfgs or {})
        self.framework = framework
        self.work_dir = osp.abspath(work_dir) if work_dir else None
        if self.work_dir:
            os.makedirs(self.work_dir, exist_ok=True)
        self.timestamp = time.strftime("%Y%m%d_%H%M%S", time.localtime())
        self.logger = logger or get_root_logger(
            log_file=osp.join(self.work_dir, f"{self.timestamp}.log") if self.work_dir else None)
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
        """Seeded weights and model state, the schedule and the optimizer."""
        make_deterministic()
        make_optimizer = self._optimizer_factory(optimizer, lr_config, optimizer_config,
                                                 iters_per_epoch, dict(type="Adam", lr=1e-3))
        net, model_state = self.framework.init(self.seed, sample_batch)
        self.state = TrainState(net=net, model_state=model_state,
                                optimizer=make_optimizer(net.parameters()))
        self._log_init(net)
        return self.state

    def _optimizer_factory(self, optimizer: Optional[dict], lr_config: Optional[dict],
                           optimizer_config: Optional[dict], iters_per_epoch: int,
                           default: dict) -> Callable:
        """Sets ``base_lr`` and ``lr_schedule`` from the configs and returns
        parameters -> optimizer (``runners/optim.py``)."""
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
        if optimizer.pop("paramwise_cfg", None):
            raise NotImplementedError(f"paramwise_cfg {_LATER}")
        if optimizer_config.get("cumulative_iters", 1) > 1:
            raise NotImplementedError(f"gradient accumulation {_LATER}")
        grad_clip, schedule = optimizer_config.get("grad_clip"), self.lr_schedule
        return lambda params: build_optimizer(optimizer, params, grad_clip,
                                              lr_schedule=schedule)

    def _log_init(self, net) -> None:
        n_params = sum(p.numel() for p in net.parameters())
        self.logger.info(f"Initialized {type(self.framework).__name__}: "
                         f"{n_params / 1e6:.2f}M params, device={self.framework.device}")

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
            host_check=getattr(self.framework, "host_check_batch", None))

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
    def save_checkpoint(self, out_dir=None, meta=None):
        from .checkpoint import save_checkpoint
        return save_checkpoint(out_dir or self.work_dir, self.state,
                               meta=dict(epoch=self.epoch + 1, iter=self.iter, **(meta or {})))

    def resume(self, checkpoint: Optional[str] = None):
        from .checkpoint import latest_checkpoint, load_checkpoint, load_meta
        path = checkpoint or latest_checkpoint(self.work_dir)
        if path is None:
            self.logger.info("No checkpoint found to resume from")
            return False
        assert self.state is not None, "call setup() before resume()"
        try:
            self.state = load_checkpoint(path, self.state,
                                         map_location=self.framework.device)
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
