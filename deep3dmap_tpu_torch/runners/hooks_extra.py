"""The other hooks (port of ``deep3dmap_tpu/runners/hooks_extra.py``): EMA,
profiler, sampler seeds, buffers, the cache, the logger backends, early
stopping, the optimizer-config shims and the supervisor's heartbeat.

A logger hook whose client package is missing is disabled with the JAX
package's warning (``<Hook> disabled: <error>``); the rest of the run goes
on.  None of these hooks reads the device in a training step: the EMA is
updated with foreach ops on the device, and the heartbeat writes host
counters only.
"""
from __future__ import annotations

import gc
import json
import os
import os.path as osp
import time
from typing import Optional

import numpy as np
import torch

from ..utils import tracing
from .hooks import HOOKS, Hook


@HOOKS.register_module()
class EMAHook(Hook):
    """Exponential moving average of the parameters, on the device
    (``runner.ema_params``, one tensor per parameter), updated every
    ``interval`` iterations with JAX's momentum ramp ``min(momentum, (1 +
    iter) / (warm_up + iter))``; ``apply_ema``/``restore`` swap it in for
    validation."""

    PRIORITY = 40

    def __init__(self, momentum: float = 0.0002, interval: int = 1, warm_up: int = 100):
        self.momentum = momentum
        self.interval = interval
        self.warm_up = warm_up
        self._backup = None

    @staticmethod
    def _params(runner):
        return list(runner.state.net.parameters())

    def before_run(self, runner):
        runner.ema_params = [p.detach().clone() for p in self._params(runner)]

    @torch.no_grad()
    def after_train_iter(self, runner):
        if (runner.iter + 1) % self.interval:
            return
        m = np.float32(min(self.momentum, (1 + runner.iter) / (self.warm_up + runner.iter)))
        # (1 - m) * ema + m * p, each product rounded, as XLA computes it
        torch._foreach_mul_(runner.ema_params, float(np.float32(1.0) - m))
        torch._foreach_add_(runner.ema_params,
                            torch._foreach_mul(self._params(runner), float(m)))

    @torch.no_grad()
    def apply_ema(self, runner):
        params = self._params(runner)
        self._backup = [p.detach().clone() for p in params]
        torch._foreach_copy_(params, runner.ema_params)

    @torch.no_grad()
    def restore(self, runner):
        if self._backup is not None:
            torch._foreach_copy_(self._params(runner), self._backup)
            self._backup = None

    def before_val_epoch(self, runner):
        self.apply_ema(runner)

    def after_val_epoch(self, runner):
        self.restore(runner)


@HOOKS.register_module()
class ProfilerHook(Hook):
    """A ``torch.profiler`` trace over iterations ``start_iter`` to
    ``start_iter + n_iters - 1``, written as a Chrome trace under
    ``out_dir`` (``work_dir/profile`` by default); the card's kernels are
    traced when there is one, beside the program's ``span:`` ranges, and
    the counters (``utils/tracing.py``) are logged with the trace's path,
    each as its change over the traced iterations."""

    def __init__(self, start_iter: int = 2, n_iters: int = 3, out_dir: Optional[str] = None):
        self.start_iter = start_iter
        self.n_iters = n_iters
        self.out_dir = out_dir
        self._prof = None
        self._counted = {}
        self.trace_path = None

    def before_train_iter(self, runner):
        if runner.iter == self.start_iter and self._prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._counted = tracing.read_counters()
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()

    def _stop(self, runner):
        self._prof.__exit__(None, None, None)
        out = self.out_dir or osp.join(runner.work_dir or ".", "profile")
        os.makedirs(out, exist_ok=True)
        self.trace_path = osp.join(out, f"trace_{self.start_iter}_{runner.iter}.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        counted = {k: v - self._counted.get(k, 0) for k, v in tracing.read_counters().items()}
        runner.logger.info(f"Profiler trace written ({self.start_iter}..{runner.iter}) "
                           f"-> {self.trace_path}; counters {counted}")

    def after_train_iter(self, runner):
        if self._prof is not None and runner.iter >= self.start_iter + self.n_iters - 1:
            self._stop(runner)

    def after_run(self, runner):
        if self._prof is not None:
            self._stop(runner)


@HOOKS.register_module()
class DistSamplerSeedHook(Hook):
    """Reseed shuffling loaders per epoch."""

    def before_train_epoch(self, runner):
        loader = runner.cur_loader
        if loader is not None and hasattr(loader, "epoch"):
            loader.epoch = runner.epoch


@HOOKS.register_module()
class SyncBuffersHook(Hook):
    """Nothing to sync on one card: the parameters and the recurrent state
    live in the one ``TrainState`` (multi-GPU is ROADMAP.md Queue 1)."""


@HOOKS.register_module()
class EmptyCacheHook(Hook):
    """Frees dead host objects and the caching allocator's unused blocks
    after each epoch."""

    def __init__(self, after_epoch: bool = True):
        self.after_epoch = after_epoch

    def after_train_epoch(self, runner):
        if self.after_epoch:
            gc.collect()
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()


def _scalars(runner) -> dict:
    return {k: float(v) for k, v in runner.log_buffer.output.items()
            if np.isscalar(v) or getattr(v, "ndim", 1) == 0}


@HOOKS.register_module()
class TensorboardLoggerHook(Hook):
    """Scalars to TensorBoard (``torch.utils.tensorboard``) every
    ``interval`` iterations; disabled with a warning when the writer is
    unavailable."""

    PRIORITY = 90

    def __init__(self, interval: int = 50, log_dir: Optional[str] = None):
        self.interval = interval
        self.log_dir = log_dir
        self.writer = None

    def before_run(self, runner):
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(self.log_dir or osp.join(runner.work_dir or ".", "tb"))
        except Exception as e:  # missing backend
            runner.logger.warning(f"TensorboardLoggerHook disabled: {e}")

    def after_train_iter(self, runner):
        if self.writer is None or not self.every_n_iters(runner, self.interval):
            return
        runner.log_buffer.average(self.interval)
        for k, v in _scalars(runner).items():
            self.writer.add_scalar(f"train/{k}", v, runner.iter + 1)

    def after_run(self, runner):
        if self.writer is not None:
            self.writer.flush()


@HOOKS.register_module()
class WandbLoggerHook(Hook):
    """W&B scalars; disabled with a warning without ``wandb``."""

    PRIORITY = 90

    def __init__(self, interval: int = 50, init_kwargs: Optional[dict] = None):
        self.interval = interval
        self.init_kwargs = init_kwargs or {}
        self.run = None

    def before_run(self, runner):
        try:
            import wandb

            self.run = wandb.init(**self.init_kwargs)
        except Exception as e:
            runner.logger.warning(f"WandbLoggerHook disabled: {e}")

    def after_train_iter(self, runner):
        if self.run is None or not self.every_n_iters(runner, self.interval):
            return
        runner.log_buffer.average(self.interval)
        self.run.log(dict(runner.log_buffer.output), step=runner.iter + 1)


@HOOKS.register_module()
class EarlyStoppingHook(Hook):
    """Ends training when ``monitor`` has not improved by ``min_delta`` for
    ``patience`` epochs (the runner's ``max_epochs`` becomes this epoch)."""

    PRIORITY = 75

    def __init__(self, monitor: str = "loss", rule: str = "less", patience: int = 5,
                 min_delta: float = 0.0):
        if rule not in ("less", "greater"):
            raise ValueError(f"EarlyStoppingHook rule {rule!r}: 'less' or 'greater'")
        self.monitor = monitor
        self.rule = rule
        self.patience = patience
        self.min_delta = min_delta
        self.best = None
        self.wait = 0

    def _improved(self, value):
        if self.best is None:
            return True
        if self.rule == "less":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def after_train_epoch(self, runner):
        runner.log_buffer.average()
        value = runner.log_buffer.output.get(self.monitor)
        if value is None:
            return
        if self._improved(value):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                runner.logger.info(
                    f"EarlyStopping: {self.monitor} did not improve for "
                    f"{self.patience} epochs (best={self.best:.5f})")
                runner._max_epochs = runner.epoch  # stop the loop


@HOOKS.register_module()
class OptimizerHook(Hook):
    """Config shim for ``optimizer_config=dict(type="OptimizerHook",
    grad_clip=...)``: the backward, the clip and the step happen in the
    runner's step, built by ``setup`` from ``optimizer_config``."""

    def __init__(self, grad_clip=None, **kwargs):
        self.grad_clip = grad_clip

    def before_run(self, runner):
        if self.grad_clip and runner.state is None:
            runner.logger.warning(
                "OptimizerHook.grad_clip set but runner.setup() has not "
                "built the optimizer yet; pass optimizer_config to setup()")


@HOOKS.register_module()
class MultiOptimizerHook(OptimizerHook):
    """Config shim: the ``StateMachineRunner``'s optimizers step in its own
    steps."""


@HOOKS.register_module()
class GradientCumulativeOptimizerHook(OptimizerHook):
    """Config shim: accumulation is the optimizer's ``MultiSteps``, built
    from ``optimizer_config.cumulative_iters``."""

    def __init__(self, cumulative_iters=1, **kwargs):
        super().__init__(**kwargs)
        self.cumulative_iters = cumulative_iters


class _ScalarLoggerHook(Hook):
    """Experiment trackers: the log buffer averaged every ``interval``
    iterations handed to ``_log_scalars``; disabled with a warning when the
    client package is missing."""

    PRIORITY = 90

    def __init__(self, interval: int = 50):
        self.interval = interval
        self._ok = False

    def _setup(self, runner):
        raise NotImplementedError

    def _log_scalars(self, scalars: dict, step: int):
        raise NotImplementedError

    def before_run(self, runner):
        try:
            self._setup(runner)
            self._ok = True
        except Exception as e:
            runner.logger.warning(f"{type(self).__name__} disabled: {e}")

    def after_train_iter(self, runner):
        if not self._ok or not self.every_n_iters(runner, self.interval):
            return
        runner.log_buffer.average(self.interval)
        scalars = _scalars(runner)
        if scalars:
            self._log_scalars(scalars, runner.iter + 1)


@HOOKS.register_module()
class MlflowLoggerHook(_ScalarLoggerHook):
    """MLflow tracker; needs ``mlflow``."""

    def __init__(self, exp_name: Optional[str] = None, tags=None, interval: int = 50,
                 **kwargs):
        super().__init__(interval)
        self.exp_name = exp_name
        self.tags = tags

    def _setup(self, runner):
        import mlflow

        self._mlflow = mlflow
        if self.exp_name:
            mlflow.set_experiment(self.exp_name)
        if self.tags:
            mlflow.set_tags(self.tags)

    def _log_scalars(self, scalars, step):
        self._mlflow.log_metrics(scalars, step=step)


@HOOKS.register_module()
class NeptuneLoggerHook(_ScalarLoggerHook):
    """Neptune tracker; needs ``neptune``."""

    def __init__(self, init_kwargs: Optional[dict] = None, interval: int = 50, **kwargs):
        super().__init__(interval)
        self.init_kwargs = init_kwargs or {}

    def _setup(self, runner):
        import neptune

        self._run = neptune.init_run(**self.init_kwargs)

    def _log_scalars(self, scalars, step):
        for k, v in scalars.items():
            self._run[k].append(v, step=step)

    def after_run(self, runner):
        if self._ok:
            self._run.stop()


@HOOKS.register_module()
class PaviLoggerHook(_ScalarLoggerHook):
    """PAVI tracker; needs ``pavi``."""

    def __init__(self, init_kwargs: Optional[dict] = None, interval: int = 50, **kwargs):
        super().__init__(interval)
        self.init_kwargs = init_kwargs or {}

    def _setup(self, runner):
        from pavi import SummaryWriter

        self._writer = SummaryWriter(**self.init_kwargs)

    def _log_scalars(self, scalars, step):
        self._writer.add_scalars("train", scalars, step)


@HOOKS.register_module()
class DvcliveLoggerHook(_ScalarLoggerHook):
    """DVCLive tracker; needs ``dvclive``."""

    def __init__(self, model_file: Optional[str] = None, interval: int = 50, **kwargs):
        super().__init__(interval)
        self.model_file = model_file

    def _setup(self, runner):
        from dvclive import Live

        self._live = Live()

    def _log_scalars(self, scalars, step):
        self._live.step = step
        for k, v in scalars.items():
            self._live.log_metric(k, v)


@HOOKS.register_module()
class HeartbeatHook(Hook):
    """Liveness beacon for the elastic supervisor (``tools/run_elastic.py``):
    ``{"time", "iter", "epoch"}`` written atomically (a temporary file and a
    rename) every ``interval`` iterations, at epoch ends and around the run.
    It reads host counters only."""

    PRIORITY = 10

    def __init__(self, path: str, interval: int = 10):
        self.path = path
        self.interval = int(interval)

    def _beat(self, runner):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"time": time.time(), "iter": int(runner.iter),
                       "epoch": int(runner.epoch)}, f)
        os.replace(tmp, self.path)  # atomic: the watcher never reads a torn file

    def before_run(self, runner):
        self._beat(runner)

    def after_train_iter(self, runner):
        if (runner.iter + 1) % self.interval == 0:
            self._beat(runner)

    def after_train_epoch(self, runner):
        self._beat(runner)

    def after_run(self, runner):
        self._beat(runner)
