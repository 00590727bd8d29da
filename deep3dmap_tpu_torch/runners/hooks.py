"""Hooks: host-side callbacks at step/epoch boundaries (port of
``deep3dmap_tpu/runners/hooks.py:20-186``).

Hooks observe the runner for timing, logging, checkpoints and evaluation;
the lr schedule and the clip live in the optimizer (``runners/optim.py``).
Ported: ``Hook``, ``HOOKS``, ``build_hook``, ``IterTimerHook``,
``TextLoggerHook`` (its JSON log in the JAX keys), ``CheckpointHook``,
``EvalHook`` and ``ClosureHook``; ``runners/hooks_extra.py`` registers the
rest.
"""
from __future__ import annotations

import json
import os.path as osp
import time

from typing import Optional

from ..utils.registry import Registry

HOOKS = Registry("hook")


def build_hook(cfg, default_args=None):
    from . import hooks_extra  # noqa: F401  (register)

    return HOOKS.build(dict(cfg), **(default_args or {}))


class Hook:
    PRIORITY = 50  # lower runs earlier

    stages = ("before_run", "before_train_epoch", "before_train_iter",
              "after_train_iter", "after_train_epoch", "before_val_epoch",
              "before_val_iter", "after_val_iter", "after_val_epoch",
              "after_run")

    def before_run(self, runner):
        pass

    def after_run(self, runner):
        pass

    def before_train_epoch(self, runner):
        pass

    def after_train_epoch(self, runner):
        pass

    def before_train_iter(self, runner):
        pass

    def after_train_iter(self, runner):
        pass

    def before_val_epoch(self, runner):
        pass

    def after_val_epoch(self, runner):
        pass

    def before_val_iter(self, runner):
        pass

    def after_val_iter(self, runner):
        pass

    @staticmethod
    def every_n_epochs(runner, n):
        return (runner.epoch + 1) % n == 0 if n > 0 else False

    @staticmethod
    def every_n_iters(runner, n):
        return (runner.iter + 1) % n == 0 if n > 0 else False

    @staticmethod
    def is_last_epoch(runner):
        return runner.epoch + 1 == runner.max_epochs

    @staticmethod
    def is_last_iter(runner):
        return runner.iter + 1 == runner.max_iters


@HOOKS.register_module()
class IterTimerHook(Hook):
    """Per-iteration host wall time into the log buffer.  The port's step
    does not wait for the device, so ``time`` is the host's time per step,
    which the device catches up with at the logger's interval."""

    def before_train_epoch(self, runner):
        self.t = time.time()

    def before_train_iter(self, runner):
        runner.log_buffer.update({"data_time": time.time() - self.t})

    def after_train_iter(self, runner):
        now = time.time()
        runner.log_buffer.update({"time": now - self.t})
        self.t = now


@HOOKS.register_module()
class TextLoggerHook(Hook):
    """Console and JSON logging every ``interval`` iters; the only place the
    training loop reads its logged values from the device."""

    PRIORITY = 90

    def __init__(self, interval: int = 50, by_epoch: bool = True, json_log: bool = True):
        self.interval = interval
        self.by_epoch = by_epoch
        self.json_log = json_log
        self._json_path = None
        self._iters_since_log = 0

    def before_run(self, runner):
        if self.json_log and runner.work_dir is not None:
            self._json_path = osp.join(runner.work_dir, f"{runner.timestamp}.log.json")

    def _log(self, runner, mode: str):
        runner.log_buffer.average(self.interval)
        out = dict(runner.log_buffer.output)
        lr = runner.current_lr()
        head = (f"Epoch [{runner.epoch + 1}][{runner.inner_iter + 1}/{len(runner.cur_loader)}]"
                if self.by_epoch and runner.cur_loader is not None
                else f"Iter [{runner.iter + 1}]")
        items = ", ".join(f"{k}: {v:.4f}" for k, v in out.items())
        runner.logger.info(f"{head} lr: {lr:.3e}, {items}")
        if self._json_path is not None:
            rec = dict(mode=mode, epoch=runner.epoch + 1, iter=runner.iter + 1, lr=float(lr), **out)
            with open(self._json_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        runner.log_buffer.clear_output()

    def after_train_iter(self, runner):
        if self.every_n_iters(runner, self.interval):
            self._log(runner, "train")
            self._iters_since_log = 0
        else:
            self._iters_since_log += 1

    def after_train_epoch(self, runner):
        # flush only iters not already covered by an interval log
        if runner.log_buffer.val_history and self._iters_since_log > 0:
            self._log(runner, "train")
        self._iters_since_log = 0
        runner.log_buffer.clear()

    def after_val_epoch(self, runner):
        runner.log_buffer.average()
        out = dict(runner.log_buffer.output)
        items = ", ".join(f"{k}: {v:.4f}" for k, v in out.items())
        runner.logger.info(f"Epoch(val) [{runner.epoch + 1}] {items}")
        runner.log_buffer.clear()


@HOOKS.register_module()
class CheckpointHook(Hook):
    """Periodic checkpoints (``runners/checkpoint.py``)."""

    PRIORITY = 70

    def __init__(self, interval: int = 1, by_epoch: bool = True, max_keep_ckpts: int = -1,
                 save_last: bool = True):
        self.interval = interval
        self.by_epoch = by_epoch
        self.max_keep_ckpts = max_keep_ckpts
        self.save_last = save_last

    def _save(self, runner, completed_iters):
        from .checkpoint import save_checkpoint
        # every rank takes part in gathering the whole state; rank 0 saves
        state = runner.whole_state() if hasattr(runner, "whole_state") else runner.state
        if getattr(runner, "rank", 0) != 0:
            return
        save_checkpoint(runner.work_dir, state,
                        meta=dict(epoch=runner.epoch + 1, iter=completed_iters),
                        max_keep=self.max_keep_ckpts)
        runner.logger.info(f"Saved checkpoint at epoch {runner.epoch + 1} "
                           f"(step {runner.state.step})")

    def after_train_epoch(self, runner):
        if not self.by_epoch:
            return
        if self.every_n_epochs(runner, self.interval) or (self.save_last and self.is_last_epoch(runner)):
            # the epoch loop has already counted its last run_iter
            self._save(runner, runner.iter)

    def after_train_iter(self, runner):
        if self.by_epoch:
            return
        if self.every_n_iters(runner, self.interval) or (self.save_last and self.is_last_iter(runner)):
            # after_train_iter fires before the loop's `iter += 1`
            self._save(runner, runner.iter + 1)


@HOOKS.register_module()
class EvalHook(Hook):
    """``runner.val()`` every ``interval`` epochs (or iterations without
    ``by_epoch``) from ``start`` on, and with ``save_best`` a checkpoint
    under ``work_dir/best/`` whenever the averaged ``val_<save_best>`` (or
    ``<save_best>``) improves by ``rule`` ("less" or "greater").

    The value is read at this hook's own ``after_val_epoch`` (priority 80),
    before the text logger (90) averages and clears the buffer, one device
    read per evaluation.  (JAX's reads it after ``val`` returns, when a
    ``TextLoggerHook`` has cleared it, so its ``save_best`` saves only
    without a text logger.)  The val loader is the workflow's ``val`` entry
    (``EpochBasedRunner.run`` sets ``runner._val_loader``)."""

    PRIORITY = 80

    def __init__(self, interval: int = 1, by_epoch: bool = True,
                 start: Optional[int] = None, save_best: Optional[str] = None,
                 rule: str = "less"):
        if rule not in ("less", "greater"):
            raise ValueError(f"EvalHook rule {rule!r}: 'less' or 'greater'")
        self.interval = interval
        self.by_epoch = by_epoch
        self.start = start
        self.save_best = save_best
        self.rule = rule
        self.best = None
        self._evaluating = False

    def _should(self, runner):
        idx = runner.epoch if self.by_epoch else runner.iter
        if self.start is not None and idx + 1 < self.start:
            return False
        n = self.interval
        return (idx + 1) % n == 0 if n > 0 else False

    def _evaluate(self, runner):
        if runner.val_fn is None:
            return
        self._evaluating = True
        try:
            runner.val()
        finally:
            self._evaluating = False

    def after_train_epoch(self, runner):
        if self.by_epoch and self._should(runner):
            self._evaluate(runner)

    def after_train_iter(self, runner):
        if not self.by_epoch and self._should(runner):
            self._evaluate(runner)

    def after_val_epoch(self, runner):
        if not (self._evaluating and self.save_best):
            return
        hist = runner.log_buffer.val_history
        key = next((k for k in (f"val_{self.save_best}", self.save_best) if k in hist), None)
        if key is None:
            return
        from ..utils.log_buffer import _to_floats

        weights = runner.log_buffer.n_history[key]
        vals = _to_floats(hist[key])
        val = sum(v * w for v, w in zip(vals, weights)) / max(sum(weights), 1)
        if self.best is None or (val < self.best if self.rule == "less" else val > self.best):
            self.best = val
            from .checkpoint import save_checkpoint

            state = runner.whole_state() if hasattr(runner, "whole_state") else runner.state
            if getattr(runner, "rank", 0) != 0:
                return
            path = save_checkpoint(osp.join(runner.work_dir, "best"), state,
                                   meta={"best": float(val), "metric": self.save_best})
            runner.logger.info(f"New best {self.save_best}={val:.5f} -> {path}")


@HOOKS.register_module()
class ClosureHook(Hook):
    """A function of the runner at one stage: ``ClosureHook(fn_name, fn)``."""

    def __init__(self, fn_name: str, fn):
        if fn_name not in Hook.stages:
            raise ValueError(f"ClosureHook: {fn_name!r} is not a hook stage")
        setattr(self, fn_name, fn)
