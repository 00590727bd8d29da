"""Iteration-based training loop (port of
``deep3dmap_tpu/runners/iter_based_runner.py``): a fixed number of
iterations over an endlessly cycling loader, the batches uploaded ahead of
the step by ``prefetch``, across epoch restarts too.

A framework that draws random numbers in its step (``LERFModel``) gets
``BaseRunner.setup``'s step generator as ``state.rng``; ``train_step``
hands it to ``loss_fn`` and the checkpoints carry its state.
"""
from __future__ import annotations

from .base_runner import BaseRunner
from .builder import RUNNERS


class IterLoader:
    """Endless iterator over a loader that counts its epochs.  ``wrap`` (the
    runner's device prefetcher) wraps the loader again at each restart."""

    def __init__(self, loader, wrap=None):
        self._loader = loader
        self._wrap = wrap if wrap is not None else (lambda l: l)
        self._iter = iter(self._wrap(loader))
        self._epoch = 0

    @property
    def epoch(self):
        return self._epoch

    def __len__(self):
        return len(self._loader)

    def __next__(self):
        try:
            return next(self._iter)
        except StopIteration:
            self._epoch += 1
            self._iter = iter(self._wrap(self._loader))
            return next(self._iter)


@RUNNERS.register_module()
class IterBasedRunner(BaseRunner):
    def run(self, data_loaders, workflow=(("train", -1),), max_iters=None, **kwargs):
        """``workflow`` [('train', n_iters or -1), ('val', 1), ...]; -1 runs
        to ``max_iters``."""
        if max_iters is not None:
            self._max_iters = max_iters
        assert self._max_iters is not None, "max_iters must be set"
        if not isinstance(data_loaders, (list, tuple)):
            data_loaders = [data_loaders]
        iter_loaders = [IterLoader(dl, wrap=self.prefetch) for dl in data_loaders]

        self.call_hook("before_run")
        self.cur_loader = data_loaders[0]
        self.call_hook("before_train_epoch")
        while self.iter < self._max_iters:
            for i, (mode, iters) in enumerate(workflow):
                if mode == "train":
                    n = iters if iters > 0 else self._max_iters - self.iter
                    for _ in range(n):
                        if self.iter >= self._max_iters:
                            break
                        self.inner_iter = self.iter % max(len(iter_loaders[i]), 1)
                        self.epoch = iter_loaders[i].epoch
                        self.call_hook("before_train_iter")
                        self.run_iter(next(iter_loaders[i]))
                        self.call_hook("after_train_iter")
                        self.iter += 1
                elif mode == "val":
                    self.val(data_loaders[i])
                else:
                    raise ValueError(f"Unknown workflow mode {mode}")
        self.call_hook("after_train_epoch")
        self.call_hook("after_run")
