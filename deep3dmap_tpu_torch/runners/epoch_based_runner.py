"""Epoch-based training loop (port of
``deep3dmap_tpu/runners/epoch_based_runner.py``): an epoch loop over a
``(mode, epochs)`` workflow with per-iteration hooks, the batches uploaded
ahead of the step by ``prefetch``."""
from __future__ import annotations

from .base_runner import BaseRunner
from .builder import RUNNERS


@RUNNERS.register_module()
class EpochBasedRunner(BaseRunner):
    def train(self, data_loader):
        self.mode = "train"
        self.cur_loader = data_loader
        self.call_hook("before_train_epoch")
        for i, data_batch in enumerate(self.prefetch(data_loader)):
            self.inner_iter = i
            self.call_hook("before_train_iter")
            self.run_iter(data_batch)
            self.call_hook("after_train_iter")
            self.iter += 1
        self.call_hook("after_train_epoch")
        self.epoch += 1

    def run(self, data_loaders, workflow=(("train", 1),), max_epochs=None, **kwargs):
        """``data_loaders`` parallel to ``workflow`` [('train', n_epochs), ...]."""
        if max_epochs is not None:
            self._max_epochs = max_epochs
        assert self._max_epochs is not None, "max_epochs must be set"
        if not isinstance(data_loaders, (list, tuple)):
            data_loaders = [data_loaders]
        workflow = list(workflow)
        assert len(data_loaders) == len(workflow)

        self._max_iters = self._max_epochs * len(data_loaders[0])
        # EvalHook's loader: the workflow's val entry
        self._val_loader = next((dl for dl, (mode, _) in zip(data_loaders, workflow)
                                 if mode == "val"), None)
        self.call_hook("before_run")
        while self.epoch < self._max_epochs:
            for i, (mode, epochs) in enumerate(workflow):
                for _ in range(epochs):
                    if mode == "train":
                        if self.epoch >= self._max_epochs:
                            break
                        self.train(data_loaders[i])
                    elif mode == "val":
                        self.val(data_loaders[i])
                    else:
                        raise ValueError(f"Unknown workflow mode {mode}")
        self.call_hook("after_run")
