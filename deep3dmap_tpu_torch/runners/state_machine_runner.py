"""StateMachineRunner: training through a sequence of states, with one
optimizer per parameter collection (port of
``deep3dmap_tpu/runners/state_machine_runner.py``).

- The state follows the epoch (or the iteration, ``state_switch_by``):
  ``state_seq[i]`` from ``state_steps[i]`` on.  ``state_switch`` runs at the
  start of each epoch of ``run``, so a resumed run lands in its epoch's
  state; on a change it logs ``state switch: A -> B`` and calls the
  framework's ``on_state_switch``.  JAX re-jits the step there; here
  ``loss_fn`` reads the framework's state at each step.
- The collections are JAX's top-level param collections (the keys of its
  params dict, :128): a framework with ``network_names`` holds them as the
  children of its net, every child a collection (GNeRF's five, of which
  ``network_names`` lists three), else there is one, ``"params"``, the
  whole net (a flax module's one collection).  Each has its own optimizer
  (``runners/optim.py``, the config's clip and lr schedule), as JAX keeps
  ``opt_state[name]``.
- ``state.rng`` is a ``torch.Generator`` on the framework's device, seeded
  with the runner's seed (JAX's ``TrainState.rng``); every step hands it to
  ``loss_fn`` as ``rng`` for the draws the framework makes.
- A framework with ``is_multi_opt_iters`` runs ``run_multi_iter``: for
  each optimize sequence of ``setup_optimize_sequences(state)`` one step of
  ``loss_fn(state=, opt_seq=)`` that updates only the collections
  ``optseq2netnames(opt_seq)`` names, logged as ``{opt_seq}_{key}``.
  Otherwise ``run_iter`` steps every collection.  A collection the loss does
  not reach steps with a zero gradient, as optax steps it.
- The logs go to ``log_buffer`` as device tensors, so no step waits for
  the device (JAX converts each to a float).
- ``run`` trains on the loader whose ``state`` attribute names the current
  state, else on the workflow's own (the port's loaders, like JAX's, have
  no ``state``).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import torch

from ..utils.device import make_deterministic
from ..utils.from_flax import param_collection
from .base_runner import BaseRunner
from .builder import RUNNERS
from .train_state import TrainState


@RUNNERS.register_module()
class StateMachineRunner(BaseRunner):
    def __init__(self, *args, state_seq: Sequence[str] = ("default",),
                 state_steps: Sequence[int] = (0,), state_switch_by: str = "epoch",
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.state_seq = list(state_seq)
        self.state_steps = list(state_steps)
        self.state_switch_by = state_switch_by
        self.cur_state = self.state_seq[0]

    # -- state switching (JAX :41-55) ----------------------------------------
    def state_switch(self):
        progress = self.epoch if self.state_switch_by == "epoch" else self.iter
        idx = 0
        for i, start in enumerate(self.state_steps):
            if progress >= start:
                idx = i
        new_state = self.state_seq[idx]
        if new_state != self.cur_state:
            self.logger.info(f"state switch: {self.cur_state} -> {new_state}")
            self.cur_state = new_state
            if hasattr(self.framework, "on_state_switch"):
                self.framework.on_state_switch(new_state)

    # -- setup -----------------------------------------------------------------
    def collections(self, net) -> Dict[str, torch.nn.Module]:
        """Collection name -> the module whose parameters it holds."""
        if getattr(self.framework, "network_names", None):
            return dict(net.named_children())
        return {"params": param_collection(net, "params")}

    def setup(self, sample_batch, optimizer: Optional[dict] = None,
              lr_config: Optional[dict] = None, optimizer_config: Optional[dict] = None,
              iters_per_epoch: int = 1) -> TrainState:
        """Seeded weights (``framework.init``), one optimizer per collection
        and the step generator; training is made bitwise repeatable on the
        card."""
        make_deterministic()
        make_optimizer = self._optimizer_factory(optimizer, lr_config, optimizer_config,
                                                 iters_per_epoch, dict(type="Adam", lr=1e-3))
        net, model_state = self.framework.init(self.seed, sample_batch)
        self.state = TrainState(net=net, model_state=model_state, optimizer={
            name: make_optimizer(m.parameters()) for name, m in self.collections(net).items()},
            rng=torch.Generator(device=self.framework.device).manual_seed(self.seed))
        self._log_init(net)
        return self.state

    # -- steps -----------------------------------------------------------------
    def _step(self, batch, names: Optional[Iterable[str]] = None, **loss_kw):
        """One backward and an update of the collections ``names`` (all when
        None).  Returns the log: the framework's log vars and ``loss``,
        key-sorted as JAX's jitted dict is."""
        opts = self.state.optimizer
        for opt in opts.values():
            opt.zero_grad()
        loss, aux = self.framework.loss_fn(self.state.net, self.state.model_state, batch,
                                           rng=self.state.rng, **loss_kw)
        loss.backward()
        for name in (names if names is not None else opts):
            for p in opts[name].params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            opts[name].step()
        self.state.model_state = aux.get("model_state", self.state.model_state)
        self.state.step += 1
        log_vars = {k: v.detach() for k, v in aux.get("log_vars", {}).items()}
        log_vars["loss"] = loss.detach()
        return dict(sorted(log_vars.items()))

    def run_iter(self, data_batch):
        """One step of every collection; the log to ``log_buffer``."""
        log_vars = self._step(self._host_checked(data_batch))
        self.log_buffer.update(log_vars)
        return log_vars

    def run_multi_iter(self, data_batch):
        """The current state's optimize sequences on one batch (JAX
        :138-154); each step updates only its sequence's collections."""
        fw = self.framework
        sequences: List = (fw.setup_optimize_sequences(self.cur_state)
                           if hasattr(fw, "setup_optimize_sequences") else [None])
        batch = self._host_checked(data_batch)
        all_logs = {}
        for opt_seq in sequences:
            if opt_seq is None:
                log_vars = self._step(batch)
            else:
                names = fw.optseq2netnames(opt_seq) if hasattr(fw, "optseq2netnames") else None
                log_vars = self._step(batch, names, state=self.cur_state, opt_seq=opt_seq)
            for k, v in log_vars.items():
                all_logs[k if opt_seq is None else f"{opt_seq}_{k}"] = v
        self.log_buffer.update(all_logs)
        return all_logs

    # -- loops -----------------------------------------------------------------
    def train(self, data_loader):
        self.mode = "train"
        self.cur_loader = data_loader
        self.call_hook("before_train_epoch")
        multi = getattr(self.framework, "is_multi_opt_iters", False)
        for i, data_batch in enumerate(self.prefetch(data_loader)):
            self.inner_iter = i
            self.call_hook("before_train_iter")
            if multi:
                self.run_multi_iter(data_batch)
            else:
                self.run_iter(data_batch)
            self.call_hook("after_train_iter")
            self.iter += 1
        self.call_hook("after_train_epoch")
        self.epoch += 1

    def run(self, data_loaders, workflow=(("train", 1),), max_epochs=None, **kwargs):
        if max_epochs is not None:
            self._max_epochs = max_epochs
        assert self._max_epochs is not None, "max_epochs must be set"
        if not isinstance(data_loaders, (list, tuple)):
            data_loaders = [data_loaders]
        self._max_iters = self._max_epochs * len(data_loaders[0])
        self.call_hook("before_run")
        while self.epoch < self._max_epochs:
            self.state_switch()
            for i, (mode, epochs) in enumerate(workflow):
                for _ in range(epochs):
                    if mode == "train":
                        if self.epoch >= self._max_epochs:
                            break
                        loader = next((dl for dl in data_loaders
                                       if getattr(dl, "state", None) == self.cur_state),
                                      data_loaders[i])
                        self.train(loader)
                    elif mode == "val":
                        self.val(data_loaders[i])
        self.call_hook("after_run")
