"""Gan2ShapeRunner: the per-instance fitting loop of Gan2Shape, on
``BaseRunner`` (port of ``deep3dmap_tpu/runners/gan2shape_runner.py:31-173``).

Each epoch fits one instance: ``num_stage`` stages of step 1 (photometric),
a snapshot of the canonical estimate, step 2 (latent projection) and a pool
of projected samples, then step 3 (joint refinement on samples drawn from
the pool).  With ``use_mask`` and no ``input_mask`` in the instance, the
mask comes from ``framework.parse_mask`` once per instance, before
``before_train_iter``.

- ``state`` is a ``TrainState`` (``runners/train_state.py``) with one Adam
  per head by name (``runners/optim.py::build_optimizer``, the configs'
  ``grad_clip`` and lr schedule per head as optax's per-head chain) and the
  generator of step 2's draws; a mode steps only its ``MODE_NETS`` heads.
- ``reset_weight`` restores the heads' *parameters* at each instance, as
  JAX does (:95-97); the optimizers' moments and counts carry over.
- The step-2 pool is ``stage_iters["step2"] // 4`` (at least 1) no-grad
  ``forward_step2`` calls, the i-th with a generator seeded ``1000 + i``
  (JAX: ``PRNGKey(1000 + i)``).  Step 3 draws its indices with JAX's numpy
  call (``step3_indices``), so they are JAX's indices.
- Hooks run around each epoch and its one iteration (the instance), as in
  JAX.  Every step's logs go to ``log_buffer`` under JAX's ``s1_``/``s2_``/
  ``s3_`` keys as device tensors; ``logs`` gets one entry per stage, the
  mean of each logged value.
- No step waits for the device: the batch goes to the device once per
  instance, a stage's step-3 indices at the stage's start, and the stage's
  means are read once when it ends.
- Checkpoints (``runners/checkpoint.py``) hold the heads, each head's
  optimizer, the mapping net's centres, the step generator and the epoch;
  the frozen GAN comes from ``gan_ckpt`` or the seeded init.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..utils.device import make_deterministic
from .base_runner import BaseRunner
from .builder import RUNNERS
from .train_state import TrainState

MODE_NETS = {
    "step1": ["depth_head", "albedo_head", "view_head", "light_head"],
    "step2": ["encoder_head"],
    "step3": ["depth_head", "albedo_head", "view_head", "light_head"],
}


def step3_indices(stage: int, pool_size: int, batchsize: int, n: int) -> np.ndarray:
    """(n, batchsize) int64 pool indices of a stage's step-3 batches: JAX's
    ``np.random.RandomState(stage).choice(...)`` calls (:130-133), in order."""
    rs = np.random.RandomState(stage)
    out = [rs.choice(pool_size, batchsize, replace=pool_size < batchsize)
           for _ in range(n)]
    return np.asarray(out, np.int64).reshape(n, batchsize)


@RUNNERS.register_module()
class Gan2ShapeRunner(BaseRunner):
    """``framework``: a ``Gan2Shape``; the runner works on its device.
    ``optimizer``: each head's optimizer config (else ``runner_cfgs``'
    ``optimizer``, else celeba's ``dict(type="Adam", lr=1e-4)``).  The other
    keywords are ``BaseRunner``'s (``runner_cfgs``, ``work_dir``, ``seed``,
    ``max_epochs``, ...)."""

    def __init__(self, framework, optimizer: Optional[dict] = None,
                 stage_iters: Sequence[int] = (20, 20, 20), num_stage: int = 2,
                 reset_weight: bool = True, **kwargs):
        super().__init__(framework, **kwargs)
        self.optimizer_cfg = optimizer
        self.stage_iters = dict(zip(("step1", "step2", "step3"), stage_iters))
        self.num_stage = num_stage
        self.reset_weight = reset_weight
        self.logs: List[Dict[str, float]] = []
        self._init_params: Optional[Dict[str, torch.Tensor]] = None

    def setup(self, sample_batch, optimizer: Optional[dict] = None,
              lr_config: Optional[dict] = None, optimizer_config: Optional[dict] = None,
              iters_per_epoch: int = 1):
        """Seeded weights (``framework.init``), one optimizer per head, the
        snapshot ``reset_weight`` restores, and the step generator; training
        is made bitwise repeatable (``utils/device.py``).  Returns (net,
        model_state)."""
        make_deterministic()
        fw = self.framework
        make_optimizer = self._optimizer_factory(
            optimizer or self.optimizer_cfg, lr_config, optimizer_config, iters_per_epoch,
            dict(type="Adam", lr=1e-4))
        net, model_state = fw.init(self.seed, sample_batch)
        self.state = TrainState(
            net=net, model_state=model_state,
            optimizer={name: make_optimizer(getattr(net, name).parameters())
                       for name in fw.network_names},
            rng=torch.Generator(device=fw.device).manual_seed(self.seed))
        self._init_params = {n: p.detach().clone() for n, p in net.named_parameters()}
        self._log_init(net)
        return net, model_state

    @property
    def net(self):
        return None if self.state is None else self.state.net

    @property
    def model_state(self):
        return self.state.model_state

    @property
    def optimizers(self) -> Mapping:
        return self.state.optimizer

    @property
    def rng(self) -> torch.Generator:
        return self.state.rng

    @property
    def step(self) -> int:
        return self.state.step

    @step.setter
    def step(self, value: int):
        self.state.step = value

    def train_step(self, mode: str, batch) -> Dict[str, torch.Tensor]:
        """One step of ``mode``: ``loss_fn``, backward, an Adam step of the
        mode's heads.  Returns the logs and ``loss`` as device tensors."""
        if self.state is None:
            raise RuntimeError("Gan2ShapeRunner: call setup(sample_batch) first")
        for opt in self.optimizers.values():
            opt.zero_grad()
        loss, aux = self.framework.loss_fn(self.net, self.model_state, batch,
                                           self.rng, mode=mode)
        loss.backward()
        for name in MODE_NETS[mode]:
            self.optimizers[name].step()
        self.step += 1
        log = {k: v.detach() for k, v in aux["log_vars"].items()}
        log["loss"] = loss.detach()
        return log

    def _collect_canon(self, batch) -> Dict[str, torch.Tensor]:
        """The canonical estimate of the current heads (step-1 forward and
        the light head on the input), kept on the device."""
        out, _ = self.framework.forward_test(self.net, self.model_state, batch)
        with torch.no_grad():
            light = self.net.light_head(batch["input_im"])
        return dict(depth=out["depth"], albedo=out["albedo"], normal=out["normal"],
                    light=light)

    def _collect_pool(self, batch):
        fw = self.framework
        proj, masks = [], []
        with torch.no_grad():
            for i in range(max(self.stage_iters["step2"] // 4, 1)):
                gen = torch.Generator(device=fw.device).manual_seed(1000 + i)
                _, _, outs = fw.forward_step2(self.net, self.model_state, batch, gen)
                proj.append(outs["proj_im"])
                masks.append(outs["mask"])
        return torch.cat(proj), torch.cat(masks)

    def fit_instance(self, batch):
        """One instance through every stage (the batch: numpy or tensors)."""
        fw = self.framework
        if self.reset_weight and self._init_params is not None:
            with torch.no_grad():
                for n, p in self.net.named_parameters():
                    p.copy_(self._init_params[n])
        dev = fw.batch_to_device(batch)
        n3 = self.stage_iters["step3"]
        pool_size = max(self.stage_iters["step2"] // 4, 1) * fw.batchsize
        for stage in range(self.num_stage):
            logs: Dict[str, List[torch.Tensor]] = {}

            def keep(prefix, log):
                log = {f"{prefix}_{k}": v for k, v in sorted(log.items())}
                self.log_buffer.update(log)
                for k, v in log.items():
                    logs.setdefault(k, []).append(v)
            # the stage's step-3 indices go to the device while it is idle
            idx = torch.from_numpy(step3_indices(stage, pool_size, fw.batchsize,
                                                 n3)).to(fw.device)
            for _ in range(self.stage_iters["step1"]):
                keep("s1", self.train_step("step1", dev))
            step2_batch = dict(dev, **self._collect_canon(dev))
            for _ in range(self.stage_iters["step2"]):
                keep("s2", self.train_step("step2", step2_batch))
            proj_pool, mask_pool = self._collect_pool(step2_batch)
            for i in range(n3):
                b3 = dict(dev, proj_im=proj_pool[idx[i]], proj_mask=mask_pool[idx[i]])
                keep("s3", self.train_step("step3", b3))
            self.logs.append(self._stage_means(logs, stage))
        return self.net

    def _stage_means(self, logs: Mapping[str, List[torch.Tensor]], stage: int):
        """The mean of each logged value over the stage: one read."""
        keys = sorted(logs)
        means = torch.stack([torch.stack(logs[k]).mean() for k in keys]).tolist() \
            if keys else []
        return dict(zip(keys, means), epoch=self.epoch, stage=stage)

    def train(self, dataset):
        """One epoch: the instance ``dataset.setup_input(epoch)`` (or
        ``dataset[epoch % len(dataset)]``), its mask derived when the
        framework uses one and the instance has none, fitted by
        ``fit_instance`` between the hooks."""
        self.mode = "train"
        self.call_hook("before_train_epoch")
        batch = dataset.setup_input(self.epoch) if hasattr(dataset, "setup_input") \
            else dataset[self.epoch % len(dataset)]
        if np.ndim(batch["input_im"]) == 3:
            batch = {k: np.asarray(v)[None] for k, v in batch.items()}
        fw = self.framework
        if fw.use_mask and "input_mask" not in batch:
            batch = dict(batch, input_mask=fw.parse_mask(batch["input_im"]))
        self.call_hook("before_train_iter")
        self.fit_instance(batch)
        self.call_hook("after_train_iter")
        self.iter += 1
        self.call_hook("after_train_epoch")
        self.epoch += 1

    def run(self, datasets, workflow=(("train", 1),), max_epochs: Optional[int] = None,
            **kwargs):
        """Fit instances until ``max_epochs`` (one instance per epoch);
        ``datasets[0]`` is the dataset or a loader over it."""
        if max_epochs is not None:
            self._max_epochs = max_epochs
        if self._max_epochs is None:
            raise ValueError("Gan2ShapeRunner.run: max_epochs is not set")
        dataset = datasets[0] if isinstance(datasets, (list, tuple)) else datasets
        if hasattr(dataset, "dataset"):       # a loader wrapping the dataset
            dataset = dataset.dataset
        self._max_iters = self._max_epochs
        self.call_hook("before_run")
        while self.epoch < self._max_epochs:
            self.train(dataset)
        self.call_hook("after_run")
