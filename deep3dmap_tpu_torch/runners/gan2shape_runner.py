"""Gan2ShapeRunner: the per-instance fitting loop of Gan2Shape.

Port of ``deep3dmap_tpu/runners/gan2shape_runner.py:25-173`` without
``BaseRunner`` (its hooks, checkpoints and log buffer for this runner are
ROADMAP.md Queue 1, the runtime's leftovers).  Each epoch fits one
instance: ``num_stage`` stages of step 1 (photometric), a snapshot of the
canonical estimate, step 2 (latent projection) and a pool of projected
samples, then step 3 (joint refinement on samples drawn from the pool).

- One Adam per head from ``runners/optim.py::build_optimizer``; a mode
  steps only its ``MODE_NETS`` heads, as optax's per-head ``opt_state``.
- ``reset_weight`` restores the heads' *parameters* at each instance, as
  JAX does (:95-97); the optimizers' moments and counts carry over.
- The step-2 pool is ``stage_iters["step2"] // 4`` (at least 1) no-grad
  ``forward_step2`` calls, the i-th with a generator seeded ``1000 + i``
  (JAX: ``PRNGKey(1000 + i)``).  Step 3 draws its indices with JAX's numpy
  call (``step3_indices``), so they are JAX's indices.
- No step waits for the device: the batch goes to the device once per
  instance, a stage's step-3 indices at the stage's start, and the logs
  stay device tensors until the stage ends (``logs`` gets one entry per
  stage, the mean of each logged value; JAX reads every step's logs).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..utils.device import make_deterministic
from .optim import build_optimizer

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


class Gan2ShapeRunner:
    """``framework``: a ``Gan2Shape``; the runner works on its device.
    ``optimizer``: the config of each head's optimizer (celeba's
    ``dict(type="Adam", lr=1e-4)`` by default)."""

    def __init__(self, framework, optimizer: Optional[dict] = None,
                 stage_iters: Sequence[int] = (20, 20, 20), num_stage: int = 2,
                 reset_weight: bool = True, seed: int = 0,
                 max_epochs: Optional[int] = None):
        self.framework = framework
        self.optimizer_cfg = dict(optimizer or dict(type="Adam", lr=1e-4))
        self.stage_iters = dict(zip(("step1", "step2", "step3"), stage_iters))
        self.num_stage = num_stage
        self.reset_weight = reset_weight
        self.seed = seed
        self.max_epochs = max_epochs
        self.epoch = self.iter = self.step = 0
        self.net = self.model_state = self.rng = None
        self.optimizers: Dict = {}
        self.logs: List[Dict[str, float]] = []
        self._init_params: Optional[Dict[str, torch.Tensor]] = None

    def setup(self, sample_batch):
        """Seeded weights (``framework.init``), one optimizer per head, the
        snapshot ``reset_weight`` restores, and the step generator; training
        is made bitwise repeatable (``utils/device.py``)."""
        make_deterministic()
        fw = self.framework
        self.net, self.model_state = fw.init(self.seed, sample_batch)
        self.optimizers = {name: build_optimizer(self.optimizer_cfg,
                                                 getattr(self.net, name).parameters())
                           for name in fw.network_names}
        self._init_params = {n: p.detach().clone() for n, p in self.net.named_parameters()}
        self.rng = torch.Generator(device=fw.device).manual_seed(self.seed)
        return self.net, self.model_state

    def train_step(self, mode: str, batch) -> Dict[str, torch.Tensor]:
        """One step of ``mode``: ``loss_fn``, backward, an Adam step of the
        mode's heads.  Returns the logs and ``loss`` as device tensors."""
        if self.net is None:
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
                for k, v in log.items():
                    logs.setdefault(f"{prefix}_{k}", []).append(v)
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
        ``dataset[epoch % len(dataset)]``) fitted by ``fit_instance``."""
        batch = dataset.setup_input(self.epoch) if hasattr(dataset, "setup_input") \
            else dataset[self.epoch % len(dataset)]
        if np.ndim(batch["input_im"]) == 3:
            batch = {k: np.asarray(v)[None] for k, v in batch.items()}
        if self.framework.use_mask and "input_mask" not in batch:
            raise NotImplementedError(
                "Gan2ShapeRunner: use_mask=True without an input_mask needs the "
                "parsing models (parse_mask: BiSeNet / PSPNet), which are not "
                "ported yet")
        self.fit_instance(batch)
        self.iter += 1
        self.epoch += 1

    def run(self, datasets, max_epochs: Optional[int] = None):
        """Fit instances until ``max_epochs`` (one instance per epoch)."""
        if max_epochs is not None:
            self.max_epochs = max_epochs
        if self.max_epochs is None:
            raise ValueError("Gan2ShapeRunner.run: max_epochs is not set")
        dataset = datasets[0] if isinstance(datasets, (list, tuple)) else datasets
        if hasattr(dataset, "dataset"):       # a loader wrapping the dataset
            dataset = dataset.dataset
        while self.epoch < self.max_epochs:
            self.train(dataset)
