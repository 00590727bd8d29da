"""One training step: the counterpart of ``base_runner.py:192-210`` and
``bench.py:222-228``.

``train_step`` zeroes the gradients, runs the framework's ``loss_fn``,
backpropagates, clips and takes an Adam step, and carries the recurrent
model state on.  Nothing in it waits for the device.  ``BaseRunner.run_iter``
(``base_runner.py``) calls it.

Data parallelism: a framework on a mesh (``set_mesh``) keeps its data
group as ``loss_group``; one bucketed ``all_reduce(SUM)`` of the gradients
over it runs between the backward and the optimizer's step.  SUM, not
DDP's mean: the framework's loss is the global batch's on every rank (the
fused loss all-reduces its sums, ``ops/fused_loss.py``), so each rank's
gradient is the global loss's through its own shard and the sum is the
global gradient.  The clip and ``grad_norm`` then see it, as
``clip_by_global_norm`` does in JAX's sharded step.  A plain collective
after the backward, not a DDP wrapper: the step stays the single-card one,
and its collectives are counted (``parallel/collectives.py``).

Under a profiler the step records the spans ``step`` and, inside it,
``step.forward``, ``step.backward``, ``step.grad_reduce`` (on a mesh) and
``step.optimizer`` (``utils/tracing.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

from ..parallel.collectives import reduce_gradients
from ..utils.tracing import span
from .optim import ClippedAdam, build_optimizer


@dataclasses.dataclass
class TrainState:
    """The network, its optimizer (one ``ClippedAdam``, or one per head by
    name as Gan2Shape's runner keeps them), the model state, the updates
    taken, and the generator of the steps' random draws where they draw
    (JAX's ``TrainState.rng``)."""
    net: torch.nn.Module
    optimizer: Union[ClippedAdam, Mapping[str, ClippedAdam]]
    model_state: Dict[str, Any]
    step: int = 0
    rng: Optional[torch.Generator] = None


def init_train_state(framework, seed: int, batch, optimizer_cfg: dict,
                     grad_clip: Optional[dict] = None) -> TrainState:
    """Seeded weights and initial model state from ``framework.init`` (on the
    framework's device, CUDA unless it was built with ``device="cpu"``), and
    the optimizer over the weights."""
    net, model_state = framework.init(seed, batch)
    return TrainState(net=net, model_state=model_state,
                      optimizer=build_optimizer(optimizer_cfg, net.parameters(),
                                                grad_clip))


def train_step(framework, state: TrainState, batch
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One step.  Returns the new state and the log: the per-level losses,
    ``loss`` and ``grad_norm`` (before clipping), as device tensors.  A state
    with a generator hands it to ``loss_fn`` as ``rng``.  The framework's
    ``loss_group`` (the data-parallel ranks its loss is the global batch's
    over) sums the gradients over it before the step."""
    with span("step"):
        opt = state.optimizer
        opt.zero_grad()
        kw = {} if state.rng is None else {"rng": state.rng}
        with span("step.forward"):
            loss, aux = framework.loss_fn(state.net, state.model_state, batch, **kw)
        with span("step.backward"):
            loss.backward()
        group = getattr(framework, "loss_group", None)
        if group is not None:
            with span("step.grad_reduce"):
                reduce_gradients(state.net.parameters(), group)
        with span("step.optimizer"):
            grad_norm = opt.step()
    log_vars = {k: v.detach() for k, v in aux["log_vars"].items()}
    log_vars["loss"] = loss.detach()
    log_vars["grad_norm"] = grad_norm
    return dataclasses.replace(state, model_state=aux["model_state"],
                               step=state.step + 1), log_vars
