"""One training step: the counterpart of ``base_runner.py:192-210`` and
``bench.py:222-228``.

``train_step`` zeroes the gradients, runs the framework's ``loss_fn``,
backpropagates, clips and takes an Adam step, and carries the recurrent
model state on.  Nothing in it waits for the device.  ``BaseRunner.run_iter``
(``base_runner.py``) calls it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

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
    with a generator hands it to ``loss_fn`` as ``rng``."""
    opt = state.optimizer
    opt.zero_grad()
    kw = {} if state.rng is None else {"rng": state.rng}
    loss, aux = framework.loss_fn(state.net, state.model_state, batch, **kw)
    loss.backward()
    grad_norm = opt.step()
    log_vars = {k: v.detach() for k, v in aux["log_vars"].items()}
    log_vars["loss"] = loss.detach()
    log_vars["grad_norm"] = grad_norm
    return dataclasses.replace(state, model_state=aux["model_state"],
                               step=state.step + 1), log_vars
