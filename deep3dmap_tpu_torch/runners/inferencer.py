"""BaseInferencer (port of ``deep3dmap_tpu/runners/inferencer.py``): a
config and a port checkpoint -> a callable predictor over any registered
framework.  The framework runs on the card unless ``device="cpu"`` is
asked for; the recurrent state is carried from call to call.

``mesh`` (``parallel/mesh.py``, every rank calling with the same whole
batch) places each batch as JAX's ``shard_batch`` does and returns the
whole batch's outputs on every rank (``forward_engine.local_batch`` /
``global_outputs``); NeuralRecon's global volumes are sharded as in
training where its ``set_mesh`` takes the spatial path."""
from __future__ import annotations

from typing import Any, Optional, Union

import torch

from ..models.builder import build_reconstruction
from ..utils.config import Config
from .forward_engine import _host, global_outputs, load_for_test, local_batch


class BaseInferencer:
    def __init__(self, config: Union[str, Config, dict], checkpoint: Optional[str] = None,
                 seed: int = 0, device=None, mesh=None):
        if isinstance(config, str):
            config = Config.fromfile(config)
        self.cfg = config
        self.framework = build_reconstruction(config["model"], device=device)
        self.mesh = mesh
        self._spatial = bool(mesh is not None and hasattr(self.framework, "set_mesh")
                             and self.framework.set_mesh(mesh))
        self._net = None
        self._mstate = None
        self._ckpt = checkpoint
        self._seed = seed

    def _ensure_init(self, batch):
        if self._net is not None:
            return
        self._net, self._mstate = self.framework.init(self._seed, batch)
        if self._ckpt:
            self._mstate = load_for_test(self._ckpt, self._net, self._mstate,
                                         self.framework.device, self.mesh, self._spatial)

    @torch.no_grad()
    def __call__(self, batch: dict) -> Any:
        """``forward_test`` on one batch; its outputs as host arrays."""
        local = local_batch(batch, self.mesh)
        self._ensure_init(local)
        out, self._mstate = self.framework.forward_test(self._net, self._mstate, local)
        return {k: _host(v) for k, v in global_outputs(out, batch, self.mesh).items()}
