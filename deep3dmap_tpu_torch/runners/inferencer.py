"""BaseInferencer (port of ``deep3dmap_tpu/runners/inferencer.py``): a
config and a port checkpoint -> a callable predictor over any registered
framework.  The framework runs on the card unless ``device="cpu"`` is
asked for; the recurrent state is carried from call to call."""
from __future__ import annotations

from typing import Any, Optional, Union

import torch

from ..models.builder import build_reconstruction
from ..utils.config import Config
from .forward_engine import _host


class BaseInferencer:
    def __init__(self, config: Union[str, Config, dict], checkpoint: Optional[str] = None,
                 seed: int = 0, device=None):
        if isinstance(config, str):
            config = Config.fromfile(config)
        self.cfg = config
        self.framework = build_reconstruction(config["model"], device=device)
        self._net = None
        self._mstate = None
        self._ckpt = checkpoint
        self._seed = seed

    def _ensure_init(self, batch):
        if self._net is not None:
            return
        from .checkpoint import load_checkpoint_raw, tree_leaves, tree_unflatten

        self._net, self._mstate = self.framework.init(self._seed, batch)
        if self._ckpt:
            restored = load_checkpoint_raw(self._ckpt, map_location=self.framework.device)
            self._net.load_state_dict(restored["net"])
            leaves = restored.get("model_state") or []
            if leaves and len(leaves) == len(tree_leaves(self._mstate)):
                self._mstate = tree_unflatten(self._mstate, leaves)

    @torch.no_grad()
    def __call__(self, batch: dict) -> Any:
        """``forward_test`` on one batch; its outputs as host arrays."""
        self._ensure_init(batch)
        out, self._mstate = self.framework.forward_test(self._net, self._mstate, batch)
        return {k: _host(v) for k, v in out.items()}
