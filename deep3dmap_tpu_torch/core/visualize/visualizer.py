"""Visualizer and its backends (port of
``deep3dmap_tpu/core/visualize/visualizer.py``): drawing is plain numpy
rasterisation (points, boxes, masks) so it runs headless, every ``add_*``
fans out to the configured backends, and a backend whose client library is
missing fails when it is first used (its import is gated).  The local
backend writes PNGs with the port's own encoder.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ...utils.image_io import imwrite_png
from ...utils.registry import Registry

VISBACKENDS = Registry("vis_backend")


class BaseVisBackend:
    """Backend contract: lazily created
    experiment object + add_config/add_image/add_scalar(s)/close."""

    def __init__(self, save_dir: Optional[str] = None):
        self._save_dir = save_dir
        self._env_initialized = False

    def _init_env(self):  # pragma: no cover - trivial
        self._env_initialized = True

    def _ensure(self):
        if not self._env_initialized:
            self._init_env()
            self._env_initialized = True

    def add_config(self, config: dict, **kwargs):
        raise NotImplementedError

    def add_image(self, name: str, image: np.ndarray, step: int = 0, **kw):
        raise NotImplementedError

    def add_scalar(self, name: str, value, step: int = 0, **kw):
        raise NotImplementedError

    def add_scalars(self, scalars: Dict[str, float], step: int = 0, **kw):
        for k, v in scalars.items():
            self.add_scalar(k, v, step=step)

    def close(self):
        pass


@VISBACKENDS.register_module()
class LocalVisBackend(BaseVisBackend):
    """Filesystem backend: images as PNG under
    ``save_dir/vis_image``, scalars appended to ``scalars.json`` (one JSON
    object per line), config dumped to ``config.py``."""

    def _init_env(self):
        os.makedirs(self._save_dir, exist_ok=True)
        os.makedirs(os.path.join(self._save_dir, "vis_image"), exist_ok=True)
        self._scalar_file = os.path.join(self._save_dir, "scalars.json")

    def add_config(self, config: dict, **kwargs):
        self._ensure()
        with open(os.path.join(self._save_dir, "config.py"), "w") as f:
            f.write(repr(config))

    def add_image(self, name: str, image: np.ndarray, step: int = 0, **kw):
        self._ensure()
        path = os.path.join(self._save_dir, "vis_image",
                            f"{name}_{step}")
        image = np.asarray(image).astype(np.uint8)
        if image.ndim == 3 and image.shape[2] in (3, 4):
            image = image[..., [2, 1, 0, 3][:image.shape[2]]]    # the encoder takes BGR(A)
        imwrite_png(path + ".png", image)

    def add_scalar(self, name: str, value, step: int = 0, **kw):
        self._ensure()
        rec = {name: float(value), "step": int(step), "time": time.time()}
        with open(self._scalar_file, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def add_scalars(self, scalars: Dict[str, float], step: int = 0, **kw):
        self._ensure()
        rec = {k: float(v) for k, v in scalars.items()}
        rec.update(step=int(step), time=time.time())
        with open(self._scalar_file, "a") as f:
            f.write(json.dumps(rec) + "\n")


@VISBACKENDS.register_module()
class TensorboardVisBackend(BaseVisBackend):
    """Gated on a TensorBoard writer being available."""

    def _init_env(self):
        from torch.utils.tensorboard import SummaryWriter  # gated import

        self._writer = SummaryWriter(self._save_dir)

    def add_config(self, config: dict, **kwargs):
        self._ensure()
        self._writer.add_text("config", repr(config))

    def add_image(self, name, image, step=0, **kw):
        self._ensure()
        self._writer.add_image(name, np.asarray(image), step,
                               dataformats="HWC")

    def add_scalar(self, name, value, step=0, **kw):
        self._ensure()
        self._writer.add_scalar(name, float(value), step)

    def close(self):
        if self._env_initialized:
            self._writer.close()


@VISBACKENDS.register_module()
class WandbVisBackend(BaseVisBackend):
    """Gated on wandb."""

    def __init__(self, save_dir=None, init_kwargs: Optional[dict] = None):
        super().__init__(save_dir)
        self._init_kwargs = init_kwargs or {}

    def _init_env(self):
        import wandb  # gated import

        self._wandb = wandb
        wandb.init(dir=self._save_dir, **self._init_kwargs)

    def add_config(self, config, **kwargs):
        self._ensure()
        self._wandb.config.update(config, allow_val_change=True)

    def add_image(self, name, image, step=0, **kw):
        self._ensure()
        self._wandb.log({name: self._wandb.Image(np.asarray(image))},
                        step=step)

    def add_scalar(self, name, value, step=0, **kw):
        self._ensure()
        self._wandb.log({name: float(value)}, step=step)

    def close(self):
        if self._env_initialized:
            self._wandb.finish()


@VISBACKENDS.register_module()
class MlflowVisBackend(BaseVisBackend):
    """Gated on mlflow."""

    def _init_env(self):
        import mlflow  # gated import

        self._mlflow = mlflow
        mlflow.start_run()

    def add_config(self, config, **kwargs):
        self._ensure()
        self._mlflow.log_params({k: str(v) for k, v in config.items()})

    def add_image(self, name, image, step=0, **kw):
        self._ensure()
        self._mlflow.log_image(np.asarray(image), f"{name}_{step}.png")

    def add_scalar(self, name, value, step=0, **kw):
        self._ensure()
        self._mlflow.log_metric(name.replace("/", "_"), float(value),
                                step=step)

    def close(self):
        if self._env_initialized:
            self._mlflow.end_run()


class Visualizer:
    """Draw-and-dispatch visualizer.

    Drawing primitives rasterize onto a numpy image (headless-safe); every
    ``add_*`` fans out to all configured backends.  Construct from config:
    ``Visualizer(vis_backends=[dict(type='LocalVisBackend')],
    save_dir='work_dir/vis')``.
    """

    def __init__(self, name: str = "visualizer",
                 vis_backends: Optional[List[dict]] = None,
                 save_dir: Optional[str] = None):
        self.name = name
        self._backends: Dict[str, BaseVisBackend] = {}
        for cfg in vis_backends or []:
            cfg = dict(cfg)
            cfg.setdefault("save_dir", save_dir)
            btype = cfg.pop("type")
            cls = VISBACKENDS.get(btype) if isinstance(btype, str) else btype
            self._backends[getattr(cls, "__name__", str(btype))] = cls(**cfg)
        self._image: Optional[np.ndarray] = None

    def get_backend(self, name: str) -> BaseVisBackend:
        return self._backends[name]

    # -- drawing ------------------------------------------------------------
    def set_image(self, image: np.ndarray):
        self._image = np.ascontiguousarray(np.asarray(image, np.uint8))

    def get_image(self) -> np.ndarray:
        assert self._image is not None, "call set_image first"
        return self._image

    def draw_points(self, positions: np.ndarray,
                    colors=(0, 255, 0), sizes: int = 2):
        img = self.get_image()
        H, W = img.shape[:2]
        c = np.asarray(colors, np.uint8)
        for x, y in np.asarray(positions).reshape(-1, 2):
            x0, x1 = int(max(0, x - sizes)), int(min(W, x + sizes + 1))
            y0, y1 = int(max(0, y - sizes)), int(min(H, y + sizes + 1))
            img[y0:y1, x0:x1] = c
        return self

    def draw_bboxes(self, bboxes: np.ndarray, edge_colors=(0, 255, 0),
                    line_widths: int = 1):
        img = self.get_image()
        H, W = img.shape[:2]
        c = np.asarray(edge_colors, np.uint8)
        w = line_widths
        for x1, y1, x2, y2 in np.asarray(bboxes).reshape(-1, 4):
            x1, y1 = int(max(0, x1)), int(max(0, y1))
            x2, y2 = int(min(W - 1, x2)), int(min(H - 1, y2))
            img[y1:y1 + w, x1:x2 + 1] = c
            img[max(y2 - w + 1, 0):y2 + 1, x1:x2 + 1] = c
            img[y1:y2 + 1, x1:x1 + w] = c
            img[y1:y2 + 1, max(x2 - w + 1, 0):x2 + 1] = c
        return self

    def draw_binary_masks(self, masks: np.ndarray, colors=(0, 255, 0),
                          alphas: float = 0.8):
        img = self.get_image()
        c = np.asarray(colors, np.float32)
        for m in np.asarray(masks, bool).reshape(-1, *img.shape[:2]):
            img[m] = (img[m] * (1 - alphas) + c * alphas).astype(np.uint8)
        return self

    # -- dispatch -----------------------------------------------------------
    def add_config(self, config: dict, **kwargs):
        for b in self._backends.values():
            b.add_config(config, **kwargs)

    def add_image(self, name: str, image: Optional[np.ndarray] = None,
                  step: int = 0):
        image = self.get_image() if image is None else image
        for b in self._backends.values():
            b.add_image(name, image, step=step)

    def add_scalar(self, name: str, value, step: int = 0):
        for b in self._backends.values():
            b.add_scalar(name, value, step=step)

    def add_scalars(self, scalars: Dict[str, float], step: int = 0):
        for b in self._backends.values():
            b.add_scalars(scalars, step=step)

    def close(self):
        for b in self._backends.values():
            b.close()
