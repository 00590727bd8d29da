"""Pipeline composition (port of
``deep3dmap_tpu/datasets/pipelines/compose.py``)."""
from __future__ import annotations

import inspect

from ..builder import PIPELINES


@PIPELINES.register_module()
class Compose:
    """Applies transforms in order; a transform returning None drops the
    sample.  ``device`` goes to every transform built from a dict whose
    class takes a ``device`` argument and whose dict names none (the GT
    fusion of ``SeqRandomTransformSpace``)."""

    def __init__(self, transforms, device=None):
        self.transforms = []
        for t in transforms:
            if isinstance(t, dict):
                t = dict(t)
                cls = PIPELINES.get(t["type"])
                if (device is not None and cls is not None and "device" not in t
                        and "device" in inspect.signature(cls).parameters):
                    t["device"] = device
                self.transforms.append(PIPELINES.build(t))
            elif callable(t):
                self.transforms.append(t)
            else:
                raise TypeError(f"transform must be dict or callable, got {type(t)}")

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
            if data is None:
                return None
        return data

    def __repr__(self):
        return f"Compose({self.transforms})"
