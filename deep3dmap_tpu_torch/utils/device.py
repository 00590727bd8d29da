"""Device resolution for the port's entry points.

Every entry point runs on the GPU unless its caller asks for the CPU by name:
``None`` means ``"cuda"``, and a CUDA request on a machine without a usable
GPU raises instead of continuing on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is requested but unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deep3dmap_tpu_torch: CUDA requested (the default) but no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return dev
