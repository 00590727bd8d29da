"""Device resolution for the port's entry points.

Every entry point runs on the GPU unless its caller asks for the CPU by name:
``None`` means ``"cuda"``, and a CUDA request on a machine without a usable
GPU raises instead of continuing on the CPU.
"""
from __future__ import annotations

import contextlib
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


def make_deterministic() -> None:
    """Make training bitwise repeatable on the card, as the JAX package's
    is: cuDNN picks deterministic algorithms and no autotuned ones.  The
    port's own scatter-adds reduce in a fixed order on every device (sorted
    ``index_put_(accumulate=True)`` and advanced-indexing gathers in
    ``ops/``, never ``index_add_`` or ``index_select`` under autograd).
    Called by the runner and the CLIs."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and cuDNN convolutions at full precision inside the
    block (TF32 off), whatever the caller's setting; restored on exit.  A
    solver whose result is compared with float32 (the SfM layer's Schur
    complement) runs in it, and so does a check of the op zoo's GEMMs and
    convolutions against the CPU."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
