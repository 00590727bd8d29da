"""PyTorch/CUDA port of ``deep3dmap_tpu`` for NVIDIA Hopper (H100).

The JAX package ``deep3dmap_tpu`` is the reference: every module here mirrors
its counterpart's path and names, keeps its public layouts (images NHWC,
volumes NDHWC, batch dicts with the same keys) and is held against it by the
``tests/test_torch_*.py`` parity tests.  Nothing here imports JAX, flax or
``deep3dmap_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit ``"cpu"`` they raise (``utils/device.py``).  The
Pallas TPU kernels become kernels written by hand for Hopper (``ops/``).
"""
