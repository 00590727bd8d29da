"""The async producer datasets (``datasets/async_producer.py``): JAX's cases
(``tests/test_async_producer.py``) on the port, one producer's batches
against JAX's producer for the same seed, and the producers' processes
without torch.

The port's ``SyntheticFaceUVDataset`` gives JAX's items (PR 8's parity), and
one producer draws JAX's epoch order from the same ``RandomState``, so the
batches agree to float32 rounding of the synthetic faces (1e-6).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from deep3dmap_tpu_torch.datasets import build_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACES = dict(type="SyntheticFaceUVDataset", n_samples=6, resolution=16)


@pytest.fixture(scope="module")
def async_ds():
    ds = build_dataset(dict(type="AsyncProducerDataset", dataset=FACES, batch_size=2,
                            nthread=2, n_slots=3))
    yield ds
    ds.close()


def test_get_returns_batches(async_ds):
    batch = async_ds.get()
    assert set(batch) >= {"faceimg", "gt_uvimg", "tform_mat"}
    assert batch["faceimg"].shape == (2, 16, 16, 3)
    assert batch["gt_uvimg"].shape == (2, 16, 16, 3)
    assert np.isfinite(batch["faceimg"]).all() and batch["faceimg"].std() > 0.01


def test_iter_yields_epoch(async_ds):
    batches = list(iter(async_ds))
    assert len(batches) == async_ds.iter_size == 3
    assert all(b["faceimg"].shape == (2, 16, 16, 3) for b in batches)


def test_batches_vary(async_ds):
    a, b, c = (async_ds.get()["faceimg"] for _ in range(3))
    assert not (np.allclose(a, b) and np.allclose(b, c))


def test_producers_hold_no_torch(async_ds):
    """The producers build the wrapped dataset without torch (and hide the
    card from their process)."""
    async_ds.get()
    flags = async_ds.producers_imported_torch()
    assert len(flags) == 2 and all(f is False for f in flags if f is not None)
    assert any(f is False for f in flags)


def test_state_tagging():
    for kind, state in (("FaceImagesAsyncDataset", "sup_unsup"),
                        ("FaceTexUVAsyncDataset", "sup")):
        ds = build_dataset(dict(type=kind, dataset=dict(FACES, n_samples=4, resolution=8),
                                batch_size=1, nthread=1, n_slots=2))
        try:
            assert ds.state == state
            assert ds.get()["faceimg"].shape == (1, 8, 8, 3)
        finally:
            ds.close()
    ds = build_dataset(dict(type="AsyncProducerDataset", dataset=FACES, nthread=1, n_slots=2,
                            state="unsup"))
    try:
        assert ds.state == "unsup" and len(ds) == 6 and ds.iter_size == 6
    finally:
        ds.close()


@pytest.mark.parametrize("epoch_mode", [True, False])
def test_one_producer_matches_jax(epoch_mode):
    from deep3dmap_tpu.datasets import build_dataset as jax_build

    cfg = dict(type="AsyncProducerDataset", dataset=FACES, batch_size=2, nthread=1,
               n_slots=2, seed=7, epoch_mode=epoch_mode)
    port, ref = build_dataset(dict(cfg)), jax_build(dict(cfg))
    try:
        assert port.keys == ref.keys
        for _ in range(5):
            a, b = port.get(), ref.get()
            for k in ref.keys:
                np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=0, err_msg=k)
    finally:
        port.close()
        ref.close()


def test_producer_path_imports_no_torch():
    """A process that builds and drains an async dataset through the
    package's entry point never imports torch, nor do its producers."""
    code = ("import sys\n"
            "from deep3dmap_tpu_torch.datasets import build_dataset\n"
            "ds = build_dataset(dict(type='FaceTexUVAsyncDataset', batch_size=2, nthread=2,\n"
            "    n_slots=3, dataset=dict(type='SyntheticFaceUVDataset', n_samples=4,\n"
            "    resolution=8)))\n"
            "[ds.get() for _ in range(4)]\n"
            "flags = ds.producers_imported_torch()\n"
            "ds.close()\n"
            "assert 'torch' not in sys.modules, sorted(m for m in sys.modules if 'torch' in m)\n"
            "assert True not in flags and False in flags, flags\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=180)
    assert r.returncode == 0, r.stderr
