"""Gan2Shape's CelebA reader: the port's ``CelebaDataset`` against the JAX
package's on the same files, on the CPU.

The tree holds PNGs written by ``cv2.imwrite`` (the JAX reader's codec):
128² faces (one grey, one RGBA), 256² ones (an integer 2x ``INTER_AREA``
shrink), 178x218 ones read with ``crop=178`` (a 178 -> 128 shrink by area
weights), their depth maps (``INTER_LINEAR``), and ``.npy`` and ``.pt``
latents.  ``input_im`` and ``depth_gt`` agree within 1e-6 abs (the same
weights summed in another order; measured 1.8e-7 against ``cv2`` in float32),
latents exactly.  The port reads them with ``cv2`` unimportable.
"""
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from deep3dmap_tpu.datasets.real_files import CelebaDataset as JCeleba
from deep3dmap_tpu_torch.datasets.builder import build_dataset
from deep3dmap_tpu_torch.datasets.real_files import CelebaDataset

ATOL = 1e-6


def _face(rng, h, w):
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    shade = np.clip(1.2 - xx ** 2 - yy ** 2, 0, 1)[..., None] * rng.uniform(0.4, 1.0, 3)
    noise = rng.uniform(0, 0.2, (h, w, 3))
    return np.clip((shade + noise) * 255, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """``celeba/{images,depths,latents}`` and one list per image size."""
    root = tmp_path_factory.mktemp("celeba")
    for d in ("images", "depths", "latents"):
        os.makedirs(root / d)
    rng = np.random.RandomState(0)
    lists = {}
    for size, (h, w) in (("128", (128, 128)), ("256", (256, 256)), ("178", (218, 178))):
        names = []
        for i in range(3):
            name = f"face_{size}_{i}.png"
            img = _face(rng, h, w)
            if size == "128" and i == 1:
                img = img[..., 0]                                      # grey
            if size == "128" and i == 2:
                img = np.concatenate([img, rng.randint(0, 256, (h, w, 1), np.uint8)], -1)
            cv2.imwrite(str(root / "images" / name), img)
            cv2.imwrite(str(root / "depths" / name), _face(rng, h, w))
            lat = rng.randn(512).astype(np.float32)
            if i % 2:
                torch.save(torch.from_numpy(lat), root / "latents" / f"face_{size}_{i}.pt")
            else:
                np.save(root / "latents" / f"face_{size}_{i}.npy", lat)
            names.append(name)
        path = root / f"list_{size}.txt"
        path.write_text("\n".join(names) + "\n\n")
        lists[size] = str(path)
    return root, lists


@pytest.mark.parametrize("size,crop", [("128", None), ("256", None), ("178", 178)])
def test_items_match_jax(tree, monkeypatch, size, crop):
    root, lists = tree
    kw = dict(img_list_path=lists[size], img_root=str(root / "images"),
              latent_root=str(root / "latents"), image_size=128, crop=crop,
              load_gt_depth=True)
    ref = JCeleba(**kw)
    want = [ref[i] for i in range(len(ref))]
    want_setup = ref.setup_input(4)
    monkeypatch.setitem(sys.modules, "cv2", None)      # the port reads without cv2
    ds = build_dataset(dict(type="CelebaDataset", **kw), default_args=dict(device="cpu"))
    assert isinstance(ds, CelebaDataset) and len(ds) == len(ref) == 3
    for i, w in enumerate(want):
        got = ds[i]
        assert set(got) == set(w) == {"input_im", "latent_w", "depth_gt"}
        assert got["input_im"].shape == (128, 128, 3) and got["input_im"].dtype == np.float32
        np.testing.assert_allclose(got["input_im"], w["input_im"], atol=ATOL, rtol=0)
        np.testing.assert_allclose(got["depth_gt"], w["depth_gt"], atol=ATOL, rtol=0)
        np.testing.assert_array_equal(got["latent_w"], w["latent_w"])
    got, w = ds.setup_input(4), want_setup
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in w.items()}
    assert got["input_im"].shape == (1, 128, 128, 3)
    np.testing.assert_allclose(got["input_im"], w["input_im"], atol=ATOL, rtol=0)


def test_resize_weights_match_cv2():
    """``image_io.resize_float`` against ``cv2.resize`` in float32 for the
    reader's two interpolations, shrinking and enlarging, rectangular."""
    from deep3dmap_tpu_torch.utils.image_io import resize_float
    rng = np.random.RandomState(1)
    for (h, w), (H, W) in (((256, 256), (128, 128)), ((178, 178), (128, 128)),
                           ((64, 48), (128, 100)), ((100, 77), (33, 50))):
        img = rng.rand(h, w, 3).astype(np.float32)
        for area, interp in ((True, cv2.INTER_AREA), (False, cv2.INTER_LINEAR)):
            np.testing.assert_allclose(resize_float(img, (W, H), area=area),
                                       cv2.resize(img, (W, H), interpolation=interp),
                                       atol=ATOL, rtol=0, err_msg=f"{(h, w)}->{(H, W)} {area}")
