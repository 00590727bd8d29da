"""GNeRF's readers in the port against the JAX package's, on the same files:
``SyntheticNerfDataset`` (both colour modes, both splits), ``BlenderDataset``
(RGBA composited on white, ``INTER_AREA`` resize, the aspect-ratio check,
the ``val`` split cut to 8) and ``DTUDataset`` (``*_cam.txt`` parsing, every
8th image to ``val``, x4 intrinsics, ``trans_scale``), on the trees the
port's fixture writers lay out (``datasets/synthetic.py``).

The JAX readers decode with ``cv2`` and resize 0-255 floats before /255;
the port decodes with its PNG codec and resizes after: images agree to
float32 rounding (1e-6), intrinsics and poses exactly.
"""
import os.path as osp

import numpy as np
import pytest

from deep3dmap_tpu.datasets import real_files as JR
from deep3dmap_tpu.datasets.nerf_synthetic import SyntheticNerfDataset as JSynthetic
from deep3dmap_tpu_torch.datasets import real_files as TR
from deep3dmap_tpu_torch.datasets.builder import build_dataset
from deep3dmap_tpu_torch.datasets.nerf_synthetic import SyntheticNerfDataset
from deep3dmap_tpu_torch.datasets.synthetic import write_blender_fixture, write_dtu_fixture

IMG_ATOL = 1e-6


def _same_items(jds, tds):
    assert len(jds) == len(tds)
    np.testing.assert_array_equal(np.asarray(jds.intrinsics), tds.intrinsics)
    for i in range(len(jds)):
        a, b = jds[i], tds[i]
        assert set(a) == set(b) and int(a["img_idx"]) == int(b["img_idx"]) == i
        assert b["imgs"].dtype == np.float32
        np.testing.assert_allclose(b["imgs"], a["imgs"], rtol=0, atol=IMG_ATOL)


@pytest.mark.parametrize("split,color_mode", [("train", "shade"), ("val", "position"),
                                              ("train", "position")])
def test_synthetic_nerf_dataset(split, color_mode):
    kw = dict(n_images=3, img_wh=(24, 16), split=split, color_mode=color_mode)
    _same_items(JSynthetic(**kw), SyntheticNerfDataset(**kw, device="cpu"))
    assert build_dataset(dict(type="SyntheticNerfDataset", **kw),
                         default_args=dict(device="cpu")).n_images == 3


@pytest.fixture(scope="module")
def blender(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lego"))
    return write_blender_fixture(root, splits=(("train", 3), ("val", 10), ("test", 2)),
                                 img_wh=(40, 40))


@pytest.mark.parametrize("split,wh", [("train", (40, 40)), ("train", (20, 20)),
                                      ("val", (16, 16)), ("test", (24, 24))])
def test_blender_dataset(blender, split, wh):
    jds = JR.BlenderDataset(blender, split=split, img_wh=wh)
    tds = TR.BlenderDataset(blender, split=split, img_wh=wh, device="cpu")
    _same_items(jds, tds)
    np.testing.assert_array_equal(jds.poses, tds.poses)
    assert len(tds) == {"train": 3, "val": 8, "test": 2}[split]
    # RGBA on white: the fixture's background (alpha 0) reads 1.0
    assert (tds[0]["imgs"] == 1.0).all(-1).any()


def test_blender_aspect_ratio_is_checked(blender):
    with pytest.raises(ValueError, match="aspect ratio"):
        JR.BlenderDataset(blender, split="train", img_wh=(40, 30))
    with pytest.raises(ValueError, match="aspect ratio"):
        TR.BlenderDataset(blender, split="train", img_wh=(40, 30), device="cpu")
    with pytest.raises(FileNotFoundError):
        TR.BlenderDataset(blender, split="missing", device="cpu")


@pytest.fixture(scope="module")
def dtu(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dtu"))
    return write_dtu_fixture(root, n_views=17, img_wh=(32, 24))


@pytest.mark.parametrize("split,wh", [("train", (32, 24)), ("val", (32, 24)),
                                      ("train", (16, 12))])
def test_dtu_dataset(dtu, split, wh):
    jds = JR.DTUDataset(dtu, split=split, img_wh=wh)
    tds = TR.DTUDataset(dtu, split=split, img_wh=wh, device="cpu")
    _same_items(jds, tds)
    np.testing.assert_array_equal(jds.poses, tds.poses)
    assert [osp.basename(f) for f in tds.filenames] == [osp.basename(f) for f in jds.filenames]
    assert len(tds) == (2 if split == "val" else 15)
    # the fixture's cameras: eye at radius 5 after trans_scale
    np.testing.assert_allclose(np.linalg.norm(tds.poses[:, :, 3], axis=-1), 5.0, rtol=1e-5)
