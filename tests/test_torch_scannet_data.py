"""The port's ScanNet data path against the JAX package's, on the CPU.

A fixture scene written by JAX's ``write_scannet_fixture`` (its colour
frames JPEG through cv2) feeds both sides.  The port's data-gen writes the
same ``fragments_*.pkl`` as ``tools/data_gen/scannet.py`` and, with
``--save-tsdf``, the same full-scene TSDF; ``ScanNetDataset[i]`` through the
quality pipeline (``tools/quality_regression.py:46-63``) gives JAX's sample;
the loader's order is JAX's; the port's PNG codec round-trips and reads what
cv2 wrote; the port's own fixture holds JAX's depth, poses and intrinsics.

Tolerances.  Everything read from disk or computed in numpy is exact.  The
GT TSDF is fused in float32 by both frameworks and agrees to float32
rounding (atol 1e-5, as tests/test_torch_synthetic.py), with one named
exception: in fragment 1 the finest level's voxel (17, 0, 9) projects within
float32 rounding of a pixel boundary, the two frameworks' projections round
to neighbouring pixels, and its tsdf reads -0.89944 (JAX) against -0.84085
(the port).  The occupancy agrees exactly, that voxel included.  The port's
fixture stores colour as PNG where JAX's stores JPEG (quality 95): the
colours agree to JPEG's error, mean absolute difference under 2 of 255.
"""
import importlib.util
import os
import os.path as osp
import pickle
import sys

import cv2
import numpy as np
import pytest
import torch

from deep3dmap_tpu.datasets import build_dataset as jax_build_dataset
from deep3dmap_tpu.datasets.builder import NumpyLoader as JaxNumpyLoader
from deep3dmap_tpu.datasets.synthetic import write_scannet_fixture as jax_write_fixture

from deep3dmap_tpu_torch.datasets.builder import (NumpyLoader, build_dataset,
                                                  prefetch_to_device)
from deep3dmap_tpu_torch.datasets.synthetic import write_scannet_fixture
from deep3dmap_tpu_torch.tools import data_gen_scannet
from deep3dmap_tpu_torch.utils import image_io

torch.set_num_threads(2)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TSDF_ATOL = 1e-5
# (sample, level, voxel) whose nearest pixel differs between the frameworks
PIXEL_EDGE_VOXELS = {(1, 0, (17, 0, 9))}
SCENE = "scene0707_00"
PIPELINE = [
    dict(type="SeqResizeImage", size=(64, 48), depth_key="depth"),
    dict(type="SeqRandomTransformSpace", voxel_dim=(24, 24, 24), voxel_size=0.08,
         random_rotation=False, random_translation=False, n_layers=3),
    dict(type="SeqIntrinsicsPoseToProjection", n_views=5, stride=4),
    dict(type="SeqNormalizeImages", mean=[127.5] * 3, std=[127.5] * 3),
]
DATA_GEN_ARGS = ["--n-views", "5", "--min-angle", "1", "--min-distance", "0.01",
                 "--n-proc", "1"]


def _jax_data_gen():
    spec = importlib.util.spec_from_file_location(
        "jax_data_gen_scannet", osp.join(ROOT, "tools", "data_gen", "scannet.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scannet"))
    jax_write_fixture(root, splits=("train", "test"), n_frames=10)
    return root


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _same_metas(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]), err_msg=k)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_data_gen_writes_jax_fragments(jax_fixture, mode, monkeypatch):
    out = osp.join(jax_fixture, f"fragments_{mode}.pkl")
    monkeypatch.setattr(sys, "argv", ["scannet.py", "--datapath", jax_fixture,
                                      "--mode", mode, *DATA_GEN_ARGS])
    _jax_data_gen().main()
    ref = _load(out)
    data_gen_scannet.main(["--datapath", jax_fixture, "--mode", mode, *DATA_GEN_ARGS])
    _same_metas(_load(out), ref)
    assert [m["image_ids"] for m in ref] == [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]]


def test_data_gen_save_tsdf_matches_jax(tmp_path, monkeypatch):
    root = str(tmp_path)
    jax_write_fixture(root, splits=("train",), n_frames=6)
    args = ["--datapath", root, "--mode", "train", "--save-tsdf", "--voxel-size", "0.16",
            *DATA_GEN_ARGS]
    npz = osp.join(root, "scans", SCENE, "full_tsdf.npz")
    monkeypatch.setattr(sys, "argv", ["scannet.py", *args])
    _jax_data_gen().main()
    ref = dict(np.load(npz))
    data_gen_scannet.main(args + ["--device", "cpu"])
    port = dict(np.load(npz))
    assert port.keys() == ref.keys()
    np.testing.assert_array_equal(port["origin"], ref["origin"])
    assert float(port["voxel_size"]) == float(ref["voxel_size"])
    np.testing.assert_array_equal(port["weight"], ref["weight"])
    np.testing.assert_allclose(port["tsdf"], ref["tsdf"], atol=TSDF_ATOL, rtol=0)
    assert (port["weight"] > 0).sum() > 1000


@pytest.mark.parametrize("mode", ["train", "test"])
def test_dataset_sample_matches_jax(jax_fixture, mode):
    data_gen_scannet.main(["--datapath", jax_fixture, "--mode", mode, *DATA_GEN_ARGS])
    cfg = dict(type="ScanNetDataset", datapath=jax_fixture, mode=mode, nviews=5,
               n_scales=2, img_size=(64, 48), n_vox=24, voxel_size=0.08, pipeline=PIPELINE)
    ref_ds = jax_build_dataset(dict(cfg))
    port_ds = build_dataset(dict(cfg), default_args=dict(device="cpu"))
    assert len(port_ds) == len(ref_ds) == 2
    for i in range(2):
        ref, port = ref_ds[i], port_ds[i]
        assert port.keys() == ref.keys()
        for k in ref:
            if k in ("tsdf_list", "occ_list"):
                continue
            a, b = ref[k], port[k]
            if isinstance(a, list):
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(np.asarray(y), np.asarray(x), err_msg=k)
            else:
                np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=k)
        for lvl, (a, b) in enumerate(zip(ref["tsdf_list"], port["tsdf_list"])):
            assert b.dtype == np.float32 and a.shape == b.shape
            off = {(i, lvl, tuple(v)) for v in np.argwhere(np.abs(a - b) > TSDF_ATOL).tolist()}
            assert off <= PIXEL_EDGE_VOXELS, off
            assert np.abs(a - b).max() < 0.1
        for a, b in zip(ref["occ_list"], port["occ_list"]):
            assert b.dtype == np.float32
            np.testing.assert_array_equal(b, a)
        assert port["occ_list"][0].sum() > 0


def test_numpy_loader_order_matches_jax():
    data = [dict(i=np.int64(i), x=np.full(2, i, np.float32)) for i in range(7)]
    for kw in (dict(shuffle=True, seed=3), dict(shuffle=False),
               dict(shuffle=True, seed=0, drop_last=False, batch_size=3),
               dict(shuffle=True, seed=1, num_workers=2, batch_size=2)):
        port, ref = NumpyLoader(data, **kw), JaxNumpyLoader(data, **kw)
        assert len(port) == len(ref)
        for _ in range(3):      # three epochs: the shuffle seed is seed + epoch
            assert [b["i"].tolist() for b in port] == [b["i"].tolist() for b in ref]


def test_prefetch_checks_on_the_host_then_converts():
    batches = [dict(a=np.full(3, i, np.float64), lst=[np.ones(2, np.int32)], name=["s"])
               for i in range(4)]
    seen = []
    out = list(prefetch_to_device(iter(batches), "cpu", depth=2, host_check=seen.append))
    assert seen == batches
    for i, b in enumerate(out):
        assert b["a"].dtype == torch.float32 and b["a"].tolist() == [float(i)] * 3
        assert b["lst"][0].dtype == torch.int32 and b["name"] == ["s"]


@pytest.mark.parametrize("shape,dtype", [((48, 64, 3), np.uint8), ((37, 53), np.uint16),
                                         ((20, 30), np.uint8), ((16, 24, 4), np.uint8)],
                         ids=["bgr8", "depth16", "grey8", "bgra8"])
def test_png_codec_roundtrip_and_reads_cv2(tmp_path, shape, dtype):
    rs = np.random.RandomState(0)
    noise = (rs.rand(*shape) * np.iinfo(dtype).max).astype(dtype)
    smooth = np.sort(noise, axis=1)         # rows that cv2's filters predict well
    for img in (noise, smooth):
        path = str(tmp_path / "own.png")
        image_io.imwrite_png(path, img)
        got = image_io.imread(path)
        assert got.dtype == img.dtype and np.array_equal(got, img)
        assert np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
        for level in (0, 3, 9):
            path = str(tmp_path / f"cv2_{level}.png")
            cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
            assert np.array_equal(image_io.imread(path),
                                  cv2.imread(path, cv2.IMREAD_UNCHANGED))


def test_png_codec_undoes_every_row_filter():
    """Rows filtered with Sub, Up, Average and Paeth (types 1-4), built by
    hand from a known image, decode to it."""
    import struct
    import zlib

    rs = np.random.RandomState(1)
    img = rs.randint(0, 256, (5, 7, 3)).astype(np.uint8)     # RGB rows in the file
    raw = img.reshape(5, -1).astype(np.int64)
    rows, prev = [], np.zeros(raw.shape[1], np.int64)
    for y, ftype in enumerate((1, 2, 3, 4, 0)):
        cur = raw[y]
        left = np.concatenate([np.zeros(3, np.int64), cur[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int64), prev[:-3]])
        if ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        elif ftype == 4:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        else:
            pred = 0
        rows.append(bytes([ftype]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 7, 5, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))
    assert np.array_equal(image_io.decode_png(png), img[..., ::-1])   # -> BGR
    assert np.array_equal(cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_UNCHANGED),
                          img[..., ::-1])


def test_imread_jpeg_is_cv2s_and_bad_files_raise(jax_fixture, tmp_path):
    path = osp.join(jax_fixture, "scans", SCENE, "color", "0.jpg")
    assert np.array_equal(image_io.imread(path), cv2.imread(path))
    bad = tmp_path / "x.jpg"
    bad.write_bytes(b"not an image")
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        image_io.imread(str(bad))


def test_port_fixture_holds_jax_frames(jax_fixture, tmp_path):
    root = str(tmp_path)
    write_scannet_fixture(root, splits=("test",), n_frames=10, device="cpu")
    a, b = osp.join(jax_fixture, "scans_test", SCENE), osp.join(root, "scans_test", SCENE)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    np.testing.assert_array_equal(np.loadtxt(osp.join(b, "intrinsic", "intrinsic_depth.txt")),
                                  np.loadtxt(osp.join(a, "intrinsic", "intrinsic_depth.txt")))
    for i in range(10):
        np.testing.assert_array_equal(np.loadtxt(osp.join(b, "pose", f"{i}.txt")),
                                      np.loadtxt(osp.join(a, "pose", f"{i}.txt")))
        np.testing.assert_array_equal(image_io.imread(osp.join(b, "depth", f"{i}.png")),
                                      cv2.imread(osp.join(a, "depth", f"{i}.png"),
                                                 cv2.IMREAD_ANYDEPTH))
        port_c = image_io.imread(osp.join(b, "color", f"{i}.jpg"))
        jax_c = cv2.imread(osp.join(a, "color", f"{i}.jpg"))
        assert port_c.shape == jax_c.shape and port_c.dtype == np.uint8
        assert np.abs(port_c.astype(int) - jax_c.astype(int)).mean() < 2.0
        # cv2 reads the port's PNG frames by content, under their .jpg names
        assert np.array_equal(cv2.imread(osp.join(b, "color", f"{i}.jpg")), port_c)
