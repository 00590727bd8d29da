"""The port's detection data path against the JAX package's, on the CPU:

* each single-image transform (``datasets/pipelines/{loading,formating,
  transforms,auto_augment,test_time_aug}.py``) on the same seeded input:
  images equal bit for bit (``uint8`` and ``float32``), boxes and labels
  equal, the same ``flipped`` and ``AutoAugment`` choices;
* ``configs/detection/coco_custom.py``'s train and test pipelines through
  ``CustomDataset`` on a seeded PNG fixture, sample by sample, bit for bit;
* ``CustomDataset``: ``_filter_imgs``, ``flag``, ``_rand_another``,
  ``get_cat_ids``, ``evaluate`` (mAP and recall) equal to JAX's;
* ``utils/fileio.py`` round trips, ``utils/structures.py`` (numpy and
  tensor leaves) and ``utils/mask_structures.py`` (every mask op bit-equal,
  ``tests/test_custom_masks.py`` and ``tests/test_structures_paramwise.py``
  as the spec);
* in a subprocess with ``cv2`` and ``PIL`` blocked: the whole train and
  test pipelines on PNG files and the sequence pipeline's resize.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import deep3dmap_tpu.datasets.pipelines  # noqa: F401  (register)
import deep3dmap_tpu_torch.datasets.pipelines  # noqa: F401  (register)
from deep3dmap_tpu.datasets.builder import PIPELINES as JP
from deep3dmap_tpu.datasets.builder import build_dataset as jbuild
from deep3dmap_tpu.utils import fileio as jfileio
from deep3dmap_tpu.utils import mask_structures as jmask
from deep3dmap_tpu.utils import structures as jstruct
from deep3dmap_tpu.utils.config import Config as JConfig
from deep3dmap_tpu_torch.datasets.builder import PIPELINES as TP
from deep3dmap_tpu_torch.datasets.builder import build_dataset as tbuild
from deep3dmap_tpu_torch.datasets.synthetic import write_detection_fixture
from deep3dmap_tpu_torch.utils import fileio, mask_structures, structures
from deep3dmap_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "detection", "coco_custom.py")


def _same(a, b):
    """Pipeline outputs equal: arrays bit for bit, lists element-wise."""
    assert set(a) == set(b), (set(a) ^ set(b))
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, list) and x and isinstance(x[0], np.ndarray):
            for u, v in zip(x, y):
                assert u.dtype == v.dtype and u.shape == v.shape, k
                np.testing.assert_array_equal(u, v, err_msg=k)
        elif isinstance(x, np.ndarray):
            assert x.dtype == np.asarray(y).dtype and x.shape == np.asarray(y).shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert x == y, k


def _sample(rs, w=133, h=80, dtype=np.uint8):
    img = (rs.rand(h, w, 3) * 255).astype(dtype)
    boxes = np.array([[4, 4, 50, 40], [60, 10, 120, 70], [100, 60, 130, 79]], np.float32)
    return dict(img=img, gt_bboxes=boxes, gt_labels=np.array([1, 2, 3]),
                gt_semantic_seg=(rs.rand(h, w) * 20).astype(np.uint8))


TRANSFORMS = [
    dict(type="Resize", size=(200, 120)),
    dict(type="Normalize", mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
         to_rgb=True),
    dict(type="RandomFlip", prob=0.5, seed=3),
    dict(type="Pad", size_divisor=32, value=7.0),
    dict(type="CenterCrop", size=(40, 64)),
    dict(type="RandomCrop", size=(40, 64), seed=5),
    dict(type="PhotoMetricDistortion", seed=11),
    dict(type="Shear", level=6, prob=0.7),
    dict(type="Shear", level=4, prob=1.0, direction="vertical", img_fill_val=(10, 20, 30)),
    dict(type="Rotate", level=7, prob=0.8),
    dict(type="Rotate", level=5, prob=1.0, center=(20.5, 11.0), scale=1.2),
    dict(type="Translate", level=6, prob=1.0, max_translate_offset=60.0, min_size=2),
    dict(type="Translate", level=3, prob=1.0, direction="vertical"),
    dict(type="ColorTransform", level=7, prob=0.9),
    dict(type="EqualizeTransform", prob=0.9),
    dict(type="BrightnessTransform", level=3, prob=0.9),
    dict(type="ContrastTransform", level=8, prob=0.9),
    dict(type="ToFloat32", keys=("img",)),
    dict(type="ImageToArray", keys=("img",)),
    dict(type="ToTensor", keys=("img",)),
    dict(type="Collect", keys=("img", "gt_bboxes"), meta_keys=("flipped", "none")),
]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("cfg", TRANSFORMS, ids=lambda c: c["type"])
def test_transform_matches_jax(cfg, dtype):
    for call in range(3):          # repeated calls: the draws advance alike
        outs = []
        for reg in (JP, TP):
            np.random.seed(100 + call)
            t = reg.build(dict(cfg))
            for _ in range(call):
                t(_sample(np.random.RandomState(9), dtype=dtype))
            outs.append(t(_sample(np.random.RandomState(call), dtype=dtype)))
        _same(*outs)


def test_face_and_gan_transforms_match_jax():
    rs = np.random.RandomState(0)
    img = rs.rand(64, 64, 3).astype(np.float32)
    lm = np.stack([rs.uniform(20, 40, 68), rs.uniform(25, 45, 68)], 0).T.copy()
    for cfg, data in ((dict(type="FaceLandmarkCrop", resolution_inp=32, scale=1.5),
                       dict(pt3d_68=lm, img=img)),
                      (dict(type="FaceLandmarkCrop", resolution_inp=16),
                       dict(pt3d_68=np.array([5.0, 25.0, 5.0, 25.0]), img=img)),
                      (dict(type="NormalizeForGAN"), dict(img=img)),
                      (dict(type="BlendAToRGB"), dict(img=rs.rand(8, 8, 4).astype(np.float32))),
                      (dict(type="GetKeysFromDict", in_dict_key="mat", out_keys=("pts3d", "x")),
                       dict(mat={"pts3d": np.ones(3), "junk": 0})),
                      (dict(type="FaceFormatBundle", imglike_keys=("img",)),
                       dict(img=np.zeros((8, 8)), tform_mat=np.eye(3)))):
        a, b = (reg.build(dict(cfg))({k: (v.copy() if hasattr(v, "copy") else v)
                                      for k, v in data.items()}) for reg in (JP, TP))
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-4, err_msg=k)


def test_auto_augment_and_multiscale_flip_match_jax():
    policies = [[dict(type="Translate", level=4, prob=1.0, max_translate_offset=10.0)],
                [dict(type="BrightnessTransform", level=10, prob=1.0)],
                [dict(type="Rotate", level=5, prob=1.0), dict(type="EqualizeTransform", prob=1.0)]]
    for seed in range(6):
        outs = []
        for reg in (JP, TP):
            np.random.seed(seed)
            outs.append(reg.build(dict(type="AutoAugment", policies=policies))(
                _sample(np.random.RandomState(seed))))
        _same(*outs)
    tta = dict(type="MultiScaleFlipAug", img_scale=[(16, 16), (32, 24)], flip=True,
               flip_direction=["horizontal", "vertical"],
               transforms=[dict(type="Resize", size=(16, 16)), dict(type="RandomFlip", seed=1)])
    a, b = (reg.build(dict(tta))(dict(img=np.arange(24 * 32 * 3, dtype=np.uint8).reshape(24, 32, 3)))
            for reg in (JP, TP))
    _same(a, b)
    assert b["flip"] == [False, True, True] * 2 and len(b["img"]) == 6


def test_instaboost_needs_its_package():
    from deep3dmap_tpu_torch.datasets.pipelines.test_time_aug import InstaBoost

    try:
        import instaboostfast  # noqa: F401
        pytest.skip("instaboostfast is installed")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="pip install instaboostfast"):
        InstaBoost()


def test_loading_transforms(tmp_path):
    from deep3dmap_tpu_torch.utils.image_io import imwrite_png

    rs = np.random.RandomState(0)
    for name, img in (("c3.png", (rs.rand(9, 7, 3) * 255).astype(np.uint8)),
                      ("g.png", (rs.rand(9, 7) * 255).astype(np.uint8)),
                      ("c4.png", (rs.rand(9, 7, 4) * 255).astype(np.uint8))):
        path = str(tmp_path / name)
        imwrite_png(path, img)
        for cfg in (dict(type="LoadImageFromFile"),
                    dict(type="LoadImageFromFile", to_float32=True, color_order="rgb")):
            _same(*(reg.build(dict(cfg))({"img_path": path}) for reg in (JP, TP)))
    with pytest.raises(FileNotFoundError):
        TP.build(dict(type="LoadImageFromFile"))({"img_path": str(tmp_path / "none.png")})
    np.save(tmp_path / "a.npy", np.arange(5))
    out = TP.build(dict(type="LoadArrayUsingNp"))({"arr_path": str(tmp_path / "a.npy")})
    np.testing.assert_array_equal(out["arr"], np.arange(5))
    import scipy.io as sio
    sio.savemat(tmp_path / "m.mat", {"pts": np.ones((2, 3)), "other": 1})
    out = TP.build(dict(type="LoadMatDictUsingSio", fields=("pts",)))(
        {"mat_path": str(tmp_path / "m.mat")})
    assert set(out["mat"]) == {"pts"}


@pytest.fixture(scope="module")
def fixture_ann(tmp_path_factory):
    return write_detection_fixture(str(tmp_path_factory.mktemp("det")), n_images=6,
                                   img_wh=(160, 120), seed=3)


def _datasets(ann, part):
    jcfg, tcfg = JConfig.fromfile(CONFIG), Config.fromfile(CONFIG)
    out = []
    for cfg, build in ((jcfg, jbuild), (tcfg, tbuild)):
        d = dict(cfg.data[part])
        d["ann_file"] = ann
        out.append(build(d))
    return out


def test_train_pipeline_through_custom_dataset_matches_jax(fixture_ann):
    jd, td = _datasets(fixture_ann, "train")
    assert len(jd) == len(td) == 6
    np.testing.assert_array_equal(td.flag, jd.flag)
    for i in range(len(td)):
        outs = []
        for ds in (jd, td):
            np.random.seed(i)
            outs.append(ds[i])
        _same(*outs)
        assert outs[1]["img"].shape == (800, 1344, 3) and outs[1]["img"].dtype == np.float32


def test_test_pipeline_through_custom_dataset_matches_jax(fixture_ann):
    jd, td = _datasets(fixture_ann, "test")
    a, b = jd[1], td[1]
    _same(a, b)
    assert [im.shape for im in b["img"]] == [(800, 1344, 3)] * 4
    assert b["flip"] == [False, True, False, True]
    assert b["scale"] == [(1333, 800), (1333, 800), (666, 400), (666, 400)]


def _ann_file(tmp_path):
    infos = [
        dict(filename="a.png", width=640, height=480,
             ann=dict(bboxes=np.array([[10, 10, 100, 100]], np.float32), labels=np.array([0]))),
        dict(filename="b.png", width=480, height=640,
             ann=dict(bboxes=np.array([[5, 5, 50, 50], [60, 60, 120, 120]], np.float32),
                      labels=np.array([0, 1]))),
        dict(filename="empty.png", width=640, height=480,
             ann=dict(bboxes=np.zeros((0, 4), np.float32), labels=np.zeros((0,), np.int64))),
        dict(filename="small.png", width=20, height=480,
             ann=dict(bboxes=np.array([[1, 1, 5, 5]], np.float32), labels=np.array([1]))),
        dict(filename="c.png", width=640, height=480,
             ann=dict(bboxes=np.array([[30, 30, 60, 90]], np.float32), labels=np.array([1]),
                      bboxes_ignore=np.array([[0, 0, 20, 20]], np.float32),
                      labels_ignore=np.array([1]))),
    ]
    path = str(tmp_path / "ann.pkl")
    fileio.dump(infos, path)
    return path


def test_custom_dataset_matches_jax(tmp_path):
    from deep3dmap_tpu.datasets import CustomDataset as JCustom
    from deep3dmap_tpu_torch.datasets.custom import CustomDataset

    ann = _ann_file(tmp_path)
    classes = tmp_path / "classes.txt"
    classes.write_text("c0\nc1\n")
    for kw in (dict(), dict(test_mode=True), dict(classes=str(classes)),
               dict(classes=["c0", "c1"], filter_empty_gt=False)):
        j, t = JCustom(ann, pipeline=None, **kw), CustomDataset(ann, pipeline=None, **kw)
        assert len(t) == len(j) and t.CLASSES == j.CLASSES
        assert [i["filename"] for i in t.data_infos] == [i["filename"] for i in j.data_infos]
        if not kw.get("test_mode"):
            np.testing.assert_array_equal(t.flag, j.flag)
            assert t._filter_imgs() == j._filter_imgs()
            for idx in range(len(t)):
                np.random.seed(idx)
                a = j._rand_another(idx)
                np.random.seed(idx)
                assert t._rand_another(idx) == a
        assert [t.get_cat_ids(i) for i in range(len(t))] == [j.get_cat_ids(i) for i in range(len(j))]
        assert set(t[0]) == set(j[0])
    t, j = CustomDataset(ann, pipeline=None), JCustom(ann, pipeline=None)
    assert repr(t) == repr(j)
    rs = np.random.RandomState(0)
    results = []
    for i in range(len(t)):
        a = t.get_ann_info(i)
        per_class = []
        for c in range(2):
            g = a["bboxes"][a["labels"] == c]
            b = np.concatenate([g + rs.randn(*g.shape) * 3, rs.rand(2, 4) * 50 + [0, 0, 60, 60]])
            per_class.append(np.concatenate([b, rs.rand(len(b), 1)], 1).astype(np.float32))
        results.append(per_class)
    for kw in (dict(metric="mAP"), dict(metric=["mAP"], iou_thr=[0.5, 0.75]),
               dict(metric="recall", proposal_nums=(1, 3, 10), iou_thr=[0.5, 0.7])):
        res = results if kw["metric"] != "recall" else [np.vstack(r) for r in results]
        assert t.evaluate(res, **kw) == j.evaluate(res, **kw)
    tres = [[torch.from_numpy(c) for c in r] for r in results]
    assert t.evaluate(tres, metric="mAP") == j.evaluate(results, metric="mAP")
    with pytest.raises(KeyError):
        t.evaluate(results, metric="nonsense")


def test_fileio_round_trips(tmp_path):
    obj = {"a": 1, "b": [1, 2, 3], "c": {"d": "e"}}
    for fmt in ("json", "pkl", "pickle", "yaml", "yml"):
        p = str(tmp_path / f"x.{fmt}")
        fileio.dump(obj, p)
        assert fileio.load(p) == obj == jfileio.load(p)
    arr = np.arange(6.0).reshape(2, 3)
    np.save(tmp_path / "x.npy", arr)
    np.testing.assert_array_equal(fileio.load(str(tmp_path / "x.npy")), arr)
    fileio.dump([1], str(tmp_path / "noext"), file_format="json")
    assert fileio.load(str(tmp_path / "noext"), file_format="json") == [1]
    with pytest.raises(ValueError, match="unsupported"):
        fileio.dump(obj, str(tmp_path / "x.txt"))
    assert isinstance(fileio.get_backend("/tmp/x"), fileio.LocalBackend)
    assert isinstance(fileio.get_backend("http://example.invalid/x"), fileio.HTTPBackend)
    assert fileio.LocalBackend().exists(str(tmp_path / "x.json"))
    for prefix, cls in (("lmdb://db", "LmdbBackend"), ("s3://bucket/x", "PetrelBackend")):
        try:
            fileio.get_backend(prefix)
        except ImportError as e:
            assert cls.replace("Backend", "").lower() in str(e).lower() or "requires" in str(e)
        except TypeError:
            pass        # the lmdb backend needs a db_path, in JAX as here


def test_structures_match_jax():
    for mod in (jstruct, structures):
        e = mod.BaseDataElement(metainfo=dict(img_shape=(32, 32)), boxes=np.zeros((2, 4)))
        assert e.metainfo_keys() == ["img_shape"] and e.keys() == ["boxes"]
        with pytest.raises(AttributeError):
            e.img_shape = (8, 8)
        e.set_metainfo(dict(img_shape=(8, 8)))
        assert e.img_shape == (8, 8) and "boxes" in e and "missing" not in e
        assert e.pop("boxes").shape == (2, 4) and "boxes" not in e
        c = mod.BaseDataElement(metainfo=dict(scale=2.0), x=np.arange(3.0))
        d = c.clone()
        d.x[0] = 99.0
        assert c.x[0] == 0.0 and set(c.to_dict()) == {"scale", "x"}
        inst = mod.InstanceData(bboxes=np.zeros((3, 4)), labels=np.array([0, 1, 2]))
        with pytest.raises(ValueError):
            inst.scores = np.zeros(2)
        assert inst[np.array([True, False, True])].labels.tolist() == [0, 2]
        assert len(inst[1:2]) == 1 and len(mod.InstanceData.cat([inst, inst])) == 6
        pd = mod.PixelData(seg=np.zeros((1, 8, 8)))
        with pytest.raises(ValueError):
            pd.depth = np.zeros((4, 4))
    # tensor leaves: indexing by tensors and masks, cat, device round trips
    inst = structures.InstanceData(metainfo=dict(id=3), bboxes=torch.arange(12.0).view(3, 4),
                                   labels=np.array([0, 1, 2]))
    sub = inst[torch.tensor([True, False, True])]
    assert sub.bboxes.tolist() == [[0, 1, 2, 3], [8, 9, 10, 11]] and sub.labels.tolist() == [0, 2]
    assert inst[torch.tensor([2, 0])].labels.tolist() == [2, 0]
    assert inst[np.array([1])].bboxes.shape == (1, 4)
    cat = structures.InstanceData.cat([inst, inst])
    assert isinstance(cat.bboxes, torch.Tensor) and cat.bboxes.shape == (6, 4) and cat.id == 3
    on = inst.to("cpu")
    assert isinstance(on.labels, torch.Tensor) and on.id == 3
    back = on.numpy()
    assert isinstance(back.bboxes, np.ndarray) and back.labels.tolist() == [0, 1, 2]
    assert torch.equal(inst.cpu().bboxes, inst.bboxes) and inst.clone().bboxes is not inst.bboxes


def _bitmap_ops(mod, m):
    bm = mod.BitmapMasks(m, *m.shape[1:])
    outs = [bm.masks, bm.areas, bm.get_bboxes(), bm.resize((37, 23)).masks,
            bm.rescale(1.7).masks, bm.rescale((50, 20)).masks]
    outs += [bm.flip(d).masks for d in ("horizontal", "vertical", "diagonal")]
    outs += [bm.pad((40, 40), 3).masks, bm.crop(np.array([3, 2, 20, 15])).masks,
             bm.crop_and_resize(np.array([[2, 3, 20, 18], [0, 0, 5, 5]], np.float32), (9, 7),
                                np.array([0, 1])).masks,
             bm.expand(40, 50, 3, 4).masks, bm[np.array([0, 2])].masks, bm[1].masks]
    for direction in ("horizontal", "vertical"):
        outs += [bm.translate(m.shape[1:], 3.5, direction, fill_val=2).masks,
                 bm.shear(m.shape[1:], 0.3, direction, border_value=1).masks]
    outs += [bm.rotate(m.shape[1:], 33.0).masks,
             bm.rotate((30, 26), -17.0, center=(5.0, 7.0), scale=1.3).masks]
    return outs


def _polygon_ops(mod, polys):
    pm = mod.PolygonMasks(polys, 28, 31)
    outs = [pm.to_ndarray(), pm.areas, pm.get_bboxes(), pm.to_bitmap().masks,
            pm.resize((40, 22)).to_ndarray(), pm.rescale(1.5).to_ndarray(),
            pm.rescale((60, 30)).to_ndarray(), pm.crop(np.array([4, 3, 25, 20])).to_ndarray(),
            pm.pad((40, 40)).to_ndarray(), pm[[0, 2]].to_ndarray(), pm[1].to_ndarray()]
    outs += [pm.flip(d).to_ndarray() for d in ("horizontal", "vertical", "diagonal")]
    return outs


def test_masks_bit_equal_to_jax():
    rs = np.random.RandomState(0)
    m = (rs.rand(3, 28, 31) > 0.6).astype(np.uint8)
    for a, b in zip(_bitmap_ops(jmask, m), _bitmap_ops(mask_structures, m)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    polys = mask_structures.PolygonMasks.random(3, 28, 31, n_verts=7, rng=rs).masks
    polys[1].append(np.array([2, 2, 9, 2, 9, 8, 2, 8], np.float32))      # two parts
    for a, b in zip(_polygon_ops(jmask, polys), _polygon_ops(mask_structures, polys)):
        np.testing.assert_array_equal(a, b)
    for mod in (jmask, mask_structures):
        assert len(mod.BitmapMasks.random(2, 16, 16)) == 2
        assert mod.BitmapMasks([], 4, 5).resize((8, 9)).masks.shape == (0, 8, 9)
        with pytest.raises(NotImplementedError):
            mod.PolygonMasks(polys, 28, 31).expand()
    square = [[np.array([2, 2, 6, 2, 6, 6, 2, 6], np.float32)]]
    pm = mask_structures.PolygonMasks(square, 8, 8)
    assert pm.areas[0] == pytest.approx(16.0) and abs(int(pm.to_ndarray().sum()) - 16) <= 4


_BLOCKED = r"""
import os, sys, tempfile
sys.modules["cv2"] = None
sys.modules["PIL"] = None
import numpy as np
from deep3dmap_tpu_torch.datasets.builder import build_dataset, PIPELINES
from deep3dmap_tpu_torch.datasets.synthetic import write_detection_fixture
from deep3dmap_tpu_torch.utils.config import Config
cfg = Config.fromfile(sys.argv[1])
ann = write_detection_fixture(tempfile.mkdtemp(), n_images=2, img_wh=(96, 64))
for part in ("train", "test"):
    d = dict(cfg.data[part]); d["ann_file"] = ann
    ds = build_dataset(d)
    for i in range(len(ds)):
        np.random.seed(i)
        out = ds[i]
        imgs = out["img"] if isinstance(out["img"], list) else [out["img"]]
        assert all(np.isfinite(im).all() and im.shape[1] == 1344 for im in imgs), part
resize = PIPELINES.build(dict(type="SeqResizeImage", size=(64, 48), depth_key="depths"))
frames = [np.random.RandomState(0).randint(0, 255, (60, 80, 3)).astype(np.uint8)]
out = resize({"imgs": frames, "intrinsics": [np.eye(3, dtype=np.float32)],
              "depths": [np.ones((60, 80), np.float32)]})
assert out["imgs"][0].shape == (48, 64, 3) and out["depths"][0].shape == (48, 64)
assert sys.modules["cv2"] is None and sys.modules["PIL"] is None
print("ok")
"""


def test_pipelines_run_with_cv2_and_pil_blocked():
    r = subprocess.run([sys.executable, "-c", _BLOCKED, CONFIG], cwd=ROOT, capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-3000:]
