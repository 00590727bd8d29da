"""The port's streaming demo, mesh preview and quality-regression twin
(``demos/demo_neucon.py``, ``core/visualize/mesh_viewer.py``,
``tools/quality_regression.py``) on the CPU:

- the demo on 2 tiny synthetic fragments writes the scene mesh and one
  preview PNG per fragment, and reports keyframes/s;
- ``save_mesh_preview``'s pixels equal those of the JAX package's PNG
  (matplotlib's ``imsave``) for the same mesh;
- the twin's config text equals the JAX tool's template for the same
  arguments, its artifact has the JAX artifact's keys, and its pass rule
  agrees with JAX's on canned metrics (and reads an untrained NaN AbsRel
  as worse than any finite one);
- the ``Visualizer``'s local backend writes JAX's PNG and scalars;
- the learning run itself (40 epochs, both arms) is slow, as JAX's
  ``tests/test_quality_regression.py`` is.
"""
import json
import math
import os
import os.path as osp
import sys

import numpy as np
import pytest

from deep3dmap_tpu_torch.core.utils.marching_cubes import marching_tetrahedra
from deep3dmap_tpu_torch.core.visualize.mesh_viewer import save_mesh_preview
from deep3dmap_tpu_torch.demos import demo_neucon
from deep3dmap_tpu_torch.tools import quality_regression as twin
from deep3dmap_tpu_torch.utils.image_io import imread

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def test_demo_streams_tiny_fragments(tmp_path):
    out = demo_neucon.main(["--n-fragments", "2", "--n-views", "2", "--n-vox", "16",
                            "--img", "32", "--out", str(tmp_path), "--device", "cpu"])
    assert out["keyframes"] == 4 and out["keyframes_per_s"] > 0
    assert len(out["meshes"]) == 1 and os.path.getsize(out["meshes"][0]) > 0
    assert len(out["previews"]) == 2
    for p in out["previews"]:
        img = imread(p)
        assert img.shape == (512, 512, 4) and img.dtype == np.uint8 and img[..., :3].std() > 0


def _sphere_mesh():
    g = np.linspace(-1, 1, 20, dtype=np.float32)
    vol = np.sqrt((g[:, None, None] ** 2 + g[None, :, None] ** 2
                   + (1.3 * g[None, None, :]) ** 2)) - 0.7
    verts, faces = marching_tetrahedra(vol, level=0.0)
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def test_mesh_preview_matches_jax_png(tmp_path):
    from deep3dmap_tpu.core.visualize.mesh_viewer import save_mesh_preview as jax_preview

    verts, faces = _sphere_mesh()
    assert len(faces) > 100
    jp = jax_preview(verts, faces, str(tmp_path / "jax.png"), size=96, elev_deg=20.0)
    tp = save_mesh_preview(verts, faces, str(tmp_path / "port.png"), size=96, elev_deg=20.0)
    j, t = imread(jp), imread(tp)
    assert t.shape == j.shape == (96, 96, 4)
    np.testing.assert_array_equal(t, j)
    blank = imread(save_mesh_preview(np.zeros((0, 3)), np.zeros((0, 3), np.int64),
                                     str(tmp_path / "empty.png"), size=32))
    assert blank.shape == (32, 32, 4) and (blank == 255).all()


def test_quality_config_is_the_jax_template():
    sys.path.insert(0, osp.join(REPO, "tools"))
    try:
        import quality_regression as jax_twin
    finally:
        sys.path.pop(0)
    for fusion, epochs in ((True, 120), (False, 7)):
        kw = dict(work_dir="/w/fusion", datapath="/d", fusion=fusion, epochs=epochs)
        assert twin.config_text(**kw) == jax_twin.CONFIG_TMPL.format(**kw)


METRICS = dict(fscore=0.4, prec=0.5, recal=0.3, AbsRel=0.2, complete=0.1)


@pytest.mark.parametrize("trained,untrained,ok", [
    (dict(fscore=0.5, AbsRel=0.1), dict(fscore=0.2, AbsRel=0.3), True),
    (dict(fscore=0.24, AbsRel=0.1), dict(fscore=0.2, AbsRel=0.3), False),
    (dict(fscore=0.5, AbsRel=0.4), dict(fscore=0.2, AbsRel=0.3), False),
    (dict(fscore=0.5, AbsRel=0.1), dict(fscore=0.0, AbsRel=math.nan), True),
    (dict(fscore=0.5, AbsRel=math.nan), dict(fscore=0.0, AbsRel=math.nan), False),
], ids=["learns", "fscore_short", "absrel_higher", "untrained_nan", "trained_nan"])
def test_pass_rule(trained, untrained, ok):
    tr, un = dict(METRICS, **trained), dict(METRICS, **untrained)
    assert twin.learns_reconstruction(tr, un) is ok
    if not math.isnan(un["AbsRel"]):     # JAX's rule (tools/quality_regression.py:171-172)
        assert (tr["fscore"] > un["fscore"] + 0.05 and tr["AbsRel"] < un["AbsRel"]) is ok
    res = twin.summarize(dict(trained_fusion=tr, untrained_fusion=un,
                              trained_nofusion=dict(METRICS, fscore=0.1),
                              untrained_nofusion=dict(METRICS)))
    assert res["learns_reconstruction"] is ok
    assert res["fusion_delta_fscore"] == round(tr["fscore"] - 0.1, 4)
    with open(osp.join(REPO, "QUALITY_r05.json")) as f:
        jax_keys = set(json.load(f))
    assert jax_keys - {"round", "epochs", "note"} == set(res)


@pytest.mark.slow
def test_quality_regression_learns(tmp_path):
    out = twin.main(["--out", str(tmp_path / "q.json"), "--epochs", "40",
                     "--workdir", str(tmp_path / "wd"), "--device", "cpu"])
    assert out["learns_reconstruction"]
    with open(tmp_path / "q.json") as f:
        assert json.load(f)["fusion_delta_fscore"] == out["fusion_delta_fscore"]


def test_visualizer_local_backend_matches_jax(tmp_path):
    from deep3dmap_tpu.core.visualize.visualizer import Visualizer as JaxVisualizer
    from deep3dmap_tpu_torch.core.visualize import Visualizer

    img = np.random.RandomState(0).randint(0, 255, (24, 32, 3)).astype(np.uint8)
    outs = []
    for cls, d in ((JaxVisualizer, tmp_path / "jax"), (Visualizer, tmp_path / "port")):
        vis = cls(vis_backends=[dict(type="LocalVisBackend")], save_dir=str(d))
        vis.set_image(img.copy())     # set_image keeps the array it is given
        vis.draw_bboxes(np.array([[2, 3, 20, 15]])).draw_points(np.array([[5, 5]]))
        vis.draw_binary_masks(np.zeros((24, 32), bool) | (np.arange(32) < 4)[None])
        vis.add_image("frame", step=3)
        vis.add_scalars({"loss": 0.5}, step=3)
        vis.close()
        outs.append((imread(str(d / "vis_image" / "frame_3.png")),
                     json.loads(open(d / "scalars.json").read())))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert {k: v for k, v in outs[1][1].items() if k != "time"} == {"loss": 0.5, "step": 3}
