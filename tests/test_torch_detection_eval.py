"""The port's detection evaluation (``core/evaluation/{mean_ap,recall,
evaluator}.py``) and ``utils/{message_hub,meters}.py`` against the JAX
package's on the same seeded inputs: equal to float64 rounding (the same
numpy arithmetic: measured equal bit for bit).  Tensor inputs give the
numpy inputs' answers.  One 2-rank ``gloo`` run holds ``BaseMetric.evaluate``'s
gather (``all_gather_object``) to the metric over both ranks' results.
"""
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deep3dmap_tpu.core import evaluation as jev
from deep3dmap_tpu.core.evaluation import evaluator as jevaluator
from deep3dmap_tpu.utils import message_hub as jhub
from deep3dmap_tpu.utils import meters as jmeters
from deep3dmap_tpu_torch.core import evaluation as tev
from deep3dmap_tpu_torch.core.evaluation import evaluator as tevaluator
from deep3dmap_tpu_torch.utils import message_hub as thub
from deep3dmap_tpu_torch.utils import meters as tmeters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _boxes(rs, n, span=300.0):
    xy = rs.rand(n, 2) * span
    wh = rs.rand(n, 2) * 80 + 4
    return np.concatenate([xy, xy + wh], 1)


def _detections(seed=0, n_img=12, n_cls=6):
    """GT per image, and detections: jittered GT, duplicates and false
    positives with scores; some images with ignore regions."""
    rs = np.random.RandomState(seed)
    anns, dets, props = [], [], []
    for i in range(n_img):
        n = rs.randint(0, 9)
        gt = _boxes(rs, n).astype(np.float32)
        lab = rs.randint(0, n_cls, n)
        ann = dict(bboxes=gt, labels=lab)
        if i % 3 == 0:
            ann["bboxes_ignore"] = _boxes(rs, 2).astype(np.float32)
            ann["labels_ignore"] = rs.randint(0, n_cls, 2)
        anns.append(ann)
        per_cls, allp = [], []
        for c in range(n_cls):
            g = gt[lab == c]
            jit = g + rs.randn(*g.shape) * 6
            fp = _boxes(rs, rs.randint(0, 4))
            dup = g[: len(g) // 2] + rs.randn(len(g) // 2, 4) * 2
            b = np.concatenate([jit, fp, dup]).astype(np.float32)
            sc = rs.rand(len(b)).astype(np.float32)
            sc[:2] = sc[-2:] if len(sc) >= 4 else sc[:2]        # score ties
            d = np.concatenate([b, sc[:, None]], 1)
            per_cls.append(d)
            allp.append(d)
        dets.append(per_cls)
        props.append(np.concatenate(allp))
    return dets, anns, props


@pytest.mark.parametrize("mode", ["area", "11points"])
def test_average_precision(mode):
    rs = np.random.RandomState(1)
    rec = np.sort(rs.rand(3, 20), axis=1)
    prec = rs.rand(3, 20)
    np.testing.assert_array_equal(tev.average_precision(rec, prec, mode),
                                  jev.average_precision(rec, prec, mode))
    assert tev.average_precision(rec[0], prec[0], mode) == \
        jev.average_precision(rec[0], prec[0], mode)
    np.testing.assert_array_equal(
        tev.average_precision(torch.from_numpy(rec), torch.from_numpy(prec), mode),
        jev.average_precision(rec, prec, mode))


def test_tpfp_and_overlaps():
    dets, anns, _ = _detections(2)
    for d_img, ann in zip(dets, anns):
        ign = ann.get("bboxes_ignore")
        for d in d_img:
            for thr in (0.5, 0.75):
                for a, b in zip(tev.tpfp_default(d, ann["bboxes"], ign, thr),
                                jev.tpfp_default(d, ann["bboxes"], ign, thr)):
                    np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tev.bbox_overlaps_np(ann["bboxes"], d_img[0][:, :4]),
                                      jev.bbox_overlaps_np(ann["bboxes"], d_img[0][:, :4]))


@pytest.mark.parametrize("iou_thr", [0.5, 0.75])
def test_eval_map(iou_thr):
    dets, anns, _ = _detections(3)
    mj, rj = jev.eval_map(dets, anns, iou_thr=iou_thr)
    mt, rt = tev.eval_map(dets, anns, iou_thr=iou_thr)
    assert mt == mj and rt == rj and 0 < mt < 1
    # tensors, as the card's NMS gives them
    tdets = [[torch.from_numpy(d) for d in img] for img in dets]
    assert tev.eval_map(tdets, anns, iou_thr=iou_thr)[0] == mj
    m11, _ = tev.eval_map(dets, anns, iou_thr=iou_thr, mode="11points")
    assert m11 == jev.eval_map(dets, anns, iou_thr=iou_thr, mode="11points")[0]


def test_eval_recalls():
    _, anns, props = _detections(4)
    gts = [a["bboxes"] for a in anns]
    for nums, thrs in (((5, 20, 100), [0.5, 0.7, 0.9]), (10, 0.5), ([3, 30], None)):
        np.testing.assert_array_equal(tev.eval_recalls(gts, props, nums, thrs),
                                      jev.eval_recalls(gts, props, nums, thrs))
    tprops = [torch.from_numpy(p) for p in props]
    np.testing.assert_array_equal(tev.eval_recalls(gts, tprops, [10, 50], [0.5]),
                                  jev.eval_recalls(gts, props, [10, 50], [0.5]))
    assert tev.set_recall_param(100, 0.5)[0].tolist() == [100]


def test_summaries_go_through_the_logger(caplog):
    dets, anns, props = _detections(5)
    logger = logging.getLogger("test_torch_detection_eval")
    with caplog.at_level(logging.INFO, logger="test_torch_detection_eval"):
        m, _ = tev.eval_map(dets, anns, logger=logger)
        tev.eval_recalls([a["bboxes"] for a in anns], props, [10], [0.5], logger=logger)
    text = caplog.text
    assert "mAP" in text and f"{m:.3f}" in text and "0.50" in text


class _Sum(tevaluator.BaseMetric):
    default_prefix = "toy"

    def process(self, data_batch, predictions):
        self.results.append(float(np.sum(predictions["x"])))

    def compute_metrics(self, results):
        return {"total": float(np.sum(results)), "count": len(results)}


def test_evaluator_depth_metric_matches_jax():
    rs = np.random.RandomState(6)
    gt = rs.uniform(0.5, 9, (3, 2, 8, 8)).astype(np.float32)
    pred = gt * rs.uniform(0.8, 1.2, gt.shape).astype(np.float32)
    pred[0, 0, :2] = 0
    outs = []
    for mod in (jevaluator, tevaluator):
        ev = mod.Evaluator([dict(type="DepthMetric", max_depth=8.0)])
        for p, g in zip(pred, gt):
            ev.process({"gt_depth": g}, {"depth": p})
        outs.append(ev.evaluate())
    assert outs[0] == outs[1] and "depth/AbsRel" in outs[1]
    ev = tevaluator.Evaluator([_Sum(), _Sum(prefix="again")])
    ev.process({}, {"x": np.ones(3)})
    assert ev.evaluate() == {"toy/total": 3.0, "toy/count": 1, "again/total": 3.0,
                             "again/count": 1}
    with pytest.raises(ValueError, match="duplicate"):
        e = tevaluator.Evaluator([_Sum(), _Sum()])
        e.process({}, {"x": np.ones(1)})
        e.evaluate()


def test_message_hub_and_meters_match_jax():
    rs = np.random.RandomState(7)
    vals = rs.rand(30)
    hj, ht = jhub.HistoryBuffer(max_length=20), thub.HistoryBuffer(max_length=20)
    for i, v in enumerate(vals):
        hj.update(v, count=i % 3 + 1)
        ht.update(v, count=i % 3 + 1)
    for w in (None, 5):
        assert ht.mean(w) == hj.mean(w) and ht.max(w) == hj.max(w) and ht.min(w) == hj.min(w)
    assert ht.current() == hj.current()
    for a, b in zip(ht.data, hj.data):
        np.testing.assert_array_equal(a, b)
    hub = thub.MessageHub.get_instance("torch_eval_test")
    assert thub.MessageHub.get_instance("torch_eval_test") is hub
    assert thub.MessageHub.get_current_instance() is thub.MessageHub.get_instance("default")
    hub.update_scalars({"loss": 1.0, "acc": 0.5})
    hub.update_scalar("loss", 0.5)
    hub.update_info("epoch", 3)
    assert hub.get_scalar("loss").mean() == 0.75 and hub.get_info("epoch") == 3
    with pytest.raises(ValueError):
        thub.HistoryBuffer().current()
    sj, st = jmeters.StandardMetrics(), tmeters.StandardMetrics()
    for i, v in enumerate(vals):
        sj.update({"a": v, "b": 2 * v}, n=i % 4 + 1)
        st.update({"a": v, "b": 2 * v}, n=i % 4 + 1)
    assert st.averages() == sj.averages() and repr(st) == repr(sj)


_GATHER = r"""
import sys
import numpy as np
import torch.distributed as dist
from deep3dmap_tpu_torch.core.evaluation.evaluator import BaseMetric

class Sum(BaseMetric):
    def process(self, data_batch, predictions):
        self.results.append(float(predictions))
    def compute_metrics(self, results):
        return {"total": float(np.sum(results)), "n": len(results), "first": results[0]}

rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method=sys.argv[2], world_size=2, rank=rank)
m = Sum()
for v in ([1.0, 2.0] if rank == 0 else [10.0, 20.0, 30.0]):
    m.process({}, v)
print(m.evaluate(), flush=True)
dist.destroy_process_group()
"""


def test_base_metric_gathers_over_a_gloo_group():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"tcp://127.0.0.1:{port}"
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _GATHER, str(r), url], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(out.strip().splitlines()[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    want = str({"total": 63.0, "n": 5, "first": 1.0})
    assert outs == [want, want]
