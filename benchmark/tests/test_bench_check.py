"""``correct`` against broken timed paths and against the control, at a
size a CPU run holds, with each cell's own limits.

The whole run is driven as on the card (``drivers.run_cell``), past the
harness's look for a card, with the timed path broken underneath: a step or
fragment that hands back its state unchanged, half the batch left out (the
loss's mean over the rest), an answer (the tsdf) altered where it is
produced.  Each must come out not correct; the unbroken run correct.
The control, the reference one type below what the configuration states in
the program's place, must fail at least one number."""
import time

import pytest

from benchmark.harness import check, drivers
from benchmark.reference import neuralrecon as ref
from benchmark.tests.tiny import tiny_cell

# the faults each cell can have: training cells produce updates, not
# answers; half a batch needs a batch of more than one; one chip, no exchange
RUNS = [("nr_block.train", None), ("nr_block.train", "frozen"),
        ("nr_block.train", "half_batch"),
        ("nr_scannet.train", None), ("nr_scannet.train", "frozen"),
        ("nr_scannet.stream", None), ("nr_scannet.stream", "frozen"),
        ("nr_scannet.stream", "altered")]


@pytest.mark.parametrize("name,fault", RUNS, ids=[f"{n}-{f}" for n, f in RUNS])
def test_broken_path_is_not_correct(name, fault):
    cell = tiny_cell(name)
    out = drivers.run_cell(cell, 2 ** 31 + 77, 0.5, False, "cpu", time.perf_counter(),
                           fault=fault)
    res = out["result"]
    assert res["correct"] is (fault is None), (fault, out["numbers"], cell.limits)
    assert list(res)[-1] == "checks"
    assert {k: v["limit"] for k, v in res["checks"].items()} == cell.limits


@pytest.mark.parametrize("name", ["nr_block.train", "nr_scannet.train", "nr_scannet.stream"])
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    seed, dev = 2 ** 31 + 91, "cpu"
    prec = ref.Precision.for_control(cell.config["precision"])
    tr = cell.traffic
    c = ref.resolve(cell.config["model_cfgs"])
    from benchmark.harness import scene
    if tr["driver"] == "train":
        b = scene.train_pool(seed, 3, cell.config["batch"], tr["views"], tuple(tr["image_hw"]),
                             c["n_vox"], c["voxel_size"], 3, dev)
        ctl = drivers.reference_train(cell, seed, b, None, dev, prec=prec)
        refd = drivers.reference_train(cell, seed, b, ctl["decisions"], dev)
        numbers = check.train_numbers(c, ctl, refd, cell.config["batch"])
    else:
        f = scene.stream_path(seed, 4, tr["views"], tuple(tr["image_hw"]), c["n_vox"],
                              c["voxel_size"], 3, tr["scene_m"], tr["spheres"],
                              tr["path_radius_m"], dev)
        ctl = drivers.reference_stream(cell, seed, f, None, dev, prec=prec)
        refd = drivers.reference_stream(cell, seed, f, ctl["decisions"], dev)
        numbers = check.stream_numbers(c, ctl["answers"], ctl["decisions"],
                                       [v.permute(0, 2, 3, 4, 1) for v in ctl["hidden"]], refd)
    assert numbers["mask_mismatch"] == 0
    assert not check.judge(numbers, cell.limits), (numbers, cell.limits)
