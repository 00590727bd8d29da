"""The reference against the port at a small size on the CPU, both
configurations.  This file may import the port; the reference may not."""
import pytest
import torch

from benchmark.harness import drivers, scene, weights
from benchmark.reference import neuralrecon as ref
from benchmark.tests.tiny import tiny_cell

nr = pytest.importorskip("deep3dmap_tpu_torch.models.frameworks.neuralrecon")


def _float32(cfg):
    m = dict(cfg["model_cfgs"])
    for k in ("GLOBAL_DTYPE", "BLOCK_DTYPE"):
        m.pop(k, None)
    m["BACKBONE2D"] = {k: v for k, v in m["BACKBONE2D"].items() if k != "DTYPE"}
    return m


@pytest.mark.parametrize("name", ["nr_block.train", "nr_scannet.train"])
def test_forward_loss_and_gradients_match_the_port(name):
    """Float32 on both sides (the port's bf16 gather table off): every
    level's outputs, masks and hidden windows, the loss and each leaf's
    gradient."""
    cell = tiny_cell(name)
    m = _float32(cell.config)
    fw = nr.NeuralRecon(m, device="cpu")
    fw.net.bp_gather_dtype = None
    net = ref.RefNet(m)
    w = weights.draw(net, 7, "cpu")
    weights.load(fw.net, w)
    weights.load(net, w)
    b = scene.train_pool(3, 1, 2, 3, (64, 80), 32, 0.12, 3, "cpu")[0]
    fw.net.train()
    out, _ = fw._apply(fw.net, fw.init_state(2), b)
    hid = [torch.zeros(2, c, d, d, d) for c, d in zip(net.cfg["channels"], net.cfg["dims"])]
    o = ref.forward(net, b["imgs"], b["proj_matrices"], b["vol_origin_partial"],
                    b["world_to_aligned_camera"], hid)
    for i in range(3):
        assert torch.equal(out["sparse_mask"][i].bool(), o["mask"][i])
        torch.testing.assert_close(out["tsdf"][i][..., 0], o["tsdf"][i], atol=2e-4, rtol=0)
        torch.testing.assert_close(out["occ"][i][..., 0], o["occ"][i], atol=2e-4, rtol=0)
        torch.testing.assert_close(out["new_hidden"][i].permute(0, 4, 1, 2, 3),
                                   o["hidden"][i], atol=2e-4, rtol=0)
    lp, _ = fw.loss_fn(fw.net, fw.init_state(2), b)
    lr = ref.loss(net, o, b["tsdf_list"], b["occ_list"])
    assert abs(lp.item() - lr.item()) <= 1e-5 * abs(lr.item())
    lp.backward()
    lr.backward()
    gr = dict(net.named_parameters())
    for n, p in fw.net.named_parameters():
        g = gr[n].grad
        # ReLU kinks: one input on the other side of 0 moves a leaf's gradient
        # (the port's own slice tests agree with JAX to ~1e-2 for this)
        assert (p.grad - g).norm() <= 5e-2 * g.norm() + 1e-6, n


def test_following_own_decisions_changes_nothing():
    cell = tiny_cell("nr_block.train")
    net = ref.RefNet(cell.config["model_cfgs"])
    weights.load(net, weights.draw(net, 9, "cpu"))
    b = scene.train_pool(4, 1, 2, 3, (64, 80), 32, 0.12, 3, "cpu")[0]
    hid = [torch.zeros(2, c, d, d, d) for c, d in zip(net.cfg["channels"], net.cfg["dims"])]
    args = (net, b["imgs"], b["proj_matrices"], b["vol_origin_partial"],
            b["world_to_aligned_camera"], hid)
    own = ref.forward(*args)
    followed = ref.forward(*args, follow=own["occupied"])
    for k in ("tsdf", "occ", "mask"):
        for a, c in zip(own[k], followed[k]):
            assert torch.equal(a, c)
    assert ref.mask_mismatch(net.cfg, own["occ"], own["mask"], 2) == 0


@pytest.mark.parametrize("name", ["nr_block.train", "nr_scannet.stream"])
def test_port_decisions_agree_with_the_rule(name):
    """The port's per-level masks are what its own outputs of the level
    before give (the rule ``mask_mismatch`` holds it to)."""
    cell = tiny_cell(name)
    prog = drivers.Program(cell, 5, "cpu")
    tr = cell.traffic
    if tr["driver"] == "train":
        pool = scene.train_pool(5, 3, 2, 3, (64, 80), 32, 0.12, 3, "cpu")
        _, first = drivers.program_first_steps(prog, prog.train_state(2), pool)
        decisions = first["decisions"]
    else:
        frags = scene.stream_path(5, 4, 3, (64, 80), 32, 0.12, 3, 7.68, 6, 1.2, "cpu")
        _, decisions, _ = drivers.program_pass(prog, frags)
    c = ref.resolve(cell.config["model_cfgs"])
    assert len(decisions) >= 3
    assert sum(ref.mask_mismatch(c, d["occ"], d["mask"], d["occ"][0].shape[0]) for d in decisions) == 0
