"""The port's supervisor path and the MNASNet graft, on the CPU.

- the port's ``tools/train.py`` writes heartbeats under
  ``D3M_HEARTBEAT_FILE`` (JAX's CLI does at ``tools/train.py:100-105``);
- the port's ``tools/run_elastic.py`` restarts a crashed toy run to its end
  (the ``tests/test_elastic.py`` case), with no JAX in the child;
- ``import_weights.py mnasnet`` and ``import_mnasnet_trunk`` against JAX's
  importer on a seeded torchvision-layout trunk: the ``.npz`` key for key
  (the trunk's values equal, the FPN head's shapes equal: that head has no
  torch source and comes from each side's own seeded init), the bad-shape
  error, and the graft into ``NeuralRecon`` leaf by leaf with JAX's error.
"""
import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep3dmap_tpu_torch.models.frameworks.neuralrecon import NeuralRecon
from deep3dmap_tpu_torch.tools import import_weights, train
from deep3dmap_tpu_torch.utils.from_flax import to_flax_params
from deep3dmap_tpu_torch.utils.torch_import import import_mnasnet_trunk

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))

TOY_CFG = '''
import os

import numpy as np
import torch

from deep3dmap_tpu_torch.datasets.builder import DATASETS
from deep3dmap_tpu_torch.models.builder import RECONSTRUCTORS
from deep3dmap_tpu_torch.runners.hooks import HOOKS, Hook

MARKER = {marker!r}


@HOOKS.register_module(force=True)
class CrashOnceHook(Hook):
    def after_train_iter(self, runner):
        if MARKER and runner.iter >= 8 and not os.path.exists(MARKER):
            open(MARKER, "w").write("x")
            raise RuntimeError("injected crash (elastic test)")


@RECONSTRUCTORS.register_module(force=True)
class ElasticToy:
    def __init__(self, model_cfgs=None, train_cfg=None, test_cfg=None, device=None):
        self.device = torch.device(device or "cuda")

    def init(self, seed, batch):
        torch.manual_seed(seed)
        return torch.nn.Linear(4, 1).to(self.device), {{}}

    def loss_fn(self, net, model_state, batch):
        x = torch.as_tensor(batch["x"], device=self.device)
        y = torch.as_tensor(batch["y"], device=self.device)
        loss = ((net(x) - y) ** 2).mean()
        return loss, {{"log_vars": {{"mse": loss.detach()}}, "model_state": model_state}}


@DATASETS.register_module(force=True)
class ElasticToyData:
    def __init__(self, n=6, device=None):
        rs = np.random.RandomState(0)
        self.items = [dict(x=rs.randn(4, 4).astype(np.float32),
                           y=rs.randn(4, 1).astype(np.float32)) for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


data = dict(samples_per_gpu=1, train=dict(type="ElasticToyData"))
model = dict(type="ElasticToy", model_cfgs=dict())
checkpoint_config = dict(interval=1)
log_config = dict(interval=1)
custom_hooks = [dict(type="CrashOnceHook")]
workflow = [("train", 1)]
runner = dict(type="EpochBasedRunner",
              runner_cfgs=dict(optimizer=dict(type="Adam", lr=1e-2), max_epochs=2))
'''


def test_train_cli_writes_heartbeats(tmp_path, monkeypatch):
    cfg = tmp_path / "toy.py"
    cfg.write_text(TOY_CFG.format(marker=""))
    hb = tmp_path / "hb.json"
    monkeypatch.setenv("D3M_HEARTBEAT_FILE", str(hb))
    monkeypatch.setenv("D3M_HEARTBEAT_INTERVAL", "4")
    runner = train.main([str(cfg), "--work-dir", str(tmp_path / "work"), "--device", "cpu"])
    beat = json.loads(hb.read_text())
    assert beat["epoch"] == runner.epoch == 2 and beat["iter"] == runner.iter == 12
    assert [type(h).__name__ for h in runner.hooks].count("HeartbeatHook") == 1
    assert not (tmp_path / "hb.json.tmp").exists()


def test_run_elastic_restarts_after_crash(tmp_path):
    marker = tmp_path / "crashed_once"
    cfg = tmp_path / "crash_cfg.py"
    cfg.write_text(TOY_CFG.format(marker=str(marker)))
    hb = tmp_path / "hb.json"
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-m", "deep3dmap_tpu_torch.tools.run_elastic",
         "--max-restarts", "2", "--stall-timeout", "60", "--poll", "0.2",
         "--backoff", "0.1", "--heartbeat-file", str(hb), "--",
         str(cfg), "--work-dir", str(tmp_path / "work"), "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=120, cwd=str(tmp_path))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert marker.exists()
    assert "restart 1/2" in r.stdout and "restart 2/2" not in r.stdout
    assert "-m deep3dmap_tpu_torch.tools.train" in r.stdout
    log = (tmp_path / "work" / "train.log").read_text()
    assert "Resumed from" in log and "Training finished" in log
    assert json.loads(hb.read_text())["epoch"] == 2
    # the crash came at iteration 9 of 12: the child resumed from ckpt_6
    assert "ckpt_6 (epoch 1, iter 6)" in log


def test_run_elastic_gives_up_after_the_budget(tmp_path):
    cfg = tmp_path / "bad.py"
    cfg.write_text("model = dict(type='Missing')\n")
    r = subprocess.run(
        [sys.executable, "-m", "deep3dmap_tpu_torch.tools.run_elastic",
         "--max-restarts", "1", "--poll", "0.2", "--backoff", "0.1", "--",
         str(cfg), "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 1 and "restart budget (1) exhausted" in r.stdout


def _torch_mnasnet_trunk(seed, alpha_channels=(32, 16, 24, 40, 80)):
    """A torchvision-MNASNet-shaped trunk (layers 0-10, alpha 1) with
    seeded weights and BatchNorm statistics: the state dict of
    ``tests/test_torch_import.py``'s trunk."""
    tnn = torch.nn
    rs = np.random.default_rng(seed)

    class _IR(tnn.Module):
        def __init__(self, cin, cout, k, s, exp):
            super().__init__()
            mid = cin * exp
            self.layers = tnn.Sequential(
                tnn.Conv2d(cin, mid, 1, bias=False), tnn.BatchNorm2d(mid), tnn.ReLU(),
                tnn.Conv2d(mid, mid, k, padding=k // 2, stride=s, groups=mid, bias=False),
                tnn.BatchNorm2d(mid), tnn.ReLU(),
                tnn.Conv2d(mid, cout, 1, bias=False), tnn.BatchNorm2d(cout))

    def _stack(cin, cout, k, s, exp):
        return tnn.Sequential(_IR(cin, cout, k, s, exp), _IR(cout, cout, k, 1, exp),
                              _IR(cout, cout, k, 1, exp))

    c = alpha_channels
    trunk = tnn.Module()
    trunk.layers = tnn.Sequential(
        tnn.Conv2d(3, c[0], 3, stride=2, padding=1, bias=False), tnn.BatchNorm2d(c[0]),
        tnn.ReLU(), tnn.Conv2d(c[0], c[0], 3, padding=1, groups=c[0], bias=False),
        tnn.BatchNorm2d(c[0]), tnn.ReLU(), tnn.Conv2d(c[0], c[1], 1, bias=False),
        tnn.BatchNorm2d(c[1]), _stack(c[1], c[2], 3, 2, 3), _stack(c[2], c[3], 5, 2, 3),
        _stack(c[3], c[4], 5, 2, 6))
    with torch.no_grad():
        for p in trunk.parameters():
            p.copy_(torch.from_numpy(rs.normal(size=tuple(p.shape)).astype(np.float32) * 0.1))
        for m in trunk.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.running_mean.copy_(torch.from_numpy(
                    rs.normal(size=tuple(m.running_mean.shape)).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(
                    rs.uniform(0.5, 2.0, size=tuple(m.running_var.shape)).astype(np.float32)))
    return trunk.state_dict()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def trunk_npz(tmp_path_factory):
    """The port's CLI output and JAX's importer output on one seeded
    trunk."""
    from deep3dmap_tpu.models.backbones.fpn2d import MnasFPN as JaxMnasFPN
    from deep3dmap_tpu.utils.torch_import import import_mnasnet_trunk as jax_import

    d = tmp_path_factory.mktemp("mnas")
    sd = _torch_mnasnet_trunk(7)
    torch.save(sd, d / "mnasnet.pth")
    dst = str(d / "mnasnet.npz")
    import_weights.main(["mnasnet", str(d / "mnasnet.pth"), dst, "--device", "cpu"])
    mnas = JaxMnasFPN(alpha=1.0, norm="none", torch_pad=True)
    template = jax.jit(mnas.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    want = jax.tree_util.tree_map(
        np.asarray, jax_import({k: v.numpy() for k, v in sd.items()}, template))
    return dst, sd, dict(want)


def test_import_weights_mnasnet_matches_jax(trunk_npz):
    dst, _, want = trunk_npz
    with np.load(dst, allow_pickle=True) as data:
        assert list(data.keys()) == ["params"]
        got = data["params"].item()
    w, g = _flat(want), _flat(got)
    assert sorted(g) == sorted(w)
    trunk = [k for k in w if not k.startswith("params/Conv_") or
             k.split("/")[1] in ("Conv_0", "Conv_1", "Conv_2")]
    head = sorted(set(w) - set(trunk))
    assert len(head) == 7 and all(k.split("/")[1] in ("Conv_3", "Conv_4", "Conv_5",
                                                       "Conv_6", "Conv_7") for k in head)
    for k in trunk:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    for k in head:
        assert g[k].shape == w[k].shape and g[k].dtype == np.float32, k


def test_import_mnasnet_rejects_bad_shape(trunk_npz):
    from deep3dmap_tpu.models.backbones.fpn2d import MnasFPN as JaxMnasFPN
    from deep3dmap_tpu.utils.torch_import import import_mnasnet_trunk as jax_import

    _, sd, _ = trunk_npz
    bad = dict(sd)
    bad["layers.0.weight"] = bad["layers.0.weight"][:, :, :1, :1]
    with pytest.raises(ValueError, match="torch shape"):
        import_mnasnet_trunk(bad)
    mnas = JaxMnasFPN(alpha=1.0, norm="none", torch_pad=True)
    template = jax.jit(mnas.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    with pytest.raises(ValueError, match="torch shape"):
        jax_import({k: v.numpy() for k, v in bad.items()}, template)


def test_graft_into_neuralrecon_leaf_by_leaf(trunk_npz):
    from torch_slice_helpers import train_fragments

    dst, _, want = trunk_npz
    frag = train_fragments(16, 1)[0]
    cfg = dict(N_LAYER=3, N_VOX=[16, 16, 16], VOXEL_SIZE=0.08,
               BACKBONE2D=dict(ARC="fpn-mnas-1", NORM="none", TORCH_PAD=True, CKPT=dst))
    net, _ = NeuralRecon(cfg, device="cpu").init(0, frag)
    got = _flat(to_flax_params(net.backbone2d.fpn))
    w = _flat(want["params"])
    with np.load(dst, allow_pickle=True) as data:
        npz = _flat(data["params"].item()["params"])
    assert sorted(got) == sorted(w) == sorted(npz)
    for k in got:
        np.testing.assert_array_equal(got[k], npz[k], err_msg=k)
    # `pretrained` names the file too; a model of other widths refuses it
    # with JAX's message
    bb2d = {k: v for k, v in cfg["BACKBONE2D"].items() if k != "CKPT"}
    net2, _ = NeuralRecon(dict(cfg, BACKBONE2D=bb2d), pretrained=dst,
                          device="cpu").init(0, frag)
    for a, b in zip(net.backbone2d.fpn.parameters(), net2.backbone2d.fpn.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="was the npz produced with the same "
                                         "ARC/NORM/TORCH_PAD settings"):
        NeuralRecon(dict(cfg, BACKBONE2D=dict(cfg["BACKBONE2D"], ARC="fpn-mnas-0.5")),
                    device="cpu").init(0, frag)
