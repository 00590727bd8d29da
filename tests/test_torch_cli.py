"""The port's command-line tools end to end on the CPU, as a user runs them:
``python -m deep3dmap_tpu_torch.tools.data_gen_scannet``, ``...tools.train``
and ``...tools.test --eval depth_mesh`` with ``--device cpu`` on the
fixture scene and ``tools/quality_regression.py``'s config.  The test CLI's
last ``{``-line is the metrics dict that ``quality_regression.py:111``
parses, with the JAX package's keys (those of ``QUALITY_r05.json``).
Without ``--device`` the CLIs train and test on the card, so on a machine
without one they raise.
"""
import ast
import importlib.util
import json
import os
import os.path as osp
import subprocess
import sys

import pytest
import torch

from deep3dmap_tpu_torch.datasets.synthetic import write_scannet_fixture
from deep3dmap_tpu_torch.tools import data_gen_scannet, test as test_cli, train as train_cli

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _config(datapath, work_dir):
    """tools/quality_regression.py's CONFIG_TMPL (fusion on, 1 epoch)."""
    spec = importlib.util.spec_from_file_location(
        "quality_regression", osp.join(ROOT, "tools", "quality_regression.py"))
    qr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qr)
    return qr.CONFIG_TMPL.format(work_dir=work_dir, datapath=datapath, fusion=True,
                                 epochs=1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    data = str(root / "data")
    write_scannet_fixture(data, splits=("train", "test"), n_frames=10, device="cpu")
    for mode in ("train", "test"):
        data_gen_scannet.main(["--datapath", data, "--mode", mode, "--n-views", "5",
                               "--min-angle", "1", "--min-distance", "0.01",
                               "--n-proc", "1"])
    cfg = root / "cfg.py"
    cfg.write_text(_config(data, str(root / "work")))
    return str(cfg), str(root / "work"), str(root)


def _run(*args):
    r = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                       cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r


def test_train_then_test_prints_jax_metric_keys(setup):
    cfg, work, root = setup
    _run("deep3dmap_tpu_torch.tools.train", cfg, "--device", "cpu")
    ckpts = sorted(os.listdir(osp.join(work, "checkpoints")))
    assert ckpts == ["ckpt_2", "latest"]
    (log,) = [f for f in os.listdir(work) if f.endswith(".log.json")]
    with open(osp.join(work, log)) as f:
        lines = [json.loads(line) for line in f]
    # one line, the epoch's flush (interval 20); as in JAX it reads iter + 1
    # after the loop's last increment
    assert [(r["epoch"], r["iter"]) for r in lines] == [(1, 3)]

    r = _run("deep3dmap_tpu_torch.tools.test", cfg, "--checkpoint", "auto", "--out",
             osp.join(root, "meshes"), "--eval", "depth_mesh", "--device", "cpu")
    last = [line for line in r.stdout.strip().splitlines() if line.startswith("{")][-1]
    metrics = ast.literal_eval(last.replace("nan", "None"))
    with open(osp.join(ROOT, "QUALITY_r05.json")) as f:
        jax_keys = set(json.load(f)["trained_fusion"])
    assert set(metrics) == jax_keys
    assert osp.exists(osp.join(root, "meshes", "scene0707_00.ply"))
    assert 0.0 <= metrics["fscore"] <= 1.0

    # resuming from the latest checkpoint continues the epochs
    _run("deep3dmap_tpu_torch.tools.train", cfg, "--device", "cpu", "--resume-from",
         "auto", "--max-epochs", "2")
    assert "ckpt_4" in os.listdir(osp.join(work, "checkpoints"))


@pytest.mark.parametrize("cli", [train_cli, test_cli], ids=["train", "test"])
def test_cli_raises_without_a_gpu_unless_cpu_is_asked(setup, cli):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default does not raise here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([setup[0]])


@pytest.mark.parametrize("cli", [train_cli, test_cli], ids=["train", "test"])
def test_cfg_options_without_equals_is_an_error(setup, cli):
    with pytest.raises(ValueError, match="KEY=VALUE"):
        cli.parse_args([setup[0], "--cfg-options", "bad_format"])
