"""On the card: each cell through ``run.py`` as the check runs it, short
windows.  Skips without a CUDA card (decided in the fixture)."""
import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import cells

SPEC = json.load(open(os.path.join(cells.ROOT, "BENCHMARK.json")))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cells run the port's CUDA kernels")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("work", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(card, work, trace):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", work,
                          "--seed", str(2 ** 31 + 5), "--seconds", "3", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=cells.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0 and res["device"]["kind"] == card
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert len(res["breakdown"]["device_ops"]) <= 10
    else:
        assert "setup_s" in res["metrics"]
