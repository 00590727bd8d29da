"""The benchmark's cells are found by name from BENCHMARK.json, and the file
keeps to the contract's shape."""
import json
import os
import re

import pytest

from benchmark.harness import cells

ROOT = cells.ROOT
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

E2E = {"train_keyframes_per_s": "keyframes/s", "peak_mem_gib": "GiB", "setup_s": "s"}
PER_LAYER = {"launches_per_step.train": "launches/step", "loss_roofline.train": "%",
             "mfu.train": "%", "device_idle_pct.train": "%"}


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    n = 24
    assert (2 + 14 * n) * (SPEC["run_seconds"] + 60) + n * 2 * 90 + 1200 <= 43200


def test_metric_names_and_units():
    assert {m["name"]: m["unit"] for m in SPEC["end_to_end"]} == E2E
    assert {m["name"]: m["unit"] for m in SPEC["per_layer"]} == PER_LAYER
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in E2E
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("work", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(work):
    cell = cells.load_cell(work["name"])
    assert work["name"] == f"{work['config']}.{work['traffic']}"
    assert cell.chips == 1 and len(work["why"]) <= 200
    assert cell.traffic["driver"] in ("train", "stream")
    assert {m.name for m in cell.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert len(cell.end_to_end) >= 3 and cell.per_layer
    for m in cell.per_layer:
        assert callable(m.reader) and m.reader({}) is None      # nothing to read
        entry = next(p for p in SPEC["per_layer"] if p["name"] == m.name)
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == entry["moves"])
        assert work["name"] in moved.get("workloads", [work["name"]])
    assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())


def test_unlisted_cell_runs_from_its_files():
    """``nr_scannet.stream`` is not listed (PERF.md §7): it loads from its
    config, traffic and limits files, on one chip, with the metrics that
    every cell reports."""
    assert "nr_scannet.stream" not in {w["name"] for w in SPEC["workloads"]}
    cell = cells.load_cell("nr_scannet.stream")
    assert cell.traffic["driver"] == "stream" and cell.chips == 1
    assert {m.name for m in cell.end_to_end} == {"peak_mem_gib", "setup_s"}
    assert not cell.per_layer and cell.limits


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    assert conf["file"].startswith("benchmark/configs/")
    data = json.load(open(os.path.join(ROOT, conf["file"])))
    assert data["name"] == conf["name"] and data["reduced"] == conf["reduced"]
    assert set(data["precision"]) == {"trunk", "dense", "block", "gather", "hidden"}
    assert data["mfu_peak"] in ("bf16", "tf32", "fp32")
    assert any(w["config"] == conf["name"] for w in SPEC["workloads"])
