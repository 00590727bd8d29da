"""Cells by name, from ``BENCHMARK.json`` and the data files beside it.

A cell ``<config>.<traffic>`` reads ``configs/<config>.json`` (the model
configuration as it is run), ``traffic/<traffic>.json`` (the mix: which
driver, sizes, pool, window rules), ``limits/<cell>.json`` (the limits of
``correct``) and, for each per-layer metric that lists the cell (or lists no
cells), ``metrics/<metric>.py``, whose ``read(ctx)`` returns a number or None.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Metric:
    name: str
    unit: str
    reader: Callable = None


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


def _reader(name: str) -> Callable:
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, spec_path: str = None) -> Cell:
    spec = _load_json(spec_path or os.path.join(ROOT, "BENCHMARK.json"))
    work = {w["name"]: w for w in spec["workloads"]}
    # a cell not listed (yet) runs from its files alone, on one chip, with
    # the metrics every cell reports: how it is calibrated before it is added
    cfg_name, traffic_name = name.split(".", 1)
    w = work.get(name, {"config": cfg_name, "traffic": traffic_name, "chips": 1})
    cfgs = {c["name"]: c["file"] for c in spec["configs"]}
    config = _load_json(os.path.join(ROOT, cfgs.get(
        w["config"], os.path.join("benchmark", "configs", f"{w['config']}.json"))))
    traffic = _load_json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    limits = _load_json(os.path.join(BENCH_DIR, "limits", f"{name}.json"))
    e2e = [Metric(m["name"], m["unit"]) for m in spec["end_to_end"] if _applies(m, name)]
    per = [Metric(m["name"], m["unit"], _reader(m["name"]))
           for m in spec["per_layer"] if _applies(m, name)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, per)
