"""Everything a cell needs, found by the names in BENCHMARK.json: the
cell's configuration file, its traffic file, its limits, its metrics and
the readers of its per-layer metrics. Adding a cell, a configuration, a
traffic mix or a metric adds files and entries; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import os

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def metric_applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_reader(name: str):
    """The `read(rec)` function of metrics/<name>.py."""
    path = os.path.join(PKG, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell(workload: str, root: str = ROOT) -> dict:
    """The cell's entry, configuration, traffic, limits and metrics."""
    b = benchmark(root)
    cells = {w["name"]: w for w in b["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in b["configs"]}
    cfg = _json(os.path.join(root, configs[w["config"]]["file"]))
    return {
        "workload": w,
        "config": cfg,
        "traffic": _json(os.path.join(PKG, "traffic",
                                      f"{w['traffic']}.json")),
        "limits": _json(os.path.join(PKG, "limits", f"{workload}.json")),
        "end_to_end": [m for m in b["end_to_end"]
                       if metric_applies(m, workload)],
        "per_layer": [m for m in b["per_layer"]
                      if metric_applies(m, workload)],
    }
