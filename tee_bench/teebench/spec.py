"""Finding a cell's files by name: ``BENCHMARK.json`` at the checkout's
root, the cell's settings under ``cells/``, its configuration under
``configs/``, its traffic mix under ``traffic/``, and each metric's reader
under ``metrics/`` (``metrics/<name>.py``, else ``metrics/<stem>.py`` for a
name ``<stem>.<cell kind>``, so one reader serves every split of a
quantity). A later cell, mix or metric is a new file and a new entry."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parents[1]      # tee_bench/
ROOT = HERE.parent                               # the checkout


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(name: str) -> dict:
    c = _json(HERE / "cells" / f"{name}.json")
    c["name"] = name
    return c


def config(name: str) -> dict:
    c = _json(HERE / "configs" / f"{name}.json")
    c["name"] = name
    return c


def traffic(name: str) -> dict:
    t = _json(HERE / "traffic" / f"{name}.json")
    t["name"] = name
    return t


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(cfg: dict):
    """The plain reference module a configuration names."""
    name = cfg["reference"]
    return load_module(HERE / "configs" / f"{name}.py",
                       f"teebench_reference_{name}")


def reader(metric: str) -> Callable:
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    return load_module(path, "teebench_metric_" + path.stem).read


def metrics_for(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The entries a run of ``workload`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or workload in m["workloads"]]


def workload(bench: dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")
