"""Finding a cell's files by name: ``BENCHMARK.json`` at the checkout's
root, the cell's settings under ``cells/``, its configuration under
``configs/``, its traffic mix under ``traffic/``, and each metric's reader
under ``metrics/`` (``metrics/<name>.py``, else ``metrics/<stem>.py`` for a
name ``<stem>.<cell kind>``, so one reader serves every split of a
quantity). A later cell, mix or metric is a new file and a new entry.

A configuration of any decoder family the port serves enters as new files:

* ``configs/<name>.json``: the published config's keys, ``torch_dtype``,
  ``program_arch`` (the port's registered config it is held to) and
  ``reference`` (the module below).
* ``configs/<reference>.py``, the plain reference (it imports nothing of
  the port), which declares

  - ``FAMILY``: the port's ``ModelConfig.family`` it is held to;
  - ``leaves(cfg)``: a ``weights.Leaf`` for each leaf of the port's tree,
    named below its block and slot (``mla.w_dq``, ``moe.experts.w_gate``)
    or whole for a global one (``embedding.table``): one model layer's
    shape, its type, its initialisation and its input axes (the fan-in,
    and what the fp8 control scales over);
  - ``logits(cfg, seed, seqs, read, *, device, weight_fn=None)``, which
    ``check.compare`` calls;
  - optionally ``RULES``: initialisations of its own by name, each
    ``rule(out, gen, leaf)`` filling one layer's slice from the generator;
  - optionally ``PORT_FIELDS``: configuration-file key -> dotted port
    field (``"n_routed_experts": "moe.num_experts"``), held beside the
    dense keys by ``program.check_agrees``;
  - optionally ``model_flops(cfg)``: (FLOPs of one token through every
    layer, counting only the experts it is routed to; FLOPs of one query
    position against one key position over every layer), which
    ``yardstick`` and ``mfu`` read; without it, a dense decoder's.
* ``cells/<cell>.json``: the engine, with ``"kv_decode"`` ``"kernel"``
  (the default: the paged B3 kernel, whose launches the check holds) or
  ``"gather"`` (every other family), the arrivals, the pre-roll, the
  traced stretch and the check's limits.
* ``metrics/<name>.py`` for a per-layer metric of its own: ``read(run)``
  over ``runner.Run``, which in a traced run also holds the port's spans
  and counters.
"""

from __future__ import annotations

import importlib.util
import json
import sys
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
    """The plain reference module a configuration names, loaded once a
    process (``sys.modules`` holds it under ``teebench_reference_<name>``)."""
    key = f"teebench_reference_{cfg['reference']}"
    mod = sys.modules.get(key)
    if mod is None:
        mod = load_module(HERE / "configs" / f"{cfg['reference']}.py", key)
        sys.modules[key] = mod
    return mod


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
