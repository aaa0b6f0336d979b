"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file (``configs/<config>.json``) names its scene recipe
(``scenes/<recipe>.py``), the recipe's parameters, the limits of the
comparison that decides ``correct`` and the pixels it checks. The traffic
mix is ``traffic/<traffic>.json``. Each per-layer metric is read by
``metrics/<name>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's directory, as a module."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError("no %s named %r (%s)" % (kind, name, path))
    spec = importlib.util.spec_from_file_location(
        "portbench_%s_%s" % (kind, name.replace("-", "_").replace(".", "_")),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, its
    traffic mix and the metrics it reports."""
    bench = benchmark or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError("no workload named %r in BENCHMARK.json" % name)
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json"))
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reported(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported(m, name)])
