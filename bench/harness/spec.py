"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root names every cell, configuration
and metric.  Each piece lives in a file of its own under ``bench/``:

* a configuration: the file its entry names (``bench/configs/<name>.json``);
  its ``driver`` key names ``bench/drivers/<driver>.py``, which builds the
  system under test, and its ``reference`` key the plain reference in
  ``bench/reference/``;
* a traffic mix: ``bench/traffic/<traffic>.json``;
* a metric, end to end or per layer: ``bench/metrics/<name>.py``, whose
  ``read(run)`` returns the number, or None where the run has nothing to
  read.  A quantity split by the end-to-end metric it moves
  (``device_idle.decode``, ``device_idle.resnet50``) may share one reader,
  ``bench/metrics/<part before the first dot>.py``, where no file of the
  whole name exists.

So a later change adds a cell by adding files and entries, and edits none.
``bench/held_out.json`` holds, in the same form, the entries of cells that
were measured and taken out (PERF.md says why).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from types import ModuleType

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]          # the entries this cell reports
    per_layer: list[dict]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str, reported: set[str]) -> bool:
    """A metric with ``workloads`` applies to those cells; a per-layer one
    without it to every cell that reports the metric it ``moves``; an
    end-to-end one without it to every cell."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def resolve(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its
    configuration, traffic mix and the metrics it reports; a cell that is
    not there is looked for in ``bench/held_out.json``, which keeps the
    entries of cells taken out of the benchmark, so that they still run
    by name (the driver runs only BENCHMARK.json's)."""
    bench = benchmark(root)
    if name not in {w["name"] for w in bench["workloads"]}:
        held = os.path.join(root, "bench", "held_out.json")
        if os.path.exists(held):
            bench = load_json(held)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, confs[w["config"]]["file"]))
    traffic = load_json(os.path.join(root, "bench", "traffic",
                                     f"{w['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer)


def _load(kind: str, name: str, root: str = BENCH) -> ModuleType:
    path = os.path.join(root, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    mod_name = f"bench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(config: dict) -> ModuleType:
    return _load("drivers", config["driver"])


def metric(name: str) -> ModuleType:
    if os.path.exists(os.path.join(BENCH, "metrics", f"{name}.py")):
        return _load("metrics", name)
    return _load("metrics", name.split(".")[0])
