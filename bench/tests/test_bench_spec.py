"""The harness finds every cell, configuration, traffic mix, driver and
metric by name, and BENCHMARK.json keeps to the benchmark's contract."""
from __future__ import annotations

import json
import os
import re

import pytest

from conftest import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
HELD = json.load(open(os.path.join(ROOT, "bench", "held_out.json")))


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert BENCH["command"][1].startswith("bench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS + [w["name"]
                                          for w in HELD["workloads"]])
def test_every_cell_resolves(name):
    from bench.harness import spec
    c = spec.resolve(name, ROOT)
    assert c.chips == 1
    assert spec.driver(c.config).build
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        if m["name"] != "setup_s":
            assert callable(spec.metric(m["name"]).read)
    for limit in c.config["limits"][c.traffic.get("wire", "raw")].values():
        assert isinstance(limit, float) and limit > 0


def test_names_units_and_bounds():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in CELLS
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_config_file_is_under_paths_and_used():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("bench/configs/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert not any("dim" in k or "size" in k for k in c["reduced"])


def test_pinned_cuts_are_what_the_partitioner_chooses():
    """The configurations pin the cuts the program's partitioner picks
    for these graphs, so the reference quantizes where the wire does."""
    from bench.harness import spec
    from repro_torch.models import cnn, lm_graph
    from repro_torch.runtime import TopologySpec
    r = spec.resolve("resnet50.q8.closed8", ROOT).config
    g = cnn.resnet50(batch=1, image=r["model"]["image"],
                     num_classes=r["model"]["num_classes"])
    s = TopologySpec.chain(g, 4, strategy=r["serve"]["strategy"])
    assert list(s.cuts) == r["serve"]["cuts"]
    d = spec.resolve("starcoder2-3b.decode.closed8", ROOT).config
    g = lm_graph.decode_lm_graph(**d["model"])
    s = TopologySpec.chain(g, 4, strategy=d["serve"]["strategy"])
    assert list(s.cuts) == d["serve"]["cuts"]


def test_a_held_out_cell_is_not_in_the_benchmark_and_keeps_its_form():
    held = {w["name"] for w in HELD["workloads"]}
    assert held and not held & set(CELLS)
    confs = {c["name"] for c in HELD["configs"]}
    assert {w["config"] for w in HELD["workloads"]} <= confs
    assert all("bound" not in m for m in HELD["end_to_end"])
    for m in HELD["per_layer"]:
        assert set(m["workloads"]) <= held
