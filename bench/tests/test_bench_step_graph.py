"""The decode step's graph share on the benchmark's side: its reader on a
synthetic run, on an older program that reports no such counters, and on a
tiny CPU run, whose steps all run eagerly."""
from __future__ import annotations

import pytest

from conftest import tiny

NAME = "step_graph_share.decode"


def _run(report):
    from bench.harness.load import Run
    return Run("c", {}, {}, 1.0, report=report)


@pytest.mark.parametrize("per_node, want", [
    ([{"step_graph_replays": 30, "step_eager_steps": 1},
      {"step_graph_replays": 68, "step_eager_steps": 1}], 98.0),
    ([{"step_graph_replays": 0, "step_eager_steps": 12}], 0.0),
    ([{"step_graph_replays": 5, "step_eager_steps": 0}], 100.0),
])
def test_the_reader_on_a_synthetic_run(per_node, want):
    from bench.harness import spec
    read = spec.metric(NAME).read
    assert read(_run({"per_node": per_node})) == pytest.approx(want)


@pytest.mark.parametrize("report", [
    None, {"per_node": [{"compute_s": 0.1, "requests": 4}]},
    {"per_node": [{"step_graph_replays": 0, "step_eager_steps": 0}]}])
def test_the_reader_reads_nothing_where_no_step_ran(report):
    from bench.harness import spec
    assert spec.metric(NAME).read(_run(report)) is None


def test_the_reader_reads_a_tiny_cpu_run_as_all_eager():
    from bench.harness import load, spec
    c = tiny("starcoder2-3b.decode.closed8")
    import torch
    sut = spec.driver(c.config).build(c.config, c.traffic, 2**31 + 5,
                                      torch.device("cpu"), {})
    try:
        load.warm(sut, c.traffic, 2**31 + 5)
        run = load.drive(sut, load.Run(c.name, c.config, c.traffic, 1.0),
                         2**31 + 5)
    finally:
        sut.close()
    assert spec.metric(NAME).read(run) == 0.0
    assert all(n["step_graph_captures"] == n["step_graph_failures"] == 0
               for n in run.report["per_node"])
