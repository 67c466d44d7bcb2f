"""The decode steps' live share on the benchmark's side: its reader on a
synthetic run, on an older program that reports no such counters, and on a
tiny CPU run of the decode cell, whose 8-row steps serve fewer sessions
than they run rows whenever a wave is not full."""
from __future__ import annotations

import pytest

from conftest import tiny

NAME = "step_live_share.decode"


def _run(report):
    from bench.harness.load import Run
    return Run("c", {}, {}, 1.0, report=report)


@pytest.mark.parametrize("per_node, want", [
    ([{"step_live_rows": 30, "step_rows_run": 40},
      {"step_live_rows": 10, "step_rows_run": 40}], 50.0),
    ([{"step_live_rows": 8, "step_rows_run": 8}], 100.0),
    ([{"step_live_rows": 1, "step_rows_run": 8},
      {"compute_s": 0.1}], 12.5),
])
def test_the_reader_on_a_synthetic_run(per_node, want):
    from bench.harness import spec
    read = spec.metric(NAME).read
    assert read(_run({"per_node": per_node})) == pytest.approx(want)


@pytest.mark.parametrize("report", [
    None, {"per_node": [{"compute_s": 0.1, "requests": 4,
                         "step_graph_replays": 3, "step_eager_steps": 1}]},
    {"per_node": [{"step_live_rows": 0, "step_rows_run": 0}]}])
def test_the_reader_reads_nothing_where_no_step_ran(report):
    from bench.harness import spec
    assert spec.metric(NAME).read(_run(report)) is None


def test_the_reader_reads_a_tiny_cpu_run():
    from bench.harness import load, spec
    c = tiny("starcoder2-3b.decode.closed8")
    import torch
    sut = spec.driver(c.config).build(c.config, c.traffic, 2**31 + 9,
                                      torch.device("cpu"), {})
    try:
        load.warm(sut, c.traffic, 2**31 + 9)
        run = load.drive(sut, load.Run(c.name, c.config, c.traffic, 1.0),
                         2**31 + 9)
    finally:
        sut.close()
    nodes = run.report["per_node"]
    live = sum(n["step_live_rows"] for n in nodes)
    ran = sum(n["step_rows_run"] for n in nodes)
    assert 0 < live <= ran
    assert ran == 8 * sum(n["step_graph_replays"] + n["step_eager_steps"]
                          for n in nodes)
    assert spec.metric(NAME).read(run) == pytest.approx(100.0 * live / ran)
