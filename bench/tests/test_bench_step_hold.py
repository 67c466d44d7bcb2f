"""The decode waves' hold time on the benchmark's side: its reader on a
synthetic run, on an older program that reports no holds, and on a tiny
CPU run of the decode cell, whose replicated stage splits the sessions that
the next stage's waves hold for."""
from __future__ import annotations

import pytest

from conftest import tiny

NAME = "step_hold_ms.decode"


def _run(report, tokens: int = 10):
    from bench.harness.load import Run, Session
    return Run("c", {}, {}, 1.0, report=report,
               sessions=[Session(0, 0, [1], tokens, tokens=[0] * tokens)])


@pytest.mark.parametrize("per_node, want", [
    ([{"step_hold_s": 0.01}, {"step_hold_s": 0.03}], 4.0),
    ([{"step_hold_s": 0.0}], 0.0),
    ([{"step_hold_s": 0.02}, {"compute_s": 0.1}], 2.0),
])
def test_the_reader_on_a_synthetic_run(per_node, want):
    from bench.harness import spec
    read = spec.metric(NAME).read
    assert read(_run({"per_node": per_node})) == pytest.approx(want)


@pytest.mark.parametrize("report, tokens", [
    (None, 10),
    ({"per_node": [{"compute_s": 0.1, "step_launch_s": 0.2,
                    "step_live_rows": 3, "step_rows_run": 8}]}, 10),
    ({"per_node": [{"step_hold_s": 0.1}]}, 0)])
def test_the_reader_reads_nothing_where_the_program_reports_no_holds(
        report, tokens):
    from bench.harness import spec
    assert spec.metric(NAME).read(_run(report, tokens)) is None


def test_the_reader_reads_a_tiny_cpu_run():
    from bench.harness import load, spec
    from bench.harness.spans import tokens
    c = tiny("starcoder2-3b.decode.closed8")
    import torch
    sut = spec.driver(c.config).build(c.config, c.traffic, 2**31 + 11,
                                      torch.device("cpu"), {})
    try:
        load.warm(sut, c.traffic, 2**31 + 11)
        run = load.drive(sut, load.Run(c.name, c.config, c.traffic, 1.0),
                         2**31 + 11)
    finally:
        sut.close()
    nodes = run.report["per_node"]
    held = sum(n["step_hold_s"] for n in nodes)
    assert all(n["step_hold_joins"] <= n["step_live_rows"] for n in nodes)
    assert all((n["step_holds"] > 0) == (n["step_hold_s"] > 0)
               for n in nodes)
    assert spec.metric(NAME).read(run) == pytest.approx(
        held * 1e3 / tokens(run))
