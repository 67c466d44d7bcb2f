"""The ``mellum2-12b.decode.long8`` cell on the benchmark's side: its
readers on hand-worked and synthetic runs, on an older program that
reports none of their counters, and whole tiny runs on the CPU, in which
planted faults read ``correct`` false: an assignment dropped, a ring slot
written at the wrong place, and TF32 in the program's place (its control).
"""
from __future__ import annotations

import copy
import math
import io
import json
import time

import pytest
import torch

from conftest import ROOT

CELL = "mellum2-12b.decode.long8"
# the configuration at a size the CPU runs in seconds: one period of the
# layer pattern (s, s, s, f), a window of 8, 4 of 8 experts held, YaRN on
TINY = {"hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "sliding_window": 8,
        "layer_types": ["sliding_attention"] * 3 + ["full_attention"],
        "moe_intermediate_size": 32, "num_experts_routed": 8,
        "num_experts": 4, "num_experts_per_tok": 2, "vocab_size": 512,
        "cache_len": 128,
        "rope_parameters": {
            "full_attention": {"rope_type": "yarn", "rope_theta": 5e5,
                               "factor": 4, "beta_fast": 32, "beta_slow": 1,
                               "original_max_position_embeddings": 16,
                               "attention_factor": 1.1386294361119891},
            "sliding_attention": {"rope_type": "default",
                                  "rope_theta": 5e5}}}
TINY_SERVE = {"cuts": [3, 5, 7]}
# prompts past the window, so every ring wraps at prefill
TINY_TRAFFIC = {"prompt_len": [12, 40], "new_tokens": [4, 12]}
SEED = 2**31 + 11


def tiny():
    from bench.harness import spec
    c = spec.resolve(CELL, ROOT)
    cfg = copy.deepcopy(c.config)
    cfg.update(copy.deepcopy(TINY))
    cfg["serve"].update(TINY_SERVE)
    c.config = cfg
    c.traffic = dict(c.traffic, **TINY_TRAFFIC)
    return c


def run_tiny(cell, seconds: float = 2.0, control: bool = False) -> dict:
    from bench.harness import cell as cell_mod
    out, err = io.StringIO(), io.StringIO()
    res = cell_mod.measure(cell, SEED, seconds, False, torch.device("cpu"),
                           time.perf_counter(), out=out, err=err,
                           control=control)
    assert res == {**json.loads(out.getvalue().strip().splitlines()[-1]),
                   **({"control": res["control"]} if control else {})}
    return res


def _run(report=None, **kw):
    from bench.harness.load import Run
    return Run("c", kw.pop("config", {}), {}, 1.0, report=report, **kw)


# -- the FLOP count ------------------------------------------------------------

def test_the_flop_count_on_a_hand_worked_case():
    """d 4, 2 query heads over 1 kv head of 2, layers (s, f) with a window
    of 3, 2 of 4 experts of width 5 held, top 2, vocab 7.  A token
    multiplies, per layer, 4 * 2 * (2 * 2 + 2 * 1) = 48 projection weights,
    4 * 4 = 16 router weights and 2 * 2 / 4 = 1 expert of 3 * 4 * 5 = 60;
    and 4 * 7 = 28 head weights: 2 * (48 + 16 + 60) + 28 = 276.  At
    position 5 it attends 3 positions on the sliding layer and 6 on the
    full one, 4 * 2 * 2 = 16 operations each: 2 * 276 + 16 * 9 = 696."""
    from bench.harness import moe_arith
    cfg = {"hidden_size": 4, "head_dim": 2, "num_attention_heads": 2,
           "num_key_value_heads": 1, "layer_types": ["sliding_attention",
                                                     "full_attention"],
           "sliding_window": 3, "num_experts_routed": 4, "num_experts": 2,
           "num_experts_per_tok": 2, "moe_intermediate_size": 5,
           "vocab_size": 7}
    assert moe_arith.matmul_params(cfg) == 276
    assert moe_arith.token_flops(cfg, 5) == 696
    assert moe_arith.token_flops(cfg, 0) == 2 * 276 + 16 * 2


def test_the_mfu_reads_nothing_untraced_and_counts_the_window():
    from bench.harness import arith, moe_arith, spec
    from bench.harness.load import Session
    read = spec.metric("mfu.mellum2-12b").read
    cfg = tiny().config
    s = Session(0, 0, [1, 2, 3], 3, start=0.5, stamps=[1.0, 1.1, 1.2],
                tokens=[4, 5, 6])
    assert read(_run(config=cfg, sessions=[s])) is None

    class Trace:
        window_s = 2.0
    run = _run(config=cfg, sessions=[s], t0=0.0, trace=Trace())
    ops = sum(moe_arith.token_flops(cfg, p) for p in range(3)) \
        + moe_arith.token_flops(cfg, 3) + moe_arith.token_flops(cfg, 4)
    assert read(run) == pytest.approx(100 * ops / (2.0 * arith.F32_FLOPS))


# -- the program-counter readers ----------------------------------------------

@pytest.mark.parametrize("per_node, want", [
    ([{"stage": 0, "moe_rows": {"a": [3, 1], "b": [2, 2]}},
      {"stage": 1, "moe_rows": {"c": [0, 8]}}], 8 * 6 / 16),
    ([{"stage": 1, "moe_rows": {"c": [1, 3]}},
      {"stage": 1, "moe_rows": {"c": [3, 1]}}], 1.0),
])
def test_moe_imbalance_sums_a_layer_over_its_replicas(per_node, want):
    from bench.harness import spec
    read = spec.metric("moe_imbalance.mellum2").read
    assert read(_run({"per_node": per_node})) == pytest.approx(want)


def test_prefill_ms_is_per_stage_seconds_per_thousand_tokens():
    from bench.harness import spec
    read = spec.metric("prefill_ms.mellum2").read
    nodes = [{"stage": 0, "prefill_s": 0.5, "prefill_tokens": 1000},
             {"stage": 1, "prefill_s": 0.25, "prefill_tokens": 400},
             {"stage": 1, "prefill_s": 0.25, "prefill_tokens": 600}]
    assert read(_run({"per_node": nodes})) == pytest.approx(0.5 + 0.5)


@pytest.mark.parametrize("name", ["moe_imbalance.mellum2",
                                  "prefill_ms.mellum2",
                                  "step_graph_share.mellum2"])
@pytest.mark.parametrize("report", [
    None, {"per_node": [{"stage": 0, "compute_s": 0.1, "requests": 4}]}])
def test_the_readers_read_nothing_from_an_older_program(name, report):
    from bench.harness import spec
    assert spec.metric(name).read(_run(report)) is None


# -- the logits checks ----------------------------------------------------------

def _judge(monkeypatch, errors: list, missing: int = 0) -> dict:
    """``moe_chain``'s logits checks of sessions whose rows read ``errors``
    (one list of row errors a session; a reference row of ones), and
    ``missing`` sessions of 4 tokens whose logits never came."""
    from types import SimpleNamespace as NS

    from bench.drivers import moe_chain
    monkeypatch.setattr(moe_chain.W, "draw", lambda *a: {})
    sut = object.__new__(moe_chain.ChainMoE)
    sut.config, sut.seed, sut.device = tiny().config, SEED, \
        torch.device("cpu")
    sessions = [NS(sid=i, prompt=[0], tokens=[0] * len(e))
                for i, e in enumerate(errors)]
    sessions += [NS(sid=-1, prompt=[0], tokens=[0] * 4)] * missing
    sut._reference = lambda params, s: torch.ones(len(s.tokens), 3)
    checks = sut._judge(NS(sessions=sessions), lambda s, params: (
        None if s.sid == -1 else
        1.0 + torch.tensor(errors[s.sid], dtype=torch.float32)[:, None]
        * torch.ones(3)))
    return {c.name: c for c in checks}


CLEAN = [[1e-5] * 30] * 33


@pytest.mark.parametrize("case", ["clean", "one_session", "nan_row",
                                  "inf_row", "missing_session"])
def test_the_logits_checks_catch_what_a_percentile_of_rows_hides(
        monkeypatch, case):
    """A fault confined to one session of 34 (under 3 % of the rows), a
    row that reads NaN or infinite, and a session whose logits are
    missing each fail a check, though the rows' 95th percentile passes."""
    errors = [list(e) for e in CLEAN]
    bad = 0
    if case == "one_session":
        errors.append([1e-1] * 30)
    elif case in ("nan_row", "inf_row"):
        errors[3][7] = math.nan if case == "nan_row" else math.inf
        bad = 1
    got = _judge(monkeypatch, errors, 1 if case == "missing_session" else 0)
    if case == "missing_session":
        bad = 4
    assert got["logits_rel_err_p95"].ok
    assert got["logits_bad_rows"].value == bad
    assert got["logits_rel_err_session_p50"].ok == (case != "one_session")
    assert all(c.ok for c in got.values()) == (case == "clean")


# -- whole tiny runs -------------------------------------------------------------

def test_a_tiny_run_is_correct_and_reads_every_counter():
    from bench.harness import spec
    c = tiny()
    res = run_tiny(c, control=True)
    assert res["correct"] is True, res["checks"]
    checks = res["checks"]
    assert checks["moe_dropped"]["value"] == 0
    assert checks["failed_sessions"]["value"] == 0
    assert checks["logits_bad_rows"]["value"] == 0
    # TF32 in the program's place, the control, is caught
    ctl = res["control"]["checks"]["logits_rel_err_p95"]
    assert ctl["value"] > ctl["limit"]


def test_the_counters_count_what_the_steps_routed():
    """Every decode step's live rows: each routes to top-k experts, so the
    held experts' rows over all layers and the assignments to experts not
    held add up to layers * k * rows; a tiny run's rows all reach the
    readers."""
    from bench.harness import load, spec
    c = tiny()
    sut = spec.driver(c.config).build(c.config, c.traffic, SEED,
                                      torch.device("cpu"), {})
    try:
        load.warm(sut, c.traffic, SEED)
        run = load.drive(sut, load.Run(c.name, c.config, c.traffic, 1.0),
                         SEED)
    finally:
        sut.close()
    nodes = run.report["per_node"]
    assert all(not any(n["moe_dropped"].values()) for n in nodes)
    rows = sum(sum(r) for n in nodes for r in n["moe_rows"].values())
    assert 0 < rows <= 4 * 2 * sum(max(len(s.tokens) - 1, 0)
                                   for s in run.sessions)
    assert spec.metric("moe_imbalance.mellum2").read(run) >= 1.0
    assert spec.metric("prefill_ms.mellum2").read(run) > 0
    assert spec.metric("step_graph_share.mellum2").read(run) == 0.0
    assert sum(n["prefill_tokens"] for n in nodes if n["stage"] == 0) \
        == sum(len(s.prompt) for s in run.sessions)


def _dropping(real):
    """The step's experts with one live row's first held assignment left
    out of the combine, and not counted as dropped."""
    def step(p, x, top_k, first, name, eps=1e-5):
        from repro_torch.models import moe
        h = moe.rmsnorm(p["ln"], x, eps).reshape(-1, x.shape[-1])
        idx, gates = moe.route_topk(p, h, top_k)
        y = real(p, x, top_k, first, name, eps)
        n = p["up"].shape[0]
        e = int(idx[0, 0]) - first
        if 0 <= e < n:
            out = moe._swiglu(p, h[:1], e) * gates[0, 0]
            y = y.clone()
            y[0, 0] -= out[0]
        return y
    return step


def _misplaced_ring(real):
    """A ring's prefill that writes the prompt's last positions one slot
    too far."""
    def nodes(spec, cache_len, use_kernel, eps=1e-5):
        fn, prefill, step = real(spec, cache_len, use_kernel, eps)

        def shifted(p, x):
            y, c = prefill(p, x)
            if spec.window is not None and x.shape[1] > cache_len:
                c = {k: torch.roll(v, 1, dims=1) for k, v in c.items()}
            return y, c
        return fn, shifted, step
    return nodes


def _zero_weight(real):
    """The step's combine with row 0's weights zeroed."""
    def combine(col, gates, n):
        w = real(col, gates, n).clone()
        w[0] = 0.0
        return w
    return combine


@pytest.mark.parametrize("fault", ["dropped_assignment", "wrong_ring_slot",
                                   "zero_combine_weight"])
def test_a_fault_makes_the_run_incorrect(monkeypatch, fault):
    from repro_torch.models import lm_graph, moe
    if fault == "dropped_assignment":
        monkeypatch.setattr(lm_graph, "held_experts_step",
                            _dropping(lm_graph.held_experts_step))
    elif fault == "wrong_ring_slot":
        monkeypatch.setattr(lm_graph, "_attn_nodes",
                            _misplaced_ring(lm_graph._attn_nodes))
    else:
        monkeypatch.setattr(moe, "combine_weights",
                            _zero_weight(moe.combine_weights))
    res = run_tiny(tiny())
    assert res["correct"] is False
    assert res["checks"]["logits_rel_err_p95"]["value"] \
        > res["checks"]["logits_rel_err_p95"]["limit"]
    if fault == "zero_combine_weight":
        assert res["checks"]["moe_dropped"]["value"] > 0
