"""The serving chain's spans, thread names and thread clocks
(``repro_torch.runtime.spans``), on a tiny decode chain and a tiny CNN
chain on the CPU."""
from __future__ import annotations

import re
import threading
import time

import numpy as np
import pytest
import torch

from _torch_weights import fan_in_params
from repro_torch.core.graph import tree_flatten_with_path
from repro_torch.models import cnn as tcnn
from repro_torch.models import lm_graph as tlm
from repro_torch.runtime import (BatchEnvelope, DispatcherCodecs,
                                 InferenceEngine, RowExtent, TopologySpec,
                                 WireCodec, frame)
from repro_torch.runtime.node import STEP_PHASES, BatchTrace
from repro_torch.runtime.spans import NULL, WAIT, WORK, SpanLog
from repro_torch.runtime.wire import K_STEP

torch.set_num_threads(1)

LM = dict(vocab=48, d_model=32, n_layers=2, num_heads=4, kv_heads=2,
          head_dim=8, d_ff=64, cache_len=48)
RAW = WireCodec("raw", "none")
CODECS = DispatcherCodecs(data=RAW, weights=RAW)
PROMPTS = [[1, 5, 9, 2], [3, 3, 7], [2, 8, 4, 6, 1]]
NEW_TOKENS = 5
REPLICAS = [1, 2]           # stage 1 replicated: names carry r0 and r1
STAGES = range(len(REPLICAS))

NODE_WORK = ["decode", "wave", "encode", "relay"]
DECODE_SPANS = (
    ["defer.submit", "defer.pump", "defer.collect", "defer.wait.admission",
     "defer.wait.result"]
    + [f"defer.route.s{i}" for i in STAGES]
    + [f"defer.s{i}.{k}" for i in STAGES
       for k in NODE_WORK + ["prefill"] + [f"step.{p}" for p in STEP_PHASES]]
    + [f"defer.wait.s{i}.{q}" for i in STAGES
       for q in ("inbox", "to_compute", "to_encode")])
CNN_SPANS = [f"defer.s{i}.{k}" for i in STAGES for k in NODE_WORK
             + ["compute"]]
THREADS = (["defer-pump", "defer-collect"]
           + [f"defer-route-s{i}" for i in STAGES]
           + [f"defer-s{i}r{j}-{role}" for i, n in enumerate(REPLICAS)
              for j in range(n) for role in ("ingress", "compute", "egress")])


def _lm_params(graph) -> dict:
    rng = np.random.default_rng(0)
    params: dict = {}
    for node in graph.nodes:
        p: dict = {}
        for path, spec in tree_flatten_with_path(node.param_spec):
            d = p
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = (0.2 * rng.standard_normal(tuple(spec.shape))
                           ).astype(np.float32)
        params[node.name] = p
    return params


def _engine(graph, params) -> InferenceEngine:
    eng = InferenceEngine(graph, TopologySpec.chain(graph, len(REPLICAS),
                                                    replicas=REPLICAS),
                          CODECS, max_batch=4, device="cpu")
    eng.configure(params)
    eng.start()
    return eng


def _sessions(eng) -> None:
    ts = [threading.Thread(target=lambda p=p: list(eng.generate(
        p, NEW_TOKENS))) for p in PROMPTS]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts)


@pytest.fixture(scope="module")
def decode():
    g = tlm.decode_lm_graph(**LM)
    eng = _engine(g, _lm_params(g))
    try:
        eng.reset_window()
        eng.start_spans()
        _sessions(eng)
        spans = eng.stop_spans()
        report = eng.report()
        names = {t.name for t in eng.threads()}
        # the log off again: a second round records nothing
        _sessions(eng)
        after = eng.stop_spans()
        yield {"eng": eng, "spans": spans.spans, "report": report,
               "names": names, "after": after.spans}
    finally:
        eng.shutdown()


def _burn(s: float) -> None:
    t = time.thread_time()
    while time.thread_time() - t < s:
        pass


@pytest.fixture(scope="module")
def cnn():
    g = tcnn.resnet50(batch=1, image=32, num_classes=10)
    eng = _engine(g, fan_in_params(g))
    x = np.random.default_rng(1).standard_normal((1, 32, 32, 3)) \
        .astype(np.float32)
    try:
        eng.start_spans()
        for f in [eng.submit(x, client_id=c) for c in range(4)]:
            f.result(60)
        spans = eng.stop_spans()
        # one request whose stage-0 apply burns 50 ms of its thread's CPU
        node = eng.dispatcher.stages[0].replicas[0]
        apply = node._apply
        node._apply = lambda b: (_burn(0.05), apply(b))[1]
        eng.reset_window()
        eng.submit(x).result(60)
        node._apply = apply
        yield {"spans": spans.spans, "report": eng.report()}
    finally:
        eng.shutdown()


def _stage(name: str) -> int | None:
    for part in name.split("."):
        if part[:1] == "s" and part[1:].isdigit():
            return int(part[1:])
    return None


@pytest.mark.parametrize("name", DECODE_SPANS)
def test_the_decode_chain_records_each_named_span_with_its_stage(decode,
                                                                  name):
    got = [s for s in decode["spans"] if s.name == name]
    assert got, name
    assert {s.kind for s in got} == {WAIT if ".wait." in name else WORK}
    i = _stage(name)
    assert {s.stage for s in got} == {-1 if i is None else i}
    assert all(s.end_ns >= s.start_ns for s in got)


@pytest.mark.parametrize("name", CNN_SPANS)
def test_the_cnn_chain_records_each_named_span_with_its_stage(cnn, name):
    got = [s for s in cnn["spans"] if s.name == name]
    assert got and {s.stage for s in got} == {_stage(name)}
    assert not [s for s in cnn["spans"] if ".step." in s.name
                or s.name.endswith(".prefill")]


def _phase(s) -> bool:
    """Whether ``s`` is a decode step's phase (a wave's hold, before the
    wave, is not)."""
    return ".step." in s.name and s.name.rsplit(".", 1)[1] in STEP_PHASES


def test_a_step_nests_inside_its_wave_on_its_thread(decode):
    """Each decode step's four phases follow one another on the compute
    thread, inside the wave span that thread was running; a wave's hold
    ends before the wave starts."""
    spans = decode["spans"]
    waves = [s for s in spans if s.name.endswith(".wave")]
    threads = {s.thread for s in spans if _phase(s)}
    assert {int(re.match(r"defer-s(\d+)r", t)[1]) for t in threads} == \
        set(STAGES)
    for h in (s for s in spans if s.name.endswith(".step.hold")):
        assert h.thread.endswith("-compute")
        assert any(w.thread == h.thread and h.end_ns <= w.start_ns
                   for w in waves)
    for t in threads:
        assert t.endswith("-compute")
        steps = sorted((s for s in spans if _phase(s) and s.thread == t),
                       key=lambda s: s.start_ns)
        assert len(steps) % len(STEP_PHASES) == 0
        for k in range(0, len(steps), len(STEP_PHASES)):
            one = steps[k:k + len(STEP_PHASES)]
            assert [s.name.rsplit(".", 1)[1] for s in one] == \
                list(STEP_PHASES)
            assert all(a.end_ns <= b.start_ns for a, b in zip(one, one[1:]))
            assert any(w.thread == t and w.start_ns <= one[0].start_ns
                       and one[-1].end_ns <= w.end_ns for w in waves)


def test_wait_spans_carry_their_ids_across_the_hops(decode):
    """Every wait span names the requests and sessions it covers, and one
    session's steps can be followed through every queue of the chain."""
    waits = [s for s in decode["spans"] if s.kind == WAIT]
    assert waits and all(s.ids and s.sessions for s in waits)
    sid = waits[0].sessions[0]
    seen = {s.name for s in waits if sid in s.sessions}
    assert seen == {n for n in DECODE_SPANS if ".wait." in n}


def test_an_off_log_records_nothing_and_hands_back_the_shared_null(decode):
    log = SpanLog()
    assert log.span("defer.pump") is NULL
    assert decode["eng"].dispatcher.spans.span("defer.collect") is NULL
    assert decode["after"] == []


def test_the_chain_threads_carry_their_names(decode):
    assert decode["names"] == set(THREADS)


def test_thread_cpu_covers_every_live_chain_thread(decode):
    rep = decode["report"]
    assert set(rep.thread_cpu_s) == set(THREADS)
    assert all(v >= 0 for v in rep.thread_cpu_s.values())
    assert 0 < sum(rep.thread_cpu_s.values()) <= rep.process_cpu_s


def test_a_thread_burning_50_ms_of_cpu_reads_at_least_40(cnn):
    assert cnn["report"].thread_cpu_s["defer-s0r0-compute"] >= 0.04


def test_window_totals_are_the_spans_summed(decode):
    """The report's step phases and step waits are the spans' own
    readings, summed (waits counted once for each step they carry)."""
    rep, spans = decode["report"], decode["spans"]
    for p in STEP_PHASES:
        got = sum(n[f"step_{p}_s"] for n in rep.per_node)
        want = sum(s.end_ns - s.start_ns for s in spans
                   if s.name.endswith(f".step.{p}")) / 1e9
        assert got == pytest.approx(want, abs=1e-6)
    got = sum(rep.step_wait_s.values())
    # a wait span counts its duration once for each step among its ids
    stepped = {i for s in spans if ".step." in s.name for i in s.ids}
    assert stepped
    want = sum(s.end_ns - s.start_ns for s in spans if s.kind == WAIT
               for i in s.ids if i in stepped) / 1e9
    assert got == pytest.approx(want, rel=1e-3)


def test_encodes_per_batch_left_the_report(decode, cnn):
    for rep in (decode["report"], cnn["report"]):
        assert rep.per_node and all("encodes_per_batch" not in n
                                    for n in rep.per_node)
    assert "encodes" in BatchTrace.__dataclass_fields__


def test_a_put_stamp_never_reaches_the_frame():
    ext = [RowExtent(3, "c", 0, 1, session="s", pos=2, kind=K_STEP)]
    a = BatchEnvelope(ext, b"\x01\x02", epoch=1)
    b = BatchEnvelope(ext, b"\x01\x02", epoch=1)
    b.t_put = time.perf_counter()
    assert frame(a) == frame(b) and a == b
