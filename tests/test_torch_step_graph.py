"""A replica's decode step on its own staging buffers
(``runtime/step_graph.py``), eager on the CPU and replayed as one CUDA graph
on a card.

A step served through the staging is held bit for bit against the stacked
step it replaced (the wave's caches concatenated, pad rows repeating the
last row's caches, the step apply run eagerly): outputs and every session's
new caches, over waves of 1 to 8 sessions with sessions closing and opening
between them.  Served through the chain, greedy tokens equal
``pipeline_decode_reference`` through eviction, a live repartition and a
replica spawned by ``scale()``, and the replicas' step counters count.

The ``cuda`` cases need a card and run there (this file imports no JAX):
``python -m pytest --noconftest -m cuda tests/test_torch_step_graph.py``.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.graph import tree_flatten_with_path
from repro_torch.kernels import decode_attention as da
from repro_torch.models import lm_graph as tlm
from repro_torch.runtime import (DispatcherCodecs, InferenceEngine,
                                 TopologySpec, WireCodec)
from repro_torch.runtime.node import STEP_COUNTS, ComputeNode
from repro_torch.runtime.session import live_session_stores
from repro_torch.runtime.wire import K_STEP, RowExtent

torch.set_num_threads(1)

# 2 layers, GQA (4 query heads over 2 kv heads): 6 nodes
LM = dict(vocab=48, d_model=32, n_layers=2, num_heads=4, kv_heads=2,
          head_dim=8, d_ff=64, cache_len=48)
# StarCoder2-3B's widths (the benchmark's decode cell) at 2 layers
WIDE = dict(vocab=49152, d_model=3072, n_layers=2, num_heads=24, kv_heads=2,
            head_dim=128, d_ff=12288, cache_len=4096)
CODECS = DispatcherCodecs(data=WireCodec("raw", "none"),
                          weights=WireCodec("raw", "none"))
WAVES = 24


@pytest.fixture(autouse=True)
def _no_port_session_residue():
    """Resident decode-session caches must be evicted on session end."""
    yield
    residue = {id(s): s.keys() for s in live_session_stores() if len(s)}
    assert not residue, f"leaked resident decode-session caches: {residue}"


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(request.param)


def lm_params(graph, seed: int = 0) -> dict:
    """numpy params: ``w ~ N(0, 1/fan_in)``, norm scales 1, the embedding
    table ``~ N(0, 1)``."""
    rng = np.random.default_rng(seed)
    params = {}
    for node in graph.nodes:
        p: dict = {}
        for path, spec in tree_flatten_with_path(node.param_spec):
            shape = tuple(spec.shape)
            if path[-1] == "scale":
                a = np.ones(shape, np.float32)
            elif path[-1] == "w":
                a = rng.standard_normal(shape, np.float32) \
                    * np.float32(1 / np.sqrt(shape[0]))
            else:
                a = rng.standard_normal(shape, np.float32)
            d = p
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = a
        params[node.name] = p
    return params


def device_params(graph, device, seed: int = 0) -> dict:
    """Prepared params drawn on ``device`` (as :func:`lm_params` scales
    them), for widths whose host draw would be slow."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(path, spec):
        shape = tuple(spec.shape)
        if path[-1] == "scale":
            return torch.ones(shape, device=device)
        a = torch.randn(shape, generator=g, device=device)
        return a / np.sqrt(shape[0]) if path[-1] == "w" else a

    params = {}
    for node in graph.nodes:
        p: dict = {}
        for path, spec in tree_flatten_with_path(node.param_spec):
            d = p
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = draw(path, spec)
        params[node.name] = p
    return params


# -- the step on one replica ------------------------------------------------

def _whole_graph_node(graph, prep, device) -> ComputeNode:
    """A replica serving the whole graph (one stage, the tail)."""
    node = ComputeNode(0, CODECS.data, device=device)
    node._graph = graph
    node._set_range(0, len(graph.nodes))
    node._params = prep
    node._make_apply()
    return node


def _stacked(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stacked([t[k] for t in trees]) for k in trees[0]}
    return torch.cat(trees, dim=0)


def _stacked_step(node, caches: list, x: np.ndarray, pos: list[int]):
    """The step as it ran before the staging: the wave's caches stacked,
    pad rows repeating the last row's caches, the apply run eagerly."""
    pad = [caches[-1]] * (node._step_rows - len(caches))
    dev = node.device
    y, new = node._decode_apply(_stacked(caches + pad),
                                torch.from_numpy(x).to(dev),
                                torch.tensor(pos, dtype=torch.int32,
                                             device=dev))
    return y.cpu().numpy(), new


@pytest.mark.parametrize("width", ["smoke", pytest.param(
    "wide", marks=pytest.mark.cuda)])
def test_staged_steps_equal_the_stacked_step_bit_for_bit(device, width):
    """``WAVES`` waves of 1 to 8 sessions, sessions closing and opening
    between them: every session's output row and new caches equal the
    stacked step's.  On a card the first wave captures the graph and the
    rest replay it, against the stacked step run eagerly; decode
    attention's counter counts the replays' launches."""
    if width == "wide" and device.type != "cuda":
        pytest.skip("StarCoder2-3B's widths run on the card only")
    cfg = LM if width == "smoke" else WIDE
    graph = tlm.decode_lm_graph(use_kernel=True, **cfg)
    prep = (graph.prepare(lm_params(graph), device) if width == "smoke"
            else device_params(graph, device))
    node = _whole_graph_node(graph, prep, device)
    rows, out_name = node._step_rows, node._exported[0]
    rng = np.random.default_rng(7)
    max_prompt = min(cfg["cache_len"] - WAVES - 1, 600)
    live: dict[str, int] = {}           # session -> its next position
    opened = 0

    def open_session():
        nonlocal opened
        sid = f"s{opened}"
        opened += 1
        n = int(rng.integers(3, max_prompt))
        prompt = rng.integers(0, cfg["vocab"], (1, n), dtype=np.int32)
        _, caches = node._prefill_apply(torch.from_numpy(prompt).to(device))
        node.sessions.put(sid, caches)
        live[sid] = n

    for _ in range(10):
        open_session()
    launches = 0
    try:
        for w in range(WAVES):
            if w % 5 == 4:                  # one closes, two open
                gone = sorted(live)[0]
                node.sessions.pop(gone)
                del live[gone]
                open_session()
                open_session()
            k = 1 + w % rows if w < rows else int(rng.integers(1, rows + 1))
            sids = list(rng.choice(sorted(live), size=k, replace=False))
            toks = rng.integers(0, cfg["vocab"], (k, 1), dtype=np.int32)
            wave = [(RowExtent(i, 0, i, 1, session=s, pos=live[s],
                               kind=K_STEP), toks[i:i + 1],
                     node.sessions.get(s)) for i, s in enumerate(sids)]
            pad = [wave[-1]] * (rows - k)
            with torch.inference_mode():
                want_y, want_new = _stacked_step(
                    node, [c for _, _, c in wave],
                    np.concatenate([x for _, x, _ in wave + pad]),
                    [e.pos for e, _, _ in wave + pad])
            before = da.launches["decode_attention"]
            outs, fails, _ = node._step_wave(wave, rows, out_name)
            launches += da.launches["decode_attention"] - before
            assert not fails, fails[0].error
            for i, ((e, _, _), (ext, got)) in enumerate(zip(wave, outs)):
                assert ext == [e]
                assert np.array_equal(got[out_name], want_y[i:i + 1])
                mine = dict(tree_flatten_with_path(node.sessions.get(e.session)))
                for path, t in tree_flatten_with_path(want_new):
                    assert torch.equal(mine[path], t[i:i + 1]), (w, path)
                live[e.session] += 1
    finally:
        node.sessions.clear()
    counts = node.step_counts
    graphed = device.type == "cuda"
    assert node._staging.graphed is graphed
    assert counts == {"step_graph_replays": WAVES - 1 if graphed else 0,
                      "step_eager_steps": 1 if graphed else WAVES,
                      "step_graph_captures": 1 if graphed else 0,
                      "step_graph_failures": 0}
    assert launches == (WAVES * cfg["n_layers"] if graphed else 0)


def test_make_apply_drops_the_staging(device):
    """New params or layers never replay an old graph: ``_make_apply``
    drops the staging, and the next step builds (and on a card captures)
    anew."""
    graph = tlm.decode_lm_graph(use_kernel=True, **LM)
    node = _whole_graph_node(graph, graph.prepare(lm_params(graph), device),
                             device)
    _, caches = node._prefill_apply(
        torch.tensor([[1, 2, 3]], dtype=torch.int32, device=device))
    node.sessions.put("a", caches)
    rows = node._step_rows

    def step():
        wave = [(RowExtent(0, 0, 0, 1, session="a", pos=3, kind=K_STEP),
                 np.array([[4]], np.int32), node.sessions.get("a"))]
        outs, fails, _ = node._step_wave(wave, rows, node._exported[0])
        assert not fails, fails[0].error
        return outs[0][1][node._exported[0]]

    try:
        first = step()
        staging = node._staging
        assert staging is not None
        node.sessions.put("a", caches)      # the same step once more
        node._make_apply()
        assert node._staging is None
        assert np.array_equal(step(), first)
        assert node._staging is not staging
    finally:
        node.sessions.clear()
    captures = 2 if device.type == "cuda" else 0
    assert node.step_counts["step_graph_captures"] == captures


# -- served through the chain -------------------------------------------------

PROMPTS = [[1, 5, 9, 2], [3, 3, 7], [2, 8, 4, 6, 1], [11, 0, 5, 5],
           [7, 7], [4, 1, 0, 9, 9, 3], [10, 2, 2], [6, 5, 4, 3],
           [9, 8], [0, 1, 2, 3, 4], [5], [8, 8, 1]]


@pytest.fixture(scope="module")
def lm_cpu():
    graph = tlm.decode_lm_graph(use_kernel=True, **LM)
    return graph, lm_params(graph)


def _serve(eng, jobs, threads, **gen_kw):
    """``jobs`` (prompt, new tokens) served by ``threads`` client threads,
    each opening its next session when its last one ends.  Returns each
    job's tokens."""
    outs: list[list[int] | None] = [None] * len(jobs)
    errs: list[BaseException] = []
    lock = threading.Lock()
    todo = list(range(len(jobs)))

    def client():
        while True:
            with lock:
                if not todo or errs:
                    return
                i = todo.pop(0)
            try:
                outs[i] = list(eng.generate(jobs[i][0], jobs[i][1], **gen_kw))
            except BaseException as e:      # noqa: BLE001 - re-raised below
                errs.append(e)

    ts = [threading.Thread(target=client) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(300)
    assert not any(t.is_alive() for t in ts), "generation hung"
    if errs:
        raise errs[0]
    return outs


def _refs(graph, params, device, jobs):
    prep = graph.prepare(params, device)
    return [tlm.pipeline_decode_reference(graph, prep, p, m)
            for p, m in jobs]


def _replicas(eng):
    return [n for g in eng.dispatcher.stages for n in g.live_replicas()]


def _counted(eng) -> dict:
    per_node = eng.report().per_node
    return {k: sum(n[k] for n in per_node) for k in STEP_COUNTS}


@pytest.mark.parametrize("case", ["one", "waves_1_to_8", "evicted"])
def test_chain_tokens_equal_the_reference(lm_cpu, device, case):
    """One session alone; 12 sessions over 8 clients, of different lengths,
    so waves hold 1 to 8 sessions and sessions close and open between
    them; 6 clients over replicas that hold 3 sessions each, so sessions
    are evicted and re-prefilled.  Every step ran as the device's gate
    says, and the counters count it."""
    graph, params = lm_cpu
    jobs = [(p, 4 + (3 * i) % 9) for i, p in enumerate(PROMPTS)]
    threads, capacity = {"one": (1, 64), "waves_1_to_8": (8, 64),
                         "evicted": (6, 3)}[case]
    if case == "one":
        jobs = jobs[:1]
    topo = TopologySpec.chain(graph, 2, session_capacity=capacity)
    eng = InferenceEngine(graph, topo, CODECS, device=device)
    eng.configure(params)
    try:
        eng.start()
        got = _serve(eng, jobs, threads, restart="always")
        counts = _counted(eng)
        stagings = [n._staging for n in _replicas(eng)]
    finally:
        eng.shutdown()
    assert got == _refs(graph, params, device, jobs)
    graphed = device.type == "cuda"
    assert all(s is not None and s.graphed is graphed for s in stagings)
    steps = counts["step_graph_replays"] + counts["step_eager_steps"]
    assert steps >= 2 * (max(m for _, m in jobs) - 1)
    assert counts["step_graph_failures"] == 0
    assert counts["step_graph_captures"] == (len(stagings) if graphed else 0)
    if not graphed:
        assert counts["step_graph_replays"] == 0


def test_a_repartition_and_a_scaled_replica_capture_anew(lm_cpu, device):
    """After a live repartition every replica steps on a new staging (on
    a card, a new capture), and a replica that ``scale()`` spawns builds
    its own; tokens equal the reference throughout."""
    graph, params = lm_cpu
    jobs = [(p, 6) for p in PROMPTS[:4]]
    want = _refs(graph, params, device, jobs)
    eng = InferenceEngine(graph, TopologySpec.chain(graph, 2), CODECS,
                          device=device)
    eng.configure(params)
    graphed = device.type == "cuda"
    try:
        eng.start()
        assert _serve(eng, jobs, 4) == want
        before = {id(n): n._staging for n in _replicas(eng)}
        eng.dispatcher.reconfigure([2])
        assert _serve(eng, jobs, 4) == want
        for n in _replicas(eng):
            assert n._staging is not before[id(n)]
            assert n.step_counts["step_graph_captures"] == (2 if graphed
                                                            else 0)
        eng.scale(0, 2)
        assert _serve(eng, jobs, 4) == want
        fresh = [n for n in _replicas(eng) if id(n) not in before]
        assert len(fresh) == 1
        assert fresh[0].step_counts["step_eager_steps"] >= 1
        assert fresh[0].step_counts["step_graph_captures"] == (
            1 if graphed else 0)
        assert sum(n["step_graph_failures"]
                   for n in eng.report().per_node) == 0
    finally:
        eng.shutdown()


def test_every_window_step_is_counted_once(lm_cpu, device):
    """Three stages, the middle one on two replicas, eight sessions at
    once: the pair reaches its first steps while the other stages step.
    After the warm-up, each replica's steps in the window are its
    ``step.launch`` spans, all replays on a card (none eager), all eager on
    the CPU."""
    graph, params = lm_cpu
    topo = TopologySpec.chain(graph, 3).with_replicas(1, 2)
    jobs = [(p, 5) for p in PROMPTS[:8]]
    want = _refs(graph, params, device, jobs)
    eng = InferenceEngine(graph, topo, CODECS, device=device)
    eng.configure(params)
    graphed = device.type == "cuda"
    try:
        eng.start()
        assert _serve(eng, jobs, 8) == want           # warm-up
        eng.reset_window()
        eng.start_spans()
        assert _serve(eng, jobs, 8) == want
        spans = eng.stop_spans().spans
        per_node = eng.report().per_node
    finally:
        eng.shutdown()
    assert len(per_node) == 4
    for n in per_node:
        launched = sum(1 for s in spans if s.name.endswith(".step.launch")
                       and (s.stage, s.replica) == (n["stage"],
                                                    n["replica"]))
        assert launched > 0
        assert n["step_graph_failures"] == 0
        assert n["step_graph_captures"] == 0        # all in the warm-up
        ran, idle = (("step_graph_replays", "step_eager_steps") if graphed
                     else ("step_eager_steps", "step_graph_replays"))
        assert n[ran] == launched and n[idle] == 0
