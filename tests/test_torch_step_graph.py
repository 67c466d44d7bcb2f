"""A replica's session cache pool (``runtime/step_graph.py``): the decode
step's own buffers, eager on the CPU and replayed as one CUDA graph on a
card.

Driven as the chain frames it (opens, steps and closes through
``ComputeNode._decode_group``), over full caches and over ring caches
beside routed experts: a step served in place equals the stacked step it
replaced (the wave's slots stacked, pad rows repeating the last, the apply
run eagerly) bit for bit; every session's output and slot equal the
session's prefill stepped alone at the step's rows; rows not in a wave,
and empty slots, keep their caches bit for bit; a closed or evicted
session's slot is reused and overwritten whole; a replica with one session
more than a bank's rows grows a second bank, and a wave over both runs two
step applies; the replica's counters count.  Served through the chain,
greedy tokens equal ``pipeline_decode_reference`` through eviction, a live
repartition and a replica spawned by ``scale()``.

The ``cuda`` cases need a card and run there (this file imports no JAX):
``python -m pytest --noconftest -m cuda tests/test_torch_step_graph.py``;
there the first step over a bank captures its graph and later steps
replay it, each held against the eager steps above.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.graph import tree_flatten_with_path, tree_map
from repro_torch.kernels import decode_attention as da
from repro_torch.models import lm_graph as tlm
from repro_torch.runtime import (DispatcherCodecs, InferenceEngine,
                                 TopologySpec, WireCodec)
from repro_torch.runtime.node import STEP_COUNTS, ComputeNode, _Decoded
from repro_torch.runtime.session import live_session_stores
from repro_torch.runtime.wire import K_CLOSE, K_OPEN, K_STEP, RowExtent

torch.set_num_threads(1)

# 2 layers, GQA (4 query heads over 2 kv heads): 6 nodes
LM = dict(vocab=48, d_model=32, n_layers=2, num_heads=4, kv_heads=2,
          head_dim=8, d_ff=64, cache_len=48)
# a window layer's ring (8 slots) beside a full layer, routed experts
RING = dict(vocab=48, d_model=32,
            layer_types=("sliding_attention", "full_attention"),
            num_heads=4, kv_heads=2, head_dim=8, sliding_window=8,
            expert_d_ff=16, num_experts=4, top_k=2, experts_held=(0, 4),
            cache_len=48)
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
    """numpy params: norm scales 1, the embedding table ``~ N(0, 1)``,
    every other weight ``~ N(0, 1/fan_in)`` (fan_in its next-to-last
    axis)."""
    rng = np.random.default_rng(seed)
    params = {}
    for node in graph.nodes:
        p: dict = {}
        for path, spec in tree_flatten_with_path(node.param_spec):
            shape = tuple(spec.shape)
            if path[-1] == "scale":
                a = np.ones(shape, np.float32)
            elif path[-1] == "table":
                a = rng.standard_normal(shape, np.float32)
            else:
                a = rng.standard_normal(shape, np.float32) \
                    * np.float32(1 / np.sqrt(shape[-2]))
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


# -- the pool on one replica ------------------------------------------------

def _whole_graph_node(graph, prep, device) -> ComputeNode:
    """A replica serving the whole graph (one stage, the tail)."""
    node = ComputeNode(0, CODECS.data, device=device)
    node._graph = graph
    node._set_range(0, len(graph.nodes))
    node._params = prep
    node._make_apply()
    return node


def _frame(kind: int, sid: str, x: np.ndarray, pos: int) -> _Decoded:
    """One session frame as the ingress stage hands it on."""
    return _Decoded([RowExtent(0, sid, 0, 1, session=sid, pos=pos,
                               kind=kind)], {"": x}, 0.0)


def _rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    return t.repeat((rows,) + (1,) * (t.dim() - 1))


class Replica:
    """A replica serving the whole graph, driven through ``_decode_group``
    as the chain frames its sessions, beside each session's reference: its
    prefill's caches at the step's rows, stepped alone (every row the
    session's)."""

    def __init__(self, width: str, device: torch.device, seed: int = 7):
        cfg = {"smoke": LM, "full": LM, "ring": RING, "wide": WIDE}[width]
        self.graph = (tlm.decode_moe_lm_graph(use_kernel=True, **cfg)
                      if width == "ring"
                      else tlm.decode_lm_graph(use_kernel=True, **cfg))
        prep = (device_params(self.graph, device) if width == "wide"
                else self.graph.prepare(lm_params(self.graph), device))
        self.node = _whole_graph_node(self.graph, prep, device)
        self.device = device
        self.rows = self.node._step_rows
        self.out = self.node._exported[0]
        self.vocab = cfg["vocab"]
        self.max_prompt = min(cfg["cache_len"] - WAVES - 1, 600)
        self.rng = np.random.default_rng(seed)
        self.ref: dict[str, dict] = {}      # session -> caches at rows
        self.pos: dict[str, int] = {}       # session -> its next position

    def group(self, frames: list) -> tuple[list, list, int]:
        """One merged wave: (outputs, failures, step applies)."""
        outs, fails, _, padded = self.node._decode_group(frames)
        opened = sum(f.extents[0].kind == K_OPEN for f in frames)
        return outs, fails, (padded - opened) // self.rows

    def open(self, sid: str, n: int | None = None):
        """Open ``sid`` on a prompt of ``n`` tokens (drawn if None); its
        slot."""
        n = n or int(self.rng.integers(3, self.max_prompt))
        prompt = self.rng.integers(0, self.vocab, (1, n), dtype=np.int32)
        _, fails, _ = self.group([_frame(K_OPEN, sid, prompt, 0)])
        assert not fails, fails[0].error
        _, caches = self.node._prefill_apply(
            torch.from_numpy(prompt).to(self.device))
        self.ref[sid] = tree_map(lambda t: _rows(t, self.rows), caches)
        self.pos[sid] = n
        return self.slot(sid)

    def close(self, sid: str) -> None:
        _, fails, _ = self.group(
            [_frame(K_CLOSE, sid, np.zeros((1, 1), np.int32), 0)])
        assert not fails
        del self.ref[sid], self.pos[sid]

    def slot(self, sid: str):
        """``sid``'s slot (refreshing its LRU place)."""
        return self.node.sessions.get(sid)

    def frames(self, sids: list[str]) -> tuple[list, np.ndarray]:
        toks = self.rng.integers(0, self.vocab, (len(sids), 1),
                                 dtype=np.int32)
        return [_frame(K_STEP, s, toks[i:i + 1], self.pos[s])
                for i, s in enumerate(sids)], toks

    def step(self, sids: list[str]) -> int:
        """One wave of ``sids``' steps: each output equals its session's
        stepped alone.  Returns the step applies the wave ran."""
        frames, toks = self.frames(sids)
        outs, fails, applies = self.group(frames)
        assert not fails, fails[0].error
        got = {ext[0].session: o[self.out] for ext, o in outs}
        assert sorted(got) == sorted(sids)
        for i, s in enumerate(sids):
            x = torch.full((self.rows, 1), int(toks[i, 0]), dtype=torch.int32,
                           device=self.device)
            pos = torch.full((self.rows,), self.pos[s], dtype=torch.int32,
                             device=self.device)
            y, _ = self.node._decode_apply(self.ref[s], x, pos)
            assert np.array_equal(got[s], y[0:1].cpu().numpy()), s
            self.pos[s] += 1
        return applies

    def assert_slot_is_ref(self, sid: str) -> None:
        """``sid``'s slot holds its reference's caches bit for bit."""
        slot = self.slot(sid)
        want = dict(tree_flatten_with_path(self.ref[sid]))
        for path, t in tree_flatten_with_path(slot.bank.caches):
            assert torch.equal(t[slot.row], want[path][0]), (sid, path)

    def snapshot(self) -> list[list[torch.Tensor]]:
        return [[t.clone() for _, t in tree_flatten_with_path(b.caches)]
                for b in self.node._banks]

    def clear(self) -> None:
        self.node.sessions.clear()


def _stacked(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stacked([t[k] for t in trees]) for k in trees[0]}
    return torch.cat(trees, dim=0)


@pytest.mark.parametrize("width", ["smoke", "ring", pytest.param(
    "wide", marks=pytest.mark.cuda)])
def test_staged_steps_equal_the_stacked_step_bit_for_bit(device, width):
    """``WAVES`` waves of 1 to 8 sessions of one bank, a session closing
    and another opening in its slot every fifth wave: every session's
    output row and new caches in its slot equal the stacked step's (the
    wave's slots stacked, pad rows repeating the last row, the apply run
    eagerly), and every other row of the bank keeps its caches.  On a card
    the first wave captures the graph and the rest replay it, against the
    stacked step run eagerly; decode attention's counter counts the
    replays' launches."""
    if width == "wide" and device.type != "cuda":
        pytest.skip("StarCoder2-3B's widths run on the card only")
    r = Replica(width, device)
    node, rows = r.node, r.rows
    opened = 0

    def open_session():
        nonlocal opened
        r.open(f"s{opened}")
        opened += 1

    for _ in range(rows):
        open_session()
    launches = 0
    try:
        for w in range(WAVES):
            if w % 5 == 4:                  # one closes, one opens
                r.close(sorted(r.pos)[0])
                open_session()
            k = 1 + w % rows if w < rows else int(r.rng.integers(1, rows + 1))
            sids = [str(s) for s in r.rng.choice(sorted(r.pos), size=k,
                                                 replace=False)]
            slots = [r.slot(s) for s in sids]
            bank = slots[0].bank
            assert all(s.bank is bank for s in slots)
            frames, toks = r.frames(sids)
            pad = [slots[-1]] * (rows - k)
            x = np.concatenate([toks] + [toks[-1:]] * (rows - k))
            pos = [r.pos[s] for s in sids] + [r.pos[sids[-1]]] * (rows - k)
            with torch.inference_mode():
                want_y, want_new = node._decode_apply(
                    _stacked([tree_map(lambda t, i=s.row: t[i:i + 1].clone(),
                                       s.bank.caches) for s in slots + pad]),
                    torch.from_numpy(x).to(device),
                    torch.tensor(pos, dtype=torch.int32, device=device))
            want_y = want_y.cpu().numpy()
            before = r.snapshot()
            n0 = da.launches["decode_attention"]
            outs, fails, applies = r.group(frames)
            launches += da.launches["decode_attention"] - n0
            assert not fails, fails[0].error
            assert applies == 1
            got = {ext[0].session: o[r.out] for ext, o in outs}
            for i, (s, slot) in enumerate(zip(sids, slots)):
                assert np.array_equal(got[s], want_y[i:i + 1]), (w, s)
                for path, t in tree_flatten_with_path(want_new):
                    mine = dict(tree_flatten_with_path(bank.caches))[path]
                    assert torch.equal(mine[slot.row], t[i]), (w, path)
                r.pos[s] += 1
            live = {s.row for s in slots}
            for old, (_, new) in zip(before[0],
                                     tree_flatten_with_path(bank.caches)):
                for row in set(range(rows)) - live:
                    assert torch.equal(old[row], new[row]), (w, row)
    finally:
        r.clear()
    counts = node.step_counts
    graphed = device.type == "cuda"
    assert len(node._banks) == 1 and node._banks[0].graphed is graphed
    assert {k: counts[k] for k in STEP_COUNTS[:4]} == {
        "step_graph_replays": WAVES - 1 if graphed else 0,
        "step_eager_steps": 1 if graphed else WAVES,
        "step_graph_captures": 1 if graphed else 0,
        "step_graph_failures": 0}
    attn = sum(n.name.endswith("_attn") for n in r.graph.nodes)
    assert launches == (WAVES * attn if graphed else 0)


@pytest.mark.parametrize("caches", ["full", "ring"])
def test_each_slot_equals_its_session_stepped_alone(device, caches):
    """Five sessions of different lengths, twelve waves of random subsets
    of them: each output equals the session's prefill stepped alone, and
    after the waves each session's slot holds its reference's caches bit
    for bit (on a card, replays against eager steps)."""
    r = Replica(caches, device)
    sids = [f"s{i}" for i in range(5)]
    try:
        for s in sids:
            r.open(s)
        for _ in range(12):
            k = int(r.rng.integers(1, len(sids) + 1))
            r.step([str(s) for s in r.rng.choice(sids, size=k,
                                                 replace=False)])
        for s in sids:
            r.assert_slot_is_ref(s)
    finally:
        r.clear()


@pytest.mark.parametrize("caches", ["full", "ring"])
def test_rows_not_stepped_and_empty_slots_keep_their_caches(device, caches):
    """Three sessions open and the middle one closes, so its row is empty
    but holds what it held: stepping the first alone, then the first and
    the third, leaves every other row of the bank bit for bit as it was
    (``k``, ``v`` and ``kpos``; the empty rows too)."""
    r = Replica(caches, device)
    try:
        rows = [r.open(s).row for s in ("a", "b", "c")]
        assert rows == [0, 1, 2]
        r.close("b")
        before = r.snapshot()
        for _ in range(3):
            r.step(["a"])
        after = r.snapshot()
        for old, new in zip(before[0], after[0]):
            assert not torch.equal(old[0], new[0])
            assert torch.equal(old[1:], new[1:])
        r.step(["a", "c"])
        r.step(["c", "a"])
        for old, new in zip(after[0], r.snapshot()[0]):
            assert torch.equal(old[1], new[1])
            assert torch.equal(old[3:], new[3:])
        r.assert_slot_is_ref("a")
        r.assert_slot_is_ref("c")
    finally:
        r.clear()


@pytest.mark.parametrize("caches", ["full", "ring"])
@pytest.mark.parametrize("how", ["closed", "evicted"])
def test_a_released_slot_is_reused_and_overwritten_whole(device, caches,
                                                          how):
    """``b`` leaves its slot (a close, or an LRU eviction at capacity 2
    when ``c`` opens); ``c`` takes that very slot, which then holds ``c``'s
    prefill whole, and steps as its reference; an evicted ``b`` steps into
    ``SessionLost``."""
    r = Replica(caches, device)
    try:
        a, b = r.open("a", r.max_prompt - 1), r.open("b", r.max_prompt - 2)
        r.step(["a", "b"])
        r.step(["a"])                       # b is the least recently stepped
        if how == "closed":
            r.close("b")
        else:
            r.node.sessions.capacity = 2
        c = r.open("c", 3)                  # far shorter: every slot is new
        assert (c.bank, c.row) == (b.bank, b.row) and a.bank is c.bank
        assert sorted(r.node.sessions.keys()) == ["a", "c"]
        r.assert_slot_is_ref("c")
        r.step(["c", "a"])
        r.assert_slot_is_ref("c")
        r.assert_slot_is_ref("a")
        if how == "evicted":
            frames, _ = r.frames(["b"])
            outs, fails, applies = r.group(frames)
            assert not outs and applies == 0
            assert "SessionLost" in fails[0].error
    finally:
        r.clear()
    assert r.node.step_counts["pool_banks"] == 1


@pytest.mark.parametrize("caches", ["full", "ring"])
def test_a_bank_grows_past_its_rows_and_a_wave_spans_both(device, caches):
    """One session more than a bank's rows: the last opens in row 0 of a
    second bank (on a card, with a graph of its own); a wave of every
    session runs two step applies, a wave of the first bank's one, and
    every output equals its session's stepped alone."""
    r = Replica(caches, device)
    sids = [f"s{i}" for i in range(r.rows + 1)]
    graphed = device.type == "cuda"
    try:
        slots = [r.open(s) for s in sids]
        assert len(r.node._banks) == 2
        first, second = r.node._banks
        assert [s.bank for s in slots] == [first] * r.rows + [second]
        assert [s.row for s in slots] == list(range(r.rows)) + [0]
        assert r.step(sids) == 2
        assert r.step(sids[:3]) == 1
        assert r.step(sids[-2:]) == 2
        assert r.step(sids[::-1]) == 2
        for s in sids:
            r.assert_slot_is_ref(s)
    finally:
        r.clear()
    counts = r.node.step_counts
    assert counts["pool_banks"] == 2
    assert counts["step_graph_replays"] + counts["step_eager_steps"] == 7
    assert counts["step_graph_captures"] == (2 if graphed else 0)


@pytest.mark.parametrize("caches", ["full", "ring"])
def test_the_pool_counters_count(device, caches):
    """``pool_banks`` counts banks allocated, ``pool_fills`` prefills
    copied into a slot, ``step_live_rows`` the sessions a step served and
    ``step_rows_run`` the rows it ran, over the window: ``reset_stats``
    starts them again."""
    r = Replica(caches, device)
    node = r.node
    pool = ("pool_banks", "pool_fills", "step_live_rows", "step_rows_run")
    try:
        for s in ("a", "b", "c"):
            r.open(s)
        assert [node.step_counts[k] for k in pool] == [1, 3, 0, 0]
        for wave in (["a", "b", "c"], ["b"], ["c", "a"]):
            r.step(wave)
        assert [node.step_counts[k] for k in pool] == [1, 3, 6, 3 * r.rows]
        node.reset_stats()
        r.close("b")
        r.open("d")
        r.step(["d", "a"])
        assert [node.step_counts[k] for k in pool] == [0, 1, 2, r.rows]
    finally:
        r.clear()


@pytest.mark.parametrize("caches", ["full", "ring"])
def test_a_session_twice_in_a_group_steps_twice_in_order(device, caches):
    """Two steps of one session in one merged group (and one of another
    session): each slot is stepped once an apply, so the group runs two
    applies, the second on the first's caches, as the session stepped
    alone twice."""
    r = Replica(caches, device)
    try:
        r.open("a")
        r.open("b")
        (fa, fb), toks = r.frames(["a", "b"])
        second = _frame(K_STEP, "a", toks[:1] + 1, r.pos["a"] + 1)
        outs, fails, applies = r.group([fa, fb, second])
        assert not fails and applies == 2
        got = [o[r.out] for ext, o in outs if ext[0].session == "a"]
        for x, y in zip((toks[0, 0], toks[0, 0] + 1), got):
            want, _ = r.node._decode_apply(
                r.ref["a"],
                torch.full((r.rows, 1), int(x), dtype=torch.int32,
                           device=device),
                torch.full((r.rows,), r.pos["a"], dtype=torch.int32,
                           device=device))
            assert np.array_equal(y, want[0:1].cpu().numpy())
            r.pos["a"] += 1
        r.assert_slot_is_ref("a")
    finally:
        r.clear()


def test_a_failed_step_drops_its_sessions(device):
    """A step that raises (here an input the bank was not built for)
    leaves its sessions' caches undefined: they are released, so their
    next steps fail with ``SessionLost`` and re-prefill, while a session
    of another wave steps on."""
    r = Replica("full", device)
    try:
        r.open("a")
        r.open("b")
        bad = _frame(K_STEP, "a", np.zeros((1, 1), np.float32), r.pos["a"])
        outs, fails, _ = r.group([bad])
        assert not outs and "does not fit" in fails[0].error
        assert r.node.sessions.keys() == ["b"]
        frames, _ = r.frames(["a"])
        assert "SessionLost" in r.group(frames)[1][0].error
        r.step(["b"])
        r.assert_slot_is_ref("b")
    finally:
        r.clear()


def test_make_apply_drops_the_staging(device):
    """New params or layers never replay an old graph: ``_make_apply``
    drops the pool and the sessions holding its slots, and the next open
    builds a new bank (on a card, captured anew) whose step equals the
    session stepped alone."""
    r = Replica("full", device)
    node = r.node
    try:
        r.open("a", 3)
        r.step(["a"])
        bank = node._banks[0]
        node._make_apply()
        assert node._banks == [] and len(node.sessions) == 0
        r.open("a", 3)
        r.step(["a"])
        assert node._banks[0] is not bank
    finally:
        r.clear()
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
    are evicted and re-prefilled.  Every replica holds one bank (no more
    than 8 sessions at once), every step ran as the device's gate says,
    and the counters count it."""
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
        pools = [n._banks for n in _replicas(eng)]
    finally:
        eng.shutdown()
    assert got == _refs(graph, params, device, jobs)
    graphed = device.type == "cuda"
    assert all(len(p) == 1 and p[0].graphed is graphed for p in pools)
    steps = counts["step_graph_replays"] + counts["step_eager_steps"]
    assert steps >= 2 * (max(m for _, m in jobs) - 1)
    assert counts["step_graph_failures"] == 0
    assert counts["step_graph_captures"] == (len(pools) if graphed else 0)
    if not graphed:
        assert counts["step_graph_replays"] == 0
    assert counts["pool_banks"] == len(pools)
    assert counts["pool_fills"] >= len(pools) * len(jobs)
    assert counts["step_rows_run"] == 8 * steps
    # each token after a session's first is a step at each of the two
    # stages, where no eviction made the session re-prefill instead
    served = 2 * sum(m - 1 for _, m in jobs)
    if case == "evicted":
        assert 0 < counts["step_live_rows"] <= served
    else:
        assert counts["step_live_rows"] == served


def test_a_repartition_and_a_scaled_replica_capture_anew(lm_cpu, device):
    """After a live repartition every replica steps on a new pool (on a
    card, a new capture), and a replica that ``scale()`` spawns builds its
    own; tokens equal the reference throughout."""
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
        before = {id(n): n._banks[0] for n in _replicas(eng)}
        eng.dispatcher.reconfigure([2])
        assert _serve(eng, jobs, 4) == want
        for n in _replicas(eng):
            assert len(n._banks) == 1 and n._banks[0] is not before[id(n)]
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
    the CPU; its live rows are the sessions those spans served, its rows
    run 8 a step, and each stage's replicas filled a slot for each
    session, in the banks of the warm-up."""
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
        assert n["step_live_rows"] == sum(
            len(s.sessions) for s in spans if s.name.endswith(".step.launch")
            and (s.stage, s.replica) == (n["stage"], n["replica"]))
        assert n["step_rows_run"] == 8 * launched
        assert n["pool_banks"] == 0
    for stage in range(3):
        assert sum(n["pool_fills"] for n in per_node
                   if n["stage"] == stage) == len(jobs)
