"""Mellum2-12B-A2.5B's block served through DEFER's chain
(``lm_graph.decode_moe_lm_graph``): window and full attention layers, YaRN
on the full ones, and routed experts of which a contiguous share is held.

At smoke width on the CPU: tokens served by ``generate`` through a 2-stage
chain against the plain reference's full forward
(``bench/reference/mellum2.py``) and bit for bit against
``pipeline_decode_reference``; a ring's contents after prefill; the
held shares of one expert layer adding up to the uncut layer; YaRN's
frequencies against the published formula; and no dropped assignment at
any routing.  The ``cuda`` case runs one period at the published widths on
the card (this file imports no JAX): ``python -m pytest --noconftest -m
cuda tests/test_torch_mellum2.py``.
"""
import functools
import math
import threading

import numpy as np
import pytest
import torch

from bench.reference import mellum2 as ref
from repro_torch.core.graph import StepRows, step_rows, tree_flatten_with_path
from repro_torch.models import lm_graph as tlm
from repro_torch.models import moe
from repro_torch.models.attention import AttnSpec, attention_kv
from repro_torch.models.layers import Yarn, rope_freqs
from repro_torch.runtime import (DispatcherCodecs, InferenceEngine,
                                 TopologySpec, WireCodec)
from repro_torch.runtime.session import live_session_stores
from repro_torch.runtime.wire import K_OPEN, K_STEP

torch.set_num_threads(1)

YARN = {"rope_type": "yarn", "rope_theta": 1e4, "factor": 4.0,
        "original_max_position_embeddings": 64, "beta_fast": 32,
        "beta_slow": 1, "attention_factor": 0.1 * math.log(4.0) + 1}
ROPE = {"full_attention": YARN,
        "sliding_attention": {"rope_type": "default", "rope_theta": 1e4}}
KINDS = ["sliding_attention"] * 3 + ["full_attention"]
# the smoke model: d 64, one period (s, s, s, f) with a window of 8,
# 8 experts top-2, YaRN on the full layer
SMOKE = dict(vocab=96, d_model=64, layer_types=KINDS, num_heads=4,
             kv_heads=2, head_dim=16, sliding_window=8, rope_parameters=ROPE,
             expert_d_ff=32, num_experts=8, top_k=2, eps=1e-6, cache_len=64)
CODECS = DispatcherCodecs(data=WireCodec("raw", "none"),
                          weights=WireCodec("raw", "none"))
# the reference's configuration keys for SMOKE
REF_CFG = dict(rms_norm_eps=1e-6, head_dim=16, num_attention_heads=4,
               num_key_value_heads=2, num_experts_per_tok=2,
               layer_types=KINDS, rope_parameters=ROPE, sliding_window=8)
# f32 throughout: the chain and the reference sum in other orders (a
# chunked softmax over a ring against one over the whole row, 8-row step
# GEMMs against S-row ones, every held expert over every row against each
# over its own tokens); over one period at d 64 they differ by ~1e-6 of
# the largest logit.  A ring slot off by one or an assignment dropped
# moves the logits by ~1e-1 of it (bench/tests/test_bench_mellum2.py).
REL_TOL = 1e-5


@pytest.fixture(autouse=True)
def _no_port_session_residue():
    yield
    residue = {id(s): s.keys() for s in live_session_stores() if len(s)}
    assert not residue, f"leaked resident decode-session caches: {residue}"


def draw_params(graph, seed: int = 0) -> dict:
    """numpy params: norm scales U(0.5, 1.5), the embedding N(0, 1), every
    other weight N(0, 1/fan_in) (fan_in its next-to-last axis)."""
    rng = np.random.default_rng(seed)
    params = {}
    for node in graph.nodes:
        p: dict = {}
        for path, spec in tree_flatten_with_path(node.param_spec):
            shape = tuple(spec.shape)
            if path[-1] == "scale":
                a = rng.uniform(0.5, 1.5, shape)
            elif path[-1] == "table":
                a = rng.standard_normal(shape)
            else:
                a = rng.standard_normal(shape) / np.sqrt(shape[-2])
            d = p
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = a.astype(np.float32)
        params[node.name] = p
    return params


def _torch_tree(tree):
    return {k: (_torch_tree(v) if isinstance(v, dict)
                else torch.from_numpy(v)) for k, v in tree.items()}


def _serve_recording(eng, jobs):
    """Each job (prompt, new tokens) through ``generate`` on its own
    thread; (tokens, [logits of each served token]) per job."""
    logits: dict[str, list] = {}
    submit = eng.dispatcher.submit

    def recording(x, client_id=0, **kw):
        fut = submit(x, client_id=client_id, **kw)
        if kw.get("session_kind") in (K_OPEN, K_STEP):
            out = logits.setdefault(kw["session"], [])
            fut.add_done_callback(lambda f: out.append(
                np.asarray(f.result()).reshape(-1)))
        return fut
    eng.dispatcher.submit = recording
    toks: list = [None] * len(jobs)

    def run(i):
        toks[i] = list(eng.generate(jobs[i][0], jobs[i][1],
                                    session_id=f"job{i}"))
    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(jobs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(300)
    return [(toks[i], np.stack(logits[f"job{i}"])) for i in range(len(jobs))]


@pytest.mark.parametrize("held", [(0, 8), (2, 4)])
def test_served_logits_equal_the_reference_past_the_window(held):
    """Prompts of 20 to 30 tokens (past the window of 8: every ring wraps
    at prefill), decoding 14 tokens across further wraps, 4 sessions at
    once through a 2-stage chain: every served token's logits against
    the reference's full forward, and the tokens bit for bit against
    ``pipeline_decode_reference``; no assignment dropped."""
    graph = tlm.decode_moe_lm_graph(experts_held=held, **SMOKE)
    params = draw_params(graph)
    rng = np.random.default_rng(3)
    jobs = [(rng.integers(0, 96, n).tolist(), 14) for n in (20, 23, 27, 30)]
    eng = InferenceEngine(graph, TopologySpec.chain(graph, 2), CODECS,
                          device="cpu")
    eng.configure(params)
    try:
        eng.start()
        got = _serve_recording(eng, jobs)
        per_node = eng.report().per_node
    finally:
        eng.shutdown()
    prep = graph.prepare(params, "cpu")
    tp = _torch_tree(params)
    cfg = dict(REF_CFG, experts_first_held=held[0])
    for (prompt, n), (toks, y) in zip(jobs, got):
        assert toks == tlm.pipeline_decode_reference(graph, prep, prompt, n)
        z = ref.forward(tp, torch.tensor(prompt + toks), cfg)
        z = z[len(prompt) - 1:len(prompt) - 1 + n].numpy()
        err = np.abs(y - z).max(axis=1) / np.abs(z).max(axis=1)
        assert err.max() < REL_TOL, err.max()
    assert all(not any(n["moe_dropped"].values()) for n in per_node)
    assert sum(n["prefill_tokens"] for n in per_node if n["stage"] == 0) \
        == sum(len(p) for p, _ in jobs)


@pytest.mark.parametrize("q_chunk", [1024, 6])
@pytest.mark.parametrize("S", [5, 8, 21, 40])
def test_a_ring_holds_the_last_window_positions_after_prefill(S, q_chunk):
    """A sliding layer's prefill leaves slot p % 8 holding position p's
    key and value for the prompt's last 8 positions (all of a shorter
    prompt, the other slots empty), as a full attention pass computes
    them.  Attended a query chunk of 6 at a time (21 and 40 leave a
    shorter last chunk), its output is the one-chunk pass's to rounding."""
    spec = AttnSpec(d_model=64, num_heads=4, kv_heads=2, head_dim=16,
                    rope_theta=1e4, window=8, q_chunk=q_chunk)
    graph = tlm.decode_moe_lm_graph(**SMOKE)
    p = graph.prepare(draw_params(graph), "cpu")["blk0_attn"]
    x = torch.randn(1, S, 64, generator=torch.Generator().manual_seed(S))
    _, prefill, _ = tlm._attn_nodes(spec, 8, False, 1e-6)
    y, cache = prefill(p, x)
    one = AttnSpec(d_model=64, num_heads=4, kv_heads=2, head_dim=16,
                   rope_theta=1e4, window=8)
    y1, k, v = attention_kv(p, one, x, torch.arange(S)[None], 1e-6)
    torch.testing.assert_close(y, y1, rtol=0, atol=1e-5)
    kept = list(range(max(S - 8, 0), S))
    want = [-1] * 8
    for pos in kept:
        want[pos % 8] = pos
        assert torch.equal(cache["k"][0, pos % 8], k[0, pos])
        assert torch.equal(cache["v"][0, pos % 8], v[0, pos])
    assert cache["kpos"][0].tolist() == want
    for slot in set(range(8)) - {pos % 8 for pos in kept}:
        assert not cache["k"][0, slot].any()


def _layer_params(n_held: int, first: int, full: dict):
    """The held share [first, first + n_held) of an uncut layer ``full``."""
    return {"ln": full["ln"], "router": full["router"],
            **{k: full[k][first:first + n_held]
               for k in ("gate", "up", "down")}}


@pytest.mark.parametrize("path", ["prefill", "step"])
def test_the_held_shares_add_up_to_the_uncut_layer(path):
    """Held sets {0-3} and {4-7} of an 8-expert top-2 layer: their parts
    of the result (each the layer's output less the residual), with the
    residual counted once, add up to the uncut reference layer."""
    g = torch.Generator().manual_seed(5)
    d, f, E = 64, 32, 8
    full = {"ln": {"scale": torch.rand(d, generator=g) + 0.5},
            "router": torch.randn(d, E, generator=g) / 8,
            "gate": torch.randn(E, d, f, generator=g) / 8,
            "up": torch.randn(E, d, f, generator=g) / 8,
            "down": torch.randn(E, f, d, generator=g) / math.sqrt(f)}
    x = torch.randn(8, 1, d, generator=g) if path == "step" \
        else torch.randn(1, 13, d, generator=g)
    parts = []
    for first in (0, 4):
        p = _layer_params(4, first, full)
        y = (moe.held_experts_step(p, x, 2, first, "l", 1e-6)
             if path == "step" else moe.held_experts(p, x, 2, first, 1e-6))
        parts.append(y - x)
    whole = x + parts[0] + parts[1]
    flat = x.reshape(-1, d)
    want = flat + ref.experts(full, flat, 2, 0, 1e-6)
    torch.testing.assert_close(whole.reshape(-1, d), want, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("head_dim, theta, factor, original", [
    (16, 1e4, 4.0, 64), (128, 5e5, 16.0, 8192), (64, 1e6, 8.0, 4096)])
def test_yarn_frequencies_follow_the_published_formula(head_dim, theta,
                                                       factor, original):
    """YaRN (Peng et al. 2023, as Hugging Face transformers computes it):
    dimension pair j keeps theta^(-2j/hd) below the correction range, is
    divided by ``factor`` above it, and ramps linearly between
    floor(D(32)) and ceil(D(1)), D(t) = hd ln(L / (2 pi t)) / (2 ln
    theta).  Computed here in float64 from the formula."""
    def dims(t):
        return head_dim * math.log(original / (2 * math.pi * t)) \
            / (2 * math.log(theta))
    lo, hi = max(math.floor(dims(32)), 0), min(math.ceil(dims(1)),
                                                head_dim - 1)
    want = []
    for j in range(head_dim // 2):
        w = theta ** (-2 * j / head_dim)
        r = min(max((j - lo) / max(hi - lo, 1e-3), 0.0), 1.0)
        want.append(w / factor * r + w * (1 - r))
    yarn = Yarn(factor, original, 32.0, 1.0, 1.0)
    got = rope_freqs(head_dim, theta, yarn=yarn).double().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6)
    rope = {"rope_type": "yarn", "rope_theta": theta, "factor": factor,
            "original_max_position_embeddings": original, "beta_fast": 32,
            "beta_slow": 1, "attention_factor": 1.25}
    w, scale = ref.rope_frequencies(rope, head_dim)
    np.testing.assert_allclose(w.double().numpy(), want, rtol=2e-6)
    assert scale == 1.25
    assert tlm._rope(rope)[1] == Yarn(factor, original, 32.0, 1.0, 1.25)


@pytest.mark.parametrize("routing", ["all_to_one", "seeded", "none_held"])
def test_no_assignment_drops_at_any_routing(routing):
    """8 rows, 2 of them padding: all routed to held expert 2 (then 1),
    routed by a seeded router, or all to experts not held.  The step's
    tally counts each live row once per held expert it chose, drops none,
    and the step equals the gather path on the live rows."""
    g = torch.Generator().manual_seed(9)
    d, f, E, first, n = 64, 32, 8, 0, 4
    p = {"ln": {"scale": torch.ones(d)},
         "router": torch.randn(d, E, generator=g),
         "gate": torch.randn(n, d, f, generator=g) / 8,
         "up": torch.randn(n, d, f, generator=g) / 8,
         "down": torch.randn(n, f, d, generator=g) / 8}
    x = torch.randn(8, 1, d, generator=g)
    if routing != "seeded":
        # the router sees only the row's sign of a constant: every row
        # picks the same two experts
        x = x.abs() + 1.0
        pick = [2, 1] if routing == "all_to_one" else [6, 7]
        p["router"] = torch.zeros(d, E)
        p["router"][:, pick[0]] = 1.0
        p["router"][:, pick[1]] = 0.5
    live = torch.tensor([1] * 6 + [0] * 2, dtype=torch.int32)
    rows = StepRows(live, {})
    with step_rows(rows):
        y = moe.held_experts_step(p, x, 2, first, "l", 1e-6)
    h = moe.rmsnorm(p["ln"], x, 1e-6).reshape(8, d)
    idx, _ = moe.route_topk(p, h, 2)
    want = [sum(int((idx[r] == e).sum()) for r in range(6))
            for e in range(n)]
    tally = rows.tallies["moe_rows"]["l"].tolist()
    assert tally == want
    assert rows.tallies["moe_dropped"]["l"].item() == 0
    if routing == "all_to_one":
        assert tally == [0, 6, 6, 0]
    torch.testing.assert_close(y, moe.held_experts(p, x, 2, first, 1e-6),
                               rtol=0, atol=1e-5)


def test_an_assignment_weighted_by_zero_counts_as_dropped(monkeypatch):
    """The step's combine with row 0's weights zeroed: each of row 0's
    choices of a held expert counts in ``moe_dropped``, a pad row's
    do not."""
    g = torch.Generator().manual_seed(4)
    d, f, E, n = 64, 32, 8, 4
    p = {"ln": {"scale": torch.ones(d)},
         "router": torch.randn(d, E, generator=g),
         "gate": torch.randn(n, d, f, generator=g) / 8,
         "up": torch.randn(n, d, f, generator=g) / 8,
         "down": torch.randn(n, f, d, generator=g) / 8}
    x = torch.randn(8, 1, d, generator=g)
    real = moe.combine_weights

    def zeroing(col, gates, n, rows=(0, 7)):
        w = real(col, gates, n).clone()
        w[list(rows)] = 0.0
        return w
    monkeypatch.setattr(moe, "combine_weights", zeroing)
    live = torch.tensor([1] * 7 + [0], dtype=torch.int32)
    rows = StepRows(live, {})
    with step_rows(rows):
        moe.held_experts_step(p, x, 2, 0, "l", 1e-6)
    idx, _ = moe.route_topk(p, moe.rmsnorm(p["ln"], x, 1e-6).reshape(8, d),
                            2)
    want = int((idx[0] < n).sum())
    assert want > 0
    assert rows.tallies["moe_dropped"]["l"].item() == want


def test_the_capacity_check_binds_the_full_layers_only():
    """A session may run past a ring's slots (8) but not past the full
    layers' cache (64)."""
    graph = tlm.decode_moe_lm_graph(**SMOKE)
    assert graph.decode_cache_len == 64
    eng = InferenceEngine(graph, TopologySpec.chain(graph, 1), CODECS,
                          device="cpu")
    eng.configure(draw_params(graph))
    try:
        eng.start()
        assert len(list(eng.generate(list(range(40)), 24))) == 24
        with pytest.raises(ValueError, match="KV capacity"):
            list(eng.generate(list(range(40)), 25))
    finally:
        eng.shutdown()


# -- at the published widths, on the card ------------------------------------

PUBLISHED = dict(vocab=98304, d_model=2304, layer_types=KINDS,
                 num_heads=32, kv_heads=4, head_dim=128, sliding_window=1024,
                 rope_parameters={
                     "full_attention": {
                         "rope_type": "yarn", "rope_theta": 500000,
                         "factor": 16, "original_max_position_embeddings":
                         8192, "beta_fast": 32, "beta_slow": 1,
                         "attention_factor": 1.2772588722239782},
                     "sliding_attention": {"rope_type": "default",
                                           "rope_theta": 500000}},
                 expert_d_ff=896, num_experts=64, top_k=8,
                 experts_held=(0, 32), eps=1e-6, cache_len=8192)
WAVES = 24


@pytest.mark.parametrize("width", ["smoke", pytest.param(
    "published", marks=pytest.mark.cuda)])
def test_staged_steps_equal_the_eager_step_and_count_the_routing(width):
    """One period, prompts past the rings: ``WAVES`` waves of 1 to 8
    sessions of one bank of the replica's pool, a session closing and
    another opening in its slot every fifth wave.  Each step, in place in
    the slots, equals the eager step over the wave's slots stacked bit for
    bit (outputs and caches), the pool counts its fills and rows, the
    replica's ``moe_rows`` tally equals a host recount of the routing of
    the live rows, and nothing drops.  At the published widths on the card (32 of
    64 experts held, 8,192-slot full caches, 1,024-slot rings) the first
    step captures the graph, every later one replays it, and no capture
    fails."""
    from repro_torch.runtime.node import ComputeNode
    from repro_torch.runtime.wire import RowExtent
    if width == "published" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0) if width == "published" else \
        torch.device("cpu")
    cfg = PUBLISHED if width == "published" else dict(
        SMOKE, experts_held=(2, 4))
    first, held = cfg["experts_held"]
    vocab, top_k = cfg["vocab"], cfg["top_k"]
    window = cfg["sliding_window"]
    graph = tlm.decode_moe_lm_graph(use_kernel=True, **cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {}
    for node in graph.nodes:
        p: dict = {}
        for path, spec in tree_flatten_with_path(node.param_spec):
            shape = tuple(spec.shape)
            a = (torch.rand(shape, generator=gen, device=dev) + 0.5
                 if path[-1] == "scale" else
                 torch.randn(shape, generator=gen, device=dev)
                 / (1.0 if path[-1] == "table" else math.sqrt(shape[-2])))
            d = p
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = a
        params[node.name] = p
    node = ComputeNode(0, CODECS.data, device=dev)
    node._graph = graph
    node._set_range(0, len(graph.nodes))
    node._params = params
    node._make_apply()
    rows, out_name = node._step_rows, node._exported[0]
    rng = np.random.default_rng(7)
    live: dict[str, int] = {}
    opened = 0
    recount = {f"blk{i}_mlp": np.zeros(held, np.int64) for i in range(4)}

    def open_session():
        nonlocal opened
        sid = f"s{opened}"
        opened += 1
        n = int(rng.integers(window + 1, 3 * window))
        prompt = rng.integers(0, vocab, (1, n), dtype=np.int32)
        _, caches = node._prefill_apply(torch.from_numpy(prompt).to(dev))
        node.sessions.open(sid, functools.partial(
            node._take_slot, caches, prompt[:, :1]))
        live[sid] = n

    for _ in range(rows):
        open_session()
    steps = 0
    try:
        for w in range(WAVES):
            if w % 5 == 4:                  # one closes, one opens its slot
                gone = sorted(live)[0]
                node.sessions.pop(gone)
                del live[gone]
                open_session()
            k = 1 + w % rows if w < rows else int(rng.integers(1, rows + 1))
            sids = list(rng.choice(sorted(live), size=k, replace=False))
            toks = rng.integers(0, vocab, (k, 1), dtype=np.int32)
            wave = [(RowExtent(i, 0, i, 1, session=s, pos=live[s],
                               kind=K_STEP), toks[i:i + 1],
                     node.sessions.get(s)) for i, s in enumerate(sids)]
            pad = [wave[-1]] * (rows - k)
            batch = wave + pad
            stacked = {name: {leaf: torch.cat(
                [c.bank.caches[name][leaf][c.row:c.row + 1]
                 for _, _, c in batch]) for leaf in ("k", "v", "kpos")}
                for name in wave[0][2].bank.caches
                if wave[0][2].bank.caches[name]}
            x = torch.from_numpy(np.concatenate([t for _, t, _ in batch]))
            pos = torch.tensor([e.pos for e, _, _ in batch],
                               dtype=torch.int32, device=dev)
            # the routing of the live rows, recounted on the host
            seen = {}
            with torch.inference_mode():
                acts = x.to(dev)
                want_new = {}
                for gn in graph.nodes:
                    gp = params[gn.name]
                    if gn.name.endswith("_mlp"):
                        h = moe.rmsnorm(gp["ln"], acts, 1e-6).reshape(rows, -1)
                        idx, _ = moe.route_topk(gp, h, top_k)
                        seen[gn.name] = idx[:k].cpu().numpy()
                    if gn.decode is not None:
                        acts, want_new[gn.name] = gn.decode.step_fn(
                            gp, stacked.get(gn.name, {}), acts, pos)
                    else:
                        acts = gn.fn(gp, acts)
                want_y = acts.cpu().numpy()
            for name, idx in seen.items():
                mine = idx[(idx >= first) & (idx < first + held)] - first
                recount[name] += np.bincount(mine, minlength=held)
            outs, fails, _ = node._step_wave(wave, out_name)
            steps += k
            assert not fails, fails[0].error
            for i, ((e, _, c), (ext, got)) in enumerate(zip(wave, outs)):
                assert np.array_equal(got[out_name], want_y[i:i + 1]), w
                mine = dict(tree_flatten_with_path(c.bank.caches))
                for path, t in tree_flatten_with_path(want_new):
                    assert torch.equal(mine[path][c.row], t[i]), (w, path)
                live[e.session] += 1
    finally:
        node.sessions.clear()
    graphed = dev.type == "cuda"
    assert len(node._banks) == 1 and node._banks[0].graphed is graphed
    assert node.window.step_counts == {
        "step_graph_replays": WAVES - 1 if graphed else 0,
        "step_eager_steps": 1 if graphed else WAVES,
        "step_graph_captures": 1 if graphed else 0,
        "step_graph_failures": 0,
        "pool_banks": 1, "pool_fills": opened,
        "step_live_rows": steps, "step_rows_run": WAVES * rows,
        "step_holds": 0, "step_hold_joins": 0}
    tallies, _ = node.window_report()
    for name, counts in recount.items():
        assert tallies["moe_rows"][name] == counts.tolist(), name
        assert tallies["moe_dropped"][name] == 0, name
