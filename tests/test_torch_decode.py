"""Slice C end to end on the CPU: the decode-capable LM graph in the port
against the JAX package's, and autoregressive decode served through the
port's dispatcher -> compute-node chain (inproc and tcp, a replicated
stage, live scale() and reconfigure(), LRU eviction), its greedy tokens
held bit for bit against the port's ``pipeline_decode_reference`` and
equal to the JAX package's on the same weights.

Weights are numpy, made from a seed (fan-in scaled, so the logits are
not degenerate), and carried into both packages.  Every engine is built
with ``device="cpu"``.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm_graph as jlm
from repro_torch.core.graph import tree_flatten_with_path
from repro_torch.models import cnn as tcnn
from repro_torch.models import lm_graph as tlm
from repro_torch.runtime import (DispatcherCodecs, InferenceEngine,
                                 TopologySpec, WireCodec)
from repro_torch.runtime.dispatcher import RetryPolicy
from repro_torch.runtime.session import SessionLost, live_session_stores

torch.set_num_threads(1)

# 2 layers, GQA (4 query heads over 2 kv heads): 6 nodes
LM = dict(vocab=48, d_model=32, n_layers=2, num_heads=4, kv_heads=2,
          head_dim=8, d_ff=64, cache_len=48)
# lossless data path so greedy decode is bit-identical across hops; the
# bypass threshold exercises the small-frame fast path on every step
DATA = WireCodec("raw", "lz4", small_bypass=4096)
CODECS = DispatcherCodecs(data=DATA, weights=WireCodec("raw", "none"))
PROMPTS = [[1, 5, 9, 2], [3, 3, 7], [2, 8, 4, 6, 1], [11, 0, 5, 5]]
LOGIT_ATOL = 1e-5       # prefill logits, port vs JAX (f32, 2 layers)


@pytest.fixture(autouse=True)
def _no_port_session_residue():
    """Fail a test that leaves resident decode-session KV caches behind in
    a port SessionStore (the twin of the root conftest's guard, which
    sees only the JAX package's stores): session-keyed state must be
    evicted on session end — close frame, fence clear, or thread exit."""
    yield
    residue = {id(s): s.keys() for s in live_session_stores() if len(s)}
    assert not residue, (
        "test leaked resident decode-session KV caches in repro_torch "
        f"(session-keyed state must be evicted on session end): {residue}")


def lm_params(graph, seed: int = 0) -> dict:
    """numpy params for either package's LM graph: ``w ~ N(0, 1/fan_in)``,
    norm scales 1, the embedding table ``~ N(0, 1)``."""
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


@pytest.fixture(scope="module")
def lm():
    tg = tlm.decode_lm_graph(**LM)
    params = lm_params(tg)
    return tg, params, tg.prepare(params, "cpu")


def jax_tokens(params, prompt, m, use_kernel=False):
    jg = jlm.decode_lm_graph(use_kernel=use_kernel, **LM)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    return jlm.pipeline_decode_reference(jg, jp, prompt, m)


def refs(lm, prompts, m):
    tg, _, prep = lm
    return [tlm.pipeline_decode_reference(tg, prep, p, m) for p in prompts]


def build(lm, topology=None, **kw):
    tg, params, _ = lm
    topo = topology if topology is not None else TopologySpec.chain(tg, 2)
    kw.setdefault("max_batch", 4)
    eng = InferenceEngine(tg, topo, CODECS, device="cpu", **kw)
    eng.configure(params)
    return eng


def run_sessions(eng, prompts, m, after=None, **gen_kw):
    """One generate() per prompt on its own thread (concurrent sessions at
    different sequence positions); ``after`` runs once every session has
    2 tokens.  Returns the token lists, re-raising the first failure."""
    outs: list[list[int]] = [[] for _ in prompts]
    errs: list[BaseException] = []

    def one(i, p):
        try:
            for tok in eng.generate(p, m, **gen_kw):
                outs[i].append(tok)
        except BaseException as e:      # noqa: BLE001 - re-raised below
            errs.append(e)

    ts = [threading.Thread(target=one, args=(i, p))
          for i, p in enumerate(prompts)]
    for t in ts:
        t.start()
    if after is not None:
        deadline = time.monotonic() + 120
        while not all(len(o) >= 2 for o in outs) and not errs:
            assert time.monotonic() < deadline, [len(o) for o in outs]
            time.sleep(0.01)
        after()
    for t in ts:
        t.join(300)
    assert not any(t.is_alive() for t in ts), "generation hung"
    if errs:
        raise errs[0]
    return outs


# -- the graph ----------------------------------------------------------------------

def test_graph_structure_and_cut_costs_match_jax():
    tg = tlm.decode_lm_graph(**LM)
    jg = jlm.decode_lm_graph(**LM)
    assert [n.name for n in tg.nodes] == [n.name for n in jg.nodes]
    assert tg.decode_capable and tg.decode_cache_len == jg.decode_cache_len
    for i in range(len(tg.nodes)):
        assert tg.crossing_names(i) == jg.crossing_names(i)
        assert tg.cut_cost(i) == jg.cut_cost(i)
    assert tg.total_flops == jg.total_flops
    assert tg.total_param_bytes == jg.total_param_bytes


def test_prefill_logits_match_jax(lm):
    tg, params, prep = lm
    jg = jlm.decode_lm_graph(**LM)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    for prompt in PROMPTS:
        x = np.asarray([prompt], np.int32)
        got = tg.apply(prep, torch.from_numpy(x)).numpy()
        want = np.asarray(jg.apply(jp, jnp.asarray(x)))
        assert got.shape == (1, len(prompt), LM["vocab"])
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
        # the prefill view (what an opening session runs) gives the same
        # logits and caches the prompt at slots [0, S)
        acts, caches = torch.from_numpy(x), {}
        for node in tg.nodes:
            if node.decode is not None:
                acts, caches[node.name] = node.decode.prefill_fn(
                    prep[node.name], acts)
            else:
                acts = node.fn(prep[node.name], acts)
        assert torch.equal(acts, torch.from_numpy(got))
        kpos = caches["blk0_attn"]["kpos"][0].numpy()
        assert list(kpos[:len(prompt)]) == list(range(len(prompt)))
        assert (kpos[len(prompt):] == -1).all()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_reference_tokens_equal_jax(lm, use_kernel):
    tg, params, prep = lm
    g = tlm.decode_lm_graph(use_kernel=use_kernel, **LM)
    m = 10
    got = [tlm.pipeline_decode_reference(g, prep, p, m) for p in PROMPTS]
    assert got == [jax_tokens(params, p, m, use_kernel) for p in PROMPTS]
    assert len({tuple(t) for t in got}) == len(PROMPTS)


def _prefilled(graph, prep, prompts):
    """A 2-stage chain's first stage (embed, blk0_attn, blk0_mlp) and the
    caches its prefill leaves for each prompt."""
    nodes = graph.nodes[:3]
    dev = prep["embed"]["table"].device
    caches = []
    with torch.inference_mode():
        for p in prompts:
            acts = torch.tensor([p], dtype=torch.int32, device=dev)
            c = {}
            for node in nodes:
                if node.decode is not None:
                    acts, c[node.name] = node.decode.prefill_fn(
                        prep[node.name], acts)
                else:
                    acts = node.fn(prep[node.name], acts)
            caches.append(c)
    return nodes, caches


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def step_device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py checks batch "
                    "invariance on the card")
    return torch.device(request.param)


def test_step_is_batch_invariant_at_the_fixed_row_count(lm, step_device):
    """A session stepped alone (padded to ``decode_step_rows`` by
    repeating its row) and the same session as row 3 of a full step of
    other sessions give bit-identical outputs and caches (on the card,
    through the decode-attention kernel).  Unpadded, a batch-1 step is
    not bit-identical to a row of a batch of 8 on this CPU's GEMM, which
    is why every step runs at the fixed row count."""
    _, params, _ = lm
    graph = tlm.decode_lm_graph(use_kernel=True, **LM)
    prep = graph.prepare(params, step_device)
    rows = graph.decode_step_rows
    prompts = [list(range(i + 1, i + 4 + i % 3)) for i in range(rows)]
    nodes, caches = _prefilled(graph, prep, prompts)

    def step(idx):
        c = {n: {k: torch.cat([caches[i][n][k] for i in idx])
                 for k in caches[0][n]} for n in caches[0]}
        x = torch.tensor([[7 + i] for i in idx], dtype=torch.int32,
                         device=step_device)
        pos = torch.tensor([len(prompts[i]) for i in idx], dtype=torch.int32,
                           device=step_device)
        acts = x
        with torch.inference_mode():
            for node in nodes:
                if node.decode is not None:
                    acts, c[node.name] = node.decode.step_fn(
                        prep[node.name], c[node.name], acts, pos)
                else:
                    acts = node.fn(prep[node.name], acts)
        return acts, c

    full, cfull = step(list(range(rows)))
    alone, calone = step([3] * rows)
    assert torch.equal(full[3], alone[0])
    for n in cfull:
        for k in cfull[n]:
            assert torch.equal(cfull[n][k][3], calone[n][k][0])


# -- served through the chain ---------------------------------------------------------

@pytest.mark.parametrize("transport", ["inproc", "tcp"])
def test_chain_tokens_bit_identical_to_reference(lm, transport):
    """3-4 concurrent sessions at different positions over a 2-stage chain
    with stage 0 replicated twice (sticky routing)."""
    tg, params, _ = lm
    topo = TopologySpec.chain(tg, 2, transport=transport).with_replicas(0, 2)
    eng = build(lm, topo)
    m = 8
    try:
        eng.start()
        outs = run_sessions(eng, PROMPTS, m)
    finally:
        eng.shutdown()
    assert outs == refs(lm, PROMPTS, m)
    assert outs == [jax_tokens(params, p, m) for p in PROMPTS]


def test_step_payload_is_10x_smaller_than_full_sequence_resend(lm):
    """After prefill each hop ships one token's activations, O(d_model),
    not the growing sequence."""
    eng = build(lm)
    prompt, m = [1, 2, 3, 4, 5, 6, 7, 8], 30
    try:
        eng.start()
        gen = eng.generate(prompt, m)
        next(gen)
        node = eng.dispatcher.stages[0].live_replicas()[0]
        node.reset_stats()
        for _ in range(m - 1):
            next(gen)
        per_step = node.snapshot()["payload_bytes"] / (m - 1)
        gen.close()
        # what resending the whole sequence's activations would ship:
        # activation-like values, which LZ4 cannot shrink as it does zeros
        full = np.random.default_rng(0).standard_normal(
            (1, len(prompt) + m, LM["d_model"])).astype(np.float32)
        assert len(DATA.encode_array(full)) / per_step >= 10.0
    finally:
        eng.shutdown()


def test_scale_during_generation_drops_zero_sessions(lm):
    tg, params, _ = lm
    topo = TopologySpec.chain(tg, 2).with_replicas(0, 2)
    eng = build(lm, topo, retry_policy=RetryPolicy(
        max_attempts=4, backoff_s=0.05, retry_budget=64.0, refill_per_s=32.0))
    m = 12

    def rescale():
        eng.scale(0, 1)            # drain one replica: displaces sessions
        eng.scale(0, 2)

    try:
        eng.start()
        outs = run_sessions(eng, PROMPTS, m, after=rescale)
    finally:
        eng.shutdown()
    assert outs == refs(lm, PROMPTS, m)
    assert outs == [jax_tokens(params, p, m) for p in PROMPTS]


def test_reconfigure_during_generation_migrates_sessions(lm):
    """A repartition invalidates every stage's resident KV; sessions
    re-prefill onto the new cuts and finish bit-identical."""
    eng = build(lm)
    m = 12
    try:
        eng.start()
        outs = run_sessions(
            eng, PROMPTS[:3], m, restart="always",
            after=lambda: eng.dispatcher.reconfigure([2]))
        assert eng.dispatcher.partition.cuts == (2,)
    finally:
        eng.shutdown()
    assert outs == refs(lm, PROMPTS[:3], m)
    assert outs == [jax_tokens(lm[1], p, m) for p in PROMPTS[:3]]


def test_eviction_with_restart_never_raises_sessionlost(lm):
    tg, params, prep = lm
    eng = build(lm, TopologySpec.chain(tg, 2, session_capacity=1))
    try:
        eng.start()
        s1 = eng.generate(PROMPTS[0], 4, restart="never")
        next(s1)
        s2 = eng.generate(PROMPTS[1], 4, restart="never")
        t2 = [next(s2)]                         # evicts s1 (capacity 1)
        with pytest.raises(SessionLost):
            next(s1)
        t2.append(next(s2))
        s2.close()
        assert t2 == refs(lm, [PROMPTS[1]], 4)[0][:2]
        # one-shot traffic on the same chain is unharmed
        x = np.asarray([PROMPTS[2]], np.int32)
        np.testing.assert_allclose(
            eng.submit(x).result(timeout=60),
            tg.apply(prep, torch.from_numpy(x)).numpy(), atol=1e-5)
    finally:
        eng.shutdown()


def test_eviction_thrash_recovered_by_reprefill(lm):
    tg, _, _ = lm
    eng = build(lm, TopologySpec.chain(tg, 2, session_capacity=1))
    m = 5
    try:
        eng.start()
        gens = [eng.generate(p, m, restart="always") for p in PROMPTS[:2]]
        outs = [[], []]
        for _ in range(m):
            for o, gen in zip(outs, gens):
                o.append(next(gen))
        for gen in gens:
            gen.close()
    finally:
        eng.shutdown()
    assert outs == refs(lm, PROMPTS[:2], m)


def test_generate_bounds_the_prompt_by_the_kv_capacity(lm):
    eng = build(lm)
    try:
        eng.start()
        with pytest.raises(ValueError, match="KV capacity"):
            next(eng.generate(list(range(40)), 10))     # 40 + 10 > 48
        with pytest.raises(ValueError, match="non-empty prompt"):
            next(eng.generate([], 4))
        assert len(list(eng.generate(list(range(40)), 8))) == 8
    finally:
        eng.shutdown()


def test_params_carry_across_from_the_jax_package(lm):
    tg, params, _ = lm
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    carried = tcnn.params_from_jax(jp, tg)
    for name, p in params.items():
        for path, a in tree_flatten_with_path(p):
            b = carried[name]
            for k in path:
                b = b[k]
            assert b.dtype == np.float32 and b.tobytes() == a.tobytes()
