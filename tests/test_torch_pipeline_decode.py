"""Autoregressive decode through the port's pipeline
(``core/pipeline_decode.py``, ``launch/serve.py::build_pipeline_decoder``)
against the JAX package, token for token.

The reference is held at S = 1 against its single-device greedy loop
(``tests/test_pipeline_decode.py``) and at S = 4 in a subprocess with 4
fake XLA devices.  Here its own ``pipeline_decode_apply`` runs at S = 4
under ``jax.vmap(..., axis_name="stage")`` on one CPU device
(``_vmap_decoder``, put in place of
``repro.core.pipeline_decode.make_pipeline_decoder`` with pytest's
monkeypatch).  Weights are the reference's (``params_from_jax``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.pipeline_decode as jpdec
import repro.launch.serve as jserve
from repro.configs import registry as jreg
from repro.models import transformer as JT
from repro_torch.configs import registry as treg
from repro_torch.core import pipeline as tpipe
from repro_torch.kernels import block_quant as tbq
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

MB, STEPS, MAX_LEN = 2, 4, 16
# the reference's S = 1 test's microbatch counts; at S = 4
# they are below S, so the S = 4 greedy check runs at M = 4 as well
CASES = [("phi3-mini-3.8b", 2), ("mamba2-2.7b", 3), ("zamba2-2.7b", 2)]
ARCHS = [a for a, _ in CASES]
_j_decode = jax.jit(JT.decode_step, static_argnames=("cfg", "use_kernel",
                                                     "unroll"))


def _vmap_decoder(mesh, cfg, *, decode_unit_fn, embed_fn, head_fn, steps):
    """The reference's ``pipeline_decode_apply`` for every stage at once,
    under ``jax.vmap`` with the stage axis named; returns the last stage's
    tokens and every stage's caches."""
    tmap = jax.tree_util.tree_map

    def body(w, c, tok, pos, head):
        return jpdec.pipeline_decode_apply(
            tmap(lambda a: a[None], w), tmap(lambda a: a[None], c), tok, pos,
            head, decode_unit_fn=decode_unit_fn, embed_fn=embed_fn,
            head_fn=head_fn, steps=steps, cfg=cfg)

    per_stage = jax.vmap(body, in_axes=(0, 0, None, None, None),
                         axis_name="stage")

    def fn(*args):
        toks, caches = per_stage(*args)
        return toks[-1], caches

    return jax.jit(fn)


@functools.cache
def _params(arch):
    cfg = jreg.get_smoke(arch)
    return jax.jit(JT.init_lm, static_argnums=(0,))(cfg,
                                                    jax.random.PRNGKey(0))


def _start(arch, M):
    cfg = jreg.get_smoke(arch)
    rng = np.random.default_rng(M + len(arch))
    return rng.integers(0, cfg.vocab, (M, MB, 1)).astype(np.int32)


@functools.cache
def _greedy(arch, M):
    """The reference's single-device greedy loop, per microbatch
    (``tests/test_pipeline_decode.py::_ref_greedy``): tokens
    [M, steps, mb]."""
    cfg, params = jreg.get_smoke(arch), _params(arch)
    toks = []
    for m in range(M):
        caches = JT.init_caches(cfg, MB, MAX_LEN, jnp.float32)
        tok, out = jnp.asarray(_start(arch, M)[m]), []
        for p in range(STEPS):
            lg, caches = _j_decode(params, cfg, tok,
                                   jnp.full((MB,), p, jnp.int32), caches)
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
            out.append(np.asarray(tok[:, 0]))
        toks.append(np.stack(out))
    return np.stack(toks)


@functools.cache
def _reference_s4(arch, M, compress):
    """The reference's S = 4 decoder: (tokens, caches) as numpy."""
    cfg, params = jreg.get_smoke(arch), _params(arch)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpdec, "make_pipeline_decoder", _vmap_decoder)
        fn, sw, caches0, head = jserve.build_pipeline_decoder(
            cfg, params, None, 4, M, MB, MAX_LEN, STEPS, compress=compress)
    toks, caches = fn(sw, caches0, jnp.asarray(_start(arch, M)),
                      jnp.zeros((M, MB), jnp.int32), head)
    return np.asarray(toks), jax.tree_util.tree_map(np.array, caches)


def _port(arch, M, S, compress, quant_impl="kernel"):
    """The port's decoder on the CPU: (tokens numpy, caches, fn)."""
    params = TT.params_from_jax(jax.tree_util.tree_map(np.array,
                                                       _params(arch)),
                                device="cpu")
    fn, sw, caches0, head = tserve.build_pipeline_decoder(
        treg.get_smoke(arch), params, tmesh.make_host_mesh(S, "cpu"), S, M,
        MB, MAX_LEN, STEPS, compress=compress, quant_impl=quant_impl)
    with torch.inference_mode():
        toks, caches = fn(sw, caches0, torch.from_numpy(_start(arch, M)),
                          torch.zeros((M, MB), dtype=torch.int32), head)
    return toks.numpy(), caches, fn


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch,M", CASES)
def test_single_stage_decoder_matches_greedy(arch, M, compress):
    """S = 1: every token equals the reference's single-device greedy loop
    (one stage relays no hidden state, so compress changes nothing)."""
    toks, _, fn = _port(arch, M, 1, compress)
    np.testing.assert_array_equal(toks, _greedy(arch, M))
    assert fn.relayed.encoded == 0
    assert fn.relayed.relays == M * STEPS        # the token, back to stage 0


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch,M", CASES)
def test_four_stage_decoder_matches_the_reference(arch, M, compress):
    """S = 4 (stages 2 and 3 hold only padded units at smoke depth):
    every token equals the reference's S = 4 decoder, raw and compressed.
    Compressed, a call quantizes M * steps * (S - 1) hidden states: the
    "kernel" route's plain versions on the CPU, once per relay."""
    tbq.reset_counts()
    toks, _, fn = _port(arch, M, 4, compress)
    np.testing.assert_array_equal(toks, _reference_s4(arch, M, compress)[0])
    want = M * STEPS * 3 if compress else 0
    assert fn.relayed.encoded == want
    assert tbq.plain_calls == {"quantize_blocks": want,
                               "dequantize_blocks": want}


@pytest.mark.parametrize("arch", ARCHS)
def test_four_stage_decoder_with_m_at_s_matches_greedy_and_its_caches(arch):
    """M = S = 4: the token each microbatch needs is back at stage 0 in
    time, so every token equals the single-device greedy loop; the caches
    the chain leaves equal the reference's S = 4 decoder's: positions
    exactly, states within 1e-5 of each leaf's largest value (the SSD
    state reaches 105; observed at most 2.5e-6 of it, the conv tail)."""
    toks, caches, _ = _port(arch, 4, 4, False)
    np.testing.assert_array_equal(toks, _greedy(arch, 4))
    rtoks, rcaches = _reference_s4(arch, 4, False)
    np.testing.assert_array_equal(toks, rtoks)
    cfg = jreg.get_smoke(arch)
    n_units = cfg.num_layers // cfg.unit_layers
    flat = jax.tree_util.tree_flatten_with_path(rcaches)[0]
    assert flat
    for path, ref in flat:
        got = caches
        for k in path:
            got = got[k.key]
        # [S, (1,) u, M, ...] -> the valid units' [n_units, M, ...]
        ref = ref[:, 0].reshape((-1,) + ref.shape[3:])[:n_units]
        got = got.reshape((-1,) + tuple(got.shape[2:]))[:n_units].numpy()
        if got.dtype.kind == "i":
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max())


def test_below_m_of_s_stage_zero_reads_a_token_not_back_yet():
    """With M < S the token a microbatch needs leaves the last stage after
    stage 0 has taken that microbatch's next step: the reference reads
    its buffer as it is (ROADMAP queue 3 item 12) and so does the port.
    At phi3's M = 2 the tokens equal the reference's S = 4 decoder's and
    differ from the greedy loop's after the first step."""
    toks, _, _ = _port("phi3-mini-3.8b", 2, 4, False)
    greedy = _greedy("phi3-mini-3.8b", 2)
    np.testing.assert_array_equal(toks, _reference_s4("phi3-mini-3.8b", 2,
                                                      False)[0])
    np.testing.assert_array_equal(toks[:, 0], greedy[:, 0])
    assert (toks[:, 1:] != greedy[:, 1:]).any()


def test_kernel_and_plain_routes_give_the_same_tokens_on_the_cpu():
    """``quant_impl`` "kernel" (the wrappers, their plain versions on the
    CPU) and "plain" (the plain versions directly) give the same tokens."""
    a = _port("phi3-mini-3.8b", 4, 4, True, "kernel")[0]
    b = _port("phi3-mini-3.8b", 4, 4, True, "plain")[0]
    np.testing.assert_array_equal(a, b)


# -- on a card ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_decode_equals_the_plain_route(cuda_device):
    """On a card the compressed decode chain launches each block-quant
    kernel M * steps * (S - 1) times and gives the "plain" route's tokens."""
    cfg = treg.get_smoke("phi3-mini-3.8b")
    params = TT.init_lm(cfg, 0, device=cuda_device)
    mesh = tmesh.make_host_mesh(4, cuda_device)
    start = torch.randint(0, cfg.vocab, (4, MB, 1), dtype=torch.int32,
                          device=cuda_device)
    pos = torch.zeros((4, MB), dtype=torch.int32, device=cuda_device)
    toks = {}
    for impl in tpipe.QUANT_IMPLS:
        fn, sw, c0, head = tserve.build_pipeline_decoder(
            cfg, params, mesh, 4, 4, MB, MAX_LEN, STEPS, compress=True,
            quant_impl=impl)
        tbq.reset_counts()
        with torch.inference_mode():
            toks[impl] = fn(sw, c0, start, pos, head)[0]
        torch.cuda.synchronize()
        want = 4 * STEPS * 3 if impl == "kernel" else 0
        assert tbq.launches == {"quantize_blocks": want,
                                "dequantize_blocks": want}
        assert tbq.plain_calls == {"quantize_blocks": 0,
                                   "dequantize_blocks": 0}
    assert torch.equal(toks["kernel"], toks["plain"])
