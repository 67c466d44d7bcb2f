"""The port's stage pipeline (``core/pipeline.py``, ``launch/mesh.py``,
``launch/serve.py``'s prefill path) against the JAX package.

The reference runs its chain as one SPMD program over a "stage" mesh axis
and tests it at S = 4 in a subprocess with 4 fake XLA devices.  Here its
own ``pipeline_apply`` runs under ``jax.vmap(..., axis_name="stage")`` on
one CPU device instead (``_vmap_pipeline``, put in place of
``repro.launch.serve.make_pipeline`` with pytest's monkeypatch): the same
per-stage body, the same ``ppermute`` relay, in-process and in seconds.

Weights are the reference's, carried over with ``params_from_jax``.  On
the CPU the port's block-quant wrappers run their plain versions; the
``cuda`` tests and ``chip_smoke.py`` drive the kernels on a card.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
from repro.configs import registry as jreg
from repro.core import pipeline as jpipe
from repro.models import transformer as JT
from repro_torch.configs import registry as treg
from repro_torch.core import pipeline as tpipe
from repro_torch.kernels import block_quant as tbq
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

_ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ["phi3-mini-3.8b", "zamba2-2.7b", "seamless-m4t-large-v2"]
B, SEQ, M, STAGES = 8, 16, 4, 4
RAW_TOL = 1e-4       # the reference's bar for the raw chain against forward
REF_REL = 1e-2       # compressed: port vs reference (see test docstring)
ZFP_REL = 0.15       # compressed vs forward: the reference's own bar
CPU = torch.device("cpu")


def _vmap_pipeline(mesh, cfg, unit_fn, data_axes=(), with_extra=False):
    """The reference's ``pipeline_apply`` for every stage at once, under
    ``jax.vmap`` with the stage axis named: ``make_pipeline``'s result
    without ``shard_map``.  Returns the last stage's outputs."""
    tmap = jax.tree_util.tree_map

    def body(w, x, *extra):
        return jpipe.pipeline_apply(tmap(lambda a: a[None], w), x, *extra,
                                    unit_fn=unit_fn, cfg=cfg)

    axes = (0, None, None) if with_extra else (0, None)
    per_stage = jax.vmap(body, in_axes=axes, axis_name="stage")
    return lambda *args: tmap(lambda a: a[-1], per_stage(*args))


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the codec -------------------------------------------------------------------

@functools.cache
def _j_encode():
    # compiled, as the relay runs it: the scale is absmax * f32(1/127)
    return jax.jit(lambda y: jpipe._wire_encode(y, "jnp"))


@pytest.mark.parametrize("impl", tpipe.QUANT_IMPLS)
@pytest.mark.parametrize("shape", [(2, 24, 96), (2, 8, 256)])
def test_wire_codec_byte_identical_to_the_reference(shape, impl):
    """q and scales of the port's relay codec equal the reference's "jnp"
    codec byte for byte, with both pads ((2, 24, 96): 48 rows of 96 ->
    (48, 128)) and without ((2, 8, 256)); the decoded relay equals the
    reference's bit for bit."""
    x = (np.random.default_rng(sum(shape)).standard_normal(shape)
         * 3.0).astype(np.float32)
    jq, js = _j_encode()(jnp.asarray(x))
    q, s = tpipe._wire_encode(torch.from_numpy(x), impl)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    back = tpipe._wire_decode(q, s, shape, torch.float32, impl)
    jback = jpipe._wire_decode(jq, js, shape, jnp.float32, "jnp")
    assert back.shape == shape
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    assert float((back - torch.from_numpy(x)).abs().max()) <= \
        float(np.abs(x).max()) / 127.0 + 1e-6


def test_quant_impl_must_be_kernel_or_plain():
    with pytest.raises(ValueError, match="quant_impl"):
        tpipe.PipelineConfig(4, 4, quant_impl="pallas")


# -- stage stacking ------------------------------------------------------------------

@pytest.mark.parametrize("n_units,S", [(7, 4), (8, 4)])
def test_stack_stages_equal_to_the_reference(n_units, S):
    w = np.arange(n_units * 3, dtype=np.float32).reshape(n_units, 3) + 1.0
    tree = {"a": w, "b": {"c": w[:, :1] * 2.0}}
    jst, jvalid = jpipe.stack_stages(jax.tree_util.tree_map(jnp.asarray, tree),
                                     n_units, S)
    st, valid = tpipe.stack_stages(
        {"a": _t(w), "b": {"c": _t(w[:, :1] * 2.0)}}, n_units, S)
    assert isinstance(valid, np.ndarray)
    np.testing.assert_array_equal(valid, np.asarray(jvalid))
    np.testing.assert_array_equal(st["a"].numpy(), np.asarray(jst["a"]))
    np.testing.assert_array_equal(st["b"]["c"].numpy(),
                                  np.asarray(jst["b"]["c"]))


def test_stacked_stages_are_views_where_stages_divide_the_units():
    """At 32 units over 4 stages (phi3's) the stacked weights share the
    params' memory; with padding (7 over 4) they are a copy."""
    w = torch.randn(32, 4, 4)
    st, _ = tpipe.stack_stages({"w": w}, 32, 4)
    assert st["w"].shape == (4, 8, 4, 4)
    assert st["w"].untyped_storage().data_ptr() == \
        w.untyped_storage().data_ptr()
    st7, _ = tpipe.stack_stages({"w": w[:7]}, 7, 4)
    assert st7["w"].untyped_storage().data_ptr() != \
        w.untyped_storage().data_ptr()


# -- a toy chain --------------------------------------------------------------------

D_TOY, N_TOY = 96, 7


def _toy():
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((N_TOY, D_TOY, D_TOY)) * 0.1).astype(np.float32)
    x = rng.standard_normal((M, 2, 8, D_TOY)).astype(np.float32)
    return w, x


def test_single_stage_pipeline_equals_sequential():
    """S = 1: the schedule reduces to a plain loop over the units."""
    w, x = _toy()
    stacked, valid = tpipe.stack_stages(_t(w), N_TOY, 1)
    fn = tpipe.make_pipeline(tmesh.make_host_mesh(1, "cpu"),
                             tpipe.PipelineConfig(1, M),
                             tpipe.make_stage_unit_fn(
                                 lambda up, h: h + torch.tanh(h @ up)))
    y = fn((stacked, valid), _t(x))
    ref = _t(x)
    for i in range(N_TOY):
        ref = ref + torch.tanh(ref @ _t(w[i]))
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-6)
    assert fn.relayed.relays == 0


@pytest.mark.parametrize("compress", [False, True])
def test_toy_chain_matches_the_reference_under_vmap(compress):
    """S = 4 over 7 units (one padded slot), M = 4, d 96 (a padded relay
    grid).  Raw: within 1e-6 of the reference's chain.  Compressed: within
    one quantization step (the largest relayed tile's absmax/127) of it;
    a rounding tie that float order flips moves one element by a step.
    Observed: 0 raw, 0 compressed (the codec's bytes equal)."""
    w, x = _toy()
    cfg_j = jpipe.PipelineConfig(STAGES, M, compress=compress)
    jfn = _vmap_pipeline(None, cfg_j, jpipe.make_stage_unit_fn(
        lambda up, h: h + jnp.tanh(h @ up)))
    jst = jpipe.stack_stages(jnp.asarray(w), N_TOY, STAGES)
    jy = np.asarray(jax.jit(jfn)(jst, jnp.asarray(x)))
    fn = tpipe.make_pipeline(tmesh.make_host_mesh(STAGES, "cpu"),
                             tpipe.PipelineConfig(STAGES, M,
                                                  compress=compress),
                             tpipe.make_stage_unit_fn(
                                 lambda up, h: h + torch.tanh(h @ up)))
    y = fn(tpipe.stack_stages(_t(w), N_TOY, STAGES), _t(x)).numpy()
    err = float(np.abs(y - jy).max())
    if compress:
        assert err <= float(np.abs(jy).max()) / 127.0
    else:
        assert err <= 1e-6 * float(np.abs(jy).max())
    assert fn.relayed.relays == M * (STAGES - 1)
    assert fn.relayed.encoded == (M * (STAGES - 1) if compress else 0)


def test_compressed_relay_launch_count_is_the_schedules():
    """Bubble ticks are skipped with their relays, and the last stage's
    output is not relayed: a call quantizes M * (S - 1) times per stream
    leaf.  On the CPU the "kernel" route runs the wrappers' plain versions
    (counted as ``plain_calls``) and "plain" bypasses them."""
    w, x = _toy()
    st = tpipe.stack_stages(_t(w), N_TOY, STAGES)
    unit = tpipe.make_stage_unit_fn(
        lambda up, x: {k: h + torch.tanh(h @ up) for k, h in x.items()})
    outs = {}
    for impl in tpipe.QUANT_IMPLS:
        tbq.reset_counts()
        fn = tpipe.make_pipeline(
            tmesh.make_host_mesh(STAGES, "cpu"),
            tpipe.PipelineConfig(STAGES, M, compress=True, quant_impl=impl),
            unit)
        outs[impl] = fn(st, {"h": _t(x), "e": _t(x[:, :, :2])})
        want = 2 * M * (STAGES - 1) if impl == "kernel" else 0
        assert tbq.plain_calls == {"quantize_blocks": want,
                                   "dequantize_blocks": want}
        assert tbq.launches == {"quantize_blocks": 0, "dequantize_blocks": 0}
        assert fn.relayed.encoded == 2 * M * (STAGES - 1)
    torch.testing.assert_close(outs["kernel"], outs["plain"], rtol=0, atol=0)


def test_data_axes_and_a_mismatched_mesh_raise():
    cfg = tpipe.PipelineConfig(STAGES, M)
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        tpipe.make_pipeline(tmesh.make_host_mesh(STAGES, "cpu"), cfg,
                            lambda w, x: x, data_axes=("data",))
    with pytest.raises(ValueError, match="stages"):
        tpipe.make_pipeline(tmesh.make_host_mesh(2, "cpu"), cfg,
                            lambda w, x: x)


def test_pipeline_mesh_goes_round_robin():
    m = tmesh.make_pipeline_mesh(5, ["cpu", torch.device("cpu")])
    assert m.num_stages == 5 and m.axis == "stage"
    assert all(d == CPU for d in m.devices)
    assert tmesh.make_host_mesh(3, "cpu").devices == (CPU,) * 3


def test_entry_points_raise_without_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_pipeline_mesh(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_host_mesh(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--arch", "phi3-mini-3.8b", "--stages", "4"])


# -- the LM prefill pipeline -----------------------------------------------------------

@functools.cache
def _lm_case(arch):
    """The reference's weights, a seeded batch, its forward and its S = 4
    pipeline's logits, raw and compressed."""
    cfg = jreg.get_smoke(arch)
    params = jax.jit(JT.init_lm, static_argnums=(0,))(cfg,
                                                      jax.random.PRNGKey(0))
    rng = np.random.default_rng(len(arch))
    tokens = rng.integers(0, cfg.vocab, (B, SEQ)).astype(np.int32)
    kw = {}
    if cfg.encoder_layers:
        kw["encoder_embeds"] = (rng.standard_normal(
            (B, cfg.num_prefix_embeds, cfg.d_model)) * 0.1).astype(np.float32)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    ref = jax.jit(lambda p, t: JT.forward(p, cfg, t, **jkw)[0])(
        params, jnp.asarray(tokens))
    pipe = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jserve, "make_pipeline", _vmap_pipeline)
        for compress in (False, True):
            lm = jserve.build_pipeline_lm(cfg, params, None, STAGES, M,
                                          compress=compress)
            pipe[compress] = np.asarray(
                jax.jit(lambda t: lm(t, **jkw))(jnp.asarray(tokens)))
    return (jax.tree_util.tree_map(np.array, params), tokens, kw,
            np.asarray(ref), pipe)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_lm_matches_the_reference_pipeline_and_forward(arch,
                                                                compress):
    """``build_pipeline_lm`` at S = 4, M = 4, B = 8, seq 16: phi3 (dense),
    zamba2 (the shared block rides as ``extra``), seamless-m4t (the
    {"h", "enc"} stream).  Raw: within 1e-4 of the reference's S = 4
    pipeline and of its ``forward`` (observed at most 2.6e-5, logits up to
    6.7).  Compressed: within 1e-2 relative of the reference's compressed
    pipeline — a rounding tie that float order flips moves one element by
    its tile's absmax/127, and the later layers carry it on (observed
    0.0035-0.0070) — and within the reference's 0.15 of ``forward``
    (observed 0.016-0.058)."""
    jparams, tokens, kw, ref, pipe = _lm_case(arch)
    cfg = jreg.get_smoke(arch)
    tcfg = treg.get_smoke(arch)
    params = TT.params_from_jax(jparams, device="cpu")
    lm = tserve.build_pipeline_lm(tcfg, params,
                                  tmesh.make_host_mesh(STAGES, "cpu"),
                                  STAGES, M, compress=compress)
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    with torch.inference_mode():
        out = lm(torch.from_numpy(tokens), **tkw).numpy()
    assert out.shape == (B, SEQ, cfg.padded_vocab)
    assert np.isfinite(out).all()
    n_units = cfg.num_layers // cfg.unit_layers
    assert lm.fn.relayed.relays == M * (STAGES - 1) * (
        2 if cfg.encoder_layers else 1)
    assert n_units < STAGES      # smoke: stages 2-3 hold only padded units
    if compress:
        assert _rel(out, pipe[True]) <= REF_REL
        assert _rel(out, ref) <= ZFP_REL
    else:
        assert np.abs(out - pipe[False]).max() <= RAW_TOL
        assert np.abs(out - ref).max() <= RAW_TOL


def test_wire_bytes_per_relay_prices_a_raw_relay_at_bf16():
    """The reference's ``wire_bytes_per_relay`` prices a raw relay at
    bf16 (mb*seq*d*2) and the compressed one on the unpadded grid; the
    port keeps that, while its pipeline relays the model's dtype (f32
    here: twice the figure) and pads the grid (ROADMAP queue 3 item 11)."""
    for arch in ("phi3-mini-3.8b", "seamless-m4t-large-v2"):
        jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
        for mb, seq, c in ((4, 64, False), (4, 64, True), (2, 1, True)):
            assert tserve.wire_bytes_per_relay(tcfg, mb, seq, c) == \
                jserve.wire_bytes_per_relay(jcfg, mb, seq, c)
    cfg = treg.get_smoke("phi3-mini-3.8b")
    y = torch.randn(2, 1, cfg.d_model)
    log = tpipe.RelayLog()
    tpipe.relay(y, CPU, tpipe.PipelineConfig(2, 1), log)
    assert log.raw_bytes == 2 * tserve.wire_bytes_per_relay(cfg, 2, 1, False)
    log = tpipe.RelayLog()
    tpipe.relay(y, CPU, tpipe.PipelineConfig(2, 1, compress=True), log)
    assert log.wire_bytes == 8 * cfg.d_model + 4 * (cfg.d_model // 128)
    assert tserve.wire_bytes_per_relay(cfg, 2, 1, True) == 2 * cfg.d_model


@pytest.mark.parametrize("compress", [False, True])
def test_serve_launcher_runs_on_the_cpu(compress):
    """``python -m repro_torch.launch.serve`` end to end at the smoke
    config, the CPU asked for."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "phi3-mini-3.8b", "--stages", "4", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(cmd + (["--compress"] if compress else []), env=env,
                       cwd=_ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert f"compress={compress} device=cpu" in r.stdout
    assert "logits (32, 64, 512)" in r.stdout
    assert f"relayed 24 leaves ({24 if compress else 0} encoded)" in r.stdout


# -- on a card ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_relay_equals_the_plain_relay(cuda_device):
    """On a card the "kernel" route launches the block-quant kernels
    M * (S - 1) times each and gives the "plain" route's output bit for
    bit (the kernel's bytes equal its plain version's)."""
    tcfg = treg.get_smoke("phi3-mini-3.8b")
    params = TT.init_lm(tcfg, 0, device=cuda_device)
    mesh = tmesh.make_host_mesh(STAGES, cuda_device)
    tokens = torch.randint(0, tcfg.vocab, (B, SEQ), device=cuda_device)
    outs = {}
    for impl in tpipe.QUANT_IMPLS:
        tbq.reset_counts()
        lm = tserve.build_pipeline_lm(tcfg, params, mesh, STAGES, M,
                                      compress=True, quant_impl=impl)
        with torch.inference_mode():
            outs[impl] = lm(tokens)
        torch.cuda.synchronize()
        want = M * (STAGES - 1) if impl == "kernel" else 0
        assert tbq.launches == {"quantize_blocks": want,
                                "dequantize_blocks": want}
        assert tbq.plain_calls == {"quantize_blocks": 0,
                                   "dequantize_blocks": 0}
    assert torch.equal(outs["kernel"], outs["plain"])
