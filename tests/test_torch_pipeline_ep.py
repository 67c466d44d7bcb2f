"""The port's expert-parallel stage pipeline (``core/pipeline_ep.py``, the
expert shards of ``launch/mesh.py``) and the moe family through the
launcher's pipelines (``launch/serve.py``) against the JAX package.

The reference runs its PP x EP chain as one SPMD program under
``shard_map`` and tests it in a ``slow`` subprocess with 4 fake XLA
devices (``tests/test_perf_variants.py``).  Here its stage body
``ep_unit_fn`` runs under ``jax.vmap(..., axis_name="expert")`` on one
CPU device instead, against the port's stage body over the same shards;
the whole chain is held against the reference's ``forward`` at its own
bar (1e-4 relative, capacity factor 8.0 so that no dispatch drops).

Weights are the reference's, carried over with ``params_from_jax``.  On
the CPU the block-quant wrappers run their plain versions;
``chip_smoke.py`` drives the kernels on the card.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import pipeline_ep as jpe
from repro.core.pipeline import stack_stages as j_stack_stages
from repro.models import transformer as JT
from repro_torch.configs import registry as treg
from repro_torch.core import pipeline as tpipe
from repro_torch.core import pipeline_ep as tpe
from repro_torch.core.graph import tree_map
from repro_torch.kernels import block_quant as tbq
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

ARCH = "dbrx-132b"
B, SEQ, M, STAGES, AX = 4, 16, 2, 2, 2
RAW_TOL = 1e-4       # the reference's bar for the EP chain against forward
BODY_TOL = 1e-5
ZFP_REL = 0.15       # compressed vs forward: the reference's own bar


def _cfgs(cf=8.0, layers=None):
    """dbrx's smoke config (4 experts, top-2) at capacity factor ``cf``."""
    out = []
    for reg in (jreg, treg):
        c = reg.get_smoke(ARCH)
        c = dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=cf))
        out.append(dataclasses.replace(c, num_layers=layers or c.num_layers))
    return out


@functools.cache
def _setup(cf=8.0, layers=None):
    jc, tc = _cfgs(cf, layers)
    params = JT.init_lm(jc, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab, (B, SEQ)).astype(np.int32)
    ref, _ = jax.jit(lambda p, t: JT.forward(p, jc, t))(
        params, jnp.asarray(tokens))
    tp = TT.params_from_jax(jax.tree_util.tree_map(np.array, params), "cpu")
    return jc, tc, params, tp, tokens, np.asarray(ref)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


# -- the stage body ----------------------------------------------------------------

def _j_shards(units, ax):
    """The reference's per-device weights of one stage ([u, ...] leaves),
    cut by its own ``_ep_weight_specs`` and stacked on a new expert axis."""
    stacked = jax.tree_util.tree_map(lambda a: a[None], units)
    specs = jpe._ep_weight_specs(stacked, "stage", "expert")

    def cut(a, spec):
        a = a[0]
        if "expert" not in tuple(spec):
            return jnp.stack([a] * ax)
        dim = tuple(spec).index("expert") - 1
        return jnp.stack(jnp.split(a, ax, axis=dim))

    return jax.tree_util.tree_map(cut, stacked, specs)


def _t_shards(units, ax):
    """The port's shards of one stage's units ([u, ...] leaves)."""
    return [tree_map(lambda a: a[0], sh) for sh in
            tpe.shard_units(tree_map(lambda a: a[None], units), ax)]


@pytest.mark.parametrize("ax,cf", [(2, 2.0), (4, 2.0), (2, 1.25)])
def test_stage_body_matches_the_reference_ep_unit_fn(ax, cf):
    """One stage (both smoke layers) over ``ax`` expert shards: the port's
    body against the reference's ``ep_unit_fn`` on every device of the
    expert axis (each returns the whole microbatch), within 1e-5 of the
    largest |y| (about 6: two residual layers of He-init weights; the two
    sum their products in other orders).  At cf 1.25 a shard's dispatch
    may drop; both drop the same assignments."""
    jc, tc, params, tp, tokens, _ = _setup(cf)
    units = params["units"]
    valid = jnp.ones((jc.num_layers,), bool)
    x = (0.5 * np.random.default_rng(2).standard_normal(
        (2, 8, jc.d_model))).astype(np.float32)
    body = jpe.ep_unit_fn(jc)
    jy = jax.jit(jax.vmap(lambda w, x: body((w, valid), x),
                          in_axes=(0, None), axis_name="expert"))(
        _j_shards(units, ax), jnp.asarray(x))
    shards = _t_shards(tp["units"], ax)
    y = tpe.ep_unit_fn(tc)((shards, np.ones(jc.num_layers, bool)),
                           torch.from_numpy(x))
    for i in range(ax):
        assert _rel(y.numpy(), jy[i]) < BODY_TOL


def test_ep_weight_specs_equal_the_reference():
    """Every leaf's spec, as a tuple, over dbrx's stage-stacked smoke
    units: experts and heads over "expert", the rest replicated."""
    jc, tc, params, tp, _, _ = _setup()
    n = jc.num_layers
    js, _ = j_stack_stages(params["units"], n, STAGES)
    ts, _ = tpipe.stack_stages(tp["units"], n, STAGES)
    want = dict((jax.tree_util.keystr(p), tuple(s)) for p, s in
                jax.tree_util.tree_flatten_with_path(
                    jpe._ep_weight_specs(js, "stage", "expert"))[0])
    got = {}

    def walk(tree, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{path}['{k}']")
            else:
                got[f"{path}['{k}']"] = tuple(v)

    walk(tpe._ep_weight_specs(ts, "stage", "expert"))
    assert got == want
    assert got["['pos0']['moe']['up']"] == ("stage", None, "expert", None,
                                            None)


def test_shards_are_views_of_the_stage_weights():
    _, tc, _, tp, _, _ = _setup()
    st, _ = tpipe.stack_stages(tp["units"], tc.num_layers, STAGES)
    sh = tpe.shard_units(st, AX)
    for key in ("up", "gate", "down"):
        a = sh[1]["pos0"]["moe"][key]
        assert a.shape[2] == tc.moe.num_experts // AX
        assert a.untyped_storage().data_ptr() == \
            tp["units"]["pos0"]["moe"][key].untyped_storage().data_ptr()
    wq = sh[1]["pos0"]["attn"]["wq"]["w"]
    assert wq.shape[-1] == tc.num_heads * tc.head_dim // AX
    assert wq.untyped_storage().data_ptr() == \
        tp["units"]["pos0"]["attn"]["wq"]["w"].untyped_storage().data_ptr()


# -- the chain ----------------------------------------------------------------------

def _chain(tc, tp, tokens, compress=False, quant_impl="kernel", stages=STAGES):
    mesh = tmesh.make_host_mesh(stages, "cpu", expert_shards=AX)
    n = tc.num_layers
    factory = tpe.build_ep_pipeline(tc, mesh, num_stages=stages,
                                    num_microbatches=M, compress=compress,
                                    quant_impl=quant_impl)
    x = TL.embed(tp["embed"], torch.from_numpy(tokens))
    stacked, valid = tpipe.stack_stages(tp["units"], n, stages)
    fn = factory(stacked, valid)
    y = fn((stacked, valid), x.reshape(M, B // M, SEQ, -1)).reshape(B, SEQ, -1)
    return TT._logits(tp, tc, y), fn


@pytest.mark.parametrize("layers", [None, 3])
def test_ep_pipeline_matches_the_reference_forward(layers):
    """dbrx smoke, 2 stages x 2 expert shards, M 2, cf 8.0 (no dispatch
    drops, as the record shows): within 1e-4 of the reference's forward,
    its own bar; 3 layers over 2 stages pads one unit slot (identity)."""
    jc, tc, params, tp, tokens, ref = _setup(8.0, layers)
    TM.reset_dispatch_record()
    logits, fn = _chain(tc, tp, tokens)
    assert TM.dropped() == 0
    assert _rel(logits.numpy(), ref) < RAW_TOL
    own, _ = TT.forward(tp, tc, torch.from_numpy(tokens))
    assert _rel(logits.numpy(), own.numpy()) < RAW_TOL
    assert fn.relayed.relays == M * (STAGES - 1)
    assert fn.relayed.encoded == 0


def test_compressed_ep_chain_is_the_plain_codec_bit_for_bit():
    """The relay through the block-quant wrappers (their plain versions on
    the CPU, counted) equals the chain whose codec is the plain version,
    bit for bit, and stays within the reference's 0.15 of forward; each
    call encodes M * (S - 1) relays."""
    _, tc, _, tp, tokens, ref = _setup()
    tbq.reset_counts()
    kern, fn = _chain(tc, tp, tokens, compress=True)
    assert fn.relayed.encoded == M * (STAGES - 1)
    assert tbq.plain_calls == {"quantize_blocks": M * (STAGES - 1),
                               "dequantize_blocks": M * (STAGES - 1)}
    assert tbq.launches == {"quantize_blocks": 0, "dequantize_blocks": 0}
    plain, _ = _chain(tc, tp, tokens, compress=True, quant_impl="plain")
    assert torch.equal(kern, plain)
    assert _rel(kern.numpy(), ref) < ZFP_REL


def test_tokens_that_do_not_split_over_the_shards_raise():
    _, tc, _, tp, _, _ = _setup()
    body = tpe.ep_unit_fn(tc)
    shards = _t_shards(tp["units"], AX)
    with pytest.raises(ValueError, match="do not split over 2"):
        body((shards, np.ones(tc.num_layers, bool)),
             torch.zeros(1, 15, tc.d_model))


def test_several_chains_are_not_ported():
    _, tc, _, _, _, _ = _setup()
    mesh = types.SimpleNamespace(shape={"data": 2, "expert": 2, "stage": 2},
                                 devices=(torch.device("cpu"),) * 2,
                                 num_stages=2)
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        tpe.build_ep_pipeline(tc, mesh, 2, M)


def test_stage_mesh_has_expert_shards():
    mesh = tmesh.make_host_mesh(2, "cpu", expert_shards=4)
    assert mesh.shape == {"expert": 4, "stage": 2}
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert tmesh.make_host_mesh(3, "cpu").shape == {"expert": 1, "stage": 3}
    with pytest.raises(ValueError, match="expert_shards"):
        tmesh.make_pipeline_mesh(2, ["cpu"], expert_shards=0)


# -- the moe family through the launcher ---------------------------------------------

def test_pipeline_lm_runs_dbrx_smoke():
    """``build_pipeline_lm`` (``T._apply_unit`` as the stage body) over
    2 stages at cf 8.0: within 1e-4 of the reference's forward."""
    _, tc, _, tp, tokens, ref = _setup()
    lm = tserve.build_pipeline_lm(tc, tp, tmesh.make_host_mesh(STAGES, "cpu"),
                                  STAGES, M)
    assert _rel(lm(torch.from_numpy(tokens)).numpy(), ref) < RAW_TOL


def test_pipeline_decoder_runs_dbrx_smoke():
    """``build_pipeline_decoder`` over 2 stages: every token equals the
    single-device greedy ``decode_step`` loop's (each microbatch routes
    the same mb tokens a step, so both dispatch at one capacity)."""
    _, tc, _, tp, _, _ = _setup()
    mb, steps = 2, 4
    start = torch.from_numpy(np.random.default_rng(3).integers(
        0, tc.vocab, (M, mb, 1)).astype(np.int32))
    fn, sw, caches0, head = tserve.build_pipeline_decoder(
        tc, tp, tmesh.make_host_mesh(STAGES, "cpu"), STAGES, M, mb, 16, steps)
    toks, _ = fn(sw, caches0, start, torch.zeros((M, mb), dtype=torch.int32),
                 head)
    for m in range(M):
        caches = TT.init_caches(tc, mb, 16, device="cpu")
        tok = start[m]
        for p in range(steps):
            logits, caches = TT.decode_step(
                tp, tc, tok, torch.full((mb,), p, dtype=torch.int32), caches)
            tok = logits.argmax(-1).to(torch.int32)
            assert torch.equal(toks[m, p], tok[:, 0])


def test_serve_cli_runs_dbrx_smoke(capsys):
    tserve.main(["--arch", ARCH, "--stages", "2", "--microbatches", "2",
                 "--requests", "4", "--seq", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=dbrx-132b stages=2 M=2" in out
    assert "logits (4, 8, 512)" in out
