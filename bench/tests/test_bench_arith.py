"""The yardstick's arithmetic against the program's own annotations and
hand counts, and the trace's interval arithmetic on synthetic events."""
from __future__ import annotations

import numpy as np
import pytest

from bench.harness import arith
from bench.harness.trace import Trace, gaps, union_s


@pytest.mark.parametrize("image,classes", [(224, 1000), (32, 10)])
def test_resnet50_flops_equal_the_graph_annotations(image, classes):
    from repro_torch.models import cnn
    g = cnn.resnet50(batch=1, image=image, num_classes=classes)
    assert arith.resnet50_flops(image, classes) == g.total_flops


def test_decoder_flops_equal_the_graph_annotations():
    """At S tokens the graph annotates every layer for S tokens attending
    S positions; the benchmark's per-token count, summed over S tokens at
    full attention, with the head, is the same number."""
    from repro_torch.models import lm_graph
    cfg = dict(vocab=49152, d_model=3072, n_layers=30, num_heads=24,
               kv_heads=2, head_dim=128, d_ff=12288)
    S = 8
    g = lm_graph.decode_lm_graph(seq_hint=S, cache_len=4096, **cfg)
    matmul = 2.0 * S * arith.decoder_matmul_params(**cfg)
    attn = cfg["n_layers"] * 4.0 * cfg["num_heads"] * cfg["head_dim"] * S * S
    assert matmul + attn == g.total_flops
    per_token = [arith.decoder_token_flops(cfg, p) for p in range(S)]
    causal = cfg["n_layers"] * 4.0 * cfg["num_heads"] * cfg["head_dim"] \
        * sum(range(1, S + 1))
    assert sum(per_token) == pytest.approx(matmul + causal, rel=1e-12)


def test_decoder_parameters_match_the_config():
    from bench.harness import spec
    from conftest import ROOT
    c = spec.resolve("starcoder2-3b.decode.closed8", ROOT).config
    m = c["model"]
    n = arith.decoder_matmul_params(**m) + m["vocab"] * m["d_model"] \
        + (2 * m["n_layers"] + 1) * m["d_model"]
    assert n == c["parameters"]


def test_block_quant_bytes_by_hand():
    # slice A's largest leaf: 401,408 f32 read, as many int8 and 392
    # scales written
    assert arith.block_quant_bytes(401_408) == 401_408 * 4 + 401_408 + 392 * 4
    assert arith.block_quant_bytes(1000) == 4000 + 1000 + 4


def test_decode_attention_need_by_hand():
    # one row over 300 valid slots at StarCoder2-3B's heads: K and V of
    # 2 heads x 128 f32 and a 4-byte position a slot; q and the output
    nbytes, ops = arith.decode_attention_need(300, 24, 2, 128)
    assert nbytes == 300 * (2 * 2 * 128 * 4 + 4) + 2 * 24 * 128 * 4
    assert ops == 4 * 24 * 128 * 300
    # a wave of 8 real rows: memory-bound (6 operations a byte < 20)
    assert arith.bound_s(8 * nbytes, 8 * ops) == 8 * nbytes / 3.35e12


def test_resnet50_leaves_at_the_cells_cuts():
    assert arith.resnet50_leaves(224, 1000, (4, 20, 37)) == [
        150_528, 200_704, 200_704, 401_408, 200_704, 1000]


def test_union_of_overlapping_intervals():
    ivs = [(0, 10), (5, 15), (20, 30), (22, 25), (40, 41)]
    assert union_s(ivs) == pytest.approx(26e-9)
    assert gaps(ivs, 0, 50) == [(15, 20), (30, 40), (41, 50)]
    # two streams: the sum would count 11 ns twice; the union does not
    t = Trace(0, 100, [("a", 0, 50), ("b", 40, 60)], [])
    assert t.busy_s() == pytest.approx(60e-9)


def test_idle_gaps_are_named_by_the_innermost_host_span():
    t = Trace(0, 100, [("k", 0, 10), ("k", 30, 40), ("k", 70, 100)],
              [("outer", 0, 100), ("inner", 12, 28), ("x", 95, 99)])
    got = dict(t.idle_gaps())
    assert got == {"inner": pytest.approx(20e-9),
                   "outer": pytest.approx(30e-9)}


def test_poisson_schedule_is_the_same_work_for_every_seed():
    from bench.harness.load import poisson_offsets
    a = poisson_offsets(40.0, 30.0, 1)
    b = poisson_offsets(40.0, 30.0, 2**31 + 5)
    assert len(a) == len(b) == 1200
    # the same gaps in another order, but for the one before the first
    # request, which each seed leaves out
    da, db = np.round(np.diff(a), 12), np.round(np.diff(b), 12)
    assert len(np.intersect1d(da, db)) >= len(a) - 2
    assert a[-1] < 30.0 and not np.array_equal(a, b)


def test_session_rounds_are_the_same_work_for_every_seed():
    from bench.harness.load import session_round
    t = {"clients": 8, "prompt_len": [128, 512], "new_tokens": [16, 64]}
    a = session_round(t, 1, 49152, 0)
    b = session_round(t, 2**33, 49152, 0)
    key = [(len(p), n) for p, n in a]
    assert key == [(len(p), n) for p, n in b] and a != b
    later = [(len(p), n) for p, n in session_round(t, 1, 49152, 1)]
    assert sorted(later) == sorted(key) and later != key
    assert min(k[0] for k in key) >= 128 and max(k[0] for k in key) <= 512


@pytest.mark.parametrize("n", [10, 1000, 1025, 3072, 150_528])
def test_the_reference_quantizes_as_the_q8_wire_does(n):
    """The reference's own block quantization gives the q8 wire's values
    bit for bit (the program's plain version on the CPU)."""
    import torch

    from bench.reference.blockquant import roundtrip
    from repro_torch.runtime import WireCodec
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    x[: n // 3] *= 1e-3
    w = WireCodec("q8", "none", device="cpu")
    want = w.decode_array(w.encode_array(x))
    got = roundtrip(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _served_wave(k: int, seed: int = 0):
    """A wave of ``k`` rows of 1,000 logits of unlike sizes through the q8
    wire's last hop (the program's plain version on the CPU): the rows
    before and after, and each value's true step."""
    from repro_torch.runtime import WireCodec
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((k, 1000))
         * np.array([1.0, 3.0, 0.5, 2.0])[:k, None]).astype(np.float32)
    w = WireCodec("q8", "none", device="cpu")
    y = w.decode_array(w.encode_array(z))
    flat = np.concatenate([z.reshape(-1), np.zeros(-z.size % 1024,
                                                   np.float32)])
    scale = (np.abs(flat.reshape(-1, 1024)).max(1)
             * (np.float32(1) / np.float32(127))).astype(np.float32)
    steps = np.repeat(scale, 1024)[:z.size].reshape(k, 1000)
    return z, y, steps


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_tile_steps_read_the_last_hops_tiles_from_each_served_row(k):
    """Each row of a wave, alone, gives back the step of every value of it,
    tiles straddling two requests included; what the rounding explains is
    not counted, and a value one step off is."""
    import torch

    from bench.harness import compare
    z, y, want = _served_wave(k)
    offs = compare.wave_offsets(1000, 4)
    assert offs == [0, 952, 976, 1000]
    for p in range(k):
        yt, zt = torch.from_numpy(y[p:p + 1]), torch.from_numpy(z[p:p + 1])
        got = compare.tile_steps(yt, offs)
        np.testing.assert_allclose(got.numpy(), want[p:p + 1], rtol=1e-6)
        assert compare.logits_err(yt, zt, got) < 1e-6
        assert compare.logits_err(yt, zt, None) > 1e-3
        off = yt.clone()
        off[0, 500] += got[0, 500]
        assert compare.logits_err(off, zt, got) > 0.2 / 127


def test_a_row_that_is_not_a_q8_row_reads_infinite():
    import torch

    from bench.harness import compare
    z, y, _ = _served_wave(2)
    yt = torch.from_numpy(y[1:2]).clone()
    yt[0, 700] += 1e-4
    steps = compare.tile_steps(yt, compare.wave_offsets(1000, 4))
    assert compare.logits_err(yt, torch.from_numpy(z[1:2]), steps) \
        == float("inf")


def test_host_cpu_per_request_and_per_token():
    from bench.harness import spec
    from bench.harness.load import Request, Run, Session
    run = Run("c", {}, {}, 1.0)
    run.requests = [Request(i, 0, 0.0, 0.0, done=(1.0 if i < 4 else None))
                    for i in range(5)]
    run.cpu_s = 0.2
    assert spec.metric("host_cpu_ms.resnet50").read(run) == pytest.approx(50)
    run.requests, run.sessions = [], [Session(0, 0, [1], 3, tokens=[1, 2])]
    assert spec.metric("host_cpu_ms.decode").read(run) == pytest.approx(100)
    assert spec.metric("host_cpu_ms.decode").read(Run("c", {}, {}, 1.0)) \
        is None


class _Event:
    def __init__(self, name, dev, a, b):
        self._v = (name, dev, a, b)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]


def test_the_window_mark_on_the_card_is_not_an_operation():
    """A thread that both opens the window's mark and launches kernels
    gets a copy of the mark on the card's timeline; it spans the window
    and must not count as busy."""
    from bench.harness.trace import WINDOW_MARK, read_events
    t = read_events([_Event(WINDOW_MARK, "DeviceType.CPU", 100, 1100),
                     _Event(WINDOW_MARK, "DeviceType.CUDA", 110, 1090),
                     _Event("k", "DeviceType.CUDA", 200, 300),
                     _Event("aten::mm", "DeviceType.CPU", 150, 400)])
    assert (t.start_ns, t.end_ns) == (100, 1100)
    assert t.device == [("k", 200, 300)]
    assert t.busy_s() == pytest.approx(100e-9)
