"""The port's graph, partitioner and numpy codecs against the JAX package:
cut costs, partition cuts and codec blobs must be identical."""
import numpy as np
import pytest
import torch

from repro.core import codecs as jcodecs
from repro.core import partitioner as jpart
from repro.models import cnn as jcnn
from repro_torch import device as tdevice
from repro_torch.core import codecs as tcodecs
from repro_torch.core import partitioner as tpart
from repro_torch.core.graph import (TensorSpec, tree_bytes,
                                    tree_flatten_with_path)
from repro_torch.models import cnn as tcnn

torch.set_num_threads(1)

MODELS = ["resnet50", "vgg16", "vgg19"]


def _pair(name):
    if name == "resnet50":
        return (jcnn.resnet50(batch=1, image=64, num_classes=10),
                tcnn.resnet50(batch=1, image=64, num_classes=10))
    return jcnn.BUILDERS[name](1), tcnn.BUILDERS[name](1)


@pytest.mark.parametrize("name", MODELS)
def test_graph_structure_and_costs_match(name):
    jg, tg = _pair(name)
    assert [n.name for n in tg.nodes] == [n.name for n in jg.nodes]
    for jn, tn in zip(jg.nodes, tg.nodes):
        assert tuple(tn.inputs) == tuple(jn.inputs)
        assert tn.out_spec.shape == tuple(jn.out_spec.shape)
        assert tn.flops == jn.flops
        assert tn.param_bytes == jn.param_bytes
        assert tn.out_bytes == jn.out_bytes
        jspec = {p: tuple(s.shape) for p, s in _jax_paths(jn.param_spec)}
        tspec = {p: s.shape for p, s in tree_flatten_with_path(tn.param_spec)}
        assert tspec == jspec
    assert tg.total_flops == jg.total_flops
    assert tg.total_param_bytes == jg.total_param_bytes


def _jax_paths(tree):
    import jax
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(tuple(getattr(k, "key", k) for k in path), leaf)
            for path, leaf in flat]


@pytest.mark.parametrize("name", MODELS)
def test_crossing_names_and_cut_cost_identical_for_every_cut(name):
    jg, tg = _pair(name)
    for i in range(len(jg.nodes)):
        assert tg.crossing_names(i) == jg.crossing_names(i), i
        assert tg.cut_cost(i) == jg.cut_cost(i), i
    for lo in range(0, len(jg.nodes), 7):
        hi = min(len(jg.nodes), lo + 11)
        assert tg.boundary_names(lo, hi) == jg.boundary_names(lo, hi)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("strategy", ["equal_layers", "balanced_flops",
                                      "balanced_latency"])
@pytest.mark.parametrize("k", [2, 4])
def test_partition_cuts_identical(name, strategy, k):
    jg, tg = _pair(name)
    jp = jpart.partition(jg, k, strategy=strategy)
    tp = tpart.partition(tg, k, strategy=strategy)
    assert tp.cuts == jp.cuts
    assert tp.ranges() == jp.ranges()
    assert [s.out_bytes for s in tp.stages] == [s.out_bytes for s in jp.stages]
    assert tp.bottleneck_s == jp.bottleneck_s


def test_partition_cuts_identical_hetero_and_replicated():
    jg, tg = _pair("resnet50")
    comp = [jpart.ComputeModel(flops_per_s=f) for f in (10e9, 20e9, 40e9)]
    tcomp = [tpart.ComputeModel(flops_per_s=f) for f in (10e9, 20e9, 40e9)]
    link = dict(bandwidth_bytes_per_s=50e6, latency_s=1e-3)
    jp = jpart.partition(jg, 3, compute=comp, link=jpart.LinkModel(**link),
                         replicas=[1, 2, 1])
    tp = tpart.partition(tg, 3, compute=tcomp, link=tpart.LinkModel(**link),
                         replicas=[1, 2, 1])
    assert tp.cuts == jp.cuts
    assert tp.throughput_bottleneck_s == jp.throughput_bottleneck_s


@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("window", [None, 2])
def test_calibrated_partition_identical(staged, window):
    jg, _ = _pair("resnet50")
    rng = np.random.default_rng(0)
    n = len(jg.nodes)
    layer_s = rng.uniform(1e-4, 3e-3, n)
    cut_bytes = np.array([jg.cut_cost(i) for i in range(n)], np.float64)
    kw = dict(encode_s_per_byte=2e-9, decode_s_per_byte=1e-9,
              wire_s_per_byte=5e-10, head_in_bytes=49152.0,
              tail_out_bytes=40.0)
    jc = jpart.CalibratedCosts(layer_s, cut_bytes, **kw)
    tc = tpart.CalibratedCosts(layer_s, cut_bytes, **kw)
    prev = [0, n // 4, n // 2, 3 * n // 4, n] if window else None
    jb, jt = jpart.calibrated_partition(jc, 4, staged=staged,
                                        prev_bounds=prev, window=window,
                                        replicas=[1, 2, 1, 1])
    tb, tt = tpart.calibrated_partition(tc, 4, staged=staged,
                                        prev_bounds=prev, window=window,
                                        replicas=[1, 2, 1, 1])
    assert tb == jb and tt == jt


# -- numpy codecs: copied, so byte-identical ---------------------------------------

def _arrays():
    rng = np.random.default_rng(3)
    return [rng.standard_normal((1, 16, 16, 64)).astype(np.float32),
            (rng.standard_normal((7, 13)) * 100).astype(np.float32),
            np.maximum(rng.standard_normal((1, 8, 8, 32)), 0)
            .astype(np.float32),
            np.zeros((3, 5), np.float32)]


@pytest.mark.parametrize("i", range(4))
def test_json_codec_byte_identical(i):
    a = _arrays()[i]
    assert tcodecs.JsonCodec().encode(a) == jcodecs.JsonCodec().encode(a)


@pytest.mark.parametrize("i", range(4))
@pytest.mark.parametrize("vectorized", [True, False])
@pytest.mark.parametrize("rate", [8, 16, 24])
def test_zfp_codec_byte_identical(i, vectorized, rate):
    a = _arrays()[i]
    jb = jcodecs.ZfpCodec(rate=rate, vectorized=vectorized).encode(a)
    tb = tcodecs.ZfpCodec(rate=rate, vectorized=vectorized).encode(a)
    assert tb == jb
    back = tcodecs.ZfpCodec(rate=rate, vectorized=vectorized).decode(jb)
    ref = jcodecs.ZfpCodec(rate=rate, vectorized=vectorized).decode(tb)
    assert back.tobytes() == ref.tobytes()


@pytest.mark.parametrize("i", range(4))
@pytest.mark.parametrize("vectorized", [True, False])
def test_lz4_codec_byte_identical(i, vectorized):
    data = jcodecs.ZfpCodec(rate=16).encode(_arrays()[i])
    jb = jcodecs.Lz4Codec(vectorized=vectorized).compress(data)
    tb = tcodecs.Lz4Codec(vectorized=vectorized).compress(data)
    assert tb == jb
    assert tcodecs.Lz4Codec(vectorized=vectorized).decompress(jb) == data


def test_roundtrip_stats_match():
    a = _arrays()[0]
    jback, js = jcodecs.roundtrip(a, "zfp", "lz4", zfp_rate=16)
    tback, ts = tcodecs.roundtrip(a, "zfp", "lz4", zfp_rate=16)
    assert tback.tobytes() == jback.tobytes()
    assert (ts.raw_bytes, ts.wire_bytes) == (js.raw_bytes, js.wire_bytes)


# -- graph helpers and device rule ---------------------------------------------------

def test_tree_helpers_and_tensorspec():
    spec = TensorSpec((2, 3))
    assert spec.dtype == np.float32 and tree_bytes(spec) == 24
    tree = {"b": [np.zeros(2, np.int8), None], "a": {"y": torch.zeros(3),
                                                     "x": np.zeros(1)}}
    paths = [p for p, _ in tree_flatten_with_path(tree)]
    assert paths == [("a", "x"), ("a", "y"), ("b", 0)]
    assert tree_bytes(tree) == 8 + 12 + 2


def test_init_is_stable_across_processes_and_seeded():
    _, tg = _pair("resnet50")
    a, b = tg.init(seed=1), tg.init(seed=1)
    c = tg.init(seed=2)
    assert a["stem"]["w"].tobytes() == b["stem"]["w"].tobytes()
    assert a["stem"]["w"].tobytes() != c["stem"]["w"].tobytes()
    assert a["stem"]["w"].dtype == np.float32
    assert a["stem"]["w"].shape == (7, 7, 3, 64)


def test_device_rule_cuda_or_raise_cpu_only_when_asked():
    assert tdevice.get_device("cpu") == torch.device("cpu")
    tdevice.set_device("cpu")
    try:
        assert tdevice.get_device() == torch.device("cpu")
    finally:
        tdevice.set_device(None)
    if torch.cuda.is_available():
        assert tdevice.get_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdevice.get_device()
