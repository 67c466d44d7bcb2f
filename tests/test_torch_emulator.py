"""The port's emulator, H100 profile and paper benchmarks against the
reference's.

``emulate`` measures codec time on real arrays, so parity holds on every
field that does not depend on timing: each stage's compute seconds
(FLOPs over the profile's peak), transfer seconds (chunks and wire bytes
over the link), wire bytes, and the single-device figures.  Those must
be identical: the port's JSON/ZFP/LZ4 codecs are the reference's numpy
code and the partitioner is the same.  Figures 2 and 3 and Tables I and
II are checked row for row on their timing-free columns.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from benchmarks import (fig2_throughput, fig3_energy, table1_codecs,
                        table2_codec_throughput, torch_fig2_throughput,
                        torch_fig3_energy, torch_table1_codecs,
                        torch_table2_codec_throughput)
from repro.core import emulator as jemu
from repro.core import metrics as jmetrics
from repro.models import cnn as jcnn
from repro_torch.core import emulator as temu
from repro_torch.core import metrics as tmetrics
from repro_torch.models import cnn as tcnn

torch.set_num_threads(1)

# (model, nodes, serializer, compression, replicas): the paper's chains
# at 4/6/8 nodes, both data codecs with and without LZ4 at 4, and one
# replicated topology
RUNS = [("resnet50", n, "zfp", "none", None) for n in (4, 6, 8)] \
    + [("vgg16", n, "zfp", "none", None) for n in (4, 6, 8)] \
    + [("resnet50", 4, "json", "none", None),
       ("resnet50", 4, "zfp", "lz4", None),
       ("resnet50", 4, "zfp", "none", (1, 2, 1, 1))]


@functools.lru_cache(maxsize=None)
def _graphs(model: str):
    return jcnn.BUILDERS[model](batch=1), tcnn.BUILDERS[model](batch=1)


@functools.lru_cache(maxsize=None)
def _reports(model, nodes, ser, comp, replicas):
    jg, tg = _graphs(model)
    reps = list(replicas) if replicas else None
    return (jemu.emulate(jg, nodes, jemu.CodecConfig(ser, comp, 16),
                         replicas=reps),
            temu.emulate(tg, nodes, temu.CodecConfig(ser, comp, 16),
                         replicas=reps))


@pytest.mark.parametrize("run", RUNS, ids=lambda r: "-".join(
    str(v) for v in r if v is not None))
def test_emulate_timing_free_fields_identical(run):
    j, t = _reports(*run)
    for f in ("model", "num_nodes", "codec", "single_device_cps",
              "single_device_energy_j", "total_payload_mb", "replicas"):
        assert getattr(t, f) == getattr(j, f), f
    assert len(t.stages) == len(j.stages) == run[1]
    for ts, js in zip(t.stages, j.stages):
        # compute_s is the stage's FLOPs over the peak; transfer_s its
        # chunks' latency plus its wire bytes over the link
        for f in ("node", "compute_s", "transfer_s", "payload_bytes",
                  "replicas"):
            assert getattr(ts, f) == getattr(js, f), f
    jg, tg = _graphs(run[0])
    stage_flops = [s.compute_s * tmetrics.EDGE.peak_flops for s in t.stages]
    assert sum(stage_flops) == pytest.approx(tg.total_flops, rel=1e-12)
    assert all(np.isfinite(r.throughput_cps) and r.throughput_cps > 0
               for r in (t, j))


@pytest.mark.parametrize("ser,comp", [("zfp", "none"), ("json", "none")])
def test_measure_wire_and_config_step_payload_identical(ser, comp):
    jg, tg = _graphs("resnet50")
    for shape in ((1, 56, 56, 256), (1, 1000)):
        jw = jemu.measure_wire(shape, jemu.CodecConfig(ser, comp, 16))
        tw = temu.measure_wire(shape, temu.CodecConfig(ser, comp, 16))
        assert (tw.raw_bytes, tw.wire_bytes, tw.chunks) \
            == (jw.raw_bytes, jw.wire_bytes, jw.chunks)
    j = jemu.emulate_config_step(jg, 4, jemu.CodecConfig(ser, comp, 16))
    t = temu.emulate_config_step(tg, 4, temu.CodecConfig(ser, comp, 16))
    assert set(t) == set(j) == {"architecture", "weights", "data"}
    for kind in j:
        assert (t[kind].kind, t[kind].codec, t[kind].payload_mb) \
            == (j[kind].kind, j[kind].codec, j[kind].payload_mb), kind


def test_emulator_reproduces_paper_scaling():
    """DEFER's Fig-2/Fig-3 claims on the port's emulated chain: ResNet50
    with 8 nodes beats single-device throughput; per-node energy drops
    with more nodes (twin of tests/test_system.py)."""
    g = tcnn.resnet50(batch=1)
    cfg = temu.CodecConfig(serializer="zfp", compression="none", zfp_rate=16)
    reports = {n: temu.emulate(g, n, cfg) for n in (4, 6, 8)}
    r8 = reports[8]
    assert r8.speedup > 1.0, f"8-node speedup {r8.speedup:.2f}"
    e = [reports[n].per_node_energy_j for n in (4, 6, 8)]
    assert e[2] < e[1] < e[0]
    assert reports[8].per_node_energy_j < reports[8].single_device_energy_j


def test_emulator_codec_table_ordering():
    """Table II: ZFP beats JSON for inter-node data payload."""
    _, zfp = _reports("resnet50", 4, "zfp", "none", None)
    _, js = _reports("resnet50", 4, "json", "none", None)
    assert zfp.total_payload_mb < js.total_payload_mb


def test_h100_profile_and_roofline_default():
    h = tmetrics.H100
    assert (h.peak_flops, h.hbm_bw, h.link_bw, h.tdp_w,
            h.energy_per_bit_j, h.idle_w) \
        == (67e12, 3.35e12, 64e9, 700.0, 10e-12, 0.0)
    # the port's roofline prices the H100; the reference's the TPU
    t = tmetrics.roofline(67e12, 3.35e12 * 2, 64e9 * 4, chips=1)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 2.0, 4.0)
    assert t.dominant == "collective"
    j = jmetrics.roofline(197e12, 0.0, 0.0, chips=1)
    assert j.compute_s == 1.0
    # the reference's profiles stay in the port, field for field
    for name in ("EDGE", "TPU_V5E"):
        assert vars(getattr(tmetrics, name)) == vars(getattr(jmetrics, name))
    # an emulated chain of H100s: single-device rate is FLOPs over peak
    g = tcnn.resnet50(batch=1)
    rep = temu.emulate(g, 4, temu.CodecConfig("zfp", "none", 16), hw=h)
    assert rep.single_device_cps == 1.0 / (g.total_flops / h.peak_flops)
    assert rep.single_device_energy_j == g.total_flops / h.peak_flops * 700.0


def _graph_only(builders):
    """A benchmark's graph cache without its params, which no emulated
    figure reads: initialising VGG16/19 twice (JAX and numpy) would cost
    ~20 s and ~3 GB here."""
    return lambda model, batch=1: (builders[model](batch=batch), None)


def test_fig2_rows_equal_reference(monkeypatch):
    monkeypatch.setattr(fig2_throughput, "graph_and_params",
                        _graph_only(jcnn.BUILDERS))
    monkeypatch.setattr(torch_fig2_throughput, "graph_and_params",
                        _graph_only(tcnn.BUILDERS))
    j, t = fig2_throughput.run(), torch_fig2_throughput.run()
    assert [list(r) for r in t] == [list(r) for r in j]
    for tr, jr in zip(t, j):
        keys = ["model", "nodes", "single_device_cps"]
        if jr["nodes"] == 1:                    # the single-device row
            keys += ["throughput_cps", "speedup"]
        assert {k: tr[k] for k in keys} == {k: jr[k] for k in keys}


def test_fig3_rows_equal_reference(monkeypatch):
    """Through the port's own graph cache (numpy params from
    ``LayerGraph.init``); the reference's skips its JAX init."""
    monkeypatch.setattr(fig3_energy, "graph_and_params",
                        _graph_only(jcnn.BUILDERS))
    j, t = fig3_energy.run(), torch_fig3_energy.run()
    g, params = torch_fig3_energy.graph_and_params("resnet50")
    assert set(params) == {n.name for n in g.nodes}
    assert [list(r) for r in t] == [list(r) for r in j]
    for tr, jr in zip(t, j):
        for k in ("nodes", "single_device_energy_j"):
            assert tr[k] == jr[k], k
        assert tr["energy_ratio"] > 0 and np.isfinite(tr["energy_ratio"])


def _one_config(monkeypatch, module, name, want, builders):
    """Run a table's harness with every configuration computed as
    ``want``: the rows it labels ``want`` are then genuine and cheap (its
    JSON/LZ4 rows alone take ~35 s here); the others are dropped."""
    real = getattr(module, name)

    def only(graph, nodes, cfg, *args, **kw):
        return real(graph, nodes, dataclasses.replace(
            cfg, serializer=want[0], compression=want[1]), *args, **kw)

    monkeypatch.setattr(module, name, only)
    monkeypatch.setattr(module, "graph_and_params", _graph_only(builders))
    return [r for r in module.run()
            if (r["serialization"], r["compression"]) == (want[0].upper(),
                                                          "Uncompressed")]


def test_table1_rows_for_one_config(monkeypatch):
    """Table I's rows for ZFP/uncompressed: the reference's keys and
    rows, payloads to the byte."""
    j = _one_config(monkeypatch, table1_codecs, "emulate_config_step",
                    ("zfp", "none"), jcnn.BUILDERS)
    t = _one_config(monkeypatch, torch_table1_codecs, "emulate_config_step",
                    ("zfp", "none"), tcnn.BUILDERS)
    assert [r["type"] for r in t] == ["weights", "data"]
    assert [list(r) for r in t] == [list(r) for r in j]
    for tr, jr in zip(t, j):
        for k in ("type", "serialization", "compression", "payload_mb"):
            assert tr[k] == jr[k], k
    assert [(c.upper(), m) for c, m in torch_table1_codecs.CONFIGS] \
        == [("JSON", "lz4"), ("JSON", "none"), ("ZFP", "lz4"),
            ("ZFP", "none")]


def test_table2_row_for_one_config(monkeypatch):
    j = _one_config(monkeypatch, table2_codec_throughput, "emulate",
                    ("zfp", "none"), jcnn.BUILDERS)
    t = _one_config(monkeypatch, torch_table2_codec_throughput, "emulate",
                    ("zfp", "none"), tcnn.BUILDERS)
    assert len(t) == len(j) == 1
    assert list(t[0]) == list(j[0])
    for k in ("serialization", "compression", "payload_mb"):
        assert t[0][k] == j[0][k], k
    assert torch_table2_codec_throughput.CONFIGS \
        == torch_table1_codecs.CONFIGS
