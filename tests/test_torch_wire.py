"""The port's wire layer against the reference: ``frame()`` bytes at every
supported version, ``encode_tree`` leaf naming and order, and blobs that
cross between the packages in both directions."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.runtime import wire as jw
from repro_torch.runtime import wire as tw

torch.set_num_threads(1)


def _items(w, version):
    """The same channel items built from one package's classes: envelopes
    (ok, error, retryable, pad_trim, tuple client ids), a fence with a
    plan, the stop/retire tokens and a control frame — restricted to what
    ``version`` can carry."""
    ext = dict(pad_trim=(3, 5)) if version >= 2 else {}
    if version >= 3:
        ext["attempt"] = 2
    extents = [w.RowExtent(7, ("cli", 1), 4, 2, t_submit=1.5, **ext),
               w.RowExtent(8, "b", 0, 1, t_submit=2.25)]
    items = [
        w.BatchEnvelope(extents, b"payload" * 9, epoch=3),
        w.BatchEnvelope(extents[1:], b"", error="Traceback: boom",
                        retryable=version >= 3),
        w._STOP, w._RETIRE,
        w.ControlFrame("hb", {"node": 1, "q": [1, 2], "t": ("x", 2)}),
        w.ReconfigMarker(5, {
            1: w.NodePlan(3, 9, b'{"layers": ["a"]}', b"\x00weights",
                          w.WireCodec("zfp", "lz4", zfp_rate=16,
                                      vectorized=False), wire_bytes=42),
            2: w.NodePlan(9, 12, b"{}", b"", w.WireCodec("raw", "none"))}),
    ]
    if version >= 4:
        items.append(w.BatchEnvelope(
            [w.RowExtent(9, "s", 1, 1, session="sess-1", pos=17,
                         kind=w.K_STEP)], b"tok"))
    return items


@pytest.mark.parametrize("version", [2, 3, 4])
def test_frame_bytes_identical(version):
    assert tw.FRAME_VERSION == jw.FRAME_VERSION
    for ji, ti in zip(_items(jw, version), _items(tw, version)):
        assert tw.frame(ti, version=version) == jw.frame(ji, version=version)


@pytest.mark.parametrize("version", [2, 3, 4])
def test_frames_cross_between_packages(version):
    unframe_j = jw.unframe if version == jw.FRAME_VERSION else jw.unframe_compat
    unframe_t = tw.unframe if version == tw.FRAME_VERSION else tw.unframe_compat
    for ji, ti in zip(_items(jw, version), _items(tw, version)):
        ref_blob = jw.frame(ji, version=version)
        port_blob = tw.frame(ti, version=version)
        # a reference blob through the port's unframe, re-framed, and the
        # other way round, both reproduce the same bytes
        assert tw.frame(unframe_t(ref_blob), version=version) == ref_blob
        assert jw.frame(unframe_j(port_blob), version=version) == port_blob


def test_stop_tokens_unframe_to_the_port_singletons():
    assert tw.unframe(jw.frame(jw._STOP)) is tw._STOP
    assert tw.unframe(jw.frame(jw._RETIRE)) is tw._RETIRE


def test_device_is_not_a_wire_field():
    c = tw.WireCodec("q8", "none", device="cpu")
    plan = tw.NodePlan(0, 1, b"{}", b"", c)
    back = tw.unframe(tw.frame(tw.ReconfigMarker(1, {0: plan})))
    assert back.plans[0].weights_codec.device is None
    assert back.plans[0].weights_codec == c          # device not compared
    assert tw.frame(tw.ReconfigMarker(1, {0: plan})) == jw.frame(
        jw.ReconfigMarker(1, {0: jw.NodePlan(0, 1, b"{}", b"",
                                             jw.WireCodec("q8", "none"))}))


def _tree(rng):
    return {"s1b0_add": rng.standard_normal((2, 8, 8, 16)).astype(np.float32),
            "": rng.standard_normal((2, 4)).astype(np.float32),
            "stem": {"w": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
                     "bias": np.arange(4, dtype=np.float32),
                     "scale": np.ones(4, np.float32)},
            "fc": {"b": np.zeros(3, np.float32),
                   "w": rng.standard_normal((4, 3)).astype(np.float32)},
            "relu": {}}


@pytest.mark.parametrize("codec", [("raw", "none"), ("zfp", "lz4"),
                                   ("json", "none"), ("q8", "none"),
                                   ("zfp", "none")])
def test_encode_tree_names_order_and_bytes_identical(codec):
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    jblob, jrec = jw.WireCodec(*codec, zfp_rate=16).encode_tree(tree, "data")
    tblob, trec = tw.WireCodec(*codec, zfp_rate=16,
                               device="cpu").encode_tree(tree, "data")
    assert tblob == jblob
    assert (trec.raw_bytes, trec.wire_bytes) == (jrec.raw_bytes,
                                                 jrec.wire_bytes)
    tflat, _ = tw.WireCodec(*codec, zfp_rate=16,
                            device="cpu").decode_tree(jblob)
    jflat, _ = jw.WireCodec(*codec, zfp_rate=16).decode_tree(tblob)
    assert list(tflat) == list(jflat) == [
        "", "fc/b", "fc/w", "s1b0_add", "stem/bias", "stem/scale", "stem/w"]
    for k in tflat:
        assert tflat[k].tobytes() == jflat[k].tobytes()
    nested = tw.tree_unflatten_paths(tflat)
    assert set(nested["stem"]) == {"w", "bias", "scale"}


def test_encode_tree_copies_tensors_to_the_host():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((2, 5)).astype(np.float32)
    codec = tw.WireCodec("raw", "none")
    blob_t, _ = codec.encode_tree({"x": torch.from_numpy(a),
                                   "y": [torch.ones(2), np.zeros(1)]}, "data")
    blob_n, _ = jw.WireCodec("raw", "none").encode_tree(
        {"x": a, "y": [np.ones(2, np.float32), np.zeros(1)]}, "data")
    assert blob_t == blob_n
    flat, _ = codec.decode_tree(blob_t)
    assert list(flat) == ["x", "y/0", "y/1"]


def test_wire_codec_fields_match_reference():
    jf = {f.name for f in dataclasses.fields(jw.WireCodec)}
    tf = {f.name for f in dataclasses.fields(tw.WireCodec)}
    assert tf - jf == {"device"} and jf <= tf
