"""The port's serving controller against the reference's
(``tests/test_controller.py``, test for test): cost calibration from
synthetic traces, hysteresis, adaptive knobs, weighted admission / quotas,
bucketed pad-to-shape batching, and zero-loss live repartitioning under
load, on the port's engine on the CPU.

The pure functions (``CostCalibrator``, ``decide_repartition``,
``decide_scale``, ``suggest_knobs``) are called in both packages on the
same synthetic snapshots: both sides do the same float64 numpy
arithmetic, so calibrated arrays and decisions must be identical, bit for
bit.  The live migration is made deterministic: stage 0 sleeps a fixed
time per wave, ``ewma_alpha=1``, and one explicit ``step()`` decides.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import LayerGraph as JLayerGraph
from repro.runtime import controller as jctl
from repro_torch.core.graph import LayerGraph, TensorSpec
from repro_torch.runtime import (AdmissionFull, ControllerConfig,
                                 CostCalibrator, DispatcherCodecs,
                                 InferenceEngine, TopologySpec, WireCodec,
                                 decide_repartition, decide_scale,
                                 suggest_knobs)
from repro_torch.runtime.dispatcher import _WeightedAdmissionQueue
from repro_torch.runtime.wire import _STOP

torch.set_num_threads(1)

D = 16

RAW = DispatcherCodecs(data=WireCodec("raw", "none"),
                       weights=WireCodec("raw", "none"))


def mlp_graph(depth: int = 8, d: int = D, rank3: bool = False) -> LayerGraph:
    shape = (1, 4, d) if rank3 else (1, d)
    g = LayerGraph("toy-mlp", TensorSpec(shape))
    prev = ""
    for i in range(depth):
        g.layer(f"fc{i}",
                lambda p, x: torch.tanh(x @ p["w"]),
                {"w": TensorSpec((d, d))},
                (prev,),
                TensorSpec(shape),
                flops=2.0 * d * d)
        prev = f"fc{i}"
    return g


def jax_mlp_graph(depth: int = 8, d: int = D) -> JLayerGraph:
    """The reference's twin of ``mlp_graph``: same names, shapes, FLOPs."""
    g = JLayerGraph("toy-mlp", jax.ShapeDtypeStruct((1, d), np.float32))
    prev = ""
    for i in range(depth):
        g.layer(f"fc{i}",
                lambda p, x: jnp.tanh(x @ p["w"]),
                {"w": jax.ShapeDtypeStruct((d, d), np.float32)},
                (prev,),
                jax.ShapeDtypeStruct((1, d), np.float32),
                flops=2.0 * d * d)
        prev = f"fc{i}"
    return g


def reference(g: LayerGraph, params, x: np.ndarray) -> np.ndarray:
    """Single-device apply of the whole graph on the CPU."""
    return g.apply(g.prepare(params, "cpu"), torch.from_numpy(x)).numpy()


def snap(node, n=16, compute_s=0.1, ser=0.01, des=0.01, mb=8, co=0.005,
         qd=1.0, bm=2.0):
    return {"node": node, "n": n, "compute_s": compute_s,
            "serialize_s": ser, "deserialize_s": des,
            "busy_decode_s": des, "busy_compute_s": compute_s,
            "busy_encode_s": ser, "queue_depth_mean": qd, "batch_mean": bm,
            "max_batch": mb, "coalesce_s": co, "payload_bytes": 0,
            "encodes": 1, "epoch": 0}


def sample(i: int, shape=(1, D)) -> np.ndarray:
    return np.random.default_rng(i).normal(size=shape).astype(np.float32)


def both_calibrators(depth: int, alpha: float):
    return (CostCalibrator(mlp_graph(depth), alpha=alpha),
            jctl.CostCalibrator(jax_mlp_graph(depth), alpha=alpha))


def assert_same_calibration(cal, jcal) -> None:
    assert cal.ready == jcal.ready and cal.updates == jcal.updates
    c, j = cal.costs(), jcal.costs()
    for f in ("layer_s", "cut_bytes"):
        a, b = getattr(c, f), getattr(j, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("encode_s_per_byte", "decode_s_per_byte", "wire_s_per_byte",
              "head_in_bytes", "tail_out_bytes"):
        assert getattr(c, f) == getattr(j, f), f


# -- calibrator + decision (synthetic traces) --------------------------------

def test_skewed_compute_moves_predicted_cut():
    """Node 0 measures 3x the per-request compute of node 1: the
    calibrated DP moves the cut to shrink node 0's range — in both
    packages, to the same cut with the same predictions."""
    cal, jcal = both_calibrators(8, 1.0)
    for c in (cal, jcal):
        c.update([snap(0, compute_s=0.30 * 16 / 16),
                  snap(1, compute_s=0.10)], [(0, 4), (4, 8)])
    assert cal.ready
    assert_same_calibration(cal, jcal)
    # measured per-layer time: node0's layers 3x node1's
    assert cal.layer_s[0] == pytest.approx(3 * cal.layer_s[4])
    dec = decide_repartition(cal.costs(), [0, 4, 8], 2, hysteresis=0.1)
    assert dec is not None
    assert dec["cuts"][0] < 4                  # fewer layers for node 0
    assert dec["predicted_new_s"] < dec["predicted_current_s"]
    assert dec == jctl.decide_repartition(jcal.costs(), [0, 4, 8], 2,
                                          hysteresis=0.1)


def test_hysteresis_holds_on_noisy_traces():
    """A few percent of imbalance (noise) must NOT trigger a migration."""
    cal, jcal = both_calibrators(8, 1.0)
    for c in (cal, jcal):
        c.update([snap(0, compute_s=0.105), snap(1, compute_s=0.100)],
                 [(0, 4), (4, 8)])
    assert_same_calibration(cal, jcal)
    assert decide_repartition(cal.costs(), [0, 4, 8], 2,
                              hysteresis=0.15) is None
    assert jctl.decide_repartition(jcal.costs(), [0, 4, 8], 2,
                                   hysteresis=0.15) is None


def test_calibrator_not_ready_until_all_nodes_report():
    cal, jcal = both_calibrators(8, 0.4)
    for c in (cal, jcal):
        c.update([snap(0), snap(1, n=0)], [(0, 4), (4, 8)])
    assert not cal.ready                       # node 1 had no traffic yet
    assert_same_calibration(cal, jcal)
    for c in (cal, jcal):
        c.update([snap(0), snap(1)], [(0, 4), (4, 8)])
    assert cal.ready
    assert_same_calibration(cal, jcal)


def test_ewma_converges_and_smooths():
    cal, jcal = both_calibrators(4, 0.5)
    first = cal.layer_s.copy()
    for _ in range(12):
        for c in (cal, jcal):
            c.update([snap(0, compute_s=0.2)], [(0, 4)])
    per_layer = 0.2 / 16 / 4                   # per-request / layers
    assert np.allclose(cal.layer_s, per_layer, rtol=0.02)
    assert not np.allclose(first, cal.layer_s)
    assert_same_calibration(cal, jcal)


def test_suggest_knobs_codec_vs_compute_bound():
    def knobs(s, **kw):
        got = suggest_knobs(s, **kw)
        assert got == jctl.suggest_knobs(s, **kw)     # bit for bit
        return got

    codec_bound = snap(0, compute_s=0.05, ser=0.5, des=0.4, qd=6.0, bm=5.0)
    mb, co = knobs(codec_bound, cap=16)
    assert co > codec_bound["coalesce_s"]      # grow the coalescing window
    assert mb > codec_bound["max_batch"]       # backlogged: grow batches
    compute_bound = snap(0, compute_s=0.5, ser=0.01, des=0.01, qd=0.2,
                         bm=1.0)
    mb2, co2 = knobs(compute_bound, cap=16)
    assert co2 < compute_bound["coalesce_s"]   # shrink toward low latency
    assert mb2 < compute_bound["max_batch"]
    # clamps hold at the extremes (backlogged codec-bound node at the cap)
    lo, hi = 0.0005, 0.04
    s = snap(0, compute_s=0.01, ser=1.0, des=1.0, co=hi, qd=6.0, bm=2.0)
    assert knobs(s, cap=16, coalesce_bounds=(lo, hi))[1] == hi
    # no backlog: a codec-bound node still SHRINKS its window
    s = snap(0, compute_s=0.01, ser=1.0, des=1.0, co=0.01, qd=0.5, bm=1.0)
    assert knobs(s, cap=16)[1] < 0.01
    # the window never grows past the measured per-wave service time
    s = snap(0, n=16, compute_s=0.001, ser=0.008, des=0.008, co=0.005,
             qd=6.0, bm=2.0)
    wave_service = (0.001 + 0.016) / (16 / 2)
    assert knobs(s, cap=16)[1] <= wave_service
    # fully saturated codec-bound node (every wave FULL): max_batch still
    # grows toward the cap even though the coalesce branch is inactive
    s = snap(0, compute_s=0.05, ser=0.5, des=0.4, qd=8.0, bm=8.0, mb=8)
    mb3, co3 = knobs(s, cap=32)
    assert mb3 == 16 and co3 == s["coalesce_s"]


@pytest.mark.parametrize("seed", range(6))
def test_pure_decisions_identical_on_random_windows(seed):
    """Several telemetry windows of random skew through both packages'
    calibrators, then every decision function on the result: repartition
    (with and without a warm-start window, over replicas), scale, and the
    knob law per stage — identical, bit for bit."""
    rng = np.random.default_rng(seed)
    depth, stages = 12, 4
    cal, jcal = both_calibrators(depth, float(rng.uniform(0.2, 1.0)))
    bounds = [0, 3, 6, 9, depth]
    ranges = list(zip(bounds, bounds[1:]))
    reps = [int(r) for r in rng.integers(1, 4, stages)]
    for _ in range(4):
        snaps = [snap(i, n=int(rng.integers(0, 40)),
                      compute_s=float(rng.uniform(0.01, 0.5)),
                      ser=float(rng.uniform(0.0, 0.05)),
                      des=float(rng.uniform(0.0, 0.05)),
                      mb=int(rng.choice([2, 4, 8])),
                      co=float(rng.uniform(0.0005, 0.02)),
                      qd=float(rng.uniform(0.0, 8.0)),
                      bm=float(rng.uniform(0.5, 8.0)))
                 for i in range(stages)]
        for c in (cal, jcal):
            c.update(snaps, ranges)
        assert_same_calibration(cal, jcal)
        for s in snaps:
            assert suggest_knobs(s, 16) == jctl.suggest_knobs(s, 16)
    for staged in (True, False):
        for window in (None, 2):
            kw = dict(staged=staged, hysteresis=0.05, window=window,
                      replicas=reps)
            assert decide_repartition(cal.costs(), bounds, stages, **kw) \
                == jctl.decide_repartition(jcal.costs(), bounds, stages,
                                           **kw)
        kw = dict(staged=staged, max_replicas=4, up_ratio=1.2,
                  down_ratio=1.5)
        assert decide_scale(cal.costs(), bounds, reps, **kw) \
            == jctl.decide_scale(jcal.costs(), bounds, reps, **kw)


def test_encode_rate_is_the_tail_stages_in_both_packages():
    """The calibrator keeps ONE per-byte encode rate, folded over the
    stages in order: at ``ewma_alpha=1`` the tail's wins, and the tail
    encodes ResNet50's 4 KB of logits at a fixed per-call cost.  With the
    per-request seconds the H100 measured on slice A's chain (stage 0
    slowed), that rate prices stage 0's 1.6 MB cut at ~6.8x the 2.9 ms
    stage 0 took to encode it — the same in both packages (ROADMAP queue
    3 item 6)."""
    from repro.models import cnn as jcnn
    from repro_torch.models import cnn as tcnn
    tg, jg = tcnn.resnet50(batch=1), jcnn.resnet50(batch=1)
    ranges = [(0, 4), (4, 20), (20, 37), (37, 72)]
    # per request (s): deserialize, compute, serialize; 16 requests a stage
    per = [(1.70e-3, 9.16e-3, 2.89e-3), (2.66e-3, 14.9e-3, 4.09e-3),
           (2.64e-3, 9.26e-3, 1.68e-3), (1.59e-3, 4.71e-3, 4.91e-5)]
    snaps = [snap(i, compute_s=16 * c, ser=16 * e, des=16 * d)
             for i, (d, c, e) in enumerate(per)]
    cal = CostCalibrator(tg, alpha=1.0)
    jcal = jctl.CostCalibrator(jg, alpha=1.0)
    for c in (cal, jcal):
        c.update(snaps, ranges)
    assert_same_calibration(cal, jcal)
    assert cal.encode_s_per_byte == per[3][2] / cal.tail_out_bytes
    priced = cal.encode_s_per_byte * cal.cut_bytes[3]
    assert cal.cut_bytes[3] == 1605632.0
    assert priced / per[0][2] == pytest.approx(6.8, rel=0.01)


def test_controller_delta_identical():
    """The interval diff the controller calibrates on: a fresh baseline,
    a normal interval, and a counter that went down (skipped)."""
    from repro_torch.runtime.controller import Controller
    keys = Controller._COUNTERS
    prev = {k: 10 for k in keys}
    cur = {k: 10 + i for i, k in enumerate(keys)}
    down = dict(cur, n=0)
    for p, c in ((None, cur), (prev, cur), (cur, down)):
        assert Controller._delta(p, c) == jctl.Controller._delta(p, c)
    assert ControllerConfig() == ControllerConfig(
        **vars(jctl.ControllerConfig()))


# -- weighted admission queue + quotas ---------------------------------------

def test_weighted_dequeue_proportional_no_starvation():
    q = _WeightedAdmissionQueue(64)
    for i in range(10):
        q.put(("p0", i), priority=0)
        q.put(("p1", i), priority=1)
    first9 = [q.get() for _ in range(9)]
    # weight 2:1 — priority 1 gets ~2/3 of dequeues while both backlogged
    bands = [b for b, _ in first9]
    assert bands.count("p1") == 6 and bands.count("p0") == 3
    # FIFO within a band
    p1_idx = [i for b, i in first9 if b == "p1"]
    assert p1_idx == sorted(p1_idx)
    rest = [q.get() for _ in range(11)]
    assert len(rest) == 11                     # nothing lost


def test_stop_never_overtakes_queued_requests():
    q = _WeightedAdmissionQueue(8)
    q.put("a", priority=0)
    q.put("b", priority=5)
    q.put(_STOP)
    assert q.get() is not _STOP
    assert q.get() is not _STOP
    assert q.get() is _STOP                    # surfaced only when drained


def test_client_quota_enforced_and_released():
    g = mlp_graph(6)
    params = g.init(0)
    eng = InferenceEngine(g, 2, RAW, max_batch=2, client_quota=3,
                          device="cpu")
    eng.configure(params)
    gate = threading.Event()
    node0 = eng.dispatcher.nodes[0]
    orig = node0._apply
    node0._apply = lambda b: (gate.wait(timeout=60), orig(b))[1]
    try:
        futs = [eng.submit(sample(i), client_id="greedy") for i in range(3)]
        with pytest.raises(AdmissionFull, match="quota"):
            eng.submit(sample(9), client_id="greedy")
        # another client is unaffected by the greedy one's quota
        other = eng.submit(sample(10), client_id="polite")
        gate.set()
        for f in futs + [other]:
            f.result(timeout=120)
        # quota released: the greedy client can admit again
        eng.submit(sample(11), client_id="greedy").result(timeout=120)
    finally:
        gate.set()
        eng.shutdown()


def test_priority_submit_end_to_end():
    g = mlp_graph(6)
    params = g.init(0)
    eng = InferenceEngine(g, 2, RAW, max_batch=4, device="cpu")
    try:
        eng.configure(params)
        futs = [eng.submit(sample(i), client_id=i % 2, priority=i % 3)
                for i in range(9)]
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(timeout=120),
                                       reference(g, params, sample(i)),
                                       atol=1e-5)
    finally:
        eng.shutdown()


# -- bucketed pad-to-shape (heterogeneous trailing shapes) -------------------

def _stalled_pair(eng, node, shapes):
    """Deterministically land ``shapes``' requests in ONE compute merge
    (the reference's ``tests/test_topology.py::_stalled_pair``): a plug
    request provably occupies the gated apply first (so it cannot absorb
    them), the pair is decoded into the compute queue behind it, and the
    gate opens only once every pair extent is queued; the next merge then
    drains them together.  Returns the pair's futures."""
    gate = threading.Event()
    entered = threading.Event()
    orig = node._apply

    def gated(b):
        entered.set()
        gate.wait(timeout=60)
        return orig(b)

    node._apply = gated
    try:
        plug = eng.submit(sample(39, (1, 3, D)))
        assert entered.wait(timeout=60)     # compute thread is inside apply
        futs = [eng.submit(sample(40 + i, s)) for i, s in enumerate(shapes)]

        def decoded_parts():                # pair extents decoded and queued
            return sum(len(d.extents) for w in list(node._to_compute.queue)
                       if isinstance(w, list) for d in w)

        deadline = time.perf_counter() + 10
        while decoded_parts() < len(shapes) \
                and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert decoded_parts() == len(shapes)
    finally:
        gate.set()
    plug.result(timeout=60)
    return futs


def test_pow2_buckets_merge_near_miss_shapes():
    """(1, 5, D) and (1, 7, D) pad to (1, 8, D), merge into ONE apply and
    ONE encode, and come back trimmed to their original shapes with
    per-request reference numerics.  The pair is stalled behind a plug
    request until both are in the compute queue, so the merge does not
    depend on thread timing."""
    g = mlp_graph(6, rank3=True)
    params = g.init(0)
    eng = InferenceEngine(g, 2, RAW, max_batch=8, shape_buckets="pow2",
                          device="cpu")
    eng.configure(params)
    node0 = eng.dispatcher.nodes[0]
    shapes = [(1, 5, D), (1, 7, D)]
    try:
        futs = _stalled_pair(eng, node0, shapes)
        outs = [f.result(timeout=120) for f in futs]
    finally:
        eng.shutdown()
    for i, (shape, out) in enumerate(zip(shapes, outs)):
        x = sample(40 + i, shape)
        assert out.shape == x.shape            # trimmed back, not padded
        np.testing.assert_allclose(out, reference(g, params, x), atol=1e-5)
    merged = max(node0.traces, key=lambda t: t.n)
    assert merged.n == 2 and merged.encodes == 1   # one bucket, one pass


def test_exact_buckets_keep_shapes_separate():
    """Default mode: near-miss shapes stay in their own buckets."""
    g = mlp_graph(4, rank3=True)
    params = g.init(0)
    eng = InferenceEngine(g, 2, RAW, max_batch=8, device="cpu")
    eng.configure(params)
    gate = threading.Event()
    node0 = eng.dispatcher.nodes[0]
    orig = node0._apply
    node0._apply = lambda b: (gate.wait(timeout=60), orig(b))[1]
    try:
        futs = [eng.submit(sample(1, (1, 5, D))),
                eng.submit(sample(2, (1, 7, D)))]
        time.sleep(0.2)
        gate.set()
        for f in futs:
            f.result(timeout=120)
    finally:
        gate.set()
        eng.shutdown()
    assert all(t.encodes == t.n or t.n == 1 for t in node0.traces)


# -- live repartition: zero loss, FIFO preserved -----------------------------

def test_live_repartition_zero_loss_fifo_under_load():
    """Two hot repartitions while client threads stream: every request
    resolves with reference numerics, per-client FIFO holds, and the
    chain's threads survive."""
    g = mlp_graph(8)
    params = g.init(0)
    eng = InferenceEngine(g, TopologySpec.chain(g, 3, cuts=(5, 7)), RAW,
                          max_batch=4, device="cpu")
    per_client, n_clients = 14, 3
    results: dict[int, list] = {}
    errors: list = []

    def client(c):
        try:
            xs = [sample(100 * c + i) for i in range(per_client)]
            results[c] = list(eng.submit_stream(xs, client_id=c))
        except Exception as e:                  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    try:
        eng.configure(params)
        eng.start()
        for t in threads:
            t.start()
        rec1 = eng.dispatcher.reconfigure((3, 6))
        rec2 = eng.dispatcher.reconfigure((2, 4))
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        rep = eng.report()
    finally:
        eng.shutdown()
    assert not errors
    assert rec1["changed"] and rec1["acknowledged"]
    assert rec2["changed"] and rec2["acknowledged"]
    assert rep.epoch == 2 and rep.cuts == (2, 4)
    # zero loss + per-client FIFO: result i is exactly input i's output
    for c in range(n_clients):
        assert len(results[c]) == per_client
        for i, got in enumerate(results[c]):
            np.testing.assert_allclose(
                got, reference(g, params, sample(100 * c + i)), atol=1e-5)


def test_reconfigure_ships_only_weight_diff():
    """A one-layer boundary shift ships ~one layer of weights, not the
    whole model."""
    g = mlp_graph(8)
    params = g.init(0)
    eng = InferenceEngine(g, 2, RAW, max_batch=2, device="cpu")
    try:
        eng.configure(params)
        eng.start()
        one_layer = D * D * 4
        rec = eng.dispatcher.reconfigure((3,))  # (0,4),(4,8) -> (0,3),(3,8)
    finally:
        eng.shutdown()
    assert rec["moved_layers"] == 1
    assert one_layer <= rec["shipped_bytes"] <= 3 * one_layer


def test_reconfigure_across_paramless_layers():
    """CNN-style graphs interleave param-less layers (pool / add /
    activation): they produce no wire weights, and a migration across
    them must still commit."""
    g = LayerGraph("mixed", TensorSpec((1, D)))
    prev = ""
    for i in range(8):
        if i % 2:
            g.layer(f"relu{i}", lambda p, x: torch.relu(x), {},
                    (prev,), TensorSpec((1, D)), flops=float(D))
            prev = f"relu{i}"
        else:
            g.layer(f"fc{i}",
                    lambda p, x: torch.tanh(x @ p["w"]),
                    {"w": TensorSpec((D, D))},
                    (prev,), TensorSpec((1, D)), flops=2.0 * D * D)
            prev = f"fc{i}"
    params = g.init(0)
    eng = InferenceEngine(g, 2, RAW, max_batch=2, device="cpu")
    try:
        eng.configure(params)
        eng.start()
        rec = eng.dispatcher.reconfigure((3,))  # boundary lands on relu3
        assert rec["changed"] and rec["acknowledged"]
        out = eng.submit(sample(5)).result(timeout=120)
        np.testing.assert_allclose(out, reference(g, params, sample(5)),
                                   atol=1e-5)
        for node in eng.dispatcher.nodes:
            assert all(t.is_alive() for t in node._threads)
    finally:
        eng.shutdown()


def test_reconfigure_noop_and_validation():
    g = mlp_graph(8)
    params = g.init(0)
    eng = InferenceEngine(g, 2, RAW, device="cpu")
    try:
        eng.configure(params)
        eng.start()
        assert eng.dispatcher.reconfigure((4,))["changed"] is False
        with pytest.raises(ValueError):
            eng.dispatcher.reconfigure((2, 5))  # wrong stage count
    finally:
        eng.shutdown()


# -- controller closes the loop on a real chain ------------------------------

def test_controller_migrates_off_slow_node_and_keeps_serving():
    """Stage 0 sleeps 50 ms per wave; one explicit controller step must
    calibrate, migrate layers off stage 0 (epoch 1), and every request
    after the swap must resolve with reference numerics: the slow wrapper
    went with the migrated partition's fresh apply.  Deterministic: the
    injected sleep dwarfs every other stage's compute whatever the host's
    load, ``ewma_alpha=1``, and no assertion is on wall time."""
    g = mlp_graph(9)
    params = g.init(0)
    cfg = ControllerConfig(interval_s=30.0, ewma_alpha=1.0, hysteresis=0.05,
                           min_requests=8, cooldown_s=0.0,
                           precompile_after_swap=True)
    eng = InferenceEngine(g, 3, RAW, max_batch=4, controller=cfg,
                          device="cpu")
    try:
        eng.configure(params)
        eng.start()                             # controller thread idles
        node0 = eng.dispatcher.nodes[0]
        orig = node0._apply
        slow = node0._apply = lambda b: (time.sleep(0.05), orig(b))[1]
        futs = [eng.submit(sample(i), client_id=i % 2) for i in range(12)]
        for f in futs:
            f.result(timeout=120)
        action = eng.controller.step()          # deterministic period
        assert action.kind == "repartition", action
        assert action.detail["acknowledged"]
        assert action.detail["nodes_touched"][0] == 0
        assert eng.dispatcher.partition.ranges()[0][1] < 3   # stage 0 shrank
        assert node0._apply not in (slow, orig)  # fresh apply, no sleep
        futs = [eng.submit(sample(100 + i)) for i in range(6)]
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(timeout=120),
                                       reference(g, params, sample(100 + i)),
                                       atol=1e-5)
        rep = eng.report()
    finally:
        eng.shutdown()
    assert rep.epoch == 1
    assert eng.controller.migrations == 1
    assert [a.kind for a in eng.controller.actions] == ["repartition"]
    assert eng.controller._thread is None       # shutdown joined it


def test_controller_holds_on_balanced_chain():
    """On a cost-balanced chain the deadband keeps the cuts put (a wide
    hysteresis: tiny windows on tiny layers are noisy; the tight-threshold
    semantics are covered synthetically above)."""
    g = mlp_graph(9)
    params = g.init(0)
    cfg = ControllerConfig(interval_s=30.0, min_requests=4, hysteresis=0.75,
                           cooldown_s=0.0, adapt_knobs=False)
    eng = InferenceEngine(g, 3, RAW, max_batch=4, controller=cfg,
                          device="cpu")
    try:
        eng.configure(params)
        eng.start()
        for i in range(8):
            eng.submit(sample(i)).result(timeout=120)
        action = eng.controller.step()
    finally:
        eng.shutdown()
    assert action.kind == "hold"
    assert eng.controller.migrations == 0


def test_report_raw_utilization_unclamped():
    """util_*_raw report busy/wall honestly (can exceed the clamped 1.0
    ceiling); clamped fields stay within [0, 1]."""
    g = mlp_graph(6)
    params = g.init(0)
    eng = InferenceEngine(g, 2, RAW, max_batch=4, device="cpu")
    try:
        eng.configure(params)
        _, rep = eng.run([sample(i) for i in range(6)])
    finally:
        eng.shutdown()
    for pn in rep.per_node:
        for stage in ("decode", "compute", "encode"):
            raw, clamped = pn[f"util_{stage}_raw"], pn[f"util_{stage}"]
            assert raw >= 0.0 and 0.0 <= clamped <= 1.0
            assert clamped == min(1.0, raw)
        assert pn["max_batch"] >= 1 and pn["coalesce_s"] >= 0.0
