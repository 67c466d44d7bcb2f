"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # on a machine with a CUDA card

Phases, each printing JSON records on their own lines:

1. the card (name and power limit as ``nvidia-smi`` gives them), the torch
   and CUDA versions, the compute capability;
2. the build of every CUDA source under ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, started together), with its time and the
   assembler's register report;
3. each kernel against its plain PyTorch version on the card, byte for
   byte, at the wire shapes and on edge-case tiles; after the main path,
   both are timed with CUDA events at those shapes, on the device (calls
   captured in a CUDA graph and replayed) and per call from Python, with
   inputs rotated through more than the 50 MB L2, beside the byte bound;
4. the main path at full width: ResNet50 (224x224, 1000 classes, seeded
   fan-in-scaled weights) cut by ``balanced_latency`` into a 4-stage chain
   with one replicated stage, served by ``InferenceEngine(device="cuda")``
   with the raw, q8 and zfp/lz4 codecs over ``inproc`` and q8 over
   ``tcp``, each engine serving its requests twice (first and warm
   window); outputs are held against single-device ``apply`` on the card
   (TF32 off) and on the CPU, and the block-quant launch counters must
   rise during the main path.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result; so does a machine without CUDA.
``--cpu-rehearsal`` runs phase 4 on the CPU at image 64 (no kernel
build), to rehearse the control flow without a card; it never prints a
result and exits 3.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import block_quant as bq  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.runtime import (DispatcherCodecs, InferenceEngine,  # noqa: E402
                                 TopologySpec, WireCodec)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_OPS_PER_S = 67e12            # H100 SXM, float32 outside the tensor cores
SWEEP = [(8, 128), (2048, 128), (4096, 128), (32768, 128), (1024, 512)]
RAW_TOL_REL = 1e-4      # chain vs single-device on the card: batched cuDNN
CPU_TOL_REL = 1e-3      # card vs CPU apply (different conv algorithms)
Q8_REL = 0.05           # 5 quantize passes, each within absmax/254
ZFP_REL = 0.15          # the reference's bar for ZFP-16 + LZ4


def emit(**rec) -> None:
    print(json.dumps(rec), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


# -- phase 1: the card ---------------------------------------------------------

def card_info() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(out, flush=True)
    cap = torch.cuda.get_device_capability(0)
    info = {"nvidia_smi": out, "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "capability": f"{cap[0]}.{cap[1]}"}
    emit(phase="card", **info)
    check(cap == (9, 0), f"want an sm_90 card, got {cap}")
    return info


# -- phase 2: build ------------------------------------------------------------

def build_kernels() -> None:
    names = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                   if f.endswith(".cu"))
    t0 = time.perf_counter()
    paths = _build.build(names)
    emit(phase="build", sources=names, seconds=time.perf_counter() - t0,
         libraries={n: os.path.relpath(p, ROOT) for n, p in paths.items()},
         ptxas={n: [ln for ln in _build.build_info[n]["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
                for n in names})


# -- phase 3: kernels against their plain versions ------------------------------

def _data(shape, seed) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 4, size=shape)
    return torch.from_numpy(x.astype(np.float32))


def _edge_tiles() -> torch.Tensor:
    """All-zero tile; exact .5 ties at scale 1.0; clip at ±127; a large
    value beside tiny ones; a subnormal absmax whose scale underflows."""
    x = np.zeros((40, 128), np.float32)
    x[8, 0] = 127.0
    x[8, 1:9] = [2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 1.5, -1.5]
    x[16, :4] = [127.0, -127.0, 126.5, -126.5]
    x[24, 0], x[25, :3] = 1e6, [1e-3, -1e-3, 3e3]
    x[32, :3] = [1e-44, -1e-44, 5e-45]
    return torch.from_numpy(x)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def compare_kernels(dev) -> dict:
    """Kernel == plain version, bit for bit, on the sweep and the edge
    tiles.  Returns the largest absolute difference seen per kernel."""
    err = {"quantize_blocks": 0.0, "dequantize_blocks": 0.0}
    cases = [(s, _data(s, seed=i)) for i, s in enumerate(SWEEP)]
    cases.append(((40, 128), _edge_tiles()))
    for shape, x in cases:
        xd = x.to(dev)
        q, s = bq.quantize_blocks(xd)
        out = bq.dequantize_blocks(q, s)
        torch.cuda.synchronize()
        qr, sr = ref.quantize_blocks_ref(xd)
        outr = ref.dequantize_blocks_ref(qr, sr)
        same_q = torch.equal(q, qr) and torch.equal(_bits(s), _bits(sr))
        same_d = torch.equal(_bits(out), _bits(outr))
        eq = float(max((q.int() - qr.int()).abs().max().item(),
                       (s - sr).abs().max().item()))
        ed = float((out - outr).abs().max().item())
        err["quantize_blocks"] = max(err["quantize_blocks"], eq)
        err["dequantize_blocks"] = max(err["dequantize_blocks"], ed)
        emit(phase="kernel_vs_plain", shape=list(shape),
             quantize_identical=same_q, dequantize_identical=same_d,
             max_abs_err_q=eq, max_abs_err_dq=ed)
        check(same_q, f"quantize kernel != plain version at {shape}")
        check(same_d, f"dequantize kernel != plain version at {shape}")
    return err


def _call_ms(fn, args_list, iters: int = 200) -> float:
    """Mean time per call of ``fn(*args)`` issued back to back from Python,
    cycling through ``args_list`` (enough buffers to exceed the L2 cache):
    what a caller pays, host launch path included."""
    for a in args_list[:3]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def _device_ms(fn, args_list, reps: int = 10) -> float:
    """Device time per call of ``fn(*args)``: up to 64 calls over distinct
    buffers captured into one CUDA graph and replayed, so the host's
    launch path is out of the measurement."""
    k = min(len(args_list), 64)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in args_list[:3]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for a in args_list[:k]:
            fn(*a)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    stop.synchronize()
    ms = start.elapsed_time(stop) / (reps * k)
    del graph
    return ms


def _bounds(R: int, C: int) -> dict:
    n, tiles = R * C, (R // 8) * (C // 128)
    q_bytes = 4 * n + n + 4 * tiles            # read x; write q and scales
    dq_bytes = n + 4 * tiles + 4 * n           # read q, scales; write out
    q_ops, dq_ops = 6 * n, n                   # abs, max, div, rint, 2x clip
    out = {}
    for name, b, ops in (("quantize_blocks", q_bytes, q_ops),
                         ("dequantize_blocks", dq_bytes, dq_ops)):
        t_b, t_o = b / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        out[name] = {"bytes": b, "bound_ms": max(t_b, t_o),
                     "bound_by": "bytes" if t_b >= t_o else "operations"}
    return out


def time_kernels(dev, shapes) -> dict:
    """Kernel and plain-version times at each shape, on the device (CUDA
    graph replay) and per call from Python; returns them keyed by shape."""
    res = {}
    for R, C in shapes:
        nbytes = R * C * 4
        nbuf = max(2, min(256, -(-(128 << 20) // nbytes)))
        base = [_data((R, C), seed=k).to(dev) for k in range(min(nbuf, 4))]
        xs = [(base[k % len(base)].clone(),) for k in range(nbuf)]
        qs = [bq.quantize_blocks(x) for (x,) in xs]
        fns = {"quantize_blocks": (bq.quantize_blocks,
                                   ref.quantize_blocks_ref, xs),
               "dequantize_blocks": (bq.dequantize_blocks,
                                     ref.dequantize_blocks_ref, qs)}
        bounds = _bounds(R, C)
        for name, (kernel, plain, args) in fns.items():
            ms = _device_ms(kernel, args)
            rec = dict(shape=[R, C], kernel=name, ms=ms,
                       plain_ms=_device_ms(plain, args),
                       call_ms=_call_ms(kernel, args),
                       plain_call_ms=_call_ms(plain, args),
                       buffers=nbuf, **bounds[name])
            rec["bandwidth_gb_s"] = bounds[name]["bytes"] / (ms * 1e-3) / 1e9
            emit(phase="kernel_time", **rec)
            res[(R, C, name)] = rec
        del xs, qs
        torch.cuda.empty_cache()
    return res


# -- phase 4: the main path --------------------------------------------------------

def fan_in_params(graph, seed: int) -> dict:
    """Seeded He-style weights in the reference's names and HWIO layout:
    ``w ~ N(0, 2/fan_in)``, folded-BN ``scale ~ U(0.5, 1)``, biases
    ``~ N(0, 0.1)``; param-less layers get ``{}``."""
    rng = np.random.default_rng(seed)
    params = {}
    for node in graph.nodes:
        p = {}
        for k in sorted(node.param_spec):
            shape = node.param_spec[k].shape
            if k == "w":
                a = rng.standard_normal(shape, np.float32) \
                    * np.float32(np.sqrt(2.0 / np.prod(shape[:-1])))
            elif k == "scale":
                a = rng.uniform(0.5, 1.0, shape).astype(np.float32)
            else:
                a = np.float32(0.1) * rng.standard_normal(shape, np.float32)
            p[k] = a
        params[node.name] = p
    return params


def wire_shapes(graph, spec) -> list[tuple[int, int]]:
    """The [R, 128] grids q8 hands the kernel for one batch-1 request: the
    input, every leaf crossing a cut, and the logits, each padded to a
    power-of-two count of (8, 128) tiles."""
    sizes = [int(np.prod(graph.input_spec.shape))]
    for cut in spec.cuts:
        for name in graph.crossing_names(cut - 1):
            sizes.append(int(np.prod(graph.input_spec.shape if name == ""
                                     else graph[name].out_spec.shape)))
    sizes.append(int(np.prod(graph.nodes[-1].out_spec.shape)))
    return [(bq._pow2_tiles(n) * 8, 128) for n in sizes]


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(1e-12, np.abs(b).max()))


def serve(graph, params, spec, codec, xs, device, label, card) -> list:
    """Serve ``xs`` twice on one engine: the first window is the engine's
    first traffic (after precompile), the second is warm; both are
    printed, the warm one with its per-stage breakdown."""
    eng = InferenceEngine(graph, spec, DispatcherCodecs(
        data=codec, weights=WireCodec("raw", "none")),
        max_batch=4, device=device)
    try:
        eng.configure(params)
        eng.precompile()
        cold, rep = eng.run(xs)
        emit(phase="serve_first_window", codec=rep.codec, transport=label,
             requests_per_s=rep.throughput_cps,
             p50_latency_s=rep.p50_latency_s, wall_s=rep.wall_s, card=card)
        outs, rep = eng.run(xs)
    finally:
        eng.shutdown()
    outs = cold + outs
    emit(phase="serve", codec=rep.codec, transport=label,
         requests=rep.samples, requests_per_s=rep.throughput_cps,
         p50_latency_s=rep.p50_latency_s, p99_latency_s=rep.p99_latency_s,
         wall_s=rep.wall_s, payload_mb_per_request=rep.payload_mb,
         replicas=list(rep.replicas), cuts=list(rep.cuts),
         card=card)
    # where each replica's time went: per-request seconds in its decode,
    # compute (apply + D2H copy) and encode stages, and busy shares
    emit(phase="serve_stages", codec=rep.codec, transport=label, stages=[
        {k: n[k] for k in ("stage", "replica", "requests", "deserialize_s",
                           "compute_s", "serialize_s", "util_decode",
                           "util_compute", "util_encode", "batch_mean")}
        for n in rep.per_node])
    return outs


def main_path(device, image: int, classes: int, n_req: int, card: str
              ) -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(phase="main_path_setup", tf32="off (cudnn and matmul)",
         image=image, num_classes=classes, requests=n_req)
    graph = cnn.resnet50(batch=1, image=image, num_classes=classes)
    params = fan_in_params(graph, seed=0)
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((1, image, image, 3)).astype(np.float32)
          for _ in range(n_req)]
    spec = TopologySpec.chain(graph, 4, strategy="balanced_latency",
                              replicas=[1, 2, 1, 1])

    # single-device references: on the serving device and on the CPU
    prep = graph.prepare(params, device)
    single = [graph.apply(prep, torch.from_numpy(x).to(device)).cpu().numpy()
              for x in xs]
    del prep
    cpu_prep = graph.prepare(params, "cpu")
    for x, s in zip(xs[:2], single):
        c = graph.apply(cpu_prep, torch.from_numpy(x)).numpy()
        r = _rel(s, c)
        emit(phase="check", what="device apply vs CPU apply", rel=r,
             tol=CPU_TOL_REL)
        check(r <= CPU_TOL_REL, f"device apply vs CPU apply rel {r}")
    del cpu_prep
    check(np.linalg.norm(single[0] - single[1])
          > 0.01 * np.linalg.norm(single[0]), "logits insensitive to input")

    bq.reset_counts()
    runs = [("raw", WireCodec("raw", "none"), "inproc", RAW_TOL_REL),
            ("q8", WireCodec("q8", "none"), "inproc", Q8_REL),
            ("zfp", WireCodec("zfp", "lz4", zfp_rate=16), "inproc", ZFP_REL),
            ("q8", WireCodec("q8", "none"), "tcp", Q8_REL)]
    for name, codec, transport, tol in runs:
        s = TopologySpec(tuple(dataclasses.replace(st, transport=transport)
                               for st in spec.stages))
        outs = serve(graph, params, s, codec, xs, device, transport, card)
        worst = max(_rel(o, r) for o, r in zip(outs, single + single))
        emit(phase="check", what=f"{name}/{transport} chain vs single-device",
             rel=worst, tol=tol)
        check(all(np.isfinite(o).all() and o.shape == (1, classes)
                  for o in outs), f"{name} outputs not finite/shaped")
        check(worst <= tol, f"{name}/{transport} rel {worst} > {tol}")
    counts = dict(bq.launches)
    emit(phase="main_path_launches", launches=counts,
         plain_calls=dict(bq.plain_calls))
    return {"counts": counts, "shapes": wire_shapes(graph, spec)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the main path on the CPU at image 64; never "
                         "prints a result")
    args = ap.parse_args()
    if args.cpu_rehearsal:
        torch.set_num_threads(min(4, os.cpu_count() or 1))
        main_path(torch.device("cpu"), 64, 10, 4, "cpu rehearsal")
        print("chip_smoke: CPU rehearsal done; no result", file=sys.stderr)
        return 3
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    info = card_info()
    card = info["nvidia_smi"]
    build_kernels()
    errs = compare_kernels(dev)
    main = main_path(dev, 224, 1000, 8, card)
    shapes = sorted(set(main["shapes"]) | set(SWEEP))
    times = time_kernels(dev, shapes)
    # the kernels line reports the largest grid one request puts on the
    # wire on the main path
    R, C = max(main["shapes"])
    kernels = []
    for name, tpu in (("quantize_blocks", "src/repro/kernels/block_quant.py:59"),
                      ("dequantize_blocks",
                       "src/repro/kernels/block_quant.py:85")):
        t = times[(R, C, name)]
        check(main["counts"][name] > 0,
              f"{name} was never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/block_quant.cu",
            "replaces": tpu, "launches": main["counts"][name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "call_ms": t["call_ms"], "plain_call_ms": t["plain_call_ms"],
            "shape": [R, C], "card": card})
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
