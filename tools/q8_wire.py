"""The q8 wire's variants on a CUDA card, each pair timed in turns in one
process.

    python3 tools/q8_wire.py [--out FILE.jsonl]

Prints one JSON record per line (and writes them to ``--out`` if given):

1. ``kernel_variant``: the kernels as built from ``csrc/block_quant.cu``
   against copies of the source with one part changed (``VARIANTS``:
   quantize's 4-byte q stores gathered by shuffles into 16-byte ones,
   dequantize's CTAs of other sizes), built with the same flags: device
   ms at the wire's leaf sizes (shipped, variant, variant, shipped), and
   whether the two wrote the same bytes.
2. ``staging``: ``quantize_wire`` / ``dequantize_wire`` with page-locked
   host buffers (as shipped) against pageable ones, per call from
   Python, in turns.
3. ``serve``: slice A as ``chip_smoke.py`` serves it (ResNet50 at
   224x224, a 4-stage ``balanced_latency`` chain, stage 1 replicated
   twice, ``max_batch`` 4), in turns: raw; raw at ``max_batch`` 2 (the
   batches q8 forms); q8 through the padded wire path below, through the
   unpadded path on the default stream, through the unpadded path on
   each codec thread's own stream (as shipped), and through the plain
   version on the host (no codec work on the card at all).  Requests/s
   and each replica's per-request decode, compute and encode seconds and
   mean batch, per warm window.

The module also holds the padded wire path that the ragged kernels
replaced (``quantize_wire_padded`` / ``dequantize_wire_padded``: the leaf
zero-padded on the host to the blob's power-of-two tile count, pageable
copies on the default stream, q and the scales brought back by two
copies), which ``chip_smoke.py`` times beside the port's; nothing on a
serving path calls it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from repro_torch.device import get_device  # noqa: E402
from repro_torch.kernels import block_quant as bq  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


# -- the padded wire path -------------------------------------------------------

def quantize_wire_padded(arr: np.ndarray, device=None
                         ) -> tuple[np.ndarray, np.ndarray]:
    """The padded path's ``quantize_wire``: (int8 [Np], scales [Np/1024])
    from the leaf zero-padded to ``Np`` on the host."""
    a = np.ascontiguousarray(arr, dtype=np.float32).ravel()
    n = a.size
    if n == 0:
        return np.zeros(0, np.int8), np.zeros(0, np.float32)
    np_full = bq.wire_tiles(n) * bq.TILE
    if np_full > n:
        a = np.concatenate([a, np.zeros(np_full - n, np.float32)])
    x = torch.from_numpy(a.reshape(-1, bq.TILE_C)).to(get_device(device))
    q, s = bq.quantize_blocks(x)
    return q.cpu().numpy().ravel(), s.cpu().numpy().ravel()


def dequantize_wire_padded(q: np.ndarray, scales: np.ndarray, n: int,
                           shape, dtype, device=None) -> np.ndarray:
    """The padded path's ``dequantize_wire``: the payload zero-filled to
    the padded grid on the host, the whole grid copied back."""
    if n == 0:
        return np.zeros(shape, dtype)
    qf = np.zeros(scales.size * bq.TILE, np.int8)
    qf[:q.size] = q
    dev = get_device(device)
    q2 = torch.from_numpy(qf.reshape(-1, bq.TILE_C)).to(dev)
    s2 = torch.from_numpy(np.array(scales, np.float32).reshape(-1, 1)).to(dev)
    out = bq.dequantize_blocks(q2, s2).cpu().numpy()
    return out.ravel()[:n].reshape(shape).astype(dtype, copy=False)


# -- the wire path with pageable host buffers -------------------------------------

def quantize_wire_pageable(arr: np.ndarray, device=None):
    a = np.ascontiguousarray(arr, dtype=np.float32).ravel()
    n, dev = a.size, get_device(device)
    tiles = bq.wire_tiles(n)
    stream = bq._stream(dev)
    with torch.cuda.stream(stream):
        x = torch.from_numpy(a).to(dev, non_blocking=True)
        packed = bq.quantize_ragged(x, tiles).cpu().numpy()
    off = ref.wire_layout(n, tiles)[0]
    return packed[:n].view(np.int8), packed[off:].view(np.float32)


def dequantize_wire_pageable(q, scales, n, shape, dtype, device=None):
    dev, tiles = get_device(device), scales.size
    off, nbytes = ref.wire_layout(n, tiles)
    stage = np.empty(nbytes, np.uint8)
    stage[:n] = np.asarray(q[:n]).view(np.uint8)
    stage[off:] = np.asarray(scales, np.float32).view(np.uint8)
    stream = bq._stream(dev)
    with torch.cuda.stream(stream):
        packed = torch.from_numpy(stage).to(dev, non_blocking=True)
        out = bq.dequantize_ragged(*bq.wire_views(packed, n, tiles)).cpu()
    return out.numpy().reshape(shape).astype(dtype, copy=False)


# -- copies of csrc/block_quant.cu with one part changed -------------------------

_STORE = """  if (e + 4 <= n) {
    *reinterpret_cast<char4*>(q + e) = o;
  } else if (e < n) {"""
_STORE16 = """  const int w = (o.x & 0xff) | ((o.y & 0xff) << 8) | ((o.z & 0xff) << 16) |
                ((int)o.w << 24);
  const int w1 = __shfl_down_sync(kFull, w, 1);
  const int w2 = __shfl_down_sync(kFull, w, 2);
  const int w3 = __shfl_down_sync(kFull, w, 3);
  if (first + row * C + kTileC <= n) {
    if ((lane & 3) == 0)
      *reinterpret_cast<int4*>(q + e) = make_int4(w, w1, w2, w3);
  } else if (e + 4 <= n) {
    *reinterpret_cast<char4*>(q + e) = o;
  } else if (e < n) {"""
_DQ_THREADS = "constexpr int kDequantThreads = 256;"
# dequantize without the shared-memory transpose: each lane converts its
# own 16 values (one tile row, one scale) and stores them as 4 float4 at
# its own 64 bytes
_DQ_BODY = "  // the scales of the warp's 4 tile rows"
_DQ_END = "\n}\n\n}  // namespace"
_DQ_DIRECT = """  const long long e = w0 + lane * kDequantPerThread;
  const unsigned tiles_c = (unsigned)(C / kTileC);
  const unsigned g = (unsigned)(e / kTileC);
  const unsigned row = g / tiles_c, col = g - row * tiles_c;
  const float sc =
      e < n ? flush(__ldg(scales + (row / kTileR) * tiles_c + col)) : 0.0f;
  union {
    uint4 v;
    signed char b[kDequantPerThread];
  } raw;
  raw.v = make_uint4(0, 0, 0, 0);
  if (e + kDequantPerThread <= n) {
    raw.v = __ldg(reinterpret_cast<const uint4*>(q + e));
  } else if (e < n) {
#pragma unroll
    for (int i = 0; i < kDequantPerThread; ++i)
      if (e + i < n) raw.b[i] = q[e + i];
  }
#pragma unroll
  for (int k = 0; k < kDequantPerThread / 4; ++k) {
    float4 o;
    o.x = flush(__fmul_rn(static_cast<float>(raw.b[4 * k]), sc));
    o.y = flush(__fmul_rn(static_cast<float>(raw.b[4 * k + 1]), sc));
    o.z = flush(__fmul_rn(static_cast<float>(raw.b[4 * k + 2]), sc));
    o.w = flush(__fmul_rn(static_cast<float>(raw.b[4 * k + 3]), sc));
    const long long d = e + 4 * k;
    if (d + 4 <= n) {
      *reinterpret_cast<float4*>(out + d) = o;
    } else if (d < n) {
      const float f[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (d + i < n) out[d + i] = f[i];
    }
  }"""

# dequantize with four 4-byte loads of q a lane (each coalesced across the
# warp, as the stores are) in place of one 16-byte load and the transpose
_DQ_CHAR4 = """  const unsigned tiles_c = (unsigned)(C / kTileC);
  signed char c[kSegs][4];
  float sj[kSegs];
#pragma unroll
  for (int j = 0; j < kSegs; ++j) {
    const long long seg = w0 + j * kTileC;
    const unsigned g = (unsigned)(seg / kTileC);
    const unsigned row = g / tiles_c, col = g - row * tiles_c;
    sj[j] = seg < n ? flush(__ldg(scales + (row / kTileR) * tiles_c + col))
                    : 0.0f;
    const long long d = seg + lane * 4;
    if (d + 4 <= n) {
      const char4 v = __ldg(reinterpret_cast<const char4*>(q + d));
      c[j][0] = v.x, c[j][1] = v.y, c[j][2] = v.z, c[j][3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) c[j][i] = d + i < n ? q[d + i] : 0;
    }
  }
#pragma unroll
  for (int j = 0; j < kSegs; ++j) {
    const long long seg = w0 + j * kTileC;
    if (seg >= n) break;
    float4 o;
    o.x = flush(__fmul_rn(static_cast<float>(c[j][0]), sj[j]));
    o.y = flush(__fmul_rn(static_cast<float>(c[j][1]), sj[j]));
    o.z = flush(__fmul_rn(static_cast<float>(c[j][2]), sj[j]));
    o.w = flush(__fmul_rn(static_cast<float>(c[j][3]), sj[j]));
    const long long d = seg + lane * 4;
    if (d + 4 <= n) {
      *reinterpret_cast<float4*>(out + d) = o;
    } else if (d < n) {
      const float f[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (d + i < n) out[d + i] = f[i];
    }
  }"""


def _replace(old: str, new: str):
    def edit(src: str) -> str:
        if src.count(old) != 1:
            raise SystemExit("q8_wire: a variant's text is not in the "
                             "source once")
        return src.replace(old, new)
    return edit


def _body(new: str):
    """Dequantize's body from its scales on, replaced by ``new``."""
    def edit(src: str) -> str:
        i = src.find(_DQ_BODY)
        j = src.find(_DQ_END, i)
        if i < 0 or j < 0:
            raise SystemExit("q8_wire: dequantize's body is not where the "
                             "variant expects it")
        return src[:i] + new + src[j:]
    return edit


# name: (the kernel timed, the edit of the source)
VARIANTS = {
    # each lane's 4 int8 gathered by shuffles into 16-byte stores
    "quantize_store16": ("quantize", _replace(_STORE, _STORE16)),
    # dequantize's CTAs of 128 or 64 threads: more CTAs at a leaf
    "dequantize_cta128": ("dequantize", _replace(
        _DQ_THREADS, _DQ_THREADS.replace("256", "128"))),
    "dequantize_cta64": ("dequantize", _replace(
        _DQ_THREADS, _DQ_THREADS.replace("256", "64"))),
    "dequantize_direct": ("dequantize", _body(_DQ_DIRECT)),
    "dequantize_char4": ("dequantize", _body(_DQ_CHAR4)),
}


def _build_variant(name: str, edit) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    with open(os.path.join(_build.CSRC, "block_quant.cu")) as f:
        src = f.read()
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, f"block_quant_{name}.cu")
    with open(cu, "w") as f:
        f.write(edit(src))
    so = cu[:-3] + ".so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.bq_quantize_f32.argtypes = [p, p, p, ll, ll, ll, p]
    lib.bq_dequantize_f32.argtypes = [p, p, p, ll, ll, p]
    for fn in (lib.bq_quantize_f32, lib.bq_dequantize_f32):
        fn.restype = ctypes.c_int
    return lib


def _quant(lib, x, packed, n, tiles):
    q, s = bq.wire_views(packed, n, tiles)
    err = lib.bq_quantize_f32(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                              bq.TILE_C, n, tiles,
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"quantize variant: CUDA error {err}")


def _dequant(lib, packed, out, n, tiles):
    q, s = bq.wire_views(packed, n, tiles)
    err = lib.bq_dequantize_f32(q.data_ptr(), s.data_ptr(), out.data_ptr(),
                                bq.TILE_C, n,
                                torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"dequantize variant: CUDA error {err}")


def _same(kernel: str, a, b, n: int, tiles: int) -> bool:
    if kernel == "dequantize":
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    (qa, sa), (qb, sb) = bq.wire_views(a, n, tiles), bq.wire_views(b, n, tiles)
    return torch.equal(qa, qb) and torch.equal(sa.view(torch.int32),
                                               sb.view(torch.int32))


def kernel_variant(dev, sizes, emit) -> None:
    """Each of ``VARIANTS`` against the source as built, device ms in turns
    (shipped, variant, variant, shipped) at each n, and whether the two
    wrote the same bytes."""
    from chip_smoke import _data, _device_ms
    shipped = bq._lib()
    for name, (kernel, edit) in VARIANTS.items():
        libs = {"shipped": shipped, name: _build_variant(name, edit)}
        for n in sizes:
            tiles = bq.wire_tiles(n)
            nbuf = max(2, min(256, -(-(128 << 20) // (4 * n))))
            xs = [_data((n,), seed=k).to(dev) for k in range(nbuf)]
            if kernel == "quantize":
                fn, inputs = _quant, xs
                shape, dtype = ref.wire_layout(n, tiles)[1], torch.uint8
            else:
                fn, inputs = _dequant, [bq.quantize_ragged(x, tiles)
                                        for x in xs]
                shape, dtype = n, torch.float32
            outs = {k: [torch.empty(shape, dtype=dtype, device=dev)
                        for _ in xs] for k in libs}
            ms: dict[str, list[float]] = {}
            for k in ("shipped", name, name, "shipped"):
                args = [(libs[k], i, o, n, tiles)
                        for i, o in zip(inputs, outs[k])]
                ms.setdefault(k, []).append(_device_ms(fn, args))
            for k, lib in libs.items():          # every buffer, once
                for i, o in zip(inputs, outs[k]):
                    fn(lib, i, o, n, tiles)
            torch.cuda.synchronize()
            same = all(_same(kernel, a, b, n, tiles)
                       for a, b in zip(outs["shipped"], outs[name]))
            emit(phase="kernel_variant", variant=name, n=n, tiles=tiles,
                 shipped_ms=ms["shipped"], variant_ms=ms[name],
                 identical=same)
            del xs, inputs, outs
            torch.cuda.empty_cache()


def staging(dev, sizes, emit, iters: int = 50) -> None:
    from chip_smoke import _data
    paths = {"pinned": (bq.quantize_wire, bq.dequantize_wire),
             "pageable": (quantize_wire_pageable, dequantize_wire_pageable)}
    for n in sizes:
        a = _data((n,), seed=n).numpy()
        q, s = bq.quantize_wire(a, device=dev)
        ms: dict[str, list[float]] = {}
        for name in ("pageable", "pinned", "pinned", "pageable"):
            quant, dequant = paths[name]
            for what, fn, args in (
                    ("quantize", quant, (a, dev)),
                    ("dequantize", dequant, (q, s, n, (n,), np.float32,
                                             dev))):
                got = fn(*args)
                for _ in range(2):
                    fn(*args)
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn(*args)
                ms.setdefault(f"{name}_{what}", []).append(
                    (time.perf_counter() - t0) / iters * 1e3)
                want = bq.quantize_wire(a, device=dev) \
                    if what == "quantize" else \
                    bq.dequantize_wire(q, s, n, (n,), np.float32, dev)
                if what == "quantize":
                    same = all(g.tobytes() == w.tobytes()
                               for g, w in zip(got, want))
                else:
                    same = got.tobytes() == want.tobytes()
                if not same:
                    raise SystemExit(f"q8_wire: {name} {what} differs at "
                                     f"n={n}")
        emit(phase="staging", n=n, **{k + "_ms": v for k, v in ms.items()})


def serve(dev, emit, requests: int, windows: int) -> None:
    """Slice A raw and through q8 three ways, in turns."""
    from chip_smoke import fan_in_params
    from repro_torch.models import cnn
    from repro_torch.runtime import (DispatcherCodecs, InferenceEngine,
                                     TopologySpec, WireCodec)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    graph = cnn.resnet50(batch=1, image=224, num_classes=1000)
    params = fan_in_params(graph, seed=0)
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((1, 224, 224, 3)).astype(np.float32)
          for _ in range(requests)]
    spec = TopologySpec.chain(graph, 4, strategy="balanced_latency",
                              replicas=[1, 2, 1, 1])
    shipped = (bq.quantize_wire, bq.dequantize_wire, bq._stream)

    def default_stream(d):
        return torch.cuda.default_stream(d)

    # name: (data codec, the wire functions and stream, max_batch)
    q8 = WireCodec("q8", "none")
    variants = {
        "raw": (WireCodec("raw", "none"), shipped, 4),
        "raw_batch2": (WireCodec("raw", "none"), shipped, 2),
        "q8_padded": (q8, (quantize_wire_padded, dequantize_wire_padded,
                           bq._stream), 4),
        "q8_default_stream": (q8, (bq.quantize_wire, bq.dequantize_wire,
                                   default_stream), 4),
        "q8_own_stream": (q8, shipped, 4),
        "q8_host": (WireCodec("q8", "none", device="cpu"), shipped, 4),
    }
    order = list(variants) + list(variants)[::-1]
    try:
        for name in order:
            codec, (quant, dequant, stream), max_batch = variants[name]
            bq.quantize_wire, bq.dequantize_wire, bq._stream = \
                quant, dequant, stream
            eng = InferenceEngine(graph, spec, DispatcherCodecs(
                data=codec, weights=WireCodec("raw", "none")),
                max_batch=max_batch, device=dev)
            try:
                eng.configure(params)
                eng.precompile()
                eng.run(xs)
                for w in range(windows):
                    _, rep = eng.run(xs)
                    emit(phase="serve", variant=name, window=w,
                         codec=rep.codec, requests=rep.samples,
                         requests_per_s=rep.throughput_cps,
                         p50_latency_s=rep.p50_latency_s,
                         payload_mb_per_request=rep.payload_mb,
                         stages=[{k: n[k] for k in (
                             "stage", "replica", "requests",
                             "deserialize_s", "compute_s", "serialize_s",
                             "batch_mean")} for n in rep.per_node])
            finally:
                eng.shutdown()
    finally:
        bq.quantize_wire, bq.dequantize_wire, bq._stream = shipped


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the records to this file")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--windows", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("q8_wire: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    out = open(args.out, "w") if args.out else None

    def emit(**rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit(phase="card", nvidia_smi=card, torch=torch.__version__)
    dev = torch.device("cuda", 0)
    sizes = [1000, 150_528, 200_704, 401_408, 1_605_632]
    kernel_variant(dev, sizes, emit)
    staging(dev, sizes, emit)
    serve(dev, emit, args.requests, args.windows)
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
