"""Shared-scale int8 block quantization: the CUDA kernel's wrappers.

Twin of ``repro.kernels.block_quant``, whose Pallas TPU kernels
(``quantize_blocks`` / ``dequantize_blocks``) this module's CUDA C++
kernels (``csrc/block_quant.cu``, built for ``sm_90a`` at first use)
replace.  Per (8, 128) tile: ``scale = absmax·f32(1/127)`` (1.0 for an
all-zero tile; see ``ref.INV127``), ``q = clip(round_half_even(x/scale),
±127)``; dequantize is ``q·scale``.  The (8, 128) tile is the wire *format* (Q8 blobs and
``quant_bytes`` encode it), not a GPU tile.

The kernels also take a *ragged* grid: only its first n values are real
and the rest is zero padding that they never read (``quantize_ragged`` /
``dequantize_ragged``, what the q8 wire's entry points call, so a leaf
crosses PCIe unpadded).

A wrapper given a CPU tensor runs the plain PyTorch version
(:mod:`repro_torch.kernels.ref`); given a CUDA tensor it launches the
kernel or raises (as it does under autograd: the kernels have no
backward).  ``launches`` counts kernel launches only, by kernel;
``plain_calls`` counts the CPU path.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from repro_torch.device import get_device
from repro_torch.kernels import ref, refuse_grad

TILE_R, TILE_C = ref.TILE_R, ref.TILE_C
TILE = TILE_R * TILE_C

launches = {"quantize_blocks": 0, "dequantize_blocks": 0}
plain_calls = {"quantize_blocks": 0, "dequantize_blocks": 0}


def reset_counts() -> None:
    for d in (launches, plain_calls):
        for k in d:
            d[k] = 0


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The kernel library, built and bound on first use."""
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import _build
        lib = _build.load("block_quant")
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.bq_quantize_f32.argtypes = [p, p, p, ll, ll, ll, p]
        lib.bq_dequantize_f32.argtypes = [p, p, p, ll, ll, p]
        for fn in (lib.bq_quantize_f32, lib.bq_dequantize_f32):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_grid(t: torch.Tensor, what: str) -> tuple[int, int]:
    if t.dim() != 2:
        raise ValueError(f"{what}: want a 2-D [R, C] tensor, got {tuple(t.shape)}")
    R, C = t.shape
    if R % TILE_R or C % TILE_C:
        raise ValueError(f"{what}: shape {tuple(t.shape)} is not a whole "
                         f"number of ({TILE_R}, {TILE_C}) tiles")
    return R, C


def _check_cuda(t: torch.Tensor, what: str, dtype: torch.dtype) -> None:
    refuse_grad(what, t)
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {t.device}, want cuda or cpu")
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, the kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: data pointer must be 16-byte aligned")


def _launch_quantize(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                     C: int, n: int, ntiles: int) -> None:
    err = _lib().bq_quantize_f32(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), C, n, ntiles,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"quantize: CUDA launch failed with error {err}")
    launches["quantize_blocks"] += 1


def _launch_dequantize(q: torch.Tensor, s: torch.Tensor, out: torch.Tensor,
                       C: int, n: int) -> None:
    err = _lib().bq_dequantize_f32(
        q.data_ptr(), s.data_ptr(), out.data_ptr(), C, n,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"dequantize: CUDA launch failed with error {err}")
    launches["dequantize_blocks"] += 1


def quantize_blocks(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [R, C] f32 (R % 8 == 0, C % 128 == 0) -> (q int8 [R, C],
    scales f32 [R/8, C/128])."""
    R, C = _check_grid(x, "quantize_blocks")
    if x.device.type == "cpu":
        plain_calls["quantize_blocks"] += 1
        return ref.quantize_blocks_ref(x)
    _check_cuda(x, "quantize_blocks", torch.float32)
    q = torch.empty((R, C), dtype=torch.int8, device=x.device)
    s = torch.empty((R // TILE_R, C // TILE_C), dtype=torch.float32,
                    device=x.device)
    _launch_quantize(x, q, s, C, R * C, s.numel())
    return q, s


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q int8 [R, C] + scales f32 [R/8, C/128] -> float32 [R, C]."""
    R, C = _check_grid(q, "dequantize_blocks")
    if tuple(scales.shape) != (R // TILE_R, C // TILE_C):
        raise ValueError(f"dequantize_blocks: scales {tuple(scales.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if q.device.type == "cpu" and scales.device.type == "cpu":
        plain_calls["dequantize_blocks"] += 1
        return ref.dequantize_blocks_ref(q, scales, dtype)
    if dtype != torch.float32:
        raise TypeError(f"dequantize_blocks: output dtype {dtype}; the "
                        "kernel writes float32")
    _check_cuda(q, "dequantize_blocks", torch.int8)
    _check_cuda(scales, "dequantize_blocks scales", torch.float32)
    if scales.device != q.device:
        raise ValueError("dequantize_blocks: q and scales on different devices")
    out = torch.empty((R, C), dtype=torch.float32, device=q.device)
    _launch_dequantize(q, scales, out, C, R * C)
    return out


# -- the ragged form: the first n values of a zero-padded [8·ntiles, 128] grid


def wire_tiles(n: int) -> int:
    """Whole (8, 128) tiles covering n values, rounded up to a power of two:
    the count the q8 blob carries a scale for (the reference pads so its
    jit cache sees a bounded set of shapes; the blob keeps its scales)."""
    tiles = -(-n // TILE)
    p = 1
    while p < tiles:
        p *= 2
    return p


def wire_views(packed: torch.Tensor, n: int, ntiles: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The packed wire buffer's views: (q int8 [n], scales f32 [ntiles])."""
    off = ref.wire_layout(n, ntiles)[0]
    return packed[:n].view(torch.int8), packed[off:].view(torch.float32)


def quantize_ragged(x: torch.Tensor, ntiles: int) -> torch.Tensor:
    """x f32 [n], the first n values of a [8·ntiles, 128] grid whose rest
    is zero -> the packed buffer uint8 (:func:`ref.wire_layout`): q of the
    n values, then the scales of all ntiles tiles (:func:`wire_views`).  The
    kernel reads nothing past n; the bytes between q and the scales are
    not written."""
    if x.dim() != 1:
        raise ValueError(f"quantize_ragged: want a 1-D tensor, got "
                         f"{tuple(x.shape)}")
    n = x.numel()
    if n > ntiles * TILE:
        raise ValueError(f"quantize_ragged: {n} values over {ntiles} tiles")
    if x.device.type == "cpu":
        plain_calls["quantize_blocks"] += 1
        return ref.quantize_ragged_ref(x, ntiles)
    _check_cuda(x, "quantize_ragged", torch.float32)
    packed = torch.empty(ref.wire_layout(n, ntiles)[1], dtype=torch.uint8,
                         device=x.device)
    q, s = wire_views(packed, n, ntiles)
    _launch_quantize(x, q, s, TILE_C, n, ntiles)
    return packed


def dequantize_ragged(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """q int8 [n], the first n values of a [8·ntiles, 128] grid whose rest
    is zero, and its scales f32 [ntiles] -> float32 [n]."""
    if q.dim() != 1 or scales.dim() != 1:
        raise ValueError("dequantize_ragged: want 1-D q and scales")
    n = q.numel()
    if n > scales.numel() * TILE:
        raise ValueError(f"dequantize_ragged: {n} values over "
                         f"{scales.numel()} tiles")
    if q.device.type == "cpu" and scales.device.type == "cpu":
        plain_calls["dequantize_blocks"] += 1
        return ref.dequantize_ragged_ref(q, scales)
    _check_cuda(q, "dequantize_ragged", torch.int8)
    _check_cuda(scales, "dequantize_ragged scales", torch.float32)
    if scales.device != q.device:
        raise ValueError("dequantize_ragged: q and scales on different "
                         "devices")
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    _launch_dequantize(q, scales, out, TILE_C, n)
    return out


# -- host-facing wire entry points (the serving runtime's "q8" serializer) ---
#
# The wire sees activation leaves of any size.  A leaf crosses to the card
# unpadded; the kernel quantizes its n values and writes the scales of the
# power-of-two tile count the blob carries; q and the scales come back in
# one buffer.  On a card each calling thread works on a stream of its own
# (a serving node's codec threads then neither wait behind another
# replica's compute on the default stream nor hold it up) and synchronises
# it once per call.

_local = threading.local()


def _stream(dev: torch.device) -> torch.cuda.Stream:
    """The calling thread's own stream on ``dev``, made at its first use."""
    streams = _local.__dict__.setdefault("streams", {})
    s = streams.get(dev)
    if s is None:
        s = streams[dev] = torch.cuda.Stream(dev)
    return s


def quantize_wire(arr: np.ndarray, device: str | torch.device | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Arbitrary-shape array of n values -> (int8 payload [n], float32
    scales [Np/1024]).

    ``Np`` is n rounded up to a power-of-two count of (8, 128) tiles; the
    scales are those of the zero-padded grid, so the reference's blob
    (which trims its int8 payload to n) is made of the same bytes.
    """
    a = np.ascontiguousarray(arr, dtype=np.float32).ravel()
    n = a.size
    if n == 0:
        return np.zeros(0, np.int8), np.zeros(0, np.float32)
    ntiles = wire_tiles(n)
    dev = get_device(device)
    if dev.type == "cpu":
        packed = quantize_ragged(torch.from_numpy(a), ntiles).numpy()
    else:
        stream = _stream(dev)
        with torch.cuda.stream(stream):
            # host buffers: page-locked, from PyTorch's caching host
            # allocator, so the copies run asynchronously on the stream
            x = torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)
            out = quantize_ragged(x, ntiles)
            host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(out, non_blocking=True)
        stream.synchronize()
        packed = host.numpy()
    off = ref.wire_layout(n, ntiles)[0]
    return packed[:n].view(np.int8), packed[off:].view(np.float32)


def dequantize_wire(q: np.ndarray, scales: np.ndarray, n: int,
                    shape: tuple[int, ...], dtype,
                    device: str | torch.device | None = None) -> np.ndarray:
    """Invert :func:`quantize_wire` back to ``shape``/``dtype``.  Reads the
    first n values of the int8 payload (a payload trimmed to n, as the
    blob carries it, or a longer one)."""
    if n == 0:
        return np.zeros(shape, dtype)
    ntiles = scales.size
    dev = get_device(device)
    if dev.type == "cpu":
        out = dequantize_ragged(
            torch.from_numpy(np.array(q[:n], np.int8)),
            torch.from_numpy(np.array(scales, np.float32))).numpy()
    else:
        off, nbytes = ref.wire_layout(n, ntiles)
        stream = _stream(dev)
        with torch.cuda.stream(stream):
            stage = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            st = stage.numpy()
            st[:n] = np.asarray(q[:n]).view(np.uint8)
            st[off:] = np.asarray(scales, np.float32).view(np.uint8)
            packed = stage.to(dev, non_blocking=True)
            out_d = dequantize_ragged(*wire_views(packed, n, ntiles))
            host = torch.empty(n, dtype=torch.float32, pin_memory=True)
            host.copy_(out_d, non_blocking=True)
        stream.synchronize()
        out = host.numpy()
    return out.reshape(shape).astype(dtype, copy=False)
