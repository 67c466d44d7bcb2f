"""Shared-scale int8 block quantization: the CUDA kernel's wrappers.

Twin of ``repro.kernels.block_quant``, whose Pallas TPU kernels
(``quantize_blocks`` / ``dequantize_blocks``) this module's CUDA C++
kernels (``csrc/block_quant.cu``, built for ``sm_90a`` at first use)
replace.  Per (8, 128) tile: ``scale = absmax·f32(1/127)`` (1.0 for an
all-zero tile; see ``ref.INV127``), ``q = clip(round_half_even(x/scale),
±127)``; dequantize is ``q·scale``.  The (8, 128) tile is the wire *format* (Q8 blobs and
``quant_bytes`` encode it), not a GPU tile.

A wrapper given a CPU tensor runs the plain PyTorch version
(:mod:`repro_torch.kernels.ref`); given a CUDA tensor it launches the
kernel or raises.  ``launches`` counts kernel launches only;
``plain_calls`` counts the CPU path.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.device import get_device
from repro_torch.kernels import ref

TILE_R, TILE_C = ref.TILE_R, ref.TILE_C
WIRE_C = TILE_C

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
        for fn in (lib.bq_quantize_f32, lib.bq_dequantize_f32):
            fn.argtypes = [p, p, p, ll, ll, p]
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
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {t.device}, want cuda or cpu")
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, the kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: data pointer must be 16-byte aligned")


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().bq_quantize_f32(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                 R, C, stream)
    _raise_on(err, "quantize_blocks")
    launches["quantize_blocks"] += 1
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
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().bq_dequantize_f32(q.data_ptr(), scales.data_ptr(),
                                   out.data_ptr(), R, C, stream)
    _raise_on(err, "dequantize_blocks")
    launches["dequantize_blocks"] += 1
    return out


# -- host-facing wire entry points (the serving runtime's "q8" serializer) ---
#
# The kernels want an aligned 2-D [R, C] grid; the wire sees arbitrary
# activation leaves.  These wrappers flatten, zero-pad to a power-of-two
# number of (8, 128) tiles, copy to the device, run the kernel and copy the
# result back: the reference's np -> device -> kernel -> np path.


def _pow2_tiles(n: int) -> int:
    """Whole (8, 128) tiles covering n values, rounded up to a power of two
    (the reference pads so its jit cache sees a bounded set of shapes; the
    port keeps the padding so the blobs stay byte-identical)."""
    tiles = -(-n // (TILE_R * WIRE_C))
    p = 1
    while p < tiles:
        p *= 2
    return p


def quantize_wire(arr: np.ndarray, device: str | torch.device | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Arbitrary-shape array -> (int8 payload [Np], float32 scales [Np/1024]).

    ``Np`` is ``arr.size`` zero-padded up to a power-of-two count of
    (8, 128) tiles; the caller records the true element count and may trim
    the int8 payload to it (zero input quantizes to zero, so the padding is
    reconstructible on decode).
    """
    a = np.ascontiguousarray(arr, dtype=np.float32).ravel()
    n = a.size
    if n == 0:
        return np.zeros(0, np.int8), np.zeros(0, np.float32)
    np_full = _pow2_tiles(n) * TILE_R * WIRE_C
    if np_full > n:
        a = np.concatenate([a, np.zeros(np_full - n, np.float32)])
    x = torch.from_numpy(a.reshape(-1, WIRE_C)).to(get_device(device))
    q, s = quantize_blocks(x)
    return q.cpu().numpy().ravel(), s.cpu().numpy().ravel()


def dequantize_wire(q: np.ndarray, scales: np.ndarray, n: int,
                    shape: tuple[int, ...], dtype,
                    device: str | torch.device | None = None) -> np.ndarray:
    """Invert :func:`quantize_wire` back to ``shape``/``dtype``.  Accepts an
    int8 payload trimmed to ``n`` — the tail tiles quantized from zero
    padding are re-synthesized as zeros."""
    if n == 0:
        return np.zeros(shape, dtype)
    np_full = scales.size * TILE_R * TILE_C    # one scale per (8, 128) tile
    qf = np.zeros(np_full, np.int8)
    qf[:q.size] = q
    dev = get_device(device)
    q2 = torch.from_numpy(qf.reshape(-1, WIRE_C)).to(dev)
    s2 = torch.from_numpy(np.array(scales, np.float32)    # owned copy
                          .reshape(-1, WIRE_C // TILE_C)).to(dev)
    out = dequantize_blocks(q2, s2).cpu().numpy()
    return out.ravel()[:n].reshape(shape).astype(dtype, copy=False)
