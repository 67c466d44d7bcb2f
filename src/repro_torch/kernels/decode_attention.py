"""Single-token GQA decode attention: the CUDA kernel's wrapper.

Twin of ``repro.kernels.decode_attention``, whose Pallas TPU kernel this
module's CUDA C++ kernel (``csrc/decode_attention.cu``, built for
``sm_90a`` at first use) replaces.  One query token per row attends over a
KV cache with a ``kpos`` sidecar (-1 = empty slot) and an optional window;
the softmax runs online in f32 with masked logits at -1e30.

The kernel splits the cache length into chunks of :func:`split_c` slots,
one CTA per (chunk, kv head and group of query rows, row), and combines
the chunks in a fixed order, so a row's result never depends on the batch
it is stacked in.  It takes any group size G = H/kv, any head_dim up to
``MAX_HD`` (the wrapper raises above it for CUDA tensors; the plain
version takes any) and a C that is a multiple of ``BLOCK_C``
(:func:`repro_torch.kernels.ops.decode_attention` pads a CUDA cache and
names the slots that are the cache, ``live``: the padding slots get no
weight, even in an all-empty row).  Its first pass has three forms,
chosen by (G, hd) alone (:func:`form`): the register and tiled forms
stream K/V tiles through a ring of 16-byte ``cp.async`` copies, so on a
card they need k, v and kpos 16-byte aligned (the wrapper raises
otherwise); the shared-memory form takes the head_dims that are not a
multiple of 8.

A wrapper given CPU tensors runs the plain PyTorch version
(:func:`repro_torch.kernels.ref.decode_attention_ref`); given CUDA tensors
it launches the kernel or raises (as it does under autograd with an input
that requires grad: the kernel has no backward).  ``launches`` counts kernel launches
only, and ``launches_by_shape`` the same launches by (B, H, kv, hd, C);
``plain_calls`` counts the CPU path.  A call made while its thread captures
a CUDA graph (inside :func:`capturing`) launches nothing: it counts in the
capture's own tally, which :func:`replayed` adds to the counters at each
replay of the graph.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from repro_torch.kernels import ref, refuse_grad

BLOCK_C = 32          # cache slots per shared-memory tile (csrc kTile)
SPLIT_C = 256         # cache slots per CTA, register and shared-memory forms
MAX_HD = 256          # head_dim (csrc kMaxHd); any number of query rows
REG_MAX_G = 32        # register form: query rows per kv head (csrc kRegG)
REG_MAX_HD = 128      # register form: head_dim at most (csrc kRegHd)
REG_HD_MULTIPLE = 8   # register form: head_dim a multiple (kRegHdMultiple)
TILED_HD_MULTIPLE = 8  # tiled form: head_dim a multiple (kTiledHdMultiple)
TILED_ROWS = 64       # tiled form: query rows per CTA (csrc kTiledRows)
SLICED_ROWS = 8       # tiled form: up to this, warps slice hd (kSlicedRows)
# tiled form, at most SLICED_ROWS rows per CTA: at most TILED_SPLITS splits
# of at least TILED_SPLIT_C slots (few splits keep the combine pass short,
# each CTA streams 4 tiles or more); with more rows (more arithmetic per
# slot), TILED_WIDE_SPLIT_C slots.  128 CTAs each at gemma3-4b's ring
# (C 1024) and global (C 2048) caches and at granite-34b's (C 2048), B 4.
TILED_SPLIT_C = 128
TILED_SPLITS = 8
TILED_WIDE_SPLIT_C = 64
ALIGN = 16            # register and tiled forms: bytes of alignment of k,
                      # v and kpos

launches = {"decode_attention": 0}
launches_by_shape: dict[tuple[int, ...], int] = {}
plain_calls = {"decode_attention": 0}


def reset_counts() -> None:
    launches["decode_attention"] = 0
    launches_by_shape.clear()
    plain_calls["decode_attention"] = 0


_capture = threading.local()


@contextlib.contextmanager
def capturing():
    """While this thread captures a CUDA graph: yields the tally, by (B, H,
    kv, hd, C), of the launches the graph will make at each replay."""
    tally: dict[tuple[int, ...], int] = {}
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = None


def replayed(tally: dict[tuple[int, ...], int]) -> None:
    """Count one replay of a graph whose capture recorded ``tally``."""
    for shape, n in tally.items():
        launches["decode_attention"] += n
        launches_by_shape[shape] = launches_by_shape.get(shape, 0) + n


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The kernel library, built and bound on first use."""
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import _build
        lib = _build.load("decode_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.da_decode_f32, lib.da_decode_bf16):
            fn.argtypes = [p] * 8 + [i] * 8 + [ctypes.c_float, p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def form(G: int, hd: int) -> str:
    """The kernel's first-pass form for G query rows per kv head at head_dim
    ``hd``: "register", "tiled" or "shared" (csrc ``register_form``, then
    ``tiled_form``)."""
    if G <= REG_MAX_G and hd <= REG_MAX_HD and hd % REG_HD_MULTIPLE == 0:
        return "register"
    return "tiled" if hd % TILED_HD_MULTIPLE == 0 else "shared"


def split_c(C: int, G: int, hd: int) -> int:
    """Cache slots per CTA for a C-slot cache and G query rows per kv head
    at head_dim ``hd``: a multiple of ``BLOCK_C``."""
    if form(G, hd) != "tiled":
        return SPLIT_C
    if min(G, TILED_ROWS) > SLICED_ROWS:
        return TILED_WIDE_SPLIT_C
    return max(TILED_SPLIT_C, -(-C // (TILED_SPLITS * BLOCK_C)) * BLOCK_C)


def splits(C: int, G: int, hd: int) -> int:
    """Number of C chunks (CTAs per kv head, row group and row) the kernel
    uses.  It depends on C, G and hd alone, never on the batch, so a row's
    result is the same alone and stacked."""
    return -(-C // split_c(C, G, hd))


def _check_shapes(q, k, v, kpos, pos, window) -> tuple[int, ...]:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} is not [B,1,H,hd]")
    B, _, H, hd = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != hd \
            or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"decode_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    C, kv = k.shape[1], k.shape[2]
    if H % kv:
        raise ValueError(f"decode_attention: {H} query heads over {kv} kv heads")
    if tuple(kpos.shape) != (B, C) or tuple(pos.shape) != (B,):
        raise ValueError(f"decode_attention: kpos {tuple(kpos.shape)} / pos "
                         f"{tuple(pos.shape)} do not match B={B}, C={C}")
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window {window} must be >= 1")
    return B, H, hd, C, kv


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kpos: torch.Tensor, pos: torch.Tensor,
                     window: int | None, scale: float,
                     live: int | None = None) -> torch.Tensor:
    """q [B,1,H,hd]; k/v [B,C,kv,hd]; kpos [B,C] int32; pos [B] int32 ->
    [B,1,H,hd] in q's dtype.  ``live`` (default C): the cache is slots
    ``[0, live)``; the slots past it are padding and get no weight."""
    B, H, hd, C, kv = _check_shapes(q, k, v, kpos, pos, window)
    live = C if live is None else live
    if not 0 < live <= C:
        raise ValueError(f"decode_attention: live={live} outside (0, {C}]")
    tensors = (q, k, v, kpos, pos)
    if all(t.device.type == "cpu" for t in tensors):
        plain_calls["decode_attention"] += 1
        return ref.decode_attention_ref(q, k[:, :live], v[:, :live],
                                        kpos[:, :live], pos, window,
                                        scale).to(q.dtype)
    refuse_grad("decode_attention", *tensors)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("decode_attention: tensors on "
                         f"{[str(t.device) for t in tensors]}; want one "
                         "cuda device, or all on the cpu")
    if hd > MAX_HD:
        raise ValueError(f"decode_attention: head_dim {hd} is above the "
                         f"kernel's limit of {MAX_HD}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: q/k/v {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes float32 or bfloat16, "
                        "all alike")
    if kpos.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("decode_attention: kpos and pos must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention: tensors must be contiguous")
    G = H // kv
    if C % BLOCK_C:
        raise ValueError(f"decode_attention: C={C} is not a multiple of "
                         f"{BLOCK_C} (ops.decode_attention pads it)")
    f = form(G, hd)
    if f != "shared":
        bad = [name for name, t in (("k", k), ("v", v), ("kpos", kpos))
               if t.data_ptr() % ALIGN]
        if bad:
            raise ValueError(f"decode_attention: {'/'.join(bad)} not "
                             f"{ALIGN}-byte aligned; the {f} form "
                             f"(G={G}, hd={hd}) copies 16-byte chunks")
    n = splits(C, G, hd)
    part_acc = torch.empty((B, kv, n, G, hd), dtype=torch.float32, device=dev)
    part_ml = torch.empty((B, kv, n, G, 2), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    fn = _lib().da_decode_f32 if q.dtype == torch.float32 \
        else _lib().da_decode_bf16
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(),
             pos.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
             out.data_ptr(), B, C, live, kv, G, hd, split_c(C, G, hd),
             0 if window is None else int(window), float(scale),
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention: CUDA launch failed with "
                           f"error {err}")
    shape = (B, H, kv, hd, C)
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        tally[shape] = tally.get(shape, 0) + 1
    else:
        launches["decode_attention"] += 1
        launches_by_shape[shape] = launches_by_shape.get(shape, 0) + 1
    return out
