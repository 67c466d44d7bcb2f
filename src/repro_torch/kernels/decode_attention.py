"""Single-token GQA decode attention: the CUDA kernel's wrapper.

Twin of ``repro.kernels.decode_attention``, whose Pallas TPU kernel this
module's CUDA C++ kernel (``csrc/decode_attention.cu``, built for
``sm_90a`` at first use) replaces.  One query token per row attends over a
KV cache with a ``kpos`` sidecar (-1 = empty slot) and an optional window;
the softmax runs online in f32 with masked logits at -1e30.

The kernel splits the cache length into ``SPLIT_C``-slot chunks, one CTA
per (chunk, kv head and group of query rows, row), and combines the chunks
in a fixed order, so a row's result never depends on the batch it is
stacked in.  It takes any group size G = H/kv, any head_dim up to
``MAX_HD`` (the wrapper raises above it, on any device) and a C that is a
multiple of ``BLOCK_C`` (:func:`repro_torch.kernels.ops.decode_attention`
pads the cache with ``kpos = -1``).  Its first pass has two forms, chosen
by (G, hd) alone (:func:`form`): the register form streams K/V tiles
through a ring of 16-byte ``cp.async`` copies, so on a card it needs k, v
and kpos 16-byte aligned (the wrapper raises otherwise); the shared-memory
form takes the rest of the domain.

A wrapper given CPU tensors runs the plain PyTorch version
(:func:`repro_torch.kernels.ref.decode_attention_ref`); given CUDA tensors
it launches the kernel or raises.  ``launches`` counts kernel launches
only; ``plain_calls`` counts the CPU path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

BLOCK_C = 32          # cache slots per shared-memory tile (csrc kTile)
SPLIT_C = 256         # cache slots per CTA: the split depends on C only
MAX_HD = 256          # head_dim (csrc kMaxHd); any number of query rows
REG_MAX_G = 32        # register form: query rows per kv head (csrc kRegG)
REG_MAX_HD = 128      # register form: head_dim at most (csrc kRegHd)
REG_HD_MULTIPLE = 8   # register form: head_dim a multiple (kRegHdMultiple)
ALIGN = 16            # register form: bytes of alignment of k, v and kpos

launches = {"decode_attention": 0}
plain_calls = {"decode_attention": 0}


def reset_counts() -> None:
    launches["decode_attention"] = 0
    plain_calls["decode_attention"] = 0


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The kernel library, built and bound on first use."""
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import _build
        lib = _build.load("decode_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.da_decode_f32, lib.da_decode_bf16):
            fn.argtypes = [p] * 8 + [i] * 7 + [ctypes.c_float, p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def splits(C: int) -> int:
    """Number of C chunks (CTAs per kv head and row) the kernel uses."""
    return -(-C // SPLIT_C)


def form(G: int, hd: int) -> str:
    """The kernel's first-pass form for G query rows per kv head at head_dim
    ``hd``: "register" or "shared" (csrc ``register_form``)."""
    return ("register" if G <= REG_MAX_G and hd <= REG_MAX_HD
            and hd % REG_HD_MULTIPLE == 0 else "shared")


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
    if hd > MAX_HD:
        raise ValueError(f"decode_attention: head_dim {hd} is above the "
                         f"kernel's limit of {MAX_HD}")
    return B, H, hd, C, kv


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kpos: torch.Tensor, pos: torch.Tensor,
                     window: int | None, scale: float) -> torch.Tensor:
    """q [B,1,H,hd]; k/v [B,C,kv,hd]; kpos [B,C] int32; pos [B] int32 ->
    [B,1,H,hd] in q's dtype."""
    B, H, hd, C, kv = _check_shapes(q, k, v, kpos, pos, window)
    tensors = (q, k, v, kpos, pos)
    if all(t.device.type == "cpu" for t in tensors):
        plain_calls["decode_attention"] += 1
        return ref.decode_attention_ref(q, k, v, kpos, pos, window,
                                        scale).to(q.dtype)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("decode_attention: tensors on "
                         f"{[str(t.device) for t in tensors]}; want one "
                         "cuda device, or all on the cpu")
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
    if form(G, hd) == "register":
        bad = [name for name, t in (("k", k), ("v", v), ("kpos", kpos))
               if t.data_ptr() % ALIGN]
        if bad:
            raise ValueError(f"decode_attention: {'/'.join(bad)} not "
                             f"{ALIGN}-byte aligned; the register form "
                             f"(G={G}, hd={hd}) copies 16-byte chunks")
    n = splits(C)
    part_acc = torch.empty((B, kv, n, G, hd), dtype=torch.float32, device=dev)
    part_ml = torch.empty((B, kv, n, G, 2), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    fn = _lib().da_decode_f32 if q.dtype == torch.float32 \
        else _lib().da_decode_bf16
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(),
             pos.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
             out.data_ptr(), B, C, kv, G, hd, SPLIT_C,
             0 if window is None else int(window), float(scale),
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention: CUDA launch failed with "
                           f"error {err}")
    launches["decode_attention"] += 1
    return out
