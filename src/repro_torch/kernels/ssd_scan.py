"""Mamba2 SSD chunked scan: the CUDA kernel's wrapper.

Twin of ``repro.kernels.ssd_scan``, whose Pallas TPU kernel this module's
CUDA C++ kernel (``csrc/ssd_scan.cu``, built for ``sm_90a`` at first use)
replaces.  Per (batch row, head) the scan runs over the chunks in order,
carrying an f32 state [P, N]: a quadratic attention-like term inside each
chunk plus the incoming state's contribution, then the state update
(arXiv:2405.21060).  The kernel takes the chunk-parallel form: C.B once
per (batch row, chunk), each chunk's own state contribution and output in
parallel over (batch row, chunk, head), and only an elementwise pass over
the chunks in order; the causal mask is applied before the exp.  One call
launches five CUDA kernels and counts as one launch.

The wrapper checks shapes, dtypes and contiguity whatever the device.
Given CPU tensors it then runs the plain PyTorch version
(:func:`repro_torch.kernels.ref.ssd_scan_ref`); given CUDA tensors it
launches the kernel or raises (as it does under autograd with an input
that requires grad: the kernel has no backward).  ``launches`` counts kernel launches only;
``plain_calls`` counts the CPU path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref, refuse_grad

MAX_Q = 256           # chunk length (csrc kMaxQ)
MAX_P = 64            # head_dim (csrc kMaxP)
MAX_N = 128           # state_dim (csrc kMaxN)

launches = {"ssd_scan": 0}
plain_calls = {"ssd_scan": 0}


def reset_counts() -> None:
    launches["ssd_scan"] = 0
    plain_calls["ssd_scan"] = 0


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The kernel library, built and bound on first use."""
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import _build
        lib = _build.load("ssd_scan")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.ssd_scan_f32, lib.ssd_scan_bf16):
            fn.argtypes = [p] * 11 + [i] * 6 + [p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_shapes(xc, dtc, A, Bc, Cc, init_state) -> tuple[int, ...]:
    if xc.dim() != 5:
        raise ValueError(f"ssd_scan: xc {tuple(xc.shape)} is not "
                         "[B,nc,Q,H,P]")
    B, nc, Q, H, P = xc.shape
    N = Bc.shape[-1] if Bc.dim() == 4 else -1
    want = {"dtc": (B, nc, Q, H), "A": (H,), "Bc": (B, nc, Q, N),
            "Cc": (B, nc, Q, N), "init_state": (B, H, P, N)}
    for name, t in (("dtc", dtc), ("A", A), ("Bc", Bc), ("Cc", Cc),
                    ("init_state", init_state)):
        if N < 1 or tuple(t.shape) != want[name]:
            raise ValueError(f"ssd_scan: {name} {tuple(t.shape)} does not "
                             f"match xc {tuple(xc.shape)} (want "
                             f"{want[name]})")
    return B, nc, Q, H, P, N


def ssd_scan(xc: torch.Tensor, dtc: torch.Tensor, A: torch.Tensor,
             Bc: torch.Tensor, Cc: torch.Tensor, init_state: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """xc [B,nc,Q,H,P]; dtc [B,nc,Q,H] f32; A [H] f32; Bc/Cc [B,nc,Q,N];
    init_state [B,H,P,N] f32 -> (y [B,nc,Q,H,P] in xc's dtype,
    final_state [B,H,P,N] f32)."""
    B, nc, Q, H, P, N = _check_shapes(xc, dtc, A, Bc, Cc, init_state)
    tensors = (xc, dtc, A, Bc, Cc, init_state)
    if xc.dtype not in (torch.float32, torch.bfloat16) \
            or Bc.dtype != xc.dtype or Cc.dtype != xc.dtype:
        raise TypeError(f"ssd_scan: xc/Bc/Cc {xc.dtype}/{Bc.dtype}/"
                        f"{Cc.dtype}; the kernel takes float32 or bfloat16, "
                        "all alike")
    if any(t.dtype != torch.float32 for t in (dtc, A, init_state)):
        raise TypeError(f"ssd_scan: dtc/A/init_state {dtc.dtype}/{A.dtype}/"
                        f"{init_state.dtype}; the kernel takes float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan: tensors must be contiguous")
    if all(t.device.type == "cpu" for t in tensors):
        plain_calls["ssd_scan"] += 1
        return ref.ssd_scan_ref(xc, dtc, A, Bc, Cc, init_state)
    refuse_grad("ssd_scan", *tensors)
    dev = xc.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("ssd_scan: tensors on "
                         f"{[str(t.device) for t in tensors]}; want one "
                         "cuda device, or all on the cpu")
    if Q > MAX_Q or P > MAX_P or N > MAX_N:
        raise ValueError(f"ssd_scan: Q={Q} (max {MAX_Q}), P={P} (max "
                         f"{MAX_P}), N={N} (max {MAX_N}) are outside what "
                         "the kernel takes")
    y = torch.empty_like(xc)
    final = torch.empty_like(init_state)
    # the kernel's f32 scratch: cum and dt per (b, chunk, head), C.B per
    # (b, chunk), and each chunk's state (its own contribution, then the
    # state entering it) transposed to [N, P]
    f32 = dict(dtype=torch.float32, device=dev)
    cs = torch.empty((B, nc, H, 2, Q), **f32)
    cb = torch.empty((B, nc, Q, Q), **f32)
    st = torch.empty((B, nc, H, N, P), **f32)
    fn = _lib().ssd_scan_f32 if xc.dtype == torch.float32 \
        else _lib().ssd_scan_bf16
    err = fn(xc.data_ptr(), dtc.data_ptr(), A.data_ptr(), Bc.data_ptr(),
             Cc.data_ptr(), init_state.data_ptr(), y.data_ptr(),
             final.data_ptr(), cs.data_ptr(), cb.data_ptr(), st.data_ptr(),
             B, nc, Q, H, P, N, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan: CUDA launch failed with error {err}")
    launches["ssd_scan"] += 1
    return y, final
