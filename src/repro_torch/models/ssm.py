"""Mamba2 block via SSD (state-space duality), chunk-parallel form (the twin
of ``repro.models.ssm``).

Recurrence per head (state S in R^{P x N}):
    S_t = exp(dt_t * A) * S_{t-1} + dt_t * x_t B_t^T,    y_t = S_t C_t + D x_t

Prefill uses the SSD chunked algorithm (arXiv:2405.21060): a quadratic
attention-like term inside chunks of length Q and a linear recurrence
across chunks, O(S*Q) not O(S^2).  ``use_kernel`` runs the scan as the
port's CUDA kernel (:mod:`repro_torch.kernels.ssd_scan`, its plain version
for CPU tensors); without it the scan is the Python loop over chunks
below, which is also the kernel's oracle at small shapes.  Decode is the
O(1) single-step recurrence.

``init_mamba`` takes a numpy ``Generator`` and returns numpy arrays in the
reference's names and layouts, as :mod:`repro_torch.models.layers` does;
the apply functions take torch tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.device import get_device
from repro_torch.models.layers import he_init, init_rmsnorm, rmsnorm


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_model: int
    ssm: SSMConfig

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.ssm.state_dim   # x + B + C (G=1)


def init_mamba(rng: np.random.Generator, s: MambaSpec, dtype) -> dict:
    di, N, H = s.d_inner, s.ssm.state_dim, s.n_heads
    return {
        "ln": init_rmsnorm(s.d_model, dtype),
        "in_proj": he_init(rng, (s.d_model, 2 * di + 2 * N + H), dtype),
        "conv_w": he_init(rng, (s.ssm.conv_width, s.conv_channels), dtype,
                          fan_in=s.ssm.conv_width),
        "conv_b": np.zeros((s.conv_channels,), dtype),
        "A_log": np.zeros((H,), np.float32),           # A = -exp(A_log) ~ -1
        "D": np.ones((H,), np.float32),
        "dt_bias": np.zeros((H,), np.float32),
        "norm": init_rmsnorm(di, dtype),
        "out_proj": he_init(rng, (di, s.d_model), dtype),
    }


def mamba_param_count(s: MambaSpec) -> int:
    di, N, H, w = s.d_inner, s.ssm.state_dim, s.n_heads, s.ssm.conv_width
    return (s.d_model                              # ln
            + s.d_model * (2 * di + 2 * N + H)     # in_proj
            + w * s.conv_channels + s.conv_channels
            + 3 * H                                # A_log, D, dt_bias
            + di                                   # gated norm
            + di * s.d_model)                      # out_proj


def _split_proj(s: MambaSpec, zxbcdt: torch.Tensor):
    di, N = s.d_inner, s.ssm.state_dim
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * N]
    dt = zxbcdt[..., di + di + 2 * N:]
    return z, xBC, dt


def _causal_conv(xBC, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv, width w.  xBC [B,S,ch]; conv_state [B,w-1,ch].

    The new state is a copy, so a cache does not keep the whole padded
    sequence alive."""
    w = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros_like(xBC[:, : w - 1])
    else:
        pad = conv_state
    xp = torch.cat([pad, xBC], dim=1)
    out = sum(xp[:, i:i + xBC.shape[1]] * conv_w[i] for i in range(w))
    new_state = xp[:, -(w - 1):].clone()
    return F.silu(out + conv_b), new_state


def ssd_chunked(x, dt, A, B_mat, C_mat, chunk: int, init_state=None,
                use_kernel: bool = False):
    """SSD scan.  x [B,S,H,P]; dt [B,S,H] (>0); A [H] (<0);
    B_mat/C_mat [B,S,N] (single group, broadcast over heads).
    Returns (y [B,S,H,P], final_state [B,H,P,N]).

    ``S % chunk`` rows are padded with dt = 0 steps (state-neutral), and a
    prompt shorter than a chunk is one chunk of Q = S."""
    Bb, S, H, P = x.shape
    N = B_mat.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:                       # pad with dt=0 steps (state-neutral)
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_mat = F.pad(B_mat, (0, 0, 0, pad))
        C_mat = F.pad(C_mat, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q

    xc = x.reshape(Bb, nc, Q, H, P)
    dtc = dt.reshape(Bb, nc, Q, H)
    Bc = B_mat.reshape(Bb, nc, Q, N)
    Cc = C_mat.reshape(Bb, nc, Q, N)

    if init_state is None:
        init_state = torch.zeros((Bb, H, P, N), dtype=torch.float32,
                                 device=x.device)

    if use_kernel:
        from repro_torch.kernels import ops as kops
        y, final = kops.ssd_scan(xc, dtc, A, Bc, Cc, init_state)
        return y[:, :S_orig], final

    f32 = torch.float32
    # mask, then exp: above the diagonal the exponent would be positive
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    state = init_state
    ys = []
    for c in range(nc):
        xq, dtq = xc[:, c], dtc[:, c].to(f32)      # [B,Q,H,P], [B,Q,H]
        Bq, Cq = Bc[:, c].to(f32), Cc[:, c].to(f32)   # [B,Q,N]
        l = dtq * A                                         # [B,Q,H] (<=0)
        cum = torch.cumsum(l, dim=1)                        # [B,Q,H]
        # intra-chunk quadratic term
        diff = cum[:, :, None, :] - cum[:, None, :, :]      # [B,Q,Q,H]
        Lmat = torch.exp(torch.where(causal[None, :, :, None], diff,
                                     -torch.inf))
        CB = torch.einsum("bqn,bsn->bqs", Cq, Bq)                 # [B,Q,Q]
        scores = CB[:, :, :, None] * Lmat * dtq[:, None, :, :]    # [B,Q,Q,H]
        y = torch.einsum("bqsh,bshp->bqhp", scores, xq.to(f32))
        # inter-chunk: contribution of incoming state
        y = y + torch.einsum("bqn,bhpn->bqhp", Cq, state) \
            * torch.exp(cum)[:, :, :, None]
        # state update
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)            # [B,Q,H]
        dx = xq.to(f32) * (dtq * decay_to_end)[..., None]
        state = state * torch.exp(cum[:, -1])[:, :, None, None] \
            + torch.einsum("bqhp,bqn->bhpn", dx, Bq)
        ys.append(y.to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(Bb, S, H, P)[:, :S_orig]
    return y, state


def mamba_block(p: dict, s: MambaSpec, x: torch.Tensor, eps: float = 1e-5,
                use_kernel: bool = False) -> torch.Tensor:
    """Full Mamba2 block (prefill).  x [B,S,d] -> [B,S,d]."""
    B, S, _ = x.shape
    di, N, H, P = s.d_inner, s.ssm.state_dim, s.n_heads, s.ssm.head_dim
    h = rmsnorm(p["ln"], x, eps)
    z, xBC, dt_raw = _split_proj(s, h @ p["in_proj"])
    xBC, _ = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xs = xBC[..., :di].reshape(B, S, H, P)
    Bm = xBC[..., di:di + N]
    Cm = xBC[..., di + N:]
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, _ = ssd_chunked(xs, dt, A, Bm, Cm, s.ssm.chunk, use_kernel=use_kernel)
    y = y + xs * p["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(B, S, di)
    y = rmsnorm(p["norm"], y * F.silu(z), eps)
    return x + y @ p["out_proj"]


# -- decode -------------------------------------------------------------------

def init_mamba_cache(s: MambaSpec, batch: int, dtype: torch.dtype,
                     device: str | torch.device | None = None) -> dict:
    """Conv and SSM state on ``device`` (CUDA unless the caller asks for
    the CPU)."""
    dev = get_device(device)
    return {
        "conv": torch.zeros((batch, s.ssm.conv_width - 1, s.conv_channels),
                            dtype=dtype, device=dev),
        "ssd": torch.zeros((batch, s.n_heads, s.ssm.head_dim,
                            s.ssm.state_dim), dtype=torch.float32, device=dev),
    }


def mamba_decode(p: dict, s: MambaSpec, x: torch.Tensor, cache: dict,
                 eps: float = 1e-5):
    """One token.  x [B,1,d] -> ([B,1,d], new_cache).  O(1) in history."""
    B = x.shape[0]
    di, N, H, P = s.d_inner, s.ssm.state_dim, s.n_heads, s.ssm.head_dim
    f32 = torch.float32
    h = rmsnorm(p["ln"], x, eps)
    z, xBC, dt_raw = _split_proj(s, h @ p["in_proj"])
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], cache["conv"])
    xs = xBC[:, 0, :di].reshape(B, H, P)
    Bm = xBC[:, 0, di:di + N].to(f32)
    Cm = xBC[:, 0, di + N:].to(f32)
    dt = F.softplus(dt_raw[:, 0].to(f32) + p["dt_bias"])           # [B,H]
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)                                          # [B,H]
    S_new = cache["ssd"] * a[:, :, None, None] + torch.einsum(
        "bhp,bn->bhpn", xs.to(f32) * dt[..., None], Bm)
    y = torch.einsum("bhpn,bn->bhp", S_new, Cm)
    y = y + xs.to(f32) * p["D"][None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z), eps)
    return x + y @ p["out_proj"], {"conv": new_conv, "ssd": S_new}


def mamba_flops(s: MambaSpec, tokens: int) -> float:
    di, N, H, P, Q = (s.d_inner, s.ssm.state_dim, s.n_heads, s.ssm.head_dim,
                      s.ssm.chunk)
    proj = 2.0 * tokens * s.d_model * (2 * di + 2 * N + H) \
        + 2.0 * tokens * di * s.d_model
    intra = 2.0 * tokens * Q * (N + H * P)       # CB^T + scores@x
    inter = 4.0 * tokens * H * P * N             # state in/out
    return proj + intra + inter
