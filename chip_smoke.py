"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # on a machine with a CUDA card

Phases, each printing JSON records on their own lines:

1. the card (name and power limit as ``nvidia-smi`` gives them), the torch
   and CUDA versions, the compute capability;
2. the build of every CUDA source under ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, started together), with its time and the
   assembler's register report; decode attention's register and tiled
   forms must build without spills in both dtypes;
3. each kernel against its plain PyTorch version on the card: block
   quantization byte for byte at the grid shapes and on edge-case tiles
   (the subnormal tiles also against the reference's pinned values), and
   in its ragged form (the first n values of a zero-padded grid) at the
   q8 wire's leaf sizes (``RAGGED``: parts of a tile, slice A's batch-1
   and batch-4 leaves, n not a multiple of 4) and the edge tiles, where
   ``quantize_wire`` / ``dequantize_wire`` on the card must also give the
   plain wire path's bytes; decode attention within 1e-5 (f32) / 2e-2
   (bf16) on the reference's
   sweep, the zoo's widest heads (G 2 at hd 256, G 48 at hd 128, G 5 at
   hd 96 with a padded C), hd 100 (the shared-memory form), the register
   form's edge Cs (32, 288, 672) and the tiled form's at hd 256 and G 48
   (one tile, a last split of one tile), the decode path's shapes, an
   all-empty cache and an all-empty row of a padded C (100 and 650, all
   three forms: the padding gets no weight), and batch-invariant
   bit for bit at G 12, 48 and hd 256, window None and 128; the SSD
   scan on the reference's sweep (its bars 1e-4 / 5e-2), Mamba2-2.7B's
   prefill shape, a ragged 100-token chunk and a chunk whose decay
   overflows the TPU kernel (finite), and 4 chunks against 2 + 2; after
   the main paths, each kernel is timed with CUDA events at the path's
   shapes (block quantization at slice A's leaves in its ragged form,
   bound on the bytes it moves, and at the grid shapes), on the
   device (calls captured in a CUDA graph and replayed)
   and per call from Python, with inputs rotated through more than the
   50 MB L2, beside its bound, its plain version and, for decode
   attention (at slice C's shape in f32 and bf16, gemma3-4b's local and
   global layers' and granite-34b's), ``scaled_dot_product_attention``;
   the SSD scan's five
   phases are timed from one profiler pass; and one whole
   ``quantize_wire`` and ``dequantize_wire`` call per slice A leaf is
   timed from Python beside the padded wire path they replaced;
4. slice A's path at full width: ResNet50 (224x224, 1000 classes, seeded
   fan-in-scaled weights) cut by ``balanced_latency`` into a 4-stage chain
   with one replicated stage, served by ``InferenceEngine(device="cuda")``
   with the raw, q8 and zfp/lz4 codecs over ``inproc`` and q8 over
   ``tcp``, each engine serving its requests twice (first and warm
   window); outputs are held against single-device ``apply`` on the card
   (TF32 off) and on the CPU, and the block-quant launch counters must
   rise during it;
4b. the serving controller over the same chain
   (``InferenceEngine(controller=ControllerConfig(...))``): raw, with
   stage 0 slowed by a 20 ms sleep per wave, one explicit
   ``Controller.step()`` after 16 requests must migrate layers off stage 0
   (epoch 1, the swap's ``precompile()`` run on the card) and 8 requests
   after the swap must equal single-device apply within 1e-4; then q8
   with the controller thread stepping every 0.5 s over two windows of 8
   requests: no action an error, outputs within the q8 bar, the
   block-quant kernels launched and their plain versions not run;
4c. process-per-replica serving over the same chain
   (``supervised_engine`` with ``repro_torch.models.cnn:resnet50`` as the
   workers' graph factory): 5 worker processes, each with its own CUDA
   context on the card, its own q8 codec and the parent's TF32 choice;
   two windows of 8 requests raw and two through q8 against
   single-device apply, every worker on ``cuda:0``, under q8 every
   worker's block-quant kernels launched and their plain versions never;
   then a kill drill with a ``RetryPolicy``: 4 closed-loop clients for 32
   requests, one stage-1 worker SIGKILLed mid-load, no client-visible
   failure, the death and a respawn in the supervisor's events, stage 1
   back to 2 replicas and its newcomer serving a window; every surviving
   worker says bye and exits 0 and no child process is left;
5. slice C's path, decode serving at StarCoder2-3B's widths (30 layers,
   d_model 3072, 24 query / 2 kv heads of 128, d_ff 12288, vocab 49152,
   a 4096-slot KV cache, f32, seeded fan-in weights): 8 concurrent
   ``generate()`` sessions (prompts of 128-512 tokens, 32 new tokens
   each) through a 4-stage chain with stage 1 replicated twice, twice
   (first window with a live ``scale()`` of stage 1, then a warm window);
   every token must equal the port's single-device
   ``pipeline_decode_reference`` on the card, the decode-attention kernel
   must launch and its plain version must not run;
6. slice D's path, Mamba2-2.7B at its published widths and depth (64
   layers, d_model 2560, 80 heads of 64, d_state 128, chunk 256, vocab
   50280 padded to 50304, f32, seeded fan-in weights drawn on the card):
   4 prompts of 2048 tokens through ``transformer.prefill(...,
   use_kernel=True)`` (twice: cold, then timed warm), then 32 greedy
   ``decode_step``s at B=4.  The kernel prefill's logits and every
   layer's SSD and conv states must match ``prefill(use_kernel=False)``;
   every token must equal the plain ``forward``'s argmax over the
   extended sequences wherever its top-1/top-2 margin clears the stated
   bar; the SSD kernel must launch once per layer and prefill and its
   plain version must not run;
7. slice E's path, the LM zoo's attention decode: gemma3-4b at its
   published widths and depth (34 layers, 8 query over 4 kv heads of 256,
   windows 1024 x5 then global, vocab 262144) with 4 prompts of 1536
   tokens, and granite-34b at its published widths cut to 8 of its 88
   layers (48 query heads over one kv head of 128) with 4 prompts of
   1024, each through ``transformer.prefill`` and 32 greedy
   ``decode_step(..., use_kernel=True)``s (f32, seeded fan-in weights
   drawn on the card).  Every step's logits must match
   ``decode_step(use_kernel=False)`` from a copy of the same caches;
   every token must equal the plain ``forward``'s argmax wherever its
   top-1/top-2 margin clears the stated bar; decode attention must
   launch once per attention layer and step and its plain version must
   not run.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result; so does a machine without CUDA.
``--cpu-rehearsal`` runs phases 4 to 7 on the CPU at small sizes (no
kernel build; slice E with its head geometry kept; phases 4b and 4c with
ResNet50's 1000 classes, 4c's workers on the CPU), to rehearse the
control flow without a card; it never prints a result and exits 3.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch.nn.functional as F  # noqa: E402

from repro_torch.core.graph import tree_flatten_with_path  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import block_quant as bq  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.configs import base as cfg_base  # noqa: E402
from repro_torch.configs import gemma3_4b, granite_34b, mamba2_2_7b  # noqa: E402
from repro_torch.models import cnn, lm_graph, transformer  # noqa: E402
from repro_torch.core.metrics import H100  # noqa: E402
from repro_torch.runtime import (ControllerConfig,  # noqa: E402
                                 DispatcherCodecs, InferenceEngine,
                                 TopologySpec, WireCodec)

HBM_BYTES_PER_S = H100.hbm_bw    # H100 SXM data sheet
F32_OPS_PER_S = H100.peak_flops  # H100 SXM, float32 outside the tensor cores
SWEEP = [(8, 128), (2048, 128), (4096, 128), (32768, 128), (1024, 512)]
# the q8 wire's ragged leaves (n values of a zero-padded power-of-two tile
# grid): parts of a tile, one off a tile either way, slice A's batch-1
# leaves (ResNet50's input; stem_pool, s0b0_c2 and s2b0_add; s1b0_add),
# their batch-4 sizes, one past the largest batch-1 leaf
RAGGED = [1, 3, 1000, 1023, 1025, 150_528, 200_704, 401_408, 602_112,
          802_816, 1_605_632, 401_409]
# timed: the logits (one tile) and the batch-1 and batch-4 leaves
RAGGED_TIMED = [1000, 150_528, 200_704, 401_408, 602_112, 802_816,
                1_605_632]
RAW_TOL_REL = 1e-4      # chain vs single-device on the card: batched cuDNN
CPU_TOL_REL = 1e-3      # card vs CPU apply (different conv algorithms)
Q8_REL = 0.05           # 5 quantize passes, each within absmax/254
ZFP_REL = 0.15          # the reference's bar for ZFP-16 + LZ4
DA_F32_ATOL = 1e-5      # decode attention kernel vs plain (f32)
DA_BF16_ATOL = 2e-2     # the reference sweep's bar for bf16 inputs
# decode attention shapes (B, H, kv, hd, C): the reference's sweep
# (tests/test_kernels.py); the zoo's widest heads at slice E's shapes
# (gemma3-4b's local and global layers, granite-34b's), one split at B=1,
# and G 5 at hd 96 with a C that ops.decode_attention pads; hd 100, the
# shared-memory form's domain; the register form's edge Cs at slice C's
# heads (one tile: nothing to prefetch; a last split of one tile; a last
# split of five tiles) and the tiled form's at gemma3-4b's and
# granite-34b's heads (one tile; a last split of one tile); then the
# decode path's at batch 1 and 8
DA_SWEEP = [(1, 4, 4, 64, 256), (2, 8, 2, 64, 512), (2, 8, 1, 128, 1024),
            (1, 16, 4, 80, 640), (4, 8, 4, 256, 1024), (4, 8, 4, 256, 2048),
            (4, 48, 1, 128, 2048), (1, 48, 1, 128, 256), (2, 40, 8, 96, 650),
            (2, 8, 2, 100, 256),
            (2, 24, 2, 128, 32), (2, 24, 2, 128, 288), (2, 24, 2, 128, 672),
            (2, 8, 4, 256, 32), (2, 8, 4, 256, 160), (2, 48, 1, 128, 32),
            (2, 48, 1, 128, 96)]
DA_PATH = [(1, 24, 2, 128, 4096), (8, 24, 2, 128, 4096)]
# an all-empty row 0 beside a filled row 1 at C 100 and 650, which
# ops.decode_attention pads for the kernel (the padding must get no
# weight): the register, tiled and shared-memory forms
DA_EMPTY_ROW = [(2, 24, 2, 128, 100), (2, 24, 2, 128, 650),
                (2, 8, 4, 256, 100), (2, 8, 4, 256, 650),
                (2, 8, 2, 100, 100), (2, 8, 2, 100, 650)]
# batch invariance at B=8: slice C's heads, granite-34b's and gemma3-4b's
DA_INVARIANCE = [(8, 24, 2, 128, 4096), (8, 48, 1, 128, 2048),
                 (8, 8, 4, 256, 2048)]
# timed beside slice C's step shape: slice E's layers at B=4 (gemma3-4b's
# global and sliding-window ring caches, granite-34b's)
DA_ZOO_TIMED = [(4, 8, 4, 256, 2048), (4, 8, 4, 256, 1024),
                (4, 48, 1, 128, 2048)]
# StarCoder2-3B (arXiv:2402.19173; src/repro/configs/starcoder2_3b.py) in
# the reference's decode graph: a 4096-slot cache, its sliding window
STARCODER2_3B = dict(vocab=49152, d_model=3072, n_layers=30, num_heads=24,
                     kv_heads=2, head_dim=128, d_ff=12288, cache_len=4096)
SESSIONS, NEW_TOKENS, PROMPT_LEN = 8, 32, (128, 512)
# SSD scan, kernel vs plain.  On the reference's sweep and its input
# distribution (dt ~ U(0.001, 0.1)), the reference's own bars: 1e-4 (f32)
# and 5e-2 (bf16).  At the Mamba2 path's distribution (dt = softplus of a
# fan-in projection, A = -1) a chunk's cum = cumsum(dt*A) reaches ~-256,
# where one f32 ulp is 3e-5, and both versions exponentiate differences of
# such sums in their own order: there the bar is 1e-3 of the case's
# largest |y| (and of the largest |state|).  A bf16 output may in
# addition round to the neighbouring bf16 value: + 2^-7 |y|.
SSD_F32_ATOL, SSD_BF16_ATOL, SSD_STATE_RTOL = 1e-4, 5e-2, 1e-3
SSD_PATH_REL = 1e-3
BF16_ULP = 2.0 ** -7
# (B, nc, Q, H, P, N): the reference's sweep (tests/test_kernels.py), then
# Mamba2-2.7B's prefill at B=4, S=2048 and a 100-token prompt (one ragged
# chunk of Q = 100)
SSD_SWEEP = [(1, 2, 16, 2, 16, 8), (2, 4, 32, 3, 32, 16), (1, 8, 64, 2, 64, 64)]
SSD_PATH = (4, 8, 256, 80, 64, 128)
SSD_RAGGED = (4, 1, 100, 80, 64, 128)
# the CUDA kernels one SSD-scan call launches, in order (csrc/ssd_scan.cu)
SSD_PHASES = ("cum", "cb", "state", "pass", "scan")
# Mamba2-2.7B (arXiv:2405.21060; src/repro_torch/configs/mamba2_2_7b.py) at
# its published widths and depth: 4 prompts of 2048 tokens, 32 greedy
# steps.  Kernel prefill vs plain prefill: the two scans differ only in
# their f32 summation order (above), which 64 layers amplify; a CPU run of
# this depth at d_model 512 with the kernel's cumsum order moved the
# logits by 1.4e-4 and a layer's state by 1.9e-4 of its largest value, so
# the bars are 5e-3 absolute for logits (|logits| ~ 2) and 5e-3 of each
# layer's largest |state| (ssd and conv).  A greedy token must equal the
# plain forward's argmax wherever that forward's top-1/top-2 margin is at
# least MAMBA_MARGIN (twice the logit bar: both logits may move).
MAMBA_BATCH, MAMBA_PROMPT, MAMBA_STEPS = 4, 2048, 32
MAMBA_LOGIT_ATOL, MAMBA_STATE_REL, MAMBA_MARGIN = 5e-3, 5e-3, 1e-2
# Slice E, the LM zoo's attention decode: gemma3-4b (hf:google/gemma-3-1b-pt;
# src/repro_torch/configs/gemma3_4b.py) at its published widths and depth;
# granite-34b (arXiv:2405.04324) at its published widths, cut to 8 of its
# 88 layers: the whole model is ~134 GB in f32 and the card holds 80 GB.
# (config, prompt length, the cut); 4 prompts, 32 greedy steps, caches of
# 2048 slots (gemma3-4b's local layers hold their 1024-slot window).
ZOO_RUNS = [(gemma3_4b.CONFIG, 1536, None),
            (dataclasses.replace(granite_34b.CONFIG, num_layers=8), 1024,
             "num_layers 88 -> 8: ~134 GB of f32 weights at full depth do "
             "not fit one 80 GB card")]
# Kernel decode_step vs plain decode_step from the same caches: the two
# attentions differ by at most DA_F32_ATOL (1e-5) per output element; a
# CPU run at these depths and head shapes (d_model 512 / 1024) with every
# attention output moved by uniform noise of 1e-5 moved the logits (|x| up
# to 2.6) by at most 1.1e-4, 2.5e-4 scaled to full width: the bar is 1e-3.
# Greedy tokens vs the plain forward: decode and forward logits must agree
# within half the margin bar (other GEMM shapes and attention code, summed
# in other orders), and a token must equal the forward's argmax wherever
# its top-1/top-2 margin is at least ZOO_MARGIN (both logits may move).
ZOO_BATCH, ZOO_STEPS, ZOO_MAX_LEN = 4, 32, 2048
ZOO_STEP_ATOL, ZOO_MARGIN = 1e-3, 1e-2
# subnormal tiles [a, -a/2, 0.3a, 0...]: (a, q of the first 3, scale) as
# the reference computes them (XLA reads subnormals as zero and flushes a
# subnormal scale; a TPU has none)
FLT_MIN = float(np.finfo(np.float32).tiny)
SUBNORMAL_TABLE = [(1e-44, [0, 0, 0], 1.0), (FLT_MIN / 2, [0, 0, 0], 1.0),
                   (FLT_MIN, [127, 0, 0], 0.0),
                   (2 * FLT_MIN, [127, -127, 0], 0.0),
                   (100 * FLT_MIN, [127, -127, 127], 0.0),
                   (127 * FLT_MIN, [127, -64, 38], FLT_MIN)]


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

def _da_ptxas(log: str) -> list[dict]:
    """Registers and spill bytes of each decode-attention kernel from the
    assembler's ``-v`` report, the mangled names made readable
    (``reg_split_kernel<bf16, 3>``: the register form at 3 rows a warp;
    ``tiled_split_kernel<f32, 8, 6>``: the tiled form, 8 row groups of 6
    rows)."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            # the mangled name's length prefix keeps split_kernel from
            # matching inside reg_ or tiled_split_kernel
            k = re.search(r"\d(tiled_split_kernel|reg_split_kernel|"
                          r"split_kernel|combine_kernel)"
                          r"I(f|13__nv_bfloat16)((?:Li\d+E)*)", m.group(1))
            args = [] if k is None else re.findall(r"Li(\d+)E", k.group(3))
            name = m.group(1) if k is None else (
                f"{k.group(1)}<"
                + ", ".join(['f32' if k.group(2) == 'f' else 'bf16'] + args)
                + ">")
            cur = {"kernel": name}
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def build_kernels() -> None:
    names = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                   if f.endswith(".cu"))
    t0 = time.perf_counter()
    paths = _build.build(names)
    emit(phase="build", sources=names, seconds=time.perf_counter() - t0,
         libraries={n: os.path.relpath(p, ROOT) for n, p in paths.items()},
         ptxas={n: [ln for ln in _build.build_info[n]["log"].splitlines()
                    if any(w in ln for w in ("entry function", "registers",
                                             "spill"))]
                for n in names})
    log = _build.build_info["decode_attention"]["log"]
    if log != "(reused)":
        da_k = _da_ptxas(log)
        emit(phase="ptxas_decode_attention", kernels=da_k)
        # register form: 8 row counts; tiled form: 8 row counts of one
        # row group and 7 of 8 row groups; each in 2 dtypes
        for prefix, want in (("reg_split_kernel<", 16),
                             ("tiled_split_kernel<", 30)):
            ks = [k for k in da_k if k["kernel"].startswith(prefix)]
            check(len(ks) == want and all(
                k.get("spill_stores") == 0 and k.get("spill_loads") == 0
                for k in ks),
                f"decode attention's {prefix[:-1]}: want {want} kernels "
                f"without spills, ptxas says {ks}")


# -- phase 3: kernels against their plain versions ------------------------------

def _data(shape, seed) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 4, size=shape)
    return torch.from_numpy(x.astype(np.float32))


def _edge_tiles() -> torch.Tensor:
    """All-zero tile; exact .5 ties at scale 1.0; clip at ±127; a large
    value beside tiny ones; a subnormal absmax; then one tile per row of
    SUBNORMAL_TABLE (from row 40)."""
    x = np.zeros((40 + 8 * len(SUBNORMAL_TABLE), 128), np.float32)
    x[8, 0] = 127.0
    x[8, 1:9] = [2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 1.5, -1.5]
    x[16, :4] = [127.0, -127.0, 126.5, -126.5]
    x[24, 0], x[25, :3] = 1e6, [1e-3, -1e-3, 3e3]
    x[32, :3] = [1e-44, -1e-44, 5e-45]
    for i, (a, _, _) in enumerate(SUBNORMAL_TABLE):
        a = np.float32(a)
        x[40 + 8 * i, :3] = [a, -a / np.float32(2), np.float32(0.3) * a]
    return torch.from_numpy(x)


def _check_subnormal_table(q: torch.Tensor, s: torch.Tensor) -> None:
    """The kernel's subnormal tiles hold the reference's values."""
    q, s = q.cpu().numpy(), s.cpu().numpy()
    for i, (a, want_q, want_s) in enumerate(SUBNORMAL_TABLE):
        r = 40 + 8 * i
        got_q = [int(v) for v in q[r, :3]]
        rest = q[r:r + 8].copy()
        rest[0, :3] = 0
        ok = (got_q == want_q and not rest.any()
              and s[r // 8, 0].tobytes() == np.float32(want_s).tobytes())
        emit(phase="subnormal_tile", absmax=a, q=got_q,
             scale=float(s[r // 8, 0]), want_q=want_q, want_scale=want_s,
             identical_to_reference=bool(ok))
        check(ok, f"subnormal tile a={a}: q {got_q} scale {s[r // 8, 0]} "
                  f"!= reference {want_q} {want_s}")


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
    _check_subnormal_table(q, s)            # the last case: the edge tiles
    edge = _edge_tiles().reshape(-1)
    cases = [(n, _data((n,), seed=n)) for n in RAGGED]
    cases += [(edge.numel(), edge), (edge.numel() - 5, edge[:-5])]
    for n, x in cases:
        compare_ragged(dev, n, x, err)
    return err


def compare_ragged(dev, n: int, x: torch.Tensor, err: dict) -> None:
    """The ragged kernels (n values of a zero-padded power-of-two tile
    grid) against their plain versions, bit for bit: q, the scales of
    every tile and the dequantized values; then ``quantize_wire`` /
    ``dequantize_wire`` on the card against the plain wire path (the CPU
    device), byte for byte."""
    xd, tiles = x.to(dev), bq.wire_tiles(n)
    q, s = bq.wire_views(bq.quantize_ragged(xd, tiles), n, tiles)
    out = bq.dequantize_ragged(q, s)
    torch.cuda.synchronize()
    qr, sr = bq.wire_views(ref.quantize_ragged_ref(xd, tiles), n, tiles)
    outr = ref.dequantize_ragged_ref(qr, sr)
    same_q = torch.equal(q, qr) and torch.equal(_bits(s), _bits(sr))
    same_d = torch.equal(_bits(out), _bits(outr))
    eq = float(max((q.int() - qr.int()).abs().max().item(),
                   (s - sr).abs().max().item()))
    ed = float((out - outr).abs().max().item())
    err["quantize_blocks"] = max(err["quantize_blocks"], eq)
    err["dequantize_blocks"] = max(err["dequantize_blocks"], ed)
    a = x.numpy()
    qw, sw = bq.quantize_wire(a, device=dev)
    qc, sc = bq.quantize_wire(a, device="cpu")
    dw = bq.dequantize_wire(qw, sw, n, (n,), np.float32, device=dev)
    dc = bq.dequantize_wire(qc, sc, n, (n,), np.float32, device="cpu")
    same_w = (qw.tobytes() == qc.tobytes() and sw.tobytes() == sc.tobytes()
              and dw.tobytes() == dc.tobytes())
    emit(phase="ragged_vs_plain", n=n, tiles=tiles,
         quantize_identical=same_q, dequantize_identical=same_d,
         wire_identical=same_w, max_abs_err_q=eq, max_abs_err_dq=ed)
    check(same_q, f"ragged quantize kernel != plain version at n={n}")
    check(same_d, f"ragged dequantize kernel != plain version at n={n}")
    check(same_w, f"q8 wire on the card != the plain wire path at n={n}")


def _da_inputs(B, H, kv, hd, C, seed, dev, dtype=torch.float32,
               valid=None):
    """Seeded decode-attention inputs on ``dev``.  Row b's cache holds
    ``valid[b]`` filled slots (default: all but the last 50, at least
    half) at positions 0.., the rest empty (kpos -1); pos is the last
    filled position."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dev, dtype) for s in ((B, 1, H, hd), (B, C, kv, hd),
                                          (B, C, kv, hd)))
    n = np.full(B, max(C - 50, C // 2)) if valid is None \
        else np.asarray(valid)
    kpos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    kpos[kpos >= n[:, None]] = -1
    pos = np.maximum(n - 1, 0).astype(np.int32)
    return (q, k, v, torch.from_numpy(kpos).to(dev),
            torch.from_numpy(pos).to(dev))


def compare_decode_attention(dev) -> dict:
    """Decode-attention kernel vs its plain version on the card, in f32 and
    bf16, window None and 128: the reference's sweep (through
    ``ops.decode_attention``, whose padding C=640 exercises), the decode
    path's shapes with rows at different fill levels, an all-empty
    cache, which must stay finite, and an all-empty row of a padded C
    (``DA_EMPTY_ROW``; the plain version runs on the unpadded cache).
    Returns the largest error per dtype."""
    err = {"f32": 0.0, "bf16": 0.0}
    cases = [(s, None) for s in DA_SWEEP]
    cases += [(s, [128 + 497 * b for b in range(s[0])]) for s in DA_PATH]
    cases += [(DA_PATH[1], [0] * DA_PATH[1][0])]              # all empty
    cases += [(s, [0, s[4] - 30]) for s in DA_EMPTY_ROW]
    for i, ((B, H, kv, hd, C), valid) in enumerate(cases):
        for dtype, name, tol in ((torch.float32, "f32", DA_F32_ATOL),
                                 (torch.bfloat16, "bf16", DA_BF16_ATOL)):
            q, k, v, kpos, pos = _da_inputs(B, H, kv, hd, C, i, dev, dtype,
                                            valid)
            for window in (None, 128):
                scale = 1.0 / math.sqrt(hd)
                out = ops.decode_attention(q, k, v, kpos, pos, window, scale)
                torch.cuda.synchronize()
                want = ref.decode_attention_ref(q, k, v, kpos, pos, window,
                                                scale)
                e = float((out.float() - want).abs().max().item())
                finite = bool(torch.isfinite(out).all().item())
                err[name] = max(err[name], e)
                emit(phase="decode_attention_vs_plain",
                     shape=[B, H, kv, hd, C], dtype=name, window=window,
                     all_empty=valid is not None and not any(valid),
                     empty_rows=0 if valid is None else valid.count(0),
                     max_abs_err=e, tol=tol, finite=finite)
                check(finite and e <= tol,
                      f"decode attention kernel vs plain at "
                      f"{[B, H, kv, hd, C]} {name} window={window}: "
                      f"err {e} (tol {tol}), finite={finite}")
    return err


def check_da_batch_invariance(dev) -> None:
    """Row 3 of a B=8 call, computed alone, is bit-identical to the same
    row computed stacked (rows at different fill levels), f32 and bf16,
    window None and 128."""
    for i, (B, H, kv, hd, C) in enumerate(DA_INVARIANCE):
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q, k, v, kpos, pos = _da_inputs(
                B, H, kv, hd, C, 80 + i, dev, dtype,
                [C // 8 + (C // 9) * b for b in range(B)])
            for window in (None, 128):
                full = da.decode_attention(q, k, v, kpos, pos, window,
                                           1.0 / math.sqrt(hd))
                one = da.decode_attention(q[3:4], k[3:4], v[3:4], kpos[3:4],
                                          pos[3:4], window,
                                          1.0 / math.sqrt(hd))
                torch.cuda.synchronize()
                same = bool(torch.equal(full[3:4], one))
                emit(phase="decode_attention_batch_invariance",
                     shape=[B, H, kv, hd, C], dtype=name, window=window,
                     form=da.form(H // kv, hd), row=3, bit_identical=same)
                check(same, f"decode attention row 3 alone != stacked at "
                            f"{[B, H, kv, hd, C]} {name} window={window}")


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


def _ragged_bounds(n: int, tiles: int) -> dict:
    """What the ragged kernels really move: quantize reads 4n bytes and
    writes n int8 and a scale for each of the grid's tiles; dequantize
    reads n int8 and the scales of the tiles that hold them and writes
    4n."""
    used = -(-n // 1024)
    out = {}
    for name, b, ops_ in (("quantize_blocks", 4 * n + n + 4 * tiles, 6 * n),
                          ("dequantize_blocks", n + 4 * used + 4 * n, n)):
        t_b, t_o = b / HBM_BYTES_PER_S * 1e3, ops_ / F32_OPS_PER_S * 1e3
        out[name] = {"bytes": b, "bound_ms": max(t_b, t_o),
                     "bound_by": "bytes" if t_b >= t_o else "operations"}
    return out


def time_ragged(dev, sizes) -> dict:
    """The ragged kernels and their plain versions at the wire's leaf
    sizes, on the device (CUDA graph replay) and per call from Python,
    beside the bound on the bytes they move; keyed by (n, kernel)."""
    res = {}
    for n in sizes:
        tiles = bq.wire_tiles(n)
        nbuf = max(2, min(256, -(-(128 << 20) // (4 * n))))
        base = [_data((n,), seed=k).to(dev) for k in range(min(nbuf, 4))]
        xs = [(base[k % len(base)].clone(), tiles) for k in range(nbuf)]
        qs = [bq.wire_views(bq.quantize_ragged(x, t), n, t) for x, t in xs]
        fns = {"quantize_blocks": (bq.quantize_ragged,
                                   ref.quantize_ragged_ref, xs),
               "dequantize_blocks": (bq.dequantize_ragged,
                                     ref.dequantize_ragged_ref, qs)}
        bounds = _ragged_bounds(n, tiles)
        for name, (kernel, plain, args) in fns.items():
            ms = _device_ms(kernel, args)
            rec = dict(n=n, tiles=tiles, kernel=name, ms=ms,
                       plain_ms=_device_ms(plain, args),
                       call_ms=_call_ms(kernel, args),
                       plain_call_ms=_call_ms(plain, args),
                       buffers=nbuf, **bounds[name])
            rec["bandwidth_gb_s"] = bounds[name]["bytes"] / (ms * 1e-3) / 1e9
            emit(phase="kernel_time", **rec)
            res[(n, name)] = rec
        del xs, qs, base
        torch.cuda.empty_cache()
    return res


def time_wire(dev, sizes, iters: int = 50) -> list[dict]:
    """One whole ``quantize_wire`` and ``dequantize_wire`` call per leaf
    from Python, host clock (each call ends in a synchronise): the port's
    (unpadded, its thread's own stream, one copy each way) and the padded
    path it replaced (``tools/q8_wire.py``: host padding to the blob's
    power-of-two tile count, pageable copies on the default stream, two
    copies back), in turns (padded, port, port, padded)."""
    from tools import q8_wire
    paths = {"port": (bq.quantize_wire, bq.dequantize_wire),
             "padded": (q8_wire.quantize_wire_padded,
                        q8_wire.dequantize_wire_padded)}
    out = []
    for n in sizes:
        a = _data((n,), seed=n).numpy()
        q, s = bq.quantize_wire(a, device=dev)
        times: dict[str, list[float]] = {}
        for name in ("padded", "port", "port", "padded"):
            quant, dequant = paths[name]
            for what, fn, args in (
                    ("quantize", quant, (a, dev)),
                    ("dequantize", dequant, (q, s, n, (n,), np.float32,
                                             dev))):
                for _ in range(3):
                    fn(*args)
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn(*args)
                times.setdefault(f"{name}_{what}", []).append(
                    (time.perf_counter() - t0) / iters * 1e3)
        rec = {"n": n, "tiles": bq.wire_tiles(n),
               **{k + "_ms": v for k, v in times.items()}}
        emit(phase="wire_time", **rec)
        out.append(rec)
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


def _da_bounds(B, H, kv, hd, C, itemsize: int = 4) -> dict:
    """Least time for one decode-attention call on a full cache with q/k/v
    of ``itemsize`` bytes: read K, V, kpos, q (and pos) once, write out
    once; 4 f32 flops per (row, slot, element): q.k and p.v."""
    nbytes = itemsize * (2 * B * C * kv * hd + 2 * B * H * hd) \
        + 4 * (B * C + B)
    ops_ = 4 * B * H * C * hd
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops_ / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def time_decode_attention(dev, B, H, kv, hd, C,
                          dtype=torch.float32) -> dict:
    """Kernel, plain version and ``scaled_dot_product_attention`` (the
    library yardstick, never called by the port) on a FULL cache of
    ``dtype`` at a decode path's shape, inputs rotated through more than
    the L2."""
    scale = 1.0 / math.sqrt(hd)
    itemsize = torch.empty((), dtype=dtype).element_size()
    per = itemsize * (2 * B * C * kv * hd)
    nbuf = max(2, -(-(128 << 20) // per))
    sets = [_da_inputs(B, H, kv, hd, C, 100 + i, dev, dtype, valid=[C] * B)
            for i in range(nbuf)]
    kargs = [(q, k, v, kp, p, None, scale) for q, k, v, kp, p in sets]
    # the library's layout: [B, heads, L, hd], mask [B, 1, 1, C]
    largs = [(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
              v.transpose(1, 2).contiguous(), (kp >= 0)[:, None, None, :])
             for q, k, v, kp, _ in sets]

    def library(q, k, v, mask):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)

    lib_out = library(*largs[0]).transpose(1, 2)
    want = ref.decode_attention_ref(*kargs[0])
    lib_err = float((lib_out.float() - want).abs().max().item())
    rec = dict(shape=[B, H, kv, hd, C], kernel="decode_attention",
               dtype="f32" if dtype == torch.float32 else "bf16",
               form=da.form(H // kv, hd),
               ms=_device_ms(da.decode_attention, kargs),
               plain_ms=_device_ms(ref.decode_attention_ref, kargs),
               library_ms=_device_ms(library, largs),
               call_ms=_call_ms(da.decode_attention, kargs),
               plain_call_ms=_call_ms(ref.decode_attention_ref, kargs),
               library_call_ms=_call_ms(library, largs),
               library_max_abs_err=lib_err, buffers=nbuf,
               **_da_bounds(B, H, kv, hd, C, itemsize))
    rec["bandwidth_gb_s"] = rec["bytes"] / (rec["ms"] * 1e-3) / 1e9
    emit(phase="kernel_time", **rec)
    del sets, kargs, largs
    torch.cuda.empty_cache()
    return rec


def _ssd_inputs(shape, seed, dev, dtype=torch.float32, dist="sweep"):
    """Seeded SSD-scan inputs drawn on ``dev``: x, B, C, state ~ N(0, 1);
    dt ~ U(0.001, 0.1) and A ~ -U(0.5, 1.5) for the reference's sweep,
    dt = softplus(N(0, 2)) and A = -1 for the Mamba2 path (a fan-in
    projection of a normalised input, dt_bias 0, A_log 0), or dt = 3 and
    A = -1 for a chunk whose decay overflows the TPU kernel."""
    B, nc, Q, H, P, N = shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def randn(*sh):
        return torch.randn(sh, generator=gen, device=dev)

    x, Bm, Cm, st = randn(B, nc, Q, H, P), randn(B, nc, Q, N), \
        randn(B, nc, Q, N), randn(B, H, P, N)
    if dist == "sweep":
        dt = 0.001 + 0.099 * torch.rand((B, nc, Q, H), generator=gen,
                                        device=dev)
        A = -(0.5 + torch.rand((H,), generator=gen, device=dev))
    elif dist == "path":
        dt = F.softplus(math.sqrt(2.0) * randn(B, nc, Q, H))
        A = -torch.ones(H, device=dev)
    else:
        dt = torch.full((B, nc, Q, H), 3.0, device=dev)
        A = -torch.ones(H, device=dev)
    return (x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype), st)


def _ssd_errors(y, fin, yr, fr, dtype, dist) -> tuple[float, float, bool]:
    """(max |y - y_plain|, max |state - state_plain|, within the bars)."""
    y32, yr32 = y.float(), yr.float()
    ey = (y32 - yr32).abs()
    ef = (fin - fr).abs()
    if dist == "sweep":
        ytol = SSD_BF16_ATOL if dtype == torch.bfloat16 else SSD_F32_ATOL
        ftol = ytol + SSD_STATE_RTOL * fr.abs()
    else:
        ytol = SSD_PATH_REL * max(1.0, float(yr32.abs().max()))
        ftol = SSD_PATH_REL * max(1.0, float(fr.abs().max()))
    if dtype == torch.bfloat16:
        ytol = ytol + BF16_ULP * yr32.abs()
    ok = bool((ey <= ytol).all()) and bool((ef <= ftol).all())
    return float(ey.max()), float(ef.max()), ok


def compare_ssd_scan(dev) -> dict:
    """SSD-scan kernel vs its plain version on the card, f32 and bf16: the
    reference's sweep, the Mamba2 path's shape and a ragged 100-token
    chunk at the path's distribution, a chunk whose decay overflows the
    TPU kernel (must be finite), and state chaining (4 chunks at once ==
    2 + 2).  Returns the largest error per dtype."""
    err = {"f32": 0.0, "bf16": 0.0}
    cases = [(s, "sweep") for s in SSD_SWEEP]
    cases += [(SSD_PATH, "path"), (SSD_RAGGED, "path"),
              ((1, 2, 256, 8, 64, 128), "large")]
    for i, (shape, dist) in enumerate(cases):
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            args = _ssd_inputs(shape, 40 + i, dev, dtype, dist)
            y, fin = ssd.ssd_scan(*args)
            torch.cuda.synchronize()
            yr, fr = ref.ssd_scan_ref(*args)
            finite = bool(torch.isfinite(y).all()) \
                and bool(torch.isfinite(fin).all())
            ey, ef, ok = _ssd_errors(y, fin, yr, fr, dtype, dist)
            err[name] = max(err[name], ey)
            emit(phase="ssd_scan_vs_plain", shape=list(shape), dtype=name,
                 inputs=dist, max_abs_err=ey, max_abs_err_state=ef,
                 y_max_abs=float(yr.float().abs().max()),
                 within_tol=ok, finite=finite,
                 plain_finite=bool(torch.isfinite(yr).all()))
            check(finite and ok, f"ssd_scan kernel vs plain at {shape} "
                                 f"{name} ({dist}): err {ey} / state {ef}, "
                                 f"finite={finite}")
            del args, y, fin, yr, fr
    # state chaining: 4 chunks in one call == two calls of 2 chunks
    x, dt, A, Bm, Cm, st = _ssd_inputs((1, 4, 64, 80, 64, 128), 60, dev,
                                       dist="path")
    y_all, f_all = ssd.ssd_scan(x, dt, A, Bm, Cm, st)
    halves = [[t[:, sl].contiguous() for t in (x, dt, Bm, Cm)]
              for sl in (slice(0, 2), slice(2, 4))]
    y1, f1 = ssd.ssd_scan(halves[0][0], halves[0][1], A, halves[0][2],
                          halves[0][3], st)
    y2, f2 = ssd.ssd_scan(halves[1][0], halves[1][1], A, halves[1][2],
                          halves[1][3], f1)
    torch.cuda.synchronize()
    ey = float((y_all - torch.cat([y1, y2], dim=1)).abs().max())
    ef = float((f_all - f2).abs().max())
    emit(phase="ssd_scan_chaining", max_abs_err=ey, max_abs_err_state=ef,
         identical=bool(ey == 0.0 and ef == 0.0), tol=SSD_F32_ATOL)
    check(ey <= SSD_F32_ATOL and ef <= SSD_F32_ATOL,
          f"ssd_scan state chaining: err {ey} / state {ef}")
    torch.cuda.empty_cache()
    return err


def _ssd_bounds(B, nc, Q, H, P, N) -> dict:
    """Least time for one f32 SSD-scan call: read x, dt, A, B, C and the
    initial state once, write y and the final state once; the work its
    inputs need is the causal half of each chunk's C.B (per batch row and
    chunk, not per head) and of scores @ x (per head), and the state's
    contribution in and update out (2 flops per multiply-add).
    ``repo_ops`` is ``mamba_flops``' intra + inter count, which prices the
    full Q x Q product."""
    T = B * nc * Q
    nbytes = 4 * (2 * T * H * P + 2 * T * N + T * H + H + 2 * B * H * P * N)
    ops_ = T * (Q + 1) * (N + H * P) + 4 * T * H * P * N
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops_ / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops_,
            "repo_ops": 2 * T * Q * (N + H * P) + 4 * T * H * P * N,
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def _ssd_phases_ms(sets, calls: int = 8) -> dict:
    """Device ms per launch of each CUDA kernel that one SSD-scan call
    launches once (``SSD_PHASES``): the mean over the launches that one
    ``torch.profiler`` pass over ``calls`` calls recorded (the tracer may
    drop an event).  These launches are not the path's."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            ssd.ssd_scan(*sets[i % len(sets)])
        torch.cuda.synchronize()
    us, n = {}, {}
    for t, name, count in _kernel_rows(prof):
        for ph in SSD_PHASES:
            if re.search(rf"\b{ph}_kernel\b", name):
                us[ph] = us.get(ph, 0.0) + t
                n[ph] = n.get(ph, 0) + count
    check(set(us) == set(SSD_PHASES),
          f"ssd_scan's kernels in the profile: {sorted(us)}")
    return {ph: us[ph] / 1e3 / n[ph] for ph in SSD_PHASES}


def time_ssd_scan(dev, shape) -> dict:
    """Kernel and plain version at the Mamba2 path's shape (f32, the path's
    input distribution), two input sets of 0.37 GB each (past the L2), and
    each of the kernel's phases from the profiler."""
    sets = [_ssd_inputs(shape, 70 + i, dev, dist="path") for i in range(2)]
    rec = dict(shape=list(shape), kernel="ssd_scan",
               ms=_device_ms(ssd.ssd_scan, sets),
               plain_ms=_device_ms(ref.ssd_scan_ref, sets, reps=3),
               call_ms=_call_ms(ssd.ssd_scan, sets, iters=20),
               plain_call_ms=_call_ms(ref.ssd_scan_ref, sets, iters=6),
               phases_ms=_ssd_phases_ms(sets),
               buffers=len(sets), **_ssd_bounds(*shape))
    rec["tflop_s"] = rec["ops"] / (rec["ms"] * 1e-3) / 1e12
    emit(phase="kernel_time", **rec)
    del sets
    torch.cuda.empty_cache()
    return rec


# -- phase 4: slice A's path -------------------------------------------------------

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


def wire_sizes(graph, spec) -> list[int]:
    """The leaves q8 hands the kernels for one batch-1 request, in
    values: the input, every leaf crossing a cut, and the logits."""
    sizes = [int(np.prod(graph.input_spec.shape))]
    for cut in spec.cuts:
        for name in graph.crossing_names(cut - 1):
            sizes.append(int(np.prod(graph.input_spec.shape if name == ""
                                     else graph[name].out_spec.shape)))
    sizes.append(int(np.prod(graph.nodes[-1].out_spec.shape)))
    return sizes


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
    return {"counts": counts, "sizes": wire_sizes(graph, spec)}


# -- phase 4b: the serving controller over slice A's chain ---------------------------

CTL_SLOW_S = 0.02       # injected per-wave sleep of stage 0 (computes ~1.2 ms)


def _jsonable(obj):
    """A controller record as plain JSON (numpy scalars, tuples)."""
    return json.loads(json.dumps(obj, default=lambda o: (
        o.item() if hasattr(o, "item") else str(o))))


def _serve_window(eng, xs, single, tol, what) -> tuple[float, float]:
    """Submit ``xs`` at once, wait for every result, hold each against
    single-device apply; (requests/s, worst relative error)."""
    t0 = time.perf_counter()
    futs = [eng.submit(x, client_id=i % 2) for i, x in enumerate(xs)]
    outs = [f.result(timeout=300) for f in futs]
    rate = len(xs) / (time.perf_counter() - t0)
    check(all(np.isfinite(o).all() and o.shape == single[0].shape
              for o in outs), f"{what}: outputs not finite/shaped")
    worst = max(_rel(o, r) for o, r in zip(outs, single))
    emit(phase="check", what=what, rel=worst, tol=tol)
    check(worst <= tol, f"{what}: rel {worst} > {tol}")
    return rate, worst


def _stage_rows(rep) -> list[dict]:
    """Per replica: requests and per-request stage seconds this window."""
    return [{k: n[k] for k in ("stage", "replica", "requests",
                               "deserialize_s", "compute_s", "serialize_s",
                               "batch_mean")} for n in rep.per_node]


def controller_phase(device, image: int, classes: int, card: str) -> dict:
    """Slice A's chain under ``InferenceEngine(controller=...)``.

    Raw: stage 0 sleeps ``CTL_SLOW_S`` per wave; after 16 requests one
    explicit ``Controller.step()`` must have calibrated stage 0's layers
    at no less than the sleep's share of a request and migrate layers off
    it (epoch 1), and 8 requests after the swap must equal single-device
    apply within ``RAW_TOL_REL`` (the swap's ``precompile()`` ran on the
    card from the step).  A control engine takes the same step with
    nothing slowed first; its decision is recorded beside the other.  q8: the controller thread runs every 0.5 s while two windows
    of 8 requests are served; no action may be an error, outputs stay
    within ``Q8_REL`` and the block-quant kernels (not their plain
    versions) carry the wire."""
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    graph = cnn.resnet50(batch=1, image=image, num_classes=classes)
    params = fan_in_params(graph, seed=0)
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((1, image, image, 3)).astype(np.float32)
          for _ in range(40)]
    prep = graph.prepare(params, device)
    single = [graph.apply(prep, torch.from_numpy(x).to(device)).cpu().numpy()
              for x in xs]
    del prep
    spec = TopologySpec.chain(graph, 4, strategy="balanced_latency",
                              replicas=[1, 2, 1, 1])
    raw = WireCodec("raw", "none")
    bq.reset_counts()
    cfg = ControllerConfig(interval_s=30.0, ewma_alpha=1.0, hysteresis=0.05,
                           min_requests=8, cooldown_s=0.0,
                           precompile_after_swap=True)

    # 0. the control: the same chain, traffic and step with nothing slowed;
    # whether it repartitions too is recorded, not checked
    eng = InferenceEngine(graph, spec, DispatcherCodecs(data=raw,
                                                        weights=raw),
                          max_batch=4, controller=cfg, device=device)
    try:
        eng.configure(params)
        eng.precompile()
        eng.start()
        for w in range(2):
            _serve_window(eng, xs[8 * w:8 * w + 8], single[8 * w:8 * w + 8],
                          RAW_TOL_REL, f"controller raw control: window {w}")
        control_stages = _stage_rows(eng.report())
        control = eng.controller.step()
    finally:
        eng.shutdown()
    emit(phase="controller_control_step", kind=control.kind,
         detail=_jsonable(control.detail), stages_before=control_stages,
         layer_s=eng.controller.calibrator.layer_s.tolist())

    # 1. deterministic migration off a slowed stage 0 (raw wire)
    eng = InferenceEngine(graph, spec, DispatcherCodecs(data=raw,
                                                        weights=raw),
                          max_batch=4, controller=cfg, device=device)
    try:
        eng.configure(params)
        eng.precompile()
        pre_s = []                       # the swap's precompile() calls
        for group in eng.dispatcher.stages:
            for node in group.replicas:
                def timed(fn=node.precompile):
                    t0 = time.perf_counter()
                    fn()
                    pre_s.append(time.perf_counter() - t0)
                node.precompile = timed
        slow = []
        for node in eng.dispatcher.stages[0].replicas:
            def slowed(b, fn=node._apply):
                time.sleep(CTL_SLOW_S)
                return fn(b)
            node._apply = slowed
            slow.append(slowed)
        eng.start()                      # the thread idles (30 s period)
        old = [list(r) for r in eng.dispatcher.partition.ranges()]
        # 16 requests in two windows of 8: the first pays the engine's
        # first traffic, the second is the slowed chain warm
        rate_first, _ = _serve_window(eng, xs[:8], single[:8], RAW_TOL_REL,
                                      "controller raw: first window")
        rate_before, _ = _serve_window(eng, xs[8:16], single[8:16],
                                       RAW_TOL_REL, "controller raw: before")
        stages = _stage_rows(eng.report())
        t0 = time.perf_counter()
        action = eng.controller.step()
        step_s = time.perf_counter() - t0
        d = action.detail
        cal = eng.controller.calibrator
        # the mechanism: the calibration holds stage 0's measured compute,
        # so its layers' seconds cover the sleep's share of each request
        lo, hi = old[0]
        stage0_s = float(cal.layer_s[lo:hi].sum())
        sleep_share_s = CTL_SLOW_S / max(r["batch_mean"] for r in stages
                                         if r["stage"] == 0 and r["requests"])
        emit(phase="controller_step", kind=action.kind,
             detail=_jsonable(d), stages_before=stages,
             encode_s_per_byte=cal.encode_s_per_byte,
             decode_s_per_byte=cal.decode_s_per_byte,
             stage0_layer_s=stage0_s, sleep_share_s=sleep_share_s,
             layer_s=cal.layer_s.tolist())
        check(stage0_s >= sleep_share_s,
              f"calibrated stage 0 {stage0_s} s a request is below the "
              f"sleep's share {sleep_share_s} s")
        check(action.kind == "repartition",
              f"controller step gave {action.kind!r}, not a repartition")
        check(d["acknowledged"], "the migration's fence was not acknowledged")
        new = [list(r) for r in eng.dispatcher.partition.ranges()]
        check(new[0][1] < old[0][1], f"stage 0 did not shrink: {old} -> {new}")
        check(eng.dispatcher.epoch == 1 and eng.controller.migrations == 1,
              f"epoch {eng.dispatcher.epoch}, migrations "
              f"{eng.controller.migrations}")
        check(not any(n._apply in slow
                      for n in eng.dispatcher.stages[0].replicas),
              "stage 0 kept its slowed apply after the swap")
        eng.reset_window()
        rate_after, worst = _serve_window(eng, xs[16:24], single[16:24],
                                          RAW_TOL_REL,
                                          "controller raw: after the swap")
        stages_after = _stage_rows(eng.report())
    finally:
        eng.shutdown()
    emit(phase="controller_migration", card=card, ranges_before=old,
         ranges_after=new, cuts_after=list(d["cuts"]),
         predicted_gain=float(d["predicted_gain"]),
         moved_layers=d["moved_layers"], shipped_bytes=d["shipped_bytes"],
         requests_per_s_first=rate_first,
         requests_per_s_before=rate_before, requests_per_s_after=rate_after,
         migrate_s=d["migrate_s"], precompile_s=sum(pre_s),
         precompile_calls=len(pre_s), step_s=step_s, rel_after=worst,
         stages_after=stages_after, control_kind=control.kind,
         control_cuts=(list(control.detail["cuts"])
                       if control.kind == "repartition" else None))

    # 2. the live loop on the q8 wire: the thread decides, nothing injected
    q8 = WireCodec("q8", "none")
    cfg = ControllerConfig(interval_s=0.5, min_requests=8, cooldown_s=2.0)
    eng = InferenceEngine(graph, spec, DispatcherCodecs(data=q8, weights=raw),
                          max_batch=4, controller=cfg, device=device)
    rates = []
    try:
        eng.configure(params)
        eng.precompile()
        warm = dict(bq.launches)
        eng.start()
        for w in range(2):
            seen = len(eng.controller.actions)
            rate, _ = _serve_window(eng, xs[24 + 8 * w:32 + 8 * w],
                                    single[24 + 8 * w:32 + 8 * w], Q8_REL,
                                    f"controller q8: window {w}")
            rates.append(rate)
            deadline = time.perf_counter() + 30
            while (len(eng.controller.actions) == seen
                   and time.perf_counter() < deadline):
                time.sleep(0.05)         # one control period after it
            check(len(eng.controller.actions) > seen,
                  "the controller thread took no step in 30 s")
    finally:
        eng.shutdown()
    acts = [{"kind": a.kind, "detail": _jsonable(a.detail)}
            for a in eng.controller.actions]
    emit(phase="controller_live", card=card, requests_per_s=rates,
         epoch=eng.dispatcher.epoch, migrations=eng.controller.migrations,
         actions=acts)
    check(all(a["kind"] != "error" for a in acts),
          f"the controller recorded an error: {acts}")
    counts, plain = dict(bq.launches), dict(bq.plain_calls)
    emit(phase="controller_launches", launches=counts, plain_calls=plain,
         launches_after_precompile=warm,
         phase_s=time.perf_counter() - t_phase)
    if device.type == "cuda":
        check(all(counts[k] > warm[k] for k in counts),
              f"block quant did not launch while the q8 loop served: "
              f"{warm} -> {counts}")
    return {"counts": counts, "plain": plain}


# -- phase 4c: slice A's chain, every replica a worker process ----------------------

PROCS_REQ = 32          # closed-loop requests of the kill drill
PROCS_CLIENTS = 4


def _live_children() -> set[int]:
    """Pids of this process's live (non-zombie) children, from /proc."""
    me, pids = os.getpid(), set()
    for ent in os.listdir("/proc"):
        if not ent.isdigit():
            continue
        try:
            with open(f"/proc/{ent}/stat") as f:
                fields = f.read().rsplit(")", 1)[-1].split()
        except OSError:
            continue                # raced a pid that just exited
        if int(fields[1]) == me and fields[0] != "Z":
            pids.add(int(ent))
    return pids


def _bare_context_mib(device) -> float:
    """Device memory one more process takes for a CUDA context and
    nothing else (torch imported, one 4-byte tensor on the card): the
    card's used memory while it lives, less before it started."""
    free0 = torch.cuda.mem_get_info(device)[0]
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, torch; "
         "t = torch.zeros(1, device='cuda'); torch.cuda.synchronize(); "
         "print('up', flush=True); sys.stdin.read()"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        check(proc.stdout.readline().strip() == "up",
              "the bare-context process did not start")
        used = (free0 - torch.cuda.mem_get_info(device)[0]) / 2**20
    finally:
        proc.stdin.close()
        proc.wait(timeout=60)
    return used


def _procs_window(eng, xs, single, tol, what) -> dict:
    """One window on a process-backed engine: requests/s, p50 / p99 of
    admission to result, worst error against single-device apply."""
    eng.reset_window()
    rate, worst = _serve_window(eng, xs, single, tol, what)
    rep = eng.report()
    return {"requests_per_s": rate, "p50_latency_s": rep.p50_latency_s,
            "p99_latency_s": rep.p99_latency_s, "rel": worst}


def _closed_loop(eng, xs, single, tol, n, clients, on_ramp) -> dict:
    """``clients`` threads each keep one request in flight until ``n``
    requests are done; ``on_ramp`` runs once a quarter of them is.  Every
    output is held against single-device apply; any failure is kept."""
    lock = threading.Lock()
    state = {"next": 0, "done": 0, "worst": 0.0, "errors": []}
    ramp = threading.Event()

    def client(c):
        while True:
            with lock:
                i = state["next"]
                if i >= n:
                    return
                state["next"] += 1
            try:
                out = eng.submit(xs[i % len(xs)],
                                 client_id=f"c{c}").result(timeout=300)
            except Exception as e:  # noqa: BLE001 - every failure is recorded and fails the phase
                with lock:
                    state["errors"].append(f"{type(e).__name__}: {e}")
                continue
            rel = _rel(out, single[i % len(xs)])
            with lock:
                state["worst"] = max(state["worst"], rel)
                state["done"] += 1
                if state["done"] >= n // 4:
                    ramp.set()

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    eng.reset_window()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    check(ramp.wait(300), "the closed-loop load never ramped")
    rec = on_ramp()
    for t in threads:
        t.join(600)
    check(not any(t.is_alive() for t in threads),
          "a closed-loop client hung")
    wall = time.perf_counter() - t0
    rep = eng.report()
    rec.update(requests=state["done"], errors=state["errors"],
               rel=state["worst"], wall_s=wall,
               requests_per_s=state["done"] / wall,
               p50_latency_s=rep.p50_latency_s,
               p99_latency_s=rep.p99_latency_s)
    check(not state["errors"],
          f"client-visible failures in the kill drill: {state['errors']}")
    check(state["done"] == n, f"{state['done']} of {n} requests done")
    emit(phase="check", what="procs kill drill vs single-device",
         rel=state["worst"], tol=tol)
    check(state["worst"] <= tol, f"procs kill drill rel {state['worst']}")
    return rec


def _check_workers(sup, device, what, kernels: bool) -> list[dict]:
    """Every live worker reports the engine's device; with ``kernels``
    (q8 on a card) each launched both block-quant kernels and never ran
    their plain versions."""
    rows = []
    for h in sup._handles:
        if h.dead:
            continue
        rows.append({"stage": h.index, "replica": h.replica,
                     "pid": h.proc.pid, "device": h.worker_device,
                     "launches": h.launches, "plain_calls": h.plain_calls,
                     "ready_s": h.ready_at - h.spawned_at})
        check(h.worker_device == str(device),
              f"{what}: worker {h.index}.{h.replica} reports "
              f"{h.worker_device}, not {device}")
        if kernels:
            check(all(h.launches.get(k, 0) > 0 for k in bq.launches)
                  and not any(h.plain_calls.values()),
                  f"{what}: worker {h.index}.{h.replica} launches "
                  f"{h.launches}, plain calls {h.plain_calls}")
    return rows


def _drain_clean(sup, what, killed=()) -> list:
    """After ``eng.shutdown(); sup.close()``: every worker but the
    ``killed`` pids said bye and exited 0, and no child process is
    left."""
    codes = [(h.index, h.replica, h.proc.returncode, h.bye)
             for h in sup._handles]
    for h in sup._handles:
        if h.proc.pid not in killed:
            check(h.bye and h.proc.returncode == 0,
                  f"{what}: worker {h.index}.{h.replica} exited "
                  f"rc={h.proc.returncode}, bye={h.bye}")
    left = _live_children()
    check(not left, f"{what}: child processes left: {sorted(left)}")
    return codes


def procs_phase(device, image: int, classes: int, card: str) -> dict:
    """Slice A's chain with every replica a supervised worker process.

    Built through ``supervised_engine`` with the graph factory
    ``repro_torch.models.cnn:resnet50``: 5 workers for the 4-stage
    ``balanced_latency`` chain ``[1, 2, 1, 1]``, each with its own CUDA
    context on ``device``, the parent's TF32 choice (off) and its own q8
    codec.  Two windows of 8 requests raw, then two of 8 through q8, each
    against single-device apply; every worker must report ``device``, and
    under q8 each must have launched both block-quant kernels and never
    their plain versions.  Then the kill drill on the q8 engine (a
    ``RetryPolicy`` installed): 4 closed-loop clients for 32 requests,
    one stage-1 replica SIGKILLed once 8 are done; no client may see a
    failure, every output stays within ``Q8_REL``, the supervisor records
    the death and a respawn and stage 1 is back to 2 replicas, whose
    newcomer then serves a window.  Every surviving worker must say bye
    and exit 0, and no child process may be left."""
    from repro_torch.runtime import (RetryPolicy, SupervisorConfig,
                                     supervised_engine)
    from tools.torch_chaos import Chaos
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    graph = cnn.resnet50(batch=1, image=image, num_classes=classes)
    params = fan_in_params(graph, seed=0)
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((1, image, image, 3)).astype(np.float32)
          for _ in range(16)]
    prep = graph.prepare(params, device)
    single = [graph.apply(prep, torch.from_numpy(x).to(device)).cpu().numpy()
              for x in xs]
    del prep
    spec = TopologySpec.chain(graph, 4, strategy="balanced_latency",
                              replicas=[1, 2, 1, 1])
    raw, q8 = WireCodec("raw", "none"), WireCodec("q8", "none")
    cfg = SupervisorConfig(
        "repro_torch.models.cnn:resnet50",
        graph_args={"batch": 1, "image": image, "num_classes": classes},
        heartbeat_s=0.2, spawn_timeout_s=300.0, backoff_initial_s=0.2,
        backoff_max_s=1.0)
    kernels = device.type == "cuda"
    out: dict = {"card": card, "cuts": list(spec.cuts)}

    # 1. raw: two windows of 8
    if kernels:
        out["bare_context_mib"] = _bare_context_mib(device)
    children0 = _live_children()
    free0 = torch.cuda.mem_get_info(device)[0] if kernels else None
    t0 = time.perf_counter()
    eng, sup = supervised_engine(graph, params, spec, cfg,
                                 codecs=DispatcherCodecs(data=raw,
                                                         weights=raw),
                                 max_batch=4, device=device)
    try:
        eng.precompile()
        eng.start()
        out["raw_start_s"] = time.perf_counter() - t0
        pids = {h.proc.pid for h in sup._handles}
        check(len(pids) == 5 and pids <= _live_children() - children0,
              f"want 5 worker processes, have {len(pids)}")
        if kernels:     # the card's used memory, less before the spawn
            out["workers_mib"] = \
                (free0 - torch.cuda.mem_get_info(device)[0]) / 2**20
        out["raw"] = [_procs_window(eng, xs[8 * w:8 * w + 8],
                                    single[8 * w:8 * w + 8], RAW_TOL_REL,
                                    f"procs raw: window {w}")
                      for w in range(2)]
        out["raw_workers"] = _check_workers(sup, device, "procs raw", False)
    finally:
        eng.shutdown()
        sup.close()
    out["raw_exits"] = _drain_clean(sup, "procs raw")
    out["raw_events"] = [e for e in sup.events if e["kind"] != "spawn"]

    # 2. q8: two windows of 8, then the kill drill, then a healed window
    bq.reset_counts()
    policy = RetryPolicy(max_attempts=5, backoff_s=0.05, retry_budget=64.0,
                         refill_per_s=32.0)
    t0 = time.perf_counter()
    eng, sup = supervised_engine(graph, params, spec, cfg,
                                 codecs=DispatcherCodecs(data=q8,
                                                         weights=raw),
                                 max_batch=4, device=device,
                                 retry_policy=policy)
    chaos = Chaos(sup)
    try:
        eng.precompile()
        eng.start()
        out["q8_start_s"] = time.perf_counter() - t0
        warm = {h.proc.pid: dict(h.launches) for h in sup._handles}
        out["q8"] = [_procs_window(eng, xs[8 * w:8 * w + 8],
                                   single[8 * w:8 * w + 8], Q8_REL,
                                   f"procs q8: window {w}")
                     for w in range(2)]
        time.sleep(3 * cfg.heartbeat_s)      # the windows' counts arrive
        out["q8_workers"] = _check_workers(sup, device, "procs q8", kernels)
        if kernels:
            for h in sup._handles:
                check(any(h.launches[k] > warm[h.proc.pid].get(k, 0)
                          for k in h.launches),
                      f"worker {h.index}.{h.replica}: block quant did not "
                      "launch while the windows served")

        def kill() -> dict:
            victim = chaos.pick(stage=1)
            pid = chaos.kill(victim)
            t_kill = time.monotonic()
            chaos.wait_death(stage=1, timeout=60)
            return {"killed": [victim.index, victim.replica, pid],
                    "t_kill": t_kill}

        drill = _closed_loop(eng, xs, single, Q8_REL, PROCS_REQ,
                             PROCS_CLIENTS, kill)
        chaos.wait_respawn(stage=1, timeout=300)
        check(chaos.wait_stage_full(eng.dispatcher, 1, timeout=300) == 2,
              "stage 1 is not back to 2 replicas")
        new = [h for h in sup._handles if h.index == 1 and not h.dead
               and h.spawned_at > drill["t_kill"]]
        check(len(new) == 1, f"want one respawned stage-1 worker: {new}")
        h = new[0]
        drill["respawn_ready_s"] = h.ready_at - h.spawned_at
        drill["kill_to_ready_s"] = h.ready_at - drill.pop("t_kill")
        drill["replay"] = dataclasses.asdict(eng.dispatcher.replay_stats)
        drill["events"] = [e for e in sup.events
                           if e["kind"] not in ("spawn",)]
        out["drill"] = drill
        out["healed"] = _procs_window(eng, xs[:8], single[:8], Q8_REL,
                                      "procs q8: healed window")
        time.sleep(3 * cfg.heartbeat_s)
        out["healed_workers"] = _check_workers(sup, device,
                                               "procs q8 healed", kernels)
        out["respawned_served"] = h.snapshot()["n"]
        check(out["respawned_served"] > 0,
              "the respawned worker served nothing in the healed window")
    finally:
        eng.shutdown()
        sup.close()
    out["q8_exits"] = _drain_clean(sup, "procs q8",
                                   killed=[out["drill"]["killed"][2]])
    out["q8_events"] = [e for e in sup.events if e["kind"] != "spawn"]
    # the phase's block-quant launches: the parent's (the dispatcher's
    # input encode, the collector's output decode) and every worker's last
    # report (the killed one's up to its last heartbeat)
    counts = {k: bq.launches[k] + sum(h.launches.get(k, 0)
                                       for h in sup._handles)
              for k in bq.launches}
    plain = {k: bq.plain_calls[k] + sum(h.plain_calls.get(k, 0)
                                        for h in sup._handles)
             for k in bq.plain_calls}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(phase="procs", **_jsonable(out))
    emit(phase="procs_launches", launches=counts, plain_calls=plain,
         phase_s=out["phase_s"])
    raw_deaths = [e for e in out["raw_events"] if e["kind"] == "death"]
    check(not raw_deaths, f"procs raw: deaths {raw_deaths}")
    kinds = [e["kind"] for e in out["q8_events"]]
    check(kinds.count("death") == 1 and kinds.count("respawn") >= 1,
          f"procs q8: want the one death and a respawn: {out['q8_events']}")
    return {"counts": counts, "plain": plain}


# -- phase 5: slice C's path, decode serving ---------------------------------------

def lm_params(graph, seed: int, device) -> dict:
    """Seeded weights in the reference's names, drawn on ``device`` and
    handed over as host numpy (what ``configure`` ships): ``w ~ N(0,
    1/fan_in)``, norm scales 1, the embedding table ``~ N(0, 1)``, so the
    logits are far from degenerate."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = {}
    for node in graph.nodes:
        p: dict = {}
        for path, spec in tree_flatten_with_path(node.param_spec):
            if path[-1] == "scale":
                a = np.ones(spec.shape, np.float32)
            else:
                t = torch.randn(spec.shape, generator=gen, device=device)
                if path[-1] == "w":
                    t *= 1.0 / math.sqrt(spec.shape[0])
                a = t.cpu().numpy()
            d = p
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = a
        params[node.name] = p
    return params


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _prefill(graph, prep, prompt, dev):
    with torch.inference_mode():
        acts = torch.tensor([prompt], dtype=torch.int32, device=dev)
        caches = {}
        for node in graph.nodes:
            if node.decode is not None:
                acts, caches[node.name] = node.decode.prefill_fn(
                    prep[node.name], acts)
            else:
                acts = node.fn(prep[node.name], acts)
    return acts, caches


def _step(graph, prep, caches: list, toks: list, pos: list, dev):
    """One step of the whole graph over the sessions' stacked caches (the
    stack is a copy: ``caches`` are left as they were)."""
    with torch.inference_mode():
        c = {n: {k: torch.cat([cc[n][k] for cc in caches]) for k in
                 caches[0][n]} for n in caches[0]}
        acts = torch.tensor([[t] for t in toks], dtype=torch.int32,
                            device=dev)
        pv = torch.tensor(pos, dtype=torch.int32, device=dev)
        for node in graph.nodes:
            if node.decode is not None:
                acts, c[node.name] = node.decode.step_fn(
                    prep[node.name], c[node.name], acts, pv)
            else:
                acts = node.fn(prep[node.name], acts)
    return acts


def check_batch_invariance(graph, prep, prompts, dev) -> list[float]:
    """One session's step alone (padded to ``decode_step_rows`` rows by
    repeating it) against the same session as a row of a step of other
    sessions: must be bit-identical (the chain batches steps across
    sessions, the reference steps alone).  Also reports whether an
    UNPADDED batch-1 step would have been.  Returns each prompt's prefill
    time on the device (ms)."""
    rows = graph.decode_step_rows
    pre, prefill_ms = [], []
    for p in prompts[:rows]:
        _sync(dev)
        t0 = time.perf_counter()
        pre.append(_prefill(graph, prep, p, dev))
        _sync(dev)
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    first = [int(np.argmax(a[0, -1].cpu().numpy())) for a, _ in pre]
    caches = [c for _, c in pre]
    pos = [len(p) for p in prompts[:rows]]
    del pre
    i = min(3, rows - 1)
    full = _step(graph, prep, caches, first, pos, dev)
    alone = _step(graph, prep, [caches[i]] * rows, [first[i]] * rows,
                  [pos[i]] * rows, dev)
    single = _step(graph, prep, [caches[i]], [first[i]], [pos[i]], dev)
    fixed = bool(torch.equal(full[i], alone[0]))
    unpadded = bool(torch.equal(full[i], single[0]))
    emit(phase="batch_invariance", rows=rows, fixed_rows_identical=fixed,
         unpadded_batch1_identical=unpadded,
         unpadded_max_abs_diff=float((full[i] - single[0]).abs().max()))
    check(fixed, "a session's step differs between its own padded step "
                 "and a step shared with other sessions")
    return prefill_ms


def _generate_all(eng, prompts, new_tokens, rescale) -> tuple[list, dict]:
    """Run one generate() per prompt on its own thread; with ``rescale``,
    drain and regrow stage 1 once every session has 2 tokens."""
    n = len(prompts)
    toks: list[list[int]] = [[] for _ in prompts]
    stamps: list[list[float]] = [[] for _ in prompts]
    starts = [0.0] * n
    errs: list[BaseException] = []

    def one(i):
        starts[i] = time.perf_counter()
        try:
            for t in eng.generate(prompts[i], new_tokens, restart="always"):
                stamps[i].append(time.perf_counter())
                toks[i].append(t)
        except BaseException as e:      # noqa: BLE001 - re-raised below
            errs.append(e)

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    scale_s = None
    if rescale:
        deadline = time.monotonic() + 600
        while not all(len(s) >= 2 for s in stamps) and not errs:
            check(time.monotonic() < deadline, "sessions never reached 2 "
                  f"tokens: {[len(s) for s in stamps]}")
            time.sleep(0.005)
        t0 = time.perf_counter()
        eng.scale(1, 1)                  # drain: displaces pinned sessions
        eng.scale(1, 2)                  # regrow: ships stage 1's weights
        scale_s = time.perf_counter() - t0
    for t in threads:
        t.join(900)
    check(not any(t.is_alive() for t in threads), "generation hung")
    if errs:
        raise errs[0]
    steps = [b - a for s in stamps for a, b in zip(s, s[1:])]
    wall = max(s[-1] for s in stamps) - min(starts)
    total = sum(len(t) for t in toks)
    return toks, {
        "tokens": total, "wall_s": wall, "tokens_per_s": total / wall,
        "step_p50_ms": float(np.percentile(steps, 50) * 1e3),
        "step_p99_ms": float(np.percentile(steps, 99) * 1e3),
        "first_token_ms": [(s[0] - t0) * 1e3 for s, t0 in zip(stamps, starts)],
        "live_scale_s": scale_s}


def _kernel_rows(prof) -> list[tuple[float, str, int]]:
    """(device us, name, count) of every kernel in a ``torch.profiler``
    trace, largest first.  Only the device's own events: an operator's
    row (``aten::mm``) also carries the device time of the kernels it
    launched, and counting both would count that time twice."""
    rows = []
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0.0)
        if dt > 0:
            rows.append((dt, ev.key, ev.count))
    rows.sort(reverse=True)
    return rows


def profile_window(eng, prompts, want, new_tokens, dev) -> None:
    """A short third window under ``torch.profiler``: the device's busy
    share (kernel time summed over the one stream / wall) and the kernels
    that take it.  Launches here are not counted for the path."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs, rec = _generate_all(eng, prompts, new_tokens, rescale=False)
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    check(all(o == w[:new_tokens] for o, w in zip(outs, want)),
          "profiled window: tokens differ from the reference")
    rows = _kernel_rows(prof)
    busy = sum(r[0] for r in rows)
    emit(phase="decode_profile", tokens=rec["tokens"],
         tokens_per_s=rec["tokens_per_s"], wall_s=wall_us / 1e6,
         device_busy_s=busy / 1e6,
         device_busy_share=busy / wall_us if rows else None,
         device_kernels=sum(r[2] for r in rows),
         top=[{"name": k[:80], "device_ms": dt / 1e3, "count": c}
              for dt, k, c in rows[:10]])


def decode_phase(dev, cfg: dict, prompt_len: tuple[int, int],
                 new_tokens: int, card: str) -> dict:
    """Slice C's path: decode serving through the 4-stage chain, held bit
    for bit against the single-device reference on the same device."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    graph = lm_graph.decode_lm_graph(use_kernel=True, **cfg)
    n_params = sum(int(np.prod(spec.shape)) for node in graph.nodes
                   for _, spec in tree_flatten_with_path(node.param_spec))
    emit(phase="decode_setup", config=cfg, parameters=n_params,
         weight_bytes=graph.total_param_bytes, sessions=SESSIONS,
         new_tokens=new_tokens, prompt_len=list(prompt_len),
         step_rows=graph.decode_step_rows, tf32="off (cudnn and matmul)")
    t0 = time.perf_counter()
    params = lm_params(graph, seed=0, device=dev)
    weights_s = time.perf_counter() - t0
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg["vocab"], int(rng.integers(*prompt_len)))
               .tolist() for _ in range(SESSIONS)]

    # the single-device reference on the same device, then freed
    t0 = time.perf_counter()
    prep = graph.prepare(params, dev)
    prefill_ms = check_batch_invariance(graph, prep, prompts, dev)
    margins: list[float] = []
    t1 = time.perf_counter()
    want = [lm_graph.pipeline_decode_reference(graph, prep, p, new_tokens,
                                               margins) for p in prompts]
    ref_s = time.perf_counter() - t1
    # one single-session step of all layers at the fixed rows, host clock:
    # a whole decode of prompt 0 less its prefill-only decode, per step
    t2 = time.perf_counter()
    lm_graph.pipeline_decode_reference(graph, prep, prompts[0], 1)
    t3 = time.perf_counter()
    lm_graph.pipeline_decode_reference(graph, prep, prompts[0], new_tokens)
    t4 = time.perf_counter()
    emit(phase="decode_reference", weights_s=weights_s,
         prepare_and_invariance_s=t1 - t0, reference_s=ref_s,
         step_ms=((t4 - t3) - (t3 - t2)) / (new_tokens - 1) * 1e3,
         prefill_ms=prefill_ms, prompt_lens=[len(p) for p in prompts],
         min_top2_margin=min(margins), streams_distinct=len(
             {tuple(t) for t in want}))
    check(len({tuple(t) for t in want}) == len(prompts),
          "different prompts gave identical token streams")
    del prep
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    raw = WireCodec("raw", "none")
    spec = TopologySpec.chain(graph, 4, replicas=[1, 2, 1, 1])
    d, vocab = cfg["d_model"], cfg["vocab"]
    hop_bytes = len(raw.encode_tree(
        {graph.nodes[spec.stages[0].layers[1] - 1].name:
         np.zeros((1, 1, d), np.float32)}, "data")[0])
    tail_bytes = len(raw.encode_tree(
        {"head": np.zeros((1, 1, vocab), np.float32)}, "data")[0])
    eng = InferenceEngine(graph, spec, DispatcherCodecs(data=raw, weights=raw),
                          max_batch=SESSIONS, device=dev)
    try:
        t0 = time.perf_counter()
        eng.configure(params)
        configure_s = time.perf_counter() - t0
        del params
        eng.start()
        da.reset_counts()
        for window in ("first", "warm"):
            eng.reset_window()
            outs, rec = _generate_all(eng, prompts, new_tokens,
                                      rescale=window == "first")
            rep = eng.report(samples=rec["tokens"], wall_s=rec["wall_s"])
            same = [o == w for o, w in zip(outs, want)]
            emit(phase="decode_serve", window=window, card=card,
                 configure_s=configure_s, step_bytes_per_hop=hop_bytes,
                 tail_bytes_per_step=tail_bytes,
                 replicas=list(rep.replicas), cuts=list(rep.cuts),
                 sessions_bit_identical=same, **rec)
            # per replica: per-request seconds by stage, and one wave's
            # compute (requests per wave x compute per request)
            emit(phase="decode_stages", window=window, stages=[
                dict({k: n[k] for k in ("stage", "replica", "requests",
                                        "deserialize_s", "compute_s",
                                        "serialize_s", "util_compute",
                                        "batch_mean")},
                     wave_compute_ms=n["compute_s"] * n["batch_mean"] * 1e3)
                for n in rep.per_node])
            check(all(same), f"{window} window: chain tokens differ from "
                             f"the single-device reference: {same}")
        counts, plain = dict(da.launches), dict(da.plain_calls)
        if dev.type == "cuda":
            profile_window(eng, prompts, want, max(4, new_tokens // 4), dev)
    finally:
        eng.shutdown()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    emit(phase="decode_launches", launches=counts, plain_calls=plain,
         peak_device_bytes=peak)
    return {"counts": counts, "plain": plain}


# -- phase 6: slice D's path, Mamba2 prefill and greedy decode ---------------------

def mamba2_params(cfg, seed: int, dev) -> dict:
    """Seeded fan-in weights in the reference's tree, drawn on ``dev`` with
    an explicit generator: He-init ``w ~ N(0, 2/fan_in)`` (in_proj, the
    depthwise conv over its width, out_proj), norm scales 1, conv bias 0,
    A_log 0, D 1, dt_bias 0, the embedding ``N(0, 0.02)`` with zero
    pad-vocab rows, as ``init_lm`` builds it."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    spec = transformer.mamba_spec(cfg)
    n, d, di, H = cfg.num_layers, cfg.d_model, spec.d_inner, spec.n_heads
    ch, w = spec.conv_channels, cfg.ssm.conv_width

    def he(shape, fan_in):
        return torch.randn(shape, generator=gen, device=dev).mul_(
            math.sqrt(2.0 / fan_in))

    def full(shape, v):
        return torch.full(shape, float(v), device=dev)

    table = torch.zeros((cfg.padded_vocab, d), device=dev)
    table[:cfg.vocab] = torch.randn((cfg.vocab, d), generator=gen,
                                    device=dev).mul_(0.02)
    mamba = {"ln": {"scale": full((n, d), 1)},
             "in_proj": he((n, d, 2 * di + 2 * cfg.ssm.state_dim + H), d),
             "conv_w": he((n, w, ch), w), "conv_b": full((n, ch), 0),
             "A_log": full((n, H), 0), "D": full((n, H), 1),
             "dt_bias": full((n, H), 0), "norm": {"scale": full((n, di), 1)},
             "out_proj": he((n, di, d), di)}
    return {"embed": {"table": table}, "units": {"pos0": {"mamba": mamba}},
            "final_ln": {"scale": full((d,), 1)}}


def _rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _profile(fn, dev) -> dict:
    """``fn()`` under ``torch.profiler``: the device's kernels, their count
    and the card's busy share of the wall time (timed inside the profiled
    region: the profiler's start and its processing at the end are not
    the program's time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _kernel_rows(prof)
    busy = sum(r[0] for r in rows)
    return {"wall_s": wall_us / 1e6, "device_busy_s": busy / 1e6,
            "device_busy_share": busy / wall_us if rows else None,
            "device_kernels": sum(r[2] for r in rows),
            "top": [{"name": k[:80], "device_ms": t / 1e3, "count": c}
                    for t, k, c in rows[:8]]}


def check_against_forward(params, cfg, tokens, gen: list, step_logits: list,
                          margin_tol: float, dev, phase: str,
                          peak: dict) -> float:
    """Greedy decode against the plain ``forward`` over the extended
    sequences: every token (``gen``: the prefill's, then each step's) must
    equal the forward's argmax wherever its top-1/top-2 margin is at least
    ``margin_tol``, and the decode logits lie within half of it of the
    forward's; every logit finite, the streams distinct.  Records the
    peak device memory under ``peak["forward"]``; returns the forward's
    seconds."""
    prompt = tokens.shape[1]
    ext = torch.cat([tokens] + gen[:-1], dim=1)           # prompt + steps
    t0 = time.perf_counter()
    full, _ = transformer.forward(params, cfg, ext, use_kernel=False)
    fwd = full[:, prompt - 1:].clone()                     # [B, steps+1, V]
    del full                                # a large vocab's logits: free
    _sync(dev)
    forward_s = time.perf_counter() - t0
    if dev.type == "cuda":
        peak["forward"] = torch.cuda.max_memory_allocated(dev)
    got = torch.cat(gen, dim=1)                            # [B, steps+1]
    top2 = fwd.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    differ = got != fwd.argmax(-1)
    exempt = margin < margin_tol
    dec_logits = torch.cat(step_logits, dim=1)
    e_dec = float((dec_logits - fwd[:, 1:]).abs().max())
    finite = all(bool(torch.isfinite(t).all()) for t in (fwd, dec_logits))
    distinct = len({tuple(r) for r in got.tolist()})
    emit(phase=phase, tokens=int(got.numel()),
         tokens_differing=int(differ.sum()),
         differing_above_margin=int((differ & ~exempt).sum()),
         positions_below_margin=int(exempt.sum()),
         min_margin=float(margin.min()), margin_tol=margin_tol,
         decode_logits_max_abs_err=e_dec, all_logits_finite=finite,
         streams_distinct=distinct)
    check(not bool((differ & ~exempt).any()),
          "greedy tokens differ from the plain forward's argmax above "
          "the margin")
    check(e_dec <= margin_tol / 2, f"decode logits vs forward: {e_dec}")
    check(finite, "decode or forward logits not finite")
    check(distinct == got.shape[0], "different prompts gave identical "
                                    "token streams")
    return forward_s


def mamba2_phase(dev, cfg, batch: int, prompt: int, steps: int,
                 card: str) -> dict:
    """Slice D's path: ``prefill(use_kernel=True)`` of ``batch`` seeded
    prompts, then ``steps`` greedy ``decode_step``s, held against the plain
    prefill and the plain forward over the extended sequences on the same
    device.  Returns the SSD kernel's launch and plain-call counts over the
    kernel prefills."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    params = mamba2_params(cfg, seed=0, dev=dev)
    n_params = transformer.param_count(params)
    small = transformer.init_lm(cfg_base.reduced(cfg), 0, device=dev)
    same_tree = [p for p, _ in tree_flatten_with_path(params)] == \
        [p for p, _ in tree_flatten_with_path(small)]
    del small
    emit(phase="mamba2_setup", config=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, d_inner=transformer.mamba_spec(cfg).d_inner,
         heads=transformer.mamba_spec(cfg).n_heads,
         state_dim=cfg.ssm.state_dim, chunk=cfg.ssm.chunk,
         vocab=cfg.vocab, padded_vocab=cfg.padded_vocab,
         parameters=n_params, weight_bytes=4 * n_params, batch=batch,
         prompt_len=prompt, decode_steps=steps, reference_tree=same_tree,
         tf32="off (cudnn and matmul)")
    check(n_params == cfg.param_count(), f"{n_params} parameters, config "
                                         f"says {cfg.param_count()}")
    check(same_tree, "the drawn weights are not in init_lm's tree")
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt))
                              .astype(np.int32)).to(dev)
    max_len = prompt + steps + 1
    with torch.inference_mode():
        ssd.reset_counts()
        prefill_s = []
        for _ in range(2):          # the first includes cuBLAS warm-up
            _sync(dev)
            t0 = time.perf_counter()
            last, caches = transformer.prefill(params, cfg, tokens, max_len=max_len,
                                               use_kernel=True)
            _sync(dev)
            prefill_s.append(time.perf_counter() - t0)
        counts, plain = dict(ssd.launches), dict(ssd.plain_calls)
        _sync(dev)
        t0 = time.perf_counter()
        last_p, caches_p = transformer.prefill(params, cfg, tokens,
                                               max_len=max_len,
                                               use_kernel=False)
        _sync(dev)
        plain_prefill_s = time.perf_counter() - t0
        # (a) kernel prefill == plain prefill: logits and every layer's state
        e_logit = float((last - last_p).abs().max())
        uk, up = caches["units"]["pos0"], caches_p["units"]["pos0"]
        e_ssd = max(_rel_err(uk["ssd"][i], up["ssd"][i])
                    for i in range(cfg.num_layers))
        e_conv = max(_rel_err(uk["conv"][i], up["conv"][i])
                     for i in range(cfg.num_layers))
        del caches_p
        emit(phase="mamba2_prefill_vs_plain", logits_max_abs_err=e_logit,
             logits_tol=MAMBA_LOGIT_ATOL, ssd_state_max_rel_err=e_ssd,
             conv_state_max_rel_err=e_conv, state_tol=MAMBA_STATE_REL,
             logits_max_abs=float(last_p[..., :cfg.vocab].abs().max()))
        check(e_logit <= MAMBA_LOGIT_ATOL,
              f"kernel prefill logits vs plain: {e_logit}")
        check(e_ssd <= MAMBA_STATE_REL and e_conv <= MAMBA_STATE_REL,
              f"kernel prefill states vs plain: ssd {e_ssd}, conv {e_conv}")
        check(bool(torch.isfinite(last).all())
              and bool(torch.isfinite(last_p).all()),
              "prefill logits not finite")

        # greedy decode from the kernel prefill's caches
        tok = last.argmax(-1).to(torch.int32)                 # [B, 1]
        gen, step_logits, step_s = [tok], [], []
        pos0 = torch.full((batch,), prompt, dtype=torch.int32, device=dev)
        peak = {}
        if cuda:
            peak["prefill"] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t_dec = time.perf_counter()
        for i in range(steps):
            _sync(dev)
            t0 = time.perf_counter()
            logits, caches = transformer.decode_step(params, cfg, tok,
                                                     pos0 + i, caches)
            tok = logits.argmax(-1).to(torch.int32)
            _sync(dev)
            step_s.append(time.perf_counter() - t0)
            step_logits.append(logits)
            gen.append(tok)
        decode_s = time.perf_counter() - t_dec
        if cuda:
            peak["decode"] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        prof = {}
        if cuda:
            # profiled after the counts were read: not the path's launches
            def four_steps(tok=tok, caches=caches):
                for i in range(4):
                    logits, caches = transformer.decode_step(
                        params, cfg, tok, pos0 + steps + i, caches)
                    tok = logits.argmax(-1).to(torch.int32)

            prof["decode_4_steps"] = _profile(four_steps, dev)
            prof["prefill"] = _profile(lambda: transformer.prefill(
                params, cfg, tokens, max_len=max_len, use_kernel=True), dev)
        del caches

        # (b) every token == the plain forward's argmax over the extended
        # sequence, where that forward's top-1/top-2 margin allows it
        forward_s = check_against_forward(params, cfg, tokens, gen,
                                          step_logits, MAMBA_MARGIN, dev,
                                          "mamba2_decode_vs_forward", peak)
    n_tok = batch * steps
    emit(phase="mamba2", card=card, batch=batch, prompt_len=prompt,
         prefill_s=prefill_s, plain_prefill_s=plain_prefill_s,
         prefill_tokens_per_s=batch * prompt / prefill_s[-1],
         decode_s=decode_s, decode_tokens_per_s=n_tok / decode_s,
         step_p50_ms=float(np.percentile(step_s, 50) * 1e3),
         step_p99_ms=float(np.percentile(step_s, 99) * 1e3),
         forward_s=forward_s,
         peak_device_bytes=max(peak.values()) if peak else None,
         peak_device_bytes_by_stage=peak,
         kernels_per_decoded_token=(
             prof["decode_4_steps"]["device_kernels"] / (4 * batch)
             if prof else None),
         profile=prof, ssd_launches=counts, ssd_plain_calls=plain,
         phase_s=time.perf_counter() - t_phase)
    return {"counts": counts, "plain": plain, "prefills": len(prefill_s)}


# -- phase 7: slice E's path, the LM zoo's attention decode ------------------------

def dense_params(cfg, seed: int, dev) -> dict:
    """Seeded fan-in weights in ``init_lm``'s tree for the ``dense`` family,
    drawn on ``dev`` with an explicit generator: He-init ``w ~ N(0,
    2/fan_in)`` for every projection, norm scales 1, the embedding ``N(0,
    0.02)`` with zero pad-vocab rows (and an untied head's pad columns).

    The MLP's down projection is centred over its fan-in (each output's
    weights sum to 0).  A GELU's output has a positive mean, so an
    uncentred random down projection adds one fixed vector at every
    position of every layer; at granite-34b's widths that vector decides
    the argmax, and different prompts decode the same tokens (2 distinct
    streams of 4 on the card).  A trained model does not do that."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    s = transformer.attn_spec(cfg, None)
    d, f, hq, hkv = cfg.d_model, cfg.d_ff, s.num_heads * s.head_dim, \
        s.kv_heads * s.head_dim
    n_units, rem = divmod(cfg.num_layers, cfg.unit_layers)

    def he(n, fan_in, fan_out):
        return {"w": torch.randn((n, fan_in, fan_out), generator=gen,
                                 device=dev).mul_(math.sqrt(2.0 / fan_in))}

    def norm(*shape):
        return {"scale": torch.ones(shape, device=dev)}

    def layers(n):
        down = he(n, f, d)
        down["w"] -= down["w"].mean(dim=1, keepdim=True)
        mlp = {"ln": norm(n, d), "up": he(n, d, f), "down": down}
        if cfg.gated_mlp:
            mlp["gate"] = he(n, d, f)
        return {"attn": {"ln": norm(n, d), "wq": he(n, d, hq),
                         "wk": he(n, d, hkv), "wv": he(n, d, hkv),
                         "wo": he(n, hq, d)}, "mlp": mlp}

    table = torch.zeros((cfg.padded_vocab, d), device=dev)
    table[:cfg.vocab] = torch.randn((cfg.vocab, d), generator=gen,
                                    device=dev).mul_(0.02)
    params = {"embed": {"table": table},
              "units": {f"pos{i}": layers(n_units)
                        for i in range(cfg.unit_layers)},
              "final_ln": norm(d)}
    if rem:
        params["rem"] = {"pos0": layers(rem)}
    if not cfg.tie_embeddings:
        w = he(1, d, cfg.padded_vocab)["w"][0]
        w[:, cfg.vocab:] = 0.0
        params["unembed"] = {"w": w}
    return params


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def zoo_decode_phase(dev, cfg, batch: int, prompt: int, steps: int,
                     max_len: int, card: str, cut: str | None) -> dict:
    """Slice E's path: ``prefill`` of ``batch`` seeded prompts, then
    ``steps`` greedy ``decode_step(use_kernel=True)``s.  Each step's logits
    are held against ``decode_step(use_kernel=False)`` run from a copy of
    the same caches, and every token against the plain forward.  Returns
    decode attention's launch and plain-call counts over the kernel
    steps, and the launches they should be (one per attention layer and
    step)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = dense_params(cfg, seed=0, dev=dev)
    _sync(dev)
    weights_s = time.perf_counter() - t0
    n_params = transformer.param_count(params)
    # init_lm's tree at the same depth and windows, at a small width
    small = transformer.init_lm(cfg_base.reduced(
        cfg, num_layers=cfg.num_layers, window_pattern=cfg.window_pattern),
        0, device=dev)
    same_tree = [p for p, _ in tree_flatten_with_path(params)] == \
        [p for p, _ in tree_flatten_with_path(small)]
    del small
    s = transformer.attn_spec(cfg, None)
    attn_layers = cfg.num_layers
    emit(phase="zoo_setup", config=cfg.name, source=cfg.source, cut=cut,
         layers=cfg.num_layers, d_model=cfg.d_model, heads=s.num_heads,
         kv_heads=s.kv_heads, group=s.num_heads // s.kv_heads,
         head_dim=s.head_dim, d_ff=cfg.d_ff, gated_mlp=cfg.gated_mlp,
         vocab=cfg.vocab, windows=list(cfg.window_pattern),
         attention_layers=attn_layers, parameters=n_params,
         weight_bytes=4 * n_params, weights_s=weights_s, batch=batch,
         prompt_len=prompt, decode_steps=steps, max_len=max_len,
         reference_tree=same_tree, tf32="off (cudnn and matmul)")
    check(n_params == cfg.param_count(), f"{n_params} parameters, config "
                                         f"says {cfg.param_count()}")
    check(same_tree, "the drawn weights are not in init_lm's tree")
    check(cfg.family == "dense", f"{cfg.name}: not a dense config")
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt))
                              .astype(np.int32)).to(dev)
    peak = {}
    with torch.inference_mode():
        prefill_s = []
        for _ in range(2):          # the first includes cuBLAS warm-up
            _sync(dev)
            t0 = time.perf_counter()
            last, caches = transformer.prefill(params, cfg, tokens,
                                               max_len=max_len)
            _sync(dev)
            prefill_s.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(last).all()), "prefill logits not finite")
        if cuda:
            peak["prefill"] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)

        # greedy decode with the kernel; each step also run plain from a
        # copy of the caches it started from
        tok = last.argmax(-1).to(torch.int32)                 # [B, 1]
        gen, step_logits, step_s, plain_s, step_err = [tok], [], [], [], []
        pos0 = torch.full((batch,), prompt, dtype=torch.int32, device=dev)
        da.reset_counts()
        for i in range(steps):
            before = _clone(caches)
            _sync(dev)
            t0 = time.perf_counter()
            logits, caches = transformer.decode_step(
                params, cfg, tok, pos0 + i, caches, use_kernel=True)
            _sync(dev)
            step_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            plain, _ = transformer.decode_step(params, cfg, tok, pos0 + i,
                                               before, use_kernel=False)
            _sync(dev)
            plain_s.append(time.perf_counter() - t0)
            step_err.append(float((logits - plain).abs().max()))
            del before, plain
            tok = logits.argmax(-1).to(torch.int32)
            step_logits.append(logits)
            gen.append(tok)
        counts, plain_calls = dict(da.launches), dict(da.plain_calls)
        by_shape = dict(da.launches_by_shape)
        if cuda:
            peak["decode"] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        emit(phase="zoo_kernel_vs_plain_step", config=cfg.name,
             steps=steps, max_abs_err=max(step_err), tol=ZOO_STEP_ATOL,
             per_step=step_err,
             logits_max_abs=float(torch.cat(step_logits).abs().max()))
        check(max(step_err) <= ZOO_STEP_ATOL,
              f"{cfg.name}: kernel decode_step vs plain: {max(step_err)}")
        prof = {}
        if cuda:
            # profiled after the counts were read: not the path's launches
            def four_steps(tok=tok, caches=caches):
                for i in range(4):
                    logits, caches = transformer.decode_step(
                        params, cfg, tok, pos0 + steps + i, caches,
                        use_kernel=True)
                    tok = logits.argmax(-1).to(torch.int32)

            prof["decode_4_steps"] = _profile(four_steps, dev)
        del caches, last
        forward_s = check_against_forward(params, cfg, tokens, gen,
                                          step_logits, ZOO_MARGIN, dev,
                                          "zoo_decode_vs_forward", peak)
    del params
    n_tok = batch * steps
    emit(phase="zoo", config=cfg.name, card=card, cut=cut, batch=batch,
         prompt_len=prompt, prefill_s=prefill_s,
         prefill_tokens_per_s=batch * prompt / prefill_s[-1],
         decode_s=sum(step_s), decode_tokens_per_s=n_tok / sum(step_s),
         step_p50_ms=float(np.percentile(step_s, 50) * 1e3),
         step_p99_ms=float(np.percentile(step_s, 99) * 1e3),
         plain_step_p50_ms=float(np.percentile(plain_s, 50) * 1e3),
         forward_s=forward_s,
         peak_device_bytes=max(peak.values()) if peak else None,
         peak_device_bytes_by_stage=peak,
         kernels_per_decoded_token=(
             prof["decode_4_steps"]["device_kernels"] / (4 * batch)
             if prof else None),
         profile=prof, decode_attention_launches=counts,
         decode_attention_plain_calls=plain_calls,
         phase_s=time.perf_counter() - t_phase)
    return {"counts": counts, "plain": plain_calls, "by_shape": by_shape,
            "want": attn_layers * steps}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the paths on the CPU at small sizes; never "
                         "prints a result")
    args = ap.parse_args()
    if args.cpu_rehearsal:
        torch.set_num_threads(min(4, os.cpu_count() or 1))
        main_path(torch.device("cpu"), 64, 10, 4, "cpu rehearsal")
        # 1000 classes as on the card: the tail's logits set the per-byte
        # encode rate (alpha 1, ROADMAP queue 3 item 6), and 10 classes'
        # 40 bytes price every cut's encode above the 20 ms sleep, so the
        # DP grows stage 0 there
        controller_phase(torch.device("cpu"), 64, 1000, "cpu rehearsal")
        procs_phase(torch.device("cpu"), 64, 1000, "cpu rehearsal")
        small = dict(vocab=256, d_model=64, n_layers=4, num_heads=4,
                     kv_heads=2, head_dim=16, d_ff=128, cache_len=128)
        decode_phase(torch.device("cpu"), small, (16, 48), 8,
                     "cpu rehearsal")
        mamba2_phase(torch.device("cpu"), mamba2_2_7b.smoke_config(), 2, 80,
                     6, "cpu rehearsal")
        # slice E at smoke widths with the zoo's head geometry: gemma3-4b's
        # window (32 here) wraps in prefill and decode
        for cfg, heads, prompt in (
                (gemma3_4b.CONFIG, dict(num_heads=8, kv_heads=4,
                                        head_dim=256), 48),
                (granite_34b.CONFIG, dict(num_heads=48, kv_heads=1,
                                          head_dim=128), 40)):
            zoo_decode_phase(torch.device("cpu"),
                             cfg_base.reduced(cfg, **heads), 2, prompt, 6, 64,
                             "cpu rehearsal", "smoke widths")
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
    da_errs = compare_decode_attention(dev)
    check_da_batch_invariance(dev)
    ssd_errs = compare_ssd_scan(dev)
    main = main_path(dev, 224, 1000, 8, card)
    ctl = controller_phase(dev, 224, 1000, card)
    for name in ("quantize_blocks", "dequantize_blocks"):
        check(ctl["counts"][name] > 0,
              f"{name} was never launched on the controller's q8 chain")
        check(ctl["plain"][name] == 0,
              f"{name} ran its plain version on the controller's q8 chain")
    procs = procs_phase(dev, 224, 1000, card)
    for name in ("quantize_blocks", "dequantize_blocks"):
        check(procs["counts"][name] > 0,
              f"{name} was never launched on the process-backed q8 chain")
        check(procs["plain"][name] == 0,
              f"{name} ran its plain version on the process-backed chain")
    t_dec = time.perf_counter()
    dec = decode_phase(dev, STARCODER2_3B, PROMPT_LEN, NEW_TOKENS, card)
    emit(phase="decode_phase_done", seconds=time.perf_counter() - t_dec)
    check(dec["counts"]["decode_attention"] > 0,
          "decode_attention was never launched on the decode path")
    check(dec["plain"]["decode_attention"] == 0,
          "decode attention ran its plain version on the decode path")
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = mamba2_2_7b.CONFIG
    mam = mamba2_phase(dev, mcfg, MAMBA_BATCH, MAMBA_PROMPT, MAMBA_STEPS,
                       card)
    check(mam["counts"]["ssd_scan"] == mam["prefills"] * mcfg.num_layers,
          f"ssd_scan launched {mam['counts']['ssd_scan']} times in "
          f"{mam['prefills']} kernel prefills of {mcfg.num_layers} layers")
    check(mam["plain"]["ssd_scan"] == 0,
          "the SSD scan ran its plain version on the Mamba2 path")
    gc.collect()
    torch.cuda.empty_cache()
    zoo, zoo_shapes = {}, []
    for cfg, prompt, cut in ZOO_RUNS:
        t_zoo = time.perf_counter()
        z = zoo_decode_phase(dev, cfg, ZOO_BATCH, prompt, ZOO_STEPS,
                             ZOO_MAX_LEN, card, cut)
        emit(phase="zoo_phase_done", config=cfg.name,
             seconds=time.perf_counter() - t_zoo)
        check(z["counts"]["decode_attention"] == z["want"],
              f"{cfg.name}: decode_attention launched "
              f"{z['counts']['decode_attention']} times, want {z['want']} "
              "(one per attention layer and step)")
        check(z["plain"]["decode_attention"] == 0,
              f"{cfg.name}: decode attention ran its plain version")
        zoo[cfg.name] = z["counts"]["decode_attention"]
        zoo_shapes += [{"config": cfg.name, "shape": list(k),
                        "form": da.form(k[1] // k[2], k[3]), "launches": n}
                       for k, n in z["by_shape"].items()]
        gc.collect()
        torch.cuda.empty_cache()
    times = time_kernels(dev, SWEEP)
    check(set(main["sizes"]) <= set(RAGGED),
          f"slice A's leaves {main['sizes']} are not all checked in RAGGED")
    rtimes = time_ragged(dev, RAGGED_TIMED)
    wtimes = time_wire(dev, sorted(set(main["sizes"])))
    cfg = STARCODER2_3B
    da_shape = (lm_graph.DECODE_STEP_ROWS, cfg["num_heads"], cfg["kv_heads"],
                cfg["head_dim"], cfg["cache_len"])
    da_t = time_decode_attention(dev, *da_shape)
    da_other_t = [time_decode_attention(dev, *da_shape, dtype=torch.bfloat16)]
    da_other_t += [time_decode_attention(dev, *sh) for sh in DA_ZOO_TIMED]
    ssd_t = time_ssd_scan(dev, SSD_PATH)
    # the kernels line reports the largest leaf one batch-1 request puts
    # on the wire on the main path, and the [4096, 128] grid PRs 11-20
    # reported (that leaf padded to its power-of-two tile count)
    n = max(main["sizes"])
    kernels = []
    for name, tpu in (("quantize_blocks", "src/repro/kernels/block_quant.py:59"),
                      ("dequantize_blocks",
                       "src/repro/kernels/block_quant.py:85")):
        t, g = rtimes[(n, name)], times[(4096, 128, name)]
        check(main["counts"][name] > 0,
              f"{name} was never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/block_quant.cu",
            "replaces": tpu,
            "launches": main["counts"][name],
            "launches_by_path": {"main_path": main["counts"][name],
                                 "controller": ctl["counts"][name],
                                 "procs": procs["counts"][name]},
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "call_ms": t["call_ms"], "plain_call_ms": t["plain_call_ms"],
            "n": n, "tiles": t["tiles"],
            "grid_4096x128": {k: g[k] for k in (
                "ms", "call_ms", "plain_ms", "bound_ms")},
            "wire_call_ms": {k: v for w in wtimes if w["n"] == n
                             for k, v in w.items() if k.endswith("_ms")},
            "card": card})
    kernels.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:74",
        "launches": dec["counts"]["decode_attention"] + sum(zoo.values()),
        "launches_by_path": dict(decode_serve=dec["counts"]["decode_attention"],
                                 **zoo),
        "launches_by_shape": zoo_shapes,
        "max_abs_err": da_errs["f32"], "max_abs_err_bf16": da_errs["bf16"],
        "ms": da_t["ms"], "plain_ms": da_t["plain_ms"],
        "bound_ms": da_t["bound_ms"], "bound_by": da_t["bound_by"],
        "library_ms": da_t["library_ms"], "call_ms": da_t["call_ms"],
        "plain_call_ms": da_t["plain_call_ms"],
        "library_call_ms": da_t["library_call_ms"],
        "shape": list(da_shape), "dtype": da_t["dtype"], "form": da_t["form"],
        "other_shapes": [{k: t[k] for k in (
            "shape", "dtype", "form", "ms", "call_ms", "plain_ms",
            "plain_call_ms", "bound_ms", "bound_by", "library_ms",
            "library_call_ms")} for t in da_other_t],
        "card": card})
    kernels.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:71",
        "launches": mam["counts"]["ssd_scan"],
        "max_abs_err": ssd_errs["f32"], "max_abs_err_bf16": ssd_errs["bf16"],
        "ms": ssd_t["ms"], "plain_ms": ssd_t["plain_ms"],
        "bound_ms": ssd_t["bound_ms"], "bound_by": ssd_t["bound_by"],
        "library_ms": None, "call_ms": ssd_t["call_ms"],
        "plain_call_ms": ssd_t["plain_call_ms"],
        "phases_ms": ssd_t["phases_ms"], "shape": list(SSD_PATH),
        "card": card})
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
