"""Serving launcher: the DEFER pipeline as a first-class deployment path
(the twin of ``repro.launch.serve``).

The dispatcher role (paper Algorithm 1) maps to this module: plan the
partition (units -> stages), stack the stage weights, stream microbatches
through the chain, collect FIFO results.  The wire codec (int8 block
quantization, the ZFP adaptation) is a flag, exactly like the paper's
codec configurations.

    python -m repro_torch.launch.serve --arch phi3-mini-3.8b --stages 4 \\
        --microbatches 8 --requests 32 --seq 64 [--compress] [--full] \\
        [--device cpu]

It runs on the card unless ``--device cpu`` is given, every stage on the
one device.  ``build_pipeline_lm`` is the reusable bridge: any ModelConfig
-> (stage weights, unit_fn, head/tail fns) consumable by
:mod:`repro_torch.core.pipeline`.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCHS, get_config, get_smoke
from repro_torch.core.graph import tree_map
from repro_torch.core.pipeline import (PipelineConfig, make_pipeline,
                                       make_stage_unit_fn, stack_stages)
from repro_torch.core.pipeline_decode import make_pipeline_decoder
from repro_torch.device import get_device
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


@dataclasses.dataclass
class PipelineLM:
    cfg: ModelConfig
    pipe_cfg: PipelineConfig
    stage_params: Any            # (stacked units [S, u, ...], valid [S, u])
    extra: Any                   # pytree every stage needs whole, or None
    params: Any                  # full params (embed/head/rem live outside)
    fn: Callable                 # the pipeline callable

    def __call__(self, tokens: torch.Tensor, prefix_embeds=None,
                 encoder_embeds=None) -> torch.Tensor:
        """tokens [B, S] with B = M * mb -> logits [B, S, V]."""
        cfg, M = self.cfg, self.pipe_cfg.num_microbatches
        B, S = tokens.shape
        if B % M:
            raise ValueError(f"batch {B} must be M={M} microbatches")
        mb = B // M
        x = L.embed(self.params["embed"], tokens)
        x = T._fuse_prefix(cfg, x, prefix_embeds)

        if cfg.encoder_layers:
            enc_out, _ = T._encode(self.params, cfg, encoder_embeds)
            stream = {"h": x.reshape(M, mb, S, -1),
                      "enc": enc_out.reshape(M, mb, *enc_out.shape[1:])}
        else:
            stream = x.reshape(M, mb, S, -1)

        out = (self.fn(self.stage_params, stream) if self.extra is None
               else self.fn(self.stage_params, stream, self.extra))
        x = (out["h"] if isinstance(out, dict) else out).reshape(B, S, -1)

        # remainder layers + head run dispatcher-side (the tail of the chain)
        positions = T._positions(B, S, x.device)
        _, rem = T._unit_count(cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(rem):
            up = T._tree_at(self.params["rem"], i)
            x, aux = T._apply_layer(up["pos0"], cfg, x, positions, aux,
                                    T._window_at(cfg, i))
        return T._logits(self.params, cfg, x)


def make_unit_fn(cfg: ModelConfig, with_extra: bool, unroll: bool = False):
    """Stage body over ``T._apply_unit``: the stage's units in order, the
    padded ones skipped.  ``unroll`` changes nothing (the port loops)."""
    del unroll

    def apply_unit(up, x, extra):
        h, enc = (x["h"], x["enc"]) if isinstance(x, dict) else (x, None)
        B, S, _ = h.shape
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        shared = extra.get("shared") if extra else None
        h, _ = T._apply_unit(up, cfg, h, T._positions(B, S, h.device), aux,
                             shared=shared, enc_out=enc)
        return {"h": h, "enc": enc} if isinstance(x, dict) else h

    def stage_fn(local, x, extra=None):
        return make_stage_unit_fn(
            lambda up, h: apply_unit(up, h, extra))(local, x)

    if with_extra:
        return stage_fn
    return lambda local, x: stage_fn(local, x, None)


def build_pipeline_lm(cfg: ModelConfig, params: Any, mesh,
                      num_stages: int, num_microbatches: int,
                      compress: bool = False, quant_impl: str = "kernel",
                      axis: str = "stage",
                      data_axes: tuple[str, ...] = (),
                      unroll: bool = False) -> PipelineLM:
    """The prefill pipeline over the port's params tree (``init_lm`` /
    ``params_from_jax``) on ``mesh`` (a
    :class:`repro_torch.launch.mesh.StageMesh`)."""
    n_units = cfg.num_layers // cfg.unit_layers
    stacked, valid = stack_stages(params["units"], n_units, num_stages)
    extra = {"shared": params["shared"]} if "shared" in params else None
    pipe_cfg = PipelineConfig(num_stages=num_stages,
                              num_microbatches=num_microbatches,
                              axis=axis, compress=compress,
                              quant_impl=quant_impl, unroll_ticks=unroll)
    fn = make_pipeline(mesh, pipe_cfg,
                       make_unit_fn(cfg, extra is not None, unroll=unroll),
                       data_axes=data_axes, with_extra=extra is not None)
    return PipelineLM(cfg, pipe_cfg, (stacked, valid), extra, params, fn)


# -- autoregressive decode THROUGH the pipeline (beyond-paper) -------------------

def build_pipeline_decoder(cfg: ModelConfig, params: Any, mesh,
                           num_stages: int, num_microbatches: int, mb: int,
                           max_len: int, steps: int, compress: bool = False,
                           axis: str = "stage", quant_impl: str = "kernel"):
    """Decode pipeline: returns (fn, stage_params, caches0, head).

    fn(stage_params, caches, start_tok [M,mb,1], start_pos [M,mb])
        -> (tokens [M, steps, mb], caches)

    ``caches0`` lives on the first stage's device and ``fn`` writes it in
    place: build a new decoder (or copy it) for a second run.
    """
    if cfg.num_layers % cfg.unit_layers:
        raise ValueError("decode pipeline needs an integral unit stack "
                         "(no remainder layers)")
    n_units = cfg.num_layers // cfg.unit_layers
    stacked, valid = stack_stages(params["units"], n_units, num_stages)

    # per-microbatch cache slabs: [n_units, M, mb, ...] -> [S, u, M, mb, ...]
    M = num_microbatches
    base = T.init_caches(cfg, mb, max_len, torch.float32,
                         device=mesh.devices[0])

    def stack_m(a: torch.Tensor) -> torch.Tensor:
        return a[:, None].repeat((1, M) + (1,) * (a.dim() - 1))

    caches0, _ = stack_stages(tree_map(stack_m, base["units"]), n_units,
                              num_stages)

    head = {"embed": params["embed"], "final_ln": params["final_ln"]}
    if not cfg.tie_embeddings:
        head["unembed"] = params["unembed"]
    if "shared" in params:
        head["shared"] = params["shared"]

    def embed_fn(hd, tok):
        return L.embed(hd["embed"], tok)

    def head_fn(hd, h):
        return T._logits(hd, cfg, h)

    def decode_unit_fn(local_w, h, pos, mcache, hd):
        units, vmask = local_w
        shared = hd.get("shared")
        for j, ok in enumerate(vmask):
            if not ok:
                continue
            up, uc = T._tree_at(units, j), T._tree_at(mcache, j)
            for i in range(cfg.unit_layers):
                h, nc = T._decode_layer(up[f"pos{i}"], cfg, h, pos,
                                        uc[f"pos{i}"], T._window_at(cfg, i),
                                        None, False)
                T._write_back(uc[f"pos{i}"], nc)
            if shared is not None:
                sc = uc["shared"]
                h, nkv, nkpos = attn_mod.attention_decode(
                    shared["attn"], T.attn_spec(cfg, None), h, pos, sc,
                    sc["kpos"], cfg.norm_eps)
                h = L.mlp(shared["mlp"], h, cfg.norm_eps)
                T._write_back(sc, {**nkv, "kpos": nkpos})
        return h, mcache

    pipe_cfg = PipelineConfig(num_stages=num_stages, num_microbatches=M,
                              axis=axis, compress=compress,
                              quant_impl=quant_impl)
    fn = make_pipeline_decoder(mesh, pipe_cfg, decode_unit_fn=decode_unit_fn,
                               embed_fn=embed_fn, head_fn=head_fn,
                               steps=steps)
    return fn, (stacked, valid), caches0, head


def wire_bytes_per_relay(cfg: ModelConfig, mb: int, seq: int,
                         compress: bool) -> int:
    """Bytes one stage relays per microbatch (the paper's 'data' payload),
    as the reference prices them: a raw relay at bf16 and the codec's
    unpadded grid (ROADMAP queue 3 item 11)."""
    shape = (mb * seq, cfg.d_model)
    if not compress:
        return mb * seq * cfg.d_model * 2          # bf16
    raw, wire = kops.quant_bytes(shape, torch.bfloat16)
    return wire


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    dev = get_device(args.device)
    mesh = make_host_mesh(args.stages, dev)
    params = T.init_lm(cfg, 0, device=dev)
    lm = build_pipeline_lm(cfg, params, mesh, args.stages, args.microbatches,
                           compress=args.compress)
    B = args.requests
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, args.seq))
                              .astype(np.int32)).to(dev)
    kw = {}
    if cfg.num_prefix_embeds and not cfg.encoder_layers:
        kw["prefix_embeds"] = torch.zeros((B, cfg.num_prefix_embeds,
                                           cfg.d_model), device=dev)
    if cfg.encoder_layers:
        kw["encoder_embeds"] = torch.zeros((B, cfg.num_prefix_embeds,
                                            cfg.d_model), device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.inference_mode():
        logits = lm(tokens, **kw)              # cold: allocator, cuBLAS
        sync()
        t0 = time.perf_counter()
        logits = lm(tokens, **kw)
        sync()
        dt = time.perf_counter() - t0
    mb = B // args.microbatches
    wire = wire_bytes_per_relay(cfg, mb, args.seq, args.compress)
    log = lm.fn.relayed
    print(f"arch={args.arch} stages={args.stages} M={args.microbatches} "
          f"compress={args.compress} device={dev}")
    print(f"logits {tuple(logits.shape)}; wall {dt*1e3:.1f} ms; "
          f"relay payload/microbatch {wire/1e6:.3f} MB")
    print(f"relayed {log.relays} leaves ({log.encoded} encoded): "
          f"{log.wire_bytes / max(log.relays, 1) / 1e6:.3f} MB/relay on the "
          f"wire, {log.raw_bytes / max(log.relays, 1) / 1e6:.3f} MB raw")


if __name__ == "__main__":
    main()
