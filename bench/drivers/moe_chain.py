"""System under test: decode serving of a transformer with routed experts
and window and full attention layers through DEFER's chain.

The configuration holds the model's published ``config.json`` keys, read
here as ``repro_torch.models.lm_graph.decode_moe_lm_graph`` takes them
(:func:`model_kwargs`; its decode attention runs the port's CUDA kernel,
with the window on the sliding layers), the experts this chip holds
(``experts_first_held`` and ``num_experts`` of ``num_experts_routed``),
the chain (``serve``) and the limits of the check.  Sessions go through
``InferenceEngine.generate``, greedy; the wire is raw.  The weights are
drawn on the device from the seed.

The check, after the window, holds the logits the engine returned for
every token served (the prefill's for the first, each step's after)
against the plain reference ``bench/reference/mellum2.py`` run once over
each session's prompt and served tokens.  A row's error is ``max |served -
reference| / max |reference|``.  Compared, each with its limit:

- ``logits_bad_rows``, limit 0: rows served with a NaN or infinite error,
  and every served token of a session whose logits are missing;
- ``logits_rel_err_p95``: the 95th percentile of the other rows' errors;
- ``logits_rel_err_session_p50``: the largest of the sessions' medians of
  their rows' errors, so that a fault confined to one session shows
  although its rows are fewer than 5 % of the window's;
- beside them, with limit 0, the decode steps' live assignments to held
  experts that the combine weighted by 0 (the replicas' ``moe_dropped``;
  no replica reporting it reads infinite), failed sessions, and decode
  attention's plain calls on the card.

Not the largest row: a session's prompt makes some 70,000 routing
choices, and the gap between a router's k-th and (k+1)-th logit falls to
1e-7 among them, where f32 summation order decides which expert is taken
and either is the model's arithmetic.  The other expert moves that
position's hidden state by a few percent, and the later rows that attend
to it by up to 2 % (on the card, 14 of 2,906 rows above 1e-3 over three
windows, each in a session whose history held a gap under 1.6e-6, and at
most 6 of a session's rows).
"""
from __future__ import annotations

import math
import time
from collections import defaultdict

import numpy as np
import torch

from bench.drivers.lm_chain import ChainLM
from bench.harness import weights as W
from bench.harness.result import Check
from bench.reference import mellum2 as ref


def model_kwargs(cfg: dict) -> dict:
    """``decode_moe_lm_graph``'s arguments from the configuration's keys."""
    return dict(
        vocab=cfg["vocab_size"], d_model=cfg["hidden_size"],
        layer_types=tuple(cfg["layer_types"]),
        num_heads=cfg["num_attention_heads"],
        kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        sliding_window=cfg["sliding_window"],
        rope_parameters=cfg["rope_parameters"],
        expert_d_ff=cfg["moe_intermediate_size"],
        num_experts=cfg["num_experts_routed"],
        top_k=cfg["num_experts_per_tok"],
        experts_held=(cfg["experts_first_held"], cfg["num_experts"]),
        eps=cfg["rms_norm_eps"], cache_len=cfg["cache_len"])


def leaves(cfg: dict) -> list:
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    hd = cfg["head_dim"]
    hq, hk = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    n, f = cfg["num_experts"], cfg["moe_intermediate_size"]
    scale = ("uniform", 0.5, 1.5)

    def w(shape, fan_in):
        return shape, ("normal", float(1.0 / np.sqrt(fan_in)))
    out = [(("embed", "table"), (v, d), ("normal", 1.0))]
    for i in range(len(cfg["layer_types"])):
        a, p = f"blk{i}_attn", f"blk{i}_mlp"
        out.append(((a, "ln", "scale"), (d,), scale))
        for k, (din, dout) in (("wq", (d, hq)), ("wk", (d, hk)),
                               ("wv", (d, hk)), ("wo", (hq, d))):
            out.append(((a, k, "w"), *w((din, dout), din)))
        out.append(((p, "ln", "scale"), (d,), scale))
        out.append(((p, "router"), *w((d, cfg["num_experts_routed"]), d)))
        out.append(((p, "gate"), *w((n, d, f), d)))
        out.append(((p, "up"), *w((n, d, f), d)))
        out.append(((p, "down"), *w((n, f, d), f)))
    out.append((("head", "ln", "scale"), (d,), scale))
    out.append((("head", "out", "w"), *w((d, v), d)))
    return out


class ChainMoE(ChainLM):

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 setup: dict):
        from repro_torch.kernels import decode_attention
        from repro_torch.models import lm_graph
        from repro_torch.runtime import (DispatcherCodecs, InferenceEngine,
                                         TopologySpec, WireCodec)
        self.config, self.seed, self.device = config, seed, device
        self._da = decode_attention
        s = config["serve"]
        self.vocab = config["vocab_size"]
        graph = lm_graph.decode_moe_lm_graph(use_kernel=True,
                                             **model_kwargs(config))
        t = time.perf_counter()
        params = W.to_host(W.draw(leaves(config), seed, device))
        setup["weights_s"] = time.perf_counter() - t
        spec = TopologySpec.chain(graph, s["stages"], cuts=s["cuts"],
                                  replicas=s["replicas"])
        raw = WireCodec("raw", "none")
        self.eng = InferenceEngine(graph, spec, DispatcherCodecs(
            data=raw, weights=raw), max_batch=s["max_batch"], device=device)
        t = time.perf_counter()
        self.eng.configure(params)
        del params
        self.eng.start()
        setup["configure_s"] = time.perf_counter() - t
        self._base = {}
        self.logits: dict[str, list] = defaultdict(list)
        self._record_logits()

    def _judge(self, run, served) -> list[Check]:
        """The logits checks of ``served(session, params)``, the rows a
        session's served tokens were taken from ([tokens, vocab] on the
        device, or None where some are missing), against the reference's
        rows at the same positions."""
        errs, bad = [], 0
        with torch.inference_mode():
            params = W.draw(leaves(self.config), self.seed, self.device)
            for s in run.sessions:
                if not s.tokens:
                    continue
                y = served(s, params)
                if y is None:
                    bad += len(s.tokens)
                    continue
                z = self._reference(params, s)
                e = (y - z).abs().amax(1).div(z.abs().amax(1)).double().cpu()
                finite = torch.isfinite(e)
                bad += int((~finite).sum())
                if finite.any():
                    errs.append(e[finite])
            del params
        lim = self.config["limits"]["raw"]
        p95 = (float(torch.quantile(torch.cat(errs), 0.95)) if errs
               else 0.0)
        p50 = max((float(torch.quantile(e, 0.5)) for e in errs),
                  default=0.0)
        return [Check("logits_bad_rows", bad, 0),
                Check("logits_rel_err_p95", p95, lim["logits_rel_err_p95"]),
                Check("logits_rel_err_session_p50", p50,
                      lim["logits_rel_err_session_p50"])]

    def _reference(self, params, s, tf32: bool = False) -> torch.Tensor:
        seq = torch.tensor(s.prompt + s.tokens, device=self.device)
        z = ref.forward(params, seq, self.config, tf32=tf32)
        return z[len(s.prompt) - 1:len(s.prompt) - 1 + len(s.tokens)]

    def check(self, run) -> list[Check]:
        nodes = [n for n in (run.report or {}).get("per_node", [])
                 if "moe_dropped" in n]
        dropped = (sum(sum(n["moe_dropped"].values()) for n in nodes)
                   if nodes else math.inf)
        checks = self._judge(run, self._served) + [
            Check("moe_dropped", dropped, 0),
            Check("failed_sessions",
                  sum(s.error is not None for s in run.sessions), 0)]
        if self.device.type == "cuda":
            checks.append(Check(
                "decode_attention_plain_calls",
                run.counters["decode_attention"]["plain_calls"], 0))
        return checks

    def control(self, run) -> list[Check]:
        return self._judge(run, lambda s, params: self._reference(
            params, s, tf32=True))


def build(config: dict, traffic: dict, seed: int, device, setup: dict):
    return ChainMoE(config, traffic, seed, device, setup)
