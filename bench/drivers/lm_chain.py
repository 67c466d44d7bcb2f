"""System under test: decode serving of a transformer through DEFER's chain.

The configuration names the model (``model``: the keyword arguments of
``repro_torch.models.lm_graph.decode_lm_graph``, whose decode attention
runs the port's CUDA kernel), the chain (``serve``) and the limits of the
check.  Sessions go through ``InferenceEngine.generate``, greedy; the
wire is raw.  The weights are drawn on the device from the seed.

The check, after the window: the plain reference runs once over each
session's prompt and the tokens it was served.  The number compared is,
over every token served, ``max |served - reference| / max |reference|`` of
the logits the engine returned for that token (the prefill's for the
first, each step's after): the logits the client took the token from,
recorded as the engine's futures resolve.  The widest gap by which a
served token's logit lies below the reference's best is not compared:
TF32, the control, moves the argmax at about one served token in three
hundred, so its readings include 0 (PERF.md).
"""
from __future__ import annotations

import dataclasses
import gc
import math
from collections import defaultdict

import numpy as np
import torch

from bench.harness import compare
from bench.harness import weights as W
from bench.harness.result import Check
from bench.reference import decoder as ref


def leaves(m: dict) -> list:
    d, f, v = m["d_model"], m["d_ff"], m["vocab"]
    hq, hk = m["num_heads"] * m["head_dim"], m["kv_heads"] * m["head_dim"]
    scale = ("uniform", 0.5, 1.5)

    def w(din, dout):
        return (din, dout), ("normal", float(1.0 / np.sqrt(din)))
    out = [(("embed", "table"), (v, d), ("normal", 1.0))]
    for i in range(m["n_layers"]):
        a, p = f"blk{i}_attn", f"blk{i}_mlp"
        out.append(((a, "ln", "scale"), (d,), scale))
        for k, (din, dout) in (("wq", (d, hq)), ("wk", (d, hk)),
                               ("wv", (d, hk)), ("wo", (hq, d))):
            out.append(((a, k, "w"), *w(din, dout)))
        out.append(((p, "ln", "scale"), (d,), scale))
        out.append(((p, "up", "w"), *w(d, f)))
        out.append(((p, "down", "w"), *w(f, d)))
    out.append((("head", "ln", "scale"), (d,), scale))
    out.append((("head", "out", "w"), *w(d, v)))
    return out


class ChainLM:
    kind = "sessions"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 setup: dict):
        import time

        from repro_torch.kernels import decode_attention
        from repro_torch.models import lm_graph
        from repro_torch.runtime import (DispatcherCodecs, InferenceEngine,
                                         TopologySpec, WireCodec)
        self.config, self.seed, self.device = config, seed, device
        self._da = decode_attention
        m, s = config["model"], config["serve"]
        self.vocab = m["vocab"]
        graph = lm_graph.decode_lm_graph(use_kernel=True, **m)
        t = time.perf_counter()
        params = W.to_host(W.draw(leaves(m), seed, device))
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

    def _record_logits(self) -> None:
        """Keep the logits each session's prefill and steps return, in
        the order they resolve (a session waits for each before the
        next)."""
        from repro_torch.runtime.wire import K_OPEN, K_STEP
        d = self.eng.dispatcher
        submit = d.submit

        def recording(x, client_id=0, **kw):
            fut = submit(x, client_id=client_id, **kw)
            if kw.get("session_kind") in (K_OPEN, K_STEP):
                out = self.logits[kw["session"]]
                fut.add_done_callback(
                    lambda f: f.exception() is None and out.append(
                        f.result()))
            return fut
        d.submit = recording

    # -- what the traffic generator calls ----------------------------------
    def generate(self, prompt: list[int], n: int, client: int, sid: str):
        return self.eng.generate(prompt, n, client_id=client, session_id=sid)

    def reset_window(self) -> None:
        self.eng.reset_window()
        self._base = self._kernel_counts()

    def report(self) -> dict:
        return dataclasses.asdict(self.eng.report())

    def _kernel_counts(self) -> dict:
        return {"launches": sum(self._da.launches.values()),
                "plain_calls": sum(self._da.plain_calls.values())}

    def counters(self) -> dict:
        now = self._kernel_counts()
        return {"decode_attention": {k: now[k] - self._base[k] for k in now}}

    def close(self) -> None:
        self.eng.shutdown()
        del self.eng
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------------
    def _judge(self, run, served) -> Check:
        """The logits check of ``served(session, params)``, the rows a
        session's served tokens were taken from ([tokens, vocab] on the
        device, or None where some are missing), against the reference's
        rows at the same positions."""
        m = self.config["model"]
        worst = 0.0
        with torch.inference_mode():
            params = W.draw(leaves(m), self.seed, self.device)
            for s in run.sessions:
                if not s.tokens:
                    continue
                y = served(s, params)
                err = (math.inf if y is None else compare.logits_err(
                    y, self._reference(params, s), None))
                worst = max(worst, err)
            del params
        return Check("logits_rel_err", worst,
                     self.config["limits"]["raw"]["logits_rel_err"])

    def _served(self, s, params) -> torch.Tensor | None:
        got = self.logits.get(s.sid, [])[:len(s.tokens)]
        if len(got) < len(s.tokens):
            return None
        return torch.from_numpy(np.stack([np.asarray(
            g, np.float32).reshape(-1) for g in got])).to(self.device)

    def check(self, run) -> list[Check]:
        checks = [self._judge(run, self._served),
                  Check("failed_sessions",
                        sum(s.error is not None for s in run.sessions), 0)]
        if self.device.type == "cuda":
            checks.append(Check(
                "decode_attention_plain_calls",
                run.counters["decode_attention"]["plain_calls"], 0))
        return checks

    def _reference(self, params, s, tf32: bool = False) -> torch.Tensor:
        """The reference's logits at each of session ``s``'s served
        tokens: the rows that predict them."""
        m = self.config["model"]
        seq = torch.tensor(s.prompt + s.tokens, device=self.device)
        z = ref.forward(params, seq, m["num_heads"], m["kv_heads"],
                        m["head_dim"], tf32=tf32)
        return z[len(s.prompt) - 1:len(s.prompt) - 1 + len(s.tokens)]

    def control(self, run) -> list[Check]:
        """The control, judged by the check: the plain reference in TF32
        in the program's place, serving each session's rows at the same
        prompts and served tokens."""
        return [self._judge(run, lambda s, params: self._reference(
            params, s, tf32=True))]


def build(config: dict, traffic: dict, seed: int, device, setup: dict):
    return ChainLM(config, traffic, seed, device, setup)
