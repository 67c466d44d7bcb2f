"""System under test: a CNN served through DEFER's chain.

The configuration names the model (``model``), the chain (``serve``: the
stage count, the pinned cuts, the replicas of each stage, ``max_batch``)
and the limits of the check; the traffic mix names the data codec of the
wire (``wire``: ``raw`` or ``q8``).  The program's
``InferenceEngine(device=...)`` serves over ``inproc`` channels; its
weights and the images are drawn on the device from the seed.

The check, after the window: every answered request's logits against the
plain reference on the same image and weights, which quantizes where the
wire does (the input and each leaf that crosses a cut, each request on its
own) when the wire is ``q8``.  The number compared is the largest
``max(|served - reference| - step / 2) / max |reference|`` over the
requests, ``step`` the q8 last hop's step at each value, read from the
served row (``bench/harness/compare.py``), or 0 on the raw wire.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from bench.harness import compare
from bench.harness import weights as W
from bench.harness.load import stream_seed
from bench.harness.result import Check
from bench.reference import resnet50 as ref
from bench.reference.blockquant import roundtrip

IMAGES = 128            # distinct images; request i sends image i mod 128


def leaves(classes: int) -> list:
    out = []
    for layer, p in ref.param_shapes(classes).items():
        for k, shape in p.items():
            if k == "w":
                fan_in = int(np.prod(shape[:-1]))
                law = ("normal", float(np.sqrt(2.0 / fan_in)))
            elif k == "scale":
                law = ("uniform", 0.5, 1.0)
            else:
                law = ("normal", 0.1)
            out.append(((layer, k), shape, law))
    return out


def images(seed: int, image: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, 2))
    return torch.randn((IMAGES, image, image, 3), generator=gen,
                       device=device)


class ChainCNN:
    kind = "requests"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 setup: dict):
        import time

        from repro_torch.kernels import block_quant
        from repro_torch.models import cnn
        from repro_torch.runtime import (DispatcherCodecs, InferenceEngine,
                                         TopologySpec, WireCodec)
        self.config, self.seed, self.device = config, seed, device
        self.wire = traffic["wire"]
        self._bq = block_quant
        m, s = config["model"], config["serve"]
        graph = getattr(cnn, m["arch"])(batch=1, image=m["image"],
                                        num_classes=m["num_classes"])
        t = time.perf_counter()
        params = W.to_host(W.draw(leaves(m["num_classes"]), seed, device))
        # the graph's parameter-less layers take empty trees
        params = {n.name: params.get(n.name, {}) for n in graph.nodes}
        pool = images(seed, m["image"], device)
        self.images = pool.cpu().numpy()
        del pool
        setup["weights_s"] = time.perf_counter() - t
        spec = TopologySpec.chain(graph, s["stages"], cuts=s["cuts"],
                                  replicas=s["replicas"])
        self.cuts = tuple(spec.cuts)
        codec = (WireCodec("q8", "none") if self.wire == "q8"
                 else WireCodec("raw", "none"))
        self.eng = InferenceEngine(graph, spec, DispatcherCodecs(
            data=codec, weights=WireCodec("raw", "none")),
            max_batch=s["max_batch"], device=device)
        t = time.perf_counter()
        self.eng.configure(params)
        setup["configure_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.eng.precompile()
        self.eng.start()
        setup["precompile_s"] = time.perf_counter() - t
        self._base = {}

    # -- what the traffic generator calls ----------------------------------
    def request_input(self, i: int) -> np.ndarray:
        return self.images[i % IMAGES][None]

    def submit(self, x: np.ndarray, client: int):
        return self.eng.submit(x, client_id=client)

    def reset_window(self) -> None:
        self.eng.reset_window()
        self._base = {k: dict(v) for k, v in self._kernel_counts().items()}

    def report(self) -> dict:
        import dataclasses
        return dataclasses.asdict(self.eng.report())

    def _kernel_counts(self) -> dict:
        return {"launches": dict(self._bq.launches),
                "plain_calls": dict(self._bq.plain_calls)}

    def counters(self) -> dict:
        now = self._kernel_counts()
        return {"block_quant": {
            k: sum(now[k].values()) - sum(self._base[k].values())
            for k in now}}

    def close(self) -> None:
        self.eng.shutdown()
        del self.eng
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------------
    def _logits(self, want: list[int], tf32: bool = False) -> dict:
        """The reference's logits of images ``want``, by image, on the
        device: before the last hop, with the q8 wire's rounding of the
        input and of each cut where the wire is q8."""
        m = self.config["model"]
        out = {}
        with torch.inference_mode():
            params = W.draw(leaves(m["num_classes"]), self.seed, self.device)
            pool = images(self.seed, m["image"], self.device)
            for lo in range(0, len(want), 16):
                idx = want[lo:lo + 16]
                z = ref.forward(params, pool[idx], cuts=self.cuts,
                                q8=self.wire == "q8", tf32=tf32)
                out.update(zip(idx, z))
            del params, pool
        return out

    def _judge(self, answered, served: dict, refs: dict) -> Check:
        """The logits check of the rows ``served`` gives the requests
        ``answered`` (by request index), against the reference's by
        image."""
        limit = self.config["limits"][self.wire]["logits_rel_err"]
        if not answered:
            return Check("logits_rel_err", 0.0, limit)
        y = torch.stack([torch.as_tensor(
            np.asarray(served[r.index], np.float32).reshape(-1))
            for r in answered]).to(self.device)
        z = torch.stack([refs[r.index % IMAGES] for r in answered])
        steps = None
        if self.wire == "q8":
            s = self.config["serve"]
            steps = compare.tile_steps(y, compare.wave_offsets(
                self.config["model"]["num_classes"], s["max_batch"]))
        return Check("logits_rel_err", compare.logits_err(y, z, steps),
                     limit)

    def check(self, run) -> list[Check]:
        answered = [r for r in run.requests if r.out is not None]
        refs = self._logits(sorted({r.index % IMAGES for r in answered}))
        checks = [self._judge(answered, {r.index: r.out for r in answered},
                              refs),
                  Check("unanswered", len(run.requests) - len(answered), 0)]
        if self.wire == "q8" and self.device.type == "cuda":
            checks.append(Check("block_quant_plain_calls",
                                run.counters["block_quant"]["plain_calls"],
                                0))
        return checks

    def control(self, run) -> list[Check]:
        """The control, judged by the check: the plain reference in TF32
        (every product's operands rounded to 10 mantissa bits) in the
        program's place, serving each answered request its logits, through
        the q8 wire's last hop (each request alone) where the wire is
        q8."""
        answered = [r for r in run.requests if r.out is not None]
        want = sorted({r.index % IMAGES for r in answered})
        refs = self._logits(want)
        low = self._logits(want, tf32=True)
        if self.wire == "q8":
            low = {i: roundtrip(v) for i, v in low.items()}
        served = {r.index: low[r.index % IMAGES].cpu().numpy()
                  for r in answered}
        return [self._judge(answered, served, refs)]


def build(config: dict, traffic: dict, seed: int, device, setup: dict):
    return ChainCNN(config, traffic, seed, device, setup)
