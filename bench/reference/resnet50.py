"""ResNet50 (He et al., arXiv:1512.03385) in plain PyTorch: the inference
form with batch norm folded into a per-channel scale and bias.

The benchmark's plain reference for the ``resnet50`` configuration.  It
imports nothing of the program.  Inputs are NHWC images; weights are the
benchmark's own tree, named by layer (``stem``, ``s{stage}b{block}_c1`` ..
``_c3``, ``_sc`` for a projection shortcut, ``fc``), each convolution
kernel HWIO.  Padding is TF-style SAME: ``total = max((ceil(n/s) - 1)*s +
k - n, 0)``, split ``(total // 2, total - total // 2)``, so asymmetric at
stride 2; the 3x3 max pool pads with -inf.

``forward`` runs the 72 layers in order.  With ``cuts`` and ``q8`` it
also does what a wire in block quantization does to the activations: the
input and every activation that crosses a cut (the cut after layer i sends
every output of layers <= i that a layer > i reads) pass through
:func:`blockquant.roundtrip`, each request's on its own (each of these
leaves holds a whole number of tiles a request).  The logits come out as
the last stage computes them, before the last hop.  With ``tf32`` every operand of a
convolution and of the fully connected layer is first rounded to TF32
(10 mantissa bits), the products accumulating in f32: the lower
precision that the benchmark's control runs in.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference import blockquant

STAGES = [(3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2),
          (3, 512, 2048, 2)]


def layers() -> list[tuple[str, str, tuple[str, ...], dict]]:
    """The 72 layers as (name, op, inputs, attributes), in order; the
    input image is ``""``."""
    out = [("stem", "conv", ("",), dict(k=7, s=2, relu=True)),
           ("stem_pool", "maxpool", ("stem",), {})]
    prev = "stem_pool"
    for si, (blocks, _, _, stride0) in enumerate(STAGES):
        for bi in range(blocks):
            s = stride0 if bi == 0 else 1
            b = f"s{si}b{bi}"
            out.append((f"{b}_c1", "conv", (prev,), dict(k=1, s=1, relu=True)))
            out.append((f"{b}_c2", "conv", (f"{b}_c1",),
                        dict(k=3, s=s, relu=True)))
            out.append((f"{b}_c3", "conv", (f"{b}_c2",),
                        dict(k=1, s=1, relu=False)))
            short = prev
            if bi == 0:
                out.append((f"{b}_sc", "conv", (prev,),
                            dict(k=1, s=s, relu=False)))
                short = f"{b}_sc"
            out.append((f"{b}_add", "add_relu", (f"{b}_c3", short), {}))
            prev = f"{b}_add"
    out.append(("gap", "mean", (prev,), {}))
    out.append(("fc", "fc", ("gap",), {}))
    return out


def param_shapes(num_classes: int = 1000) -> dict[str, dict[str, tuple]]:
    """Every weight's shape by layer: convolutions ``w`` (HWIO), ``scale``
    and ``bias``; the fully connected layer ``w`` (in, out) and ``b``."""
    shapes: dict[str, dict[str, tuple]] = {
        "stem": {"w": (7, 7, 3, 64), "scale": (64,), "bias": (64,)}}
    cin = 64
    for si, (blocks, cmid, cout, _) in enumerate(STAGES):
        for bi in range(blocks):
            b = f"s{si}b{bi}"
            for name, k, ci, co in ((f"{b}_c1", 1, cin, cmid),
                                    (f"{b}_c2", 3, cmid, cmid),
                                    (f"{b}_c3", 1, cmid, cout)):
                shapes[name] = {"w": (k, k, ci, co), "scale": (co,),
                                "bias": (co,)}
            if bi == 0:
                shapes[f"{b}_sc"] = {"w": (1, 1, cin, cout),
                                     "scale": (cout,), "bias": (cout,)}
            cin = cout
    shapes["fc"] = {"w": (cin, num_classes), "b": (num_classes,)}
    return shapes


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to the nearest value with 10 mantissa bits (ties away
    from zero), as TF32 holds it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _same(n: int, k: int, s: int) -> tuple[int, int]:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    (t, b), (lft, r) = _same(x.shape[2], k, s), _same(x.shape[3], k, s)
    return F.pad(x, (lft, r, t, b), value=value)


def forward(params: dict, x: torch.Tensor, cuts: tuple[int, ...] = (),
            q8: bool = False, tf32: bool = False) -> torch.Tensor:
    """Logits [B, classes] of NHWC images ``x`` [B, H, W, 3] (f32).

    ``params`` holds torch tensors on ``x``'s device.  ``cuts`` are layer
    indices: a cut c lies between layers c - 1 and c.  ``q8`` quantizes
    the input and what crosses each cut, per request (each row of the
    batch on its own)."""
    plan = layers()
    rnd = _tf32 if tf32 else (lambda t: t)

    def wire(t: torch.Tensor, nhwc: bool) -> torch.Tensor:
        if not q8:
            return t
        t = t.permute(0, 2, 3, 1) if nhwc else t
        t = torch.stack([blockquant.roundtrip(r) for r in t])
        return t.permute(0, 3, 1, 2).contiguous() if nhwc else t

    acts = {"": wire(x.permute(0, 3, 1, 2).contiguous(), True)}
    for i, (name, op, inputs, at) in enumerate(plan):
        if i in cuts:
            later = {n for _, _, ins, _ in plan[i:] for n in ins}
            for src in later & set(acts):
                acts[src] = wire(acts[src], True)
        a = acts[inputs[0]]
        p = params.get(name, {})
        if op == "conv":
            w = p["w"].permute(3, 2, 0, 1)
            y = F.conv2d(rnd(_pad(a, at["k"], at["s"])), rnd(w),
                         stride=at["s"])
            y = y * p["scale"][:, None, None] + p["bias"][:, None, None]
            y = torch.relu(y) if at["relu"] else y
        elif op == "maxpool":
            y = F.max_pool2d(_pad(a, 3, 2, float("-inf")), 3, 2)
        elif op == "add_relu":
            y = torch.relu(a + acts[inputs[1]])
        elif op == "mean":
            y = a.mean(dim=(2, 3))
        else:
            y = rnd(a) @ rnd(p["w"]) + p["b"]
        acts[name] = y
    return acts["fc"]
