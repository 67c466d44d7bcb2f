"""The paper's own evaluation models — VGG16 / VGG19 / ResNet50 — as
:class:`LayerGraph`s in PyTorch (the twin of ``repro.models.cnn``).

Activations are NHWC at every layer boundary and weights keep the
reference's names and HWIO layout in the params tree, so wire frames and
weight blobs are interchangeable with the JAX package.  Each convolution's
``prepare`` hook turns its HWIO kernel into an OIHW ``channels_last``
tensor once, when a node adopts its weights; at call time the NHWC
activation is viewed as NCHW with ``permute`` (already ``channels_last``
in memory, so no copy) and the result is viewed back.

Padding follows the reference's TF-style "SAME": ``pad_total =
max((ceil(n/s) - 1)·s + k - n, 0)``, split ``(total//2, total - total//2)``,
which is asymmetric at stride 2 — so it is applied explicitly with
``F.pad`` rather than through ``padding=`` (which torch refuses, or
makes symmetric, at stride > 1).
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.graph import (LayerGraph, TensorSpec, to_tensor,
                                    tree_flatten_with_path, tree_map)

F32 = np.dtype(np.float32)


def _sds(shape):
    return TensorSpec(tuple(shape), F32)


# -- layout + padding helpers ----------------------------------------------------

def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x_nchw: torch.Tensor, k: int, s: int,
              value: float = 0.0) -> torch.Tensor:
    h, w = x_nchw.shape[2], x_nchw.shape[3]
    ph, pw = _same_pads(h, k, s), _same_pads(w, k, s)
    if ph == (0, 0) and pw == (0, 0):
        return x_nchw
    return F.pad(x_nchw, (pw[0], pw[1], ph[0], ph[1]), value=value)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def prepare_conv(p: dict, device: torch.device) -> dict:
    """HWIO numpy kernel -> OIHW ``channels_last`` tensor (once per
    weight adoption); every other leaf becomes a tensor as it is."""
    out = {k: to_tensor(v, device) for k, v in p.items()}
    out["w"] = out["w"].permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    return out


def _conv(p, x, stride, padding):
    xn = _nchw(x)
    k = p["w"].shape[-1]
    if padding == "SAME":
        xn = _pad_same(xn, k, stride)
    return _nhwc(F.conv2d(xn, p["w"], stride=stride))


# -- layer apply fns (params, *inputs) -> output ---------------------------------

def conv_apply(p, x, *, stride, padding):
    return _conv(p, x, stride, padding) + p["b"]


def conv_bn_relu_apply(p, x, *, stride, padding, relu=True):
    y = _conv(p, x, stride, padding) * p["scale"] + p["bias"]   # folded BN
    return torch.relu(y) if relu else y


def relu_apply(p, x):
    return torch.relu(x)


def add_relu_apply(p, a, b):
    return torch.relu(a + b)


def maxpool_apply(p, x, *, size, stride):
    xn = _nchw(x)
    if size == 3:                                   # SAME, -inf padding
        xn = _pad_same(xn, size, stride, value=float("-inf"))
    return _nhwc(F.max_pool2d(xn, size, stride))


def gap_apply(p, x):
    return x.mean(dim=(1, 2))


def flatten_apply(p, x):
    return x.reshape(x.shape[0], -1)


def fc_apply(p, x, *, relu):
    y = x @ p["w"] + p["b"]
    return torch.relu(y) if relu else y


# -- cost helpers ------------------------------------------------------------------

def conv_flops(out_shape, k, cin):
    n = int(np.prod(out_shape))
    return 2.0 * n * k * k * cin


def fc_flops(batch, din, dout):
    return 2.0 * batch * din * dout


# -- VGG ---------------------------------------------------------------------------

_VGG16_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512, "M"]
_VGG19_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
               512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


def _build_vgg(name: str, plan, batch: int = 1, image: int = 224,
               num_classes: int = 1000) -> LayerGraph:
    g = LayerGraph(name, _sds((batch, image, image, 3)))
    h, w, cin = image, image, 3
    prev = ""
    ci = 0
    for item in plan:
        if item == "M":
            h //= 2
            w //= 2
            nname = f"pool{ci}"
            g.layer(nname, functools.partial(maxpool_apply, size=2, stride=2),
                    {}, (prev,), _sds((batch, h, w, cin)), flops=0.0)
        else:
            cout = item
            nname = f"conv{ci}"
            spec = {"w": _sds((3, 3, cin, cout)), "b": _sds((cout,))}
            g.layer(nname, functools.partial(conv_apply, stride=1, padding="SAME"),
                    spec, (prev,), _sds((batch, h, w, cout)),
                    flops=conv_flops((batch, h, w, cout), 3, cin),
                    prepare=prepare_conv)
            # relu fused into a separate cheap node keeps layer-wise cuts
            g.layer(f"relu{ci}", relu_apply, {}, (nname,),
                    _sds((batch, h, w, cout)), flops=0.0)
            nname = f"relu{ci}"
            cin = cout
        prev = nname
        ci += 1
    g.layer("flatten", flatten_apply, {}, (prev,),
            _sds((batch, h * w * cin)), flops=0.0)
    dims = [h * w * cin, 4096, 4096, num_classes]
    prev = "flatten"
    for i in range(3):
        spec = {"w": _sds((dims[i], dims[i + 1])), "b": _sds((dims[i + 1],))}
        g.layer(f"fc{i}", functools.partial(fc_apply, relu=i < 2), spec, (prev,),
                _sds((batch, dims[i + 1])), flops=fc_flops(batch, dims[i], dims[i + 1]))
        prev = f"fc{i}"
    return g


def vgg16(batch: int = 1) -> LayerGraph:
    return _build_vgg("vgg16", _VGG16_PLAN, batch)


def vgg19(batch: int = 1) -> LayerGraph:
    return _build_vgg("vgg19", _VGG19_PLAN, batch)


# -- ResNet50 ------------------------------------------------------------------------

_R50_STAGES = [(3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2),
               (3, 512, 2048, 2)]


def resnet50(batch: int = 1, image: int = 224, num_classes: int = 1000
             ) -> LayerGraph:
    g = LayerGraph("resnet50", _sds((batch, image, image, 3)))
    h = w = image // 2
    # stem
    spec = {"w": _sds((7, 7, 3, 64)), "scale": _sds((64,)), "bias": _sds((64,))}
    g.layer("stem", functools.partial(conv_bn_relu_apply, stride=2, padding="SAME"),
            spec, ("",), _sds((batch, h, w, 64)),
            flops=conv_flops((batch, h, w, 64), 7, 3), prepare=prepare_conv)
    h //= 2
    w //= 2
    g.layer("stem_pool", functools.partial(maxpool_apply, size=3, stride=2),
            {}, ("stem",), _sds((batch, h, w, 64)), flops=0.0)
    prev, cin = "stem_pool", 64

    def bn_conv(name, inp, k, cout, stride, relu, hh, ww, ci):
        spec = {"w": _sds((k, k, ci, cout)), "scale": _sds((cout,)),
                "bias": _sds((cout,))}
        g.layer(name,
                functools.partial(conv_bn_relu_apply, stride=stride,
                                  padding="SAME", relu=relu),
                spec, (inp,), _sds((batch, hh, ww, cout)),
                flops=conv_flops((batch, hh, ww, cout), k, ci),
                prepare=prepare_conv)
        return name

    for si, (blocks, cmid, cout, stride0) in enumerate(_R50_STAGES):
        for bi in range(blocks):
            stride = stride0 if bi == 0 else 1
            hh, ww = h // stride, w // stride
            base = f"s{si}b{bi}"
            a = bn_conv(f"{base}_c1", prev, 1, cmid, 1, True, h, w, cin)
            b = bn_conv(f"{base}_c2", a, 3, cmid, stride, True, hh, ww, cmid)
            c = bn_conv(f"{base}_c3", b, 1, cout, 1, False, hh, ww, cmid)
            if bi == 0:
                sc = bn_conv(f"{base}_sc", prev, 1, cout, stride, False, hh, ww, cin)
            else:
                sc = prev
            g.layer(f"{base}_add", add_relu_apply, {}, (c, sc),
                    _sds((batch, hh, ww, cout)), flops=0.0)
            prev, cin, h, w = f"{base}_add", cout, hh, ww
    g.layer("gap", gap_apply, {}, (prev,), _sds((batch, cin)), flops=0.0)
    g.layer("fc", functools.partial(fc_apply, relu=False),
            {"w": _sds((cin, num_classes)), "b": _sds((num_classes,))},
            ("gap",), _sds((batch, num_classes)),
            flops=fc_flops(batch, cin, num_classes))
    return g


BUILDERS = {"resnet50": resnet50, "vgg16": vgg16, "vgg19": vgg19}


# -- weights -------------------------------------------------------------------------

def params_from_jax(params: Any, graph: LayerGraph) -> dict:
    """The reference package's params (a nested dict of arrays that
    ``np.asarray`` converts) -> the port's: the same names, HWIO layout
    and float32 numpy arrays, checked leaf by leaf against ``graph``'s
    ``param_spec``.  After this the two packages compute the same
    function, and ``engine.configure()`` ships the result unchanged."""
    out: dict[str, Any] = {}
    for node in graph.nodes:
        want = dict(tree_flatten_with_path(node.param_spec))
        if not want:
            out[node.name] = {}
            continue
        if node.name not in params:
            raise KeyError(f"params lack layer {node.name!r}")
        conv = tree_map(np.asarray, dict(params[node.name]))
        have = dict(tree_flatten_with_path(conv))
        if set(have) != set(want):
            raise ValueError(
                f"layer {node.name!r}: leaves {sorted(have)} != "
                f"spec {sorted(want)}")
        for path, spec in want.items():
            arr = have[path]
            if tuple(arr.shape) != spec.shape:
                raise ValueError(
                    f"layer {node.name!r} leaf {path}: shape "
                    f"{tuple(arr.shape)} != spec {spec.shape}")
        out[node.name] = tree_map(
            lambda a: np.ascontiguousarray(a, dtype=np.float32), conv)
    return out
