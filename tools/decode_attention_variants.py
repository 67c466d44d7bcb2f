"""Time copies of decode attention's CUDA source with parts taken out, on one
NVIDIA GPU, to see where a call's device time goes.

    python3 tools/decode_attention_variants.py [--parent OLD.cu]

Each copy of ``src/repro_torch/kernels/csrc/decode_attention.cu`` is built
with the port's ``nvcc`` flags into its own library under
``src/repro_torch/kernels/_build/variants/`` (ignored by git), all copies
at once, and called through ctypes with the scratch the wrapper allocates.
Calls are timed as ``chip_smoke.py`` times the kernel (device ms per call,
CUDA-graph replay over inputs rotated past the 50 MB L2, f32, full
caches) at the zoo's shapes (``chip_smoke.DA_ZOO_TIMED``), every copy
twice, in turns.  The copies change the tiled form and the combine pass:

- ``source``: the source as it is, at the wrapper's split, half of it and
  twice it;
- ``first_pass``: without the combine pass;
- ``no_logits_pv``: without the combine pass and without the loops of the
  logits and of P.V (the ring, the softmax and the writes are left);
- ``three_stages``: the tiled form's ring with 3 stages.

``source`` and ``three_stages`` are checked against the wrapper's output;
the others compute wrong results on purpose.  With ``--parent``, another
version of the source is timed in turns beside them, called with
``SPLIT_C`` (the split of every form before the tiled form).  Prints one
JSON record per shape, with the card's name and power limit; needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402

TILED = ("// -- tiled form", "// -- shared-memory form")
COMBINE = "  combine_kernel<T><<<"
LOGITS = "c < chunks; c += kSlices)"
PV = "      if (d0 < hd) {\n#pragma unroll 2"


def _sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"decode_attention_variants: {old!r} is not in the "
                         "source once; update this tool")
    return text.replace(old, new)


def variants(src: str) -> dict[str, str]:
    """Name -> source of each copy."""
    a, b = src.index(TILED[0]), src.index(TILED[1])
    tiled = src[a:b]
    no_combine = _sub(src, COMBINE, "  if (0) combine_kernel<T><<<")
    bare = _sub(_sub(tiled, LOGITS, "c < 0; c += kSlices)"), PV,
                PV.replace("d0 < hd", "d0 < 0"))
    a2 = no_combine.index(TILED[0])
    staged = "constexpr int kTiledStages = 3;\n" + tiled.replace(
        "kStages", "kTiledStages")
    return {"source": src, "first_pass": no_combine,
            "no_logits_pv": no_combine[:a2] + bare + no_combine[a2 + len(tiled):],
            "three_stages": src[:a] + staged + src[b:]}


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log.decode()}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        lib.da_decode_f32.argtypes = [ctypes.c_void_p] * 8 + \
            [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        lib.da_decode_f32.restype = ctypes.c_int
        libs[name] = lib
    return libs


def caller(lib: ctypes.CDLL, split_c: int):
    """``da.decode_attention``'s launch through ``lib`` at ``split_c``."""
    def call(q, k, v, kpos, pos, window, scale):
        B, _, H, hd = q.shape
        C, kv = k.shape[1], k.shape[2]
        G, n = H // kv, -(-C // split_c)
        part_acc = torch.empty((B, kv, n, G, hd), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B, kv, n, G, 2), dtype=torch.float32,
                              device=q.device)
        out = torch.empty_like(q)
        err = lib.da_decode_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(),
            pos.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            out.data_ptr(), B, C, kv, G, hd, split_c,
            0 if window is None else window, scale,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with error {err}")
        return out
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another decode_attention.cu to time "
                                     "beside the copies")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_attention_variants: needs a CUDA card", file=sys.stderr)
        return 2
    card = cs.card_info()["nvidia_smi"]
    with open(os.path.join(_build.CSRC, "decode_attention.cu")) as f:
        sources = variants(f.read())
    if args.parent:
        with open(args.parent) as f:
            sources["parent"] = f.read()
    libs = build(sources)
    dev = torch.device("cuda", 0)
    for B, H, kv, hd, C in cs.DA_ZOO_TIMED:
        per = 4 * 2 * B * C * kv * hd
        nbuf = max(2, -(-(128 << 20) // per))
        sets = [cs._da_inputs(B, H, kv, hd, C, 100 + i, dev, valid=[C] * B)
                for i in range(nbuf)]
        kargs = [(q, k, v, kp, p, None, hd ** -0.5)
                 for q, k, v, kp, p in sets]
        sc = da.split_c(C, H // kv, hd)
        want = da.decode_attention(*kargs[0])
        fns = {f"source split {s}": caller(libs["source"], s)
               for s in (sc // 2, sc, 2 * sc)}
        fns.update({name: caller(libs[name], sc) for name in
                    ("first_pass", "no_logits_pv", "three_stages")})
        if "parent" in libs:
            fns[f"parent split {da.SPLIT_C}"] = caller(libs["parent"],
                                                       da.SPLIT_C)
        err = {name: float((fns[name](*kargs[0]) - want).abs().max())
               for name in fns if not name.startswith(("first", "no_"))}
        ms: dict[str, list[float]] = {}
        for _ in range(2):
            for name, fn in fns.items():
                ms.setdefault(name, []).append(cs._device_ms(fn, kargs))
        print(json.dumps({"shape": [B, H, kv, hd, C], "form": da.form(
            H // kv, hd), "split_c": sc, "ms": ms, "max_abs_err": err,
            "card": card}), flush=True)
        del sets, kargs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
