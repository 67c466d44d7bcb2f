"""The yardstick's arithmetic: the card's peaks, the operations of the
models, and the bytes and operations a kernel launch needs.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit: 67
TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM3.  A card
set to a lower power limit reaches less; every result names the card and
its limit beside these shares.
"""
from __future__ import annotations

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# -- ResNet50 -------------------------------------------------------------------

_R50 = [(3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2), (3, 512, 2048, 2)]


def _out(n: int, s: int) -> int:
    return -(-n // s)


def resnet50_flops(image: int = 224, classes: int = 1000) -> float:
    """Multiply-adds x 2 of one image through ResNet50's convolutions and
    its fully connected layer (the folded batch norm, ReLU, pooling and
    residual adds are not counted)."""
    h = _out(image, 2)
    total = 2.0 * h * h * 64 * 7 * 7 * 3
    h = _out(h, 2)
    cin = 64
    for blocks, cmid, cout, stride in _R50:
        for b in range(blocks):
            s = stride if b == 0 else 1
            hh = _out(h, s)
            total += 2.0 * h * h * cmid * cin            # 1x1 in
            total += 2.0 * hh * hh * cmid * 9 * cmid     # 3x3
            total += 2.0 * hh * hh * cout * cmid         # 1x1 out
            if b == 0:
                total += 2.0 * hh * hh * cout * cin      # projection
            cin, h = cout, hh
    return total + 2.0 * cin * classes


# -- the decoder --------------------------------------------------------------------

def decoder_matmul_params(d_model: int, n_layers: int, num_heads: int,
                          kv_heads: int, head_dim: int, d_ff: int,
                          vocab: int, **_) -> int:
    """Weights that a token multiplies: the projections, the MLP and the
    output head (the embedding is a gather)."""
    attn = d_model * head_dim * (2 * num_heads + 2 * kv_heads)
    return n_layers * (attn + 2 * d_model * d_ff) + d_model * vocab


def decoder_token_flops(cfg: dict, position: int) -> float:
    """Operations of one token at ``position`` (0-based): 2 per weight it
    multiplies, and attention's 4 * heads * head_dim per position it
    attends (itself and every earlier one) in each layer."""
    attend = 4.0 * cfg["num_heads"] * cfg["head_dim"] * (position + 1)
    return 2.0 * decoder_matmul_params(**cfg) + cfg["n_layers"] * attend


# -- kernel bounds -------------------------------------------------------------------

def block_quant_bytes(n: int) -> int:
    """Bytes that quantizing n values needs: n f32 read, n int8 and one
    f32 scale per tile of 1,024 written.  Dequantizing moves the same."""
    return 4 * n + n + 4 * (-(-n // 1024))


def decode_attention_need(valid: int, num_heads: int, kv_heads: int,
                          head_dim: int) -> tuple[float, float]:
    """(bytes, operations) that one row of one decode-attention call needs
    over ``valid`` cache slots: K and V of the valid slots and their
    positions read, q read and the output written (f32); the scores and the
    weighted sum, 2 operations per multiply-add each."""
    nbytes = (valid * (2 * kv_heads * head_dim * 4 + 4)
              + 2 * num_heads * head_dim * 4)
    ops = 4.0 * num_heads * head_dim * valid
    return nbytes, ops


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card needs: bytes at HBM bandwidth or operations
    at the f32 peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)


def resnet50_leaves(image: int, classes: int, cuts) -> list[int]:
    """Values of each leaf a batch-1 request sends over a chain cut at
    ``cuts`` (layer indices): the image, every activation that crosses a
    cut, and the logits."""
    from bench.reference.resnet50 import layers
    plan = layers()
    hw, ch = {"": image}, {"": 3}
    for name, op, ins, at in plan:
        h = hw[ins[0]]
        hw[name] = {"conv": _out(h, at.get("s", 1)), "maxpool": _out(h, 2),
                    "mean": 1, "fc": 1}.get(op, h)
        ch[name] = (_conv_out(name) if op == "conv" else
                    classes if op == "fc" else ch[ins[0]])
    shape = {n: hw[n] * hw[n] * ch[n] for n in hw}
    sizes = [shape[""]]
    for c in cuts:
        later = {n for _, _, ins, _ in plan[c:] for n in ins}
        done = {""} | {n for n, _, _, _ in plan[:c]}
        sizes += [shape[n] for n in [""] + [p[0] for p in plan[:c]]
                  if n in later & done]
    return sizes + [classes]


def _conv_out(name: str) -> int:
    if name == "stem":
        return 64
    si, part = int(name[1]), name.split("_")[1]
    _, cmid, cout, _ = _R50[si]
    return cmid if part in ("c1", "c2") else cout
