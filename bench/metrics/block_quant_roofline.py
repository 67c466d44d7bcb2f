"""Block quantization's share of its roofline on the path: the least time
the q8 wire's quantize and dequantize launches need, over their device
time in the trace.  Every answered request's leaves (the image, each leaf
crossing a cut, the logits) are quantized once and dequantized once; each
pass needs ``arith.block_quant_bytes(n)`` at HBM bandwidth."""

PATTERN = r"(?:^|[\s:])(?:de)?quant_kernel\b"


def read(run):
    from bench.harness import arith
    from bench.harness.readers import roofline_pct
    if run.traffic.get("wire") != "q8":
        return None
    m, s = run.config["model"], run.config["serve"]
    n = sum(1 for r in run.requests if r.done is not None)
    leaves = arith.resnet50_leaves(m["image"], m["num_classes"], s["cuts"])
    need = 2 * n * sum(arith.block_quant_bytes(k) for k in leaves)
    return roofline_pct(run, PATTERN, need / arith.HBM_BYTES_PER_S)
