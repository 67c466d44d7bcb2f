"""The whole chain's share of the card's f32 peak: ResNet50's operations
(convolutions and the fully connected layer, ``arith.resnet50_flops``) for
every request answered in the traced window, over the window's length
times 67 TFLOP/s."""


def read(run):
    from bench.harness import arith
    if run.trace is None or not run.requests:
        return None
    m = run.config["model"]
    n = sum(1 for r in run.requests if r.done is not None)
    ops = n * arith.resnet50_flops(m["image"], m["num_classes"])
    return 100.0 * ops / (run.trace.window_s * arith.F32_FLOPS)
