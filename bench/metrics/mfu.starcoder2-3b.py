"""The whole decode chain's share of the card's f32 peak: for every
prompt token prefilled and every token decoded in the traced window (a
session that began before it counts its decoded tokens only), 2
operations per weight it multiplies and attention's over the positions it
attends (``arith.decoder_token_flops``), over the window's length times 67
TFLOP/s.  Padding rows of a decode step are not useful work and do not
count."""


def read(run):
    from bench.harness import arith
    if run.trace is None or not run.sessions:
        return None
    m = run.config["model"]
    ops = 0.0
    for s in run.sessions:
        L = len(s.prompt)
        if s.tokens and s.start >= run.t0:
            ops += sum(arith.decoder_token_flops(m, p) for p in range(L))
        ops += sum(arith.decoder_token_flops(m, L + i - 1)
                   for i in range(1, len(s.tokens))
                   if s.stamps[i] >= run.t0)
    return 100.0 * ops / (run.trace.window_s * arith.F32_FLOPS)
