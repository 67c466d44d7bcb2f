"""The whole decode chain's share of the card's f32 peak in the
``mellum2-12b-chain`` cell: for every prompt token prefilled and every
token decoded in the traced window (a session that began before it counts
its decoded tokens only), ``moe_arith.token_flops`` (the held experts'
routed work at their share of the top-k, attention over the positions
attended, window-capped on sliding layers), over the window's length
times 67 TFLOP/s.  Padding rows of a decode step, and the held experts a
step runs over rows that did not choose them, are not useful work and do
not count."""


def read(run):
    from bench.harness import arith, moe_arith
    if run.trace is None or not run.sessions:
        return None
    cfg = run.config
    ops = 0.0
    for s in run.sessions:
        L = len(s.prompt)
        if s.tokens and s.start >= run.t0:
            ops += sum(moe_arith.token_flops(cfg, p) for p in range(L))
        ops += sum(moe_arith.token_flops(cfg, L + i - 1)
                   for i in range(1, len(s.tokens))
                   if s.stamps[i] >= run.t0)
    return 100.0 * ops / (run.trace.window_s * arith.F32_FLOPS)
