"""Kernels the card ran in the traced window per token served there."""


def read(run):
    from bench.harness.readers import kernels
    n = sum(1 for s in run.sessions for t in s.stamps if t >= run.t0)
    if run.trace is None or not n:
        return None
    return kernels(run) / n
