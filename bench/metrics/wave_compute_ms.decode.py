"""Compute time of one decode wave through the chain: the sum over stages
of the engine's per-request ``compute_s`` times its ``batch_mean``,
replicas weighted by the requests they served."""


def read(run):
    from bench.harness.readers import stage_sum
    v = stage_sum(run, lambda n: n["compute_s"] * n["batch_mean"])
    return None if v is None else v * 1e3
