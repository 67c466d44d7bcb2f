"""Compute time a request spends in the stages: the sum over stages of
the engine's per-request ``compute_s`` (host clock around the apply, ending
in a synchronise), replicas weighted by the requests they served."""


def read(run):
    from bench.harness.readers import stage_sum
    v = stage_sum(run, lambda n: n["compute_s"])
    return None if v is None else v * 1e3
