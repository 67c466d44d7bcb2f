"""Codec time a request spends at the stages' hops: the sum over stages of
the engine's per-request ``serialize_s + deserialize_s``, replicas weighted
by the requests they served."""


def read(run):
    from bench.harness.readers import stage_sum
    v = stage_sum(run, lambda n: n["serialize_s"] + n["deserialize_s"])
    return None if v is None else v * 1e3
