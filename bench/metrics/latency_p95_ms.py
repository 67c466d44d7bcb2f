"""95th percentile of every request sent in the window: from its send time
(its scheduled send time in an open loop) to its result (host clock)."""


def read(run):
    from bench.harness.readers import latencies, p95_ms
    return p95_ms(latencies(run))
