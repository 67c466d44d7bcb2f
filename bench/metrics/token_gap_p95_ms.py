"""95th percentile of every gap between two consecutive tokens of a
session, both served within the window (host clock)."""


def read(run):
    from bench.harness.readers import p95_ms
    gaps = [b - a for s in run.sessions
            for a, b in zip(s.stamps, s.stamps[1:])
            if a >= run.t0 and b <= run.t_end]
    return p95_ms(gaps)
