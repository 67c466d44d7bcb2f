"""Tokens served within the window, per second of the window (host
clock): every session's tokens, the first of each included."""


def read(run):
    if not run.sessions:
        return None
    n = sum(1 for s in run.sessions for t in s.stamps
            if run.t0 <= t <= run.t_end)
    return n / run.window_s
