"""Requests answered within the window, per second of the window (host
clock)."""


def read(run):
    from bench.harness.readers import answered_in_window
    if not run.requests:
        return None
    return answered_in_window(run) / run.window_s
