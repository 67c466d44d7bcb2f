"""Share of the rows the decode steps ran that served a session: the
engine's ``step_live_rows`` summed over replicas, over their
``step_rows_run`` (every step runs ``decode_step_rows`` rows of its
replica's cache pool, whether or not their sessions step in it), over
window and drain, in percent (the program's own counters; None where it
reports neither)."""


def read(run):
    from bench.harness.spans import replica_sum
    live = replica_sum(run, "step_live_rows")
    ran = replica_sum(run, "step_rows_run")
    if live is None or not ran:
        return None
    return 100.0 * live / ran
