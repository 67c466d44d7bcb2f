"""CPU time this process spent, window and drain, per request answered or
per token served (host clock: ``time.process_time``): the host's work,
threads that poll included; a traced run counts the profiler's own work
in it too."""


def read(run):
    cpu = run.cpu_s
    if run.sessions:
        n = sum(len(s.tokens) for s in run.sessions)
    else:
        n = sum(1 for r in run.requests if r.done is not None)
    if cpu is None or not n:
        return None
    return cpu * 1e3 / n
