"""Time a token's decode step spends in queues, admission to result: the
engine's ``step_wait_s`` summed over its queues (admission, each stage's
inbox, to_compute and to_encode, the result channel; each step envelope's
put to its take, as its ``defer.wait.*`` spans), over window and drain,
per token served (host clock)."""


def read(run):
    from bench.harness.spans import per_token_ms
    waits = (run.report or {}).get("step_wait_s")
    if not waits:
        return None
    return per_token_ms(run, sum(waits.values()))
