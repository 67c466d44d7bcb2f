"""CPU time of the chain's own threads (stages, routers, pump, collector),
window and drain, per token served: the engine's ``thread_cpu_s``
summed, each thread's clock read at the window's reset and at the report
(``host_cpu_ms.decode`` counts the whole process over the same span)."""


def read(run):
    from bench.harness.spans import per_token_ms
    cpu = (run.report or {}).get("thread_cpu_s")
    if not cpu:
        return None
    return per_token_ms(run, sum(cpu.values()))
