"""Host time a token's decode steps spend copying the session caches: the
sum over replicas of the engine's ``step_stack_s`` (the wave's caches
stacked, its tokens and positions copied in) and ``step_unstack_s`` (each
row's new caches cut out and stored), over window and drain, per token
served (host clock, the program's own readings, which its
``defer.s{i}.step.stack`` and ``.step.unstack`` spans close on)."""


def read(run):
    from bench.harness.spans import per_token_ms, replica_sum
    stack = replica_sum(run, "step_stack_s")
    unstack = replica_sum(run, "step_unstack_s")
    if stack is None or unstack is None:
        return None
    return per_token_ms(run, stack + unstack)
