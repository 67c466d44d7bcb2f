"""Host time a token's decode steps spend launching their work: the sum
over replicas of the engine's ``step_launch_s`` (each step apply, from the
call to its return, before its logits are copied out: the host enqueueing
the step's kernels), over window and drain, per token served (host clock,
the program's own readings, which its ``defer.s{i}.step.launch`` spans
close on)."""


def read(run):
    from bench.harness.spans import per_token_ms, replica_sum
    return per_token_ms(run, replica_sum(run, "step_launch_s"))
