"""Host time a token's decode waves spend held for their banks' due
residents: the sum over replicas of the engine's ``step_hold_s`` (each
wave's hold, from its start to the last step that joined it or its bound,
wall s), over window and drain, per token served (host clock, the
program's own readings, which its ``defer.s{i}.step.hold`` spans close on;
None where the program reports no holds)."""


def read(run):
    from bench.harness.spans import per_token_ms, replica_sum
    return per_token_ms(run, replica_sum(run, "step_hold_s"))
