"""Decode attention's share of its roofline on the path: the least time
its launches need, over their device time in the trace.  Token i >= 1 of
a session with an L-token prompt is decoded at position L + i - 1 and
attends L + i valid slots in each layer; only those slots of the real rows
count (no padding row, no empty slot), for the tokens served in the
traced window; bytes at HBM bandwidth or
operations at the f32 peak, whichever is longer."""

PATTERN = r"(?:^|[\s:])(?:reg_split|tiled_split|split|combine)_kernel\b"


def read(run):
    from bench.harness import arith
    from bench.harness.readers import roofline_pct
    if not run.sessions:
        return None
    m = run.config["model"]
    need = 0.0
    for s in run.sessions:
        L = len(s.prompt)
        for i in range(1, len(s.tokens)):
            if s.stamps[i] < run.t0:
                continue
            need += arith.bound_s(*arith.decode_attention_need(
                L + i, m["num_heads"], m["kv_heads"], m["head_dim"]))
    return roofline_pct(run, PATTERN, need * m["n_layers"])
