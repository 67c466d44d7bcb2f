"""Prefill time through the chain per 1,000 prompt tokens: for each
stage, its replicas' ``prefill_s`` (the window totals of their
``defer.s{i}.prefill`` spans, each session open's copy to the host
included) over their ``prefill_tokens``, summed over stages, window and
drain (the program's own totals; None where it reports none)."""


def read(run):
    by_stage: dict[int, list[float]] = {}
    for n in (run.report or {}).get("per_node", []):
        if "prefill_s" in n:
            t = by_stage.setdefault(n["stage"], [0.0, 0])
            t[0] += n["prefill_s"]
            t[1] += n["prefill_tokens"]
    if not by_stage or not all(tok for _, tok in by_stage.values()):
        return None
    return sum(s * 1e3 / tok for s, tok in by_stage.values())
