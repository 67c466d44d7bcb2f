"""How unevenly the decode steps load the held experts: the busiest held
expert's routed rows over the mean of all held experts' rows, an expert
being one of one layer, its rows summed over the replicas of its stage
(the engine's ``moe_rows``: live rows only, counted on the device inside
each step, over window and drain).  1 is even; None where the program
reports no routed rows."""


def read(run):
    rows: dict[str, list[int]] = {}
    for n in (run.report or {}).get("per_node", []):
        for layer, counts in n.get("moe_rows", {}).items():
            have = rows.setdefault(layer, [0] * len(counts))
            rows[layer] = [a + b for a, b in zip(have, counts)]
    flat = [c for counts in rows.values() for c in counts]
    if not flat or not sum(flat):
        return None
    return max(flat) * len(flat) / sum(flat)
