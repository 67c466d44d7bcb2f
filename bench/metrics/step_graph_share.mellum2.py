"""Share of the decode steps that ran as a replay of their replica's CUDA
graph, routed experts included: the engine's ``step_graph_replays``
summed over replicas, over the replays and the steps run eagerly
(``step_eager_steps``, captures included), over window and drain, in
percent (the program's own counters; None where it reports neither)."""


def read(run):
    from bench.harness.spans import replica_sum
    replays = replica_sum(run, "step_graph_replays")
    eager = replica_sum(run, "step_eager_steps")
    if replays is None or eager is None or not replays + eager:
        return None
    return 100.0 * replays / (replays + eager)
