"""Requests a compute wave merges: the engine's ``batch_mean`` of each
replica, weighted by the requests it served (the dispatcher's and the
routers' batching)."""


def read(run):
    nodes = (run.report or {}).get("per_node", [])
    served = sum(n["requests"] for n in nodes)
    if not served:
        return None
    return sum(n["batch_mean"] * n["requests"] for n in nodes) / served
