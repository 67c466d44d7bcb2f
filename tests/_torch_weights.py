"""Seeded fan-in-scaled CNN weights shared by the port's parity tests.

Not the reference's 0.02 init: with BN scale ~N(0, 0.02) the residual
branches vanish and the logits collapse to the fc bias, so a parity test
would pass vacuously.  Scales: conv/fc ``w ~ N(0, 2/fan_in)`` (He),
folded-BN ``scale ~ U(0.5, 1.0)``, every bias ``~ N(0, 0.1)``.
"""
import numpy as np


def fan_in_params(graph, seed: int = 0) -> dict:
    """numpy params in the reference's names and HWIO layout for either
    package's graph; param-less layers get ``{}``, as ``init`` gives them."""
    rng = np.random.default_rng(seed)
    params = {}
    for node in graph.nodes:
        spec = node.param_spec
        p = {}
        for k in sorted(spec):
            shape = tuple(spec[k].shape)
            if k == "w":
                fan_in = int(np.prod(shape[:-1]))
                p[k] = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
            elif k == "scale":
                p[k] = rng.uniform(0.5, 1.0, shape)
            else:
                p[k] = 0.1 * rng.standard_normal(shape)
            p[k] = p[k].astype(np.float32)
        params[node.name] = p
    return params
