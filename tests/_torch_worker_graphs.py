"""Graph factories for the port's process-backed workers in tests.

The twin of ``tests/_worker_graphs.py``.  Worker processes rebuild the
layer graph locally from a factory named in
:class:`~repro_torch.runtime.supervisor.SupervisorConfig` — tests point at
this file with the path form (``"/abs/path/_torch_worker_graphs.py:mlp_graph"``,
resolved by :func:`repro_torch.runtime.worker.load_graph_factory`) because
the ``tests`` directory is not an installed package.  Everything here must
be importable with only ``src`` on ``sys.path``, and imports no ``jax``.
"""
import numpy as np
import torch

from repro_torch.core.graph import LayerGraph, TensorSpec

D = 16


POISON = 777.0


def _tanh_fc(p, x):
    return torch.tanh(x @ p["w"])


def poison_graph(depth: int = 4, d: int = D) -> LayerGraph:
    """mlp_graph plus a tripwire: an input whose first element is
    :data:`POISON` makes the first layer raise — a deterministic
    APPLICATION error (user ``apply`` code), which the reliability layer
    must surface after exactly one attempt, never replay."""
    shape = (1, d)
    g = LayerGraph("poison-mlp", TensorSpec(shape, np.float32))

    def trip(p, x):
        # host-side tripwire in the stage apply (eager, so the
        # data-dependent raise needs no escape from a trace); raises
        # identically on every attempt — nothing a retry can heal
        if bool((x == POISON).any()):
            raise ValueError("poison pill: application error from apply()")
        return _tanh_fc(p, x)

    prev = ""
    for i in range(depth):
        g.layer(f"fc{i}", trip if i == 0 else _tanh_fc,
                {"w": TensorSpec((d, d), np.float32)}, (prev,),
                TensorSpec(shape, np.float32), flops=2.0 * d * d)
        prev = f"fc{i}"
    return g


def lm_graph(**kw) -> LayerGraph:
    """The small decode-capable transformer the decode-serving tests
    standardize on — deterministic builder, so the supervisor-side and
    worker-side copies agree layer for layer (and the KV cache capacity,
    a graph-level constant, matches across processes)."""
    from repro_torch.models.lm_graph import decode_lm_graph
    defaults = dict(vocab=32, d_model=16, n_layers=2, num_heads=2,
                    kv_heads=2, head_dim=8, d_ff=32, cache_len=48)
    defaults.update(kw)
    return decode_lm_graph(**defaults)


def mlp_graph(depth: int = 6, d: int = D) -> LayerGraph:
    """The toy tanh MLP the runtime tests standardize on — deterministic,
    so the supervisor-side and worker-side copies agree layer for layer."""
    shape = (1, d)
    g = LayerGraph("toy-mlp", TensorSpec(shape, np.float32))
    prev = ""
    for i in range(depth):
        g.layer(f"fc{i}", _tanh_fc, {"w": TensorSpec((d, d), np.float32)},
                (prev,), TensorSpec(shape, np.float32), flops=2.0 * d * d)
        prev = f"fc{i}"
    return g
