"""Layer-graph IR — the PyTorch twin of ``repro.core.graph``.

DEFER partitions a model by walking its layer DAG and cutting it into
contiguous sub-networks.  We represent any model as a :class:`LayerGraph`
of :class:`LayerNode`s.  Each node carries

* ``fn``        — a function ``(params, *inputs) -> output`` on torch tensors,
* ``param_spec``— nested dict of :class:`TensorSpec` for its parameters,
* cost terms    — FLOPs, parameter bytes, and output-activation bytes,

so the partitioner can cost a cut without running anything, exactly like the
paper's dispatcher plans partitions before shipping them.

Parameters travel (and are initialized) as nested dicts of numpy arrays in
the reference's names and layouts, so weight blobs are interchangeable
with the JAX package.  Before compute, :meth:`LayerGraph.prepare` turns
them into device tensors once — each node's ``prepare`` hook may also
change a layout there (the CNN convolutions go HWIO -> OIHW) — and
:meth:`LayerGraph.apply` runs on prepared params.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import zlib
from typing import Any, Callable, Iterator, Mapping, Sequence

import numpy as np
import torch

Params = Any  # nested dict of arrays


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor (the counterpart of
    ``jax.ShapeDtypeStruct``); ``dtype`` is a numpy dtype."""

    shape: tuple[int, ...]
    dtype: np.dtype = np.dtype(np.float32)

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "dtype", np.dtype(self.dtype))


# -- nested-dict tree helpers (stand-ins for jax.tree_util) ----------------------

def tree_leaves(tree: Any) -> list:
    """Leaves of a nested dict/list/tuple in sorted-key order (the order
    ``jax.tree_util`` flattens dicts in)."""
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_flatten_with_path(tree: Any, prefix: tuple = ()
                           ) -> Iterator[tuple[tuple, Any]]:
    """Yield ``(path, leaf)`` pairs: dict keys sorted, sequence items by
    index, ``None`` and empty containers contribute no leaves."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from tree_flatten_with_path(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_flatten_with_path(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf, keeping the container structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def tree_map_with_path(fn: Callable[[tuple, Any], Any], tree: Any,
                       prefix: tuple = ()) -> Any:
    """Apply ``fn(path, leaf)`` to every leaf, keeping the container
    structure; ``path`` as :func:`tree_flatten_with_path` gives it."""
    if isinstance(tree, Mapping):
        return {k: tree_map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)


def _leaf_bytes(leaf: Any) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    size = int(np.prod(leaf.shape)) if leaf.shape else 1
    return size * np.dtype(leaf.dtype).itemsize


def tree_bytes(tree: Any) -> int:
    """Total bytes of every leaf (arrays, tensors and TensorSpecs)."""
    return sum(_leaf_bytes(leaf) for leaf in tree_leaves(tree))


def to_tensor(leaf: Any, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``."""
    return torch.as_tensor(np.asarray(leaf), device=device)


@dataclasses.dataclass
class LayerDecode:
    """Autoregressive view of a layer: a stateful one (attention with a KV
    cache), or one whose step differs from its prefill (routed experts,
    whose cache is ``{}``).

    ``repro_torch.models.lm_graph`` builds one per attention block and per
    routed-expert block; the compute node runs ``prefill_fn`` when a
    session opens and ``step_fn`` for each later token, with the caches
    resident on the replica.
    """

    prefill_fn: Callable[..., Any]         # (params, x) -> (y, cache)
    step_fn: Callable[..., Any]            # (params, cache, x, pos) -> (y, new_cache)


@dataclasses.dataclass
class StepRows:
    """What a decode step's layers may read beside their inputs: ``live``
    [rows] int32 on the step's device, 1 where the row is a session's and
    0 where it pads the step, and ``tallies``, int64 device counters by
    name and layer that the layers add into."""

    live: torch.Tensor
    tallies: dict[str, dict[str, torch.Tensor]]

    def tally(self, counter: str, layer: str,
              shape: tuple[int, ...] = ()) -> torch.Tensor:
        """Layer ``layer``'s ``counter``, zeros of ``shape`` at its first
        use (an eager step's: a CUDA graph's capture then adds into it)."""
        by_layer = self.tallies.setdefault(counter, {})
        t = by_layer.get(layer)
        if t is None:
            t = by_layer[layer] = torch.zeros(
                shape, dtype=torch.int64, device=self.live.device)
        return t


_STEP = threading.local()


@contextlib.contextmanager
def step_rows(rows: StepRows) -> Iterator[None]:
    """Steps applied inside (on this thread) see ``rows``."""
    prev = getattr(_STEP, "rows", None)
    _STEP.rows = rows
    try:
        yield
    finally:
        _STEP.rows = prev


def current_step_rows() -> StepRows | None:
    """The :class:`StepRows` of the step being applied on this thread, or
    None outside a replica's step."""
    return getattr(_STEP, "rows", None)


@dataclasses.dataclass
class LayerNode:
    """One layer (or fused block) in the model DAG."""

    name: str
    fn: Callable[..., Any]                 # (prepared params, *inputs) -> output
    param_spec: Any                        # nested dict of TensorSpec
    inputs: Sequence[str]                  # names of producer nodes ('' = graph input)
    out_spec: TensorSpec                   # activation this node emits
    flops: float                           # fwd FLOPs for one sample batch
    meta: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    # True iff this layer preserves its middle axes and acts independently
    # along them (see the reference's LayerNode.pad_safe)
    pad_safe: bool = True
    decode: LayerDecode | None = None
    # (params, device) -> device-ready params; None = every leaf as a tensor
    prepare: Callable[[Any, torch.device], Any] | None = None

    @property
    def param_bytes(self) -> int:
        return tree_bytes(self.param_spec)

    @property
    def out_bytes(self) -> int:
        return tree_bytes(self.out_spec)

    def prepare_params(self, params: Any, device: torch.device) -> Any:
        if self.prepare is not None:
            return self.prepare(params, device)
        return tree_map(lambda a: to_tensor(a, device), params)


class LayerGraph:
    """A topologically-ordered DAG of layers plus init/apply utilities.

    Mirrors the role of the Keras model object in DEFER: it can be traversed,
    cut into contiguous partitions, and each partition materialized as a
    standalone callable (the "new model of just the partitioned layers").
    """

    def __init__(self, name: str, input_spec: TensorSpec):
        self.name = name
        self.input_spec = input_spec
        self.nodes: list[LayerNode] = []
        self._by_name: dict[str, LayerNode] = {}

    # -- construction -----------------------------------------------------
    def add(self, node: LayerNode) -> str:
        if node.name in self._by_name:
            raise ValueError(f"duplicate layer name {node.name!r}")
        for inp in node.inputs:
            if inp and inp not in self._by_name:
                raise ValueError(
                    f"layer {node.name!r} consumes unknown producer {inp!r}"
                )
        self.nodes.append(node)
        self._by_name[node.name] = node
        return node.name

    def layer(self, name: str, fn, param_spec, inputs, out_spec, flops,
              pad_safe: bool = True, decode: LayerDecode | None = None,
              prepare=None, **meta):
        return self.add(
            LayerNode(name, fn, param_spec, tuple(inputs), out_spec, flops,
                      meta, pad_safe=pad_safe, decode=decode, prepare=prepare)
        )

    @property
    def decode_capable(self) -> bool:
        """True iff the graph declares an autoregressive view: at least one
        stateful :class:`LayerDecode` node AND a pure chain shape."""
        return (any(n.decode is not None for n in self.nodes)
                and all(len(n.inputs) == 1 for n in self.nodes))

    def __len__(self) -> int:
        return len(self.nodes)

    def __getitem__(self, name: str) -> LayerNode:
        return self._by_name[name]

    # -- aggregate costs ---------------------------------------------------
    @property
    def total_flops(self) -> float:
        return sum(n.flops for n in self.nodes)

    @property
    def total_param_bytes(self) -> int:
        return sum(n.param_bytes for n in self.nodes)

    # -- cut legality -------------------------------------------------------
    def cut_cost(self, i: int) -> int:
        """Bytes crossing a cut placed after node index ``i`` (the union of
        crossing producer activations, each sent once)."""
        total = 0
        for name in self.crossing_names(i):
            total += (
                tree_bytes(self.input_spec)
                if name == ""
                else self._by_name[name].out_bytes
            )
        return total

    def crossing_names(self, i: int) -> list[str]:
        """Activations crossing a cut placed after node index ``i``: every
        edge from a producer at index <= i (or the graph input '') to a
        consumer at index > i."""
        consumed_after = {inp for n in self.nodes[i + 1:] for inp in n.inputs}
        names = [n.name for n in self.nodes[: i + 1] if n.name in consumed_after]
        if "" in consumed_after:
            names.insert(0, "")
        return names

    # -- init / prepare / apply ---------------------------------------------
    def init(self, seed: int = 0, scale: float = 0.02) -> Params:
        """Materialize real parameters for every node (normal init) as
        numpy arrays.  Each node draws from a generator seeded by ``seed``
        and a stable hash of its name, so the result is the same in every
        process."""
        params: dict[str, Any] = {}
        for node in self.nodes:
            rng = np.random.default_rng(
                [seed, zlib.crc32(node.name.encode())])

            def leaf(spec: TensorSpec, rng=rng):
                if np.issubdtype(spec.dtype, np.floating):
                    return (rng.standard_normal(spec.shape, np.float32)
                            * np.float32(scale)).astype(spec.dtype)
                return np.zeros(spec.shape, spec.dtype)

            params[node.name] = tree_map(leaf, node.param_spec)
        return params

    def prepare(self, params: Params, device: str | torch.device,
                nodes: Sequence[LayerNode] | None = None) -> dict[str, Any]:
        """Params (numpy, reference layout) -> device tensors in each
        node's compute layout.  Done once per configuration, not per call."""
        device = torch.device(device)
        nodes = list(self.nodes) if nodes is None else list(nodes)
        return {n.name: n.prepare_params(params[n.name], device)
                for n in nodes if n.name in params}

    def apply(self, params: Params, x: torch.Tensor,
              nodes: Sequence[LayerNode] | None = None,
              boundary_inputs: Mapping[str, torch.Tensor] | None = None
              ) -> torch.Tensor:
        """Run (a slice of) the graph on params from :meth:`prepare`.

        ``boundary_inputs`` supplies activations produced by an earlier
        partition — this is exactly what a DEFER compute node receives on its
        incoming socket.
        """
        nodes = list(self.nodes) if nodes is None else list(nodes)
        acts: dict[str, torch.Tensor] = {"": x}
        if boundary_inputs:
            acts.update(boundary_inputs)
        out = x
        with torch.inference_mode():
            for node in nodes:
                args = [acts[i] for i in node.inputs]
                out = node.fn(params.get(node.name, {}), *args)
                acts[node.name] = out
        return out

    # -- partition materialization -------------------------------------------
    def slice_nodes(self, lo: int, hi: int) -> list[LayerNode]:
        """Nodes of partition [lo, hi) in topological order."""
        return self.nodes[lo:hi]

    def boundary_names(self, lo: int, hi: int) -> tuple[list[str], list[str]]:
        """(required_inputs, exported_outputs) for partition [lo, hi)."""
        inside = {n.name for n in self.nodes[lo:hi]}
        required: list[str] = []
        for n in self.nodes[lo:hi]:
            for inp in n.inputs:
                if inp not in inside and inp not in required:
                    required.append(inp)
        consumed_after = {inp for n in self.nodes[hi:] for inp in n.inputs}
        exported = [n.name for n in self.nodes[lo:hi] if n.name in consumed_after]
        if hi == len(self.nodes) and self.nodes and self.nodes[-1].name not in exported:
            exported.append(self.nodes[-1].name)
        return required, exported
