"""A stage replica's decode step on buffers it owns, replayed as one CUDA graph.

Every decode step of a replica runs at ``decode_step_rows`` rows over one
:class:`StepStaging`: a buffer per leaf of the slice's cache tree, one for
the step's tokens or activations, one for the positions, all allocated
once.  A wave's sessions' caches are copied into rows ``[0, n)`` (one
``torch.cat`` per leaf, into the buffer); pad rows repeat the last row's
token and position and keep whatever caches their rows hold, since their
outputs are dropped and no row of a step reads another (the GEMMs run at a
fixed M, decode attention and the norms per row).  A mask of the live rows
and the replica's device tallies are what the step's layers see of it
beside their inputs (:class:`~repro_torch.core.graph.StepRows`).

On a CUDA device the first step over a staging runs eagerly on a side
stream, which serves that wave and warms cuBLAS, the kernel libraries and
the allocator; the step apply is then captured over the same buffers as one
CUDA graph, and every later step replays it on the calling thread's stream.
The capture's mode is thread-local, so the other stages' threads keep
launching while it runs.  A capture that raises leaves the staging eager,
as it always is on the CPU.
"""
from __future__ import annotations

import threading
import traceback
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.graph import (StepRows, step_rows,
                                    tree_flatten_with_path, tree_leaves,
                                    tree_map)
from repro_torch.kernels import decode_attention

# how a step ran (StepStaging.step); "captured" and "failed" ran eagerly too
REPLAY, EAGER, CAPTURED, FAILED = "replay", "eager", "captured", "failed"
# one capture at a time in a process: a stage's replicas may reach their
# first step together
_CAPTURE_LOCK = threading.Lock()


def signature(caches: Any, x: np.ndarray) -> tuple:
    """What a staging is built for: the cache tree's leaf paths, row shapes
    and dtypes, and the input row's shape and dtype."""
    return (tuple((path, tuple(t.shape[1:]), t.dtype)
                  for path, t in tree_flatten_with_path(caches)),
            x.shape[1:], x.dtype)


class StepStaging:
    """Fixed buffers for a replica's step at ``rows`` rows, built for the
    signature of ``caches`` (one session's cache tree, leading axis 1) and
    ``x`` (one row's input), and on a CUDA device the step captured over
    them."""

    def __init__(self, apply: Callable, rows: int, caches: Any,
                 x: np.ndarray, device: torch.device,
                 tallies: dict | None = None):
        self.key = signature(caches, x)
        self.device = device
        self._apply = apply
        with torch.inference_mode():
            self.caches = tree_map(lambda t: torch.zeros(
                (rows,) + tuple(t.shape[1:]), dtype=t.dtype, device=device),
                caches)
            self.x = torch.zeros((rows,) + x.shape[1:],
                                 dtype=torch.from_numpy(x[:0]).dtype,
                                 device=device)
            # the positions and the live-row mask (1 or 0), one copy in
            self._pos_live = torch.zeros((2, rows), dtype=torch.int32,
                                         device=device)
            self.pos, self.live = self._pos_live
        self._rows = StepRows(self.live, {} if tallies is None else tallies)
        self._leaves = tree_leaves(self.caches)
        self._graph: torch.cuda.CUDAGraph | None = None
        self._out: tuple | None = None
        self._launches: dict = {}
        self.error: str | None = None      # the capture's traceback

    @property
    def graphed(self) -> bool:
        """Whether steps run as a graph's replay: on a CUDA device, unless
        the capture raised."""
        return self.device.type == "cuda" and self.error is None

    def stage(self, caches: list, x: np.ndarray, pos: list[int]) -> None:
        """Copy ``len(caches)`` sessions' caches (each of the staging's
        signature: the replica's own) into the first rows, and every row's
        input ``x`` and position ``pos``."""
        rows = [tree_leaves(c) for c in caches]
        n = len(caches)
        with torch.inference_mode():
            for j, buf in enumerate(self._leaves):
                torch.cat([r[j] for r in rows], dim=0, out=buf[:n])
            self.x.copy_(torch.from_numpy(x))
            self._pos_live.copy_(torch.tensor(
                [pos, [1] * n + [0] * (len(pos) - n)], dtype=torch.int32))

    def step(self) -> tuple[torch.Tensor, Any, str]:
        """Run the step over the buffers: (output, new caches, how).  The
        outputs of a replay are the graph's own tensors, which the next
        replay overwrites."""
        if self._graph is not None:
            self._graph.replay()
            decode_attention.replayed(self._launches)
            return (*self._out, REPLAY)
        if not self.graphed:
            with step_rows(self._rows):
                return (*self._apply(self.caches, self.x, self.pos), EAGER)
        with step_rows(self._rows):
            return self._capture()

    def _capture(self) -> tuple[torch.Tensor, Any, str]:
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        how = CAPTURED
        with torch.cuda.stream(side):
            y, new = self._apply(self.caches, self.x, self.pos)
            graph = torch.cuda.CUDAGraph()
            try:
                with _CAPTURE_LOCK, decode_attention.capturing() as tally:
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        out = self._apply(self.caches, self.x, self.pos)
                    finally:
                        graph.capture_end()
            except Exception:
                self.error = traceback.format_exc()
                how = FAILED
            else:
                self._graph, self._out, self._launches = graph, out, tally
        cur.wait_stream(side)
        return y, new, how
