"""A stage replica's session cache pool: the decode step's own buffers,
replayed as one CUDA graph.

A replica's pool is a list of banks.  A bank (:class:`StepStaging`) holds
``decode_step_rows`` rows: a buffer per leaf of the slice's cache tree, one
for the step's tokens or activations, one for the positions and one for
the live-row mask, all allocated once.  A session opening on the replica
takes a free row of a bank (its :class:`Slot`), into which its prefill's
caches are copied once; from then on every step of the session reads and
writes its caches there, in place (a decode step's layers write the new
position into the cache tensors they are passed).  A step stages the
token and position of each session it serves at its slot and marks those
rows live; every other row of the bank, another session's or empty, is
computed too (the GEMMs run at a fixed M, and no row reads another) but
keeps its caches as they were, since the layers write only where the
row is live (:class:`~repro_torch.core.graph.StepRows`, with the
replica's device tallies).  Rows not staged keep their last token and
position.

On a CUDA device the first step over a bank runs eagerly on a side
stream, which serves that wave and warms cuBLAS, the kernel libraries and
the allocator; the step apply is then captured over the same buffers as one
CUDA graph, and every later step replays it on the calling thread's stream.
The capture's mode is thread-local, so the other stages' threads keep
launching while it runs.  A capture that raises leaves the bank eager, as
it always is on the CPU.
"""
from __future__ import annotations

import dataclasses
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
    """What a bank is built for: the cache tree's leaf paths, row shapes
    and dtypes, and the input row's shape and dtype."""
    return (tuple((path, tuple(t.shape[1:]), t.dtype)
                  for path, t in tree_flatten_with_path(caches)),
            x.shape[1:], x.dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class Slot:
    """A session's row of a bank, held from its open until the replica's
    :class:`~repro_torch.runtime.session.SessionStore` drops it."""

    bank: "StepStaging"
    row: int

    def release(self) -> None:
        """Give the row back to its bank, for the next session to open."""
        self.bank.free.append(self.row)


class StepStaging:
    """One bank of a replica's pool: ``rows`` slots for sessions of the
    signature of ``caches`` (one session's cache tree, leading axis 1) and
    ``x`` (one row's input), and on a CUDA device the step captured over
    them."""

    def __init__(self, apply: Callable, rows: int, caches: Any,
                 x: np.ndarray, device: torch.device,
                 tallies: dict | None = None):
        self.key = signature(caches, x)
        self.rows = rows
        self.device = device
        self._apply = apply
        # rows no session holds, the lowest taken first
        self.free = list(range(rows - 1, -1, -1))
        # the step's inputs in one buffer, filled by one copy from its host
        # mirror: each row's x, then its position and its live flag (int32)
        xbytes = rows * x[0].nbytes
        self._host = np.zeros(xbytes + 8 * rows, np.uint8)
        self._x_host = self._host[:xbytes].view(x.dtype).reshape(
            (rows,) + x.shape[1:])
        self._pos_host, self._live_host = self._host[xbytes:].view(
            np.int32).reshape(2, rows)
        with torch.inference_mode():
            self.caches = tree_map(lambda t: torch.zeros(
                (rows,) + tuple(t.shape[1:]), dtype=t.dtype, device=device),
                caches)
            self._in = torch.zeros(self._host.shape, dtype=torch.uint8,
                                   device=device)
            self.x = self._in[:xbytes].view(
                torch.from_numpy(x[:0]).dtype).view(self._x_host.shape)
            self.pos, self.live = self._in[xbytes:].view(torch.int32).view(
                2, rows)
        self._rows = StepRows(self.live, {} if tallies is None else tallies)
        self._leaves = tree_leaves(self.caches)
        self._graph: torch.cuda.CUDAGraph | None = None
        self._out: torch.Tensor | None = None
        self._launches: dict = {}
        self.error: str | None = None      # the capture's traceback

    @property
    def graphed(self) -> bool:
        """Whether steps run as a graph's replay: on a CUDA device, unless
        the capture raised."""
        return self.device.type == "cuda" and self.error is None

    def take(self, caches: Any) -> Slot:
        """A free row, holding a copy of ``caches`` (one session's tree of
        the bank's signature, as its prefill left them)."""
        slot = Slot(self, self.free.pop())
        with torch.inference_mode():
            for buf, t in zip(self._leaves, tree_leaves(caches)):
                buf[slot.row].copy_(t[0])
        return slot

    def stage(self, rows: list[int], x: np.ndarray, pos: list[int]) -> None:
        """The next step's inputs: ``x`` and ``pos`` of the sessions whose
        slots are ``rows``, which alone are live."""
        if x.shape[1:] != self._x_host.shape[1:] \
                or x.dtype != self._x_host.dtype:
            raise ValueError(f"step input {x.dtype}{list(x.shape[1:])} does "
                             f"not fit this bank's "
                             f"{self._x_host.dtype}{list(self._x_host.shape[1:])}")
        self._x_host[rows] = x
        self._pos_host[rows] = pos
        self._live_host[:] = 0
        self._live_host[rows] = 1
        with torch.inference_mode():
            self._in.copy_(torch.from_numpy(self._host))

    def step(self) -> tuple[torch.Tensor, str]:
        """Run the step over the bank: (output of every row, how).  The
        output of a replay is the graph's own tensor, which the next replay
        overwrites."""
        if self._graph is not None:
            self._graph.replay()
            decode_attention.replayed(self._launches)
            return self._out, REPLAY
        if not self.graphed:
            with step_rows(self._rows):
                return self._apply(self.caches, self.x, self.pos)[0], EAGER
        with step_rows(self._rows):
            return self._capture()

    def _capture(self) -> tuple[torch.Tensor, str]:
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        how = CAPTURED
        with torch.cuda.stream(side):
            y = self._apply(self.caches, self.x, self.pos)[0]
            graph = torch.cuda.CUDAGraph()
            try:
                with _CAPTURE_LOCK, decode_attention.capturing() as tally:
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        out = self._apply(self.caches, self.x, self.pos)[0]
                    finally:
                        graph.capture_end()
            except Exception:
                self.error = traceback.format_exc()
                how = FAILED
            else:
                self._graph, self._out, self._launches = graph, out, tally
        cur.wait_stream(side)
        return y, how
