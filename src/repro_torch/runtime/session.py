"""Decode sessions: per-replica KV residency + the token-generation loop.

A decode *session* is one autoregressive generation: a prompt is prefilled
ONCE through the chain (``kind=K_OPEN``, full ``[1, S]`` token frame), every
attention layer's KV cache stays RESIDENT on the replica that computed it,
and each subsequent step ships only the newest token (``kind=K_STEP``,
``[1, 1]`` — plus its sequence position in the extent header), not the
growing sequence.  The per-hop payload is therefore O(d_model), independent
of how long the sequence has grown — the whole point of distributing decode.

Residency makes replicas stateful, which this module pays for in three
places:

* :class:`SessionStore` — the per-replica map of sessions to their slots
  in the replica's cache pool (:mod:`repro_torch.runtime.step_graph`;
  LRU-bounded so a leaked session cannot pin a slot forever; an evicted
  session is NOT an error, its next step fails with ``SessionLost`` and
  the generate loop re-prefills).  Every live store registers in a
  module-level WeakSet so the test harness can assert session-keyed state
  is actually evicted on session end (the per-client-GC precedent from
  the admission merge).
* sticky routing — the stage routers pin a session to the replica holding
  its cache (:mod:`repro_torch.runtime.router`); this module only *names* the
  session in each submit.
* :func:`generate_tokens` — the client-side loop.  It retains the full
  token history (prompt + generated), so ANY loss of residency — replica
  death, drain at a fence, repartition, LRU eviction — is recovered by
  re-opening the session (one re-prefill of the history) on whatever
  replicas the routers pick next.  Greedy decode is deterministic, so a
  recovered session's remaining tokens are bit-identical to an undisturbed
  run: a prefill of history ending at token ``t`` yields exactly the logits
  the failed step owed.

Recovery is ALWAYS re-prefill, never wire-level replay: the dispatcher's
blind replay layer is bypassed for session-tagged submits (a replayed step
against a cache that died with its replica would silently corrupt the
sequence).
"""
from __future__ import annotations

import threading
import uuid
import weakref
from collections import OrderedDict
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from repro_torch.runtime.wire import K_CLOSE, K_OPEN, K_STEP

# every constructed SessionStore, weakly: the conftest guard walks this to
# assert no session-keyed state survives a test (eviction on session end)
_LIVE_STORES: "weakref.WeakSet[SessionStore]" = weakref.WeakSet()


def live_session_stores() -> list["SessionStore"]:
    """Snapshot of every SessionStore still alive in this process."""
    return list(_LIVE_STORES)


class SessionLost(RuntimeError):
    """A session's KV residency is gone and recovery was not permitted
    (``restart='never'``, or the restart budget ran out).  Not retryable
    at the request layer — the caller must re-open the session (re-prefill
    its prompt) to continue."""

    retryable = False


class SessionStore:
    """Per-replica resident sessions, keyed by session id: each holds its
    slot, the row of the replica's cache pool that keeps its KV caches
    (:class:`~repro_torch.runtime.step_graph.Slot`).

    LRU-bounded: opening a session past ``capacity`` evicts the
    least-recently *stepped* session.  Eviction is safe by protocol — the
    evicted session's next step gets a ``SessionLost`` error envelope and
    its generate loop re-prefills — so capacity is a memory ceiling, not a
    correctness knob.  Every slot the store drops (a close, an eviction,
    a re-open, ``clear``) is released to its bank.  All methods are
    thread-safe (the compute stage writes; fences and thread exits
    clear)."""

    def __init__(self, capacity: int = 64):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._slots: OrderedDict[Any, Any] = OrderedDict()
        _LIVE_STORES.add(self)

    def open(self, session: Any, take: Callable[[], Any]) -> Any:
        """Give ``session`` a new slot, ``take()``'s, after releasing the
        one it holds and, at capacity, the least recently stepped
        sessions' (so the new slot may reuse one of theirs)."""
        with self._lock:
            old = self._slots.pop(session, None)
            if old is not None:
                old.release()
            while len(self._slots) >= self.capacity:
                self._slots.popitem(last=False)[1].release()
            slot = self._slots[session] = take()
            return slot

    def get(self, session: Any) -> Any | None:
        """Fetch a session's slot (refreshing its LRU place), or None."""
        with self._lock:
            slot = self._slots.get(session)
            if slot is not None:
                self._slots.move_to_end(session)
            return slot

    def pop(self, session: Any) -> Any | None:
        with self._lock:
            slot = self._slots.pop(session, None)
            if slot is not None:
                slot.release()
            return slot

    def clear(self) -> None:
        with self._lock:
            for slot in self._slots.values():
                slot.release()
            self._slots.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._slots)

    def keys(self) -> list[Any]:
        with self._lock:
            return list(self._slots)


def generate_tokens(dispatcher, prompt: Sequence[int],
                    max_new_tokens: int, *,
                    session_id: str | None = None,
                    client_id: Any = None,
                    restart: str = "auto",
                    deadline_s: float | None = None,
                    step_timeout: float | None = 60.0,
                    max_restarts: int = 4) -> Iterator[int]:
    """Greedy-decode ``max_new_tokens`` tokens through the chain, yielding
    each as it exits the tail.

    ``restart`` governs recovery when residency is lost mid-generation
    (replica killed, drained at a fence, repartitioned, LRU-evicted):

    * ``'always'`` — re-prefill from the retained history and continue;
    * ``'never'``  — raise :class:`SessionLost` (``retryable=False``);
    * ``'auto'``   — restart iff the dispatcher has a
      :class:`~repro_torch.runtime.dispatcher.RetryPolicy` (the operator already
      opted into transparent recovery).

    ``max_restarts`` bounds CONSECUTIVE re-prefills without a completed
    step, so a persistently broken chain fails instead of looping.
    ``step_timeout`` bounds each future wait (a hung chain surfaces as a
    timeout, not a silent stall).  ``deadline_s`` applies per submitted
    frame (open and step alike), riding the dispatcher's deadline reaper.

    The generator's ``finally`` closes the session: it unregisters from
    the dispatcher and sends a best-effort ``K_CLOSE`` frame down the
    chain so every stage evicts its caches promptly (LRU would get them
    eventually; close keeps the stores tight — and lets the test
    harness assert eviction on session end).
    """
    from repro_torch.runtime.dispatcher import NodeError  # circular at import time

    graph = dispatcher.graph
    if not getattr(graph, "decode_capable", False):
        raise ValueError(
            f"graph {graph.name!r} is not decode-capable: it declares no "
            "LayerDecode nodes, or is not a pure chain")
    history = [int(t) for t in np.asarray(prompt, np.int64).reshape(-1)]
    if not history:
        raise ValueError("decode needs a non-empty prompt")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    cache_len = getattr(graph, "decode_cache_len", None)
    if cache_len is not None and len(history) + max_new_tokens > cache_len:
        raise ValueError(
            f"prompt ({len(history)}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds the graph's KV capacity ({cache_len})")
    if restart not in ("auto", "always", "never"):
        raise ValueError(f"restart={restart!r}: use auto | always | never")
    allow_restart = (restart == "always"
                     or (restart == "auto"
                         and dispatcher.retry_policy is not None))

    sid = session_id if session_id is not None \
        else f"sess-{uuid.uuid4().hex[:16]}"
    cid = client_id if client_id is not None else sid

    def _open() -> np.ndarray:
        """(Re-)prefill the full retained history; the tail trims to the
        last position, so the result is the next-token logits — exactly
        what the step this replaces would have produced."""
        x = np.asarray(history, np.int32).reshape(1, -1)
        fut = dispatcher.submit(x, client_id=cid, session=sid,
                                session_pos=0, session_kind=K_OPEN,
                                deadline_s=deadline_s)
        return np.asarray(fut.result(step_timeout))

    def _step(tok: int) -> np.ndarray:
        x = np.asarray([[tok]], np.int32)
        fut = dispatcher.submit(x, client_id=cid, session=sid,
                                session_pos=len(history) - 1,
                                session_kind=K_STEP,
                                deadline_s=deadline_s)
        return np.asarray(fut.result(step_timeout))

    def _advance(tok: int | None) -> np.ndarray:
        """One chain round-trip with recovery: a displaced or failed
        session re-opens (full-history prefill) up to ``max_restarts``
        times before giving up."""
        restarts = 0
        reopen = tok is None or dispatcher.session_displaced(sid)
        while True:
            try:
                return _open() if reopen else _step(tok)
            except NodeError as e:
                if not allow_restart or restarts >= max_restarts:
                    raise SessionLost(
                        f"session {sid!r} lost its KV residency and "
                        f"restart={restart!r} forbids recovery (or the "
                        f"{max_restarts}-restart budget ran out); re-open "
                        "the session to continue") from e
                restarts += 1
                dispatcher.session_displaced(sid)   # clear any stale flag
                reopen = True

    dispatcher.session_register(sid)
    try:
        logits = _advance(None)
        made = 0
        while True:
            tok = int(np.argmax(logits[0, -1]))
            yield tok
            history.append(tok)
            made += 1
            if made >= max_new_tokens:
                return
            logits = _advance(tok)
    finally:
        dispatcher.session_unregister(sid)
        try:
            fut = dispatcher.submit(
                np.zeros((1, 1), np.int32), client_id=cid, session=sid,
                session_pos=0, session_kind=K_CLOSE, block=False)
            fut.result(timeout=5.0)
        except Exception:  # deferlint: swallow(best-effort close; LRU eviction and the store-clearing fence/exit paths reclaim the caches anyway)
            pass
