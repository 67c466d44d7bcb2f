"""Per-stage routing for replicated topologies.

A :class:`StageGroup` owns one topology stage: its replicas, its inbound
channel, and a router thread that spreads work across the replicas.  The
groups of consecutive stages chain through the stage input channels:

    pump -> [router 0] -> replica inboxes (stage 0)
                           each replica egress -> stage 1 input channel
         -> [router 1] -> replica inboxes (stage 1)
                           ...
         -> result channel -> collector

Routing policies: ``"rr"`` (round-robin) and ``"lqd"`` (least queue
depth — the default; ties break round-robin, so a homogeneous idle stage
degrades gracefully to rr).

**The fence barrier.** With one replica per stage the chain is a single
FIFO and a :class:`~repro_torch.runtime.wire.ReconfigMarker` can never be
overtaken.  Replication breaks that: a fast replica may emit post-fence
envelopes while a slow sibling still drains pre-fence work.  Each router
therefore runs a counting barrier per epoch: it forwards the fence to its
own replicas only after receiving one copy from EVERY upstream replica,
and envelopes stamped ahead of its current epoch
(:attr:`BatchEnvelope.epoch`) are held until that barrier completes.
Pre-fence stragglers (stamped at or below the current epoch) keep flowing
during the barrier — holding them would deadlock the very backlog the
barrier waits for.

**Elastic membership.** ``Dispatcher.scale`` stages a pending membership
change (spawned replicas to add, draining replicas to retire) keyed by the
fence epoch; the router applies it exactly when the fence passes: spawned
replicas join the broadcast + routing set at the fence (so the downstream
barrier count includes them), draining replicas receive the fence (flushing
their in-flight work), are removed from the routing set, and get a
``_RETIRE`` token queued behind the fence — they finish everything already
routed to them and exit without signaling downstream.  Zero requests are
dropped, reordered (the collector's sequenced merge), or recomputed.

``fence_info`` is the cross-stage contract: before broadcasting epoch ``e``
the router records how many marker copies the downstream barrier must
expect and how many members will remain after — the downstream router (or
the tail collector) reads exactly that.  The same count bookkeeping makes
``_STOP`` exact: a shutdown broadcast reaches every live replica, each
forwards one stop, and the downstream barrier knows how many to await.

**Dead links.**  With a real socket transport a replica's inbox can die
mid-serve (connection reset, :class:`ChannelClosed`).  The router then (1)
fails exactly the affected batch's futures (the same per-batch isolation a
compute error gets), (2) removes the member from the routing set so later
traffic heals onto its siblings, and (3) keeps the member on a ``dead``
list whose control tokens it *proxies*: when a fence or stop broadcast
comes due, the router sends the dead member's copy directly into its
downstream channel — the replica's own egress will never do it (its
ingress self-retired on the closed channel) and the downstream barrier
counts would otherwise wait forever.  The chain keeps serving, and
shutdown still joins cleanly.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import TYPE_CHECKING

from repro_torch.runtime.node import _RETIRE, _STOP, ComputeNode
from repro_torch.runtime.transport import Channel, ChannelClosed
from repro_torch.runtime.wire import (K_CLOSE, K_OPEN, K_STEP, BatchEnvelope,
                                      ReconfigMarker)

if TYPE_CHECKING:
    from repro_torch.runtime.topology import StageSpec


class FenceTally:
    """Counting state for the markers and stops one consumer receives from
    an upstream replica set — shared by every stage router and the tail
    collector, so the barrier/stop accounting exists exactly once.

    A drained replica forwards its fence copy but never a stop, and the
    fence lowers ``expected_stops`` when its barrier completes — possibly
    AFTER the last live replica's stop already arrived, so the consumer
    must re-check :attr:`stopped` after every completed barrier, not only
    on stop receipt (otherwise shutdown racing an in-flight drain fence
    deadlocks)."""

    def __init__(self, upstream_members: int):
        self.expected_stops = upstream_members
        self.stops = 0
        self._marks: dict[int, int] = {}
        self._barrier: dict[int, tuple[int, int]] = {}

    @property
    def stopped(self) -> bool:
        return self.stops >= self.expected_stops

    def on_stop(self) -> bool:
        """Record one _STOP; True once every upstream member stopped."""
        self.stops += 1
        return self.stopped

    def on_marker(self, epoch: int,
                  upstream: "StageGroup | None") -> bool:
        """Record one fence copy; True exactly when the barrier for
        ``epoch`` completes (at which point all pre-fence traffic from
        every upstream replica has been received, and ``expected_stops``
        reflects the post-fence membership)."""
        self._marks[epoch] = self._marks.get(epoch, 0) + 1
        if epoch not in self._barrier:
            # first copy of this fence: learn the barrier size (recorded
            # by the upstream router before it broadcast, so this read
            # can never race ahead of the write)
            self._barrier[epoch] = ((1, 1) if upstream is None
                                    else upstream.fence_info(epoch))
        need, after = self._barrier[epoch]
        if self._marks[epoch] < need:
            return False
        del self._marks[epoch], self._barrier[epoch]
        self.expected_stops = after
        return True


class StageGroup:
    """One stage of the topology: replicas + router + fence bookkeeping."""

    def __init__(self, index: int, spec: "StageSpec",
                 replicas: list[ComputeNode], input_channel: Channel,
                 upstream: "StageGroup | None",
                 fail_batch=None, note_displaced=None):
        self.index = index
        self.spec = spec
        self.replicas = replicas            # all live replicas (stats view)
        self.input = input_channel
        self.upstream = upstream            # None = fed by the pump
        self.routing = spec.routing
        # (extents, error=str) callback: a routing failure (a transport
        # send raising) fails exactly the affected requests' futures
        # instead of silently killing the router thread and hanging every
        # client — mirroring the per-batch isolation inside ComputeNode
        self.fail_batch = fail_batch
        # (sessions) callback: the replica these decode sessions were
        # pinned to left the routing set (drained at a fence, or its link
        # died), so their KV caches at this stage are gone — the
        # dispatcher flags them for session-layer re-prefill
        self.note_displaced = note_displaced
        # epoch -> (markers the DOWNSTREAM barrier must count, members
        # remaining after the fence).  Written before the broadcast, read
        # by the next router / the collector when its barrier trips.
        self._fence_info: dict[int, tuple[int, int]] = {}
        # epoch -> (replicas to add, replicas to retire) at that fence
        self._pending: dict[int, tuple[list[ComputeNode],
                                       list[ComputeNode]]] = {}
        self._info_lock = threading.Lock()
        self._thread: threading.Thread | None = None

    # -- cross-stage contract -------------------------------------------------
    def fence_info(self, epoch: int) -> tuple[int, int]:
        """(expected marker count, members after) for a fence this stage
        broadcast — consumed once by the downstream barrier."""
        with self._info_lock:
            return self._fence_info.pop(epoch)

    def stage_membership(self, epoch: int, adds: list[ComputeNode],
                         drops: list[ComputeNode]) -> None:
        """Queue a membership change to apply when fence ``epoch`` passes
        this stage's router."""
        with self._info_lock:
            self._pending[epoch] = (adds, drops)

    def upstream_members(self) -> int:
        return 1 if self.upstream is None else len(self.upstream.replicas)

    def live_replicas(self) -> list[ComputeNode]:
        """Current members for stats/pricing: prunes replicas retired by
        a drain once their threads exit.  An un-acked drain leaves a
        retiree in ``replicas`` while it flushes (its telemetry is still
        real); once dead it must go, or its frozen snapshot epoch makes
        the controller rebaseline forever and its ghost membership
        inflates capacity pricing."""
        with self._info_lock:
            for node in [r for r in self.replicas if r.retiring]:
                if not any(t.is_alive() for t in node._threads):
                    self.replicas.remove(node)
            return list(self.replicas)

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(target=self._route_loop, daemon=True)
        self._thread.start()

    @property
    def thread(self) -> threading.Thread | None:
        """The router thread (None before ``start()``)."""
        return self._thread

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()

    # -- the router thread ----------------------------------------------------
    # in-flight ledger floor per member: outstanding items on a channel
    # are bounded by its credit window (the stage queue_depth), so the
    # per-member depth is that capacity with headroom — this floor only
    # covers channels that do not expose a capacity
    _LEDGER_DEPTH = 64

    @classmethod
    def _ledger_depth(cls, m: ComputeNode) -> int:
        cap = getattr(m.inbox, "capacity", 0) or 0
        # process-backed members (lost_on_death) lose their CONSUMED
        # in-flight work too when they die, so the ledger must also cover
        # the member's internal pipeline: up to ~3 waves of max_batch
        # envelopes (ingress stash + compute + egress) beyond the channel
        mb = (getattr(m, "max_batch_cap", None)
              or getattr(m, "max_batch", 0) or 0)
        return max(cls._LEDGER_DEPTH, 2 * cap + 4 * mb)
    # how long to wait for a dead member's threads to finish flushing
    # before proxying its fence/stop downstream (normally milliseconds —
    # the self-retire is immediate once the channel raises)
    _FLUSH_JOIN_S = 5.0

    def _route_loop(self) -> None:
        members = list(self.replicas)       # the routing set (thread-local)
        dead: list[ComputeNode] = []        # members with a dead inbox link
        # per member: the last routed items' extents (None for control
        # tokens), FIFO-aligned with the channel, so when a link dies the
        # unconsumed tail (channel qsize, credit accounting) can be failed
        # instead of leaving those batches' futures hanging forever
        ledger: dict[int, deque] = {}
        # per member that can report what it forwarded
        # (``forwarded_tokens``, i.e. process-backed): [settled_prefix,
        # control tokens sent on its link, in order].  A member can die
        # AFTER a broadcast handed its fence/stop copy to the socket
        # (the send succeeds into a doomed buffer) but BEFORE its egress
        # forwarded the copy downstream — without settling that copy the
        # downstream barrier is short one count forever and a mid-fence
        # scale() wedges.  settle_tokens() proxies exactly the
        # sent-minus-forwarded tail on death.
        sent_tokens: dict[int, list] = {}
        rr = 0
        current_epoch = 0
        tally = FenceTally(self.upstream_members())
        held: list[BatchEnvelope] = []
        # decode-session stickiness: session id -> the member holding its
        # KV cache at this stage.  Router-thread-local like the routing
        # set itself; opens pin (policy pick), steps follow the pin,
        # closes unpin, and a member leaving the set displaces its
        # sessions (note_displaced).  Session envelopes carry exactly one
        # extent, so an envelope never needs splitting to route sticky.
        affinity: dict = {}

        def displace_sessions(m: ComputeNode) -> None:
            owned = [s for s, mm in affinity.items() if mm is m]
            for s in owned:
                del affinity[s]
            if owned and self.note_displaced is not None:
                self.note_displaced(owned)

        def fail_extents(extents, why: str,
                         retryable: bool = False) -> None:
            if self.fail_batch is not None:
                self.fail_batch(extents, error=why, retryable=retryable)

        def fail_stranded(m: ComputeNode) -> None:
            """Fail the batches stranded in a dead link's buffers: the
            unconsumed tail of its FIFO, counted by the channel's
            outstanding credits.  A batch the replica had in fact already
            consumed may be failed spuriously (its late result is then
            ignored by the collector) — at-most-once on a dying link,
            never a hang.  For a process-backed member
            (``lost_on_death``) the replica's own pipeline died with the
            link, so the CONSUMED-but-unfinished batches are gone too:
            the whole ledger fails, and entries whose results already
            reached the collector resolve to no-ops there."""
            dq = ledger.pop(id(m), None)
            if not dq:
                return
            if getattr(m, "lost_on_death", False):
                entries = list(dq)
            else:
                try:
                    k = m.inbox.qsize()
                except Exception:  # deferlint: swallow(depth probe on a dying link; 0 means nothing stranded)
                    k = 0
                if not k:
                    return
                entries = list(dq)[-k:]
            for entry in entries:
                if entry is not None:
                    # a dead link/replica is an infrastructure failure:
                    # the reliability layer may replay through the healed
                    # routing set (spurious failures resolve to no-ops at
                    # the collector's at-most-once merge)
                    fail_extents(
                        entry,
                        f"stage {self.index} replica {m.replica}: inbox "
                        "link died with this batch in flight "
                        "(undeliverable)",
                        retryable=True)

        def settle_tokens(m: ComputeNode) -> None:
            """Proxy the control tokens a dead member was SENT but never
            forwarded.  Joining the member's threads first makes the
            forwarded count final (and means everything it DID flush is
            already downstream, so the proxies cannot overtake it); only
            members exposing ``forwarded_tokens`` — process-backed, whose
            consumed-but-unforwarded copies die with the process — need
            this, and only they are tracked in ``sent_tokens``."""
            rec = sent_tokens.pop(id(m), None)
            if rec is None:
                return
            base, tokens = rec
            for t in m._threads:
                t.join(self._FLUSH_JOIN_S)
            owed = tokens[m.forwarded_tokens() - base:]
            try:
                if m.next_inbox is not None:
                    for item in owed:
                        m.next_inbox.send(item)
            except (ChannelClosed, OSError):
                pass            # downstream gone too: nothing owed

        def on_member_death(m: ComputeNode) -> None:
            """Heal the routing set; the dead member's fence/stop copies
            are proxied at the next broadcast."""
            if m in members:
                members.remove(m)
                dead.append(m)
            displace_sessions(m)
            fail_stranded(m)
            settle_tokens(m)

        def member_send(m: ComputeNode, item, data: bool = False) -> bool:
            """Send + ledger-record one item to a member.  A DEAD link
            (ChannelClosed/OSError) heals the routing set and fails the
            member's stranded batches — True/False tells the caller.  Any
            other send failure on a DATA envelope (e.g. a payload the
            framing refuses) propagates so the caller fails exactly that
            batch WITHOUT retiring a healthy replica; for control tokens
            (always frameable) any failure is link-shaped."""
            try:
                m.inbox.send(item)
            except (ChannelClosed, OSError):
                on_member_death(m)
                return False
            except Exception:
                if data:
                    raise
                on_member_death(m)
                return False
            ledger.setdefault(id(m), deque(maxlen=self._ledger_depth(m))) \
                .append(item.extents if isinstance(item, BatchEnvelope)
                        else None)
            if not isinstance(item, BatchEnvelope) \
                    and getattr(m, "forwarded_tokens", None) is not None:
                rec = sent_tokens.setdefault(id(m), [0, []])
                rec[1].append(item)
                if len(rec[1]) > 16:
                    # drop the confirmed-forwarded prefix (a stale read
                    # only under-prunes — the relay count is monotonic)
                    k = min(m.forwarded_tokens() - rec[0], len(rec[1]))
                    if k > 0:
                        del rec[1][:k]
                        rec[0] += k
            return True

        def probe_members() -> None:
            """Proactively heal members whose channel reports itself dead
            (the transport noticed the peer process vanish).  Waiting for
            a send to fail is not enough: under lqd a dead member whose
            frozen depth exceeds its siblings' is never picked again, so
            its stranded batches' futures would hang until shutdown."""
            for m in list(members):
                if getattr(m.inbox, "dead", False):
                    on_member_death(m)

        def route(env: BatchEnvelope) -> None:
            nonlocal rr
            probe_members()
            if not members:
                raise ChannelClosed(
                    f"stage {self.index}: no live replicas (all inbox "
                    "links dead)")
            ext = env.extents[0] if len(env.extents) == 1 else None
            sess = ext.session if ext is not None else None
            if sess is not None:
                pinned = affinity.get(sess)
                if ext.kind == K_CLOSE:
                    affinity.pop(sess, None)
                if pinned is not None:
                    if pinned in members:
                        if not member_send(pinned, env, data=True):
                            raise ChannelClosed("routed onto a dead link")
                        return
                    # pin points outside the routing set (member drained
                    # or died since): fall through to a policy pick — an
                    # open re-prefills there; a step meets SessionLost at
                    # a replica with no cache, which is the truth
                    affinity.pop(sess, None)
            if len(members) == 1:
                pick = 0
            elif self.routing == "lqd":
                depth = [m.inbox.qsize() for m in members]
                lo = min(depth)
                # ties (and the idle case) rotate round-robin
                pick = min((i for i, d in enumerate(depth) if d == lo),
                           key=lambda i: (i - rr) % len(members))
            else:
                pick = rr % len(members)
            rr = (pick + 1) % len(members)
            target = members[pick]
            if not member_send(target, env, data=True):
                raise ChannelClosed("routed onto a dead link")
            if sess is not None and ext.kind in (K_OPEN, K_STEP):
                affinity[sess] = target

        def broadcast(item) -> None:
            """One control token to every member.  A member whose link
            dies moves to ``dead``; every dead member's copy is proxied
            into its downstream channel so the next stage's barrier/stop
            counting stays exact (the dead replica's own egress will
            never forward it — its ingress self-retired).  Before
            proxying, the dead member's threads get a bounded join: once
            they have exited, everything it flushed is already in the
            downstream channel, so the proxied token cannot overtake its
            pre-fence work (if the join times out — a wedged replica —
            the proxy goes ahead rather than deadlocking the router)."""
            probe_members()     # a dead member's copy must be proxied, not
            for m in list(members):     # lost in its socket's doomed buffer
                member_send(m, item)
            for m in dead:
                for t in m._threads:
                    t.join(self._FLUSH_JOIN_S)
                try:
                    if m.next_inbox is not None:
                        m.next_inbox.send(item)
                except (ChannelClosed, OSError):
                    pass                # downstream gone too: nothing owed

        def fail(env: BatchEnvelope, exc: BaseException) -> None:
            import traceback
            # link-shaped routing failures are retryable (the set heals,
            # a respawn lands); anything else — e.g. a payload the framing
            # refuses — would fail identically on every attempt
            fail_extents(env.extents, traceback.format_exc(),
                         retryable=isinstance(exc, (ChannelClosed, OSError)))

        while True:
            try:
                item = self.input.recv()
            except ChannelClosed:
                # the stage's input link died: nothing will ever arrive
                # again — fail anything still held at a fence barrier (its
                # fence can no longer complete), then flush the replicas
                # out so shutdown can join them
                for env in held:
                    fail_extents(
                        env.extents,
                        f"stage {self.index}: input link died with this "
                        "batch held at an epoch fence (undeliverable)",
                        retryable=True)
                broadcast(_STOP)
                return
            if item is _STOP:
                if not tally.on_stop():
                    continue
                broadcast(_STOP)
                return
            if isinstance(item, ReconfigMarker):
                e = item.epoch
                if not tally.on_marker(e, self.upstream):
                    continue
                # barrier complete: every upstream replica flushed the
                # fence, so all pre-fence work has arrived here
                with self._info_lock:
                    adds, drops = self._pending.pop(e, ([], []))
                members.extend(adds)
                with self._info_lock:
                    # record BEFORE broadcasting — the downstream barrier
                    # reads this when the first forwarded copy lands.
                    # Dead members count on both sides: their marker/stop
                    # copies arrive downstream via the proxy.
                    self._fence_info[e] = (
                        len(members) + len(dead),
                        len(members) - len(drops) + len(dead))
                broadcast(item)
                for m in drops:
                    if m in members:
                        members.remove(m)
                        # a drained member's resident KV caches retire
                        # with it: flag its sessions for re-prefill
                        displace_sessions(m)
                        try:
                            m.retire()  # queued behind the fence: flush+exit
                        except Exception:
                            # link died since the broadcast: a dropped
                            # member owes downstream nothing, but its
                            # stranded batches must still fail (the
                            # ledger is popped only on a clean retire —
                            # fail_stranded needs it), and any fence copy
                            # it never forwarded must be settled
                            fail_stranded(m)
                            settle_tokens(m)
                        else:
                            ledger.pop(id(m), None)     # clean exit: it
                            sent_tokens.pop(id(m), None)    # flushes all
                    elif m in dead:
                        # a dead member can't flush; its fence copy was
                        # proxied and its threads already self-retired —
                        # dropping it just stops the stop-proxying
                        dead.remove(m)
                current_epoch = e
                if held:
                    ready = [env for env in held if env.epoch <= e]
                    held = [env for env in held if env.epoch > e]
                    for env in ready:
                        try:
                            route(env)
                        except Exception as exc:
                            fail(env, exc)
                if tally.stopped:
                    # shutdown raced an in-flight drain fence: the last
                    # live stop arrived BEFORE this barrier lowered the
                    # expectation (the drained replica never stops), so
                    # re-check here or nobody ever will
                    broadcast(_STOP)
                    return
                continue
            env = item
            if env.epoch > current_epoch:
                held.append(env)            # post-fence overtaker: hold at
                continue                    # the barrier
            try:
                route(env)
            except Exception as exc:
                # fail exactly this batch's futures and keep routing —
                # a dying router would silently hang every client
                fail(env, exc)
