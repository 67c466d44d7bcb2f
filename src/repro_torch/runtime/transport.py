"""Pluggable transports: the link between DEFER runtime entities.

Every hop in the serving topology — pump -> stage router, router -> replica
inbox, replica egress -> next stage, last stage -> collector — is a
:class:`Channel` obtained from a :class:`Transport`.  The wire *format*
(:class:`~repro_torch.runtime.wire.BatchEnvelope` framing plus the
:func:`~repro_torch.runtime.wire.frame`/:func:`~repro_torch.runtime.wire.unframe`
channel-item envelope) is transport-agnostic; a transport only moves
already-encoded items between endpoints, so stage specs select a backend
by name (:class:`~repro_torch.runtime.topology.StageSpec.transport`) without
touching the codec or batching layers.

Three backends ship in-tree:

* ``"inproc"`` — a bounded thread-safe queue, the default.  Exactly the
  structure the chain used before transports existed, so the staged-relay
  backpressure semantics (a full channel blocks the sender) are unchanged.
* ``"tcp"`` — real loopback/LAN sockets (:class:`TcpTransport`): one
  listener + connection pool per transport instance, every channel item
  framed to bytes (:func:`~repro_torch.runtime.wire.frame`, length-prefixed on
  the stream, no pickle), and a credit window so ``send`` blocks at
  ``capacity`` outstanding items — the kernel socket buffer cannot silently
  widen the staged-relay backpressure contract.  ``qsize`` is the
  outstanding-credit count, so least-queue-depth routing keeps working.
* ``"link:<bw>,<latency>[,<jitter>]"`` — :class:`LinkTransport`, the
  paper's CORE-emulated Ethernet without privileges: items are framed to
  bytes and delivery is shaped by a serialization delay (``bytes / bw``),
  a propagation latency, and optional uniform jitter (FIFO preserved by a
  monotonic-ready clamp, like TCP ordering under CORE).  E.g.
  ``"link:10mbit,20ms"`` or ``"link:1gbit,2ms,1ms"``; bare ``"link"`` is
  100 Mbit / 5 ms (the paper's Ethernet).

``recv_nowait``/``recv(timeout=)`` raise :class:`queue.Empty`, mirroring
the stdlib so the node stage loops keep their idioms.  A channel whose
peer vanished (socket reset, :meth:`Channel.kill`) raises
:class:`ChannelClosed` from ``send``/``recv`` — the runtime turns that
into a per-batch failure plus a self-retiring replica instead of a hang.

New backends register with :func:`register_transport` (a plain name) or
:func:`register_transport_scheme` (a ``scheme:args`` family like
``link:``).  Re-registering a name whose live instance still backs
channels is refused — a live engine would otherwise keep sending into a
transport the registry no longer knows — until those channels are closed
(``Dispatcher.shutdown`` closes every channel it opened) or the caller
passes ``force=True``.
"""
from __future__ import annotations

import queue
import random
import socket
import struct
import threading
import time
from collections import deque
from typing import Any, Callable

from repro_torch.runtime import wire as _wire

Empty = queue.Empty


class ChannelClosed(Exception):
    """The channel's peer is gone (socket reset / killed link): sends and
    recvs can never complete.  Distinct from :class:`queue.Empty` so the
    node stage loops can tell "nothing yet" from "never again"."""


class Channel:
    """One directed edge between runtime entities.

    ``send`` blocks when the channel is at capacity (backpressure is the
    runtime's flow control); ``recv`` blocks until an item arrives.  Items
    are opaque to the channel: envelopes, fence markers, and the stop
    token all ride the same FIFO, which is what makes the epoch fence
    ordering argument work on any transport that preserves per-channel
    FIFO delivery.
    """

    def send(self, item: Any) -> None:
        raise NotImplementedError

    def recv(self, timeout: float | None = None) -> Any:
        raise NotImplementedError

    def recv_nowait(self) -> Any:
        raise NotImplementedError

    def qsize(self) -> int:
        """Queued-item count, used as the least-queue-depth routing signal.
        Backends without cheap introspection keep this default: 0 for
        every channel makes lqd degrade gracefully to round-robin."""
        return 0

    @property
    def dead(self) -> bool:
        """True once the channel can never carry another item (killed, or
        the peer endpoint is known gone).  Routers probe this so a member
        whose process died is healed even while no send is in flight —
        without it, stranded batches would wait for the next send to that
        member, which under least-queue-depth routing may never come.
        Backends without liveness knowledge keep the default False."""
        return False

    def close(self) -> None:
        """Release the channel's resources and drop it from its owning
        transport's live count (see :func:`register_transport`).  Safe to
        call twice; the base implementation only does the bookkeeping."""
        tr = getattr(self, "_owner", None)
        if tr is not None and not getattr(self, "_untracked", False):
            self._untracked = True
            tr._live_channels = max(0, tr.live_channels - 1)


class InprocChannel(Channel):
    """The default transport's channel: a bounded in-process queue."""

    def __init__(self, capacity: int = 0):
        self._q: queue.Queue = queue.Queue(maxsize=capacity)

    def send(self, item: Any) -> None:
        self._q.put(item)

    def recv(self, timeout: float | None = None) -> Any:
        return self._q.get(timeout=timeout)

    def recv_nowait(self) -> Any:
        return self._q.get_nowait()

    def qsize(self) -> int:
        return self._q.qsize()


class Transport:
    """A channel factory.  Subclasses back channels with a different
    medium (sockets, an emulated lossy/slow link, shared memory).

    Backends that call :meth:`_track` on the channels they hand out get
    live-channel accounting for free: :func:`register_transport` refuses
    to replace an instance that still backs open channels.  Backends that
    skip it degrade gracefully (``live_channels`` stays 0)."""

    name = "abstract"

    def channel(self, capacity: int = 0) -> Channel:
        raise NotImplementedError

    @property
    def live_channels(self) -> int:
        return getattr(self, "_live_channels", 0)

    def _track(self, ch: Channel) -> Channel:
        self._live_channels = self.live_channels + 1
        ch._owner = self
        return ch


class InprocTransport(Transport):
    name = "inproc"

    def channel(self, capacity: int = 0) -> Channel:
        return self._track(InprocChannel(capacity))


# -- TCP sockets ---------------------------------------------------------------

def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise ConnectionError on EOF."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise ConnectionError("socket closed mid-frame")
        got += k
    return bytes(buf)


def _recv_u32(sock: socket.socket, what: str) -> int:
    """Read one little-endian u32 header field through the wire bounds
    gate, so a truncated or malformed peer surfaces as WireFormatError
    (the per-channel fault the read loops already translate into a clean
    channel death) instead of a bare struct.error."""
    try:
        buf = _recv_exact(sock, 4)
    except ConnectionError as e:
        raise _wire.WireFormatError(f"truncated {what}: {e}") from e
    _wire._checked(buf, 0, 4, what)
    (v,) = struct.unpack("<I", buf)
    return v


_CLOSED = object()      # reader-thread sentinel: the stream is gone


class _CreditWindow:
    """Bounded-in-flight accounting shared by the byte transports: at
    most ``capacity`` unconsumed sends may be outstanding (0 =
    unbounded), and ``outstanding()`` is the depth signal ``qsize``
    reports.  One implementation so the backpressure invariant — and its
    kill/rollback edge cases — cannot drift between backends."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._sem = threading.Semaphore(capacity) if capacity > 0 else None
        self._outstanding = 0
        self._lock = threading.Lock()

    def take(self, is_killed) -> None:
        """Block for a credit, then count one outstanding item.  Raises
        :class:`ChannelClosed` if the channel died while blocked (kill
        floods the semaphore so blocked senders wake)."""
        if self._sem is not None:
            self._sem.acquire()
            if is_killed():
                self._sem.release()
                raise ChannelClosed("channel was killed")
        with self._lock:
            self._outstanding += 1

    def untake(self) -> None:
        """Roll back a take whose send failed."""
        with self._lock:
            self._outstanding -= 1
        if self._sem is not None:
            self._sem.release()

    def consumed(self) -> None:
        """One item left the window (receiver consumed it)."""
        with self._lock:
            self._outstanding -= 1
        if self._sem is not None:
            self._sem.release()

    def outstanding(self) -> int:
        with self._lock:
            return self._outstanding

    def flood(self) -> None:
        """Open the window wide so senders blocked on a credit that will
        never come wake up and see the kill flag."""
        if self._sem is not None:
            for _ in range(self.capacity + 1):
                self._sem.release()


class TcpChannel(Channel):
    """One TCP connection carrying framed channel items one way and
    credit bytes the other way.

    The sender may not outrun the consumer: with ``capacity > 0`` each
    ``send`` takes a credit and each *consumed* ``recv`` returns one (a
    single byte on the reverse half of the connection), so at most
    ``capacity`` items are in flight across the socket buffer and the
    receive queue combined — the staged-relay backpressure contract,
    independent of kernel buffer sizing.  ``qsize`` reports the
    outstanding (sent-but-unconsumed) count, which is exactly the depth
    signal lqd routing wants."""

    def __init__(self, capacity: int = 0):
        self.capacity = capacity
        self._window = _CreditWindow(capacity)
        self._send_lock = threading.Lock()
        self._recv_q: queue.Queue = queue.Queue()
        self._send_sock: socket.socket | None = None
        self._recv_sock: socket.socket | None = None
        self._attached = threading.Event()
        self._killed = False
        self._peer_lost = False

    # -- wiring (transport-internal) ------------------------------------------
    def _open_send_side(self, sock: socket.socket) -> None:
        self._send_sock = sock
        threading.Thread(target=self._credit_loop, daemon=True).start()

    def _attach(self, conn: socket.socket) -> None:
        self._recv_sock = conn
        threading.Thread(target=self._read_loop, daemon=True).start()
        self._attached.set()

    def _credit_loop(self) -> None:
        sock = self._send_sock
        try:
            while True:
                b = sock.recv(4096)
                if not b:
                    return
                for _ in range(len(b)):
                    self._window.consumed()
        except OSError:
            return
        finally:
            # a dead credit stream would block senders forever: flood the
            # window open so their next send hits the socket error instead
            self._peer_lost = True
            self._window.flood()

    def _read_loop(self) -> None:
        sock = self._recv_sock
        try:
            while True:
                ln = _recv_u32(sock, "tcp frame length prefix")
                self._recv_q.put(_wire.unframe(_recv_exact(sock, ln)))
        except (OSError, ConnectionError, _wire.WireFormatError):
            # EOF, reset, or an unrecoverable framing desync: the stream
            # cannot be resynchronized, so the channel is dead
            self._peer_lost = True
            self._recv_q.put(_CLOSED)

    # -- Channel API ----------------------------------------------------------
    def wait_attached(self, timeout: float = 10.0) -> None:
        """Block until the peer wires this half (expect_channel halves
        are exposed before their remote peer dials in)."""
        if not self._attached.wait(timeout):
            raise ChannelClosed(
                f"tcp half-channel peer never attached within {timeout}s")

    def send(self, item: Any) -> None:
        if self._killed:
            raise ChannelClosed("tcp channel was killed")
        if not self._attached.is_set():
            # an expect_channel send half raced its peer's dial: the
            # accept loop wires it asynchronously, so wait instead of
            # tripping over a not-yet-assigned socket
            self.wait_attached()
            if self._killed:
                raise ChannelClosed("tcp channel was killed")
        blob = _wire.frame(item)
        if len(blob) >= 1 << 32:
            # validated BEFORE any credit accounting so an oversized
            # payload is a clean per-item error, not a leaked credit
            raise _wire.WireFormatError(
                f"frame of {len(blob)} bytes exceeds the 4-byte length "
                "prefix (max 4 GiB per channel item)")
        self._window.take(lambda: self._killed)
        try:
            with self._send_lock:
                if len(blob) <= 64 * 1024:
                    # small frame: one packet, the copy is cheap
                    self._send_sock.sendall(
                        struct.pack("<I", len(blob)) + blob)
                else:
                    # big frame: two sendalls instead of re-copying a
                    # multi-MB payload just to prepend 4 bytes
                    self._send_sock.sendall(struct.pack("<I", len(blob)))
                    self._send_sock.sendall(blob)
        except (OSError, AttributeError) as e:
            self._window.untake()
            raise ChannelClosed(f"tcp send failed: {e}") from e

    def _take(self, item: Any) -> Any:
        if item is _CLOSED:
            self._recv_q.put(_CLOSED)       # keep raising for later recvs
            raise ChannelClosed("tcp channel closed by peer")
        try:
            self._recv_sock.sendall(b"\x01")    # return one credit
        except OSError:
            pass                            # sender gone; item still valid
        return item

    def recv(self, timeout: float | None = None) -> Any:
        return self._take(self._recv_q.get(timeout=timeout))

    def recv_nowait(self) -> Any:
        return self._take(self._recv_q.get_nowait())

    def qsize(self) -> int:
        return self._window.outstanding()

    @property
    def dead(self) -> bool:
        return self._killed or self._peer_lost

    def kill(self) -> None:
        """Sever the connection as a network failure would: both socket
        halves close, in-flight frames are lost, the next ``send`` raises
        :class:`ChannelClosed` and blocked ``recv`` callers wake with the
        same — the failure-injection hook the kill-the-socket tests use."""
        self._killed = True
        self._attached.set()        # unblock senders waiting on a peer
        for s in (self._send_sock, self._recv_sock):    # that never dials
            if s is not None:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass
        self._window.flood()            # wake senders blocked on a credit
        self._recv_q.put(_CLOSED)       # that will never come

    def close(self) -> None:
        self.kill()
        super().close()


class TcpTransport(Transport):
    """Real sockets on loopback (or a LAN host): one listening socket per
    transport instance, one pooled connection per channel, channel items
    length-prefix framed on the stream (:func:`~repro_torch.runtime.wire.frame`,
    no pickle).  The listener binds lazily on the first ``channel()``
    call, so merely *validating* a spec that names ``"tcp"`` opens no
    sockets."""

    name = "tcp"

    # a connection that sends a partial hello then stalls would otherwise
    # pin the single accept thread forever (half-open handshake): the
    # hello read runs under this socket timeout and a stalled client is
    # dropped, after which the accept loop serves the next connection
    handshake_timeout_s = 5.0

    def __init__(self, host: str = "127.0.0.1"):
        self._host = host
        self._listener: socket.socket | None = None
        self._pending: dict[int, TcpChannel] = {}
        self._roles: dict[int, str] = {}    # cid -> local half ("send"/"recv")
        self._next_cid = 0
        self._lock = threading.Lock()

    @property
    def address(self) -> tuple[str, int] | None:
        """(host, port) of the listener, once bound."""
        return (self._listener.getsockname() if self._listener is not None
                else None)

    def _ensure_listener(self) -> None:
        with self._lock:
            if self._listener is not None:
                return
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            try:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind((self._host, 0))
                s.listen(128)
            except BaseException:
                s.close()
                raise
            self._listener = s
            threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            try:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                # the 4-byte hello names the channel this connection backs.
                # socket.timeout is an OSError, so a half-open client that
                # stalls mid-hello lands here and is dropped
                conn.settimeout(self.handshake_timeout_s)
                cid = _recv_u32(conn, "tcp channel hello")
                conn.settimeout(None)       # read loops expect blocking IO
            except (OSError, ConnectionError, _wire.WireFormatError):
                conn.close()
                continue
            with self._lock:
                ch = self._pending.pop(cid, None)
                role = self._roles.pop(cid, "recv")
            if ch is None:
                conn.close()
                continue
            if role == "send":
                # a half-channel registered by expect_channel(role="send"):
                # this side only transmits, the dialing peer receives
                ch._open_send_side(conn)
                ch._attached.set()
            else:
                ch._attach(conn)

    def channel(self, capacity: int = 0) -> Channel:
        self._ensure_listener()
        ch = TcpChannel(capacity)
        with self._lock:
            cid = self._next_cid
            self._next_cid += 1
            self._pending[cid] = ch
        sock = None
        try:
            sock = socket.create_connection(self.address, timeout=10.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.sendall(struct.pack("<I", cid))
            ch._open_send_side(sock)
            if not ch._attached.wait(10.0):
                raise ChannelClosed("tcp accept timed out")
        except Exception as e:
            # failed mid-handshake: un-register the pending slot (a late
            # accept must not wire a conn onto a discarded channel) and
            # close the socket (which also ends its credit thread)
            with self._lock:
                self._pending.pop(cid, None)
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            if isinstance(e, ChannelClosed):
                raise
            raise ChannelClosed(f"tcp channel setup failed: {e}") from e
        return self._track(ch)

    def expect_channel(self, capacity: int = 0,
                       role: str = "send") -> tuple[TcpChannel, int]:
        """Register a cross-process half-channel and return ``(channel,
        cid)``.  A remote peer completes it by dialing this transport's
        listener and sending ``cid`` as the hello
        (:func:`dial_channel`); until then the local half is unattached
        (``wait_attached``).  ``role`` names the LOCAL half: ``"send"``
        (this process transmits, the peer receives — e.g. a worker's
        inbox held by the supervisor) or ``"recv"`` (the peer transmits
        into this process — e.g. a worker's output stream).  Unlike
        :meth:`channel`, nothing dials back: the peer only ever connects
        *in*, so workers never need a listener of their own."""
        if role not in ("send", "recv"):
            raise ValueError(f"bad channel role {role!r}")
        self._ensure_listener()
        ch = TcpChannel(capacity)
        with self._lock:
            cid = self._next_cid
            self._next_cid += 1
            self._pending[cid] = ch
            self._roles[cid] = role
        return self._track(ch), cid

    def unexpect_channel(self, cid: int) -> None:
        """Drop a pending expect_channel registration whose peer never
        arrived (spawn failure cleanup): a late dial with this cid then
        meets a closed connection instead of wiring a discarded channel."""
        with self._lock:
            self._pending.pop(cid, None)
            self._roles.pop(cid, None)

    def close(self) -> None:
        """Close the listener socket (the accept thread exits).  Already
        wired channels keep their pooled connections; pending
        expect_channel halves can no longer be completed.  For private
        transport instances (e.g. a supervisor's data plane) — the shared
        registry instance from :func:`get_transport` should outlive any
        one engine."""
        with self._lock:
            listener = self._listener
        if listener is not None:
            try:
                listener.close()
            except OSError:
                pass


def dial_channel(host: str, port: int, cid: int, role: str,
                 capacity: int = 0, timeout: float = 10.0) -> TcpChannel:
    """Complete a half-channel a remote :meth:`TcpTransport.expect_channel`
    registered: connect to its listener, send the cid hello, and wire the
    LOCAL half (``role``: ``"send"`` or ``"recv"`` — the opposite of what
    the registering side chose).  The worker-side entry point for
    cross-process channels."""
    if role not in ("send", "recv"):
        raise ValueError(f"bad channel role {role!r}")
    # build the channel before connecting: once the socket exists, every
    # remaining step either hands it off or closes it
    ch = TcpChannel(capacity)
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.sendall(struct.pack("<I", cid))
        sock.settimeout(None)               # read loops expect blocking IO
    except OSError as e:
        try:
            sock.close()
        except OSError:
            pass
        raise ChannelClosed(f"tcp dial failed: {e}") from e
    if role == "send":
        ch._open_send_side(sock)
        ch._attached.set()
    else:
        ch._attach(sock)
    return ch


# -- framed control streams (supervisor <-> worker sideband) -------------------

def send_framed(sock: socket.socket, item: Any,
                lock: threading.Lock | None = None) -> None:
    """Write one channel item onto a raw socket with the same
    ``[u32 length][wire.frame bytes]`` layout the TCP channels speak.
    Used by the supervisor/worker control sockets, which carry
    :class:`~repro_torch.runtime.wire.ControlFrame` heartbeats and the initial
    :class:`~repro_torch.runtime.wire.ReconfigMarker` config+weights handoff
    without the credit-window machinery (control traffic is tiny and
    strictly request/reply or periodic)."""
    blob = _wire.frame(item)
    if len(blob) >= 1 << 32:
        raise _wire.WireFormatError(
            f"control frame of {len(blob)} bytes exceeds the 4-byte "
            "length prefix")
    payload = struct.pack("<I", len(blob)) + blob
    if lock is not None:
        with lock:
            sock.sendall(payload)
    else:
        sock.sendall(payload)


def recv_framed(sock: socket.socket) -> Any:
    """Read one ``[u32 length][wire.frame bytes]`` item from a raw socket
    (blocking; honors the socket's own timeout).  EOF or truncation raise
    :class:`~repro_torch.runtime.wire.WireFormatError` like every other wire
    read."""
    ln = _recv_u32(sock, "control frame length prefix")
    return _wire.unframe(_recv_exact(sock, ln))


# -- emulated link (the paper's CORE conditions, unprivileged) -----------------

_UNITS = {"bit": 1 / 8, "kbit": 125.0, "mbit": 125e3, "gbit": 125e6,
          "kbps": 125.0, "mbps": 125e3, "gbps": 125e6,
          "b": 1.0, "kb": 1e3, "mb": 1e6, "gb": 1e9}


def _parse_rate(tok: str) -> float:
    """'10mbit' -> bytes/second."""
    tok = tok.strip().lower()
    for unit in sorted(_UNITS, key=len, reverse=True):
        if tok.endswith(unit):
            try:
                return float(tok[: -len(unit)]) * _UNITS[unit]
            except ValueError:
                break
    raise ValueError(f"bad link bandwidth {tok!r} "
                     f"(want e.g. '10mbit', '1gbit', '500kbit')")


def _parse_time(tok: str) -> float:
    """'20ms' / '0.1s' / '150us' -> seconds."""
    tok = tok.strip().lower()
    for unit, mult in (("us", 1e-6), ("ms", 1e-3), ("s", 1.0)):
        if tok.endswith(unit):
            try:
                return float(tok[: -len(unit)]) * mult
            except ValueError:
                break
    raise ValueError(f"bad link time {tok!r} (want e.g. '20ms', '0.5s')")


class LinkChannel(Channel):
    """An in-process channel shaped like an emulated network link.

    Items are framed to bytes (the same no-pickle wire the TCP backend
    speaks), then delivery is shaped: a transmitter thread holds each
    frame for ``bytes / bandwidth`` seconds (serialization delay — the
    link is busy, so back-to-back frames queue behind each other exactly
    as on a real NIC), after which the item becomes receivable
    ``latency + U(0, jitter)`` later.  Ready times are clamped monotonic
    so jitter never reorders a FIFO stream (as TCP under CORE).  The
    credit window mirrors the TCP backend: at most ``capacity`` items in
    flight, ``qsize`` = outstanding."""

    def __init__(self, capacity: int, bandwidth_bytes_s: float,
                 latency_s: float, jitter_s: float, seed: int = 0):
        self.capacity = capacity
        self._bw = max(1.0, float(bandwidth_bytes_s))
        self._lat = max(0.0, float(latency_s))
        self._jit = max(0.0, float(jitter_s))
        self._rng = random.Random(seed)
        self._window = _CreditWindow(capacity)
        self._pending: queue.Queue = queue.Queue()
        self._cond = threading.Condition()
        self._ready: deque = deque()        # (ready_at, item), ready_at asc
        self._last_ready = 0.0
        self._killed = False
        threading.Thread(target=self._xmit_loop, daemon=True).start()

    def _xmit_loop(self) -> None:
        while True:
            blob = self._pending.get()
            if blob is _CLOSED:
                with self._cond:
                    self._cond.notify_all()
                return
            time.sleep(len(blob) / self._bw)        # link occupied
            delay = self._lat + (self._rng.uniform(0.0, self._jit)
                                 if self._jit else 0.0)
            item = _wire.unframe(blob)
            with self._cond:
                ready = max(time.monotonic() + delay, self._last_ready)
                self._last_ready = ready
                self._ready.append((ready, item))
                self._cond.notify_all()

    def send(self, item: Any) -> None:
        if self._killed:
            raise ChannelClosed("link channel was killed")
        blob = _wire.frame(item)
        self._window.take(lambda: self._killed)
        self._pending.put(blob)

    def _pop_ready_locked(self) -> Any:
        _, item = self._ready.popleft()
        self._window.consumed()
        return item

    def recv(self, timeout: float | None = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                now = time.monotonic()
                if self._ready and self._ready[0][0] <= now:
                    return self._pop_ready_locked()
                if self._killed and not self._ready:
                    raise ChannelClosed("link channel was killed")
                waits = []
                if self._ready:
                    waits.append(self._ready[0][0] - now)
                if deadline is not None:
                    if now >= deadline:
                        raise queue.Empty
                    waits.append(deadline - now)
                self._cond.wait(min(waits) if waits else None)

    def recv_nowait(self) -> Any:
        with self._cond:
            if self._ready and self._ready[0][0] <= time.monotonic():
                return self._pop_ready_locked()
            if self._killed and not self._ready:
                raise ChannelClosed("link channel was killed")
            raise queue.Empty

    def qsize(self) -> int:
        return self._window.outstanding()

    def kill(self) -> None:
        self._killed = True
        self._pending.put(_CLOSED)
        self._window.flood()
        with self._cond:
            self._cond.notify_all()

    def close(self) -> None:
        self.kill()
        super().close()


class LinkTransport(Transport):
    """Channels shaped by a configurable bandwidth / latency / jitter —
    the paper's CORE-emulated Ethernet reproduced without privileges.
    Registered bare as ``"link"`` (100 Mbit, 5 ms — the paper's links)
    and as the ``link:`` scheme: ``"link:10mbit,20ms"``,
    ``"link:1gbit,2ms,1ms"``."""

    name = "link"

    def __init__(self, bandwidth_bytes_s: float = 12.5e6,
                 latency_s: float = 0.005, jitter_s: float = 0.0,
                 seed: int = 0):
        self.bandwidth_bytes_s = float(bandwidth_bytes_s)
        self.latency_s = float(latency_s)
        self.jitter_s = float(jitter_s)
        self._seed = seed
        self._made = 0

    @classmethod
    def from_spec(cls, spec: str) -> "LinkTransport":
        """Parse '<bw>,<latency>[,<jitter>]' (the ``link:`` scheme args)."""
        parts = [p for p in spec.split(",") if p.strip()]
        if not 1 <= len(parts) <= 3:
            raise ValueError(
                f"bad link spec {spec!r} (want 'bw,latency[,jitter]', "
                "e.g. '10mbit,20ms' or '1gbit,2ms,1ms')")
        bw = _parse_rate(parts[0])
        lat = _parse_time(parts[1]) if len(parts) > 1 else 0.0
        jit = _parse_time(parts[2]) if len(parts) > 2 else 0.0
        return cls(bw, lat, jit)

    def channel(self, capacity: int = 0) -> Channel:
        self._made += 1
        return self._track(LinkChannel(
            capacity, self.bandwidth_bytes_s, self.latency_s, self.jitter_s,
            seed=self._seed + self._made))


# -- registry ------------------------------------------------------------------

_TRANSPORTS: dict[str, Callable[[], Transport]] = {
    "inproc": InprocTransport,
    "tcp": TcpTransport,
    "link": LinkTransport,
}
# scheme factories: "scheme:args" names resolve through these when the
# full name has no direct registration; each distinct full name still
# gets (and caches) its own shared instance
_SCHEMES: dict[str, Callable[[str], Transport]] = {
    "link": LinkTransport.from_spec,
}
_INSTANCES: dict[str, Transport] = {}


def register_transport(name: str, factory: Callable[[], Transport],
                       force: bool = False) -> None:
    """Make ``name`` usable as a :class:`StageSpec.transport` binding.

    Re-registering a name whose shared instance still backs live channels
    is refused: a running engine holds those channels, and silently
    swapping the instance out from under it would strand them (new
    channels on the new instance, old ones on an orphan).  Close the
    channels first (``Dispatcher.shutdown`` does) or pass ``force=True``
    to strand them knowingly."""
    inst = _INSTANCES.get(name)
    if inst is not None and inst.live_channels > 0 and not force:
        raise ValueError(
            f"transport {name!r} still backs {inst.live_channels} live "
            "channel(s) — re-registering would strand them; shut down the "
            "engine(s) using it (or pass force=True)")
    _TRANSPORTS[name] = factory
    _INSTANCES.pop(name, None)          # a re-registration replaces state


def register_transport_scheme(scheme: str,
                              factory: Callable[[str], Transport],
                              force: bool = False) -> None:
    """Register a parameterized transport family: any binding of the form
    ``"<scheme>:<args>"`` resolves through ``factory(args)``, one shared
    instance per distinct full name (so ``"link:10mbit,20ms"`` and
    ``"link:1gbit,1ms"`` are two independent links).

    Same strand protection as :func:`register_transport`, applied to
    every cached instance of the scheme: re-registration is refused
    while any such instance backs live channels (unless ``force``), and
    the stale cached instances are dropped so the new factory actually
    takes effect for already-resolved full names."""
    cached = [n for n in _INSTANCES if n.partition(":")[0] == scheme
              and n not in _TRANSPORTS]
    live = {n: _INSTANCES[n].live_channels for n in cached
            if _INSTANCES[n].live_channels > 0}
    if live and not force:
        raise ValueError(
            f"transport scheme {scheme!r} still backs live channels via "
            f"{sorted(live)} — re-registering would strand them; shut "
            "down the engine(s) using them (or pass force=True)")
    for n in cached:
        _INSTANCES.pop(n, None)
    _SCHEMES[scheme] = factory


def get_transport(name: str) -> Transport:
    """One shared instance per name: a stateful backend (socket listener,
    connection pool, emulated-link clock) keeps its state across every
    channel it backs; spec validation gets the same instance with no
    side effects."""
    inst = _INSTANCES.get(name)
    if inst is not None:
        return inst
    factory = _TRANSPORTS.get(name)
    if factory is None and ":" in name:
        scheme, _, args = name.partition(":")
        maker = _SCHEMES.get(scheme)
        if maker is not None:
            def factory(maker=maker, args=args):
                return maker(args)
    if factory is None:
        raise ValueError(
            f"unknown transport {name!r}; registered: "
            f"{sorted(_TRANSPORTS)} plus schemes "
            f"{sorted(s + ':' for s in _SCHEMES)}")
    inst = _INSTANCES[name] = factory()
    return inst
