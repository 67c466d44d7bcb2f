"""Worker process entrypoint: one stage replica in its own OS process.

The twin of ``repro.runtime.worker``.  Run as
``python -m repro_torch.runtime.worker --connect HOST:PORT --token T``.
The worker dials the supervisor's control listener, identifies itself
with the spawn token, and then follows a strictly serial control loop on
that socket:

* ``ControlFrame("config")`` — set this process's device (the engine's,
  named by the frame's ``"device"``: a worker told ``cuda`` where CUDA is
  missing raises and the process exits nonzero, it never falls back to
  the CPU), build the layer graph locally (the graph *code* is
  pre-installed on every device, exactly the paper's setting; only
  topology and weights travel), dial both data channels back into the
  supervisor's private :class:`~repro_torch.runtime.transport.TcpTransport`
  listener (:func:`~repro_torch.runtime.transport.dial_channel` — the
  worker never opens a listener of its own), and build the
  :class:`~repro_torch.runtime.node.ComputeNode` this process serves on
  that device, its data codec too (q8 runs the block-quant kernel in
  this process).
* a framed :class:`~repro_torch.runtime.wire.ReconfigMarker` — the
  configuration step: architecture spec + weights arrive over the wire
  (``NodePlan`` framing, same bytes a live repartition ships) and the
  node materializes its partition.
* ``"precompile"`` / ``"start"`` / ``"knobs"`` — lifecycle and tuning,
  applied in order (the loop is serial, so a ``"start"`` can never
  overtake the config that precedes it).  After ``"start"`` the worker
  acks ``"ready"`` and begins heartbeating.  ``"ready"`` and every
  ``"hb"`` also carry the worker's ``device`` and its block-quant
  wrapper's ``launches`` / ``plain_calls`` counters, so the supervisor
  can show where the wire's kernel ran.
* ``"chaos"`` — fault injection (hang or dilate the compute stage),
  honored only when the process was launched with ``--chaos``;
  production spawns ignore it.

Everything after ``"start"`` is the normal data path: envelopes and
fence markers arrive on the worker's inbox channel exactly as they would
on an in-process replica, so live repartitions, scale fences, and the
_STOP/_RETIRE drain protocol all work unchanged across the process
boundary.

When the node's stage threads exit (a clean drain: _STOP or a retire
fence flushed it), the worker sends ``"bye"`` on the control socket and
exits — that frame is how the supervisor distinguishes a deliberate
drain from a crash (a crash is control-EOF *without* bye, or a missed
heartbeat).  Every auxiliary thread is a daemon: the process can always
exit, whatever state the chain was in.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import socket
import sys
import threading

import torch

from repro_torch.device import get_device, set_device
from repro_torch.kernels import block_quant
from repro_torch.runtime.node import ComputeNode
from repro_torch.runtime.transport import (dial_channel, recv_framed,
                                           send_framed)
from repro_torch.runtime.wire import (ControlFrame, ReconfigMarker,
                                      WireCodec, WireFormatError)


def load_graph_factory(spec: str):
    """Resolve ``"pkg.module:fn"`` or ``"/path/to/file.py:fn"`` to the
    graph-factory callable.  The file-path form lets test helpers and
    benchmark scripts that are not importable packages supply graphs."""
    modpath, sep, fn_name = spec.rpartition(":")
    if not sep or not modpath or not fn_name:
        raise ValueError(
            f"bad graph factory {spec!r} (want 'module:fn' or 'file.py:fn')")
    if modpath.endswith(".py"):
        if not os.path.isfile(modpath):
            raise ImportError(f"graph module {modpath!r} does not exist")
        name = "_defer_worker_graph"
        loader_spec = importlib.util.spec_from_file_location(name, modpath)
        if loader_spec is None or loader_spec.loader is None:
            raise ImportError(f"cannot load graph module {modpath!r}")
        mod = importlib.util.module_from_spec(loader_spec)
        sys.modules[name] = mod
        loader_spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(modpath)
    return getattr(mod, fn_name)


class Worker:
    """The per-process runtime around one :class:`ComputeNode`."""

    def __init__(self, sock: socket.socket, allow_chaos: bool = False):
        self._sock = sock
        self._send_lock = threading.Lock()
        self._allow_chaos = allow_chaos
        self._node: ComputeNode | None = None
        self._graph = None
        self._stage = -1
        self._hb_interval_s = 0.5
        self._stop = threading.Event()

    def _send(self, frame: ControlFrame) -> None:
        send_framed(self._sock, frame, lock=self._send_lock)

    def _status(self) -> dict:
        """What ``ready`` and ``hb`` carry beyond the reference's payload:
        the node's device and this process's block-quant counters by
        kernel, ``launches`` (the CUDA kernel) and ``plain_calls`` (its
        plain version, CPU tensors only)."""
        return {"device": str(self._node.device),
                "launches": dict(block_quant.launches),
                "plain_calls": dict(block_quant.plain_calls)}

    # -- control handlers -----------------------------------------------------
    def _on_config(self, p: dict) -> None:
        # the device first: a worker told "cuda" without CUDA raises here,
        # before it dials anything, and the process exits nonzero
        device = get_device(p.get("device"))
        set_device(device)
        # the engine's TF32 choice, so this replica computes as an
        # in-process one would (absent from a reference-shaped frame)
        tf32 = p.get("allow_tf32")
        if tf32 is not None:
            torch.backends.cudnn.allow_tf32 = bool(tf32["cudnn"])
            torch.backends.cuda.matmul.allow_tf32 = bool(tf32["matmul"])
        factory = load_graph_factory(p["graph_factory"])
        self._graph = factory(**(p.get("graph_args") or {}))
        # 4-element form predates the small-payload bypass: default it off
        ser, comp, rate, vec = p["data_codec"][:4]
        bypass = p["data_codec"][4] if len(p["data_codec"]) > 4 else 0
        codec = WireCodec(ser, comp, zfp_rate=rate, vectorized=vec,
                          small_bypass=bypass, device=device)
        host, port = p["host"], p["port"]
        self._stage = p["stage"]
        self._hb_interval_s = float(p.get("heartbeat_s", 0.5))
        inbox = dial_channel(host, port, p["in_cid"], role="recv",
                             capacity=p["in_capacity"])
        try:
            out = dial_channel(host, port, p["out_cid"], role="send",
                               capacity=p["out_capacity"])
        except BaseException:
            # the second dial failed: the first socket must not outlive
            # the config attempt (the supervisor will tear down and
            # respawn; a dangling dialed channel would hold its accept
            # slot forever)
            inbox.close()
            raise
        try:
            node = ComputeNode(
                p["stage"], codec, replica=p["replica"],
                max_batch=p["max_batch"], staged=p.get("staged", True),
                shape_buckets=p.get("shape_buckets", "exact"),
                max_batch_cap=p.get("max_batch_cap"),
                session_capacity=p.get("session_capacity", 64) or 64,
                inbox=inbox, device=device)
            node.coalesce_s = float(p["coalesce_s"])
            node.next_inbox = out
        except BaseException:
            inbox.close()
            out.close()
            raise
        self._node = node

    def _on_knobs(self, p: dict) -> None:
        node = self._node
        if node is None:
            return
        if "max_batch" in p:
            node.max_batch = min(max(1, int(p["max_batch"])),
                                 node.max_batch_cap)
        if "coalesce_s" in p:
            node.coalesce_s = max(0.0, float(p["coalesce_s"]))

    def _on_chaos(self, p: dict) -> None:
        if not self._allow_chaos:
            return          # fault injection is opt-in at spawn time
        if p.get("action") == "hang_compute":
            # replace the partition apply with a wait that never
            # completes: the compute stage wedges mid-batch while every
            # OTHER thread (ingress, heartbeat, control) stays perfectly
            # healthy — the scenario heartbeat-only detection must NOT
            # page on, and stall detection (snapshot frozen + inbox
            # backlog) must
            hang = threading.Event()
            self._node._apply = lambda *_a, **_k: hang.wait()
        elif p.get("action") == "slow_compute":
            # dilate each apply by a host-side sleep: batches dwell in
            # compute long enough for chaos tests to land a SIGKILL
            # reliably *mid-batch*, and for slow-but-alive workers to
            # exercise the no-false-positive side of failure detection
            delay = float(p.get("delay_s", 0.05))
            orig = self._node._apply
            pause = threading.Event()
            self._node._apply = (lambda *a, _o=orig, **k:
                                 (pause.wait(delay), _o(*a, **k))[1])

    def _on_start(self) -> None:
        self._node.start()
        threading.Thread(target=self._heartbeat_loop, daemon=True).start()
        threading.Thread(target=self.drain, daemon=True).start()
        self._send(ControlFrame("ready", {"pid": os.getpid(),
                                          **self._status()}))

    # -- background threads ---------------------------------------------------
    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self._hb_interval_s):
            try:
                self._send(ControlFrame(
                    "hb", {"snapshot": self._node.snapshot(),
                           **self._status()}))
            except OSError:
                return      # control stream gone: the supervisor owns cleanup

    def drain(self) -> None:
        """Wait for the node's stage threads to exit — a clean flush via
        _STOP or a retire fence — then send the deliberate ``"bye"`` and
        unblock the main control loop so the process exits zero."""
        self._node.join()
        self._stop.set()
        try:
            self._send(ControlFrame("bye", {}))
        except OSError:
            pass            # supervisor already gone; exiting is enough
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass            # racing close: the control loop is done anyway

    # -- the serial control loop ----------------------------------------------
    def run(self) -> int:
        while True:
            try:
                item = recv_framed(self._sock)
            except (WireFormatError, OSError):
                # control EOF: a drained worker already sent bye; anything
                # else means the supervisor died — either way, exit (all
                # other threads are daemons)
                return 0
            if isinstance(item, ReconfigMarker):
                # the configuration step: the initial partition arrives as
                # the same NodePlan framing a live repartition ships
                plan = item.plans.get(self._stage)
                if plan is not None and self._node is not None:
                    self._node.configure(
                        self._graph, plan.lo, plan.hi, plan.arch_blob,
                        plan.weights_blob, plan.weights_codec)
                continue
            if not isinstance(item, ControlFrame):
                continue
            if item.kind == "config":
                self._on_config(item.payload)
            elif item.kind == "precompile":
                self._node.precompile()
            elif item.kind == "start":
                self._on_start()
            elif item.kind == "knobs":
                self._on_knobs(item.payload)
            elif item.kind == "chaos":  # deferlint: control-verb(sent by the tools/torch_chaos.py harness, not the supervisor)
                self._on_chaos(item.payload)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.worker",
        description="DEFER stage-replica worker (spawned by the "
                    "runtime supervisor; not usually run by hand)")
    ap.add_argument("--connect", required=True, metavar="HOST:PORT",
                    help="the supervisor's control listener")
    ap.add_argument("--token", default="",
                    help="spawn token identifying this replica slot")
    ap.add_argument("--chaos", action="store_true",
                    help="honor ControlFrame('chaos') fault injection")
    args = ap.parse_args(argv)
    host, _, port = args.connect.rpartition(":")
    sock = socket.create_connection((host, int(port)), timeout=10.0)
    try:
        # the timeout covers CONNECTING only: left on the socket it would
        # turn any 10s-quiet control stream into a TimeoutError in the recv
        # loop — read as "supervisor died", exiting a perfectly healthy
        # worker
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        worker = Worker(sock, allow_chaos=args.chaos)
        send_framed(sock, ControlFrame(
            "hello", {"token": args.token, "pid": os.getpid()}))
    except BaseException:
        sock.close()
        raise
    return worker.run()


if __name__ == "__main__":
    code = main()
    # a drained worker leaves at once: interpreter finalization would run
    # C++ static destructors (torch's thread pools, the CUDA context)
    # beside daemon threads that may still be inside them, which can
    # abort the process (SIGABRT) after it said bye
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
