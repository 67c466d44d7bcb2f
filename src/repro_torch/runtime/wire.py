"""The wire format between DEFER nodes: serialize -> compress -> chunk.

Every payload that crosses a (simulated) socket goes through here, so byte
counts and encode/decode timings are measured in one place.  Mirrors the
paper: 512 kB chunking, {JSON, ZFP, Q8} serializers x {LZ4, none}
compression, independent codec choice per payload type (architecture /
weights / data).

Since the staged-relay runtime, inter-node data payloads are **batch-level**:
a compute node encodes the stacked output of a whole continuous batch ONCE
and ships it as a single :class:`BatchEnvelope` whose *envelope* (not blob)
carries per-request row extents.  One ZFP/LZ4/Q8 pass amortizes fixed codec
cost across the batch and lets LZ4 find cross-request matches; the receiving
node decodes once and only the tail collector slices rows back out
(:func:`slice_parts`).  The wire blob itself is the same framed pytree
stream as before — ``encode_tree``/``decode_tree`` — so batch payloads and
config payloads share one format:

    [u32 leaf_count] then per leaf:
    [u32 name_len][name][u64 body_len][body = serializer(+lz4) bytes]

``request_id`` is globally unique (admission order) and is what the
collector demuxes results by; continuous batching may legally reorder
requests of *different* clients, and a client's own results still come back
FIFO because ``stream()`` awaits futures in submission order.

**Channel-item framing.**  Everything that rides a runtime
:class:`~repro_torch.runtime.transport.Channel` — data envelopes, the epoch
fence, and the ``_STOP``/``_RETIRE`` control tokens — round-trips through
:func:`frame`/:func:`unframe`, a versioned byte format with **no pickle**:
a socket or emulated-link transport moves exactly these bytes, so the
chain's control plane survives a real wire.  A truncated or corrupt buffer
raises :class:`WireFormatError` (never a bare ``struct.error``), which the
node stages surface as a per-batch failure while the chain keeps serving.
"""
from __future__ import annotations

import dataclasses
import io
import json
import struct
import time
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch.core import codecs
from repro_torch.core.graph import tree_flatten_with_path

CHUNK_BYTES = 512 * 1024


class WireFormatError(ValueError):
    """A wire payload failed framing validation (truncated, corrupt, or
    version-mismatched).  Raised instead of leaking ``struct.error`` /
    bare ``ValueError`` from the codec internals, so a dropped socket or
    a bit-flipped blob fails exactly the affected batch as a
    :class:`~repro_torch.runtime.dispatcher.NodeError` instead of killing a
    stage thread mid-loop."""


class _Token:
    """A chain control token (identity-compared singleton).  Framing maps
    each token to a dedicated frame type so ``unframe`` can return the
    very same singleton on the far side of a socket."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self) -> str:          # pragma: no cover - debugging aid
        return f"<{self.name}>"


# the shutdown token: trails every admitted envelope through the FIFO
# channels; each consumer counts one copy per upstream member
_STOP = _Token("STOP")
# the single-replica drain token: flows through one replica's internal
# stages like _STOP but exits WITHOUT signaling downstream, so a retired
# replica never perturbs the next stage's stop accounting
_RETIRE = _Token("RETIRE")


@dataclasses.dataclass
class WireRecord:
    kind: str                   # "architecture" | "weights" | "data"
    raw_bytes: int
    wire_bytes: int
    encode_s: float
    decode_s: float = 0.0
    # request routing (None for config-step payloads): lets per-payload
    # metrics be correlated back to the admission stream
    request_id: int | None = None
    client_id: int | None = None

    @property
    def chunks(self) -> int:
        return max(1, -(-self.wire_bytes // CHUNK_BYTES))


@dataclasses.dataclass
class Envelope:
    """One in-flight request's payload between chain hops (PR 1 wire).

    Superseded by :class:`BatchEnvelope` inside the staged runtime; kept as
    a public single-request view for tooling and tests.
    """

    request_id: int
    client_id: int
    seq: int                    # submission index within client
    blob: bytes
    t_submit: float = 0.0       # admission timestamp (perf_counter)


@dataclasses.dataclass(frozen=True)
class RowExtent:
    """One request's slice of a batch payload: rows [offset..offset+rows)
    along axis 0 of every leaf, where offset is the sum of preceding
    extents' rows.  Routing metadata rides the envelope, not the blob."""

    request_id: int
    client_id: Any
    seq: int                    # submission index within client
    rows: int                   # this request's rows in the stacked tensor
    t_submit: float = 0.0       # admission timestamp (perf_counter)
    # set when bucketed pad-to-shape merged this request into a wider
    # bucket: the ORIGINAL middle-axis sizes (everything between axis 0
    # and the last axis) the collector trims results back to
    pad_trim: tuple | None = None
    # delivery attempt (0 = first admission).  The dispatcher's replay
    # path re-admits a request stranded by an infrastructure failure
    # under an incremented attempt so stale failure reports for an older
    # attempt can be told apart from the one currently in flight.
    attempt: int = 0
    # -- decode-session fields (wire v4) ------------------------------------
    # session id for autoregressive decode traffic (None for single-shot
    # requests).  A session-bearing envelope carries EXACTLY one extent:
    # stage routers pin the session to the replica holding its KV cache,
    # and a multi-session envelope could not route sticky.
    session: Any = None
    # sequence position of the token(s) this extent carries (the KV cache
    # slot a decode step writes); 0 for opens, which always prefill from
    # position 0
    pos: int = 0
    # 0 = plain single-shot row; 1 = session open (full-prompt prefill);
    # 2 = decode step (one new token); 3 = session close (evict KV)
    kind: int = 0


# RowExtent.kind values (module constants so call sites read as prose)
K_PLAIN = 0
K_OPEN = 1
K_STEP = 2
K_CLOSE = 3


@dataclasses.dataclass
class BatchEnvelope:
    """A whole continuous batch on the wire: ONE encoded stacked payload
    plus per-request row-extent framing.  ``error`` carries a formatted
    traceback instead of a payload when an upstream stage failed — the
    envelope still flows to the tail so the collector can fail exactly the
    affected futures while the chain keeps serving."""

    extents: list[RowExtent]
    blob: bytes
    error: str | None = None
    # failure classification for error envelopes: True means the failure
    # is an INFRASTRUCTURE one (severed link, killed replica, stranded
    # ledger) so the affected requests are safe to replay through the
    # healed chain; False (the default, and the only value application /
    # codec errors ever carry) means user code rejected the request and
    # retrying would just repeat the rejection.
    retryable: bool = False
    # partition epoch the producing stage was on when it encoded this
    # envelope.  With replicated stages the chain is no longer one global
    # FIFO: a fast replica can emit post-fence output while a slow sibling
    # still drains pre-fence work, so the next stage's router HOLDS any
    # envelope stamped ahead of its own epoch until the fence barrier
    # completes — no request ever sees a mixed-epoch chain.
    epoch: int = 0
    # perf_counter reading of its last put into an in-process queue, for
    # the queue waits (runtime/spans.py); never framed, so an envelope
    # that crossed a socket reads 0
    t_put: float = dataclasses.field(default=0.0, compare=False,
                                     repr=False)

    @property
    def n(self) -> int:
        return len(self.extents)

    @property
    def rows(self) -> int:
        return sum(e.rows for e in self.extents)


# one-shot flag for the pad_trim rank-mismatch warning below (tests reset)
_RANK_MISMATCH_WARNED = False


def slice_parts(flat: dict[str, np.ndarray],
                extents: list[RowExtent]) -> list[dict[str, np.ndarray]]:
    """Invert batch stacking: one {name: array} view per extent (no copy).

    An extent carrying ``pad_trim`` was zero-padded along its middle axes
    to merge into a wider shape bucket; its leaves are trimmed back to the
    original sizes here.  The trim only applies to rank-preserving layers:
    a leaf whose rank no longer matches the recorded trim (a rank-changing
    layer ran after the padded merge) is passed through untouched — and
    since its padded middle axes can no longer be located, the pass-through
    may contain padding.  That silent hazard is flagged with a ONE-SHOT
    ``RuntimeWarning`` (first occurrence per process) pointing at the fix:
    mark the rank-changing layer ``pad_safe=False`` so its segment falls
    back to exact bucketing."""
    global _RANK_MISMATCH_WARNED
    parts = []
    off = 0
    for e in extents:
        part = {k: v[off:off + e.rows] for k, v in flat.items()}
        if e.pad_trim is not None:
            trim = tuple(slice(0, s) for s in e.pad_trim)
            trimmed = {}
            for k, v in part.items():
                if v.ndim == len(e.pad_trim) + 2:
                    trimmed[k] = v[(slice(None),) + trim]
                else:
                    if not _RANK_MISMATCH_WARNED:
                        _RANK_MISMATCH_WARNED = True
                        warnings.warn(
                            f"slice_parts: leaf {k!r} has rank {v.ndim} but "
                            f"its pad_trim records {len(e.pad_trim)} middle "
                            f"axes (rank {len(e.pad_trim) + 2}); a "
                            "rank-changing layer ran after a padded shape-"
                            "bucket merge, so the trim cannot be applied "
                            "and the result may contain padding.  Mark the "
                            "rank-changing layer pad_safe=False (its "
                            "segment then uses exact bucketing).  Warning "
                            "only once per process.",
                            RuntimeWarning, stacklevel=2)
                    trimmed[k] = v
            part = trimmed
        parts.append(part)
        off += e.rows
    return parts


@dataclasses.dataclass
class NodePlan:
    """One node's share of a live repartition: its new layer range, the
    wire-encoded architecture spec, and the weights of only the layers it
    GAINS (weight-diff shipping — layers it keeps never travel again)."""

    lo: int
    hi: int
    arch_blob: bytes
    weights_blob: bytes                 # gained layers only; b"" if none
    weights_codec: "WireCodec"
    wire_bytes: int = 0                 # len(arch) + len(weights) on the wire


@dataclasses.dataclass
class ReconfigMarker:
    """The epoch fence for a live repartition.

    Injected at the head of the chain and relayed hop-by-hop IN ORDER with
    the data envelopes: every envelope ahead of the marker is processed by
    the old partition at every node, every envelope behind it by the new
    one — each node swaps exactly when the marker passes its compute
    stage, so no in-flight request ever sees a mixed chain and none is
    dropped or recomputed.  With replicated stages, each stage's router
    broadcasts the marker to every replica and the NEXT stage's router
    (or the tail collector) runs a counting barrier — the fence advances
    only once every replica has flushed it, and post-fence envelopes from
    fast replicas are held at the barrier (``BatchEnvelope.epoch``).
    Membership changes (spawn/drain of replicas) ride the same fence:
    the affected stage's router applies its pending membership exactly
    when the marker passes, so elasticity inherits the zero-loss
    guarantee.  The tail collector observes the completed barrier to
    acknowledge the epoch switch chain-wide."""

    epoch: int
    plans: dict[int, NodePlan]          # stage index -> its new assignment


@dataclasses.dataclass
class ControlFrame:
    """One supervisor <-> worker control-plane message (frame type
    ``_F_CONTROL``): heartbeats (``kind="hb"`` carrying a node snapshot),
    config/knob handoff, readiness acks, chaos injection, and the clean
    ``"bye"`` a worker sends before a deliberate exit (so the supervisor
    can tell a drained worker from a crashed one).  The payload is a
    JSON-able dict (tuple-tagged like client ids) — weights never ride a
    ControlFrame; they ship as the existing :class:`ReconfigMarker` /
    :class:`NodePlan` framing on the same byte stream."""

    kind: str
    payload: dict = dataclasses.field(default_factory=dict)


# small-payload bypass magic: a leaf at most `small_bypass` bytes is
# shipped as this prefix + raw .npy instead of going through the
# configured serializer/LZ4 (per-token decode frames are a few KB, where
# ZFP/LZ4 setup cost exceeds the transfer savings).  Checked on decode
# BEFORE LZ4, so the prefix must be distinguishable from every stream the
# codecs emit: ZFP starts b"ZFPR", Q8 b"Q8BQ", JSON b"{", .npy b"\\x93";
# an LZ4 block stream has no magic, so an 8-byte sentinel keeps the
# accidental-collision odds negligible.
_RAW_BYPASS_MAGIC = b"DWRAWNP1"


@dataclasses.dataclass(frozen=True)
class WireCodec:
    serializer: str = "zfp"     # "json" | "zfp" | "q8" | "raw"
    compression: str = "none"   # "lz4" | "none"
    zfp_rate: int = 24
    # vectorized=False selects the pure-Python/copying reference codec
    # implementations (the PR 1 hot path) — kept so serve_load can measure
    # the staged runtime against a faithful same-codec PR 1 baseline
    vectorized: bool = True
    # arrays at most this many bytes skip the serializer/LZ4 entirely and
    # ship as magic-prefixed raw .npy (lossless); 0 disables the bypass.
    # Decode auto-detects via the prefix, so mixed-size trees are fine.
    small_bypass: int = 0
    # where the q8 kernel runs (None = repro_torch.device.get_device());
    # a property of the process holding the codec, never framed
    device: Any = dataclasses.field(default=None, compare=False)

    @property
    def label(self) -> str:
        comp = "LZ4" if self.compression == "lz4" else "Uncompressed"
        return f"{self.serializer.upper()}/{comp}"

    def error_bound(self, absmax: float) -> float:
        """Worst-case absolute error for one encode/decode pass over values
        with |x| <= absmax (0.0 for the lossless serializers)."""
        if self.serializer == "q8":
            return codecs.Q8Codec().error_bound(absmax)
        if self.serializer == "zfp":
            return codecs.ZfpCodec(rate=self.zfp_rate).error_bound(absmax)
        return 0.0

    # -- arrays (weights / activations) ------------------------------------
    def encode_array(self, arr: np.ndarray) -> bytes:
        if (self.small_bypass and arr.nbytes <= self.small_bypass
                and (self.serializer != "raw" or self.compression != "none")):
            buf = io.BytesIO()
            np.save(buf, arr, allow_pickle=False)
            return _RAW_BYPASS_MAGIC + buf.getvalue()
        if self.serializer == "raw":
            buf = io.BytesIO()
            np.save(buf, arr, allow_pickle=False)
            blob = buf.getvalue()
        elif self.serializer == "json":
            blob = codecs.JsonCodec().encode(arr)
        elif self.serializer == "q8":
            blob = codecs.Q8Codec(device=self.device).encode(arr)
        else:
            blob = codecs.ZfpCodec(rate=self.zfp_rate,
                                   vectorized=self.vectorized).encode(arr)
        if self.compression == "lz4":
            blob = codecs.Lz4Codec(vectorized=self.vectorized).compress(blob)
        return blob

    def decode_array(self, blob: bytes) -> np.ndarray:
        """Decode one leaf.  The blob is NOT trusted: a truncated or
        corrupt payload (reachable via a dropped socket mid-frame) raises
        :class:`WireFormatError` instead of leaking ``struct.error`` /
        bare ``ValueError`` from the codec internals — the node stages
        turn that into a per-batch failure, not a dead stage thread."""
        try:
            if blob.startswith(_RAW_BYPASS_MAGIC):
                return np.load(io.BytesIO(blob[len(_RAW_BYPASS_MAGIC):]),
                               allow_pickle=False)
            if self.compression == "lz4":
                blob = codecs.Lz4Codec(
                    vectorized=self.vectorized).decompress(blob)
            if self.serializer == "raw":
                return np.load(io.BytesIO(blob), allow_pickle=False)
            if self.serializer == "json":
                return codecs.JsonCodec().decode(blob)
            if self.serializer == "q8":
                return codecs.Q8Codec(device=self.device).decode(blob)
            return codecs.ZfpCodec(rate=self.zfp_rate,
                                   vectorized=self.vectorized).decode(blob)
        except WireFormatError:
            raise
        except (struct.error, ValueError, EOFError, OSError, IndexError,
                KeyError, UnicodeDecodeError, AssertionError) as e:
            # AssertionError: the codecs assert their stream magic/shape
            # invariants — on an untrusted blob that is corruption too
            raise WireFormatError(
                f"corrupt {self.label} array payload "
                f"({len(blob)} bytes): {e}") from e

    # -- structured payloads (pytrees of arrays) -----------------------------
    def encode_tree(self, tree: Any, kind: str,
                    request_id: int | None = None,
                    client_id: int | None = None) -> tuple[bytes, WireRecord]:
        """Flatten a {name: array} tree into one framed stream.  Leaves are
        named ``a/b`` by their path (dict keys sorted, sequence items by
        index — the reference's ``tree_flatten_with_path`` order); a torch
        tensor, on the card or not, is copied to a host array first."""
        flat = list(tree_flatten_with_path(tree))
        t0 = time.perf_counter()
        parts: list[bytes] = []
        raw = 0
        for path, leaf in flat:
            name = "/".join(str(k) for k in path).encode()
            arr = (leaf.detach().cpu().numpy()
                   if isinstance(leaf, torch.Tensor) else np.asarray(leaf))
            raw += arr.nbytes
            body = self.encode_array(arr)
            parts.append(struct.pack("<I", len(name)) + name
                         + struct.pack("<Q", len(body)) + body)
        blob = struct.pack("<I", len(parts)) + b"".join(parts)
        t1 = time.perf_counter()
        return blob, WireRecord(kind, raw, len(blob), t1 - t0,
                                request_id=request_id, client_id=client_id)

    def decode_tree(self, blob: bytes) -> tuple[dict, float]:
        """Decode a framed pytree stream.  Framing bounds are validated at
        every read — leaf count vs buffer size, name/body lengths vs the
        remaining bytes, and exact consumption of the buffer — so a
        truncated or corrupt blob raises :class:`WireFormatError` rather
        than returning silently-short garbage or a bare ``struct.error``."""
        t0 = time.perf_counter()
        end = len(blob)
        off = _checked(blob, 0, 4, "tree leaf count")
        (n,) = struct.unpack_from("<I", blob, 0)
        # each leaf needs at least its 4+8 length headers: a corrupt count
        # is rejected up front instead of looping until a read trips
        if n > (end - off) // 12:
            raise WireFormatError(
                f"corrupt tree header: {n} leaves cannot fit in "
                f"{end - off} payload bytes")
        out: dict[str, np.ndarray] = {}
        for _ in range(n):
            off = _checked(blob, off, 4, "leaf name length")
            (ln,) = struct.unpack_from("<I", blob, off - 4)
            off = _checked(blob, off, ln, "leaf name")
            try:
                name = blob[off - ln:off].decode()
            except UnicodeDecodeError as e:
                raise WireFormatError(f"corrupt leaf name: {e}") from e
            off = _checked(blob, off, 8, "leaf body length")
            (lb,) = struct.unpack_from("<Q", blob, off - 8)
            off = _checked(blob, off, lb, f"leaf {name!r} body")
            out[name] = self.decode_array(blob[off - lb:off])
        if off != end:
            raise WireFormatError(
                f"corrupt tree: {end - off} trailing bytes after "
                f"{n} leaves")
        return out, time.perf_counter() - t0


def _checked(blob: bytes, off: int, n: int, what: str) -> int:
    """Validate that ``n`` bytes exist at ``off``; return the new offset.
    The single bounds gate every framing read goes through."""
    if n < 0 or off + n > len(blob):
        raise WireFormatError(
            f"truncated wire payload: need {n} bytes for {what} at offset "
            f"{off}, have {len(blob) - off}")
    return off + n


# -- channel-item framing (the byte wire under every transport) ---------------
#
#   [2B magic "DW"] [u8 version] [u8 type] [type-specific body]
#
# Types: envelope / marker / stop / retire — exactly the items the runtime
# puts on a Channel.  Every multi-byte integer is little-endian; variable
# fields are length-prefixed; client ids are JSON with tuples tagged (the
# runtime hashes client ids, so a tuple must come back a tuple).  No pickle
# anywhere: a malicious or corrupt peer can at worst raise WireFormatError.

FRAME_MAGIC = b"DW"
# v2 added the control-plane frame type (_F_CONTROL: heartbeats, worker
# config/knob/bye messages); v3 added the reliability fields (a u32
# `attempt` tag on every extent header and a `retryable` flags byte on
# envelopes) for the dispatcher's replay path; v4 added the decode-session
# fields (a `kind` byte + i64 `pos` on the extent header and a
# length-prefixed session id) for token-step frames.  Readers reject any
# other version outright, so an old peer meets a clean WireFormatError
# instead of a silent misparse; :func:`unframe_compat` keeps the v2/v3
# decode paths alive for mixed-version tests and tooling.
FRAME_VERSION = 4
_COMPAT_VERSIONS = (2, 3, FRAME_VERSION)

_F_ENVELOPE = 1
_F_MARKER = 2
_F_STOP = 3
_F_RETIRE = 4
_F_CONTROL = 5

_NONE_U32 = 0xFFFFFFFF


def _jsonable(v: Any) -> Any:
    """Tuple-tagging JSON transform for client ids and knob values."""
    if isinstance(v, tuple):
        return {"__tuple__": [_jsonable(x) for x in v]}
    if isinstance(v, list):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise WireFormatError(
        f"client_id of type {type(v).__name__} is not wire-encodable "
        "(use int / str / float / tuples thereof)")


def _unjsonable(v: Any) -> Any:
    if isinstance(v, dict):
        if set(v) == {"__tuple__"}:
            return tuple(_unjsonable(x) for x in v["__tuple__"])
        return {k: _unjsonable(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_unjsonable(x) for x in v]
    return v


def _pack_obj(v: Any) -> bytes:
    return json.dumps(_jsonable(v), separators=(",", ":")).encode()


def _unpack_obj(blob: bytes) -> Any:
    try:
        return _unjsonable(json.loads(blob.decode()))
    except (ValueError, UnicodeDecodeError) as e:
        raise WireFormatError(f"corrupt framed object: {e}") from e


def validate_client_id(client_id: Any) -> None:
    """Raise :class:`WireFormatError` if ``client_id`` cannot cross a
    byte-framed transport (int / str / float / bool / None / tuples and
    lists thereof).  The dispatcher calls this at admission so a bad id
    is a clear submit-time error on ANY topology, never a mid-chain relay
    failure on the one stage that happens to bind a socket transport."""
    _pack_obj(client_id)


def _pack_bytes(b: bytes) -> bytes:
    return struct.pack("<I", len(b)) + b


def _pack_extent(e: RowExtent, version: int = FRAME_VERSION) -> bytes:
    cid = _pack_obj(e.client_id)
    trim = (struct.pack("<i", -1) if e.pad_trim is None
            else struct.pack(f"<i{len(e.pad_trim)}q", len(e.pad_trim),
                             *e.pad_trim))
    if version >= 4:
        head = struct.pack("<qqqdIBq", e.request_id, e.seq, e.rows,
                           e.t_submit, e.attempt, e.kind, e.pos)
        sess = _pack_bytes(_pack_obj(e.session))
        return head + _pack_bytes(cid) + sess + trim
    if e.kind or e.pos or e.session is not None:
        raise WireFormatError(
            f"session extent (kind={e.kind}, pos={e.pos}, "
            f"session={e.session!r}) is not representable in wire "
            f"v{version} (decode sessions need v4)")
    if version >= 3:
        head = struct.pack("<qqqdI", e.request_id, e.seq, e.rows,
                           e.t_submit, e.attempt)
    else:
        if e.attempt:
            raise WireFormatError(
                f"attempt={e.attempt} is not representable in wire "
                f"v{version} (replay needs v3)")
        head = struct.pack("<qqqd", e.request_id, e.seq, e.rows, e.t_submit)
    return head + _pack_bytes(cid) + trim


def _unpack_extent(blob: bytes, off: int,
                   version: int = FRAME_VERSION) -> tuple[RowExtent, int]:
    attempt, kind, pos = 0, 0, 0
    if version >= 4:
        off = _checked(blob, off, 45, "extent header")
        rid, seq, rows, t_submit, attempt, kind, pos = struct.unpack_from(
            "<qqqdIBq", blob, off - 45)
        if kind > K_CLOSE:
            raise WireFormatError(f"unknown extent kind {kind}")
    elif version >= 3:
        off = _checked(blob, off, 36, "extent header")
        rid, seq, rows, t_submit, attempt = struct.unpack_from(
            "<qqqdI", blob, off - 36)
    else:
        off = _checked(blob, off, 32, "extent header")
        rid, seq, rows, t_submit = struct.unpack_from("<qqqd", blob, off - 32)
    off = _checked(blob, off, 4, "extent client id length")
    (ln,) = struct.unpack_from("<I", blob, off - 4)
    off = _checked(blob, off, ln, "extent client id")
    cid = _unpack_obj(blob[off - ln:off])
    try:
        hash(cid)
    except TypeError as e:
        raise WireFormatError(f"unhashable client id on the wire: {e}") from e
    session = None
    if version >= 4:
        off = _checked(blob, off, 4, "extent session id length")
        (ls,) = struct.unpack_from("<I", blob, off - 4)
        off = _checked(blob, off, ls, "extent session id")
        session = _unpack_obj(blob[off - ls:off])
        try:
            hash(session)
        except TypeError as e:
            raise WireFormatError(
                f"unhashable session id on the wire: {e}") from e
    off = _checked(blob, off, 4, "extent pad_trim count")
    (nt,) = struct.unpack_from("<i", blob, off - 4)
    trim = None
    if nt >= 0:
        off = _checked(blob, off, 8 * nt, "extent pad_trim values")
        trim = struct.unpack_from(f"<{nt}q", blob, off - 8 * nt)
    return RowExtent(rid, cid, seq, rows, t_submit=t_submit,
                     pad_trim=trim, attempt=attempt,
                     session=session, pos=pos, kind=kind), off


def _codec_fields(c: "WireCodec") -> bytes:
    return _pack_obj([c.serializer, c.compression, c.zfp_rate, c.vectorized])


def _codec_from_fields(blob: bytes) -> "WireCodec":
    f = _unpack_obj(blob)
    if (not isinstance(f, list) or len(f) != 4
            or not all(isinstance(x, t) for x, t in
                       zip(f, (str, str, int, bool)))):
        raise WireFormatError(f"corrupt wire codec descriptor: {f!r}")
    return WireCodec(serializer=f[0], compression=f[1], zfp_rate=f[2],
                     vectorized=f[3])


def frame(item: Any, version: int = FRAME_VERSION) -> bytes:
    """Serialize one channel item to the versioned byte wire (no pickle).
    Accepts exactly what the runtime puts on channels: a
    :class:`BatchEnvelope`, a :class:`ReconfigMarker` (with its
    :class:`NodePlan` payloads), or the ``_STOP``/``_RETIRE`` tokens.
    ``version`` selects the wire revision to speak (current by default;
    v2/v3 are kept for compat tests and refuse items that carry fields
    introduced after them — v3-only reliability fields, v4-only decode
    session fields)."""
    if version not in _COMPAT_VERSIONS:
        raise WireFormatError(
            f"cannot speak frame version {version} "
            f"(supported: {_COMPAT_VERSIONS})")

    def head(ftype: int) -> bytes:
        return FRAME_MAGIC + struct.pack("<BB", version, ftype)

    if item is _STOP:
        return head(_F_STOP)
    if item is _RETIRE:
        return head(_F_RETIRE)
    if isinstance(item, BatchEnvelope):
        err = (struct.pack("<I", _NONE_U32) if item.error is None
               else _pack_bytes(item.error.encode()))
        if version >= 3:
            flags = struct.pack("<B", 1 if item.retryable else 0)
        elif item.retryable:
            raise WireFormatError(
                "retryable envelopes are not representable in wire "
                f"v{version} (replay needs v3)")
        else:
            flags = b""
        return (head(_F_ENVELOPE) + struct.pack("<q", item.epoch) + flags
                + err + struct.pack("<I", len(item.extents))
                + b"".join(_pack_extent(e, version) for e in item.extents)
                + struct.pack("<Q", len(item.blob)) + item.blob)
    if isinstance(item, ReconfigMarker):
        parts = [head(_F_MARKER), struct.pack("<q", item.epoch),
                 struct.pack("<I", len(item.plans))]
        for stage, plan in sorted(item.plans.items()):
            parts.append(struct.pack("<iqqq", stage, plan.lo, plan.hi,
                                     plan.wire_bytes))
            parts.append(_pack_bytes(plan.arch_blob))
            parts.append(struct.pack("<Q", len(plan.weights_blob)))
            parts.append(plan.weights_blob)
            parts.append(_pack_bytes(_codec_fields(plan.weights_codec)))
        return b"".join(parts)
    if isinstance(item, ControlFrame):
        return (head(_F_CONTROL) + _pack_bytes(item.kind.encode())
                + _pack_bytes(_pack_obj(item.payload)))
    raise WireFormatError(
        f"{type(item).__name__} is not a channel item (expected "
        "BatchEnvelope, ReconfigMarker, or a control token)")


def _unframe_envelope(blob: bytes, off: int,
                      version: int = FRAME_VERSION) -> BatchEnvelope:
    off = _checked(blob, off, 8, "envelope epoch")
    (epoch,) = struct.unpack_from("<q", blob, off - 8)
    retryable = False
    if version >= 3:
        off = _checked(blob, off, 1, "envelope flags")
        flags = blob[off - 1]
        if flags > 1:
            raise WireFormatError(f"corrupt envelope flags {flags:#x}")
        retryable = bool(flags)
    off = _checked(blob, off, 4, "envelope error length")
    (el,) = struct.unpack_from("<I", blob, off - 4)
    error = None
    if el != _NONE_U32:
        off = _checked(blob, off, el, "envelope error")
        try:
            error = blob[off - el:off].decode()
        except UnicodeDecodeError as e:
            raise WireFormatError(f"corrupt envelope error text: {e}") from e
    off = _checked(blob, off, 4, "envelope extent count")
    # min extent: the fixed header (45B in v4, 36B in v3, 32B in v2) plus
    # the cid-length / pad_trim-count u32s (v4 adds a session-length u32)
    min_extent = (45 + 12 if version >= 4
                  else (36 if version >= 3 else 32) + 8)
    (n,) = struct.unpack_from("<I", blob, off - 4)
    if n > (len(blob) - off) // min_extent:
        raise WireFormatError(
            f"corrupt envelope: {n} extents cannot fit in "
            f"{len(blob) - off} bytes")
    extents = []
    for _ in range(n):
        e, off = _unpack_extent(blob, off, version)
        extents.append(e)
    off = _checked(blob, off, 8, "envelope blob length")
    (lb,) = struct.unpack_from("<Q", blob, off - 8)
    off = _checked(blob, off, lb, "envelope blob")
    if off != len(blob):
        raise WireFormatError(
            f"corrupt envelope: {len(blob) - off} trailing bytes")
    return BatchEnvelope(extents, blob[off - lb:off], error=error,
                         retryable=retryable, epoch=epoch)


def _unframe_marker(blob: bytes, off: int) -> ReconfigMarker:
    off = _checked(blob, off, 8, "marker epoch")
    (epoch,) = struct.unpack_from("<q", blob, off - 8)
    off = _checked(blob, off, 4, "marker plan count")
    (n,) = struct.unpack_from("<I", blob, off - 4)
    if n > (len(blob) - off) // 28:      # min plan: 28B fixed header
        raise WireFormatError(
            f"corrupt marker: {n} plans cannot fit in "
            f"{len(blob) - off} bytes")
    plans: dict[int, NodePlan] = {}
    for _ in range(n):
        off = _checked(blob, off, 28, "plan header")
        stage, lo, hi, wire_bytes = struct.unpack_from(
            "<iqqq", blob, off - 28)
        off = _checked(blob, off, 4, "plan arch length")
        (la,) = struct.unpack_from("<I", blob, off - 4)
        off = _checked(blob, off, la, "plan arch blob")
        arch = blob[off - la:off]
        off = _checked(blob, off, 8, "plan weights length")
        (lw,) = struct.unpack_from("<Q", blob, off - 8)
        off = _checked(blob, off, lw, "plan weights blob")
        weights = blob[off - lw:off]
        off = _checked(blob, off, 4, "plan codec length")
        (lc,) = struct.unpack_from("<I", blob, off - 4)
        off = _checked(blob, off, lc, "plan codec descriptor")
        codec = _codec_from_fields(blob[off - lc:off])
        plans[stage] = NodePlan(lo, hi, arch, weights, codec,
                                wire_bytes=wire_bytes)
    if off != len(blob):
        raise WireFormatError(
            f"corrupt marker: {len(blob) - off} trailing bytes")
    return ReconfigMarker(epoch, plans)


def _unframe_control(blob: bytes, off: int) -> ControlFrame:
    off = _checked(blob, off, 4, "control kind length")
    (lk,) = struct.unpack_from("<I", blob, off - 4)
    off = _checked(blob, off, lk, "control kind")
    try:
        kind = blob[off - lk:off].decode()
    except UnicodeDecodeError as e:
        raise WireFormatError(f"corrupt control kind: {e}") from e
    off = _checked(blob, off, 4, "control payload length")
    (lp,) = struct.unpack_from("<I", blob, off - 4)
    off = _checked(blob, off, lp, "control payload")
    payload = _unpack_obj(blob[off - lp:off])
    if off != len(blob):
        raise WireFormatError(
            f"corrupt control frame: {len(blob) - off} trailing bytes")
    if not isinstance(payload, dict):
        raise WireFormatError(
            f"control payload must be a dict, got {type(payload).__name__}")
    return ControlFrame(kind, payload)


def _unframe_versions(blob: bytes, versions: tuple[int, ...]) -> Any:
    try:
        _checked(blob, 0, 4, "frame header")
        if blob[:2] != FRAME_MAGIC:
            raise WireFormatError(f"bad frame magic {blob[:2]!r}")
        version, ftype = struct.unpack_from("<BB", blob, 2)
        if version not in versions:
            raise WireFormatError(
                f"unsupported frame version {version} "
                f"(speaking {FRAME_VERSION})")
        if ftype == _F_STOP:
            return _STOP
        if ftype == _F_RETIRE:
            return _RETIRE
        if ftype == _F_ENVELOPE:
            return _unframe_envelope(blob, 4, version)
        if ftype == _F_MARKER:
            return _unframe_marker(blob, 4)
        if ftype == _F_CONTROL:
            return _unframe_control(blob, 4)
        raise WireFormatError(f"unknown frame type {ftype}")
    except WireFormatError:
        raise
    except Exception as e:      # any residual parse error is a wire fault
        raise WireFormatError(f"corrupt frame: {e}") from e


def unframe(blob: bytes) -> Any:
    """Parse one framed channel item.  Every read is bounds-checked; any
    malformation — short buffer, bad magic, unknown version or type,
    lengths past the end, trailing bytes — raises
    :class:`WireFormatError`.  Control tokens come back as the SAME
    singletons the in-process runtime identity-compares against.  Only
    the CURRENT wire version is accepted (the runtime assumes every peer
    speaks it); :func:`unframe_compat` additionally accepts v2 frames."""
    return _unframe_versions(blob, (FRAME_VERSION,))


def unframe_compat(blob: bytes) -> Any:
    """Like :func:`unframe` but accepts every supported wire revision
    (currently v2, v3 and v4).  v2 extents come back with ``attempt=0``
    and v2 envelopes with ``retryable=False``; pre-v4 extents come back
    with ``session=None``/``kind=0`` — exactly the semantics an older
    speaker meant.  For tooling and rolling-upgrade tests; the serving
    hot path stays strict."""
    return _unframe_versions(blob, _COMPAT_VERSIONS)


def tree_unflatten_paths(flat: dict[str, np.ndarray]) -> dict:
    """'a/b/c' path keys -> nested dicts (inverse of encode_tree's framing)."""
    root: dict = {}
    for path, arr in flat.items():
        keys = path.split("/")
        cur = root
        for k in keys[:-1]:
            cur = cur.setdefault(k, {})
        cur[keys[-1]] = arr
    return root
