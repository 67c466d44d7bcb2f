"""Wire-format codecs for DEFER: JSON, ZFP-like fixed-rate, LZ4, and Q8
(twin of ``repro.core.codecs``; JSON/ZFP/LZ4 are the same numpy code, so
their blobs are byte-identical).

The paper serializes three payload types (architecture spec, weights,
inter-node activations) with {JSON, ZFP} x {LZ4, uncompressed} and measures
energy / overhead / payload for each combination (Table I) plus the resulting
inference throughput (Table II).  These are *real* codecs, not models:

* :class:`JsonCodec`   — JSON of nested lists (the paper's NumPy-JSON path).
* :class:`ZfpCodec`    — fixed-rate blockwise float compressor in the spirit
  of ZFP (Lindstrom 2014): 4x4 blocks, per-block common exponent
  (block-floating-point), orthogonal decorrelating lift, bitplane truncation
  to ``rate`` bits/value.  Lossy with a fixed-rate error bound; round-trip
  accuracy is asserted in tests.  The lift runs in place on int64 views
  (``vectorized=True``, the default); ``vectorized=False`` keeps the
  original copy-per-axis reference, byte-identical output.
* :class:`Lz4Codec`    — LZ4 *block format* compressor/decompressor.  The
  default path vectorizes the hot loops with NumPy (bulk-skip of positions
  whose 4-gram occurs only once, slice-compare match extension, slice/RLE
  match copy on decode) and is byte-exact with the pure-Python greedy
  reference (``vectorized=False``), which is kept as the baseline for the
  codec microbenchmark.
* :class:`Q8Codec`     — shared-scale int8 tile quantization, the
  fixed-rate ZFP analogue: backed by ``repro_torch.kernels.block_quant``
  (a CUDA kernel on the card, its plain PyTorch version on the CPU), with
  the same ``error_bound`` contract as :class:`ZfpCodec` so the serving
  runtime can ride int8 end-to-end.

``serialize``/``deserialize`` compose a serializer with an optional
compressor, returning (payload_bytes, timing) so the emulator can charge
overhead and energy exactly the way the paper does.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import time
from typing import Any, Literal

import numpy as np

# --------------------------------------------------------------------------
# JSON serializer (paper: "JSON serialization of NumPy arrays")
# --------------------------------------------------------------------------


class JsonCodec:
    name = "json"
    lossless = True

    def encode(self, arr: np.ndarray) -> bytes:
        payload = {
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "data": arr.ravel().tolist(),
        }
        return json.dumps(payload).encode("utf-8")

    def decode(self, blob: bytes) -> np.ndarray:
        payload = json.loads(blob.decode("utf-8"))
        return np.asarray(payload["data"], dtype=np.dtype(payload["dtype"])).reshape(
            payload["shape"]
        )


# --------------------------------------------------------------------------
# ZFP-like fixed-rate codec
# --------------------------------------------------------------------------

# shared binary framing for the array codecs' headers: ndim + shape + dtype
def _pack_shape_dtype(shape: tuple, dtype: np.dtype) -> bytes:
    return struct.pack("<B", len(shape)) + struct.pack(
        f"<{len(shape)}q", *shape) + dtype.str.encode().ljust(8, b" ")


def _unpack_shape_dtype(blob: bytes, off: int) -> tuple[tuple, np.dtype, int]:
    (ndim,) = struct.unpack_from("<B", blob, off); off += 1
    shape = struct.unpack_from(f"<{ndim}q", blob, off); off += 8 * ndim
    dtype = np.dtype(blob[off:off + 8].decode().strip()); off += 8
    return shape, dtype, off


# ZFP's 1D integer lift on a block of 4 (canonical forward/inverse pair from
# the zfp reference implementation).  Applied along both axes of each 4x4
# block; exactly invertible on int64.
def _fwd_lift(arr: np.ndarray, axis: int) -> np.ndarray:
    v = np.moveaxis(arr, axis, 0).astype(np.int64)
    x, y, z, w = v[0].copy(), v[1].copy(), v[2].copy(), v[3].copy()
    x += w; x >>= 1; w -= x
    z += y; z >>= 1; y -= z
    x += z; x >>= 1; z -= x
    w += y; w >>= 1; y -= w
    w += y >> 1; y -= w >> 1
    out = np.stack([x, y, z, w])
    return np.moveaxis(out, 0, axis)


def _inv_lift(arr: np.ndarray, axis: int) -> np.ndarray:
    v = np.moveaxis(arr, axis, 0).astype(np.int64)
    x, y, z, w = v[0].copy(), v[1].copy(), v[2].copy(), v[3].copy()
    y += w >> 1; w -= y >> 1
    y += w; w <<= 1; w -= y
    z += x; x <<= 1; x -= z
    y += z; z <<= 1; z -= y
    w += x; x <<= 1; x -= w
    out = np.stack([x, y, z, w])
    return np.moveaxis(out, 0, axis)


# Batched variants over the full (B, 4, 4) stacked block tensor: one
# transpose to (4, 4, B) makes every lift operand a large contiguous slice
# (the per-axis views above have inner stride 4, which defeats SIMD), both
# axes run in place in that layout, then one transpose back.  Identical
# arithmetic to the per-axis reference — byte-exact output, ~2-4x faster.
def _fwd_lift_blocks(q: np.ndarray) -> np.ndarray:
    """Forward lift along axes 1 then 2 of (B, 4, 4) int64 blocks."""
    t = np.ascontiguousarray(q.transpose(1, 2, 0))          # (4, 4, B)
    for ax in (0, 1):                                       # == axes 1, 2
        v = t if ax == 0 else t.transpose(1, 0, 2)
        x, y, z, w = v[0], v[1], v[2], v[3]
        x += w; x >>= 1; w -= x
        z += y; z >>= 1; y -= z
        x += z; x >>= 1; z -= x
        w += y; w >>= 1; y -= w
        w += y >> 1; y -= w >> 1
    return np.ascontiguousarray(t.transpose(2, 0, 1))


def _inv_lift_blocks(q: np.ndarray) -> np.ndarray:
    """Inverse lift along axes 2 then 1 of (B, 4, 4) int64 blocks."""
    t = np.ascontiguousarray(q.transpose(1, 2, 0))
    for ax in (1, 0):                                       # == axes 2, 1
        v = t if ax == 0 else t.transpose(1, 0, 2)
        x, y, z, w = v[0], v[1], v[2], v[3]
        y += w >> 1; w -= y >> 1
        y += w; w <<= 1; w -= y
        z += x; x <<= 1; x -= z
        y += z; z <<= 1; z -= y
        w += x; x <<= 1; x -= w
    return np.ascontiguousarray(t.transpose(2, 0, 1))


@dataclasses.dataclass
class ZfpCodec:
    """Fixed-rate blockwise transform coder (ZFP-style), 4x4 blocks.

    rate = stored bits per value (total payload ~= rate/32 of float32).
    """

    rate: int = 16
    transform: bool = True
    name: str = "zfp"
    lossless: bool = False
    vectorized: bool = True        # in-place lift over the stacked tensor

    _MAGIC = b"ZFPR"

    def encode(self, arr: np.ndarray) -> bytes:
        orig_dtype = arr.dtype
        a = np.asarray(arr, dtype=np.float32)
        flat = a.ravel()
        n = flat.size
        pad = (-n) % 16
        if pad:
            flat = np.concatenate([flat, np.zeros(pad, np.float32)])
        blocks = flat.reshape(-1, 4, 4)                       # (B,4,4)

        # per-block common exponent (block floating point)
        absmax = np.abs(blocks).reshape(len(blocks), -1).max(axis=1)
        exp = np.zeros(len(blocks), np.int16)
        nz = absmax > 0
        exp[nz] = np.frexp(absmax[nz])[1].astype(np.int16)   # absmax < 2**exp

        # to fixed point: i = round(x * 2^(30-exp)) fits in int32 with headroom
        scale = np.ldexp(1.0, (30 - exp.astype(np.int64)))[:, None, None]
        if self.vectorized:
            # one f64 temp (fused upcast-multiply), rounded in place
            t = np.multiply(blocks, scale, dtype=np.float64)
            q = np.rint(t, out=t).astype(np.int64)
        else:
            q = np.rint(blocks.astype(np.float64) * scale).astype(np.int64)

        if self.transform:
            if self.vectorized:
                q = _fwd_lift_blocks(q)
            else:
                q = _fwd_lift(q, 1)
                q = _fwd_lift(q, 2)

        # bitplane truncation: keep top `rate` bits -> shift right by 32-rate+2
        # (transform grows magnitude by <=2 bits)
        shift = max(0, 32 - self.rate + 2)
        q >>= shift

        qmax = np.abs(q).max() if q.size else 0
        width = max(8, int(qmax).bit_length() + 1)
        width = 8 * ((width + 7) // 8)                       # byte-aligned width
        store_dtype = {8: np.int8, 16: np.int16, 24: np.int32, 32: np.int32,
                       40: np.int64, 48: np.int64, 56: np.int64, 64: np.int64}[
                           min(width, 64)]
        body = q.astype(store_dtype).tobytes()

        header = self._MAGIC + struct.pack(
            "<qqBBB", n, len(blocks), self.rate, int(self.transform),
            np.dtype(store_dtype).itemsize,
        ) + _pack_shape_dtype(arr.shape, orig_dtype)
        return header + exp.tobytes() + body

    def decode(self, blob: bytes) -> np.ndarray:
        assert blob[:4] == self._MAGIC, "not a ZFPR stream"
        off = 4
        n, nblocks, rate, transform, itemsize = struct.unpack_from("<qqBBB", blob, off)
        off += struct.calcsize("<qqBBB")
        shape, orig_dtype, off = _unpack_shape_dtype(blob, off)
        exp = np.frombuffer(blob, np.int16, nblocks, off).astype(np.int64)
        off += 2 * nblocks
        store_dtype = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[itemsize]
        q = np.frombuffer(blob, store_dtype, nblocks * 16, off).astype(np.int64)
        q = q.reshape(nblocks, 4, 4)

        shift = max(0, 32 - rate + 2)
        if self.vectorized:
            q <<= shift                  # astype above made q owned
            if transform:
                q = _inv_lift_blocks(q)
        else:
            q = q << shift
            if transform:
                q = _inv_lift(q, 2)
                q = _inv_lift(q, 1)
        scale = np.ldexp(1.0, -(30 - exp))[:, None, None]
        out = (q.astype(np.float64) * scale).astype(np.float32).ravel()[:n]
        return out.reshape(shape).astype(orig_dtype)

    def error_bound(self, absmax: float) -> float:
        """Worst-case absolute error for values with |x| <= absmax."""
        # one ulp at the truncated bitplane, inflated by the (non-orthogonal)
        # inverse lift's max row sum and the low bits the forward lift drops
        exp = np.frexp(absmax)[1] if absmax > 0 else 0
        shift = max(0, 32 - self.rate + 2)
        return float(np.ldexp(16.0 * (2 ** shift), int(exp) - 30))


# --------------------------------------------------------------------------
# LZ4 block format
# --------------------------------------------------------------------------


class Lz4Codec:
    """LZ4 *block* format (https://lz4.org), byte-exact round trip.

    Greedy match finder with a 4-byte hash table; emits
    [token][literal-len*][literals][offset(2B LE)][matchlen*] sequences.

    The default (``vectorized=True``) path produces byte-identical streams
    to the pure-Python reference but vectorizes the three hot loops with
    NumPy:

    * the per-byte table scan bulk-skips every position whose 4-gram occurs
      only once in the input (its table entry could never serve a lookup),
      jumping between candidate positions with a precomputed sorted index;
    * match extension compares slices in growing chunks instead of one byte
      per Python iteration;
    * decompression copies literal runs and non-overlapping matches as
      slices and expands overlapping (RLE-style) matches by tiling.
    """

    name = "lz4"
    MIN_MATCH = 4

    def __init__(self, vectorized: bool = True):
        self.vectorized = vectorized

    def compress(self, data: bytes) -> bytes:
        if self.vectorized:
            return self._compress_vec(data)
        return self._compress_ref(data)

    def _compress_ref(self, data: bytes) -> bytes:
        """Reference greedy compressor (one Python iteration per byte)."""
        n = len(data)
        out = bytearray()
        table: dict[bytes, int] = {}
        i = 0
        anchor = 0
        # last 5 bytes must be literals (spec: last match can't start there +
        # last 5 bytes always literal)
        limit = n - 5
        while i < limit:
            key = data[i:i + 4]
            cand = table.get(key, -1)
            table[key] = i
            if cand >= 0 and i - cand <= 0xFFFF and data[cand:cand + 4] == key:
                # extend match
                mlen = 4
                while i + mlen < n - 5 and data[cand + mlen] == data[i + mlen]:
                    mlen += 1
                lit = data[anchor:i]
                self._emit(out, lit, i - cand, mlen)
                i += mlen
                anchor = i
            else:
                i += 1
        # trailing literals
        lit = data[anchor:]
        token = min(len(lit), 15) << 4
        out.append(token)
        self._emit_len(out, len(lit) - 15)
        out += lit
        return bytes(out)

    def _compress_vec(self, data: bytes) -> bytes:
        """Vectorized greedy compressor, byte-exact with :meth:`_compress_ref`.

        Exactness argument: the reference table entry at position ``p`` is
        only ever *read* by a later position with the same 4-gram, so
        skipping writes for 4-grams that occur once in ``[0, limit)`` cannot
        change any lookup.  Positions inside emitted matches are never
        visited by the reference either, so the jump-to-next-duplicate scan
        visits a superset of the positions whose table writes matter and
        exactly the positions whose lookups matter.
        """
        from bisect import bisect_left
        n = len(data)
        out = bytearray()
        anchor = 0
        limit = n - 5
        if limit > 0:
            u8 = np.frombuffer(data, dtype=np.uint8)
            v = (u8[:n - 3].astype(np.uint32)
                 | (u8[1:n - 2].astype(np.uint32) << 8)
                 | (u8[2:n - 1].astype(np.uint32) << 16)
                 | (u8[3:n].astype(np.uint32) << 24))[:limit]
            _, inverse, counts = np.unique(v, return_inverse=True,
                                           return_counts=True)
            dup_pos = np.nonzero(counts[inverse] > 1)[0]
            # python lists: per-candidate dict/index ops are ~5x cheaper
            # than numpy scalar extraction in this loop
            dups = dup_pos.tolist()
            keys = v[dup_pos].tolist()
            nd = len(dups)
            table: dict[int, int] = {}
            table_get = table.get
            out_append = out.append
            k = 0
            while k < nd:
                i = dups[k]
                key = keys[k]
                k += 1
                cand = table_get(key, -1)
                table[key] = i
                if cand >= 0 and i - cand <= 0xFFFF:
                    # chunked memcmp match extension: short mismatches stay
                    # in one tiny bytes compare, long matches grow the chunk
                    L = limit - (i + 4)
                    a0, b0 = cand + 4, i + 4
                    ext, chunk = 0, 16
                    while ext < L:
                        m = chunk if L - ext >= chunk else L - ext
                        a = data[a0 + ext:a0 + ext + m]
                        b = data[b0 + ext:b0 + ext + m]
                        if a == b:
                            ext += m
                            if chunk < (1 << 20):
                                chunk *= 4
                            continue
                        for j in range(m):          # mismatch inside chunk
                            if a[j] != b[j]:
                                break
                        ext += j
                        break
                    mlen = 4 + ext
                    llen = i - anchor
                    if llen < 15 and ext < 15:      # inlined common emit
                        out_append((llen << 4) | ext)
                        out += data[anchor:i]
                        off = i - cand
                        out_append(off & 0xFF)
                        out_append(off >> 8)
                    else:
                        self._emit(out, data[anchor:i], i - cand, mlen)
                    i += mlen
                    anchor = i
                    if i >= limit:
                        break
                    # skip candidate positions the match consumed: linear
                    # scan for short matches, bisect for long ones
                    stop = k + 8
                    while k < nd and dups[k] < i:
                        k += 1
                        if k >= stop:
                            k = bisect_left(dups, i, k)
                            break
        lit = data[anchor:]
        token = min(len(lit), 15) << 4
        out.append(token)
        self._emit_len(out, len(lit) - 15)
        out += lit
        return bytes(out)

    @staticmethod
    def _emit_len(out: bytearray, rem: int) -> None:
        if rem < 0:
            return
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)

    def _emit(self, out: bytearray, lit: bytes, offset: int, mlen: int) -> None:
        lit_code = min(len(lit), 15)
        m_code = min(mlen - self.MIN_MATCH, 15)
        out.append((lit_code << 4) | m_code)
        if lit_code == 15:
            self._emit_len(out, len(lit) - 15)
        out += lit
        out += struct.pack("<H", offset)
        if m_code == 15:
            self._emit_len(out, mlen - self.MIN_MATCH - 15)

    def decompress(self, blob: bytes) -> bytes:
        out = bytearray()
        i, n = 0, len(blob)
        vec = self.vectorized
        while i < n:
            token = blob[i]; i += 1
            lit_len = token >> 4
            if lit_len == 15:
                while True:
                    b = blob[i]; i += 1
                    lit_len += b
                    if b != 255:
                        break
            out += blob[i:i + lit_len]
            i += lit_len
            if i >= n:
                break  # final literal-only sequence
            (offset,) = struct.unpack_from("<H", blob, i); i += 2
            mlen = (token & 0xF)
            if mlen == 15:
                while True:
                    b = blob[i]; i += 1
                    mlen += b
                    if b != 255:
                        break
            mlen += self.MIN_MATCH
            pos = len(out) - offset
            if vec and offset >= mlen:
                out += out[pos:pos + mlen]         # disjoint: one slice copy
            elif vec:
                # overlapping match == periodic extension of the last
                # `offset` bytes; tile instead of copying byte-wise
                window = bytes(out[pos:])
                reps = -(-mlen // offset)
                out += (window * reps)[:mlen]
            else:
                for _ in range(mlen):              # reference byte-wise copy
                    out.append(out[pos])
                    pos += 1
        return bytes(out)


# --------------------------------------------------------------------------
# Q8: shared-scale int8 tile quantization (the fixed-rate ZFP analogue)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Q8Codec:
    """Fixed-rate int8 wire serializer backed by ``kernels/block_quant``.

    Per-(8, 128)-tile shared-scale int8 quantization: the CUDA kernel on a
    CUDA ``device``, its plain PyTorch version on the CPU, so the
    inter-node activation stream rides the int8 format end-to-end through
    the serving runtime.  Payload = int8 body + a 1/1024 float32 scale
    sidecar (~8.03 bits/value), with the same ``error_bound`` contract as
    :class:`ZfpCodec`.  ``device`` (None = :func:`repro_torch.device.get_device`)
    is where the kernel runs; it is not part of the blob.
    """

    name: str = "q8"
    lossless: bool = False
    device: Any = None

    _MAGIC = b"Q8BQ"

    def encode(self, arr: np.ndarray) -> bytes:
        from repro_torch.kernels import block_quant as bq
        a = np.asarray(arr)
        q, scales = bq.quantize_wire(a, device=self.device)
        header = self._MAGIC + struct.pack("<q", a.size) \
            + _pack_shape_dtype(a.shape, a.dtype) \
            + struct.pack("<q", scales.size)
        # trim the int8 body to the true element count: the pow2 tile
        # padding quantizes zeros, which decode re-synthesizes for free
        return header + scales.tobytes() + q[:a.size].tobytes()

    def decode(self, blob: bytes) -> np.ndarray:
        from repro_torch.kernels import block_quant as bq
        assert blob[:4] == self._MAGIC, "not a Q8BQ stream"
        off = 4
        (n,) = struct.unpack_from("<q", blob, off); off += 8
        shape, dtype, off = _unpack_shape_dtype(blob, off)
        (ns,) = struct.unpack_from("<q", blob, off); off += 8
        scales = np.frombuffer(blob, np.float32, ns, off); off += 4 * ns
        q = np.frombuffer(blob, np.int8, -1, off)
        return bq.dequantize_wire(q, scales, n, shape, dtype,
                                  device=self.device)

    def error_bound(self, absmax: float) -> float:
        """Worst-case absolute error for values with |x| <= absmax.

        The true bound is half a quantization step, scale/2 <= absmax/254;
        we claim absmax/127 to cover float32 scale rounding with 2x margin.
        """
        return float(absmax) / 127.0 if absmax > 0 else 0.0


# --------------------------------------------------------------------------
# Composition + timing (what the emulator charges as "overhead")
# --------------------------------------------------------------------------

SerName = Literal["json", "zfp", "q8"]
CompName = Literal["lz4", "none"]


@dataclasses.dataclass
class WireStats:
    raw_bytes: int
    wire_bytes: int
    encode_s: float
    decode_s: float

    @property
    def ratio(self) -> float:
        return self.wire_bytes / max(1, self.raw_bytes)


def make_serializer(name: SerName, zfp_rate: int = 16):
    if name == "json":
        return JsonCodec()
    if name == "q8":
        return Q8Codec()
    return ZfpCodec(rate=zfp_rate)


def roundtrip(arr: np.ndarray, serializer: SerName = "zfp",
              compression: CompName = "none", zfp_rate: int = 16
              ) -> tuple[np.ndarray, WireStats]:
    """Serialize(+compress) then invert, with wall-clock timing."""
    ser = make_serializer(serializer, zfp_rate)
    lz4 = Lz4Codec()
    t0 = time.perf_counter()
    blob = ser.encode(arr)
    if compression == "lz4":
        blob = lz4.compress(blob)
    t1 = time.perf_counter()
    rt = lz4.decompress(blob) if compression == "lz4" else blob
    back = ser.decode(rt)
    t2 = time.perf_counter()
    stats = WireStats(arr.nbytes, len(blob), t1 - t0, t2 - t1)
    return back, stats
