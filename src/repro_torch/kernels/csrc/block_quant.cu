// Shared-scale int8 block quantization per (8, 128) tile, for sm_90a.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/block_quant.py:
// quantize_blocks (_quant_kernel) and dequantize_blocks (_dequant_kernel).
// The port's q8 wire serializer runs them on every hop's activations.
//
//   quantize:   scale = absmax * f32(1/127) (1.0 for an all-zero tile)
//               q = clip(round_half_even(x / scale), -127, 127)
//   dequantize: x = float(q) * scale
//
// Both see a grid [R, C] (C a multiple of 128) in row-major order of which
// only the first n values are real; the rest is zero padding that is never
// read or written.  The q8 wire hands over a leaf of any size n, and its
// blob carries a scale for every tile of a power-of-two count of tiles:
// quantize reads the n values, writes their n int8 and a scale for every
// tile of the grid (1.0, without a load, for a tile of padding only), so
// the blob is byte-identical to one made from the zero-padded grid;
// dequantize reads n int8 and writes n floats.  quantize_blocks and
// dequantize_blocks pass n = R * C.
//
// Bound: bytes.  Quantize reads 4 B and writes 1 B per value (plus one
// f32 scale per 1024 values) and does a handful of operations on each, so
// it sits far below the card's operations-per-byte line.  At the q8 path's
// leaves (150,528 to 401,408 values at batch 1) that is 0.75-2 MB, a few
// microseconds, so a launch's fixed cost and the length of each thread's
// dependent chain weigh as much as the bytes.  The design spreads each
// tile over many threads and keeps every thread's chain short:
//
//   - quantize: one CTA of 8 warps per tile, warp r on the tile's row r.
//     Each lane does one 16-byte load (4 values; a warp reads its 512-byte
//     row, coalesced), the absmax is reduced with warp shuffles and then
//     across the 8 warps through shared memory, and each lane divides its
//     4 values (4 divisions, independent) and writes its 4 int8 as one
//     4-byte store: a warp writes the row's 128 bytes in one coalesced
//     transaction, as 8 lanes' 16-byte stores would after shuffles that
//     gather them.  At the wire's 512 tiles that is 512 CTAs of 256
//     threads, about 31 warps an SM, resident in one wave.  On the wire's
//     layout (C = 128) a tile is 4 KB of contiguous f32 and 256 threads
//     cover it with one 16-byte load each, in flight together, straight
//     into the registers that use them: a TMA bulk copy would add a
//     barrier and a trip through shared memory and bring nothing.
//   - dequantize: each thread takes 16 consecutive values: one 16-byte
//     load of q, the warp's 512 bytes transposed through 512 bytes of
//     shared memory (16-byte writes, 4-byte reads, no bank conflicts), so
//     each of the thread's 4 float4 stores lands beside its neighbours'
//     (512 consecutive bytes a warp and store).  Every 128 values of a
//     warp's 512 lie in one tile, so each store takes one scale; the 4
//     scales are loaded beside q, not after it.
//   - a ragged tail: the one vector that straddles n is read and written
//     value by value; lanes wholly past n load nothing (their values are
//     0) and store nothing, so a warp that ends at n on a vector boundary
//     does not diverge into the value-by-value path.
//
// The results must equal the reference byte for byte, so the arithmetic is
// IEEE and explicit.  The scale is absmax * f32(1/127) (__fmul_rn): the
// reference writes absmax/127.0, but XLA compiles a division by a constant
// into a multiply by its float32 reciprocal, and that is what its q8 wire
// blobs carry.  x/scale is a true division (__fdiv_rn, never a reciprocal
// multiply; built without --use_fast_math), and rintf rounds half to even.
// Subnormals: XLA treats a subnormal input as zero and flushes a subnormal
// result to zero, and a TPU has none, so every loaded value, the scale and
// the dequantized product go through flush() (|v| < FLT_MIN -> a zero of
// v's sign), explicitly rather than by -ftz, which would not say where.  A
// NaN quotient (0/0: a flushed element over a flushed scale) becomes 0, as
// XLA's cast gives.  A NaN input makes the tile's absmax NaN and its scale
// 1.0, as in the plain version.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kTileR = 8;
constexpr int kTileC = 128;
constexpr int kQuantThreads = kTileR * 32;   // a warp per tile row
constexpr int kDequantThreads = 256;
constexpr int kDequantPerThread = 16;        // one 16-byte load of q
constexpr int kDequantPerWarp = 32 * kDequantPerThread;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInv127 = 1.0f / 127.0f;   // correctly rounded at compile time

__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.0f, v) : v;
}

__device__ __forceinline__ signed char quant1(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  if (r != r) return 0;
  return static_cast<signed char>(fminf(fmaxf(r, -127.0f), 127.0f));
}

__global__ void __launch_bounds__(kQuantThreads)
quant_kernel(const float* __restrict__ x, signed char* __restrict__ q,
             float* __restrict__ scales, long long C, long long n) {
  // 32-bit tile arithmetic (a 64-bit division is a long software
  // routine on the card, on every thread's path to its load)
  const unsigned tile = blockIdx.x, tiles_c = (unsigned)(C / kTileC);
  const unsigned tr = tile / tiles_c, tc = tile - tr * tiles_c;
  const long long first = (long long)tr * kTileR * C + (long long)tc * kTileC;
  if (first >= n) {                    // padding only: scale 1.0, no load
    if (threadIdx.x == 0) scales[tile] = 1.0f;
    return;
  }
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  const long long e = first + row * C + lane * 4;
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (e + 4 <= n) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(x + e));
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else if (e < n) {                  // the one lane that straddles n
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (e + i < n) v[i] = x[e + i];
  }
  float m = 0.0f;
  bool nan = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = flush(v[i]);
    m = fmaxf(m, fabsf(v[i]));
    nan |= isnan(v[i]);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, s));
  // fmaxf drops NaN; the plain version's amax propagates it (-> scale 1.0)
  __shared__ float row_max[kTileR];
  if (__any_sync(kFull, nan)) m = __int_as_float(0x7fc00000);
  if (lane == 0) row_max[row] = m;
  __syncthreads();
  m = row_max[0];
  nan = isnan(m);
#pragma unroll
  for (int r = 1; r < kTileR; ++r) {
    m = fmaxf(m, row_max[r]);
    nan |= isnan(row_max[r]);
  }
  const float scale = !nan && m > 0.0f ? flush(__fmul_rn(m, kInv127)) : 1.0f;

  char4 o;
  o.x = quant1(v[0], scale);
  o.y = quant1(v[1], scale);
  o.z = quant1(v[2], scale);
  o.w = quant1(v[3], scale);
  if (e + 4 <= n) {
    *reinterpret_cast<char4*>(q + e) = o;
  } else if (e < n) {
    const signed char b[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (e + i < n) q[e + i] = b[i];
  }
  if (threadIdx.x == 0) scales[tile] = scale;
}

__global__ void __launch_bounds__(kDequantThreads)
dequant_kernel(const signed char* __restrict__ q,
               const float* __restrict__ scales, float* __restrict__ out,
               long long C, long long n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long w0 =
      ((long long)blockIdx.x * (kDequantThreads / 32) + warp) *
      kDequantPerWarp;
  if (w0 >= n) return;                 // the whole warp
  __shared__ __align__(16) signed char
      qs[kDequantThreads / 32][kDequantPerWarp];
  constexpr int kSegs = kDequantPerWarp / kTileC;

  // the scales of the warp's 4 tile rows of 128 values, loaded beside q,
  // their indices in 32 bits (g < 2^32 segments of 128: the wrapper
  // checks n)
  const unsigned tiles_c = (unsigned)(C / kTileC);
  float s[kSegs];
#pragma unroll
  for (int j = 0; j < kSegs; ++j) {
    const long long seg = w0 + j * kTileC;
    const unsigned g = (unsigned)(seg / kTileC);
    const unsigned row = g / tiles_c, col = g - row * tiles_c;
    s[j] = seg < n ? flush(__ldg(scales + (row / kTileR) * tiles_c + col))
                   : 0.0f;
  }
  const long long e = w0 + lane * kDequantPerThread;
  union {
    uint4 v;
    signed char b[kDequantPerThread];
  } raw;
  raw.v = make_uint4(0, 0, 0, 0);
  if (e + kDequantPerThread <= n) {
    raw.v = __ldg(reinterpret_cast<const uint4*>(q + e));
  } else if (e < n) {                  // the one lane that straddles n
#pragma unroll
    for (int i = 0; i < kDequantPerThread; ++i)
      if (e + i < n) raw.b[i] = q[e + i];
  }
  *reinterpret_cast<uint4*>(qs[warp] + lane * kDequantPerThread) = raw.v;
  __syncwarp();

#pragma unroll
  for (int j = 0; j < kSegs; ++j) {
    const long long seg = w0 + j * kTileC;   // 128 values of one tile row
    if (seg >= n) break;
    const char4 c =
        *reinterpret_cast<const char4*>(qs[warp] + j * kTileC + lane * 4);
    float4 o;
    o.x = flush(__fmul_rn(static_cast<float>(c.x), s[j]));
    o.y = flush(__fmul_rn(static_cast<float>(c.y), s[j]));
    o.z = flush(__fmul_rn(static_cast<float>(c.z), s[j]));
    o.w = flush(__fmul_rn(static_cast<float>(c.w), s[j]));
    const long long d = seg + lane * 4;
    if (d + 4 <= n) {
      *reinterpret_cast<float4*>(out + d) = o;
    } else if (d < n) {
      const float f[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (d + i < n) out[d + i] = f[i];
    }
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  x/q/scales/out are device
// pointers of contiguous, 16-byte aligned buffers holding the first n
// values (row-major) of an [R, C] grid with C % 128 == 0 (the wrapper
// checks).  Quantize writes q[0, n) and the scales of all ntiles tiles of
// the grid (ntiles a whole number of tile rows: R = 8 * ntiles / (C / 128),
// n <= R * C); dequantize reads q[0, n) and the scales of the tiles that
// hold them, and writes out[0, n).  Each launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a grid
// it does not take; neither synchronises.
extern "C" int bq_quantize_f32(const float* x, signed char* q, float* scales,
                               long long C, long long n, long long ntiles,
                               void* stream) {
  if (C <= 0 || C % kTileC || n < 0 || ntiles < 0 ||
      ntiles % (C / kTileC) || n > ntiles * kTileR * kTileC ||
      ntiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ntiles == 0) return 0;
  quant_kernel<<<(unsigned)ntiles, kQuantThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(x, q, scales, C, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bq_dequantize_f32(const signed char* q, const float* scales,
                                 float* out, long long C, long long n,
                                 void* stream) {
  constexpr long long kPerBlock = (long long)kDequantThreads *
                                  kDequantPerThread;
  const long long blocks = (n + kPerBlock - 1) / kPerBlock;
  if (C <= 0 || C % kTileC || C / kTileC > 0xffffffffLL || n < 0 ||
      n / kTileC > 0xffffffffLL || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  dequant_kernel<<<(unsigned)blocks, kDequantThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(q, scales, out, C, n);
  return static_cast<int>(cudaGetLastError());
}
