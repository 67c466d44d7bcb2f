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
// Bound: bytes.  Quantize reads 4 B and writes 1 B per value (plus one
// f32 scale per 1024 values) and does a handful of operations on each, so
// it sits far below the card's operations-per-byte line.  The design moves
// each byte once: one warp owns one tile, each lane loads one 16-byte
// float4 from each of the tile's 8 rows (32 lanes x 16 B = one 512-byte
// row, fully coalesced), keeps the 32 values in registers, reduces the
// absmax with warp shuffles, and writes its 4 int8 of each row as one
// 4-byte store.  No shared memory, no second pass over the input.
//
// The results must equal the reference byte for byte, so the arithmetic is
// IEEE and explicit.  The scale is absmax * f32(1/127) (__fmul_rn): the
// reference writes absmax/127.0, but XLA compiles a division by a constant
// into a multiply by its float32 reciprocal, and that is what its q8 wire
// blobs carry.  x/scale is a true division (__fdiv_rn, never a reciprocal
// multiply; built without --use_fast_math, so subnormals are kept), and
// rintf rounds half to even.  A NaN quotient (0/0 when absmax is subnormal
// and its scale underflows to 0) becomes 0, which is what PyTorch's CUDA
// cast of NaN to int8 gives for the plain version.  A NaN input makes the tile's
// absmax NaN and its scale 1.0, as in the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileR = 8;
constexpr int kTileC = 128;
constexpr int kWarps = 4;              // tiles (warps) per block
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInv127 = 1.0f / 127.0f;   // correctly rounded at compile time

__device__ __forceinline__ signed char quant1(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  if (r != r) return 0;
  return static_cast<signed char>(fminf(fmaxf(r, -127.0f), 127.0f));
}

__device__ __forceinline__ float absmax4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ bool isnan4(float4 v) {
  return isnan(v.x) || isnan(v.y) || isnan(v.z) || isnan(v.w);
}

__global__ void __launch_bounds__(kWarps * 32)
quant_kernel(const float* __restrict__ x, signed char* __restrict__ q,
             float* __restrict__ scales, long long C, long long ntiles) {
  const long long tile = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= ntiles) return;
  const int lane = threadIdx.x & 31;
  const long long tiles_c = C / kTileC;
  const long long tr = tile / tiles_c, tc = tile - tr * tiles_c;
  const long long off = tr * kTileR * C + tc * kTileC + lane * 4;

  float4 v[kTileR];
  float m = 0.0f;
  bool nan = false;
#pragma unroll
  for (int r = 0; r < kTileR; ++r) {
    v[r] = __ldg(reinterpret_cast<const float4*>(x + off + r * C));
    m = fmaxf(m, absmax4(v[r]));
    nan |= isnan4(v[r]);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, s));
  // fmaxf drops NaN; the plain version's amax propagates it (-> scale 1.0)
  if (__any_sync(kFull, nan)) m = __int_as_float(0x7fc00000);
  const float scale = m > 0.0f ? __fmul_rn(m, kInv127) : 1.0f;

#pragma unroll
  for (int r = 0; r < kTileR; ++r) {
    char4 o;
    o.x = quant1(v[r].x, scale);
    o.y = quant1(v[r].y, scale);
    o.z = quant1(v[r].z, scale);
    o.w = quant1(v[r].w, scale);
    *reinterpret_cast<char4*>(q + off + r * C) = o;
  }
  if (lane == 0) scales[tile] = scale;
}

__global__ void __launch_bounds__(kWarps * 32)
dequant_kernel(const signed char* __restrict__ q,
               const float* __restrict__ scales, float* __restrict__ out,
               long long C, long long ntiles) {
  const long long tile = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= ntiles) return;
  const int lane = threadIdx.x & 31;
  const long long tiles_c = C / kTileC;
  const long long tr = tile / tiles_c, tc = tile - tr * tiles_c;
  const long long off = tr * kTileR * C + tc * kTileC + lane * 4;
  const float s = __ldg(scales + tile);
#pragma unroll
  for (int r = 0; r < kTileR; ++r) {
    const char4 c = *reinterpret_cast<const char4*>(q + off + r * C);
    float4 o;
    o.x = __fmul_rn(static_cast<float>(c.x), s);
    o.y = __fmul_rn(static_cast<float>(c.y), s);
    o.z = __fmul_rn(static_cast<float>(c.z), s);
    o.w = __fmul_rn(static_cast<float>(c.w), s);
    *reinterpret_cast<float4*>(out + off + r * C) = o;
  }
}

long long num_blocks(long long ntiles) {
  return (ntiles + kWarps - 1) / kWarps;
}

}  // namespace

// Plain C interface, loaded with ctypes.  x/q/scales/out are device
// pointers of contiguous, 16-byte aligned buffers; R % 8 == 0 and
// C % 128 == 0 (the wrapper checks).  Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int bq_quantize_f32(const float* x, signed char* q, float* scales,
                               long long R, long long C, void* stream) {
  const long long ntiles = (R / kTileR) * (C / kTileC);
  if (ntiles == 0) return 0;
  quant_kernel<<<(unsigned)num_blocks(ntiles), kWarps * 32, 0,
                 static_cast<cudaStream_t>(stream)>>>(x, q, scales, C, ntiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bq_dequantize_f32(const signed char* q, const float* scales,
                                 float* out, long long R, long long C,
                                 void* stream) {
  const long long ntiles = (R / kTileR) * (C / kTileC);
  if (ntiles == 0) return 0;
  dequant_kernel<<<(unsigned)num_blocks(ntiles), kWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(q, scales, out, C,
                                                        ntiles);
  return static_cast<int>(cudaGetLastError());
}
