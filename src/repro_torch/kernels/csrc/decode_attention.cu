// Single-token GQA decode attention over a KV cache, for sm_90a.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/decode_attention.py
// (decode_attention, _decode_attn_kernel).  Every decode step of every
// attention layer on the port's decode paths runs it once.
//
//   q [B,1,H,hd], k/v [B,C,kv,hd] (f32 or bf16), kpos [B,C] int32
//   (-1 = empty slot), pos [B] int32  ->  out [B,1,H,hd] in q's dtype
//   slot c is valid iff kpos >= 0, pos - kpos >= 0 (and < window if set);
//   logits = q.k * scale, invalid ones -1e30; softmax; out = sum p v.
//   Any G = H/kv >= 1 and any hd <= 256, as the zoo's configs need
//   (gemma3-4b: G 2 at hd 256; granite-34b: G 48 at hd 128).
//
// Bound: bytes.  Each step reads the whole cache (K and V) once and does
// 4 flops per cached element (two multiply-adds per query row of the
// group, amortised over G = H/kv rows), far below the card's
// operations-per-byte line.  What matters is that the cache is read once
// and that enough blocks are in flight: with B = 1 and kv = 2 the
// (b, kv head) grid of the TPU kernel would occupy 2 of 132 SMs.  So the
// cache length is split ("flash decoding"):
//
//   pass 1: one CTA per (C split of split_c slots, kv head and row group,
//           b).  The query rows of the group sit in shared memory and
//           share every K/V tile load (32 slots x hd); an online softmax
//           keeps an f32 running max m, denominator l and accumulator per
//           row, as the TPU kernel does over its sequential grid axis.
//           Each CTA writes its partial (m, l, acc) to scratch.
//   pass 2: one CTA per (query row, kv head, b) combines the splits in a
//           fixed order: M = max m_s, out = sum e^(m_s-M) acc_s /
//           max(sum e^(m_s-M) l_s, 1e-30).
//
// Two forms of pass 1, chosen by shape:
//   - registers (G <= 32, hd <= 128): 128 threads, thread d owns element
//     d of every row's accumulator in registers (acc[32]).
//   - shared memory (any other G, hd <= 256): 256 threads; the
//     accumulators are [rows][hd] f32 in shared memory beside the query
//     rows, and thread i updates elements i, i + 256, ...  A CTA takes at
//     most kGroupRows = 8 query rows of a kv head; more rows go to further
//     CTAs, each reading the split's K/V again (from L2 at the zoo's
//     shapes).  That bounds its shared memory at 83 KB (hd 256) and gives
//     granite-34b's 48 rows 6x the CTAs: with all 48 rows in one CTA, its
//     32 CTAs took 0.183 ms at (B 4, C 2048), latency-bound on 8 warps per
//     SM (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's kernel_time).
// Both forms do the same arithmetic per accumulator element (scale by
// alpha, then one fma per slot of the tile in slot order); which form
// runs depends on G and hd only.
//
// Batch invariance: the split count, the row groups and every reduction
// order depend on C, hd and G only, never on B, so a row's output is
// bit-identical whether it is computed alone or stacked with other
// sessions' rows (the serving chain batches steps across sessions; its
// tokens must equal the single-session reference bit for bit).
// Arithmetic is IEEE: expf, true division, no fast math.  Masked logits
// are -1e30 and the running max starts at -1e30 (as in the TPU kernel), so
// an all-empty cache weighs its slots uniformly and stays finite.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // register form; the combine pass
constexpr int kWideThreads = 256;  // shared-memory form
constexpr int kTile = 32;          // cache slots per shared-memory tile
constexpr int kRegG = 32;          // register form: query rows per kv head
constexpr int kRegHd = 128;        // register form: one thread per element
constexpr int kMaxHd = 256;        // head_dim, either form
constexpr int kGroupRows = 8;      // shared-memory form: query rows per CTA
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

bool register_form(int G, int hd) { return G <= kRegG && hd <= kRegHd; }

int group_rows(int G, int hd) {
  return register_form(G, hd) ? G : (G < kGroupRows ? G : kGroupRows);
}

size_t smem_bytes(int G, int hd) {
  // q [R][hd], k [kTile][hd+1] (padded: conflict-free column reads),
  // v [kTile][hd], p [R][kTile], m/l/alpha [R]; the shared-memory form
  // adds acc [R][hd].  R = rows per CTA.
  const size_t R = group_rows(G, hd);
  const size_t acc = register_form(G, hd) ? 0 : R * hd;
  return sizeof(float) * (R * hd + (size_t)kTile * (hd + 1) +
                          (size_t)kTile * hd + R * kTile + 3 * R + acc);
}

template <typename T, bool kReg>
__global__ void __launch_bounds__(kReg ? kThreads : kWideThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ kpos,
             const int* __restrict__ pos, float* __restrict__ part_acc,
             float* __restrict__ part_ml, int C, int kv, int G, int hd,
             int rows, int groups, int split_c, int splits, int window,
             float scale) {
  constexpr int kThr = kReg ? kThreads : kWideThreads;
  const int s = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / groups;
  const int g0 = (blockIdx.y - h * groups) * rows;
  const int R = min(rows, G - g0);           // query rows of this CTA
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + rows * hd;
  float* v_s = k_s + kTile * (hd + 1);
  float* p_s = v_s + kTile * hd;
  float* m_s = p_s + rows * kTile;
  float* l_s = m_s + rows;
  float* a_s = l_s + rows;
  float* acc_s = a_s + rows;                 // shared-memory form only

  const T* qb = q + ((size_t)b * kv * G + (size_t)h * G + g0) * hd;
  for (int i = tid; i < R * hd; i += kThr) q_s[i] = to_f32(qb[i]);
  for (int g = tid; g < R; g += kThr) {
    m_s[g] = kNegInf;
    l_s[g] = 0.0f;
  }
  float acc[kReg ? kRegG : 1];
  if constexpr (kReg) {
#pragma unroll
    for (int g = 0; g < kRegG; ++g) acc[g] = 0.0f;
  } else {
    for (int i = tid; i < R * hd; i += kThr) acc_s[i] = 0.0f;
  }

  const int now = pos[b];
  const size_t row = (size_t)kv * hd;        // elements between cache slots
  const T* kb = k + (size_t)b * C * row + (size_t)h * hd;
  const T* vb = v + (size_t)b * C * row + (size_t)h * hd;
  const int* kp = kpos + (size_t)b * C;
  const int c0 = s * split_c;
  const int c1 = min(C, c0 + split_c);
  __syncthreads();

  for (int t0 = c0; t0 < c1; t0 += kTile) {
    for (int i = tid; i < kTile * hd; i += kThr) {
      const int t = i / hd, d = i - t * hd;
      const size_t off = (size_t)(t0 + t) * row + d;
      k_s[t * (hd + 1) + d] = to_f32(kb[off]);
      v_s[t * hd + d] = to_f32(vb[off]);
    }
    __syncthreads();
    // logits: one (row g, slot t) dot product per thread and pass
    for (int i = tid; i < R * kTile; i += kThr) {
      const int g = i / kTile, t = i - g * kTile;
      const float* qr = q_s + g * hd;
      const float* kr = k_s + t * (hd + 1);
      float dot = 0.0f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      const int kt = kp[t0 + t];
      const int delta = now - kt;
      const bool valid = kt >= 0 && delta >= 0 && (window <= 0 || delta < window);
      p_s[i] = valid ? dot * scale : kNegInf;
    }
    __syncthreads();
    // online softmax: one warp per query row, lane = slot of the tile
    for (int g = warp; g < R; g += kThr / 32) {
      const float x = p_s[g * kTile + lane];
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_prev = m_s[g];
      const float m_cur = fmaxf(m_prev, mx);
      const float p = expf(x - m_cur);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      p_s[g * kTile + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_cur;
      }
    }
    __syncthreads();
    // acc[g][d] = acc[g][d] * alpha[g] + sum_t p[g][t] v[t][d]
    if constexpr (kReg) {
      if (tid < hd) {                        // thread = d
#pragma unroll
        for (int g = 0; g < kRegG; ++g) {
          if (g < R) {
            const float* pr = p_s + g * kTile;
            float a = acc[g] * a_s[g];
#pragma unroll 8
            for (int t = 0; t < kTile; ++t) a = fmaf(pr[t], v_s[t * hd + tid], a);
            acc[g] = a;
          }
        }
      }
    } else {
      for (int i = tid; i < R * hd; i += kThr) {
        const int g = i / hd, d = i - g * hd;
        const float* pr = p_s + g * kTile;
        float a = acc_s[i] * a_s[g];
#pragma unroll 8
        for (int t = 0; t < kTile; ++t) a = fmaf(pr[t], v_s[t * hd + d], a);
        acc_s[i] = a;
      }
    }
    __syncthreads();
  }

  const size_t base = (((size_t)b * kv + h) * splits + s) * G + g0;
  if constexpr (kReg) {
    if (tid < hd) {
#pragma unroll
      for (int g = 0; g < kRegG; ++g)
        if (g < R) part_acc[(base + g) * hd + tid] = acc[g];
    }
  } else {
    for (int i = tid; i < R * hd; i += kThr) part_acc[base * hd + i] = acc_s[i];
  }
  for (int g = tid; g < R; g += kThr) {
    part_ml[(base + g) * 2] = m_s[g];
    part_ml[(base + g) * 2 + 1] = l_s[g];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ part_acc,
               const float* __restrict__ part_ml, T* __restrict__ out, int kv,
               int G, int hd, int splits) {
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t base = ((size_t)b * kv + h) * splits;
  float M = kNegInf;
  for (int s = 0; s < splits; ++s)
    M = fmaxf(M, part_ml[((base + s) * G + g) * 2]);
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float L = 0.0f, A = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const size_t i = (base + s) * G + g;
      const float w = expf(part_ml[i * 2] - M);
      L = fmaf(w, part_ml[i * 2 + 1], L);
      A = fmaf(w, part_acc[i * hd + d], A);
    }
    store(out + (((size_t)b * kv + h) * G + g) * hd + d, A / fmaxf(L, 1e-30f));
  }
}

template <typename T, bool kReg>
cudaError_t launch_split(const T* q, const T* k, const T* v, const int* kpos,
                         const int* pos, float* part_acc, float* part_ml,
                         int B, int C, int kv, int G, int hd, int split_c,
                         int splits, int window, float scale,
                         cudaStream_t stream) {
  const int rows = group_rows(G, hd);
  const int groups = (G + rows - 1) / rows;
  const size_t smem = smem_bytes(G, hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_kernel<T, kReg>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  split_kernel<T, kReg><<<dim3(splits, kv * groups, B),
                          kReg ? kThreads : kWideThreads, smem, stream>>>(
      q, k, v, kpos, pos, part_acc, part_ml, C, kv, G, hd, rows, groups,
      split_c, splits, window, scale);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const int* kpos, const int* pos,
           float* part_acc, float* part_ml, T* out, int B, int C, int kv,
           int G, int hd, int split_c, int window, float scale,
           cudaStream_t stream) {
  if (B <= 0 || C <= 0 || kv <= 0 || G <= 0 || hd <= 0 || hd > kMaxHd ||
      C % kTile || split_c <= 0 || split_c % kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (C + split_c - 1) / split_c;
  cudaError_t e =
      register_form(G, hd)
          ? launch_split<T, true>(q, k, v, kpos, pos, part_acc, part_ml, B, C,
                                  kv, G, hd, split_c, splits, window, scale,
                                  stream)
          : launch_split<T, false>(q, k, v, kpos, pos, part_acc, part_ml, B,
                                   C, kv, G, hd, split_c, splits, window,
                                   scale, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  combine_kernel<T><<<dim3(G, kv, B), kThreads, 0, stream>>>(
      part_acc, part_ml, out, kv, G, hd, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  All pointers are device pointers
// of contiguous buffers: q/out [B,1,kv*G,hd], k/v [B,C,kv,hd], kpos [B,C],
// pos [B], part_acc [B,kv,splits,G,hd] and part_ml [B,kv,splits,G,2] f32
// scratch with splits = ceil(C / split_c).  C and split_c are multiples of
// 32, G >= 1, hd <= 256; window <= 0 means no window.  Launches both
// passes on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take; never
// synchronises.
extern "C" int da_decode_f32(const float* q, const float* k, const float* v,
                             const int* kpos, const int* pos, float* part_acc,
                             float* part_ml, float* out, int B, int C, int kv,
                             int G, int hd, int split_c, int window,
                             float scale, void* stream) {
  return launch<float>(q, k, v, kpos, pos, part_acc, part_ml, out, B, C, kv, G,
                       hd, split_c, window, scale,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int da_decode_bf16(const void* q, const void* k, const void* v,
                              const int* kpos, const int* pos, float* part_acc,
                              float* part_ml, void* out, int B, int C, int kv,
                              int G, int hd, int split_c, int window,
                              float scale, void* stream) {
  using bf = __nv_bfloat16;
  return launch<bf>(static_cast<const bf*>(q), static_cast<const bf*>(k),
                    static_cast<const bf*>(v), kpos, pos, part_acc, part_ml,
                    static_cast<bf*>(out), B, C, kv, G, hd, split_c, window,
                    scale, static_cast<cudaStream_t>(stream));
}
