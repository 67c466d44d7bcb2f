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
//   Only slots c < C_live hold the cache: the wrapper pads C up to a
//   multiple of 32 with slots that get no weight at all (logit -inf), so
//   an all-empty row weighs its C_live slots uniformly, as the plain
//   version does on the unpadded cache.
//   Any G = H/kv >= 1 and any hd <= 256, as the zoo's configs need
//   (gemma3-4b: G 2 at hd 256; granite-34b: G 48 at hd 128).
//
// Bound: bytes.  Each step reads the whole cache (K and V) once and does
// 4 flops per cached element (two multiply-adds per query row of the
// group, amortised over G = H/kv rows), far below the card's
// operations-per-byte line.  At the decode path's shape (B 8, H 24, kv 2,
// hd 128, C 4096, f32) that is 67.4 MB: 0.02013 ms at 3.35 TB/s.  What
// matters is that the cache is read once, that enough bytes are in
// flight, and that the SM's work per byte stays below the memory's pace.
// With B = 1 and kv = 2 the (b, kv head) grid of the TPU kernel would
// occupy 2 of 132 SMs, so the cache length is split ("flash decoding"):
//
//   pass 1: one CTA per (C split of split_c slots, kv head and row group,
//           b).  The query rows of the group sit in shared memory and
//           share every K/V tile (32 slots x hd); an online softmax keeps
//           an f32 running max m, denominator l and accumulator per row,
//           as the TPU kernel does over its sequential grid axis.  Each
//           CTA writes its partial (m, l, acc) to scratch.
//   pass 2: one CTA per (query row, kv head, b) combines the splits in a
//           fixed order: M = max m_s, out = sum e^(m_s-M) acc_s /
//           max(sum e^(m_s-M) l_s, 1e-30).
//
// Three forms of pass 1, chosen by (G, hd) alone (register_form, then
// tiled_form):
//
//   - registers (G <= 32, hd <= 128, hd a multiple of 8): 128 threads, one
//     CTA per (split, kv head, b), all G rows in it.
//     * Tile ring.  K, V and the tile's 32 kpos entries go global ->
//       shared as 16-byte cp.async.cg copies (warp w copies slots w, w+4,
//       ..., lane c its c-th 16-byte chunk of the row: no division) into
//       a ring of kStages = 2 tiles, kept in the input dtype (a bf16
//       tile is half the bytes) and converted to f32 where they are read.
//       While tile i is computed, tile i+1 is in flight; the last split
//       of a C that is not a multiple of split_c has fewer tiles and
//       nothing is fetched past its end (empty commit groups keep the
//       wait counts uniform).  One __syncthreads per tile: it publishes
//       tile i and retires tile i-1's stage for the next copy.  Copies
//       of this source timed side by side on an H100 at the decode
//       path's shape ran slower with a third stage, and with a split of
//       128 or 512 slots; a copy that only loads the tiles took most of
//       the call's time, so the pass is bound by its loads, not by its
//       arithmetic.
//     * Alignment.  Every 16-byte copy needs a 16-byte-aligned source:
//       hd a multiple of 8 makes every row 16-byte aligned when k, v and
//       kpos are; the wrapper checks their data_ptr and raises otherwise.
//       K rows are padded by 16 bytes (4 f32 or 8 bf16), so they stay
//       aligned and 16-byte reads of one column chunk across 32 slots
//       (row stride 132 f32 or 136 bf16 at hd 128) hit all 32 banks once
//       per quarter warp.  V is read along rows and is not padded.
//     * Logits.  Warp w owns query rows w, w+4, ..., (kRows = ceil(G/4) of
//       them; rows past G are zero and never written out), lane t owns
//       slot t.  The thread walks d in 16-byte steps of its K row, reads
//       that chunk once and uses it for all its rows, each with 4
//       independent partial sums; q comes as broadcast float4 reads.  At
//       G 12: 1 K and 3 q reads per 12 FMAs (f32).
//     * Softmax.  The logits of a row already sit one per lane in the
//       warp that owns the row, so the online softmax runs in registers
//       (xor-butterfly max and sum: every lane ends with the same bits),
//       with m, l and alpha per row in registers.  p goes to a shared row
//       private to the warp: a __syncwarp, no CTA barrier.
//     * P.V.  Lane c owns elements 4c..4c+3 of each of its warp's rows
//       (acc[kRows][4] in registers).  Per slot it reads its 4 V elements
//       once (a 16-byte f32 or 8-byte bf16 read, conflict-free along the
//       row) for all its rows, and p as broadcast float4 per 4 slots: at
//       G 12, 7 reads per 48 FMAs.  Each accumulator is scaled by alpha
//       and then takes one fma per slot in slot order, as before.
//   - tiled (every other G with hd a multiple of 8, hd <= 256): 256
//     threads; one CTA per (split, kv head and group of at most kTiledRows
//     = 64 query rows, b), so a kv head's rows share each K/V tile read
//     from device memory (granite-34b's 48 rows: K/V read once per split,
//     not once per 8-row group).  The split is the wrapper's
//     (decode_attention.split_c): with at most kSlicedRows rows per CTA,
//     at most 8 splits of at least 128 slots; with more, 64 slots.
//     gemma3-4b's caches (C 1024 and 2048) and granite-34b's (C 2048)
//     each give 128 CTAs at B 4.  Timed on an H100 (NVIDIA H100 80GB
//     HBM3, 700 W; tools/decode_attention_variants.py): at gemma3-4b's C
//     2048, 16 splits of 128 slots took 11-13 % longer than 8 of 256 (a
//     second wave, and twice the partials for the combine pass); at
//     granite-34b's, splits of 32 or 128 slots took a third longer than
//     64.
//     * Tile ring: as the register form's (2 stages of 32-slot K, V and
//       kpos tiles in the input dtype, 16-byte cp.async.cg copies, K rows
//       padded by 16 bytes, empty commit groups past the split's end),
//       with warp w copying slots w, w+8, ... and lane c chunks c, c+32.
//       At hd 256 f32 a stage is 32 x (1040 + 1024) B + 128 B of kpos, so
//       the ring takes 132 KB and one CTA fits on an SM.  A third stage
//       (it fits beside up to 8 query rows) was 2-4 % faster at
//       gemma3-4b's shapes and 3-4 % slower at granite-34b's: not
//       kept.  At gemma3-4b's shapes the pass is bound by its loads:
//       without the logits and P.V it took 96-97 % of its time.  bf16
//       halves the ring.
//     * Logits.  The 8 warps are (row groups x hd slices), chosen from
//       the rows per CTA alone.  Up to kSlicedRows rows (gemma3-4b's G 2):
//       one row group, warp w takes the 16-byte chunks w, w+8, ... of hd
//       and lane t slot t; the thread reads each K chunk once for all the
//       rows, with 4 partial sums a row, and the 8 warps' partial dots are
//       added through shared memory in warp order.  Above (granite-34b's
//       48): 8 row groups, warp w owns rows w, w+8, ... over all of hd, as
//       in the register form.  q comes as broadcast float4 reads.
//     * Softmax.  Warp w runs the online softmax of rows w, w+8, ... (lane
//       = slot; xor-butterfly max and sum, so every lane ends with the
//       same bits), m and l in its registers, p and alpha to shared
//       memory for P.V.
//     * P.V.  Accumulators in registers: each thread owns 4-element runs
//       of hd of its row group's rows and reads each V element once for
//       all of them.  With one row group, thread i owns run i % 64 and
//       slots 8 (i / 64).. of each tile (4 slot groups, their sums added
//       in slot-group order at the end of the split); with 8, lane c
//       owns runs c and c + 32 of its warp's rows over all 32 slots.
//   - shared memory (hd not a multiple of 8, hd <= 256; PR 16's form,
//     which no zoo config reaches): 256 threads; the
//     accumulators are [rows][hd] f32 in shared memory beside the query
//     rows, and thread i updates elements i, i + 256, ...  A CTA takes at
//     most kGroupRows = 8 query rows of a kv head; more rows go to further
//     CTAs, each reading the split's K/V again (from L2 at the zoo's
//     shapes).  That bounds its shared memory at 83 KB (hd 256) and gives
//     granite-34b's 48 rows 6x the CTAs: with all 48 rows in one CTA, its
//     32 CTAs took 0.183 ms at (B 4, C 2048), latency-bound on 8 warps per
//     SM (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's kernel_time).
//
// Batch invariance: the split count, the row groups, the ring and every
// reduction order depend on C, hd, G and the dtype only, never on B, so a
// row's output is bit-identical whether it is computed alone or stacked
// with other sessions' rows (the serving chain batches steps across
// sessions; its tokens must equal the single-session reference bit for
// bit).  Arithmetic is IEEE f32: fmaf, expf, true division, no fast math,
// no TF32.  Masked logits are -1e30 and the running max starts at -1e30
// (as in the TPU kernel), so an all-empty cache weighs its slots
// uniformly and stays finite; a padding slot's logit is -inf, and with the
// running max at least -1e30 its weight is exactly 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // register form; the combine pass
constexpr int kWideThreads = 256;  // tiled and shared-memory forms
constexpr int kTile = 32;          // cache slots per shared-memory tile
constexpr int kRegG = 32;          // register form: query rows per kv head
constexpr int kRegHd = 128;        // register form: head_dim at most
constexpr int kRegHdMultiple = 8;  // register form: 16-byte rows in bf16
constexpr int kRegWarps = kThreads / 32;   // register form: row groups
constexpr int kMaxHd = 256;        // head_dim, either form
constexpr int kGroupRows = 8;      // shared-memory form: query rows per CTA
constexpr int kStages = 2;         // register and tiled forms: ring tiles
constexpr int kWarps = kWideThreads / 32;  // tiled form
constexpr int kTiledHdMultiple = 8;  // tiled form: 16-byte rows in bf16
constexpr int kTiledRows = 64;     // tiled form: query rows per CTA
constexpr int kSlicedRows = 8;     // tiled form: up to this, warps slice hd
constexpr float kNegInf = -1e30f;
constexpr float kPadLogit = -INFINITY;   // slots at or past C_live
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of shared memory as f32: 4 floats, or 8 bf16 widened.
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
}
// two bf16 (element 0 in the low half) as f32: exact, a bf16 is the high
// half of its f32
__device__ __forceinline__ float2 widen(unsigned w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = widen(w[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
// 4 consecutive elements of shared memory as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const float2 lo = widen(a.x), hi = widen(a.y);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

bool register_form(int G, int hd) {
  return G <= kRegG && hd <= kRegHd && hd % kRegHdMultiple == 0;
}

bool tiled_form(int hd) { return hd % kTiledHdMultiple == 0; }

// -- register form -------------------------------------------------------------

// Shared memory of the register form: q [RP][hd] and p [RP][kTile] f32
// (RP = kRegWarps * rows, rows per warp), then the ring, each stage
// k [kTile][hd + 16 B] and v [kTile][hd] in T and kpos [kTile] int32: at
// most 88 KB (f32, 32 rows, hd 128), so two CTAs fit on an SM.
template <typename T>
size_t reg_smem_bytes(int rows, int hd) {
  return sizeof(float) * (size_t)kRegWarps * rows * (hd + kTile) +
         kStages * (sizeof(T) * (size_t)kTile * (2 * hd + 16 / sizeof(T)) +
                    sizeof(int) * kTile);
}

template <typename T, int kRows>
__global__ void __launch_bounds__(kThreads, 2)
reg_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kpos,
                 const int* __restrict__ pos, float* __restrict__ part_acc,
                 float* __restrict__ part_ml, int C, int C_live, int kv,
                 int G, int hd, int split_c, int splits, int window,
                 float scale) {
  constexpr int kVec = 16 / sizeof(T);       // elements per 16-byte copy
  constexpr int kRP = kRegWarps * kRows;     // query rows, padded
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ks = hd + kVec;                  // K row stride: +16 bytes
  const int chunks = hd / kVec;              // 16-byte chunks per row
  const int stage_elems =                    // k, v, then kpos in T units
      kTile * (ks + hd) + kTile * (int)(sizeof(int) / sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* p_s = q_s + kRP * hd;
  T* ring = reinterpret_cast<T*>(p_s + kRP * kTile);

  const size_t row = (size_t)kv * hd;        // elements between cache slots
  const T* kb = k + (size_t)b * C * row + (size_t)h * hd;
  const T* vb = v + (size_t)b * C * row + (size_t)h * hd;
  const int* kp = kpos + (size_t)b * C;
  const int c0 = s * split_c;
  const int tiles = (min(C, c0 + split_c) - c0) / kTile;

  // Tile i of the split into stage st; past the split's end, only the
  // (empty) commit group.
  auto fetch = [&](int i, int st) {
    if (i < tiles) {
      T* k_st = ring + st * stage_elems;
      T* v_st = k_st + kTile * ks;
      int* kp_st = reinterpret_cast<int*>(v_st + kTile * hd);
      const int t0 = c0 + i * kTile;
      if (lane < chunks) {
        for (int t = warp; t < kTile; t += kRegWarps) {
          const size_t g = (size_t)(t0 + t) * row + lane * kVec;
          cp_async16(k_st + t * ks + lane * kVec, kb + g);
          cp_async16(v_st + t * hd + lane * kVec, vb + g);
        }
      }
      if (threadIdx.x < kTile / 4)
        cp_async16(kp_st + threadIdx.x * 4, kp + t0 + threadIdx.x * 4);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fetch(i, i);

  // this warp's query rows g = warp + kRegWarps * j, zero past G
  const T* qb = q + ((size_t)b * kv + h) * G * hd;
  for (int g = warp; g < kRP; g += kRegWarps)
    for (int d = lane; d < hd; d += 32)
      q_s[g * hd + d] = g < G ? to_f32(qb[g * hd + d]) : 0.0f;

  float m[kRows], l[kRows], acc[kRows][4];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    m[j] = kNegInf;
    l[j] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;
  }
  const int now = pos[b];
  const int d0 = lane * 4;                   // P.V: elements d0..d0+3
  int st = 0;                                // stage of tile i
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();        // tile i is in; every thread is past tile i-1
    fetch(i + kStages - 1, st == 0 ? kStages - 1 : st - 1);
    const T* k_st = ring + st * stage_elems;
    const T* v_st = k_st + kTile * ks;
    const int* kp_st = reinterpret_cast<const int*>(v_st + kTile * hd);

    // logits: lane = slot; each 16-byte chunk of K serves every row
    float part[kRows][4];
#pragma unroll
    for (int j = 0; j < kRows; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[j][c] = 0.0f;
    const T* kr = k_st + lane * ks;
#pragma unroll 4
    for (int d = 0; d < hd; d += kVec) {
      float kx[kVec];
      load16(kr + d, kx);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float* qr = q_s + (warp + kRegWarps * j) * hd + d;
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + e);
          part[j][0] = fmaf(qv.x, kx[e], part[j][0]);
          part[j][1] = fmaf(qv.y, kx[e + 1], part[j][1]);
          part[j][2] = fmaf(qv.z, kx[e + 2], part[j][2]);
          part[j][3] = fmaf(qv.w, kx[e + 3], part[j][3]);
        }
      }
    }
    const int kt = kp_st[lane];
    const int delta = now - kt;
    const bool valid = kt >= 0 && delta >= 0 && (window <= 0 || delta < window);
    const float masked = c0 + i * kTile + lane < C_live ? kNegInf : kPadLogit;

    // online softmax in registers: the warp's lanes are the tile's slots
    float alpha[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const float dot = (part[j][0] + part[j][1]) + (part[j][2] + part[j][3]);
      const float x = valid ? dot * scale : masked;
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_cur = fmaxf(m[j], mx);
      const float p = expf(x - m_cur);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      p_s[(warp + kRegWarps * j) * kTile + lane] = p;
      alpha[j] = expf(m[j] - m_cur);
      l[j] = l[j] * alpha[j] + sum;
      m[j] = m_cur;
    }
    __syncwarp();

    // acc[j][:] = acc[j][:] * alpha[j] + sum_t p[j][t] v[t][d0..d0+3]
    if (d0 < hd) {
#pragma unroll
      for (int j = 0; j < kRows; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] *= alpha[j];
#pragma unroll
      for (int t = 0; t < kTile; t += 4) {
        float4 pv[kRows];
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          pv[j] = *reinterpret_cast<const float4*>(
              p_s + (warp + kRegWarps * j) * kTile + t);
        const float4 v0 = load4(v_st + (t + 0) * hd + d0);
        const float4 v1 = load4(v_st + (t + 1) * hd + d0);
        const float4 v2 = load4(v_st + (t + 2) * hd + d0);
        const float4 v3 = load4(v_st + (t + 3) * hd + d0);
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          fma4(acc[j], pv[j].x, v0);
          fma4(acc[j], pv[j].y, v1);
          fma4(acc[j], pv[j].z, v2);
          fma4(acc[j], pv[j].w, v3);
        }
      }
    }
    st = st + 1 == kStages ? 0 : st + 1;
  }
  cp_async_wait<0>();

  const size_t base = (((size_t)b * kv + h) * splits + s) * G;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int g = warp + kRegWarps * j;
    if (g < G) {
      if (d0 < hd)
        *reinterpret_cast<float4*>(part_acc + (base + g) * hd + d0) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      if (lane == 0) {
        part_ml[(base + g) * 2] = m[j];
        part_ml[(base + g) * 2 + 1] = l[j];
      }
    }
  }
}

template <typename T, int kRows>
cudaError_t launch_reg(const T* q, const T* k, const T* v, const int* kpos,
                       const int* pos, float* part_acc, float* part_ml, int B,
                       int C, int C_live, int kv, int G, int hd, int split_c,
                       int splits, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem = reg_smem_bytes<T>(kRows, hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reg_split_kernel<T, kRows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  reg_split_kernel<T, kRows><<<dim3(splits, kv, B), kThreads, smem, stream>>>(
      q, k, v, kpos, pos, part_acc, part_ml, C, C_live, kv, G, hd, split_c,
      splits, window, scale);
  return cudaGetLastError();
}

// -- tiled form ----------------------------------------------------------------

// Query rows per CTA of the tiled form: all of G up to kTiledRows.
int tiled_rows(int G) { return G < kTiledRows ? G : kTiledRows; }

// Shared memory of the tiled form, RP = kGroups * kRows padded query rows:
// q [RP][hd], the warps' partial dots [kWarps * kRows][kTile], p
// [RP][kTile] and alpha [RP] (padded to 16 bytes) in f32, then the ring as
// the register form's.  At most 213 KB (f32, 64 rows, hd 256); the slot
// groups' P.V sums [4][RP][hd] f32 reuse the ring after the last tile.
template <typename T, int kGroups, int kRows>
size_t tiled_smem_bytes(int hd) {
  constexpr size_t kRP = kGroups * kRows;
  return sizeof(float) * (kRP * hd + (size_t)kWarps * kRows * kTile +
                          kRP * kTile + ((kRP + 3) & ~(size_t)3)) +
         kStages * (sizeof(T) * (size_t)kTile * (2 * hd + 16 / sizeof(T)) +
                    sizeof(int) * kTile);
}

// kGroups row groups of kRows rows each: kGroups = 1 (warps slice hd, at
// most kSlicedRows rows) or kWarps (warp w owns rows w, w+8, ...).
template <typename T, int kGroups, int kRows>
__global__ void __launch_bounds__(kWideThreads, 1)
tiled_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ kpos,
                   const int* __restrict__ pos, float* __restrict__ part_acc,
                   float* __restrict__ part_ml, int C, int C_live, int kv,
                   int G, int hd, int rows, int groups, int split_c,
                   int splits, int window,
                   float scale) {
  constexpr int kVec = 16 / sizeof(T);       // elements per 16-byte copy
  constexpr int kRP = kGroups * kRows;       // query rows, padded
  constexpr int kSlices = kWarps / kGroups;  // logits: hd slices
  constexpr int kSoftRows = (kRP + kWarps - 1) / kWarps;  // per warp
  constexpr int kGroupThreads = kWideThreads / kGroups;   // P.V
  constexpr int kRunStride = kGroupThreads < 64 ? kGroupThreads : 64;
  constexpr int kSlotGroups = kGroupThreads / kRunStride;
  constexpr int kRuns = kMaxHd / 4 / kRunStride;          // per thread
  constexpr int kSlots = kTile / kSlotGroups;             // per slot group
  static_assert(kGroups == 1 || kGroups == kWarps, "row groups");
  static_assert(kGroups == kWarps || kRows <= kSlicedRows, "sliced rows");

  const int s = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / groups;
  const int g0 = (blockIdx.y - h * groups) * rows;
  const int R = min(rows, G - g0);           // query rows of this CTA
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ks = hd + kVec;                  // K row stride: +16 bytes
  const int chunks = hd / kVec;              // 16-byte chunks per row
  const int stage_elems =                    // k, v, then kpos in T units
      kTile * (ks + hd) + kTile * (int)(sizeof(int) / sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* dot_s = q_s + kRP * hd;             // [kSlices][kRP][kTile]
  float* p_s = dot_s + kWarps * kRows * kTile;
  float* a_s = p_s + kRP * kTile;
  T* ring = reinterpret_cast<T*>(a_s + ((kRP + 3) & ~3));

  const size_t row = (size_t)kv * hd;        // elements between cache slots
  const T* kb = k + (size_t)b * C * row + (size_t)h * hd;
  const T* vb = v + (size_t)b * C * row + (size_t)h * hd;
  const int* kp = kpos + (size_t)b * C;
  const int c0 = s * split_c;
  const int tiles = (min(C, c0 + split_c) - c0) / kTile;

  // Tile i of the split into stage st; past the split's end, only the
  // (empty) commit group.
  auto fetch = [&](int i, int st) {
    if (i < tiles) {
      T* k_st = ring + st * stage_elems;
      T* v_st = k_st + kTile * ks;
      int* kp_st = reinterpret_cast<int*>(v_st + kTile * hd);
      const int t0 = c0 + i * kTile;
      for (int t = warp; t < kTile; t += kWarps)
        for (int c = lane; c < chunks; c += 32) {
          const size_t g = (size_t)(t0 + t) * row + c * kVec;
          cp_async16(k_st + t * ks + c * kVec, kb + g);
          cp_async16(v_st + t * hd + c * kVec, vb + g);
        }
      if (tid < kTile / 4) cp_async16(kp_st + tid * 4, kp + t0 + tid * 4);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fetch(i, i);

  // query rows g0 + g, zero past R; warp w loads rows w, w+8, ..., every
  // load issued before the first store, so the loads overlap (a loop of
  // load and store waits out each load in turn)
  const T* qb = q + ((size_t)b * kv * G + (size_t)h * G + g0) * hd;
  {
    constexpr int kQ = kMaxHd / 32;          // elements per lane and row
    float qr[kSoftRows][kQ];
#pragma unroll
    for (int j = 0; j < kSoftRows; ++j) {
      const int g = warp + kWarps * j;
#pragma unroll
      for (int e = 0; e < kQ; ++e) {
        const int d = lane + 32 * e;
        qr[j][e] = g < R && d < hd ? to_f32(qb[g * hd + d]) : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < kSoftRows; ++j) {
      const int g = warp + kWarps * j;
#pragma unroll
      for (int e = 0; e < kQ; ++e) {
        const int d = lane + 32 * e;
        if (g < kRP && d < hd) q_s[g * hd + d] = qr[j][e];
      }
    }
  }

  // logits: this warp's row group and hd slice
  const int lg = warp / kSlices, sl = warp - lg * kSlices;
  // P.V: this thread's row group, slot group and first run
  const int pg = tid / kGroupThreads, pi = tid - pg * kGroupThreads;
  const int sg = pi / kRunStride, run0 = pi - sg * kRunStride;
  float m[kSoftRows], l[kSoftRows], acc[kRows][kRuns][4];
#pragma unroll
  for (int j = 0; j < kSoftRows; ++j) {
    m[j] = kNegInf;
    l[j] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int r = 0; r < kRuns; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][r][c] = 0.0f;
  const int now = pos[b];
  int st = 0;                                // stage of tile i
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();        // tile i is in; every thread is past tile i-1
    fetch(i + kStages - 1, st == 0 ? kStages - 1 : st - 1);
    const T* k_st = ring + st * stage_elems;
    const T* v_st = k_st + kTile * ks;
    const int* kp_st = reinterpret_cast<const int*>(v_st + kTile * hd);

    // logits over this warp's slice: lane = slot; each 16-byte chunk of K
    // serves every row of the group
    float part[kRows][4];
#pragma unroll
    for (int j = 0; j < kRows; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[j][c] = 0.0f;
    const T* kr = k_st + lane * ks;
#pragma unroll 2
    for (int c = sl; c < chunks; c += kSlices) {
      float kx[kVec];
      load16(kr + c * kVec, kx);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float* qr = q_s + (lg + kGroups * j) * hd + c * kVec;
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + e);
          part[j][0] = fmaf(qv.x, kx[e], part[j][0]);
          part[j][1] = fmaf(qv.y, kx[e + 1], part[j][1]);
          part[j][2] = fmaf(qv.z, kx[e + 2], part[j][2]);
          part[j][3] = fmaf(qv.w, kx[e + 3], part[j][3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      dot_s[(sl * kRP + lg + kGroups * j) * kTile + lane] =
          (part[j][0] + part[j][1]) + (part[j][2] + part[j][3]);
    __syncthreads();

    // online softmax of rows warp, warp + 8, ...: the slices' dots added
    // in slice order
    const int kt = kp_st[lane];
    const int delta = now - kt;
    const bool valid = kt >= 0 && delta >= 0 && (window <= 0 || delta < window);
    const float masked = c0 + i * kTile + lane < C_live ? kNegInf : kPadLogit;
#pragma unroll
    for (int j = 0; j < kSoftRows; ++j) {
      const int g = warp + kWarps * j;
      // always true with 8 row groups: no branch between the rows' chains
      if (kGroups == kWarps || g < kRP) {
        float dot = dot_s[g * kTile + lane];
#pragma unroll
        for (int x = 1; x < kSlices; ++x)
          dot += dot_s[(x * kRP + g) * kTile + lane];
        const float xv = valid ? dot * scale : masked;
        float mx = xv;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float m_cur = fmaxf(m[j], mx);
        const float p = expf(xv - m_cur);
        float sum = p;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
        p_s[g * kTile + lane] = p;
        const float alpha = expf(m[j] - m_cur);
        if (lane == 0) a_s[g] = alpha;
        l[j] = l[j] * alpha + sum;
        m[j] = m_cur;
      }
    }
    __syncthreads();

    // acc[j][:] = acc[j][:] * alpha + sum_t p[j][t] v[t][run]: this
    // thread's slot group, each V run read once for all its rows
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const float alpha = a_s[pg + kGroups * j];
#pragma unroll
      for (int r = 0; r < kRuns; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][r][c] *= alpha;
    }
#pragma unroll
    for (int r = 0; r < kRuns; ++r) {
      const int d0 = (run0 + kRunStride * r) * 4;
      if (d0 < hd) {
#pragma unroll 2
        for (int t = sg * kSlots; t < (sg + 1) * kSlots; t += 4) {
          float4 pv[kRows];
#pragma unroll
          for (int j = 0; j < kRows; ++j)
            pv[j] = *reinterpret_cast<const float4*>(
                p_s + (pg + kGroups * j) * kTile + t);
          const float4 v0 = load4(v_st + (t + 0) * hd + d0);
          const float4 v1 = load4(v_st + (t + 1) * hd + d0);
          const float4 v2 = load4(v_st + (t + 2) * hd + d0);
          const float4 v3 = load4(v_st + (t + 3) * hd + d0);
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            fma4(acc[j][r], pv[j].x, v0);
            fma4(acc[j][r], pv[j].y, v1);
            fma4(acc[j][r], pv[j].z, v2);
            fma4(acc[j][r], pv[j].w, v3);
          }
        }
      }
    }
    st = st + 1 == kStages ? 0 : st + 1;
  }
  cp_async_wait<0>();

  const size_t base = (((size_t)b * kv + h) * splits + s) * G + g0;
#pragma unroll
  for (int j = 0; j < kSoftRows; ++j) {
    const int g = warp + kWarps * j;
    if (g < R && lane == 0) {
      part_ml[(base + g) * 2] = m[j];
      part_ml[(base + g) * 2 + 1] = l[j];
    }
  }
  if constexpr (kSlotGroups > 1) {
    // slot groups 1.. hand their sums to group 0 through the ring
    float* pv_s = reinterpret_cast<float*>(ring);   // [kSlotGroups][kRP][hd]
    __syncthreads();        // every thread is past the last tile
    if (sg > 0) {
#pragma unroll
      for (int j = 0; j < kRows; ++j)
#pragma unroll
        for (int r = 0; r < kRuns; ++r) {
          const int d0 = (run0 + kRunStride * r) * 4;
          if (d0 < hd)
            *reinterpret_cast<float4*>(
                pv_s + (sg * kRP + pg + kGroups * j) * hd + d0) =
                make_float4(acc[j][r][0], acc[j][r][1], acc[j][r][2],
                            acc[j][r][3]);
        }
    }
    __syncthreads();
    if (sg > 0) return;
#pragma unroll
    for (int j = 0; j < kRows; ++j)
#pragma unroll
      for (int r = 0; r < kRuns; ++r) {
        const int d0 = (run0 + kRunStride * r) * 4;
        if (d0 < hd)
          for (int x = 1; x < kSlotGroups; ++x) {
            const float4 o = *reinterpret_cast<const float4*>(
                pv_s + (x * kRP + pg + kGroups * j) * hd + d0);
            acc[j][r][0] += o.x;
            acc[j][r][1] += o.y;
            acc[j][r][2] += o.z;
            acc[j][r][3] += o.w;
          }
      }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int g = pg + kGroups * j;
    if (g < R) {
#pragma unroll
      for (int r = 0; r < kRuns; ++r) {
        const int d0 = (run0 + kRunStride * r) * 4;
        if (d0 < hd)
          *reinterpret_cast<float4*>(part_acc + (base + g) * hd + d0) =
              make_float4(acc[j][r][0], acc[j][r][1], acc[j][r][2],
                          acc[j][r][3]);
      }
    }
  }
}

template <typename T, int kGroups, int kRows>
cudaError_t launch_tiled(const T* q, const T* k, const T* v, const int* kpos,
                         const int* pos, float* part_acc, float* part_ml,
                         int B, int C, int C_live, int kv, int G, int hd,
                         int split_c, int splits, int window, float scale,
                         cudaStream_t stream) {
  const int rows = tiled_rows(G);
  const int groups = (G + rows - 1) / rows;
  const size_t smem = tiled_smem_bytes<T, kGroups, kRows>(hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tiled_split_kernel<T, kGroups, kRows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  tiled_split_kernel<T, kGroups, kRows>
      <<<dim3(splits, kv * groups, B), kWideThreads, smem, stream>>>(
          q, k, v, kpos, pos, part_acc, part_ml, C, C_live, kv, G, hd, rows,
          groups, split_c, splits, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tiled_form(const T* q, const T* k, const T* v,
                              const int* kpos, const int* pos,
                              float* part_acc, float* part_ml, int B, int C,
                              int C_live, int kv, int G, int hd, int split_c,
                              int splits, int window, float scale,
                              cudaStream_t stream) {
  const int rows = tiled_rows(G);
#define DA_TILED(GROUPS, R)                                                   \
  case R:                                                                     \
    return launch_tiled<T, GROUPS, R>(q, k, v, kpos, pos, part_acc, part_ml,  \
                                      B, C, C_live, kv, G, hd, split_c,       \
                                      splits, window, scale, stream);
  if (rows <= kSlicedRows) {
    switch (rows) {
      DA_TILED(1, 1) DA_TILED(1, 2) DA_TILED(1, 3) DA_TILED(1, 4)
      DA_TILED(1, 5) DA_TILED(1, 6) DA_TILED(1, 7) DA_TILED(1, 8)
    }
  } else {
    switch ((rows + kWarps - 1) / kWarps) {
      DA_TILED(kWarps, 2) DA_TILED(kWarps, 3) DA_TILED(kWarps, 4)
      DA_TILED(kWarps, 5) DA_TILED(kWarps, 6) DA_TILED(kWarps, 7)
      DA_TILED(kWarps, 8)
    }
  }
#undef DA_TILED
  return cudaErrorInvalidValue;
}
static_assert(kSlicedRows == kWarps && kTiledRows == 8 * kWarps,
              "one case per row count");

// -- shared-memory form ----------------------------------------------------------

int group_rows(int G) { return G < kGroupRows ? G : kGroupRows; }

size_t smem_bytes(int G, int hd) {
  // q [R][hd], k [kTile][hd+1] (padded: conflict-free column reads),
  // v [kTile][hd], p [R][kTile], m/l/alpha [R], acc [R][hd].  R = rows
  // per CTA.
  const size_t R = group_rows(G);
  return sizeof(float) * (R * hd + (size_t)kTile * (hd + 1) +
                          (size_t)kTile * hd + R * kTile + 3 * R + R * hd);
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ kpos,
             const int* __restrict__ pos, float* __restrict__ part_acc,
             float* __restrict__ part_ml, int C, int C_live, int kv, int G,
             int hd, int rows, int groups, int split_c, int splits, int window,
             float scale) {
  constexpr int kThr = kWideThreads;
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
  float* acc_s = a_s + rows;

  const T* qb = q + ((size_t)b * kv * G + (size_t)h * G + g0) * hd;
  for (int i = tid; i < R * hd; i += kThr) q_s[i] = to_f32(qb[i]);
  for (int g = tid; g < R; g += kThr) {
    m_s[g] = kNegInf;
    l_s[g] = 0.0f;
  }
  for (int i = tid; i < R * hd; i += kThr) acc_s[i] = 0.0f;

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
      p_s[i] = valid ? dot * scale
             : t0 + t < C_live ? kNegInf : kPadLogit;
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
    for (int i = tid; i < R * hd; i += kThr) {
      const int g = i / hd, d = i - g * hd;
      const float* pr = p_s + g * kTile;
      float a = acc_s[i] * a_s[g];
#pragma unroll 8
      for (int t = 0; t < kTile; ++t) a = fmaf(pr[t], v_s[t * hd + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  const size_t base = (((size_t)b * kv + h) * splits + s) * G + g0;
  for (int i = tid; i < R * hd; i += kThr) part_acc[base * hd + i] = acc_s[i];
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

template <typename T>
cudaError_t launch_split(const T* q, const T* k, const T* v, const int* kpos,
                         const int* pos, float* part_acc, float* part_ml,
                         int B, int C, int C_live, int kv, int G, int hd,
                         int split_c, int splits, int window, float scale,
                         cudaStream_t stream) {
  const int rows = group_rows(G);
  const int groups = (G + rows - 1) / rows;
  const size_t smem = smem_bytes(G, hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  split_kernel<T><<<dim3(splits, kv * groups, B), kWideThreads, smem,
                    stream>>>(
      q, k, v, kpos, pos, part_acc, part_ml, C, C_live, kv, G, hd, rows,
      groups, split_c, splits, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reg_form(const T* q, const T* k, const T* v,
                            const int* kpos, const int* pos, float* part_acc,
                            float* part_ml, int B, int C, int C_live, int kv,
                            int G, int hd, int split_c, int splits, int window,
                            float scale, cudaStream_t stream) {
  switch ((G + kRegWarps - 1) / kRegWarps) {
#define DA_REG_ROWS(R)                                                        \
  case R:                                                                     \
    return launch_reg<T, R>(q, k, v, kpos, pos, part_acc, part_ml, B, C,    \
                            C_live, kv, G, hd, split_c, splits, window,       \
                            scale, stream);
    DA_REG_ROWS(1) DA_REG_ROWS(2) DA_REG_ROWS(3) DA_REG_ROWS(4)
    DA_REG_ROWS(5) DA_REG_ROWS(6) DA_REG_ROWS(7) DA_REG_ROWS(8)
#undef DA_REG_ROWS
  }
  return cudaErrorInvalidValue;
}
static_assert(kRegG == 8 * kRegWarps, "one case per row count");

template <typename T>
int launch(const T* q, const T* k, const T* v, const int* kpos, const int* pos,
           float* part_acc, float* part_ml, T* out, int B, int C,
           int C_live, int kv, int G, int hd, int split_c, int window,
           float scale, cudaStream_t stream) {
  if (B <= 0 || C <= 0 || C_live <= 0 || C_live > C || kv <= 0 || G <= 0 ||
      hd <= 0 || hd > kMaxHd || C % kTile || split_c <= 0 || split_c % kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (C + split_c - 1) / split_c;
  cudaError_t e =
      register_form(G, hd)
          ? launch_reg_form<T>(q, k, v, kpos, pos, part_acc, part_ml, B, C,
                               C_live, kv, G, hd, split_c, splits, window,
                               scale, stream)
      : tiled_form(hd)
          ? launch_tiled_form<T>(q, k, v, kpos, pos, part_acc, part_ml, B, C,
                                 C_live, kv, G, hd, split_c, splits, window,
                                 scale, stream)
          : launch_split<T>(q, k, v, kpos, pos, part_acc, part_ml, B, C,
                            C_live, kv, G, hd, split_c, splits, window, scale,
                            stream);
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
// 32, 0 < C_live <= C (slots from C_live on are padding and get no
// weight), G >= 1, hd <= 256; window <= 0 means no window.  With hd a
// multiple of 8 (the register and tiled forms) k, v and kpos must be
// 16-byte aligned.  split_c is the wrapper's (decode_attention.split_c).
// Launches both passes on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for shapes
// the kernel does not take; never synchronises.
extern "C" int da_decode_f32(const float* q, const float* k, const float* v,
                             const int* kpos, const int* pos, float* part_acc,
                             float* part_ml, float* out, int B, int C,
                             int C_live, int kv, int G, int hd, int split_c,
                             int window, float scale, void* stream) {
  return launch<float>(q, k, v, kpos, pos, part_acc, part_ml, out, B, C,
                       C_live, kv, G, hd, split_c, window, scale,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int da_decode_bf16(const void* q, const void* k, const void* v,
                              const int* kpos, const int* pos, float* part_acc,
                              float* part_ml, void* out, int B, int C,
                              int C_live, int kv, int G, int hd, int split_c,
                              int window, float scale, void* stream) {
  using bf = __nv_bfloat16;
  return launch<bf>(static_cast<const bf*>(q), static_cast<const bf*>(k),
                    static_cast<const bf*>(v), kpos, pos, part_acc, part_ml,
                    static_cast<bf*>(out), B, C, C_live, kv, G, hd, split_c,
                    window, scale, static_cast<cudaStream_t>(stream));
}
