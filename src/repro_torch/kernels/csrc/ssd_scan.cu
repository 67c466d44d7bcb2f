// Mamba2 SSD (state-space dual) chunked scan, for sm_90a: the
// chunk-parallel form.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/ssd_scan.py
// (ssd_scan, _ssd_kernel).  Every Mamba2 layer's prefill on the port's
// path runs it once.
//
//   xc [B,nc,Q,H,P], Bc/Cc [B,nc,Q,N] (f32 or bf16, all alike),
//   dtc [B,nc,Q,H] f32 (> 0), A [H] f32 (< 0), init [B,H,P,N] f32
//   ->  y [B,nc,Q,H,P] in xc's type, final [B,H,P,N] f32
//
// Per (b, h) and chunk c, with the state S [P,N] entering the chunk:
//   cum   = cumsum(dt * A)                                   [Q]
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) (C_i . S^T)
//   S'    = S exp(cum_{Q-1}) + sum_t x_t dt_t exp(cum_{Q-1} - cum_t) B_t^T
//
// Bound: operations.  At the Mamba2-2.7B prefill shape (B=4, nc=8, Q=256,
// H=80, P=64, N=128, f32) the scan moves ~0.37 GB (0.11 ms at 3.35 TB/s)
// but needs ~32.5 GFLOP (C.B once per (b, chunk), the causal half of
// scores @ x, the state in and out): 0.4854 ms of f32 FMA outside the
// tensor cores at 67 TFLOP/s.
//
// Design (arXiv:2405.21060's chunked algorithm).  Only the state is carried
// from chunk to chunk, and carrying it is elementwise; everything quadratic
// runs in parallel over (b, chunk, head).  Five kernels on the caller's
// stream, with counts at the path shape:
//
//   cum    one warp per (b, c, h), 320 CTAs of 8 warps: cum = cumsum(dt*A)
//          and dt, as [B,nc,H,2,Q] f32 scratch (5.2 MB), so that the
//          later phases read them contiguously.
//   cb     C_i . B_j once per (b, chunk), for the 64x64 tiles j <= i only:
//          320 CTAs of 128 threads into [B,nc,Q,Q] f32 scratch (8.4 MB,
//          L2-resident).  Before, every head recomputed it: 43 % of the
//          FMAs, done 80 times over.
//   state  each chunk's own contribution to the state, one CTA per
//          (b, chunk, head), 2,560 CTAs of 128 threads:
//          local = sum_t (x_t dt_t exp(cum_end - cum_t)) B_t^T, stored
//          transposed [N][P] into [B,nc,H,N,P] f32 scratch (84 MB).
//   pass   the one sequential part, elementwise: per (b, h) and state
//          element, for c in order, store the state entering chunk c over
//          local_c (read first) and set S = S exp(cum_end_c) + local_c;
//          then write final.  2,560 CTAs of 256 threads, 16 rows of N each;
//          init and final are transposed through shared memory.
//   scan   each chunk's output, one CTA per (b, chunk, head, 64-row tile),
//          10,240 CTAs of 64 threads: exp(cum_i) (C_i . S_prev^T), then
//          scores (CB_ij exp(cum_i - cum_j) dt_j, j <= i) @ x over the
//          columns j < i0 + 64 only, in stages of 32; heaviest tiles first.
//
// Against the one-CTA-per-(b, h) kernel this replaces: C.B no longer per
// head; 2,560-10,240 CTAs instead of 320 (3 waves of one 134 KB CTA per
// SM); shared memory 37 KB (scan), 50 KB (state) and 70 KB (cb) per CTA,
// 3 to 6 CTAs per SM; every product is an outer product over a register
// tile of 8x8 (state, scan) or 4x8 (cb) per thread, read with float4
// shared loads (16 FMAs per load in state and scan, 10.7 in cb); tiles
// move global -> shared as 16-byte cp.async into two buffers, so the next
// tile loads while this one computes; load loops index with shifts by
// compile-time widths, no integer division.  A tile falls back to scalar
// loads (bf16, converted to f32 on the way, or a width or base that is not
// 16-byte aligned).
//
// Numerics as before: f32 fmaf with IEEE expf, no fast math, no TF32, and
// each sum in the same order (n, then j, then t ascending).  The causal
// mask is applied before the exp: above the diagonal cum_i - cum_j is a
// positive sum of dt*|A|, whose exp overflows once a chunk's sum passes
// ~88; the TPU kernel multiplies inf by its mask afterwards and gets NaN.
// Here the exponent is formed only for j <= i.  Padded rows (dt = 0) add
// nothing to the state.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kTile = 64;     // rows and columns of a score / output tile
constexpr int kMaxQ = 256;    // chunk length
constexpr int kMaxP = 64;     // head_dim: one output tile of columns
constexpr int kMaxN = 128;    // state_dim

constexpr int kCumWarps = 8;
constexpr int kCbThreads = 128;
constexpr int kStThreads = 128;
constexpr int kStRows = 32;   // t rows per state-phase tile
constexpr int kPassThreads = 256;
constexpr int kPassRows = 16; // rows of N per state-pass CTA
constexpr int kScRows = 8;     // rows of the output tile per scan thread
constexpr int kScThreads = kTile / kScRows * 8;
constexpr int kScK = 32;       // steps of the sum per scan stage
constexpr int kPadLd = kTile + 4;   // A-operand row stride: rows 4 banks apart

constexpr size_t kCbSmem = sizeof(float) * 2 * 2 * kTile * kPadLd;
constexpr size_t kStSmem =
    sizeof(float) * (2 * kStRows * (kMaxN + kMaxP) + kMaxQ);
constexpr size_t kScSmem =
    sizeof(float) * (2 * kTile * (kScK + 4) + 2 * kScK * kTile + 2 * kMaxQ);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v >> 1);
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A [ROWS][COLS] f32 tile into s (row stride LDS) from g (row stride ldg
// elements); rows >= nrows and columns >= ncols read as 0.  With vec
// (f32, ncols and ldg multiples of 4, g 16-byte aligned) as 16-byte
// cp.async, zero-filled past the edge; else scalar loads converted to f32.
// Either way the tile is complete after cp_async_wait and a barrier.
template <int ROWS, int COLS, int LDS, int NT, typename T>
__device__ __forceinline__ void load_tile(float* s, const T* g, long ldg,
                                          int nrows, int ncols, bool vec) {
  static_assert((COLS & (COLS - 1)) == 0 && COLS >= 4, "COLS: power of 2");
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      constexpr int C4 = COLS / 4, L4 = log2i(C4);
      static_assert((ROWS * C4) % NT == 0, "whole chunks per thread");
#pragma unroll
      for (int k = 0; k < ROWS * C4 / NT; ++k) {
        const int e = threadIdx.x + k * NT;
        const int r = e >> L4, c = (e & (C4 - 1)) << 2;
        const bool ok = r < nrows && c < ncols;
        cp_async16(s + r * LDS + c, ok ? g + r * ldg + c : g, ok ? 16 : 0);
      }
      return;
    }
  }
  constexpr int LC = log2i(COLS);
  static_assert((ROWS * COLS) % NT == 0, "whole elements per thread");
#pragma unroll 4
  for (int k = 0; k < ROWS * COLS / NT; ++k) {
    const int e = threadIdx.x + k * NT;
    const int r = e >> LC, c = e & (COLS - 1);
    s[r * LDS + c] = r < nrows && c < ncols ? to_f32(g[r * ldg + c]) : 0.0f;
  }
}

__device__ __forceinline__ void fma4(float (&acc)[8], float a, float4 b0,
                                     float4 b1) {
  acc[0] = fmaf(a, b0.x, acc[0]);
  acc[1] = fmaf(a, b0.y, acc[1]);
  acc[2] = fmaf(a, b0.z, acc[2]);
  acc[3] = fmaf(a, b0.w, acc[3]);
  acc[4] = fmaf(a, b1.x, acc[4]);
  acc[5] = fmaf(a, b1.y, acc[5]);
  acc[6] = fmaf(a, b1.z, acc[6]);
  acc[7] = fmaf(a, b1.w, acc[7]);
}

__device__ __forceinline__ float comp(float4 v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// -- cum: one warp per (chunk, h) ------------------------------------------
// Each lane sums its run of ceil(Q/32) consecutive dt*A, a warp scan
// offsets the runs.  cs[(chunk*H + h)][0][q] = cum, [1][q] = dt.
__global__ void __launch_bounds__(kCumWarps * 32)
cum_kernel(const float* __restrict__ dt, const float* __restrict__ A,
           float* __restrict__ cs, int n_chunks, int Q, int H) {
  const int w = blockIdx.x * kCumWarps + (threadIdx.x >> 5);
  if (w >= n_chunks * H) return;
  const int chunk = w / H, h = w - chunk * H;
  const int lane = threadIdx.x & 31;
  const float a = A[h];
  const float* dg = dt + (size_t)chunk * Q * H + h;
  float* cum = cs + (size_t)w * 2 * Q;
  float* dts = cum + Q;
  const int per = (Q + 31) / 32, q0 = lane * per;
  float part[kMaxQ / 32];
  float run = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxQ / 32; ++k) {
    const int q = q0 + k;
    if (k < per && q < Q) {
      const float d = dg[(size_t)q * H];
      dts[q] = d;
      run += d * a;
      part[k] = run;
    }
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const float offset = incl - run;
#pragma unroll
  for (int k = 0; k < kMaxQ / 32; ++k) {
    const int q = q0 + k;
    if (k < per && q < Q) cum[q] = part[k] + offset;
  }
}

// -- cb: C_i . B_j per (chunk, tile pair j <= i) ---------------------------
// Thread (ty, tx) of 16 x 8 owns rows i0 + ty + 16k (k < 4) and columns
// j0 + tx + 8m (m < 8); both operands are [row][n] tiles read as float4
// along n, rows kPadLd apart (8 threads of a phase hit 8 bank quads).
template <typename T>
__global__ void __launch_bounds__(kCbThreads)
cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
          float* __restrict__ cb, int ntri, int Q, int N, bool vec) {
  const int chunk = blockIdx.x / ntri;
  int tri = blockIdx.x - chunk * ntri, it = 0;
  while (tri > it) tri -= ++it;
  const int i0 = it * kTile, j0 = tri * kTile;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const T* cg = Cm + ((size_t)chunk * Q + i0) * N;
  const T* bg = Bm + ((size_t)chunk * Q + j0) * N;
  const int nk = (N + kTile - 1) / kTile;

  auto load = [&](int kt) {
    float* a = smem + (kt & 1) * 2 * kTile * kPadLd;
    load_tile<kTile, kTile, kPadLd, kCbThreads>(a, cg + kt * kTile, N, Q - i0,
                                                N - kt * kTile, vec);
    load_tile<kTile, kTile, kPadLd, kCbThreads>(a + kTile * kPadLd,
                                                bg + kt * kTile, N, Q - j0,
                                                N - kt * kTile, vec);
    cp_async_commit();
  };

  float acc[4][8];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int m = 0; m < 8; ++m) acc[k][m] = 0.0f;
  load(0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cs_ = smem + (kt & 1) * 2 * kTile * kPadLd;
    const float* bs_ = cs_ + kTile * kPadLd;
#pragma unroll 1
    for (int kk = 0; kk < kTile; kk += 4) {
      float4 c[4], b[8];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        c[k] = *reinterpret_cast<const float4*>(cs_ + (ty + 16 * k) * kPadLd +
                                                kk);
#pragma unroll
      for (int m = 0; m < 8; ++m)
        b[m] = *reinterpret_cast<const float4*>(bs_ + (tx + 8 * m) * kPadLd +
                                                kk);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int m = 0; m < 8; ++m)
            acc[k][m] = fmaf(comp(c[k], q), comp(b[m], q), acc[k][m]);
    }
    __syncthreads();   // this buffer is refilled two stages on
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = i0 + ty + 16 * k;
    if (i >= Q) continue;
    float* row = cb + ((size_t)chunk * Q + i) * Q;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int j = j0 + tx + 8 * m;
      if (j < Q) row[j] = acc[k][m];
    }
  }
}

// -- state: each chunk's own contribution, per (chunk, h) ------------------
// local[n][p] = sum_t B[t][n] (x[t][p] w_t), w_t = dt_t exp(cum_end - cum_t);
// each x tile is scaled by w in shared memory once it lands.  Thread
// (ty, tx) of 16 x 8 owns n = ty*4 + {0..3} and 64 + ty*4 + {0..3}, p =
// tx*4 + {0..3} and 32 + tx*4 + {0..3}: per t two float4 of B and two of
// x for 64 FMAs.
template <typename T>
__global__ void __launch_bounds__(kStThreads)
state_kernel(const T* __restrict__ x, const T* __restrict__ Bm,
             const float* __restrict__ cs, float* __restrict__ st, int Q,
             int H, int P, int N, bool vec_x, bool vec_b, bool vec_s) {
  const int bid = blockIdx.x;           // chunk * H + h
  const int chunk = bid / H, h = bid - chunk * H;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* w_s = smem + 2 * kStRows * (kMaxN + kMaxP);   // [kMaxQ]
  const float* cum = cs + (size_t)bid * 2 * Q;
  const float* dts = cum + Q;
  const float cum_end = cum[Q - 1];
  for (int t = tid; t < kMaxQ; t += kStThreads)
    w_s[t] = t < Q ? dts[t] * expf(cum_end - cum[t]) : 0.0f;

  const T* xg = x + (size_t)chunk * Q * H * P + (size_t)h * P;
  const T* bg = Bm + (size_t)chunk * Q * N;
  const long ldx = (long)H * P;
  const int nt = (Q + kStRows - 1) / kStRows;
  auto load = [&](int s) {
    float* b = smem + (s & 1) * kStRows * (kMaxN + kMaxP);
    const int t0 = s * kStRows;
    load_tile<kStRows, kMaxN, kMaxN, kStThreads>(b, bg + (size_t)t0 * N, N,
                                                 Q - t0, N, vec_b);
    load_tile<kStRows, kMaxP, kMaxP, kStThreads>(b + kStRows * kMaxN,
                                                 xg + t0 * ldx, ldx, Q - t0,
                                                 P, vec_x);
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int m = 0; m < 8; ++m) acc[k][m] = 0.0f;
  load(0);
  for (int s = 0; s < nt; ++s) {
    if (s + 1 < nt) {
      load(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* b_s = smem + (s & 1) * kStRows * (kMaxN + kMaxP);
    float* x_s = smem + (s & 1) * kStRows * (kMaxN + kMaxP) + kStRows * kMaxN;
    const float* w = w_s + s * kStRows;
#pragma unroll 4
    for (int k = 0; k < kStRows * kMaxP / kStThreads; ++k) {
      const int e = tid + k * kStThreads;
      x_s[e] *= w[e >> log2i(kMaxP)];
    }
    __syncthreads();
#pragma unroll 2
    for (int t = 0; t < kStRows; ++t) {
      const float* xr = x_s + t * kMaxP + tx * 4;
      const float* br = b_s + t * kMaxN + ty * 4;
      const float4 x0 = *reinterpret_cast<const float4*>(xr);
      const float4 x1 = *reinterpret_cast<const float4*>(xr + 32);
      const float4 b0 = *reinterpret_cast<const float4*>(br);
      const float4 b1 = *reinterpret_cast<const float4*>(br + 64);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        fma4(acc[k], comp(k < 4 ? b0 : b1, k & 3), x0, x1);
    }
    __syncthreads();
  }
  float* out = st + (size_t)bid * N * P;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int n = (k < 4 ? 0 : 64) + ty * 4 + (k & 3);
    if (n >= N) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = half * 32 + tx * 4;
      if (p >= P) continue;
      const float* v = &acc[k][half * 4];
      float* o = out + (size_t)n * P + p;
      if (vec_s) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (p + m < P) o[m] = v[m];
      }
    }
  }
}

// -- pass: the state carried over the chunks, elementwise ------------------
// CTA = (b, h, 16 rows of N); thread owns n = n0 + tid/16, p = 4 (tid%16)
// + {0..3}.  st[b,c,h] holds local_c in [N][P] and leaves holding the state
// entering chunk c, transposed the same way; the next chunk's local is
// loaded before this one's state is stored.  init and final ([P][N]) pass
// through a shared tile, so that both are read and written along n.
__device__ __forceinline__ float4 ld4(const float* p, int np, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (np > 0) v.x = p[0];
  if (np > 1) v.y = p[1];
  if (np > 2) v.z = p[2];
  if (np > 3) v.w = p[3];
  return v;
}
__device__ __forceinline__ void st4(float* p, float4 v, int np, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  if (np > 0) p[0] = v.x;
  if (np > 1) p[1] = v.y;
  if (np > 2) p[2] = v.z;
  if (np > 3) p[3] = v.w;
}

__global__ void __launch_bounds__(kPassThreads)
pass_kernel(const float* __restrict__ init, const float* __restrict__ cs,
            float* __restrict__ st, float* __restrict__ fin, int nc, int Q,
            int H, int P, int N, int nsl, bool vec_s) {
  __shared__ float tile[kMaxP][kPassRows + 1];
  const int bh = blockIdx.x / nsl, sl = blockIdx.x - bh * nsl;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, n0 = sl * kPassRows;
  // [P][N] <-> tile: thread reads or writes p = tid/4, n0 + 4 (tid%4) + m
  const int tp = tid >> 2, tn = (tid & 3) * 4;
  const size_t base = (size_t)bh * P * N + (size_t)tp * N + n0;
#pragma unroll
  for (int m = 0; m < 4; ++m)
    tile[tp][tn + m] =
        tp < P && n0 + tn + m < N ? init[base + tn + m] : 0.0f;
  __syncthreads();

  const int nl = tid >> 4, n = n0 + nl, p0 = (tid & 15) * 4;
  const bool mine = n < N && p0 < P;
  const int np = P - p0 < 4 ? P - p0 : 4;
  float4 S = make_float4(tile[p0][nl], tile[p0 + 1][nl], tile[p0 + 2][nl],
                         tile[p0 + 3][nl]);
  const size_t bc = (size_t)b * nc;
  auto slot = [&](int c) {
    return st + (((bc + c) * H + h) * N + n) * P + p0;
  };
  auto decay = [&](int c) {
    return expf(cs[((bc + c) * H + h) * 2 * Q + Q - 1]);
  };
  if (mine) {
    float4 next = ld4(slot(0), np, vec_s);
    float dnext = decay(0);
    for (int c = 0; c < nc; ++c) {
      const float4 loc = next;
      const float d = dnext;
      if (c + 1 < nc) {
        next = ld4(slot(c + 1), np, vec_s);
        dnext = decay(c + 1);
      }
      st4(slot(c), S, np, vec_s);
      S.x = S.x * d + loc.x;
      S.y = S.y * d + loc.y;
      S.z = S.z * d + loc.z;
      S.w = S.w * d + loc.w;
    }
  }
  __syncthreads();
  tile[p0][nl] = S.x;
  tile[p0 + 1][nl] = S.y;
  tile[p0 + 2][nl] = S.z;
  tile[p0 + 3][nl] = S.w;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 4; ++m)
    if (tp < P && n0 + tn + m < N) fin[base + tn + m] = tile[tp][tn + m];
}

// -- scan: a 64-row tile of one chunk's output, per (chunk, h) -------------
// Stages of kScK steps of the sum: ceil(N/kScK) of the inter-chunk term
// (A = C[i][n], B = S_prev^T [n][p]), then those of the column tiles
// j0 <= i0 (A = CB[i][j] turned into scores in shared memory, B = x[j][p]).
// Thread (ty, tx) of (64/R) x 8 owns R = kScRows rows ty + (64/R) k, k < R,
// and columns tx*4 + {0..3} and 32 + tx*4 + {0..3}: per 4 steps of the
// sum, R float4 of A (one per row) and 8 of B for 32 R FMAs.  The minimum
// of one CTA per SM lets ptxas keep 168 registers (no spill); left to its
// default it caps them at 130 and the phase runs ~7 % slower on an H100.
template <typename T>
__global__ void __launch_bounds__(kScThreads, 1)
scan_kernel(const T* __restrict__ x, const T* __restrict__ Cm,
            const float* __restrict__ cb, const float* __restrict__ cs,
            const float* __restrict__ st, T* __restrict__ y, int Q, int H,
            int P, int N, int nt, bool vec_x, bool vec_c, bool vec_cb,
            bool vec_s, bool vec_y) {
  constexpr int LDA = kScK + 4, LK = log2i(kScK);
  const int rest = blockIdx.x / nt;
  const int it = nt - 1 - (blockIdx.x - rest * nt);   // heaviest first
  const int chunk = rest / H, h = rest - chunk * H;
  const int i0 = it * kTile;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* a_s = smem;                              // [2][kTile][LDA]
  float* b_s = a_s + 2 * kTile * LDA;             // [2][kScK][kTile]
  float* cum = b_s + 2 * kScK * kTile;            // [kMaxQ]
  float* dts = cum + kMaxQ;                       // [kMaxQ]
  const float* csg = cs + (size_t)rest * 2 * Q;
  for (int q = tid; q < kMaxQ; q += kScThreads) {
    cum[q] = q < Q ? csg[q] : 0.0f;
    dts[q] = q < Q ? csg[Q + q] : 0.0f;
  }

  const T* cg = Cm + ((size_t)chunk * Q + i0) * N;
  const float* sg = st + (size_t)rest * N * P;
  const float* cbg = cb + ((size_t)chunk * Q + i0) * Q;
  const T* xg = x + (size_t)chunk * Q * H * P + (size_t)h * P;
  const long ldx = (long)H * P;
  const int ninter = (N + kScK - 1) / kScK;
  const int ns = ninter + (i0 + kTile) / kScK;
  auto load = [&](int s) {
    float* a = a_s + (s & 1) * kTile * LDA;
    float* b = b_s + (s & 1) * kScK * kTile;
    if (s < ninter) {
      const int n0 = s * kScK;
      load_tile<kTile, kScK, LDA, kScThreads>(a, cg + n0, N, Q - i0, N - n0,
                                              vec_c);
      load_tile<kScK, kTile, kTile, kScThreads>(b, sg + (size_t)n0 * P, P,
                                                N - n0, P, vec_s);
    } else {
      const int j0 = (s - ninter) * kScK;
      load_tile<kTile, kScK, LDA, kScThreads>(a, cbg + j0, Q, Q - i0, Q - j0,
                                              vec_cb);
      load_tile<kScK, kTile, kTile, kScThreads>(b, xg + j0 * ldx, ldx,
                                                Q - j0, P, vec_x);
    }
    cp_async_commit();
  };

  constexpr int TY = kTile / kScRows;
  float acc[kScRows][8];
#pragma unroll
  for (int k = 0; k < kScRows; ++k)
#pragma unroll
    for (int m = 0; m < 8; ++m) acc[k][m] = 0.0f;
  load(0);
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) {
      load(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* a = a_s + (s & 1) * kTile * LDA;
    const float* b = b_s + (s & 1) * kScK * kTile;
    if (s >= ninter) {
      // scores = CB_ij exp(cum_i - cum_j) dt_j on and below the diagonal,
      // 4 columns at a time
      const int j0 = (s - ninter) * kScK;
#pragma unroll 2
      for (int k = 0; k < kTile * kScK / 4 / kScThreads; ++k) {
        const int e = tid + k * kScThreads;
        const int r = e >> (LK - 2), c = (e & (kScK / 4 - 1)) << 2;
        const int i = i0 + r, j = j0 + c;
        float4* v = reinterpret_cast<float4*>(a + r * LDA + c);
        const float4 cj = *reinterpret_cast<const float4*>(cum + j);
        const float4 dj = *reinterpret_cast<const float4*>(dts + j);
        const float ci = cum[i];
        const bool row = i < Q;
        float4 o = *v;
        o.x = row && j <= i ? o.x * expf(ci - cj.x) * dj.x : 0.0f;
        o.y = row && j + 1 <= i ? o.y * expf(ci - cj.y) * dj.y : 0.0f;
        o.z = row && j + 2 <= i ? o.z * expf(ci - cj.z) * dj.z : 0.0f;
        o.w = row && j + 3 <= i ? o.w * expf(ci - cj.w) * dj.w : 0.0f;
        *v = o;
      }
      __syncthreads();
    }
#pragma unroll 2
    for (int kk = 0; kk < kScK; kk += 4) {
      float4 av[kScRows];
#pragma unroll
      for (int k = 0; k < kScRows; ++k)
        av[k] = *reinterpret_cast<const float4*>(a + (ty + TY * k) * LDA + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* brow = b + (kk + q) * kTile + tx * 4;
        const float4 b0 = *reinterpret_cast<const float4*>(brow);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + 32);
#pragma unroll
        for (int k = 0; k < kScRows; ++k) fma4(acc[k], comp(av[k], q), b0, b1);
      }
    }
    if (s == ninter - 1) {
      // the inter-chunk term is complete: scale row i by exp(cum_i)
#pragma unroll
      for (int k = 0; k < kScRows; ++k) {
        const int i = i0 + ty + TY * k;
        const float e = i < Q ? expf(cum[i]) : 0.0f;
#pragma unroll
        for (int m = 0; m < 8; ++m) acc[k][m] *= e;
      }
    }
    __syncthreads();   // this buffer is refilled two stages on
  }

#pragma unroll
  for (int k = 0; k < kScRows; ++k) {
    const int i = i0 + ty + TY * k;
    if (i >= Q) continue;
    T* row = y + ((size_t)chunk * Q + i) * ldx + (size_t)h * P;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = half * 32 + tx * 4;
      const float* v = &acc[k][half * 4];
      if constexpr (std::is_same<T, float>::value) {
        if (vec_y && p < P) {
          *reinterpret_cast<float4*>(row + p) =
              make_float4(v[0], v[1], v[2], v[3]);
          continue;
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (p + m < P) store(row + p + m, v[m]);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch(const T* x, const float* dt, const float* A, const T* Bm,
           const T* Cm, const float* init, T* y, float* fin, float* cs,
           float* cb, float* st, int B, int nc, int Q, int H, int P, int N,
           cudaStream_t stream) {
  if (B <= 0 || nc <= 0 || Q <= 0 || Q > kMaxQ || H <= 0 || P <= 0 ||
      P > kMaxP || N <= 0 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = (Q + kTile - 1) / kTile;
  const int nsl = (N + kPassRows - 1) / kPassRows;
  const long long chunks = (long long)B * nc;
  if (chunks * H * nt > INT_MAX || chunks * H > INT_MAX / 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = static_cast<int>(chunks);
  constexpr bool f32 = std::is_same<T, float>::value;
  const bool vec_x = f32 && P % 4 == 0 && aligned16(x);
  const bool vec_bc = f32 && N % 4 == 0 && aligned16(Bm) && aligned16(Cm);
  const bool vec_cb = Q % 4 == 0 && aligned16(cb);
  const bool vec_s = P % 4 == 0 && aligned16(st);
  const bool vec_y = f32 && P % 4 == 0 && aligned16(y);
  cudaError_t e;
  if ((e = allow_smem(cb_kernel<T>, kCbSmem)) != cudaSuccess ||
      (e = allow_smem(state_kernel<T>, kStSmem)) != cudaSuccess ||
      (e = allow_smem(scan_kernel<T>, kScSmem)) != cudaSuccess)
    return static_cast<int>(e);

  const int warps = n_chunks * H;
  cum_kernel<<<(warps + kCumWarps - 1) / kCumWarps, kCumWarps * 32, 0,
               stream>>>(dt, A, cs, n_chunks, Q, H);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int ntri = nt * (nt + 1) / 2;
  cb_kernel<T><<<n_chunks * ntri, kCbThreads, kCbSmem, stream>>>(
      Bm, Cm, cb, ntri, Q, N, vec_bc);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  state_kernel<T><<<n_chunks * H, kStThreads, kStSmem, stream>>>(
      x, Bm, cs, st, Q, H, P, N, vec_x, vec_bc, vec_s);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  pass_kernel<<<B * H * nsl, kPassThreads, 0, stream>>>(
      init, cs, st, fin, nc, Q, H, P, N, nsl, vec_s);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  scan_kernel<T><<<n_chunks * H * nt, kScThreads, kScSmem, stream>>>(
      x, Cm, cb, cs, st, y, Q, H, P, N, nt, vec_x, vec_bc, vec_cb, vec_s,
      vec_y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  All pointers are device pointers
// of contiguous buffers: x/y [B,nc,Q,H,P], dt [B,nc,Q,H], A [H],
// Bm/Cm [B,nc,Q,N], init/fin [B,H,P,N]; scratch the caller allocates, f32:
// cs [B,nc,H,2,Q], cb [B,nc,Q,Q], st [B,nc,H,N,P].  Q <= 256, P <= 64,
// N <= 128.  Launches the five phases in order on `stream` and returns the
// first cudaGetLastError() that is not 0 (0 on success), or
// cudaErrorInvalidValue for shapes the kernels do not take; never
// synchronises.
extern "C" int ssd_scan_f32(const float* x, const float* dt, const float* A,
                            const float* Bm, const float* Cm,
                            const float* init, float* y, float* fin,
                            float* cs, float* cb, float* st, int B, int nc,
                            int Q, int H, int P, int N, void* stream) {
  return launch<float>(x, dt, A, Bm, Cm, init, y, fin, cs, cb, st, B, nc, Q,
                       H, P, N, static_cast<cudaStream_t>(stream));
}

extern "C" int ssd_scan_bf16(const void* x, const float* dt, const float* A,
                             const void* Bm, const void* Cm, const float* init,
                             void* y, float* fin, float* cs, float* cb,
                             float* st, int B, int nc, int Q, int H, int P,
                             int N, void* stream) {
  using bf = __nv_bfloat16;
  return launch<bf>(static_cast<const bf*>(x), dt, A,
                    static_cast<const bf*>(Bm), static_cast<const bf*>(Cm),
                    init, static_cast<bf*>(y), fin, cs, cb, st, B, nc, Q, H,
                    P, N, static_cast<cudaStream_t>(stream));
}
