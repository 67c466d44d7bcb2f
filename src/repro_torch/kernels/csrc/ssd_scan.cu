// Mamba2 SSD (state-space dual) chunked scan, for sm_90a.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/ssd_scan.py
// (ssd_scan, _ssd_kernel).  Every Mamba2 layer's prefill on the port's
// path runs it once.
//
//   xc [B,nc,Q,H,P], Bc/Cc [B,nc,Q,N] (f32 or bf16, all alike),
//   dtc [B,nc,Q,H] f32 (> 0), A [H] f32 (< 0), init [B,H,P,N] f32
//   ->  y [B,nc,Q,H,P] in xc's type, final [B,H,P,N] f32
//
// Per (b, h), sequentially over chunks, with the state S [P,N] carried:
//   cum   = cumsum(dt * A)                                   [Q]
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) (C_i . S^T)
//   S     = S exp(cum_{Q-1}) + sum_t x_t dt_t exp(cum_{Q-1} - cum_t) B_t^T
//
// Mask before the exp.  Above the diagonal cum_i - cum_j is a positive
// sum of dt*|A|: once a chunk's sum passes ~88 its exp is inf, and the
// TPU kernel, which multiplies exp(cum_i - cum_j) by the causal mask
// afterwards, turns inf * 0 into NaN.  Here the exponent is only formed
// for j <= i, so no exponent is positive and nothing overflows.
//
// Bound: operations.  At the Mamba2-2.7B prefill shape (B=4, nc=8, Q=256,
// H=80, P=64, N=128, f32) the scan moves ~0.37 GB (x and y dominate) but
// does ~33 GFLOP for the causal half of the intra-chunk products and the
// state in/out products: 0.11 ms of bytes against ~0.49 ms of f32 FMA
// outside the tensor cores.
//
// Layout.  The TPU grid is (B, H, nc) with nc sequential and the state in
// VMEM scratch; on Hopper nothing carries over between blocks, so one CTA
// per (b, h) loops over the chunks and keeps S in shared memory.  A
// chunk's Q x Q score matrix (256 KB in f32) does not fit a block, so it
// is tiled by kTile = 64 rows: a row tile's y starts from the inter-chunk
// term and accumulates ((C_i B_j^T) o M_ij) x_j over the column tiles
// j <= i only (the tiles above the diagonal are all zero).  Every product
// is a scalar-FMA loop over shared-memory tiles with a 4x4 register tile
// per thread; C.B is recomputed per head (it depends on (b, chunk) only).
// Arithmetic is f32 with IEEE expf, no fast math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;     // rows (and columns) of a score tile
constexpr int kMaxQ = 256;    // chunk length
constexpr int kMaxP = 64;     // head_dim: one 4-column strip per thread
constexpr int kMaxN = 128;    // state_dim

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Odd row stride of the [rows][N] tiles: rows read by neighbouring
// threads land in different banks.
__host__ __device__ __forceinline__ int ld_n(int N) { return N | 1; }

size_t smem_bytes(int Q, int P, int N) {
  const size_t ldn = ld_n(N);
  return sizeof(float) *
         ((size_t)P * ldn               // state  [P][ldn]
          + 2 * (size_t)kTile * ldn     // C_i, B_j tiles [kTile][ldn]
          + (size_t)kTile * P           // x_j tile [kTile][P]
          + (size_t)kTile * (kTile + 1) // scores [kTile][kTile+1]
          + 2 * (size_t)Q + kTile);     // cum, dt [Q]; weights [kTile]
}

// rows [r0, r0+kTile) of a [Q][N] chunk -> s[kTile][ldn] as f32, rows
// past Q zero.
template <typename T>
__device__ void load_rows(float* s, const T* g, int r0, int Q, int N,
                          int ldn) {
  for (int i = threadIdx.x; i < kTile * N; i += kThreads) {
    const int r = i / N, n = i - r * N;
    s[r * ldn + n] = r0 + r < Q ? to_f32(g[(size_t)(r0 + r) * N + n]) : 0.0f;
  }
}

// rows [r0, r0+kTile) of x for head h: g points at x[b, c, 0, h, 0] and
// rows are H*P apart.
template <typename T>
__device__ void load_x(float* s, const T* g, int r0, int Q, int H, int P) {
  for (int i = threadIdx.x; i < kTile * P; i += kThreads) {
    const int r = i / P, p = i - r * P;
    s[r * P + p] =
        r0 + r < Q ? to_f32(g[(size_t)(r0 + r) * H * P + p]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ init,
           T* __restrict__ y, float* __restrict__ fin, int nc, int Q, int H,
           int P, int N) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;  // 16 x 16 threads, 4x4 each
  const int ldn = ld_n(N);
  extern __shared__ float smem[];
  float* st = smem;                       // [P][ldn]
  float* c_s = st + P * ldn;              // [kTile][ldn]
  float* b_s = c_s + kTile * ldn;         // [kTile][ldn]
  float* x_s = b_s + kTile * ldn;         // [kTile][P]
  float* s_s = x_s + kTile * P;           // [kTile][kTile+1]
  float* cum = s_s + kTile * (kTile + 1); // [Q]
  float* dts = cum + Q;                   // [Q]
  float* w_s = dts + Q;                   // [kTile]

  const float a = A[h];
  const float* s0 = init + ((size_t)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    st[p * ldn + n] = s0[i];
  }

  for (int c = 0; c < nc; ++c) {
    const size_t chunk = (size_t)b * nc + c;
    const T* xg = x + chunk * Q * H * P + (size_t)h * P;
    T* yg = y + chunk * Q * H * P + (size_t)h * P;
    const T* bg = Bm + chunk * Q * N;
    const T* cg = Cm + chunk * Q * N;
    const float* dg = dt + chunk * Q * H + h;

    // cum = inclusive prefix sum of dt*A: warp 0, kMaxQ/32 per lane
    if (tid < 32) {
      const int per = (Q + 31) / 32, q0 = tid * per;
      float run = 0.0f;
      for (int k = 0; k < per; ++k) {
        const int q = q0 + k;
        if (q < Q) {
          const float d = dg[(size_t)q * H];
          dts[q] = d;
          run += d * a;
          cum[q] = run;
        }
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      const float offset = incl - run;
      for (int k = 0; k < per; ++k) {
        const int q = q0 + k;
        if (q < Q) cum[q] += offset;
      }
    }
    __syncthreads();

    for (int i0 = 0; i0 < Q; i0 += kTile) {
      load_rows(c_s, cg, i0, Q, N, ldn);
      __syncthreads();
      // inter-chunk term: acc[r][p] = exp(cum_r) * sum_n C[r][n] S[p][n]
      float acc[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[k][m] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) cv[k] = c_s[(ty + 16 * k) * ldn + n];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int p = tx + 16 * m;
          sv[m] = p < P ? st[p * ldn + n] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int m = 0; m < 4; ++m) acc[k][m] = fmaf(cv[k], sv[m], acc[k][m]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = i0 + ty + 16 * k;
        const float e = r < Q ? expf(cum[r]) : 0.0f;
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[k][m] *= e;
      }

      // intra-chunk term over the column tiles j0 <= i0
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        load_rows(b_s, bg, j0, Q, N, ldn);
        load_x(x_s, xg, j0, Q, H, P);
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int m = 0; m < 4; ++m) sc[k][m] = 0.0f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) cv[k] = c_s[(ty + 16 * k) * ldn + n];
#pragma unroll
          for (int m = 0; m < 4; ++m) bv[m] = b_s[(tx + 16 * m) * ldn + n];
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int m = 0; m < 4; ++m) sc[k][m] = fmaf(cv[k], bv[m], sc[k][m]);
        }
        // M_ij = exp(cum_i - cum_j) dt_j on and below the diagonal only
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = ty + 16 * k, i = i0 + r;
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int s = tx + 16 * m, j = j0 + s;
            float v = 0.0f;
            if (i < Q && j <= i) v = sc[k][m] * expf(cum[i] - cum[j]) * dts[j];
            s_s[r * (kTile + 1) + s] = v;
          }
        }
        __syncthreads();
        // acc[r][p] += sum_s scores[r][s] x[s][p]
        for (int s = 0; s < kTile; ++s) {
          float sv[4], xv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) sv[k] = s_s[(ty + 16 * k) * (kTile + 1) + s];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int p = tx + 16 * m;
            xv[m] = p < P ? x_s[s * P + p] : 0.0f;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int m = 0; m < 4; ++m) acc[k][m] = fmaf(sv[k], xv[m], acc[k][m]);
        }
        __syncthreads();   // b_s, x_s, s_s are refilled by the next tile
      }

#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + ty + 16 * k;
        if (i >= Q) continue;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int p = tx + 16 * m;
          if (p < P) store(yg + (size_t)i * H * P + p, acc[k][m]);
        }
      }
      // c_s is refilled by the next row tile after its own barrier
    }

    // state update: S = S exp(cum_end) + sum_t (x_t dt_t exp(cum_end -
    // cum_t)) B_t^T.  Thread (ty, tx) owns S[ty + 16k][tx + 16m],
    // k < 4, m < 8.
    const float cum_end = cum[Q - 1];
    float upd[4][8];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int m = 0; m < 8; ++m) upd[k][m] = 0.0f;
    for (int t0 = 0; t0 < Q; t0 += kTile) {
      load_rows(b_s, bg, t0, Q, N, ldn);
      load_x(x_s, xg, t0, Q, H, P);
      if (tid < kTile) {
        const int t = t0 + tid;
        w_s[tid] = t < Q ? dts[t] * expf(cum_end - cum[t]) : 0.0f;
      }
      __syncthreads();
      for (int t = 0; t < kTile; ++t) {
        const float w = w_s[t];
        float xv[4], bv[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = ty + 16 * k;
          xv[k] = p < P ? x_s[t * P + p] * w : 0.0f;
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int n = tx + 16 * m;
          bv[m] = n < N ? b_s[t * ldn + n] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int m = 0; m < 8; ++m) upd[k][m] = fmaf(xv[k], bv[m], upd[k][m]);
      }
      __syncthreads();
    }
    const float decay = expf(cum_end);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = ty + 16 * k;
      if (p >= P) continue;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int n = tx + 16 * m;
        if (n < N) st[p * ldn + n] = st[p * ldn + n] * decay + upd[k][m];
      }
    }
    __syncthreads();   // the next chunk reads the new state and cum
  }

  float* f = fin + ((size_t)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    f[i] = st[p * ldn + n];
  }
}

template <typename T>
int launch(const T* x, const float* dt, const float* A, const T* Bm,
           const T* Cm, const float* init, T* y, float* fin, int B, int nc,
           int Q, int H, int P, int N, cudaStream_t stream) {
  if (B <= 0 || nc <= 0 || Q <= 0 || Q > kMaxQ || H <= 0 || P <= 0 ||
      P > kMaxP || N <= 0 || N > kMaxN || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(Q, P, N);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ssd_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      x, dt, A, Bm, Cm, init, y, fin, nc, Q, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  All pointers are device pointers
// of contiguous buffers: x/y [B,nc,Q,H,P], dt [B,nc,Q,H], A [H],
// Bm/Cm [B,nc,Q,N], init/fin [B,H,P,N].  Q <= 256, P <= 64, N <= 128.
// Launches one CTA per (h, b) on `stream` and returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for shapes the kernel does not
// take; never synchronises.
extern "C" int ssd_scan_f32(const float* x, const float* dt, const float* A,
                            const float* Bm, const float* Cm,
                            const float* init, float* y, float* fin, int B,
                            int nc, int Q, int H, int P, int N, void* stream) {
  return launch<float>(x, dt, A, Bm, Cm, init, y, fin, B, nc, Q, H, P, N,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int ssd_scan_bf16(const void* x, const float* dt, const float* A,
                             const void* Bm, const void* Cm, const float* init,
                             void* y, float* fin, int B, int nc, int Q, int H,
                             int P, int N, void* stream) {
  using bf = __nv_bfloat16;
  return launch<bf>(static_cast<const bf*>(x), dt, A,
                    static_cast<const bf*>(Bm), static_cast<const bf*>(Cm),
                    init, static_cast<bf*>(y), fin, B, nc, Q, H, P, N,
                    static_cast<cudaStream_t>(stream));
}
