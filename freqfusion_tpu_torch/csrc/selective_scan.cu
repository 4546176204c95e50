// Exact S6 selective scan over the chain layout, fp32 state.
//
// Replaces the Pallas kernels of freqfusion_tpu/ops/selective_scan.py:
// selective_scan_pallas_chain_fused (:1310), selective_scan_pallas_chain_proj
// (:1031) and selective_scan_pallas_chain (:771), which MambaIR's SS2D
// calls four times per layer (freqfusion_tpu/models/mambair.py:229-243).
// Tensors are [B, T, R, D]; the scanned sequence is chain 0, then chain 1,
// ... (position p = r * T + t, L = R * T), forward or reverse:
//     delta = softplus(dt + bias)
//     h_p   = exp(delta * A) h_{p-1} + delta * B_p * u_p      (fp32)
//     y_p   = sum_n C_p[n] h_p[n] + D * u_p
// reverse=True scans from the last position down and writes y in natural
// order, with no flipped copy.
//
// Two entry points share the scan: (a) the chain_fused / chain_proj
// contract, u = silu(xc) with dt/B/C projected from u in a hand-written
// kernel here, and (b) the chain contract with u, dt, B, C given.
//
// What bounds it on the H100: a serial walk over L = 336 * 512 = 172,032
// positions per (b, d) would use 360 threads of the card. The work is
// L * D * N exp + FMA steps (~1e9 per call at the main path's shape) and
// two reads of the [B, L, D] input; device memory is not the limit.
//
// Design: the TPU kernel's summary / compose / correct scheme moved onto
// blocks. The sequence is cut into 256-step chunks that run in parallel,
// one thread per (chunk, channel d) holding all N <= 16 states in
// registers. Pass 1 walks each chunk from a zero state and keeps its decay
// product P and end state H; a short pass composes the chunk carries
// serially per (b, d, n); pass 2 re-walks each chunk from its true initial
// state and writes y. Per-position rows shared by all channels (dt_low,
// B, C) are staged in shared memory once per chunk.
//
// Projections: the TPU kernel composes the two dt projections into one
// [D, D] weight (x_proj_w[:r]^T dt_proj_w^T) because the MXU favours one
// square matmul. On fp32 CUDA cores that costs 2 D^2 FLOPs per position
// instead of 2 * (dt_rank + 2N) * D + 2 * dt_rank * D, so here the
// projection kernel writes only x_dbl = u x_proj_w^T ([rows, dt_rank + 2N],
// 44 floats a position) and the scan expands dt = dt_low . dt_proj_w[d]
// (dt_rank FMAs) in registers; dt never reaches device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxState = 16;   // N (d_state)
constexpr int kMaxRank = 16;    // dt_rank
constexpr int kScanThreads = 128;
constexpr int kProjRows = 64, kProjCols = 32, kProjThreads = 256;
constexpr int kProjMaxK = 64;   // dt_rank + 2N
constexpr int kProjLd = kProjRows + 4;  // float4-aligned, fewer conflicts
static_assert(kProjRows == kProjMaxK && kProjThreads == 256,
              "projection tiles: 16 x 16 threads of 4 x 4 outputs");

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

struct ScanArgs {
  const float* x;       // u, or xc (pre-silu) when silu != 0; [B, T, R, D]
  const float* delta;   // dt [B, T, R, D], or null: dt = dt_low . dt_w[d]
  const float* dt_low;  // rows of ld_dbl floats, first dt_rank used
  const float* dt_w;    // [D, dt_rank]
  const float* Bm;      // rows of ld_bc floats, first N used
  const float* Cm;
  const float* A;       // [D, N], already negative
  const float* Dskip;   // [D]
  const float* bias;    // [D]
  float* y;             // [B, T, R, D]
  float* P;             // [B, nchunk, D, N] chunk decay products
  float* Hc;            // [B, nchunk, D, N] chunk end states, then inits
  int T, R, L, D, N, dt_rank, ld_dbl, ld_bc, chunk, nchunk, reverse, silu;
};

// Row of scan step s of batch b in the [B, T, R] flattening.
__device__ __forceinline__ long long row_of(const ScanArgs& a, int b, int s) {
  const int p = a.reverse ? a.L - 1 - s : s;
  const int r = p / a.T, t = p - r * a.T;
  return (long long)b * a.L + (long long)t * a.R + r;
}

template <bool kFinal>
__global__ void __launch_bounds__(kScanThreads)
scan_chunk_kernel(ScanArgs a) {
  extern __shared__ float staged[];
  const int c = blockIdx.x, b = blockIdx.z;
  const int d = blockIdx.y * blockDim.x + threadIdx.x;
  const int s0 = c * a.chunk;
  const int len = min(a.chunk, a.L - s0);
  const int nr = a.delta ? 0 : a.dt_rank;
  const int width = nr + 2 * a.N;

  for (int e = threadIdx.x; e < len * width; e += blockDim.x) {
    const int i = e / width, f = e - i * width;
    const long long row = row_of(a, b, s0 + i);
    float val;
    if (f < nr) val = a.dt_low[row * a.ld_dbl + f];
    else if (f < nr + a.N) val = a.Bm[row * a.ld_bc + (f - nr)];
    else val = a.Cm[row * a.ld_bc + (f - nr - a.N)];
    staged[e] = val;
  }
  __syncthreads();
  if (d >= a.D) return;

  // exp(delta A) = exp2(delta A log2(e)): one ex2 per state and step
  float A2[kMaxState], h[kMaxState], P[kMaxState], wdt[kMaxRank];
  const long long so = (((long long)b * a.nchunk + c) * a.D + d) * a.N;
#pragma unroll
  for (int n = 0; n < kMaxState; ++n) {
    A2[n] = n < a.N ? a.A[d * a.N + n] * 1.4426950408889634f : 0.f;
    h[n] = (kFinal && n < a.N) ? a.Hc[so + n] : 0.f;
    P[n] = 1.f;
  }
#pragma unroll
  for (int k = 0; k < kMaxRank; ++k) wdt[k] = k < nr ? a.dt_w[d * nr + k] : 0.f;
  const float bias = a.bias[d], dskip = a.Dskip[d];

  // (t, r) of the chunk's first position, then stepped without division
  const int p0 = a.reverse ? a.L - 1 - s0 : s0;
  int r = p0 / a.T, t = p0 - r * a.T;
  const long long brow = (long long)b * a.L;
  for (int i = 0; i < len; ++i) {
    const long long row = brow + (long long)t * a.R + r;
    if (a.reverse) {
      if (--t < 0) {
        t = a.T - 1;
        --r;
      }
    } else if (++t == a.T) {
      t = 0;
      ++r;
    }
    const float xv = a.x[row * a.D + d];
    const float u = a.silu ? silu(xv) : xv;
    const float* st = staged + i * width;
    float dt;
    if (nr) {
      dt = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxRank; ++k)
        if (k < nr) dt = fmaf(st[k], wdt[k], dt);
    } else {
      dt = a.delta[row * a.D + d];
    }
    dt = softplus(dt + bias);
    const float du = dt * u;
    const float* bs = st + nr;
    const float* cs = bs + a.N;
    float yv = 0.f;
#pragma unroll
    for (int n = 0; n < kMaxState; ++n) {
      if (n < a.N) {
        const float dA = exp2f(dt * A2[n]);
        h[n] = fmaf(dA, h[n], du * bs[n]);
        if (kFinal) yv = fmaf(cs[n], h[n], yv);
        else P[n] *= dA;
      }
    }
    if (kFinal) a.y[row * a.D + d] = yv + dskip * u;
  }
  if (!kFinal) {
#pragma unroll
    for (int n = 0; n < kMaxState; ++n) {
      if (n < a.N) {
        a.P[so + n] = P[n];
        a.Hc[so + n] = h[n];
      }
    }
  }
}

// Serial carry composition per (b, d, n): Hc[c] becomes chunk c's initial
// state, carry_{c+1} = P[c] carry_c + H[c].
__global__ void scan_compose_kernel(const float* __restrict__ P,
                                    float* __restrict__ Hc, int B, int nchunk,
                                    int DN) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * DN) return;
  const long long b = idx / DN, e = idx - b * DN;
  float carry = 0.f;
  for (int c = 0; c < nchunk; ++c) {
    const long long o = (b * nchunk + c) * DN + e;
    const float p = P[o], hl = Hc[o];
    Hc[o] = carry;
    carry = fmaf(p, carry, hl);
  }
}

// out[r, k] = sum_d silu(xc[r, d]) w[k, d], register-tiled: thread
// (ty, tx) of a 16 x 16 grid owns rows 4 ty .. 4 ty + 3 and columns
// 4 tx .. 4 tx + 3 of the block's 64-row x 64-column tile (K <= 64). Per
// d, one float4 of the transposed silu(xc) tile and one of the transposed
// weight tile feed 16 FMAs.
__global__ void __launch_bounds__(kProjThreads)
scan_project_kernel(const float* __restrict__ xc, const float* __restrict__ w,
                    float* __restrict__ out, long long rows, int D, int K) {
  __shared__ __align__(16) float xs[kProjCols][kProjLd];  // [d][row]
  __shared__ __align__(16) float wt[kProjCols][kProjLd];  // [d][k]
  const long long r0 = (long long)blockIdx.x * kProjRows;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += kProjCols) {
    __syncthreads();
    // i is a row of the silu(xc) tile and a column of the weight tile
    for (int e = tid; e < kProjRows * kProjCols; e += kProjThreads) {
      const int i = e / kProjCols, dd = e % kProjCols;
      const long long r = r0 + i;
      const int dcol = d0 + dd;
      xs[dd][i] = (r < rows && dcol < D) ? silu(xc[r * D + dcol]) : 0.f;
      wt[dd][i] = (i < K && dcol < D) ? w[(long long)i * D + dcol] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int dd = 0; dd < kProjCols; ++dd) {
      const float4 a4 = *reinterpret_cast<const float4*>(&xs[dd][4 * ty]);
      const float4 w4 = *reinterpret_cast<const float4*>(&wt[dd][4 * tx]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = r0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 4 * tx + j;
      if (r < rows && col < K) out[r * K + col] = acc[i][j];
    }
  }
}

// Sequence positions are 32-bit: L = T * R, padded to whole chunks.
bool fits_int(int T, int R, int chunk) {
  return (long long)T * R + chunk <= 0x7fffffffLL;
}

cudaError_t run_scan(ScanArgs a, int B, cudaStream_t stream) {
  const int width = (a.delta ? 0 : a.dt_rank) + 2 * a.N;
  const size_t smem = size_t(a.chunk) * width * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      scan_chunk_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(scan_chunk_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.nchunk, (a.D + kScanThreads - 1) / kScanThreads, B);
  scan_chunk_kernel<false><<<grid, kScanThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)B * a.D * a.N;
  scan_compose_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      a.P, a.Hc, B, a.nchunk, a.D * a.N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_chunk_kernel<true><<<grid, kScanThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// (a) chain_fused / chain_proj contract. xc [B, T, R, D] pre-silu;
// x_proj_w [dt_rank + 2N, D]; dt_proj_w [D, dt_rank]; A [D, N]; Dskip,
// bias [D]; x_dbl scratch [B * T * R, dt_rank + 2N]; P, Hc scratch
// [B, nchunk, D, N]; y [B, T, R, D]. All fp32 contiguous.
extern "C" int ff_selective_scan_proj(
    const float* xc, const float* x_proj_w, const float* dt_proj_w,
    const float* A, const float* Dskip, const float* bias, float* x_dbl,
    float* y, float* P, float* Hc, int B, int T, int R, int D, int N,
    int dt_rank, int reverse, int chunk, void* stream) {
  if (N > kMaxState || dt_rank > kMaxRank || dt_rank + 2 * N > kProjMaxK ||
      !fits_int(T, R, chunk))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K = dt_rank + 2 * N;
  const long long rows = (long long)B * T * R;
  scan_project_kernel<<<(unsigned)((rows + kProjRows - 1) / kProjRows),
                        kProjThreads, 0, s>>>(xc, x_proj_w, x_dbl, rows, D, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  ScanArgs a;
  a.x = xc; a.delta = nullptr; a.dt_low = x_dbl; a.dt_w = dt_proj_w;
  a.Bm = x_dbl + dt_rank; a.Cm = x_dbl + dt_rank + N;
  a.A = A; a.Dskip = Dskip; a.bias = bias; a.y = y; a.P = P; a.Hc = Hc;
  a.T = T; a.R = R; a.D = D; a.N = N; a.dt_rank = dt_rank;
  a.ld_dbl = K; a.ld_bc = K; a.chunk = chunk;
  a.L = T * R;
  a.nchunk = (a.L + chunk - 1) / chunk;
  a.reverse = reverse; a.silu = 1;
  return int(run_scan(a, B, s));
}

// (b) chain contract. u, delta [B, T, R, D]; Bm, Cm [B, T, R, N]; the rest
// as in (a).
extern "C" int ff_selective_scan(const float* u, const float* delta,
                                 const float* A, const float* Bm,
                                 const float* Cm, const float* Dskip,
                                 const float* bias, float* y, float* P,
                                 float* Hc, int B, int T, int R, int D, int N,
                                 int reverse, int chunk, void* stream) {
  if (N > kMaxState || !fits_int(T, R, chunk))
    return int(cudaErrorInvalidValue);
  ScanArgs a;
  a.x = u; a.delta = delta; a.dt_low = nullptr; a.dt_w = nullptr;
  a.Bm = Bm; a.Cm = Cm; a.A = A; a.Dskip = Dskip; a.bias = bias;
  a.y = y; a.P = P; a.Hc = Hc;
  a.T = T; a.R = R; a.D = D; a.N = N; a.dt_rank = 0;
  a.ld_dbl = 0; a.ld_bc = N; a.chunk = chunk;
  a.L = T * R;
  a.nchunk = (a.L + chunk - 1) / chunk;
  a.reverse = reverse; a.silu = 0;
  return int(run_scan(a, B, static_cast<cudaStream_t>(stream)));
}
