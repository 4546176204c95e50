// Exact S6 selective scan, fp32 state, over any of the JAX scan kernels'
// layouts.
//
// Replaces the Pallas kernels of freqfusion_tpu/ops/selective_scan.py:
// selective_scan_pallas_chain_fused (:1310), selective_scan_pallas_chain_proj
// (:1031) and selective_scan_pallas_chain (:771), which MambaIR's SS2D
// calls four times per layer on its default and chainv5 routes
// (freqfusion_tpu/models/mambair.py:229-269); selective_scan_pallas_spatial
// (:550, the spatial route, :271-316); selective_scan_pallas_bidir (:439,
// the route for sides that are not multiples of 8, :317-343);
// selective_scan_pallas (:202) and selective_scan_pallas_dirs (:346).
// Per direction the recurrence is
//     delta = softplus(dt + bias)
//     h_p   = exp(delta * A) h_{p-1} + delta * B_p * u_p      (fp32)
//     y_p   = sum_n C_p[n] h_p[n] + D * u_p
// over positions p = r * T + t, L = R * T, each at row t * st + r * sr of
// its sequence: the chain layout [B, T, R, D] has st = R, sr = 1; the
// spatial layout [B, R, T, D] and the flat one [B, L, D] (R = 1) have
// st = 1, sr = T. A reverse direction scans from the last position down
// and writes y in natural order, with no flipped copy.
//
// One launch scans G parameter groups of Bt sequences each (sequence z =
// g * Bt + b): group g has its own A [D, N], D and bias, its own direction
// (bit g of rev_mask) and reads u group g % Gu, so SS2D's bidir route scans
// its four directions from two u tensors in one launch (Gu = 2, groups 2
// and 3 reversed) and the K-direction contract has Gu = G = K.
//
// Four entry points share the scan: (a) the chain_fused / chain_proj
// contract, u = silu(xc) with dt/B/C projected from u in a hand-written
// kernel here, (b) the explicit contract with u, dt, B, C given, in any of
// the layouts above, (c) the bf16 chain_proj contract (the bf16 expert
// mode), with the JAX kernel's bf16 rounding points: xc and y in bf16, u =
// silu(xc) rounded to bf16, dt/B/C from one product with the composed
// weight (rounded to bf16 once) on the bf16 tensor cores in fp32, then the
// bf16 passes, and (d) the explicit contract with a bf16 u, at the operand
// types the JAX routes hand #5 (dt, B, C and y bf16), #9 (dt, B and C
// bf16, y fp32) and #8 (dt, B, C and y fp32) in the bf16 expert mode.
// (a) and (b) run the fp32 passes (scan_pass_kernel), (c) and (d) the bf16
// passes (scan_pass16_kernel); all share the compose.
//
// What bounds it on the H100. Per (position, channel) a pass does N = 16
// exp2 (one per state); the SFU does 16 a clock per SM, so one pass over the
// main path's 172,032 x 360 positions-channels needs ~0.24 ms of MUFU time
// (chip_smoke.py's PEAK_SFU), and its FP32 work (4-5 instructions a state)
// about as much issue time. A pass also streams u in pieces a step apart
// by a whole chain row; pass 2 writes y as much. Cut into chunks scanned in
// parallel, the scan runs twice (summary, then correct), so ~0.5 ms a
// direction is the floor of this scheme.
//
// fp32 passes (contracts a, b):
//  - Items: a (sequence, chunk, 128-channel tile) triple; a block of 128
//    threads, one channel each, scans one item with all N <= 16 states in
//    registers. The grid is persistent: min(items, SMs x resident blocks),
//    each block walking items blockIdx.x, + gridDim.x, ...; the chunk length
//    is planned in Python (ops/selective_scan.py:plan_scan) so that the
//    items fill the resident slots once (one wave, no idle tail).
//  - An asynchronous ring: each item's inputs (x, and dt on the explicit
//    contract; the rows dt_low/B/C shared by the tile's channels) are
//    streamed by cp.async, 16 bytes a copy where rows are 16-byte aligned
//    (else 4), into kStages = 2 stages of kSub = 16 steps: one stage is in
//    flight while the other is scanned (a third stage measured no faster).
//    Rows are found by stepping (t, r), never by division. The recurrence
//    reads only shared memory and registers: no step waits on device
//    memory. A stage is scanned in two sweeps: first delta (and u) of its
//    16 steps, independent of each other, written back over dt (and x) in
//    the thread's own column; then the recurrence. Pass 2 leaves y in the
//    x column and the block stores the stage's y rows 16 bytes at a time.
//  - N and dt_rank are template parameters on the main path (16, 12), with
//    a generic instantiation (predicated, N and dt_rank <= 16) for other
//    shapes; B, C and dt_low come from shared memory as float4 broadcasts.
//  - Pass 1 keeps, per item and channel, the end state H from a zero state
//    and the sum of delta; the chunk's decay is exp2(A2 * sum) in closed
//    form (its rounding differs from the product's within the scan
//    tolerance). The compose is a parallel scan over chunks: per (sequence,
//    channel, state), 8 warps each fold a contiguous run of chunks, combine
//    their (decay, state) pairs through shared memory, and re-walk the run
//    writing each chunk's initial state. Pass 2 re-walks each item from its
//    initial state and writes y. x is read twice from device memory (pass
//    1 and pass 2): a chunk of one wave is ~800 steps x 512 bytes, too large
//    to stay resident.
//  - Projection (contract a): x_dbl = silu(xc) x_proj_w^T in a register-
//    tiled fp32 kernel whose 128 x 48 tile fits K = dt_rank + 2N <= 48, the
//    next slab of xc fetched into registers while one is multiplied; its
//    rows are written padded (dt_low at 0, B at R4, C at R4 + N4, each a
//    multiple of 4 floats) so the scan stages them with 16-byte copies. A
//    3xTF32 tensor-core version of it was within tolerance but slower on
//    the H100 (199 registers, 8 warps an SM). The TPU kernel
//    composes the two dt projections into one [D, D] weight because the
//    MXU favours one square matmul; on fp32 CUDA cores that costs 2 D^2
//    FLOPs per position instead of 2 (dt_rank + 2N) D, so the scan expands
//    dt = dt_low . dt_proj_w[d] (dt_rank FMAs) in registers. No TF32: the
//    arithmetic is fp32 throughout.
//
// bf16 passes (contracts c, d; scan_pass16_kernel), the same items, plan
// and compose, built the way Hopper feeds a loop:
//  - A producer warp beside the 128 consumer threads issues every copy: one
//    cp.async.bulk per staged row piece (the tile's u and dt pieces, the B
//    and C rows), each completing on its stage's mbarrier (expect_tx). It
//    steps (t, r) itself (reverse scans and chain wraps are its address
//    arithmetic) and leaves each step's row in the stage for pass 2's
//    stores. Consumers wait on a stage's parity and release it with one
//    arrival each on its "empty" barrier: no block barrier in the loop.
//    Rows that are not 16-byte pieces (D % 8, or N's row bytes % 16) are
//    copied element by element by the producer warp, which then arrives.
//  - Stages hold u and dt as given (bf16 or fp32); each consumer widens
//    its own channel's values as it reads them (one integer op). bf16 B
//    and C, which every channel reads, are widened once a stage by the
//    producer warp, a stage behind its copies (widened by each consumer
//    they cost ~32 instructions a step and made pass 2 issue-bound on the
//    H100). kRing16 = 3 stages of kSub = 16 steps, four blocks an SM
//    (three blocks with four stages measured slower).
//  - Pass 1 has issue slots to spare beside the SFU, so it takes kEmu1 = 2
//    of each step's 16 exponentials on the FMA pipe (ex2_fma; 3 or 4
//    measured slower); pass 2 does not.
//  - Softplus takes log1p(z), z = exp(-|x|) in (0, 1], as z q(z) with q a
//    degree-8 polynomial (FMAs only, relative error 2.4e-7 in fp32): one
//    MUFU op (the ex2), no reciprocal.
//  - Contract c's projection (scan_project_wgmma_kernel) writes u =
//    bf16(silu(xc)) and delta = softplus(dt + bias) itself, with B and C
//    in fp32; its passes read u and delta (kDelta) and run neither silu
//    nor softplus: 16 MUFU ops a step. It runs on wgmma: a block is 64
//    rows x all D + 2N columns, in chunks of 104 (one m64n104k16 per 16 of
//    K; 52 accumulators a thread, three blocks an SM); the consumer
//    warpgroup stages bf16(silu(xc)) once into shared
//    memory in the core-matrix order (K padded to 16 with zeros), and a
//    producer warp streams the composed weight, laid out once per weight
//    in that order (ops/selective_scan.py:weight_layout), one bulk copy a
//    k16 slice through an 8-stage ring. Each y is stored by its thread,
//    rounded to bf16 once where y is bf16.
// The Pallas kernels' tiling knobs (chunk, inner, the padding of L and of D
// to lane multiples, the approximate per-chain init) do not carry over: the
// scan is exact for any D and L.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kMaxState = 16;   // N (d_state)
constexpr int kMaxRank = 16;    // dt_rank
constexpr int kTile = 128;      // channels an item covers, one a thread
constexpr int kThreads = kTile;
constexpr int kSub = 16;        // steps a ring stage holds
constexpr int kStages = 2;      // ring depth: one stage in flight
constexpr int kComposeWarps = 8;
// projection tile: 128 rows x 48 columns, 8 x 4 outputs a thread, the
// reduction over D in slabs of 24 (360 = 15 x 24)
constexpr int kProjRows = 128, kProjCols = 48, kProjSlab = 24;
constexpr int kProjThreads = (kProjRows / 8) * (kProjCols / 4);  // 192
constexpr int kProjX4 = kProjRows * kProjSlab / 4 / kProjThreads;  // 4
constexpr int kProjW = kProjCols * kProjSlab / kProjThreads;       // 6
static_assert(kProjRows * kProjSlab % (4 * kProjThreads) == 0 &&
                  kProjCols * kProjSlab % kProjThreads == 0,
              "projection slabs split evenly over the threads");

__device__ __forceinline__ float silu(float x) {
  return __fdividef(x, 1.f + ex2(-kLog2e * x));
}

// max(x, 0) + log1p(exp(-|x|)), log1p(z) = 2 atanh(q), q = z / (2 + z) <=
// 1/3, by 7 terms of the series (the next is below 2e-8 relative): within
// 2e-6 of F.softplus, in 13 instructions where log1pf takes ~30
__device__ __forceinline__ float softplus(float x) {
  const float z = ex2(-kLog2e * fabsf(x));
  const float q = __fdividef(z, 2.f + z), w = q * q;
  float p = 1.f / 13.f;
  p = fmaf(p, w, 1.f / 11.f);
  p = fmaf(p, w, 1.f / 9.f);
  p = fmaf(p, w, 1.f / 7.f);
  p = fmaf(p, w, 1.f / 5.f);
  p = fmaf(p, w, 1.f / 3.f);
  p = fmaf(p, w, 1.f);
  return fmaxf(x, 0.f) + 2.f * q * p;
}

// The bf16 passes' and the wgmma projection's softplus: log1p(z), z =
// exp(-|x|) in (0, 1], as z q(z) with q the degree-8 polynomial fitted to
// log1p(z) / z on [0, 1] (relative error 2.4e-7 evaluated in fp32), so
// small softplus values keep their relative accuracy: one MUFU op (the
// ex2) and FMAs, no reciprocal.
__device__ __forceinline__ float softplus_fma(float x) {
  const float z = ex2(-kLog2e * fabsf(x));
  float q = 0.005382914076738562f;
  q = fmaf(q, z, -0.03010528584659679f);
  q = fmaf(q, z, 0.07919948829378638f);
  q = fmaf(q, z, -0.13745466834194392f);
  q = fmaf(q, z, 0.19144455498284113f);
  q = fmaf(q, z, -0.24852736201590955f);
  q = fmaf(q, z, 0.33320309299174f);
  q = fmaf(q, z, -0.4999955017772436f);
  q = fmaf(q, z, 0.999999974076889f);
  return fmaxf(x, 0.f) + z * q;
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

struct ScanArgs {
  const float* x;      // u, or xc (pre-silu) on the projection contract
  const __nv_bfloat16* xh;  // bf16 u (bf16 passes)
  // bf16 passes: dt (or delta, kDelta), B and C in bf16 (kD16) or fp32,
  // and y in bf16 (kY16) or fp32
  const void* dv;
  const void* Bv;
  const void* Cv;
  void* yv;
  const float* delta;  // dt (explicit contract)
  const float* dbl;    // padded x_dbl rows of W floats (projection contract)
  const float* Bm;     // [rows, N] (explicit contract)
  const float* Cm;
  const float* dt_w;   // [D, dt_rank]
  const float* A;      // [G, D, N], already negative
  const float* Dskip;  // [G, D]
  const float* bias;   // [G, D]
  float* y;            // [G, Bt, L, D] in the layout of x
  float* Sdt;          // [G * Bt, nchunk, D] sum of delta over each chunk
  float* Hc;           // [G * Bt, nchunk, D, N] chunk end states, then inits
  int Bt, Gu;          // sequences per group; x holds Gu groups of Bt
  int T, R, L, st, sr; // position r * T + t lies at row t * st + r * sr
  int D, N, dt_rank;
  int W, R4;           // floats a staged row holds; offset of B in it
  int chunk, nchunk, tiles, items, rev_mask;
  int vec_x, vec_bc;   // x (and dt), B and C rows 16-byte aligned; bf16
                       // passes: every staged piece a bulk copy (vec_x)
  int vec_y;           // y rows 16-byte aligned
};

// Move (t, r), a position of the scan, i >= 0 steps on in scan order (a
// chain shorter than i wraps more than once).
__device__ __forceinline__ void step_by(const ScanArgs& a, int& t, int& r,
                                        int i, bool rev) {
  if (rev) {
    t -= i;
    while (t < 0) {
      t += a.T;
      --r;
    }
  } else {
    t += i;
    while (t >= a.T) {
      t -= a.T;
      ++r;
    }
  }
}

// Row, within its sequence, of the position i steps after (t, r).
__device__ __forceinline__ int row_after(const ScanArgs& a, int t, int r,
                                         int i, bool rev) {
  step_by(a, t, r, i, rev);
  return t * a.st + r * a.sr;
}

// Floats of a staged per-position row: compile-time on the main path.
template <bool kProj, int kN, int kR>
__device__ __forceinline__ int staged_width(const ScanArgs& a) {
  if (kN && (kR || !kProj))
    return (kProj ? (kR + 3) & ~3 : 0) + 2 * ((kN + 3) & ~3);
  return a.W;
}

// Floats of one ring stage of the fp32 passes: kSub steps of the tile's x
// (then u, then y), of its dt (then delta) and of the per-position row.
__host__ __device__ __forceinline__ int stage_floats(int W) {
  return kSub * (2 * kTile + W);
}

// Issue the copies of cnt steps of an item into a stage, the first at
// position (t, r). Copies are spread over the threads; none divides.
template <bool kProj, int kN, int kR>
__device__ __forceinline__ void stage_in(const ScanArgs& a, float* stage,
                                         int t, int r, int cnt, bool rev,
                                         long long brow, long long xrow,
                                         int d0) {
  const int tid = threadIdx.x;
  const int W = staged_width<kProj, kN, kR>(a);
  float* xs = stage;
  float* ds = stage + kSub * kTile;
  float* rs = stage + 2 * kSub * kTile;
  const int dl = min(kTile, a.D - d0);
  if (a.vec_x) {  // 4 channels a copy
    const int q = tid & 31;  // float4 column of the tile
    if (4 * q < dl) {
      for (int i = tid >> 5; i < cnt; i += kThreads / 32) {
        const long long row = row_after(a, t, r, i, rev);
        cp16(xs + i * kTile + 4 * q, a.x + (xrow + row) * a.D + d0 + 4 * q);
        if (!kProj)
          cp16(ds + i * kTile + 4 * q,
               a.delta + (brow + row) * a.D + d0 + 4 * q);
      }
    }
  } else if (tid < dl) {
    for (int i = 0; i < cnt; ++i) {
      const long long row = row_after(a, t, r, i, rev);
      cp4(xs + i * kTile + tid, a.x + (xrow + row) * a.D + d0 + tid);
      if (!kProj)
        cp4(ds + i * kTile + tid, a.delta + (brow + row) * a.D + d0 + tid);
    }
  }
  if (kProj) {
    const int w4 = W / 4;
    for (int e = tid; e < cnt * w4; e += kThreads) {
      const int i = e / w4, f = e - i * w4;
      const long long row = row_after(a, t, r, i, rev);
      cp16(rs + i * W + 4 * f, a.dbl + (brow + row) * W + 4 * f);
    }
  } else {
    const int N = kN ? kN : a.N, N4 = (N + 3) & ~3;
    if (a.vec_bc) {
      const int n4 = N / 4;
      for (int e = tid; e < cnt * 2 * n4; e += kThreads) {
        const int i = e / (2 * n4), f = e - i * 2 * n4;
        const int c = f >= n4, k = f - c * n4;
        const long long row = row_after(a, t, r, i, rev);
        cp16(rs + i * W + c * N4 + 4 * k,
             (c ? a.Cm : a.Bm) + (brow + row) * N + 4 * k);
      }
    } else {
      for (int e = tid; e < cnt * 2 * N; e += kThreads) {
        const int i = e / (2 * N), f = e - i * 2 * N;
        const int c = f >= N, k = f - c * N;
        const long long row = row_after(a, t, r, i, rev);
        cp4(rs + i * W + c * N4 + k,
            (c ? a.Cm : a.Bm) + (brow + row) * N + k);
      }
    }
  }
}

// Pass 1 (kFinal false): each item from a zero state; writes the chunk's
// sum of delta and end state. Pass 2 (kFinal true): each item from its
// initial state (Hc after the compose); writes y. kN / kR: N and dt_rank
// known at compile time (0: read from the arguments, <= 16).
// The generic instantiations are held to 4 blocks an SM (<= 128
// registers): left to itself ptxas gives them 80 and spills.
template <bool kProj, bool kFinal, int kN, int kR>
__global__ void __launch_bounds__(kThreads, kN ? 1 : 4)
scan_pass_kernel(const ScanArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int N = kN ? kN : a.N;
  const int N4 = (N + 3) & ~3;
  const int nr = kProj ? (kR ? kR : a.dt_rank) : 0;
  const int W = staged_width<kProj, kN, kR>(a);
  const int R4 = kR ? (kR + 3) & ~3 : a.R4;
  const int sfl = stage_floats(W);

  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int j = item % a.tiles, zc = item / a.tiles;
    const int c = zc % a.nchunk, z = zc / a.nchunk;
    const int g = z / a.Bt;
    const bool rev = (a.rev_mask >> g) & 1;
    const int d0 = j * kTile, d = d0 + tid;
    const int dl = min(kTile, a.D - d0);
    const bool live = tid < dl;
    const int dc = live ? d : a.D - 1;  // parameters of a channel in range
    const int s0 = c * a.chunk, len = min(a.chunk, a.L - s0);
    const int nsub = (len + kSub - 1) / kSub;
    // first row of this sequence in delta / dbl / B / C / y, and in x
    const long long brow = (long long)z * a.L;
    const long long xrow =
        ((long long)(g % a.Gu) * a.Bt + (z - g * a.Bt)) * a.L;

    // (t, r) of the item's first position: of the next stage to copy in,
    // and of the stage being scanned
    const int p0 = rev ? a.L - 1 - s0 : s0;
    int rn = p0 / a.T, tn = p0 - rn * a.T;
    int rc = rn, tc = tn;
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < nsub) {
        stage_in<kProj, kN, kR>(a, smem + k * sfl, tn, rn,
                                min(kSub, len - k * kSub), rev, brow, xrow,
                                d0);
        step_by(a, tn, rn, kSub, rev);
      }
      cp_commit();
    }

    // exp(delta A) = exp2(delta A log2(e)): one ex2 per state and step
    float A2[kMaxState], h[kMaxState], wdt[kMaxRank];
    const int gd = g * a.D + dc;
    const long long so = (((long long)z * a.nchunk + c) * a.D + dc) * N;
#pragma unroll
    for (int n = 0; n < kMaxState; ++n) {
      const bool on = kN ? n < kN : n < N;
      A2[n] = on ? a.A[(long long)gd * N + n] * kLog2e : 0.f;
      h[n] = (kFinal && on) ? a.Hc[so + n] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kMaxRank; ++k)
      wdt[k] = (kProj && k < nr) ? a.dt_w[(long long)dc * nr + k] : 0.f;
    const float bias = a.bias[gd], dskip = a.Dskip[gd];
    float sdt = 0.f;

    for (int k = 0; k < nsub; ++k) {
      __syncthreads();  // the stage refilled below was scanned at k - 1
      if (k + kStages - 1 < nsub) {
        stage_in<kProj, kN, kR>(
            a, smem + ((k + kStages - 1) % kStages) * sfl, tn, rn,
            min(kSub, len - (k + kStages - 1) * kSub), rev, brow, xrow, d0);
        step_by(a, tn, rn, kSub, rev);
      }
      cp_commit();
      cp_wait<kStages - 1>();  // stage k has landed (this thread's copies)
      __syncthreads();         // ... and every thread's
      float* stage = smem + (k % kStages) * sfl;
      float* xs = stage + tid;                 // x, then u
      float* ds = stage + kSub * kTile + tid;  // dt (explicit), then delta
      float* rs = stage + 2 * kSub * kTile;
      const int cnt = min(kSub, len - k * kSub);
      // delta and u of the stage's steps, independent of each other; each
      // thread rewrites its own column
#pragma unroll 4
      for (int i = 0; i < cnt; ++i) {
        float dt = 0.f;
        if (kProj) {
          const float* rw = rs + i * W;
          if (kR) {
#pragma unroll
            for (int k4 = 0; k4 < kR; k4 += 4) {
              const float4 v = *reinterpret_cast<const float4*>(rw + k4);
              dt = fmaf(v.x, wdt[k4], dt);
              dt = fmaf(v.y, wdt[k4 + 1], dt);
              dt = fmaf(v.z, wdt[k4 + 2], dt);
              dt = fmaf(v.w, wdt[k4 + 3], dt);
            }
          } else {
#pragma unroll
            for (int kk = 0; kk < kMaxRank; ++kk)
              if (kk < nr) dt = fmaf(rw[kk], wdt[kk], dt);
          }
          xs[i * kTile] = silu(xs[i * kTile]);
        } else {
          dt = ds[i * kTile];
        }
        dt = softplus(dt + bias);
        ds[i * kTile] = dt;
        sdt += dt;
      }
      // the recurrence: shared memory and registers only
#pragma unroll 2
      for (int i = 0; i < cnt; ++i) {
        const float dt = ds[i * kTile], u = xs[i * kTile];
        const float du = dt * u;
        const float* bs = rs + i * W + (kProj ? R4 : 0);
        const float* cs = bs + N4;
        float Bv[kMaxState], Cv[kMaxState];
        if (kN && kN % 4 == 0) {
#pragma unroll
          for (int n = 0; n < kN; n += 4) {
            const float4 b4 = *reinterpret_cast<const float4*>(bs + n);
            Bv[n] = b4.x; Bv[n + 1] = b4.y; Bv[n + 2] = b4.z; Bv[n + 3] = b4.w;
            if (kFinal) {
              const float4 c4 = *reinterpret_cast<const float4*>(cs + n);
              Cv[n] = c4.x; Cv[n + 1] = c4.y; Cv[n + 2] = c4.z;
              Cv[n + 3] = c4.w;
            }
          }
        } else {
#pragma unroll
          for (int n = 0; n < kMaxState; ++n) {
            Bv[n] = n < N ? bs[n] : 0.f;
            Cv[n] = (kFinal && n < N) ? cs[n] : 0.f;
          }
        }
        float y0 = 0.f, y1 = 0.f;  // even and odd states: shorter chains
#pragma unroll
        for (int n = 0; n < kMaxState; ++n) {
          if (kN ? n < kN : n < N) {
            h[n] = fmaf(ex2(dt * A2[n]), h[n], du * Bv[n]);
            if (kFinal) {
              if (n & 1) y1 = fmaf(Cv[n], h[n], y1);
              else y0 = fmaf(Cv[n], h[n], y0);
            }
          }
        }
        if (kFinal) xs[i * kTile] = (y0 + y1) + dskip * u;  // u is spent
      }
      if (kFinal) {
        // the stage's y rows, 16 bytes a store where they align
        __syncthreads();
        if (a.vec_y) {
          const int q = tid & 31;
          if (4 * q < dl) {
            for (int i = tid >> 5; i < cnt; i += kThreads / 32) {
              const long long row = row_after(a, tc, rc, i, rev);
              *reinterpret_cast<float4*>(a.y + (brow + row) * a.D + d0 +
                                         4 * q) =
                  *reinterpret_cast<const float4*>(stage + i * kTile + 4 * q);
            }
          }
        } else if (live) {
          for (int i = 0; i < cnt; ++i)
            a.y[(brow + row_after(a, tc, rc, i, rev)) * a.D + d] =
                xs[i * kTile];
        }
        step_by(a, tc, rc, kSub, rev);
      }
    }
    if (!kFinal && live) {
      a.Sdt[((long long)z * a.nchunk + c) * a.D + d] = sdt;
#pragma unroll
      for (int n = 0; n < kMaxState; ++n)
        if (kN ? n < kN : n < N) a.Hc[so + n] = h[n];
    }
    __syncthreads();  // the next item's prologue refills the ring
  }
}

// Chunk carries, composed in parallel over chunks. Block (32, 8) covers 32
// (channel, state) pairs e of one sequence (blockIdx.y); warp w folds the
// chunks of its run [c0, c1) into one (decay, state) pair, the pairs of
// the warps before it give its run's carry, and a second walk writes each
// chunk's initial state into Hc: carry_{c+1} = P_c carry_c + H_c with P_c
// = exp2(A2 * Sdt_c).
template <int kN>
__global__ void __launch_bounds__(32 * kComposeWarps)
scan_compose_kernel(const float* __restrict__ A, const float* __restrict__ Sdt,
                    float* __restrict__ Hc, int Bt, int nchunk, int D,
                    int n_) {
  __shared__ float sp[kComposeWarps][32], sh[kComposeWarps][32];
  const int N = kN ? kN : n_;
  const int lane = threadIdx.x, w = threadIdx.y;
  const int DN = D * N;
  const int e = blockIdx.x * 32 + lane;
  const int z = blockIdx.y, g = z / Bt;
  const bool live = e < DN;
  const int ec = live ? e : DN - 1;
  const float a2 = A[(long long)g * DN + ec] * kLog2e;
  const int per = (nchunk + kComposeWarps - 1) / kComposeWarps;
  const int c0 = min(nchunk, w * per), c1 = min(nchunk, c0 + per);
  const float* sd = Sdt + (long long)z * nchunk * D + ec / N;
  float* hc = Hc + (long long)z * nchunk * DN + ec;
  float sum = 0.f, agg = 0.f;
#pragma unroll 4
  for (int c = c0; c < c1; ++c) {
    const float s = sd[(long long)c * D];
    agg = fmaf(ex2(a2 * s), agg, hc[(long long)c * DN]);
    sum += s;
  }
  sp[w][lane] = ex2(a2 * sum);
  sh[w][lane] = agg;
  __syncthreads();
  float carry = 0.f;
  for (int v = 0; v < w; ++v) carry = fmaf(sp[v][lane], carry, sh[v][lane]);
#pragma unroll 4
  for (int c = c0; c < c1; ++c) {
    const float s = sd[(long long)c * D];
    const float hl = hc[(long long)c * DN];
    if (live) hc[(long long)c * DN] = carry;
    carry = fmaf(ex2(a2 * s), carry, hl);
  }
}

// out[r, off(k)] = sum_d silu(xc[r, d]) w[k, d], register-tiled: thread
// (ty, tx) of a 16 x 12 grid owns rows 8 ty .. 8 ty + 7 and columns
// 4 tx .. 4 tx + 3 of the block's 128-row x 48-column tile (K <= 48). Per
// d, two float4 of the transposed silu(xc) tile and one of the transposed
// weight tile feed 32 FMAs. The next slab is fetched into registers while
// this one is multiplied; silu is applied once, as a slab is stashed. Column
// k < dt_rank goes to k, the next N to R4 + (k - dt_rank), the last N to
// R4 + N4 + (k - dt_rank - N). `vec`: xc's rows are 16-byte aligned.
__global__ void __launch_bounds__(kProjThreads)
scan_project_kernel(const float* __restrict__ xc, const float* __restrict__ w,
                    float* __restrict__ out, long long rows, int D, int nr,
                    int N, int R4, int W, int vec) {
  __shared__ __align__(16) float xs[kProjSlab][kProjRows + 4];  // [d][row]
  __shared__ __align__(16) float wt[kProjSlab][kProjCols + 4];  // [d][k]
  const int K = nr + 2 * N, N4 = (N + 3) & ~3;
  const long long r0 = (long long)blockIdx.x * kProjRows;
  const int tid = threadIdx.x, ty = tid / (kProjCols / 4),
            tx = tid % (kProjCols / 4);
  float4 xr[kProjX4];
  float wr[kProjW];
  // slab element e: row e % kProjRows (consecutive threads, consecutive
  // rows: the transposed stores hit distinct banks), float4 e / kProjRows
  // along d
  auto fetch = [&](int d0) {
#pragma unroll
    for (int m = 0; m < kProjX4; ++m) {
      const int e = tid + m * kProjThreads;
      const int i = e % kProjRows, q = e / kProjRows;
      const long long r = r0 + i;
      const int dcol = d0 + 4 * q;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows) {
        const float* src = xc + r * D + dcol;
        if (vec) {
          if (dcol < D) v = *reinterpret_cast<const float4*>(src);
        } else {
          if (dcol < D) v.x = src[0];
          if (dcol + 1 < D) v.y = src[1];
          if (dcol + 2 < D) v.z = src[2];
          if (dcol + 3 < D) v.w = src[3];
        }
      }
      xr[m] = v;
    }
#pragma unroll
    for (int m = 0; m < kProjW; ++m) {
      const int e = tid + m * kProjThreads;
      const int k = e / kProjSlab, dd = e % kProjSlab;
      wr[m] = (k < K && d0 + dd < D) ? w[(long long)k * D + d0 + dd] : 0.f;
    }
  };
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int d0 = 0; d0 < D; d0 += kProjSlab) {
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kProjX4; ++m) {
      const int e = tid + m * kProjThreads;
      const int i = e % kProjRows, q = e / kProjRows;
      xs[4 * q][i] = silu(xr[m].x);
      xs[4 * q + 1][i] = silu(xr[m].y);
      xs[4 * q + 2][i] = silu(xr[m].z);
      xs[4 * q + 3][i] = silu(xr[m].w);
    }
#pragma unroll
    for (int m = 0; m < kProjW; ++m) {
      const int e = tid + m * kProjThreads;
      wt[e % kProjSlab][e / kProjSlab] = wr[m];
    }
    __syncthreads();
    if (d0 + kProjSlab < D) fetch(d0 + kProjSlab);
#pragma unroll
    for (int dd = 0; dd < kProjSlab; ++dd) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[dd][8 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[dd][8 * ty + 4]);
      const float4 w4 = *reinterpret_cast<const float4*>(&wt[dd][4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = r0 + 8 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * tx + j;
      const int off = k < nr       ? k
                      : k < nr + N ? R4 + k - nr
                                   : R4 + N4 + k - nr - N;
      if (r < rows && k < K) out[r * W + off] = acc[i][j];
    }
  }
}


// ---------------------------------------------------------------------------
// The bf16 passes (contracts c and d).
//
// Operand types of a pass (kMix, a set of these bits): u in bf16 (always,
// here); dt, B and C in bf16 (else fp32); y in bf16 (else fp32); delta
// given (the dt rows hold softplus(dt + bias) already: no softplus, no
// bias). The mixes built:
constexpr int kU16 = 1, kD16 = 4, kY16 = 8, kDelta = 16;
constexpr int kMixProj16 = kU16 | kY16 | kDelta;  // (c): u, delta, B, C
                                                  // from the projection
constexpr int kMixChain16 = kU16 | kD16 | kY16;   // (d) #5, chainv5
constexpr int kMixSpatial16 = kU16 | kD16;        // (d) #9, spatial
constexpr int kMixBidir16 = kU16;                 // (d) #8, bidir

constexpr int kRing16 = 3;               // stages of the bf16 passes' ring
constexpr int kThreads16 = kTile + 32;   // 128 consumers, a producer warp
// bytes before the ring: the full, empty and (bf16 B and C) raw barriers,
// then each stage's kSub rows (int, within the sequence) for pass 2
constexpr int kHead16 = 512;
static_assert(3 * kRing16 * 8 + kRing16 * kSub * 4 <= kHead16,
              "barriers and rows fit the head");

// Bytes of one dt (or delta), B or C value at a mix.
__host__ __device__ constexpr int dt_bytes(int mix) {
  return (mix & kD16) ? 2 : 4;
}

// Values of a staged B (or C) row as copied: N rounded up to a 16-byte
// multiple; and as the recurrence reads it, fp32: N rounded up to 4.
__host__ __device__ constexpr int bc_pad(int N, int mix) {
  return (N + 16 / dt_bytes(mix) - 1) / (16 / dt_bytes(mix)) *
         (16 / dt_bytes(mix));
}
__host__ __device__ constexpr int bc4(int N) { return (N + 3) & ~3; }

// Byte offsets in a stage: kSub steps of the tile's u (bf16) and its dt
// (or delta), then each step's B row and C row as copied; where they are
// bf16 (kD16), then the same rows widened to fp32 by the producer warp
// (one copy a stage for the 128 channels, where widening in each
// consumer cost ~32 instructions a step). Every region and row starts 16
// bytes aligned.
__host__ __device__ constexpr int stage16_bc(int mix) {
  return kSub * kTile * (2 + dt_bytes(mix));
}
__host__ __device__ constexpr int stage16_wide(int N, int mix) {
  return stage16_bc(mix) +
         ((mix & kD16) ? kSub * 2 * bc_pad(N, mix) * dt_bytes(mix) : 0);
}
__host__ __device__ constexpr int stage16_bytes(int N, int mix) {
  return stage16_wide(N, mix) + kSub * 2 * bc4(N) * 4;
}

// 2^x on the FMA pipe, for x <= 127 (x below -126 gives 2^-126, which
// the state update absorbs as ex2.approx.ftz's 0): x = k + f, k = rint(x)
// by the 1.5 * 2^23 shift, f in [-0.5, 0.5], 2^f by a degree-5
// polynomial (relative error 2.2e-7 in fp32, ex2.approx.ftz's is 2^-22.5),
// k added to the exponent. 11 instructions where the MUFU's ex2 takes 8
// cycles of a sub-partition's SFU for a warp: pass 1 runs kEmu1 of its 16
// exponentials here, so that the FMA pipe, which has issue slots to spare
// there, shares the SFU's load.
__device__ __forceinline__ float ex2_fma(float x) {
  x = fmaxf(x, -126.f);
  const float t = x + 12582912.f;
  const float f = x - (t - 12582912.f);
  float p = 0.001327660423357978f;
  p = fmaf(p, f, 0.009675494885954412f);
  p = fmaf(p, f, 0.05550712375487562f);
  p = fmaf(p, f, 0.240221206014255f);
  p = fmaf(p, f, 0.6931469679586281f);
  p = fmaf(p, f, 1.0000000714752197f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}
constexpr int kEmu1 = 2;

__device__ __forceinline__ float f32_of(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float f32_of(float v) { return v; }

// v[0 .. kMaxState) = row[0 .. N) of an fp32 row, zeros past N: 16-byte
// broadcast reads where N is compile-time.
template <int kN>
__device__ __forceinline__ void load_row(const float* row, int N,
                                         float (&v)[kMaxState]) {
  if constexpr (kN && kN % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kN / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(row)[q];
      v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int n = 0; n < kMaxState; ++n) v[n] = n < (kN ? kN : N) ? row[n] : 0.f;
  }
}

// The geometry of an item, as both roles of a bf16 pass walk it.
struct Item16 {
  int c, z, g, d0, dl, s0, len, nsub;
  bool rev;
  long long brow, xrow;
};

__device__ __forceinline__ Item16 item16(const ScanArgs& a, int item) {
  Item16 it;
  const int j = item % a.tiles, zc = item / a.tiles;
  it.c = zc % a.nchunk;
  it.z = zc / a.nchunk;
  it.g = it.z / a.Bt;
  it.rev = (a.rev_mask >> it.g) & 1;
  it.d0 = j * kTile;
  it.dl = min(kTile, a.D - it.d0);
  it.s0 = it.c * a.chunk;
  it.len = min(a.chunk, a.L - it.s0);
  it.nsub = (it.len + kSub - 1) / kSub;
  it.brow = (long long)it.z * a.L;
  it.xrow = ((long long)(it.g % a.Gu) * a.Bt + (it.z - it.g * a.Bt)) * a.L;
  return it;
}

// Widen cnt steps' bf16 B and C rows of a stage to fp32, lane by lane,
// then complete the stage (its second arrival). kN: N compiled (0: N).
template <int kN>
__device__ __forceinline__ void widen16(unsigned char* st, int cnt, int n_,
                                        uint64_t* full, int lane) {
  constexpr int mix = kD16;
  const int N = kN ? kN : n_;
  const __nv_bfloat16* raw =
      reinterpret_cast<const __nv_bfloat16*>(st + stage16_bc(mix));
  float* wide = reinterpret_cast<float*>(st + stage16_wide(N, mix));
  const int bcp = bc_pad(N, mix), b4 = bc4(N);
  for (int e = lane; e < cnt * 2 * N; e += 32) {
    const int i = e / (2 * N), f = e - i * 2 * N;
    const int cc = f >= N, n = f - cc * N;
    wide[i * 2 * b4 + cc * b4 + n] = f32_of(raw[i * 2 * bcp + cc * bcp + n]);
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(full);
}

// The producer warp: for every stage of every item the block walks, wait
// for the stage to be empty, leave the steps' rows in it, and copy the
// steps' u and dt pieces and B and C rows in, lane i taking step i. bf16
// B and C land on the stage's raw barrier; the warp widens them one stage
// behind the copies (so their latency is hidden), which completes the
// stage. Rows that are no 16-byte pieces go value by value.
template <int kN, int kMix>
__device__ __forceinline__ void produce16(const ScanArgs& a,
                                          unsigned char* ring,
                                          uint64_t* full, uint64_t* empty,
                                          uint64_t* raw, int* rows) {
  using DT = typename std::conditional<(kMix & kD16) != 0, __nv_bfloat16,
                                       float>::type;
  constexpr bool kWiden = kMix & kD16;
  constexpr int es = dt_bytes(kMix);
  const int lane = threadIdx.x & 31;
  const int N = a.N, bcp = bc_pad(N, kMix), b4 = bc4(N);
  const int sb = stage16_bytes(N, kMix);
  const DT* dsrc = static_cast<const DT*>(a.dv);
  const DT* bsrc = static_cast<const DT*>(a.Bv);
  const DT* csrc = static_cast<const DT*>(a.Cv);
  uint32_t git = 0;       // stages issued, over all items
  int pend = -1, pcnt = 0;  // the stage whose B and C wait to be widened
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const Item16 it = item16(a, item);
    const int p0 = it.rev ? a.L - 1 - it.s0 : it.s0;
    int rn = p0 / a.T, tn = p0 - rn * a.T;
    for (int k = 0; k < it.nsub; ++k, ++git) {
      const int s = git % kRing16;
      mbar_wait(&empty[s], ((git / kRing16) & 1) ^ 1);
      const int cnt = min(kSub, it.len - k * kSub);
      unsigned char* st = ring + s * sb;
      __nv_bfloat16* us = reinterpret_cast<__nv_bfloat16*>(st);
      DT* ds = reinterpret_cast<DT*>(st + kSub * kTile * 2);
      DT* bcs = reinterpret_cast<DT*>(st + stage16_bc(kMix));
      const int row = lane < cnt ? row_after(a, tn, rn, lane, it.rev) : 0;
      if (lane < kSub) rows[s * kSub + lane] = row;
      __syncwarp();
      if (a.vec_x) {
        if (lane == 0) {
          const int bc = cnt * 2 * N * es;
          mbar_arrive_expect_tx(&full[s],
                                cnt * it.dl * (2 + es) + (kWiden ? 0 : bc));
          if (kWiden) mbar_arrive_expect_tx(&raw[s], bc);
        }
        __syncwarp();
        if (lane < cnt) {
          uint64_t* bcbar = kWiden ? &raw[s] : &full[s];
          bulk_copy(us + lane * kTile, a.xh + (it.xrow + row) * a.D + it.d0,
                    it.dl * 2, &full[s]);
          bulk_copy(ds + lane * kTile, dsrc + (it.brow + row) * a.D + it.d0,
                    it.dl * es, &full[s]);
          bulk_copy(bcs + lane * 2 * bcp, bsrc + (it.brow + row) * N, N * es,
                    bcbar);
          bulk_copy(bcs + lane * 2 * bcp + bcp, csrc + (it.brow + row) * N,
                    N * es, bcbar);
        }
        if (kWiden) {
          if (pend >= 0) {
            mbar_wait(&raw[pend % kRing16], (pend / kRing16) & 1);
            widen16<kN>(ring + (pend % kRing16) * sb, pcnt, N,
                        &full[pend % kRing16], lane);
          }
          pend = git;
          pcnt = cnt;
        }
      } else {
        // value by value; B and C go straight to their fp32 rows
        float* wide = reinterpret_cast<float*>(st + stage16_wide(N, kMix));
        for (int e = lane; e < cnt * it.dl; e += 32) {
          const int i = e / it.dl, ch = e - i * it.dl;
          const long long r = rows[s * kSub + i];
          us[i * kTile + ch] = a.xh[(it.xrow + r) * a.D + it.d0 + ch];
          ds[i * kTile + ch] = dsrc[(it.brow + r) * a.D + it.d0 + ch];
        }
        for (int e = lane; e < cnt * 2 * N; e += 32) {
          const int i = e / (2 * N), f = e - i * 2 * N;
          const int cc = f >= N, n = f - cc * N;
          const long long r = rows[s * kSub + i];
          wide[i * 2 * b4 + cc * b4 + n] =
              f32_of((cc ? csrc : bsrc)[(it.brow + r) * N + n]);
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&full[s]);
          if (kWiden) mbar_arrive(&full[s]);
        }
      }
      step_by(a, tn, rn, kSub, it.rev);
    }
    if (kWiden && pend >= 0) {  // the item's last stage
      mbar_wait(&raw[pend % kRing16], (pend / kRing16) & 1);
      widen16<kN>(ring + (pend % kRing16) * sb, pcnt, N,
                  &full[pend % kRing16], lane);
      pend = -1;
    }
  }
}

// The consumers, one channel a thread: the recurrence of every stage the
// producer fills, in registers; pass 1 writes each item's sum of delta and
// end state, pass 2 each step's y. u and dt are widened as they are read.
template <bool kFinal, int kN, int kMix>
__device__ __forceinline__ void consume16(const ScanArgs& a,
                                          const unsigned char* ring,
                                          uint64_t* full, uint64_t* empty,
                                          const int* rows) {
  using DT = typename std::conditional<(kMix & kD16) != 0, __nv_bfloat16,
                                       float>::type;
  const int tid = threadIdx.x;
  const int N = kN ? kN : a.N;
  const int b4 = bc4(N);
  const int sb = stage16_bytes(N, kMix), wo = stage16_wide(N, kMix);
  uint32_t git = 0;
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const Item16 it = item16(a, item);
    const int d = it.d0 + tid;
    const bool live = tid < it.dl;
    const int dc = live ? d : a.D - 1;  // parameters of a channel in range
    // exp(delta A) = exp2(delta A log2(e)): one ex2 per state and step
    float A2[kMaxState], h[kMaxState];
    const int gd = it.g * a.D + dc;
    const long long so = (((long long)it.z * a.nchunk + it.c) * a.D + dc) * N;
#pragma unroll
    for (int n = 0; n < kMaxState; ++n) {
      const bool on = kN ? n < kN : n < N;
      A2[n] = on ? a.A[(long long)gd * N + n] * kLog2e : 0.f;
      h[n] = (kFinal && on) ? a.Hc[so + n] : 0.f;
    }
    const float bias = (kMix & kDelta) ? 0.f : a.bias[gd];
    const float dskip = a.Dskip[gd];
    float sdt = 0.f;
    for (int k = 0; k < it.nsub; ++k, ++git) {
      const int s = git % kRing16;
      mbar_wait(&full[s], (git / kRing16) & 1);
      const unsigned char* st = ring + s * sb;
      const __nv_bfloat16* us =
          reinterpret_cast<const __nv_bfloat16*>(st) + tid;
      const DT* ds = reinterpret_cast<const DT*>(st + kSub * kTile * 2) + tid;
      const float* bcs = reinterpret_cast<const float*>(st + wo);
      const int cnt = min(kSub, it.len - k * kSub);
#pragma unroll 2
      for (int i = 0; i < cnt; ++i) {
        const float u = __bfloat162float(us[i * kTile]);
        const float dt = f32_of(ds[i * kTile]);
        const float delta = (kMix & kDelta) ? dt : softplus_fma(dt + bias);
        if (!kFinal) sdt += delta;
        const float du = delta * u;
        float Bv[kMaxState], Cv[kMaxState];
        load_row<kN>(bcs + i * 2 * b4, N, Bv);
        if (kFinal) load_row<kN>(bcs + i * 2 * b4 + b4, N, Cv);
        float y0 = 0.f, y1 = 0.f;  // even and odd states: shorter chains
#pragma unroll
        for (int n = 0; n < kMaxState; ++n) {
          if (kN ? n < kN : n < N) {
            const float x = delta * A2[n];
            h[n] = fmaf(!kFinal && n < kEmu1 ? ex2_fma(x) : ex2(x), h[n],
                        du * Bv[n]);
            if (kFinal) {
              if (n & 1) y1 = fmaf(Cv[n], h[n], y1);
              else y0 = fmaf(Cv[n], h[n], y0);
            }
          }
        }
        if (kFinal && live) {
          const float y = (y0 + y1) + dskip * u;
          const long long o = (it.brow + rows[s * kSub + i]) * a.D + d;
          if (kMix & kY16)
            static_cast<__nv_bfloat16*>(a.yv)[o] = __float2bfloat16_rn(y);
          else
            static_cast<float*>(a.yv)[o] = y;
        }
      }
      mbar_arrive(&empty[s]);
    }
    if (!kFinal && live) {
      a.Sdt[((long long)it.z * a.nchunk + it.c) * a.D + d] = sdt;
#pragma unroll
      for (int n = 0; n < kMaxState; ++n)
        if (kN ? n < kN : n < N) a.Hc[so + n] = h[n];
    }
  }
}

// Pass 1 (kFinal false) or pass 2 (kFinal true) of the bf16 passes: the
// same items and outputs as scan_pass_kernel's, threads 0-127 consuming,
// the last warp producing. kN: N compiled (0: read, <= 16).
template <bool kFinal, int kN, int kMix>
__global__ void __launch_bounds__(kThreads16, kN ? 4 : 2)
scan_pass16_kernel(const ScanArgs a) {
  extern __shared__ __align__(128) unsigned char smem16[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem16);
  uint64_t* empty = full + kRing16;
  uint64_t* raw = empty + kRing16;
  int* rows = reinterpret_cast<int*>(raw + kRing16);
  unsigned char* ring = smem16 + kHead16;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing16; ++s) {
      // the copies' arrival, and the widening's where B and C are bf16
      mbar_init(&full[s], (kMix & kD16) ? 2 : 1);
      mbar_init(&empty[s], kTile);
      mbar_init(&raw[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= kTile)
    produce16<kN, kMix>(a, ring, full, empty, raw, rows);
  else
    consume16<kFinal, kN, kMix>(a, ring, full, empty, rows);
}

// ---------------------------------------------------------------------------
// The bf16 projection of contract c on wgmma.
//
// delta = softplus(u W_dt^T + bias), B = u W_B^T, C = u W_C^T, fp32, with u
// = bf16(silu(xc)) and W [D + 2N, D] the composed weight in bf16 (rows
// W_dt = dt_proj_w x_proj_w[:dt_rank], then x_proj_w's B and C rows). A
// block is 64 rows (one warpgroup's m64) and every column, in chunks of
// kPwCols = 104 (one m64n104k16 per 16 of K). Shared memory holds the
// block's u in the core-matrix order wgmma reads without swizzle (8 rows x
// 16 bytes a core matrix, 128 bytes; for each 16 of K, the 8 row groups
// 256 bytes apart, the two halves of K 128 apart) and a ring of kPwRing
// k16 slices of a chunk's weight in the same order, which the weight holds
// in device memory already (ops/selective_scan.py:weight_layout: [chunk]
// [k16][13 column groups][2 halves][8][8]); then the bias.
constexpr int kPwRows = 64, kPwCols = 104, kPwRing = 8;
constexpr int kPwThreads = 128 + 32;        // a warpgroup, a producer warp
constexpr int kPwSlice = kPwCols * 16 * 2;  // bytes of a chunk's k16 slice
constexpr int kPwHead = 128;                // the ring's barriers

__host__ __device__ constexpr int pw_k16(int D) { return (D + 15) / 16; }
__host__ __device__ constexpr int pw_chunks(int D, int N) {
  return (D + 2 * N + kPwCols - 1) / kPwCols;
}

// A wgmma shared-memory descriptor, no swizzle: the start address, the
// byte offset between the two core matrices along K (lbo) and between
// 8-row groups (sbo), each in 16-byte units.
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t(lbo >> 4) << 16) | (uint64_t(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
}

// d (+)= A B for one 64 x 104 tile and k 16 (bf16 operands, fp32 sums),
// A and B in shared memory by their descriptors; d is taken as zero where
// `accumulate` is 0.
__device__ __forceinline__ void wgmma_m64n104k16(float (&d)[52], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51}, "
      "%52, %53, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Keeps the compiler from moving reads of the accumulators above a wait.
__device__ __forceinline__ void fence_acc(float (&d)[52]) {
#pragma unroll
  for (int i = 0; i < 52; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Threads 0-127 (the warpgroup) stage u and run the products and the
// epilogue; thread 128 streams the weight's slices. wl: the weight in the
// order above, 16-byte aligned; bias [D] fp32; u [rows, D] bf16 (the
// passes' u, written as it is staged), delta [rows, D], Bm and Cm
// [rows, N] fp32.
constexpr int kPwBatch = 8;  // staging loads in flight a thread
__global__ void __launch_bounds__(kPwThreads, 3)
scan_project_wgmma_kernel(const __nv_bfloat16* __restrict__ xc,
                          const __nv_bfloat16* __restrict__ wl,
                          const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ u,
                          float* __restrict__ delta, float* __restrict__ Bm,
                          float* __restrict__ Cm, long long rows, int D,
                          int N) {
  extern __shared__ __align__(128) unsigned char smem_pw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_pw);
  uint64_t* empty = full + kPwRing;
  unsigned char* as = smem_pw + kPwHead;
  const int nk = pw_k16(D), nch = pw_chunks(D, N);
  unsigned char* ring = as + nk * 2048;
  float* bias_s = reinterpret_cast<float*>(ring + kPwRing * kPwSlice);
  const long long r0 = (long long)blockIdx.x * kPwRows;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kPwRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid >= 128) {
    if (tid == 128) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(wl);
      for (int it = 0; it < nch * nk; ++it) {
        const int s = it % kPwRing;
        mbar_wait(&empty[s], ((it / kPwRing) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], kPwSlice);
        bulk_copy(ring + s * kPwSlice, src + (long long)it * kPwSlice,
                  kPwSlice, &full[s]);
      }
    }
    return;
  }
  // u = bf16(silu(xc)) of the block's rows, zeros past D and past the
  // rows, kPwBatch loads in flight: item e is row 8 i + e % 8 of 8-column
  // group q, so each 8 lanes fill one core matrix (128 contiguous bytes)
  const int kq = 2 * nk, items = kPwRows * kq;  // 8-column groups
  for (int e0 = tid; e0 < items; e0 += 128 * kPwBatch) {
    uint4 v[kPwBatch];
#pragma unroll
    for (int b = 0; b < kPwBatch; ++b) {
      const int e = e0 + 128 * b, q = (e >> 3) % kq, i = (e >> 3) / kq;
      const long long row = r0 + 8 * i + (e & 7);
      v[b] = make_uint4(0, 0, 0, 0);
      if (e < items && row < rows && 8 * q < D)
        v[b] = load8_bf16(xc + row * D + 8 * q, D - 8 * q);
    }
#pragma unroll
    for (int b = 0; b < kPwBatch; ++b) {
      const int e = e0 + 128 * b, q = (e >> 3) % kq, i = (e >> 3) / kq;
      if (e >= items) break;
      const long long row = r0 + 8 * i + (e & 7);
      const int col = 8 * q;
      const uint4 w = map8_bf16(v[b], [](float x) { return silu(x); });
      *reinterpret_cast<uint4*>(as + (q >> 1) * 2048 + i * 256 +
                                (q & 1) * 128 + (e & 7) * 16) = w;
      if (row < rows && col < D) {
        __nv_bfloat16* dst = u + row * D + col;
        if (col + 8 <= D && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
          *reinterpret_cast<uint4*>(dst) = w;
        } else {
          const uint32_t wd[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int c = 0; c < 8; ++c)
            if (col + c < D)
              dst[c] = __ushort_as_bfloat16(
                  (unsigned short)(wd[c / 2] >> (16 * (c & 1))));
        }
      }
    }
  }
  for (int i = tid; i < D; i += 128) bias_s[i] = bias[i];
  fence_proxy_async();  // the generic stores, before wgmma reads them
  asm volatile("bar.sync 1, 128;" ::: "memory");

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  float acc[kPwCols / 2];
  for (int c = 0; c < nch; ++c) {
#pragma unroll
    for (int i = 0; i < kPwCols / 2; ++i) acc[i] = 0.f;
    fence_acc(acc);
    for (int kk = 0; kk < nk; ++kk) {
      const int it = c * nk + kk, s = it % kPwRing;
      mbar_wait(&full[s], (it / kPwRing) & 1);
      wgmma_fence();
      wgmma_m64n104k16(acc, wg_desc(as + kk * 2048, 128, 256),
                       wg_desc(ring + s * kPwSlice, 128, 256), kk > 0);
      wgmma_commit();
      if (kk > 0) {  // the slice before this one is read: release it
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % kPwRing]);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[(c * nk + nk - 1) % kPwRing]);
    // acc[4 j + 2 h + e]: row 16 warp + g + 8 h, column 8 j + 2 t4 + e.
    // In two groups of 8-column tiles (7, then 6): delta = softplus(acc +
    // bias) on D's columns with no branch, so a group's dependent chains
    // interleave, then the group's stores (float2 where all its columns
    // are D's, the rows real and D even: uniform across the warp).
    constexpr int kTiles = kPwCols / 8, kGroup = 7;
#pragma unroll
    for (int jg = 0; jg < kTiles; jg += kGroup) {
#pragma unroll
      for (int j = jg; j < min(jg + kGroup, kTiles); ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c * kPwCols + 8 * j + 2 * t4 + e;
          const float b = bias_s[min(col, D - 1)];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float sp = softplus_fma(acc[4 * j + 2 * h + e] + b);
            acc[4 * j + 2 * h + e] = col < D ? sp : acc[4 * j + 2 * h + e];
          }
        }
      const int gc = c * kPwCols + 8 * jg;  // the group's first column
      const long long row0 = r0 + 16 * warp + g;
      if (gc + 8 * min(kGroup, kTiles - jg) <= D && (D & 1) == 0 &&
          r0 + kPwRows <= rows) {
#pragma unroll
        for (int j = jg; j < min(jg + kGroup, kTiles); ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(delta + (row0 + 8 * h) * D + gc +
                                       8 * (j - jg) + 2 * t4) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        continue;
      }
#pragma unroll
      for (int j = jg; j < min(jg + kGroup, kTiles); ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const long long row = row0 + 8 * h;
            const int ce = c * kPwCols + 8 * j + 2 * t4 + e;
            const float v = acc[4 * j + 2 * h + e];
            if (row >= rows) continue;
            if (ce < D)
              delta[row * D + ce] = v;
            else if (ce < D + N)
              Bm[row * N + ce - D] = v;
            else if (ce < D + 2 * N)
              Cm[row * N + ce - D - N] = v;
          }
    }
  }
}

size_t ring_bytes(int W) {
  return size_t(kStages) * stage_floats(W) * sizeof(float);
}

// Let a kernel take `bytes` of dynamic shared memory: set once a device
// (again only for more).
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int (&allowed)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) allowed[dev] = bytes;
  return err;
}

// Let both fp32 passes take `W`'s ring.
template <bool kProj, int kN, int kR>
cudaError_t allow_passes(int W) {
  static int allowed1[64] = {}, allowed2[64] = {};
  const int bytes = int(ring_bytes(W));
  cudaError_t err = allow_smem(scan_pass_kernel<kProj, false, kN, kR>,
                               bytes, allowed1);
  if (err != cudaSuccess) return err;
  return allow_smem(scan_pass_kernel<kProj, true, kN, kR>, bytes, allowed2);
}

// Let both bf16 passes take their ring at N.
template <int kN, int kMix>
cudaError_t allow_passes16(int N) {
  static int allowed1[64] = {}, allowed2[64] = {};
  const int bytes = kHead16 + kRing16 * stage16_bytes(N, kMix);
  cudaError_t err = allow_smem(scan_pass16_kernel<false, kN, kMix>, bytes,
                               allowed1);
  if (err != cudaSuccess) return err;
  return allow_smem(scan_pass16_kernel<true, kN, kMix>, bytes, allowed2);
}

// SMs x the blocks of two kernels both fit at once on one.
template <typename K1, typename K2>
cudaError_t resident(K1 k1, K2 k2, int threads, size_t bytes, int* slots) {
  int dev = 0, sms = 0, b1 = 0, b2 = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &b1, k1, threads, bytes)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &b2, k2, threads, bytes)) != cudaSuccess)
    return err;
  *slots = sms * min(b1, b2);
  return cudaSuccess;
}

// Resident blocks of both fp32 passes on the whole card.
template <bool kProj, int kN, int kR>
cudaError_t slots_of(int W, int* slots) {
  cudaError_t err = allow_passes<kProj, kN, kR>(W);
  if (err != cudaSuccess) return err;
  return resident(scan_pass_kernel<kProj, false, kN, kR>,
                  scan_pass_kernel<kProj, true, kN, kR>, kThreads,
                  ring_bytes(W), slots);
}

// Resident blocks of both bf16 passes on the whole card.
template <int kN, int kMix>
cudaError_t slots16_of(int N, int* slots) {
  cudaError_t err = allow_passes16<kN, kMix>(N);
  if (err != cudaSuccess) return err;
  return resident(scan_pass16_kernel<false, kN, kMix>,
                  scan_pass16_kernel<true, kN, kMix>, kThreads16,
                  kHead16 + size_t(kRing16) * stage16_bytes(N, kMix), slots);
}

template <int kMix>
cudaError_t slots16(int N, int* slots) {
  return N == 16 ? slots16_of<16, kMix>(N, slots)
                 : slots16_of<0, kMix>(N, slots);
}

// The compose between the passes.
cudaError_t compose(const ScanArgs& a, int seqs, cudaStream_t stream) {
  const dim3 cgrid((a.D * a.N + 31) / 32, seqs);
  if (a.N == 16)
    scan_compose_kernel<16><<<cgrid, dim3(32, kComposeWarps), 0, stream>>>(
        a.A, a.Sdt, a.Hc, a.Bt, a.nchunk, a.D, a.N);
  else
    scan_compose_kernel<0><<<cgrid, dim3(32, kComposeWarps), 0, stream>>>(
        a.A, a.Sdt, a.Hc, a.Bt, a.nchunk, a.D, a.N);
  return cudaGetLastError();
}

// fp32 pass 1, the compose and pass 2 over `seqs` = G * Bt sequences.
template <bool kProj, int kN, int kR>
cudaError_t run_passes(const ScanArgs& a, int seqs, int grid,
                       cudaStream_t stream) {
  cudaError_t err = allow_passes<kProj, kN, kR>(a.W);
  if (err != cudaSuccess) return err;
  const size_t smem = ring_bytes(a.W);
  scan_pass_kernel<kProj, false, kN, kR>
      <<<grid, kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = compose(a, seqs, stream)) != cudaSuccess) return err;
  scan_pass_kernel<kProj, true, kN, kR><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// bf16 pass 1, the compose and pass 2 at the mix kMix: N 16 compiled,
// else the generic instantiation.
template <int kN, int kMix>
cudaError_t run_passes16_at(const ScanArgs& a, int seqs, int grid,
                            cudaStream_t stream) {
  cudaError_t err = allow_passes16<kN, kMix>(a.N);
  if (err != cudaSuccess) return err;
  const size_t smem = kHead16 + size_t(kRing16) * stage16_bytes(a.N, kMix);
  scan_pass16_kernel<false, kN, kMix>
      <<<grid, kThreads16, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = compose(a, seqs, stream)) != cudaSuccess) return err;
  scan_pass16_kernel<true, kN, kMix><<<grid, kThreads16, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int kMix>
cudaError_t run_passes16(const ScanArgs& a, int seqs, int grid,
                         cudaStream_t stream) {
  return a.N == 16 ? run_passes16_at<16, kMix>(a, seqs, grid, stream)
                   : run_passes16_at<0, kMix>(a, seqs, grid, stream);
}

int round4(int v) { return (v + 3) & ~3; }

// Floats of a staged per-position row: dt_low, B, C (projection contract)
// or B, C, each padded to a multiple of 4.
int row_width(int proj, int N, int dt_rank) {
  return (proj ? round4(dt_rank) : 0) + 2 * round4(N);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Common checks and the fields of ScanArgs every contract sets alike.
bool plan_ok(ScanArgs& a, int seqs, int chunk, int grid) {
  if (a.T < 1 || a.R < 1 || a.D < 1 || a.N < 1 || a.N > kMaxState ||
      chunk < 1 || grid < 1 || seqs < 1 || seqs > 65535)
    return false;
  const long long L = (long long)a.T * a.R;
  if (L + chunk > 0x7fffffffLL) return false;  // positions are 32-bit
  a.L = int(L);
  a.chunk = chunk;
  a.nchunk = int((L + chunk - 1) / chunk);
  a.tiles = (a.D + kTile - 1) / kTile;
  const long long items = (long long)seqs * a.nchunk * a.tiles;
  if (items > 0x7fffffffLL) return false;
  a.items = int(items);
  return true;
}

// The operand types of the bf16 contracts, by their code (the `proj` of
// ff_selective_scan_slots): 2 (c), 3 #5's, 4 #9's, 5 #8's; -1 else.
int mix_of(int contract) {
  switch (contract) {
    case 2: return kMixProj16;
    case 3: return kMixChain16;
    case 4: return kMixSpatial16;
    case 5: return kMixBidir16;
    default: return -1;
  }
}

// Every staged piece of a bf16 pass a bulk copy: u's and dt's tile pieces
// (D % 8: whole 16-byte multiples) and the B and C rows (N values of the
// mix's dt type a 16-byte multiple), all from 16-byte aligned bases.
bool bulk_ok(int mix, int D, int N, const void* u, const void* dt,
             const void* Bm, const void* Cm) {
  return D % 8 == 0 && N * dt_bytes(mix) % 16 == 0 && aligned16(u) &&
         aligned16(dt) && aligned16(Bm) && aligned16(Cm);
}

}  // namespace

// Resident blocks of the scan's passes on the current device (SMs x
// blocks an SM holds), for the contract `proj` (0 explicit, 1 projection,
// 2 the bf16 projection contract, 3-5 the explicit bf16 contracts of #5,
// #9 and #8, see mix_of) at N and dt_rank: the persistent grid is at most
// this. Returns it, or minus a CUDA error.
extern "C" int ff_selective_scan_slots(int proj, int N, int dt_rank) {
  if (N < 1 || N > kMaxState || dt_rank < 0 || dt_rank > kMaxRank ||
      proj < 0 || proj > 5)
    return -int(cudaErrorInvalidValue);
  int slots = 0;
  cudaError_t err;
  switch (proj >= 2 ? mix_of(proj) : -1) {
    case kMixProj16: err = slots16<kMixProj16>(N, &slots); break;
    case kMixChain16: err = slots16<kMixChain16>(N, &slots); break;
    case kMixSpatial16: err = slots16<kMixSpatial16>(N, &slots); break;
    case kMixBidir16: err = slots16<kMixBidir16>(N, &slots); break;
    default: {
      const int W = row_width(proj, N, dt_rank);
      if (proj)
        err = (N == 16 && dt_rank == 12) ? slots_of<true, 16, 12>(W, &slots)
                                         : slots_of<true, 0, 0>(W, &slots);
      else
        err = N == 16 ? slots_of<false, 16, 0>(W, &slots)
                      : slots_of<false, 0, 0>(W, &slots);
    }
  }
  return err == cudaSuccess ? slots : -int(err);
}

// (a) chain_fused / chain_proj contract. xc [B, T, R, D] pre-silu;
// x_proj_w [dt_rank + 2N, D]; dt_proj_w [D, dt_rank]; A [D, N]; Dskip,
// bias [D]; x_dbl scratch [B * T * R, W] (W = round4(dt_rank) +
// 2 round4(N)); y [B, T, R, D]; Sdt [B, nchunk, D] and Hc
// [B, nchunk, D, N] scratch, nchunk = ceil(T R / chunk); `grid` blocks
// walk the items. All fp32 contiguous.
extern "C" int ff_selective_scan_proj(
    const float* xc, const float* x_proj_w, const float* dt_proj_w,
    const float* A, const float* Dskip, const float* bias, float* x_dbl,
    float* y, float* Sdt, float* Hc, int B, int T, int R, int D, int N,
    int dt_rank, int reverse, int chunk, int grid, void* stream) {
  ScanArgs a = {};
  a.x = xc; a.dbl = x_dbl; a.dt_w = dt_proj_w;
  a.A = A; a.Dskip = Dskip; a.bias = bias; a.y = y; a.Sdt = Sdt; a.Hc = Hc;
  a.Bt = B; a.Gu = 1;
  a.T = T; a.R = R; a.st = R; a.sr = 1;
  a.D = D; a.N = N; a.dt_rank = dt_rank;
  a.R4 = round4(dt_rank); a.W = row_width(1, N, dt_rank);
  a.rev_mask = reverse ? 1 : 0;
  a.vec_x = D % 4 == 0 && aligned16(xc);
  a.vec_y = D % 4 == 0 && aligned16(y);
  if (dt_rank < 1 || dt_rank > kMaxRank || !aligned16(x_dbl) ||
      !plan_ok(a, B, chunk, grid))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * a.L;
  scan_project_kernel<<<(unsigned)((rows + kProjRows - 1) / kProjRows),
                        kProjThreads, 0, s>>>(xc, x_proj_w, x_dbl, rows, D,
                                              dt_rank, N, a.R4, a.W,
                                              a.vec_x);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  if (N == 16 && dt_rank == 12)
    return int(run_passes<true, 16, 12>(a, B, grid, s));
  return int(run_passes<true, 0, 0>(a, B, grid, s));
}

// (b) explicit contract: G groups of B sequences of L = T * R positions,
// position r * T + t at row t * st + r * sr. u [Gu, B, L rows, D] (group g
// reads u group g % Gu); delta [G, B, L rows, D]; Bm, Cm [G, B, L rows, N];
// A [G, D, N]; Dskip, bias [G, D]; y like delta; Sdt [G * B, nchunk, D]
// and Hc [G * B, nchunk, D, N] scratch, nchunk = ceil(L / chunk); `grid`
// blocks walk the items. Group g scans in reverse when bit g of rev_mask
// is set. All fp32 contiguous.
extern "C" int ff_selective_scan(const float* u, const float* delta,
                                 const float* A, const float* Bm,
                                 const float* Cm, const float* Dskip,
                                 const float* bias, float* y, float* Sdt,
                                 float* Hc, int G, int Gu, int B, int T,
                                 int R, int st, int sr, int D, int N,
                                 int rev_mask, int chunk, int grid,
                                 void* stream) {
  ScanArgs a = {};
  a.x = u; a.delta = delta; a.Bm = Bm; a.Cm = Cm;
  a.A = A; a.Dskip = Dskip; a.bias = bias; a.y = y; a.Sdt = Sdt; a.Hc = Hc;
  a.Bt = B; a.Gu = Gu;
  a.T = T; a.R = R; a.st = st; a.sr = sr;
  a.D = D; a.N = N; a.dt_rank = 0;
  a.R4 = 0; a.W = row_width(0, N, 0);
  a.rev_mask = rev_mask;
  a.vec_x = D % 4 == 0 && aligned16(u) && aligned16(delta);
  a.vec_bc = N % 4 == 0 && aligned16(Bm) && aligned16(Cm);
  a.vec_y = D % 4 == 0 && aligned16(y);
  if (G < 1 || G > 31 || Gu < 1 || G % Gu != 0 ||
      (long long)G * B > 65535 || !plan_ok(a, G * B, chunk, grid))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 16) return int(run_passes<false, 16, 0>(a, G * B, grid, s));
  return int(run_passes<false, 0, 0>(a, G * B, grid, s));
}

// (c) the bf16 chain_proj contract: xc [B, T, R, D] bf16 pre-silu; wl the
// composed weight [D + 2N, D] bf16 in scan_project_wgmma_kernel's order
// ([pw_chunks][pw_k16][13][2][8][8], zero-padded); A [D, N], Dskip and
// bias [D] fp32; u [B * T * R, D] bf16, delta [B * T * R, D], Bm and Cm
// [B * T * R, N] fp32 scratch the projection fills; y [B, T, R, D] bf16;
// Sdt, Hc and `grid` as (a). The projection (u = silu(xc) rounded to
// bf16, delta = softplus(dt + bias), B, C), then the bf16 passes over u,
// y rounded to bf16.
extern "C" int ff_selective_scan_proj_bf16(
    const void* xc, const void* wl, const float* A, const float* Dskip,
    const float* bias, void* u, float* delta, float* Bm, float* Cm, void* y,
    float* Sdt, float* Hc, int B, int T, int R, int D, int N, int reverse,
    int chunk, int grid, void* stream) {
  ScanArgs a = {};
  a.xh = static_cast<const __nv_bfloat16*>(u);
  a.dv = delta; a.Bv = Bm; a.Cv = Cm; a.yv = y;
  a.A = A; a.Dskip = Dskip; a.Sdt = Sdt; a.Hc = Hc;
  a.Bt = B; a.Gu = 1;
  a.T = T; a.R = R; a.st = R; a.sr = 1;
  a.D = D; a.N = N; a.dt_rank = 0;
  a.rev_mask = reverse ? 1 : 0;
  a.vec_x = bulk_ok(kMixProj16, D, N, u, delta, Bm, Cm);
  const int smem = kPwHead + pw_k16(D) * 2048 + kPwRing * kPwSlice + 4 * D;
  if (!plan_ok(a, B, chunk, grid) || !aligned16(wl) || smem > 227 * 1024)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * a.L;
  const long long blocks = (rows + kPwRows - 1) / kPwRows;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  static int allowed[64] = {};
  cudaError_t err = allow_smem(scan_project_wgmma_kernel, smem, allowed);
  if (err != cudaSuccess) return int(err);
  scan_project_wgmma_kernel<<<unsigned(blocks), kPwThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(xc),
      static_cast<const __nv_bfloat16*>(wl), bias,
      static_cast<__nv_bfloat16*>(u), delta, Bm, Cm, rows, D, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  return int(run_passes16<kMixProj16>(a, B, grid, s));
}

// (d) the explicit contract with a bf16 u (the bf16 expert mode's chainv5,
// spatial and bidir routes), laid out as (b), at the operand types of
// `contract` (mix_of): 3 (#5) dt, B, C and y bf16; 4 (#9) dt, B and C
// bf16, y fp32; 5 (#8) dt, B, C and y fp32. A [G, D, N], Dskip and bias
// [G, D] fp32; Sdt, Hc and `grid` as (b). u is post-silu: no silu runs.
extern "C" int ff_selective_scan_bf16(const void* u, const void* delta,
                                      const float* A, const void* Bm,
                                      const void* Cm, const float* Dskip,
                                      const float* bias, void* y, float* Sdt,
                                      float* Hc, int G, int Gu, int B, int T,
                                      int R, int st, int sr, int D, int N,
                                      int rev_mask, int contract, int chunk,
                                      int grid, void* stream) {
  const int mix = mix_of(contract);
  if (mix < 0 || contract < 3) return int(cudaErrorInvalidValue);
  ScanArgs a = {};
  a.xh = static_cast<const __nv_bfloat16*>(u);
  a.dv = delta; a.Bv = Bm; a.Cv = Cm; a.yv = y;
  a.A = A; a.Dskip = Dskip; a.bias = bias; a.Sdt = Sdt; a.Hc = Hc;
  a.Bt = B; a.Gu = Gu;
  a.T = T; a.R = R; a.st = st; a.sr = sr;
  a.D = D; a.N = N; a.dt_rank = 0;
  a.rev_mask = rev_mask;
  a.vec_x = bulk_ok(mix, D, N, u, delta, Bm, Cm);
  if (G < 1 || G > 31 || Gu < 1 || G % Gu != 0 ||
      (long long)G * B > 65535 || !plan_ok(a, G * B, chunk, grid))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mix) {
    case kMixChain16: return int(run_passes16<kMixChain16>(a, G * B, grid, s));
    case kMixSpatial16:
      return int(run_passes16<kMixSpatial16>(a, G * B, grid, s));
    default: return int(run_passes16<kMixBidir16>(a, G * B, grid, s));
  }
}
