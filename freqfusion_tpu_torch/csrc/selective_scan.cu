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
// weight (rounded to bf16 once) on the bf16 tensor cores into fp32 rows,
// then (b)'s passes over them, and (d) (b) with a bf16 u, at the operand
// types the JAX routes hand #5 (dt, B, C and y bf16), #9 (dt, B and C
// bf16, y fp32) and #8 (dt, B, C and y fp32) in the bf16 expert mode.
// (c) moves more bytes than (a): dt lands in device memory (4 bytes a
// position and channel) and both passes read it, where (a) expands its
// rank-12 dt in registers. (d) reads 2-byte u (and dt) rows: fewer bytes
// than (b), widened to fp32 in shared memory once a stage, and the state
// stays fp32.
//
// What bounds it on the H100. Per (position, channel) a pass does N = 16
// exp2 (one per state) and one or three more MUFU operations (softplus;
// silu on contract a); the SFU does 16 a clock per SM, so one pass over the
// main path's 172,032 x 360 positions-channels needs ~0.3 ms of MUFU time,
// and its FP32 work (4-5 instructions a state) about as much issue time.
// A pass also streams x (248 MB), and dt on contract b, in 512-byte pieces
// a step apart by a whole chain row; pass 2 writes y as much. Cut into
// chunks scanned in parallel, the scan runs twice (summary, then correct),
// so ~0.6 ms a direction is the floor of this scheme. Measured (H100 80GB
// HBM3, 700 W, chip_smoke.py --scan-only's split): ~0.44 + 0.52 ms for
// the passes of contract a; a copy with the recurrence's exp2 and state
// update taken out kept about two thirds of that, so staging, the per-step
// delta and the memory stream, not the SFU, hold most of the time.
//
// Design:
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
// The Pallas kernels' tiling knobs (chunk, inner, the padding of L and of D
// to lane multiples, the approximate per-chain init) do not carry over: the
// scan is exact for any D and L.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

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
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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
  const __nv_bfloat16* xh;  // bf16 u, or xc (pre-silu) (kU16)
  __nv_bfloat16* yh;        // bf16 y (kY16)
  const __nv_bfloat16* dh;  // bf16 dt, B and C (kD16)
  const __nv_bfloat16* Bh;
  const __nv_bfloat16* Ch;
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
  int vec_x, vec_bc;   // x (and dt), B and C rows 16-byte aligned
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

// Operand types of a pass (kMix, a set of these bits): u in bf16 (else
// fp32); u = silu of a pre-silu bf16 xc, rounded to bf16 (the bf16
// chain_proj contract); dt, B and C in bf16; y in bf16. The mixes built:
constexpr int kU16 = 1, kSilu = 2, kD16 = 4, kY16 = 8;
constexpr int kMixProj16 = kU16 | kSilu | kY16;   // (c): dt/B/C fp32 rows
constexpr int kMixChain16 = kU16 | kD16 | kY16;   // (d) #5, chainv5
constexpr int kMixSpatial16 = kU16 | kD16;        // (d) #9, spatial
constexpr int kMixBidir16 = kU16;                 // (d) #8, bidir

// Floats of one ring stage: kSub steps of the tile's x (then u, then y),
// of its dt (then delta) and of the per-position row; then, for a bf16 u,
// the steps' raw bf16 u (or xc) rows (kTile / 2 floats a step) and, for
// bf16 dt/B/C, their raw bf16 dt rows (kTile / 2) and B/C rows (W / 2).
// W is a multiple of 8, so every region starts 16 bytes aligned.
__host__ __device__ __forceinline__ int stage_floats(int W, int mix) {
  return kSub * (2 * kTile + W + (mix & kU16 ? kTile / 2 : 0) +
                 (mix & kD16 ? kTile / 2 + W / 2 : 0));
}

// The raw bf16 u (or xc) rows of a stage (kU16).
__device__ __forceinline__ __nv_bfloat16* stage_xh(float* stage, int W) {
  return reinterpret_cast<__nv_bfloat16*>(stage + kSub * (2 * kTile + W));
}

// The raw bf16 dt rows of a stage (kD16), then its B/C rows of W.
template <int kMix>
__device__ __forceinline__ __nv_bfloat16* stage_dh(float* stage, int W) {
  return reinterpret_cast<__nv_bfloat16*>(
      stage + kSub * (2 * kTile + W + (kMix & kU16 ? kTile / 2 : 0)));
}

template <int kMix>
__device__ __forceinline__ __nv_bfloat16* stage_rh(float* stage, int W) {
  return stage_dh<kMix>(stage, W) + kSub * kTile;
}

// Issue the copies of cnt steps of an item into a stage, the first at
// position (t, r). Copies are spread over the threads; none divides. bf16
// rows go 8 channels a 16-byte copy where they align (D % 8 == 0), else
// as plain 2-byte loads (there is no 2-byte cp.async), seen after the
// barrier that follows the wait.
template <bool kProj, int kN, int kR, int kMix>
__device__ __forceinline__ void stage_in(const ScanArgs& a, float* stage,
                                         int t, int r, int cnt, bool rev,
                                         long long brow, long long xrow,
                                         int d0) {
  constexpr bool kU = kMix & kU16, kD = kMix & kD16;
  const int tid = threadIdx.x;
  const int W = staged_width<kProj, kN, kR>(a);
  float* xs = stage;
  float* ds = stage + kSub * kTile;
  float* rs = stage + 2 * kSub * kTile;
  __nv_bfloat16* xh = stage_xh(stage, W);
  __nv_bfloat16* dh = stage_dh<kMix>(stage, W);
  const int dl = min(kTile, a.D - d0);
  if (a.vec_x) {
    if (!kU || (!kProj && !kD)) {  // fp32 rows, 4 channels a copy
      const int q = tid & 31;  // float4 column of the tile
      if (4 * q < dl) {
        for (int i = tid >> 5; i < cnt; i += kThreads / 32) {
          const long long row = row_after(a, t, r, i, rev);
          if (!kU)
            cp16(xs + i * kTile + 4 * q,
                 a.x + (xrow + row) * a.D + d0 + 4 * q);
          if (!kProj && !kD)
            cp16(ds + i * kTile + 4 * q,
                 a.delta + (brow + row) * a.D + d0 + 4 * q);
        }
      }
    }
    if (kU || kD) {  // bf16 rows, 8 channels a copy
      const int q8 = tid & 15;
      if (8 * q8 < dl) {
        for (int i = tid >> 4; i < cnt; i += kThreads / 16) {
          const long long row = row_after(a, t, r, i, rev);
          if (kU)
            cp16(reinterpret_cast<float*>(xh + i * kTile + 8 * q8),
                 reinterpret_cast<const float*>(a.xh + (xrow + row) * a.D +
                                                d0 + 8 * q8));
          if (kD)
            cp16(reinterpret_cast<float*>(dh + i * kTile + 8 * q8),
                 reinterpret_cast<const float*>(a.dh + (brow + row) * a.D +
                                                d0 + 8 * q8));
        }
      }
    }
  } else if (tid < dl) {
    for (int i = 0; i < cnt; ++i) {
      const long long row = row_after(a, t, r, i, rev);
      if (kU)
        xh[i * kTile + tid] = a.xh[(xrow + row) * a.D + d0 + tid];
      else
        cp4(xs + i * kTile + tid, a.x + (xrow + row) * a.D + d0 + tid);
      if (kD)
        dh[i * kTile + tid] = a.dh[(brow + row) * a.D + d0 + tid];
      else if (!kProj)
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
  } else if (kD) {  // bf16 B and C at the float row's offsets
    __nv_bfloat16* rh = stage_rh<kMix>(stage, W);
    const int N = kN ? kN : a.N, N4 = (N + 3) & ~3;
    if (a.vec_bc) {  // N % 8 == 0
      const int n8 = N / 8;
      for (int e = tid; e < cnt * 2 * n8; e += kThreads) {
        const int i = e / (2 * n8), f = e - i * 2 * n8;
        const int c = f >= n8, k = f - c * n8;
        const long long row = row_after(a, t, r, i, rev);
        cp16(reinterpret_cast<float*>(rh + i * W + c * N4 + 8 * k),
             reinterpret_cast<const float*>((c ? a.Ch : a.Bh) +
                                            (brow + row) * N + 8 * k));
      }
    } else {
      for (int e = tid; e < cnt * 2 * N; e += kThreads) {
        const int i = e / (2 * N), f = e - i * 2 * N;
        const int c = f >= N, k = f - c * N;
        const long long row = row_after(a, t, r, i, rev);
        rh[i * W + c * N4 + k] = (c ? a.Ch : a.Bh)[(brow + row) * N + k];
      }
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
// registers): left to itself ptxas gives them 80 and spills. kMix: the
// operand types (kU16, kSilu, kD16, kY16; 0 all fp32). bf16 operands are
// widened in shared memory, once a stage: u (or silu(xc) rounded to bf16)
// and delta into the thread's own columns in the delta sweep, B and C
// cooperatively, before a barrier; y is rounded once, as it is stored.
template <bool kProj, bool kFinal, int kN, int kR, int kMix>
__global__ void __launch_bounds__(kThreads, kN ? 1 : 4)
scan_pass_kernel(const ScanArgs a) {
  constexpr bool kU = kMix & kU16, kD = kMix & kD16, kY = kMix & kY16;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int N = kN ? kN : a.N;
  const int N4 = (N + 3) & ~3;
  const int nr = kProj ? (kR ? kR : a.dt_rank) : 0;
  const int W = staged_width<kProj, kN, kR>(a);
  const int R4 = kR ? (kR + 3) & ~3 : a.R4;
  const int sfl = stage_floats(W, kMix);

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
        stage_in<kProj, kN, kR, kMix>(a, smem + k * sfl, tn, rn,
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
        stage_in<kProj, kN, kR, kMix>(
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
      const __nv_bfloat16* xh = stage_xh(stage, W) + tid;       // kU16
      const __nv_bfloat16* dh = stage_dh<kMix>(stage, W) + tid;  // kD16
      const int cnt = min(kSub, len - k * kSub);
      if (kD) {  // B and C widened for the recurrence's float4 reads
        const __nv_bfloat16* rh = stage_rh<kMix>(stage, W);
        for (int e = tid; e < cnt * W; e += kThreads)
          rs[e] = __bfloat162float(rh[e]);
      }
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
          dt = kD ? __bfloat162float(dh[i * kTile]) : ds[i * kTile];
          if (kU) {
            const float x = __bfloat162float(xh[i * kTile]);
            xs[i * kTile] = (kMix & kSilu) ? round_bf16(silu(x)) : x;
          }
        }
        dt = softplus(dt + bias);
        ds[i * kTile] = dt;
        sdt += dt;
      }
      if (kD) __syncthreads();  // every thread's widened B and C
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
        if (kY) {  // rounded to bf16, 8 channels a 16-byte store
          if (a.vec_y) {
            const int q = tid & 15;
            if (8 * q < dl) {
              for (int i = tid >> 4; i < cnt; i += kThreads / 16) {
                const long long row = row_after(a, tc, rc, i, rev);
                const float* v = stage + i * kTile + 8 * q;
                const uint4 pk = make_uint4(
                    pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
                *reinterpret_cast<uint4*>(a.yh + (brow + row) * a.D + d0 +
                                          8 * q) = pk;
              }
            }
          } else if (live) {
            for (int i = 0; i < cnt; ++i)
              a.yh[(brow + row_after(a, tc, rc, i, rev)) * a.D + d] =
                  __float2bfloat16_rn(xs[i * kTile]);
          }
        } else if (a.vec_y) {
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

// out[r, :] = silu(xc[r, :]) rounded to bf16, times wt^T on the bf16
// tensor cores (mma.sync m16n8k16, fp32 accumulators): the bf16 contract's
// projection, the composed weight of the JAX kernel (wt [D + 2N, D] bf16:
// rows W_dt_full^T = dt_proj_w x_proj_w[:dt_rank], then x_proj_w's B and C
// rows). Columns c < D go to dt[r, c], the next N to B, the last N to C,
// all fp32 as the JAX kernel's scratch holds them. A block is 128 rows x
// 208 columns (two column blocks cover MambaIR's 392), 8 warps of 16 rows;
// the reduction over D in chunks of 32, 8 values a load item (16 bytes
// where rows align), the next chunk fetched into registers while this one
// is multiplied, u formed as a chunk is stashed.
constexpr int kPbRows = 128, kPbCols = 208, kPbK = 32, kPbLd = kPbK + 8;
constexpr int kPbThreads = 32 * (kPbRows / 16);
constexpr int kPbA = kPbRows * kPbK / 8 / kPbThreads;                   // 2
constexpr int kPbB = (kPbCols * kPbK / 8 + kPbThreads - 1) / kPbThreads;  // 4
static_assert(kPbA * 8 * kPbThreads == kPbRows * kPbK, "whole A items");

__global__ void __launch_bounds__(kPbThreads, 1)
scan_project_bf16_kernel(const __nv_bfloat16* __restrict__ xc,
                         const __nv_bfloat16* __restrict__ wt,
                         float* __restrict__ dt, float* __restrict__ Bm,
                         float* __restrict__ Cm, long long rows, int D,
                         int N) {
  __shared__ __align__(16) __nv_bfloat16 as[kPbRows][kPbLd];
  __shared__ __align__(16) __nv_bfloat16 bs[kPbCols][kPbLd];
  constexpr int kNt = kPbCols / 8;  // n-tiles a warp
  const int K = D + 2 * N;
  const int ctiles = (K + kPbCols - 1) / kPbCols;
  const int c0 = (blockIdx.x % ctiles) * kPbCols;
  const long long r0 = (long long)(blockIdx.x / ctiles) * kPbRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  constexpr int kCh = kPbK / 8;  // load items a row of a chunk
  uint4 ra[kPbA], rb[kPbB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int m = 0; m < kPbA; ++m) {
      const int e = tid + m * kPbThreads, r = e / kCh, d = k0 + 8 * (e % kCh);
      ra[m] = r0 + r < rows ? load8_bf16(xc + (r0 + r) * D + d, D - d)
                            : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int m = 0; m < kPbB; ++m) {
      const int e = tid + m * kPbThreads, c = e / kCh, d = k0 + 8 * (e % kCh);
      rb[m] = c < kPbCols && c0 + c < K
                  ? load8_bf16(wt + (long long)(c0 + c) * D + d, D - d)
                  : make_uint4(0, 0, 0, 0);
    }
  };
  float acc[kNt][4];
#pragma unroll
  for (int j = 0; j < kNt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  fetch(0);
  for (int k0 = 0; k0 < D; k0 += kPbK) {
    __syncthreads();  // the last chunk is consumed
#pragma unroll
    for (int m = 0; m < kPbA; ++m) {
      const int e = tid + m * kPbThreads;
      *reinterpret_cast<uint4*>(&as[e / kCh][8 * (e % kCh)]) =
          map8_bf16(ra[m], [](float x) { return silu(x); });
    }
#pragma unroll
    for (int m = 0; m < kPbB; ++m) {
      const int e = tid + m * kPbThreads;
      if (e / kCh < kPbCols)
        *reinterpret_cast<uint4*>(&bs[e / kCh][8 * (e % kCh)]) = rb[m];
    }
    __syncthreads();
    if (k0 + kPbK < D) fetch(k0 + kPbK);
#pragma unroll
    for (int k16 = 0; k16 < kPbK / 16; ++k16) {
      uint32_t a[4];
      ldsm_a(a, &as[16 * warp][16 * k16], kPbLd);
#pragma unroll
      for (int j = 0; j < kNt; j += 2) {
        uint32_t bf[2][2];
        ldsm_b_nk(bf, &bs[8 * j][16 * k16], kPbLd);
        mma_bf16(acc[j], a, bf[0][0], bf[0][1]);
        mma_bf16(acc[j + 1], a, bf[1][0], bf[1][1]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = r0 + 16 * warp + g + 8 * h;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * j + 2 * t + e;
        const float v = acc[j][2 * h + e];
        if (c < D)
          dt[row * D + c] = v;
        else if (c < D + N)
          Bm[row * N + c - D] = v;
        else if (c < K)
          Cm[row * N + c - D - N] = v;
      }
  }
}

template <int kMix>
size_t ring_bytes(int W) {
  return size_t(kStages) * stage_floats(W, kMix) * sizeof(float);
}

// Let both passes take `W`'s ring: set once a device for each
// instantiation (again only for a larger ring).
template <bool kProj, int kN, int kR, int kMix>
cudaError_t allow_smem(int W) {
  static int allowed[64] = {};
  const int bytes = int(ring_bytes<kMix>(W));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(scan_pass_kernel<kProj, false, kN, kR, kMix>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(scan_pass_kernel<kProj, true, kN, kR, kMix>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) allowed[dev] = bytes;
  return err;
}

// Resident blocks of both passes on the whole card.
template <bool kProj, int kN, int kR, int kMix = 0>
cudaError_t slots_of(int W, int* slots) {
  cudaError_t err = allow_smem<kProj, kN, kR, kMix>(W);
  if (err != cudaSuccess) return err;
  const size_t bytes = ring_bytes<kMix>(W);
  int dev = 0, sms = 0, b1 = 0, b2 = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &b1, scan_pass_kernel<kProj, false, kN, kR, kMix>, kThreads,
           bytes)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &b2, scan_pass_kernel<kProj, true, kN, kR, kMix>, kThreads,
           bytes)) !=
      cudaSuccess)
    return err;
  *slots = sms * min(b1, b2);
  return cudaSuccess;
}

// Pass 1, the compose and pass 2 over `seqs` = G * Bt sequences.
template <bool kProj, int kN, int kR, int kMix = 0>
cudaError_t run_passes(const ScanArgs& a, int seqs, int grid,
                       cudaStream_t stream) {
  cudaError_t err = allow_smem<kProj, kN, kR, kMix>(a.W);
  if (err != cudaSuccess) return err;
  const size_t smem = ring_bytes<kMix>(a.W);
  scan_pass_kernel<kProj, false, kN, kR, kMix>
      <<<grid, kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 cgrid((a.D * a.N + 31) / 32, seqs);
  scan_compose_kernel<kN><<<cgrid, dim3(32, kComposeWarps), 0, stream>>>(
      a.A, a.Sdt, a.Hc, a.Bt, a.nchunk, a.D, a.N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_pass_kernel<kProj, true, kN, kR, kMix>
      <<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
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

// Common checks and the fields of ScanArgs both contracts set alike.
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

// The operand types of the explicit bf16 contracts, by their code (the
// `proj` of ff_selective_scan_slots): 3 #5's, 4 #9's, 5 #8's; -1 else.
int mix_of(int contract) {
  switch (contract) {
    case 3: return kMixChain16;
    case 4: return kMixSpatial16;
    case 5: return kMixBidir16;
    default: return -1;
  }
}

// The explicit contract's passes at the mix kMix: N 16 compiled, else the
// generic instantiation.
template <int kMix>
cudaError_t run_explicit(const ScanArgs& a, int seqs, int grid,
                         cudaStream_t s) {
  if (a.N == 16) return run_passes<false, 16, 0, kMix>(a, seqs, grid, s);
  return run_passes<false, 0, 0, kMix>(a, seqs, grid, s);
}

template <int kMix>
cudaError_t explicit_slots(int N, int* slots) {
  const int W = row_width(0, N, 0);
  return N == 16 ? slots_of<false, 16, 0, kMix>(W, slots)
                 : slots_of<false, 0, 0, kMix>(W, slots);
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
  if (proj >= 2) {
    switch (proj == 2 ? kMixProj16 : mix_of(proj)) {
      case kMixProj16: err = explicit_slots<kMixProj16>(N, &slots); break;
      case kMixChain16: err = explicit_slots<kMixChain16>(N, &slots); break;
      case kMixSpatial16:
        err = explicit_slots<kMixSpatial16>(N, &slots);
        break;
      default: err = explicit_slots<kMixBidir16>(N, &slots); break;
    }
    return err == cudaSuccess ? slots : -int(err);
  }
  const int W = row_width(proj, N, dt_rank);
  if (proj)
    err = (N == 16 && dt_rank == 12) ? slots_of<true, 16, 12>(W, &slots)
                                     : slots_of<true, 0, 0>(W, &slots);
  else
    err = N == 16 ? slots_of<false, 16, 0>(W, &slots)
                  : slots_of<false, 0, 0>(W, &slots);
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
  return int(run_explicit<0>(a, G * B, grid, s));
}

// (c) the bf16 chain_proj contract: xc [B, T, R, D] bf16 pre-silu; wt
// [D + 2N, D] bf16, the composed weight (see scan_project_bf16_kernel);
// A [D, N], Dskip and bias [D] fp32; dt [B * T * R, D], Bm and Cm
// [B * T * R, N] fp32 scratch the projection fills; y [B, T, R, D] bf16;
// Sdt, Hc and `grid` as (a). The projection, then the explicit contract's
// passes with u = silu(xc) rounded to bf16 and y rounded to bf16.
extern "C" int ff_selective_scan_proj_bf16(
    const void* xc, const void* wt, const float* A, const float* Dskip,
    const float* bias, float* dt, float* Bm, float* Cm, void* y, float* Sdt,
    float* Hc, int B, int T, int R, int D, int N, int reverse, int chunk,
    int grid, void* stream) {
  ScanArgs a = {};
  a.xh = static_cast<const __nv_bfloat16*>(xc);
  a.yh = static_cast<__nv_bfloat16*>(y);
  a.delta = dt; a.Bm = Bm; a.Cm = Cm;
  a.A = A; a.Dskip = Dskip; a.bias = bias; a.Sdt = Sdt; a.Hc = Hc;
  a.Bt = B; a.Gu = 1;
  a.T = T; a.R = R; a.st = R; a.sr = 1;
  a.D = D; a.N = N; a.dt_rank = 0;
  a.R4 = 0; a.W = row_width(0, N, 0);
  a.rev_mask = reverse ? 1 : 0;
  a.vec_x = D % 8 == 0 && aligned16(xc) && aligned16(dt);
  a.vec_bc = N % 4 == 0 && aligned16(Bm) && aligned16(Cm);
  a.vec_y = D % 8 == 0 && aligned16(y);
  if (!plan_ok(a, B, chunk, grid)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * a.L;
  const long long blocks = (rows + kPbRows - 1) / kPbRows *
                           ((D + 2 * N + kPbCols - 1) / kPbCols);
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  scan_project_bf16_kernel<<<unsigned(blocks), kPbThreads, 0, s>>>(
      a.xh, static_cast<const __nv_bfloat16*>(wt), dt, Bm, Cm, rows, D, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return int(run_explicit<kMixProj16>(a, B, grid, s));
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
  if (mix < 0) return int(cudaErrorInvalidValue);
  const bool d16 = mix & kD16, y16 = mix & kY16;
  ScanArgs a = {};
  a.xh = static_cast<const __nv_bfloat16*>(u);
  if (d16) {
    a.dh = static_cast<const __nv_bfloat16*>(delta);
    a.Bh = static_cast<const __nv_bfloat16*>(Bm);
    a.Ch = static_cast<const __nv_bfloat16*>(Cm);
  } else {
    a.delta = static_cast<const float*>(delta);
    a.Bm = static_cast<const float*>(Bm);
    a.Cm = static_cast<const float*>(Cm);
  }
  if (y16)
    a.yh = static_cast<__nv_bfloat16*>(y);
  else
    a.y = static_cast<float*>(y);
  a.A = A; a.Dskip = Dskip; a.bias = bias; a.Sdt = Sdt; a.Hc = Hc;
  a.Bt = B; a.Gu = Gu;
  a.T = T; a.R = R; a.st = st; a.sr = sr;
  a.D = D; a.N = N; a.dt_rank = 0;
  a.R4 = 0; a.W = row_width(0, N, 0);
  a.rev_mask = rev_mask;
  a.vec_x = D % 8 == 0 && aligned16(u) && aligned16(delta);
  a.vec_bc = N % (d16 ? 8 : 4) == 0 && aligned16(Bm) && aligned16(Cm);
  a.vec_y = D % (y16 ? 8 : 4) == 0 && aligned16(y);
  if (G < 1 || G > 31 || Gu < 1 || G % Gu != 0 ||
      (long long)G * B > 65535 || !plan_ok(a, G * B, chunk, grid))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mix) {
    case kMixChain16: return int(run_explicit<kMixChain16>(a, G * B, grid, s));
    case kMixSpatial16:
      return int(run_explicit<kMixSpatial16>(a, G * B, grid, s));
    default: return int(run_explicit<kMixBidir16>(a, G * B, grid, s));
  }
}
