// Device code shared by the whole-decode VAMP kernels (fused_vamp_decode.cu,
// fused_vamp2_decode.cu): the tile of trials a block owns, the complex
// products of that tile's rows with the SVD factor Vh (register tiles over
// a cp.async ring in shared memory; for precision='high' the bf16 x 3
// tensor-core engine product_x3), and the segmented softmax posterior
// without the tau/2 halving in both variance forms.  It takes the sums,
// |x|^2 and the complex product of decode_common.cuh (shared with the BAMP
// and SCAMP kernels) and changes nothing there, so those kernels compile as
// before.
#pragma once

#include <cuda_bf16.h>

#include "decode_common.cuh"

namespace vamp {

using decode::abs2;
using decode::kAtol;
using decode::kExpMax;
using decode::kRtol;
using decode::re_conj_mul;
using decode::torch_sum;
using decode::warp_torch_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// A product tile is computed by kTy x kTx threads: thread (ty, tx) = (tid /
// kTx, tid % kTx) owns the kNI consecutive trials kNI ty .. kNI ty + kNI - 1
// and the columns n0 + tx + kTx j, j < NJ (strided, so that a warp's column
// reads and the epilogue's stores are consecutive).
constexpr int kTy = 16;
constexpr int kTx = 16;
constexpr int kNI = 4;     // trials per thread
constexpr int kNJ1 = 3;    // columns per thread, product 1 (N x p)
constexpr int kNJ2 = 2;    // columns per thread, product 2 (p x N)
constexpr int kMinBlocks = 2;  // blocks per SM the registers are held to
constexpr int kBt = kTy * kNI;     // trials of one block: 64
constexpr int kBN1 = kTx * kNJ1;   // 48 columns: 11 tiles cover p = 528
constexpr int kBN2 = kTx * kNJ2;   // 32 columns: 80 tiles cover N = 2560
constexpr int kBNmax = kBN1 > kBN2 ? kBN1 : kBN2;
constexpr int kBK = 16;     // k terms per ring slot: one FMA chain from zero
constexpr int kStages = 2;  // slots of the cp.async ring
constexpr int kPad = 2;     // complex pad of a shared row: 16-byte rows,
                            // transposing stores free of bank conflicts
static_assert(kTy * kTx == kThreads, "one product tile per block");
static_assert(kBt <= kThreads, "a thread per trial for the per-trial flags");
static_assert(kThreads == 256 && kBt % 16 == 0 && kBK == 16,
              "the loader's 16 x 16 thread map");
static_assert(kNI % 2 == 0, "a thread's trials are 16-byte reads");
static_assert(kStages >= 2, "the ring needs two slots");

// One slot of the ring: the operand tiles of kBK contraction steps, a[k][m]
// (the A tile transposed, so a thread's kNI trials are kNI / 2 16-byte
// reads) and b[k][n].
struct __align__(16) Stage {
  float2 a[kBK][kBt + kPad];
  float2 b[kBK][kBNmax + kPad];
};
// Shared memory of one block (dynamic, kSmemBytes).
struct __align__(16) Smem {
  Stage st[kStages];
};
constexpr int kSmemBytes = static_cast<int>(sizeof(Smem));

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// Copy 8 bytes from device to shared memory without registers; !valid
// writes zeros (src is then not read).
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One kBt x (kTx NJ) tile of a complex product, computed by the whole
// block:
//
//   acc[m][n] = sum_k A[m][k] * B[k][n0 + n]
//
// for the rows m < nrows of A (row-major, leading dimension lda, the
// contraction index k < K contiguous) and the columns n0 + n < ncols.
// kFactorRows: B[k][n] = Bm[n * ldb + k], the rows of Bm are the output
// columns (q = r_tilde Vh^T); else B[k][n] = conj(Bm[k * ldb + n]), the rows
// of Bm are the contraction index (x = w conj(Vh)).  Thread (ty, tx) gets
// rows kNI ty + i and columns n0 + tx + kTx j in sr (real) and si
// (imaginary).  Out-of-range elements load as 0.
//
// Loads: every kBK-deep step of both operands goes by cp.async, 8 bytes a
// thread, 16 consecutive threads on 16 consecutive k (or n) of one row, into
// a ring of kStages slots; one barrier per step, the step kStages - 1 ahead
// in flight while this one is multiplied out.  A tile whose k runs along the
// row is stored transposed, a[k][m]: the kPad columns put the 16 k of two
// rows on all 32 banks.  A may have been written earlier in this launch by
// this block (before a barrier); Bm (the factor) is read-only.
//
// Sums: FP32 FMAs on the CUDA cores (the stop test needs full FP32, so no
// TF32 tensor cores), four real FMAs per complex multiply-add.  The sum over
// k is blocked, as a library GEMM's is: each kBK = 16 terms are a chain
// of FMAs from zero, and the chains are added in k order to the running
// sums, both in registers.  A single chain over all of K (K = 2560 at the
// main path) rounds about three times as coarsely, and where trials stop by
// the allclose test on the posterior variance that coarseness shows: at the
// VAMPfinal geometry (N = 3200, cap 100) a single chain gave VAMP a mean T
// of 99.3, chains of 16 85.5, cuBLAS 87.2 and a float64 decode 69.3
// (PERF.md, tests/torch_vamp_precision.py).  The running sums start at -0,
// the identity of addition, so every output is rounded exactly as when its
// first chain was assigned.
template <bool kFactorRows, int NJ>
__device__ __forceinline__ void product_tile(
    const float2* A, int lda, int nrows, const float2* __restrict__ Bm,
    int ldb, int ncols, int K, int n0, Smem& sm, float (&sr)[kNI][NJ],
    float (&si)[kNI][NJ]) {
  constexpr int kBN = kTx * NJ;
  static_assert(kBN <= kBNmax, "column tile wider than the ring's rows");
  const int tid = threadIdx.x;
  const int ty = tid / kTx, tx = tid % kTx;
  // Loader: thread (ly, lx) = (tid / 16, tid % 16) copies k = lx of the
  // rows ly + 16 c (A, and B when kFactorRows), or k = ly and the columns
  // lx + 16 c (B otherwise).  The row and column checks and the offsets
  // are set up once per tile; a step only advances the offsets by its k.
  const int ly = tid >> 4, lx = tid & 15;
  constexpr int kRowsA = kBt / 16;
  unsigned a_ok = 0, b_ok = 0;  // bit c: row (column) c in range
#pragma unroll
  for (int c = 0; c < kRowsA; ++c) a_ok |= (ly + 16 * c < nrows) << c;
#pragma unroll
  for (int c = 0; c < NJ; ++c)
    b_ok |= (n0 + (kFactorRows ? ly : lx) + 16 * c < ncols) << c;
  // element offsets (a block's rows of A and a factor fit 32 bits)
  const unsigned a_at = ly * lda + lx, a_c = 16 * lda;
  const unsigned b_at =
      kFactorRows ? (n0 + ly) * ldb + lx : ly * ldb + n0 + lx;
  const unsigned b_c = kFactorRows ? 16 * ldb : 16;
  const unsigned b_k = kFactorRows ? kBK : kBK * ldb;
  auto load = [&](int step, int slot) {
    Stage& st = sm.st[slot];
    const int k0 = step * kBK;
    const bool ka = k0 + lx < K;
#pragma unroll
    for (int c = 0; c < kRowsA; ++c) {
      const bool ok = ka && (a_ok >> c & 1u);
      cp_async8(&st.a[lx][ly + 16 * c], ok ? A + (a_at + k0 + c * a_c) : A,
                ok);
    }
    const bool kb = k0 + (kFactorRows ? lx : ly) < K;
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      const bool ok = kb && (b_ok >> c & 1u);
      const float2* src = ok ? Bm + (b_at + step * b_k + c * b_c) : Bm;
      if (kFactorRows)
        cp_async8(&st.b[lx][ly + 16 * c], src, ok);
      else
        cp_async8(&st.b[ly][lx + 16 * c], src, ok);
    }
  };

#pragma unroll
  for (int i = 0; i < kNI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) sr[i][j] = si[i][j] = -0.f;
  const int steps = (K + kBK - 1) / kBK;
  __syncthreads();  // the previous tile's reads of the ring are done
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of step s landed
    __syncthreads();  // everyone's did, and step s - 1's slot is free
    if (s + kStages - 1 < steps) load(s + kStages - 1, (s + kStages - 1) %
                                                           kStages);
    cp_async_commit();
    const Stage& st = sm.st[s % kStages];
    float cr[kNI][NJ], ci[kNI][NJ];
#pragma unroll
    for (int i = 0; i < kNI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) cr[i][j] = ci[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float ar[kNI], ai[kNI], br[NJ], bi[NJ];
      const float4* ap =
          reinterpret_cast<const float4*>(&st.a[kk][kNI * ty]);
#pragma unroll
      for (int q = 0; q < kNI / 2; ++q) {
        const float4 v = ap[q];
        ar[2 * q] = v.x;
        ai[2 * q] = v.y;
        ar[2 * q + 1] = v.z;
        ai[2 * q + 1] = v.w;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 v = st.b[kk][tx + kTx * j];
        br[j] = v.x;
        bi[j] = kFactorRows ? v.y : -v.y;
      }
#pragma unroll
      for (int i = 0; i < kNI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          cr[i][j] = fmaf(ar[i], br[j], cr[i][j]);
          cr[i][j] = fmaf(-ai[i], bi[j], cr[i][j]);
          ci[i][j] = fmaf(ar[i], bi[j], ci[i][j]);
          ci[i][j] = fmaf(ai[i], br[j], ci[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kNI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        sr[i][j] = sr[i][j] + cr[i][j];
        si[i][j] = si[i][j] + ci[i][j];
      }
  }
}

// ---- The HIGH form (precision='high'): bf16 x 3 on the tensor cores ------
//
// The counterpart of the TPU kernels' dot3 (fused_bamp.py:60-78 of the JAX
// package): every real product x a is computed as hi(x) hi(a) + (hi(x)
// lo(a) + lo(x) hi(a)), with hi = bf16(x) and lo = bf16(x - hi) both
// rounded to nearest even, each bf16 x bf16 product exact and summed in
// FP32.  Each complex product is the Gauss form of the JAX kernels
// (fused_vamp.py:135-138 forward, :151-154 adjoint): three real products
// k1 = (a + b) T0, k2 = a T1, k3 = b T2 with re = k1 - k3, im = k1 + k2,
// where a, b are the real and imaginary planes of the trial-side operand
// and T0..T2 the wrapper's tap planes (forward on Vh^T: c, d - c, c + d;
// adjoint on Vh: c, -d - c, c - d, for Vh = c + i d).
//
// Bound on this card: the tensor cores' bf16 rate, 989 TFLOP/s dense, for
// 3 products x 3 passes of 2 K flop per complex output.  The passes run as
// mma.sync m16n8k16 (bf16 in, FP32 accumulate) on fragments read by
// ldmatrix; a simple form, not wgmma.
//
// Operands: both arrive split into bf16 hi and lo, each k16 step of each
// as one contiguous block that a single bulk copy (cp.async.bulk, the
// Hopper copy engine, completing on an mbarrier) brings into the ring:
// rows of 16 hi then 16 lo bf16 (64 bytes), their four 16-byte chunks
// swizzled (chunk c of row n at c ^ ((n / 2) % 4)) so that the eight rows
// an ldmatrix phase reads fall on distinct banks.  The tap tiles are the
// wrapper's (fused_vamp.high_taps: per Gauss plane, tile of kBN3 output
// columns, k16 step, the last tile padded with zero columns, K with
// zeros).  The trial side is split once, by the pass that writes it
// (store_split), into the block's split operand (split_at: per Gauss
// operand o = a + b summed in FP32, a, b, per k16 step, the block's 64
// trials): the forward product's operand by the pass that forms r_tilde,
// the adjoint's by the forward product's epilogue (the FP32 w is not
// formed).
//
// Tile: the block's 64 trials x kBN3 = 96 columns, in three passes over k,
// one per real product (k1, then k2, then k3), so that only one product's
// accumulators are live: warp (wm, wn) = (warp % 4, warp / 4) owns 16
// trials x 48 columns, six n8 blocks, each with two FP32 accumulators,
// hi.hi and hi.lo + lo.hi, added at the end of the pass as dot3 groups them
// (48 accumulators a thread, as many as the 64 x 32 tile of all three
// products at once took before).  The hi.hi sum is kept by FP32 adds of
// each k16 step's mma, started from zero: the tensor cores truncate as they
// add into an accumulator, and over the 160 steps of N = 2560 the sum
// carried in the mma doubled the HIGH form's gap to dot3 after one
// iteration (median |d r| 3.4e-7 against 1.8e-7 for VAMP, 6.3e-7 against
// 3.1e-7 for vamp2, HIGHEST 2.9e-6: chip_smoke.py's main-geometry control,
// PERF.md); the corrections, 2^-8 of it, accumulate in the tensor cores.
// k1 is parked in shared memory, and k1 + k2 beside it, each thread in its
// own column of the park (no barriers); after k3 the epilogue gets re = k1
// - k3 and im = k1 + k2.  Six tiles cover p = 528 and 27 cover N = 2560,
// where 32-column tiles took 17 and 80: each trial-side element is read as
// 4 bytes once per pass of a tile, about 23 GB per iteration at the main
// path (45 GB before, FP32 and once per tile).
//
// Ring: kStagesX3 slots of one k16 step (the pass's operand and tap tile),
// one pipeline over every (tile, pass, step) of the product, so that the
// next tile's copies are in flight during a tile's epilogue; thread 0
// issues the copies of the step kStagesX3 - 1 ahead after the step's
// barrier.
//
// What bounds it on this card (NVIDIA H100 80GB HBM3 at 700 W, the main
// path: 65536 trials, cap 10; probe builds of tests/torch_vamp_probes.py
// --precision high, PERF.md): the copy streams, not the tensor cores.  K3
// takes about 310 ms, its products about 105 ms of that (about 267 ms in
// the 32-column engine this one replaces); without the trial side's
// copies it runs about 45 ms faster, without the tap tiles' about 20 ms,
// without the mma passes a few ms.  Per-thread 16-byte cp.async copies of
// the same operands moved them at about 2.6 TB/s and left the products
// near 210 ms; the bulk copies and the evict-first hint on the trial side
// took them to 105.  A wider tile would read the trial side less often but
// needs more accumulators than two blocks per SM leave (or, with hi.hi and
// the corrections in one accumulator, a park twice this size); the same
// passes as wgmma from shared memory gave the same bits and ran slower
// (PERF.md).
constexpr int kBN3 = 96;             // columns of a HIGH product tile
constexpr int kNB3 = kBN3 / 16;      // n8 blocks of a warp's 16 x 48 tile
constexpr int kOut3 = 4 * kNB3;      // a thread's outputs of one product
constexpr int kStagesX3 = 4;         // slots of the HIGH ring
constexpr int kSplitStep = kBt * 2 * kBK;   // bf16 of a split operand step
constexpr int kTapStep = kBN3 * 2 * kBK;    // bf16 of a tap tile step
struct __align__(128) StageX3 {
  __nv_bfloat16 a[kSplitStep];  // the pass's trial-side operand
  __nv_bfloat16 b[kTapStep];    // the pass's tap tile
};
struct __align__(128) SmemX3 {
  StageX3 st[kStagesX3];
  float park[2][kOut3][kThreads];   // a thread's k1, then k1 + k2
  unsigned long long full[kStagesX3];  // mbarriers: slot s has landed
};
constexpr int kSmemBytesX3 = static_cast<int>(sizeof(SmemX3));
static_assert(kBt == 64 && kThreads == 256 && kBK == 16 && kBN3 % 32 == 0,
              "the HIGH engine's warp map: 4 x 2 warps of 16 x kBN3 / 2");
static_assert(kStagesX3 >= 2, "the HIGH ring needs two slots");

// Tap tiles of a product with ncols output columns and ksteps k16 steps:
// the bf16 of its three Gauss planes.
__device__ __host__ __forceinline__ long long tap_tiles_size(int ncols,
                                                             int ksteps) {
  return 3LL * ((ncols + kBN3 - 1) / kBN3) * ksteps * kTapStep;
}

// The 16-byte chunk of a 64-byte operand row n where its chunk c lies.
__device__ __forceinline__ int x3_chunk(int c, int n) {
  return c ^ ((n >> 1) & 3);
}

// ---- The DEFAULT form's one-pass engine (product_x1) -------------------
//
// It computes what the HIGH engine's hi.hi pass alone computes (the three
// Gauss products k1 = (a + b) T0, k2 = a T1, k3 = b T2 of bf16 hi parts,
// each k16 step's mma from zero and added in FP32 in k order, re = k1 -
// k3, im = k1 + k2), on operands that hold the hi parts only: rows of 16
// bf16 (32 bytes), their two 16-byte chunks swizzled (chunk c of row n at
// c ^ ((n / 4) % 2)) so that the eight rows an ldmatrix phase reads fall
// on distinct banks; the wrapper's taps (fused_vamp.default_taps) and the
// trial side (split1_at) are half the HIGH form's bytes.  The tile is the
// block's 64 trials x kBNX1 = 96 columns, three passes over k with k1 and
// k1 + k2 parked in shared memory as in HIGH (warp (warp % 4, warp / 4)
// owns 16 trials x 48 columns, six n8 blocks, 24 FP32 accumulators a
// thread), and a ring slot holds kSlotSteps = 3 k16 steps of the pass
// (one bulk copy of each operand), kStagesX1 = 4 slots: a barrier and an
// mbarrier wait per three steps, nine steps in flight.
//
// What bounds it on this card (NVIDIA H100 80GB HBM3 at 700 W, the main
// path, 65536 trials to the cap of 10; probe builds of
// tests/torch_vamp_probes.py --precision default, PERF.md): not the copy
// streams and not the tensor cores but each warp's chain of ldmatrix,
// mma and FP32 adds between barriers.  On the HIGH layout the products
// took about 100 ms (both halves copied, one k16 step a slot).  Hi-only
// 176-column tiles with a 3-slot ring of one step (the design first
// predicted: the trial side read 0.55 times as often) took them to about
// 58 ms, and no copy stream moved them any more: with 44 accumulators a
// thread under the 128-register cap ptxas serialised each step into
// ldmatrix, two mma, eight adds, one n8 pair after another.  Narrower
// tiles with several steps a slot ran faster, the deeper single-step
// rings slower: 96 columns x 4 slots x 3 steps 136 ms for K3 against 153
// ms for 176 x 3 x 1 (PERF.md lists the variants).
constexpr int kBNX1 = 96;              // columns of a DEFAULT product tile
constexpr int kNB1 = kBNX1 / 16;       // n8 blocks of a warp's half tile
constexpr int kOut1 = 4 * kNB1;        // a thread's outputs of one product
constexpr int kStagesX1 = 4;           // slots of the DEFAULT ring
constexpr int kSlotSteps = 3;          // k16 steps of one slot
constexpr int kSplitStep1 = kBt * kBK;      // bf16 of a split operand step
constexpr int kTapStep1 = kBNX1 * kBK;      // bf16 of a tap tile step
constexpr int kSlotBytesA = 2 * kSplitStep1;  // a step's trial side
constexpr int kSlotBytesB = 2 * kTapStep1;    // a step's tap tile
struct __align__(128) StageX1 {
  __nv_bfloat16 a[kSlotSteps][kSplitStep1];  // the pass's trial-side steps
  __nv_bfloat16 b[kSlotSteps][kTapStep1];    // the pass's tap tile steps
};
struct __align__(128) SmemX1 {
  StageX1 st[kStagesX1];
  float park[2][kOut1][kThreads];   // a thread's k1, then k1 + k2
  unsigned long long full[kStagesX1];  // mbarriers: slot s has landed
};
constexpr int kSmemBytesX1 = static_cast<int>(sizeof(SmemX1));
static_assert(kBNX1 % 16 == 0 && kStagesX1 >= 2 && kSlotSteps >= 1,
              "a warp's n8 blocks: pairs by ldmatrix.x4, an odd one by .x2");
static_assert(kSmemBytesX1 <= 113664,
              "two blocks per SM with the kernels' static arrays");

// The DEFAULT form's tap tiles of a product with ncols output columns and
// ksteps k16 steps: the bf16 hi of its three Gauss planes.
__device__ __host__ __forceinline__ long long tap_tiles1_size(int ncols,
                                                              int ksteps) {
  return 3LL * ((ncols + kBNX1 - 1) / kBNX1) * ksteps * kTapStep1;
}

// The 16-byte chunk of a 32-byte DEFAULT operand row n where its chunk c
// lies.
__device__ __forceinline__ int x1_chunk(int c, int n) {
  return c ^ ((n >> 2) & 1);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}
// One arrival that also expects `bytes` of copies to complete on bar.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Wait until the phase of bar with the given parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) from device
// to shared memory by the copy engine, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// The same with an L2 evict-first hint, for data read once per use (the
// trial side: each pass of a tile streams it, and it should not displace
// the tap tiles that every block reads).
__device__ __forceinline__ void bulk_copy_once(void* dst, const void* src,
                                               int bytes,
                                               unsigned long long* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 pol;\n"
      "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], pol;\n"
      "}\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Order this thread's earlier memory accesses before later ones of the
// copy engine (the async proxy) that a barrier orders after them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// The ring's mbarriers of the HIGH form (kOne false) or of the DEFAULT
// form's engine (kOne: SmemX1 on the same shared memory), by thread 0 at
// the start of a launch (before a barrier).  ring (every thread's) counts
// the steps the ring has served.
template <bool kOne = false>
__device__ __forceinline__ void init_ring(SmemX3& sm, int& ring) {
  ring = 0;
  if (threadIdx.x == 0) {
    if constexpr (kOne) {
      SmemX1& s1 = reinterpret_cast<SmemX1&>(sm);
      for (int s = 0; s < kStagesX1; ++s) mbar_init(&s1.full[s]);
    } else {
      for (int s = 0; s < kStagesX3; ++s) mbar_init(&sm.full[s]);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}


// bf16 hi and lo parts of (x0, x1), each packed as a pair (x0 in the low
// half, the lower k first in memory).
__device__ __forceinline__ void split_pair(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  const __nv_bfloat16 l0 = __float2bfloat16_rn(x0 - __bfloat162float(h0));
  const __nv_bfloat16 l1 = __float2bfloat16_rn(x1 - __bfloat162float(h1));
  hi = static_cast<unsigned>(__bfloat16_as_ushort(h0)) |
       (static_cast<unsigned>(__bfloat16_as_ushort(h1)) << 16);
  lo = static_cast<unsigned>(__bfloat16_as_ushort(l0)) |
       (static_cast<unsigned>(__bfloat16_as_ushort(l1)) << 16);
}

// Where part h (0 hi, 1 lo) of (operand o, trial m of the block, k) lies in
// a block's split operand of ksteps k16 steps (3 ksteps kSplitStep bf16).
__device__ __forceinline__ size_t split_at(int ksteps, int o, int m, int k,
                                           int h) {
  return static_cast<size_t>(o * ksteps + (k >> 4)) * kSplitStep +
         m * (2 * kBK) + x3_chunk(2 * h + ((k & 15) >> 3), m) * 8 + (k & 7);
}

// Where (operand o, trial m of the block, k) lies in a block's DEFAULT
// split operand of ksteps k16 steps (3 ksteps kSplitStep1 bf16): the hi
// part alone, rows of 16 bf16 (x1_chunk).
__device__ __forceinline__ size_t split1_at(int ksteps, int o, int m, int k) {
  return static_cast<size_t>(o * ksteps + (k >> 4)) * kSplitStep1 +
         m * kBK + x1_chunk((k & 15) >> 3, m) * 8 + (k & 7);
}

// Writes the complex values u0 at k and u1 at k + 1 (k even) of trial m
// into the split operand xs: the bf16 hi and lo of a + b (summed in FP32),
// of a and of b, as the all-at-once tile split them; kOne (DEFAULT) the hi
// parts alone, in the one-pass engine's layout.
template <bool kOne = false>
__device__ __forceinline__ void store_split(__nv_bfloat16* xs, int ksteps,
                                            int m, int k, float2 u0,
                                            float2 u1) {
  unsigned hi[3], lo[3];
  split_pair(u0.x + u0.y, u1.x + u1.y, hi[0], lo[0]);
  split_pair(u0.x, u1.x, hi[1], lo[1]);
  split_pair(u0.y, u1.y, hi[2], lo[2]);
  if constexpr (kOne) {
#pragma unroll
    for (int o = 0; o < 3; ++o)
      *reinterpret_cast<unsigned*>(xs + split1_at(ksteps, o, m, k)) = hi[o];
    return;
  }
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    *reinterpret_cast<unsigned*>(xs + split_at(ksteps, o, m, k, 0)) = hi[o];
    *reinterpret_cast<unsigned*>(xs + split_at(ksteps, o, m, k, 1)) = lo[o];
  }
}

// Writes the columns k0 <= k < 16 ksteps (k0 even) of the trials m < nrows
// into the split operand xs: X[m ld + k] (complex) for k < K, zeros beyond
// (the pad, which the zero tap pad multiplies).
template <bool kOne = false>
__device__ __forceinline__ void split_rows(const float2* X, int ld, int K,
                                           int k0, int nrows, int ksteps,
                                           __nv_bfloat16* xs) {
  const int pairs = (ksteps * kBK - k0) / 2;
  const float2 z = make_float2(0.f, 0.f);
  for (int item = threadIdx.x; item < nrows * pairs; item += kThreads) {
    const int m = item / pairs, k = k0 + 2 * (item % pairs);
    const float2* x = X + static_cast<size_t>(m) * ld;
    store_split<kOne>(xs, ksteps, m, k, k < K ? x[k] : z,
                      k + 1 < K ? x[k + 1] : z);
  }
}

// Two neighbouring complex elements of a plane, and such pairs of two
// planes.
struct Pair {
  float2 u0, u1;
};
struct Pair2 {
  Pair a, b;
};
// The pair at element e of a plane whose pairs are 16-byte aligned when
// aligned is true (rows of even length).
__device__ __forceinline__ Pair load_pair(const float2* x, size_t e,
                                          bool aligned) {
  if (aligned) {
    const float4 v = *reinterpret_cast<const float4*>(x + e);
    return {make_float2(v.x, v.y), make_float2(v.z, v.w)};
  }
  return {x[e], x[e + 1]};
}
__device__ __forceinline__ void store_pair(float2* x, size_t e, Pair v,
                                           bool aligned) {
  if (aligned) {
    *reinterpret_cast<float4*>(x + e) =
        make_float4(v.u0.x, v.u0.y, v.u1.x, v.u1.y);
  } else {
    x[e] = v.u0;
    x[e + 1] = v.u1;
  }
}

// An elementwise pass over the N elements of each active trial of the
// block by pairs (k, k + 1), k even, that also splits the new values into
// the split operand xs of ksteps k16 steps: v = load(m, e, last) for
// kUnroll pairs, then store(m, e, v, last), which stores the new pair and
// returns it; last marks the lone element at the end of an odd row (its
// partner splits as zero and is neither loaded nor stored).  Consecutive
// threads take consecutive pairs of the block's (trial, pair) items, so
// the loads of kUnroll pairs a thread are in flight at once across the
// rows (a walk over the rows one after the other, as for_each_row_element
// does, left two pairs a thread in flight and waited on every row).
template <int kUnroll, bool kOne, class Load, class Store>
__device__ __forceinline__ void for_each_split_pair(int nrows, int N,
                                                    int ksteps, const int* act,
                                                    __nv_bfloat16* xs,
                                                    Load load, Store store) {
  const int pairs = (N + 1) / 2;
  const int items = nrows * pairs;
  for (int i0 = threadIdx.x; i0 < items; i0 += kUnroll * kThreads) {
    decltype(load(0, 0, false)) v[kUnroll];
    int mk[kUnroll][2];  // (m, k) of each pair; m = -1: none
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int item = i0 + u * kThreads;
      const int m = item / pairs, k = 2 * (item - m * pairs);
      mk[u][0] = item < items && act[m] ? m : -1;
      mk[u][1] = k;
      if (mk[u][0] >= 0)
        v[u] = load(m, static_cast<size_t>(m) * N + k, k + 1 == N);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int m = mk[u][0], k = mk[u][1];
      if (m < 0) continue;
      const Pair x = store(m, static_cast<size_t>(m) * N + k, v[u],
                           k + 1 == N);
      store_split<kOne>(xs, ksteps, m, k, x.u0,
                        k + 1 < N ? x.u1 : make_float2(0.f, 0.f));
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a b for one m16n8k16 tile: a the 16 x 16 row-major fragment, (b0,
// b1) the 16 x 8 column fragment, d FP32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where output (j, e) of a thread's HIGH tile lies: trial x3_row(e) of the
// block and column x3_col(n0, j, e), j < kNB3 (the mma accumulator layout:
// rows g and g + 8, columns 2t and 2t + 1 of each n8 block, g = lane / 4,
// t = lane % 4).
__device__ __forceinline__ int x3_row(int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return 16 * (warp & 3) + (lane >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int x3_col(int n0, int j, int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return n0 + kBN3 / 2 * (warp >> 2) + 8 * j + 2 * (lane & 3) + (e & 1);
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

// Column of output (j, e) of a thread's DEFAULT tile (rows as x3_row).
__device__ __forceinline__ int x1_col(int n0, int j, int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return n0 + kBNX1 / 2 * (warp >> 2) + 8 * j + 2 * (lane & 3) + (e & 1);
}

// d = a b for one m16n8k16 tile from a zero accumulator (the C operand
// one register holding +0, so no accumulator is zeroed per call): the
// same result as mma_bf16 on d = 0.
__device__ __forceinline__ void mma_bf16_z(float (&d)[4],
                                           const unsigned (&a)[4],
                                           unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// The DEFAULT form's complex product (the one-pass engine above), with
// product_x3's contract: A the block's DEFAULT split operand xs (ksteps
// k16 steps, split1_at), T the DEFAULT tap tiles (tap_tiles1_size(ncols,
// ksteps) bf16), epi(m, n, cr0, ci0, cr1, ci1) for each thread's pairs of
// outputs, ring the slots served.  Tile t, pass g, slot c (k16 steps c
// kSlotSteps on) run in that order; thread 0 issues the copies of the slot
// kStagesX1 - 1 ahead after each slot's barrier.
template <class Epi>
__device__ __forceinline__ void product_x1(
    const __nv_bfloat16* xs, int ksteps,
    const __nv_bfloat16* __restrict__ taps, int ncols, SmemX1& sm, int& ring,
    Epi epi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int slots = (ksteps + kSlotSteps - 1) / kSlotSteps;
  const int tiles = (ncols + kBNX1 - 1) / kBNX1;
  const int total = tiles * 3 * slots;
  // thread 0: the copies of ring slot f (tile t, pass g, slot c of the
  // pass) into its place, the pass's last slot holding what is left of K
  auto load = [&](int t, int g, int c, int f) {
    const int slot = (ring + f) % kStagesX1;
    const int s0 = c * kSlotSteps, n = min(kSlotSteps, ksteps - s0);
    StageX1& st = sm.st[slot];
    mbar_expect(&sm.full[slot], n * (kSlotBytesA + kSlotBytesB));
    bulk_copy_once(st.a[0],
                   xs + static_cast<size_t>(g * ksteps + s0) * kSplitStep1,
                   n * kSlotBytesA, &sm.full[slot]);
    bulk_copy(st.b[0],
              taps + (static_cast<size_t>(g * tiles + t) * ksteps + s0) *
                         kTapStep1,
              n * kSlotBytesB, &sm.full[slot]);
  };
  auto next = [&](int& t, int& g, int& c) {
    if (++c == slots) {
      c = 0;
      if (++g == 3) {
        g = 0;
        ++t;
      }
    }
  };
  int lt = 0, lg = 0, lc = 0;  // thread 0: the next (tile, pass, slot)
  fence_proxy_async();  // this thread's writes of xs before the copies
  __syncthreads();  // everyone's, and the previous product's ring reads
  if (tid == 0) {
    for (int f = 0; f < kStagesX1 - 1 && f < total; ++f) {
      load(lt, lg, lc, f);
      next(lt, lg, lc);
    }
  }
  // ldmatrix rows: A rows 16 wm + lane % 16, chunk lane / 16; taps rows
  // kBNX1 / 2 wn + 16 q + lane % 8 + 8 (lane / 16), chunk (lane / 8) % 2
  // (the row's swizzle does not change with q; the .x2 of an odd last n8
  // block reads lanes 0-15's rows)
  const int ar = 16 * wm + (lane & 15), ac = lane >> 4;
  const int br = kBNX1 / 2 * wn + (lane & 7) + ((lane >> 4) << 3);
  const int bc = (lane >> 3) & 1;
  const int a_at = ar * kBK + x1_chunk(ac, ar) * 8;
  const int b_at = br * kBK + x1_chunk(bc, br) * 8;
  float acc[kNB1][4];
  int f = 0;  // the slot being computed, over every tile and pass
  for (int t = 0; t < tiles; ++t) {
    for (int g = 0; g < 3; ++g) {
#pragma unroll
      for (int j = 0; j < kNB1; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      for (int c = 0; c < slots; ++c, ++f) {
        const int slot = (ring + f) % kStagesX1;
        mbar_wait(&sm.full[slot], ((ring + f) / kStagesX1) & 1);
        __syncthreads();  // every warp is done with slot f - 1
        if (tid == 0 && f + kStagesX1 - 1 < total) {
          load(lt, lg, lc, f + kStagesX1 - 1);
          next(lt, lg, lc);
        }
        const StageX1& st = sm.st[slot];
        const int n = min(kSlotSteps, ksteps - c * kSlotSteps);
#pragma unroll
        for (int s = 0; s < kSlotSteps; ++s) {
          if (s >= n) break;
          unsigned ah[4];
          ldmatrix_x4(ah, st.a[s] + a_at);
          // each k16 step's product from zero, then an FP32 add: the
          // tensor cores truncate as they add into an accumulator
#pragma unroll
          for (int q = 0; q < kNB1 / 2; ++q) {
            unsigned bh[4];
            ldmatrix_x4(bh, st.b[s] + b_at + q * 16 * kBK);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float th[4];
              mma_bf16_z(th, ah, bh[2 * h], bh[2 * h + 1]);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[2 * q + h][e] = acc[2 * q + h][e] + th[e];
            }
          }
          if constexpr (kNB1 % 2 == 1) {
            unsigned bh[2];
            ldmatrix_x2(bh, st.b[s] + b_at + kNB1 / 2 * 16 * kBK);
            float th[4];
            mma_bf16_z(th, ah, bh[0], bh[1]);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[kNB1 - 1][e] = acc[kNB1 - 1][e] + th[e];
          }
        }
      }
      // the end of pass g: k1 parked, k1 + k2 beside it, re = k1 - k3
#pragma unroll
      for (int j = 0; j < kNB1; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          if (g == 0) {
            sm.park[0][i][tid] = acc[j][e];
          } else if (g == 1) {
            sm.park[1][i][tid] = sm.park[0][i][tid] + acc[j][e];
          } else {
            acc[j][e] = sm.park[0][i][tid] - acc[j][e];
          }
        }
    }
    // re in acc, im in the park; e = 0, 1 and e = 2, 3 are column pairs
#pragma unroll
    for (int j = 0; j < kNB1; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int n = x1_col(t * kBNX1, j, e);
        if (n < ncols)
          epi(x3_row(e), n, acc[j][e], sm.park[1][4 * j + e][tid],
              acc[j][e + 1], sm.park[1][4 * j + e + 1][tid]);
      }
  }
  ring += total;
}

// A complex product of the block's trials in the HIGH form, every column
// tile, computed by the whole block:
//
//   (cr + i ci)[m][n] = sum_k A[m][k] * T[k][n],  n < ncols
//
// with A the block's split operand xs (ksteps k16 steps) and T the tap
// tiles `taps` (tap_tiles_size(ncols, ksteps) bf16).  For each thread's
// pair of outputs (m, n) and (m, n + 1), n even, n < ncols, m < kBt, calls
// epi(m, n, cr0, ci0, cr1, ci1); n + 1 may be ncols.  The trials of xs the
// launch did not write give outputs the caller drops.  xs may have been
// written earlier in this launch by this block; the taps are read-only.
// ring counts the steps served (init_ring).  kOne: the DEFAULT form's one
// pass, k_g = hi.hi, on its own engine (product_x1: hi-only operands and
// taps, wider tiles) over the same shared memory, seen as SmemX1.
template <bool kOne = false, class Epi>
__device__ __forceinline__ void product_x3(
    const __nv_bfloat16* xs, int ksteps,
    const __nv_bfloat16* __restrict__ taps, int ncols, SmemX3& sm, int& ring,
    Epi epi) {
  if constexpr (kOne) {
    product_x1(xs, ksteps, taps, ncols, reinterpret_cast<SmemX1&>(sm), ring,
               epi);
    return;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int steps = ksteps;  // k16 steps of a pass
  const int tiles = (ncols + kBN3 - 1) / kBN3;
  const int total = tiles * 3 * steps;
  // thread 0: the copies of step f (tile t, pass g, k step s) into its slot
  auto load = [&](int t, int g, int s, int f) {
    const int slot = (ring + f) % kStagesX3;
    StageX3& st = sm.st[slot];
    mbar_expect(&sm.full[slot], 2 * (kSplitStep + kTapStep));
    bulk_copy_once(st.a,
                   xs + static_cast<size_t>(g * ksteps + s) * kSplitStep,
                   2 * kSplitStep, &sm.full[slot]);
    bulk_copy(st.b,
              taps + (static_cast<size_t>(g * tiles + t) * ksteps + s) *
                         kTapStep,
              2 * kTapStep, &sm.full[slot]);
  };
  auto next = [&](int& t, int& g, int& s) {
    if (++s == steps) {
      s = 0;
      if (++g == 3) {
        g = 0;
        ++t;
      }
    }
  };
  int lt = 0, lg = 0, ls = 0;  // thread 0: the next (tile, pass, step)
  fence_proxy_async();  // this thread's writes of xs before the copies
  __syncthreads();  // everyone's, and the previous product's ring reads
  if (tid == 0) {
    for (int f = 0; f < kStagesX3 - 1 && f < total; ++f) {
      load(lt, lg, ls, f);
      next(lt, lg, ls);
    }
  }
  // ldmatrix rows: A rows 16 wm + lane % 16, chunk lane / 16 (hi; lo 2
  // further); taps rows 48 wn + 16 q + lane % 8 + 8 (lane / 16), chunk
  // (lane / 8) % 2 (the row's swizzle does not change with q)
  const int ar = 16 * wm + (lane & 15), ac = lane >> 4;
  const int br = kBN3 / 2 * wn + (lane & 7) + ((lane >> 4) << 3);
  const int bc = (lane >> 3) & 1;
  const int a_hi = ar * 2 * kBK + x3_chunk(ac, ar) * 8;
  const int a_lo = ar * 2 * kBK + x3_chunk(ac + 2, ar) * 8;
  const int b_hi = br * 2 * kBK + x3_chunk(bc, br) * 8;
  const int b_lo = br * 2 * kBK + x3_chunk(bc + 2, br) * 8;
  float hh[kNB3][4], cx[kNB3][4];
  int f = 0;  // the step being computed, over every tile and pass
  for (int t = 0; t < tiles; ++t) {
    for (int g = 0; g < 3; ++g) {
#pragma unroll
      for (int j = 0; j < kNB3; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hh[j][e] = cx[j][e] = 0.f;
      for (int s = 0; s < steps; ++s, ++f) {
        const int slot = (ring + f) % kStagesX3;
        mbar_wait(&sm.full[slot], ((ring + f) / kStagesX3) & 1);
        __syncthreads();  // every warp is done with step f - 1's slot
        if (tid == 0 && f + kStagesX3 - 1 < total) {
          load(lt, lg, ls, f + kStagesX3 - 1);
          next(lt, lg, ls);
        }
        const StageX3& st = sm.st[slot];
        unsigned ah[4], al[4];
        ldmatrix_x4(ah, st.a + a_hi);
        ldmatrix_x4(al, st.a + a_lo);
#pragma unroll
        for (int q = 0; q < kNB3 / 2; ++q) {
          unsigned bh[4], bl[4];
          ldmatrix_x4(bh, st.b + b_hi + q * 16 * 2 * kBK);
          ldmatrix_x4(bl, st.b + b_lo + q * 16 * 2 * kBK);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = 2 * q + h;
            // this k16 step's hi.hi from zero, then an FP32 add: the
            // tensor cores truncate as they add into an accumulator
            float th[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(th, ah, bh[2 * h], bh[2 * h + 1]);
            mma_bf16(cx[j], ah, bl[2 * h], bl[2 * h + 1]);
            mma_bf16(cx[j], al, bh[2 * h], bh[2 * h + 1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) hh[j][e] = hh[j][e] + th[e];
          }
        }
      }
      // the end of pass g: k_g = hi.hi + (hi.lo + lo.hi), as dot3 groups it
#pragma unroll
      for (int j = 0; j < kNB3; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float k = hh[j][e] + cx[j][e];
          if (g == 0) {
            sm.park[0][i][tid] = k;
          } else if (g == 1) {
            sm.park[1][i][tid] = sm.park[0][i][tid] + k;
          } else {
            hh[j][e] = sm.park[0][i][tid] - k;
            cx[j][e] = sm.park[1][i][tid];
          }
        }
    }
    // re in hh, im in cx; e = 0, 1 and e = 2, 3 are column pairs
#pragma unroll
    for (int j = 0; j < kNB3; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int n = x3_col(t * kBN3, j, e);
        if (n < ncols)
          epi(x3_row(e), n, hh[j][e], cx[j][e], hh[j][e + 1], cx[j][e + 1]);
      }
  }
  ring += total;
}

// The row sum the HIGH kernels write as a product with ones (JAX's
// dot(x, ones) under dot3): the ones split to hi = 1, lo = 0, so it is
// sum(hi) + sum(lo), each in PyTorch's CUDA reduction order (as
// precision.rowsum3 forms it), by a whole warp.
template <class Get>
__device__ __forceinline__ float warp_rowsum3(int n, bool vec4, Get get) {
  const float s_hi = warp_torch_sum(n, vec4, [&](int k) {
    return __bfloat162float(__float2bfloat16_rn(get(k)));
  });
  const float s_lo = warp_torch_sum(n, vec4, [&](int k) {
    const float x = get(k);
    return __bfloat162float(
        __float2bfloat16_rn(x - __bfloat162float(__float2bfloat16_rn(x))));
  });
  return s_hi + s_lo;
}

// The row sum the DEFAULT kernels write as a product with ones (JAX's
// dot(x, ones) under one bf16 pass): sum(hi), in PyTorch's CUDA reduction
// order (as precision.rowsum1 forms it), by a whole warp.
template <class Get>
__device__ __forceinline__ float warp_rowsum1(int n, bool vec4, Get get) {
  return warp_torch_sum(n, vec4, [&](int k) {
    return __bfloat162float(__float2bfloat16_rn(get(k)));
  });
}

// The row sum of the HIGH (kOne false) or the DEFAULT (kOne) form.
template <bool kOne, class Get>
__device__ __forceinline__ float warp_rowsum(int n, bool vec4, Get get) {
  if constexpr (kOne)
    return warp_rowsum1(n, vec4, get);
  else
    return warp_rowsum3(n, vec4, get);
}

// The planes of one lane the denoiser reads: the pseudo-data x, the old
// variance and (vamp2's damping) the old mean.
struct LanePlanes {
  float2 x;
  float var;
  float2 xm;
};

// The denoiser: the posterior of every segment of M lanes of the block's
// active trials under the one-active-per-segment prior with effective
// noise tau[m], WITHOUT the tau/2 halving of BAMP and SCAMP, as the plain
// version's segmented_posterior(halve_tau=False) computes it: t = Re((x /
// tau) conj(s)), the segment max, exp, the sums in PyTorch's order, the
// mean and the variance, decomposed (kSecondMoment false, VAMP) or second
// moment sum |s|^2 eta / eta2 - |mean|^2 (vamp2).  load(j) returns the
// LanePlanes at flat offset j = m N + lane of the block's planes;
// store(j, mean_re, mean_im, var, d) stores the lane (d its load) and
// returns 1 when its variance fails the allclose test against the old one;
// bad[m] (zeroed by the caller before a barrier) is set where one did.
//
// Thread map: a group of G = min(last_pow2(M), 32) lanes per segment
// (torch_sum's lane count for M terms), consecutive groups on consecutive
// segments, so a warp's loads are consecutive elements; lane t of a group
// takes the segment's elements t, t + G, ..., folds their eta into four
// accumulators in turn and the group joins them in torch_sum's tree by
// shuffles (lane_sum's order, bit for bit); the segment max is joined the
// same way (max is exact in any order).  The lane's first element (its
// only one where G = M) is loaded once, into registers, a round ahead, and
// its division by tau and its eta are kept.  A thread per segment, walking
// its M lanes one after the other with every element loaded three times
// (the map this one replaced), ran the denoiser at about 0.27 TB/s of its
// bytes: half of the DEFAULT decode's time at the main path
// (tests/torch_vamp_probes.py nodenoise, PERF.md).
template <bool kSecondMoment, class Load, class Store>
__device__ __forceinline__ void denoise_segments(
    int nrows, int N, int M, int K, const float* sr, const float* si,
    const int* act, const float* tau, int* bad, Load load, Store store) {
  const int G = M >= 32 ? 32 : decode::last_pow2(M);
  const int t = threadIdx.x & (G - 1);
  const int nseg = N / M, items = nrows * nseg;
  const int per = kThreads / G;  // segments of one round of the block
  // the lane's first element of segment item, where that trial is decoded
  auto first = [&](int item) {
    LanePlanes d{};
    if (item < items && act[item / nseg])
      d = load(static_cast<size_t>(item) * M + t);
    return d;
  };
  LanePlanes next = first(static_cast<int>(threadIdx.x) / G);
  for (int base = 0; base < items; base += per) {
    const int item = base + static_cast<int>(threadIdx.x) / G;
    const LanePlanes d0 = next;
    next = first(item + per);
    // a group's lanes agree on ok; the shuffles run on every lane
    const bool ok = item < items && act[item / nseg];
    if (!__any_sync(0xffffffffu, ok)) continue;
    const int m = ok ? item / nseg : 0;
    const size_t j0 = static_cast<size_t>(ok ? item : 0) * M;
    const float tm = ok ? tau[m] : 1.f;
    const float xr0 = d0.x.x / tm, xi0 = d0.x.y / tm;
    auto t_of = [&](int i, int q) {
      if (i == t) return re_conj_mul(xr0, xi0, sr[q], si[q]);
      const float2 v = load(j0 + i).x;
      return re_conj_mul(v.x / tm, v.y / tm, sr[q], si[q]);
    };
    float mx = -INFINITY;
    for (int i = t; i < M; i += G)
      for (int q = 0; q < K; ++q) mx = fmaxf(mx, t_of(i, q));
    for (int off = G / 2; off >= 1; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, G));
    auto eta = [&](int i, int q) {
      return expf(fminf(t_of(i, q) - mx, kExpMax));
    };
    auto eta_m = [&](int i) {
      return K == 1 ? eta(i, 0)
                    : torch_sum(K, [&](int q) { return eta(i, q); });
    };
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    float eta_t = 0.f;  // eta_m of the lane's first element
    for (int i = t, s = 0; i < M; i += G, ++s) {
      const float e = eta_m(i);
      if (s == 0) eta_t = e;
      switch (s & 3) {
        case 0: acc[0] = acc[0] + e; break;
        case 1: acc[1] = acc[1] + e; break;
        case 2: acc[2] = acc[2] + e; break;
        default: acc[3] = acc[3] + e; break;
      }
    }
    float sum = ((acc[0] + acc[1]) + acc[2]) + acc[3];
    for (int off = G / 2; off >= 1; off >>= 1)
      sum = sum + __shfl_down_sync(0xffffffffu, sum, off, G);
    const float eta2 = __shfl_sync(0xffffffffu, sum, 0, G);
    if (!ok) continue;
    int flag = 0;
    for (int i = t; i < M; i += G) {
      float mr, mi, vn;
      if (K == 1) {
        const float post = (i == t ? eta_t : eta(i, 0)) / eta2;
        mr = sr[0] * post;
        mi = si[0] * post;
        vn = kSecondMoment ? abs2(sr[0], si[0]) * post - abs2(mr, mi)
                           : abs2(mr, mi) * (1.f - post) +
                                 abs2(mr - sr[0], mi - si[0]) * post;
      } else {
        mr = torch_sum(K, [&](int q) { return sr[q] * eta(i, q); }) / eta2;
        mi = torch_sum(K, [&](int q) { return si[q] * eta(i, q); }) / eta2;
        if (kSecondMoment) {
          vn = torch_sum(K, [&](int q) {
                 return abs2(sr[q], si[q]) * eta(i, q);
               }) / eta2 -
               abs2(mr, mi);
        } else {
          const float var0 = abs2(mr, mi) * (1.f - eta_m(i) / eta2);
          const float vs = torch_sum(K, [&](int q) {
            return abs2(mr - sr[q], mi - si[q]) * eta(i, q);
          });
          vn = var0 + vs / eta2;
        }
      }
      flag |= store(j0 + i, mr, mi, vn, i == t ? d0 : load(j0 + i));
    }
    if (flag) bad[m] = 1;  // every writer stores the same 1
  }
}

// An elementwise pass over the N elements of each active trial of the
// block: v = load(m, e), then store(m, e, v), for the flat offsets e of
// trial m, with kUnroll elements of a row loaded per thread before any is
// stored (the state planes may alias, so the compiler would not overlap
// the elements' loads by itself).
template <int kUnroll, class Load, class Store>
__device__ __forceinline__ void for_each_row_element(int nrows, int N,
                                                     const int* act,
                                                     Load load, Store store) {
  for (int m = 0; m < nrows; ++m) {
    if (!act[m]) continue;
    const size_t e0 = static_cast<size_t>(m) * N;
    for (int j0 = threadIdx.x; j0 < N; j0 += kUnroll * kThreads) {
      decltype(load(m, e0)) v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (j0 + u * kThreads < N) v[u] = load(m, e0 + j0 + u * kThreads);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (j0 + u * kThreads < N) store(m, e0 + j0 + u * kThreads, v[u]);
    }
  }
}

// Mean of get(0 .. n-1) as PyTorch's CUDA mean over a contiguous last
// dimension computes it: the sum in its reduction order (one warp, loads
// vectorized by four when vec4), times the float reciprocal inv_n.  Called
// by all 32 lanes of a warp; the result is on every lane.
template <class Get>
__device__ __forceinline__ float warp_torch_mean(int n, bool vec4,
                                                 float inv_n, Get get) {
  return warp_torch_sum(n, vec4, get) * inv_n;
}

// 1 when new differs from old beyond torch.allclose(rtol=1e-5, atol=1e-8)
// (NaN included).
__device__ __forceinline__ int not_close(float nw, float old) {
  return !(fabsf(nw - old) <= kAtol + kRtol * fabsf(old));
}

}  // namespace vamp
