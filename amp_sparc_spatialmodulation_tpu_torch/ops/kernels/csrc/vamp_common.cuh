// Device code shared by the whole-decode VAMP kernels (fused_vamp_decode.cu,
// fused_vamp2_decode.cu): the tile of trials a block owns, the complex
// products of that tile's rows with the SVD factor Vh (register tiles over
// a cp.async ring in shared memory), and the segmented softmax posterior
// without the tau/2 halving in both variance forms.  It takes the sums,
// |x|^2 and the complex product of decode_common.cuh (shared with the BAMP
// and SCAMP kernels) and changes nothing there, so those kernels compile as
// before.
#pragma once

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

// Ask for the 128-byte lines of n values at p in L1, without waiting.
template <class T>
__device__ __forceinline__ void prefetch_l1(const T* p, int n) {
  const char* c = reinterpret_cast<const char*>(p);
  for (int b = 0; b < n * static_cast<int>(sizeof(T)); b += 128)
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(c + b));
}

// The denoiser's thread map: one thread per (trial, segment of M lanes) of
// the block's nrows trials, trials with act[m] == 0 skipped.  seg(m, j0)
// runs the segment at flat offset j0 of the block's planes and returns its
// allclose flag, which is ORed into bad[m] (zeroed by the caller before a
// barrier); touch(j0) asks for the planes of the thread's next segment
// while this one runs (a segment is a chain of dependent steps that would
// otherwise stall on its first read from device memory).
template <class Seg, class Touch>
__device__ __forceinline__ void for_each_segment(int nrows, int N, int M,
                                                 const int* act, int* bad,
                                                 Seg seg, Touch touch) {
  const int nseg = N / M, items = nrows * nseg;
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int m = item / nseg;
    if (item + kThreads < items)
      touch(static_cast<size_t>(item + kThreads) * M);
    if (!act[m]) continue;
    const size_t j0 = static_cast<size_t>(item) * M;
    if (seg(m, j0)) atomicOr(bad + m, 1);
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

// Posterior of the segment of M lanes x[0 .. M-1] (complex pseudo-data in
// device memory) under the one-active-per-segment prior with effective
// noise tau, WITHOUT the tau/2 halving of BAMP and SCAMP, as the plain
// version's segmented_posterior(halve_tau=False) computes it: t = Re((x /
// tau) conj(s)), the segment max, exp, the sums in PyTorch's order, the
// mean and the variance — decomposed (kSecondMoment false, VAMP) or
// second moment sum |s|^2 eta / eta2 - |mean|^2 (vamp2).  Calls emit(i,
// mean_re, mean_im, var) for every lane, which stores the lane and returns
// 1 when its variance fails the allclose test against the old one; returns
// the OR of those.  Kept out of line with a callback that captures by
// value, as decode_common.cuh keeps its posterior, so that the product
// loops' registers are allocated on their own.
template <bool kSecondMoment, class Emit>
__device__ __noinline__ int segment_posterior(
    int M, int K, const float* sr, const float* si, const float2* x,
    float tau, Emit emit) {
  auto t_of = [&](int i, int q) {
    const float2 v = x[i];
    return re_conj_mul(v.x / tau, v.y / tau, sr[q], si[q]);
  };
  float segmax = -INFINITY;
  for (int i = 0; i < M; ++i)
    for (int q = 0; q < K; ++q) segmax = fmaxf(segmax, t_of(i, q));
  auto eta = [&](int i, int q) {
    return expf(fminf(t_of(i, q) - segmax, kExpMax));
  };
  auto eta_m = [&](int i) {
    return K == 1 ? eta(i, 0)
                  : torch_sum(K, [&](int q) { return eta(i, q); });
  };
  const float eta2 = torch_sum(M, eta_m);
  int bad = 0;
  for (int i = 0; i < M; ++i) {
    float mr, mi, vn;
    if (K == 1) {
      const float post = eta(i, 0) / eta2;
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
    bad |= emit(i, mr, mi, vn);
  }
  return bad;
}

// 1 when new differs from old beyond torch.allclose(rtol=1e-5, atol=1e-8)
// (NaN included).
__device__ __forceinline__ int not_close(float nw, float old) {
  return !(fabsf(nw - old) <= kAtol + kRtol * fabsf(old));
}

}  // namespace vamp
