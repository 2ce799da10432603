// Device code shared by the whole-decode VAMP kernels (fused_vamp_decode.cu,
// fused_vamp2_decode.cu): the tile of trials a block owns, the complex
// products of that tile's rows with the SVD factor Vh through shared
// memory, and the segmented softmax posterior without the tau/2 halving in
// both variance forms.  It takes the sums, |x|^2 and the complex product
// of decode_common.cuh (shared with the BAMP and SCAMP kernels) and changes
// nothing there, so those kernels compile as before.
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
constexpr int kBt = 64;   // trials of one block: the rows of every product
constexpr int kBN = 64;   // columns of one product tile
constexpr int kBK = 16;   // contraction depth staged in shared memory
constexpr int kGroup = kThreads / kBt;  // threads per trial in the denoiser

// Shared memory of one block (dynamic, kSmemBytes): the operand tiles of
// one contraction step, a[k][m] (the A tile transposed, so a thread's four
// rows are one 32-byte read) and b[k][n], and each thread's running sums
// of the product tile it holds, sum[q][thread] (q < 16 real, q >= 16
// imaginary parts), laid out so that a warp's accesses hit 32 banks.
struct __align__(16) Smem {
  float2 a[kBK][kBt];
  float2 b[kBK][kBN];
  float sum[32][kThreads];
};
constexpr int kSmemBytes = static_cast<int>(sizeof(Smem));

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// One 64 x 64 tile of a complex product, computed by the whole block:
//
//   acc[m][n] = sum_k A[m][k] * B[k][n0 + n]
//
// for the rows m < nrows of A (row-major, leading dimension lda, the
// contraction index k < K contiguous) and the columns n0 + n < ncols.
// kFactorRows: B[k][n] = Bm[n * ldb + k], the rows of Bm are the output
// columns (q = r_tilde Vh^T); else B[k][n] = conj(Bm[k * ldb + n]), the rows
// of Bm are the contraction index (x = w conj(Vh)).  Thread (ty, tx) = (tid
// / 16, tid % 16) holds rows 4 ty .. 4 ty + 3 and columns n0 + 4 tx ..
// n0 + 4 tx + 3 in cr (real) and ci (imaginary).  Each K step of 16 is
// loaded from device memory into registers while the previous one is
// multiplied out of shared memory; out-of-range elements load as 0.
//
// The products are FP32 FMAs on the CUDA cores (the stop test needs full
// FP32, so no TF32 tensor cores), four real FMAs per complex multiply-add.
// The sum over k is blocked, as a library GEMM's is: each K step of 16 is
// a chain of FMAs from zero, and the steps' partial sums are added in turn
// to the running sums in shared memory.  A single chain over all of K
// (K = 2560 at the main path) rounds about three times as coarsely, and
// where trials stop by the allclose test on the posterior variance that
// coarseness shows: at the VAMPfinal geometry (N = 3200, cap 100) a single
// chain gave VAMP a mean T of 99.3, the blocked sum 85.5, cuBLAS 87.2 and
// a float64 decode 69.3 (PERF.md, tests/torch_vamp_precision.py).  A may
// have been written earlier in this launch, so it is read through plain
// loads; Bm (the factor) is read-only for the launch and goes through the
// read-only path.
template <bool kFactorRows>
__device__ __forceinline__ void product_tile(
    const float2* A, int lda, int nrows, const float2* __restrict__ Bm,
    int ldb, int ncols, int K, int n0, Smem& sm, float (&cr)[4][4],
    float (&ci)[4][4]) {
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  // loader coordinates: A (and B when kFactorRows) by row t % 64, four
  // consecutive k from 4 (t / 64); B otherwise by k row t / 16 and four
  // consecutive columns from 4 (t % 16)
  const int lm = tid & 63, lk = (tid >> 6) * 4;
  const int bk = tid >> 4, bn = (tid & 15) * 4;
  float2 ra[4], rb[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = k0 + lk + c;
      ra[c] = (lm < nrows && k < K) ? A[static_cast<size_t>(lm) * lda + k]
                                    : make_float2(0.f, 0.f);
      if (kFactorRows) {
        const int n = n0 + lm;
        rb[c] = (n < ncols && k < K)
                    ? __ldg(Bm + static_cast<size_t>(n) * ldb + k)
                    : make_float2(0.f, 0.f);
      } else {
        const int kr = k0 + bk, n = n0 + bn + c;
        const float2 v = (kr < K && n < ncols)
                             ? __ldg(Bm + static_cast<size_t>(kr) * ldb + n)
                             : make_float2(0.f, 0.f);
        rb[c] = make_float2(v.x, -v.y);
      }
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous step's reads of sm are done
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      sm.a[lk + c][lm] = ra[c];
      if (kFactorRows)
        sm.b[lk + c][lm] = rb[c];
      else
        sm.b[bk][bn + c] = rb[c];
    }
    __syncthreads();
    if (k0 + kBK < K) fetch(k0 + kBK);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cr[i][j] = ci[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4* ap = reinterpret_cast<const float4*>(&sm.a[kk][4 * ty]);
      const float4* bp = reinterpret_cast<const float4*>(&sm.b[kk][4 * tx]);
      const float4 a01 = ap[0], a23 = ap[1], b01 = bp[0], b23 = bp[1];
      const float ar[4] = {a01.x, a01.z, a23.x, a23.z};
      const float ai[4] = {a01.y, a01.w, a23.y, a23.w};
      const float br[4] = {b01.x, b01.z, b23.x, b23.z};
      const float bi[4] = {b01.y, b01.w, b23.y, b23.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cr[i][j] = fmaf(ar[i], br[j], cr[i][j]);
          cr[i][j] = fmaf(-ai[i], bi[j], cr[i][j]);
          ci[i][j] = fmaf(ar[i], bi[j], ci[i][j]);
          ci[i][j] = fmaf(ai[i], br[j], ci[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float& sr = sm.sum[4 * i + j][tid];
        float& si = sm.sum[16 + 4 * i + j][tid];
        sr = k0 == 0 ? cr[i][j] : sr + cr[i][j];
        si = k0 == 0 ? ci[i][j] : si + ci[i][j];
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cr[i][j] = sm.sum[4 * i + j][tid];
      ci[i][j] = sm.sum[16 + 4 * i + j][tid];
    }
}

// OR over the kGroup lanes that share one trial in the denoiser pass.
__device__ __forceinline__ int group_or(int v) {
  for (int off = 1; off < kGroup; off <<= 1)
    v |= __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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
