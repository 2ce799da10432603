// Whole SCAMP decode on an NVIDIA Hopper GPU: one thread block per trial,
// with the iteration loop inside the block.
//
// Replaces the TPU kernel amp_sparc_spatialmodulation_tpu/ops/pallas/
// fused_scamp.py::_scamp_decode_kernel (reached through
// FusedScampDecode.decode_call).  Each iteration of one trial runs
//
//   gma  = W psi / Lin                       (base matrix, small plane)
//   b    = gma / phi                         (0 while phi = inf)
//   z'   = y - A xmmse + b (x) z             (banded forward + Onsager)
//   phi' = sigma2 + gma,  or mean |z'|^2 per row block (estimate_phi)
//   tau  = L / (W^T (1/phi')) / Nr           (base matrix, small plane)
//   xmap = xmmse + tau (x) A^H (z' / phi')   (banded adjoint)
//
// then the mean-only segmented softmax denoiser (tau/2 calibration),
// psi' = 1 - sum |xmmse|^2 / Na per column block, and the per-trial
// allclose(rtol=1e-5, atol=1e-8) test on psi.  A trial stops at its own
// convergence; frozen trials pass through unchanged, so the per-trial T
// equals the plain loop's.  The TPU kernel's one-hot indicator matmuls
// (_expand_rows, _gather_rows) only avoided relayouts on the MXU: here row
// block r reads b[r] and phi[r], column block c reads tau[c].
//
// Bound on this card: FP32 operations.  At the main geometry (Nt=128,
// Nr=24, Lin=20, Lout=22, Lh=3, OOK) one iteration of one trial does 6
// real banded products (2 forward with a real x, 4 adjoint) of
// 2*Lin*Lh*Nt*Nr = 368,640 flop each, about 2.2 MFLOP, against ~53 KB of
// device-memory traffic per decoded trial: at 67 TFLOP/s FP32 and
// 3.35 TB/s that is ~33 ns per iteration per trial of compute against
// ~16 ns per trial of memory.  The design keeps every loop-carried plane
// of the trial in shared memory, reads the taps and W through the
// read-only path, and runs all arithmetic in FP32 on the CUDA cores (no
// TF32).  What keeps a kernel of this shape from that bound is the loads
// that feed the FMAs: a thread that computes one output issues a tap load
// and an x load for every one or two FMAs, and the load pipe saturates
// long before the FMA pipe.
//
// Register tiles over the block-Toeplitz taps, as in fused_bamp_decode.cu
// (the tile code is this file's own copy, cut to SCAMP's products): tap l
// couples source block c to row block c + l through the same Nr x Nt
// matrix h[l] for every c, with a scalar gain per (l, c) after the
// product, so each banded map is Lh small GEMMs that share their right
// operand across the Lin blocks.
//
// * forward: P[c, l, m] = sum_k x[c, k] h[l, m, k] for every placed
//   (c, l, m).  A thread owns one tap column (l, m) and kFR source blocks
//   c: per k it loads the tap once for its kFR rows and reads x[c,
//   k..k+3] as one 16-byte broadcast word of shared memory.  A real x
//   (OOK) carries two chains per row, a complex one the four-FMA step;
// * fold: a thread per kFO outputs (r, m), their chains interleaved, forms
//   the row sum hx = sum_l g[l, c] P[c, l, m] (c = r - l) and z' = (y - hx)
//   + b z.  Without estimate_phi
//   phi' = gma + sigma2 is known before the forward pass, so the same
//   thread then writes the gain-weighted adjoint inputs Z[c, l, m] =
//   g[l, c] (z' / phi') into the slots of the P it has just read (every
//   placed (c, l, m) belongs to exactly one output): P and Z share one
//   scratch area, and tau is formed during the forward pass by threads
//   the tiles leave idle.  With estimate_phi, phi' is the row block's mean
//   of |z'|^2, so those trials keep a pass for phi', then one for tau and
//   Z;
// * adjoint: a thread owns kAK x elements k of kAR column blocks c: per
//   antenna m it loads h[l, m, k] once for its kAR rows and reads Z[c, l,
//   m..m+3] as one broadcast word for its kAK elements;
// * denoiser: a segment of M lanes is handled by a group of as many lanes
//   as PyTorch's reduction uses for its segment sum (16 at M = 16), the
//   max and the sums joined by warp shuffles in PyTorch's order, every
//   per-lane array indexed statically so it stays in registers.
//
// The x-side pseudo-data's imaginary part goes straight to the output
// (only the denoisers of complex alphabets read it back), so the main
// geometry takes 40,784 B of shared memory (five blocks per SM fit; the
// registers are held to kMinBlocks blocks per SM).  The tile sizes are
// measured (PERF.md, tests/torch_k1_passes.py --kernel scamp --tiles): at
// Lin = 20, kFR = 7 gives three row groups (216 of 256 threads carry a
// forward tile) and kAR x kAK = 5 x 2 one round of adjoint tiles; taller
// tiles, 3 or 5 blocks per SM, and two tap columns per forward thread all
// ran slower.
//
// Rounding.  The stop test compares psi = 1 - sum |xmmse|^2 / Na, a small
// difference of numbers near 1, at rtol=1e-5, so a trial's T depends on
// the last bit of the 128-element block sum and of the two base-matrix
// products.  As in fused_bamp_decode.cu, the kernel rounds where the plain
// PyTorch version (plain_loop in models/scamp.py) rounds on the card:
// -fmad=false; the banded products are sequential FMA chains over the
// contraction index, the order cuBLAS's FP32 GEMMs take at the decode's
// batch sizes; the base-matrix products, which the plain version forms as
// a product and a sum (a small GEMM's order changes with the batch size),
// are rounded products summed in PyTorch's order; divisions where the plain
// version divides two tensors; a tensor divided by a Python number is
// multiplied by the float reciprocal the host passes (inv_Lc, inv_Mr,
// inv_Na), as PyTorch's CUDA division by a CPU scalar does; L / m is
// (1 / m) * L, as Tensor.__rdiv__ computes it; and every sum follows
// PyTorch's CUDA reduction order (decode_common.cuh), with the loads
// vectorized by four for the block sums of psi when the host says PyTorch
// does so (vec4_psi).  The tiles change which thread computes an output,
// never the order of its sum: the forward chain of each (c, l, m) runs
// over k = 0..Nt-1 from zero, real part before imaginary part; the row
// sum adds the taps in the order l = 0..Lh-1 from zero, skipping those
// that place no block; the adjoint chain of each (c, k) runs over (l, m)
// in order, and a tap that places no block (trunc) reads zero-filled slots,
// which leave a chain unchanged.  The kernel's state then matches the
// plain version's bit for bit, which chip_smoke.py checks on the card.
//
// Layouts: every state vector is per-trial contiguous, complex values
// interleaved (PyTorch complex64): x-side (B, Lin*Nt), y-side (B, Lout*Nr),
// psi (B, Lin), phi (B, Lout).  Taps come as h (Lh, Nr, Nt) for the
// adjoint and hT (Lh, Nt, Nr) for the forward; gains (Lh, Lin) and the
// base matrix W (Lout, Lin) are taken as they come.

#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFR = 7;         // forward: source blocks per thread
constexpr int kAR = 5;         // adjoint: column blocks per thread
constexpr int kAK = 2;         // adjoint: x elements per thread
constexpr int kMinBlocks = 4;  // blocks per SM the registers allow
constexpr int kFO = 3;         // fold: outputs per thread, interleaved

struct Params {
  const float2* y;
  const float2* xmap_in;
  const float2* xmmse_in;
  const float* psi_in;
  const float* phi_in;
  const float2* z_in;
  const int* act_in;
  const int* T_in;
  float2* xmap_out;
  float2* xmmse_out;
  float* psi_out;
  float* phi_out;
  float2* z_out;
  int* act_out;
  int* T_out;
  const float2* h;      // (Lh, Nr, Nt)
  const float2* hT;     // (Lh, Nt, Nr)
  const float* gains;   // (Lh, Lin)
  const float* W;       // (Lout, Lin)
  const float* sym_re;  // (K,)
  const float* sym_im;  // (K,)
  int Nt, Nr, Lin, Lout, Lh, trunc, M, K, real_x, estimate_phi, vec4_psi;
  float sigma2, L, inv_Lc, inv_Mr, inv_Na;
  int cap;  // remaining iteration budget
};

// Four consecutive floats of shared memory: one 16-byte load when the
// address is aligned (kVec), else four.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* p) {
  if (kVec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ float lane4(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// tau = L / (W^T (1/phi')) / Nr of column block c.
__device__ __forceinline__ float tau_of(const Params& p, const float* phi,
                                        int c) {
  const float m = torch_sum(p.Lout, [&](int r) {
    return (1.f / phi[r]) * __ldg(p.W + r * p.Lin + c);
  });
  return ((1.f / m) * p.L) * p.inv_Mr;
}

// Forward products.

// One step k of the chain of one (c, l, m): h x, real part first.
template <bool kReal>
__device__ __forceinline__ void fwd_step(float& pr, float& pi, float x,
                                         float xj, float2 hv) {
  pr = fmaf(x, hv.x, pr);
  if (!kReal) pr = fmaf(-xj, hv.y, pr);
  pi = fmaf(x, hv.y, pi);
  if (!kReal) pi = fmaf(xj, hv.x, pi);
}

// The products of column (l, m) of the tap stack with source blocks c0 ..
// c0+kFR-1, written to P[c, l, m] (the rows past Lin repeat the last one
// and are dropped, as are the blocks tap l places nowhere).
template <bool kVec, bool kReal>
__device__ __forceinline__ void forward_tile(const Params& p, int c0, int l,
                                             int m, const float* xm_re,
                                             const float* xm_im, float* Pr,
                                             float* Pi) {
  const float2* ht = p.hT + static_cast<size_t>(l) * p.Nt * p.Nr + m;
  int row[kFR];
#pragma unroll
  for (int i = 0; i < kFR; ++i) row[i] = min(c0 + i, p.Lin - 1) * p.Nt;
  float pr[kFR], pi[kFR];
#pragma unroll
  for (int i = 0; i < kFR; ++i) pr[i] = pi[i] = 0.f;
  int k = 0;
  for (; k + 4 <= p.Nt; k += 4) {
    float2 hv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) hv[q] = __ldg(ht + (k + q) * p.Nr);
#pragma unroll
    for (int i = 0; i < kFR; ++i) {
      const float4 x = load4<kVec>(xm_re + row[i] + k);
      const float4 xj = kReal ? make_float4(0.f, 0.f, 0.f, 0.f)
                              : load4<kVec>(xm_im + row[i] + k);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        fwd_step<kReal>(pr[i], pi[i], lane4(x, q), lane4(xj, q), hv[q]);
    }
  }
  for (; k < p.Nt; ++k) {
    const float2 hv = __ldg(ht + k * p.Nr);
#pragma unroll
    for (int i = 0; i < kFR; ++i)
      fwd_step<kReal>(pr[i], pi[i], xm_re[row[i] + k],
                      kReal ? 0.f : xm_im[row[i] + k], hv);
  }
#pragma unroll
  for (int i = 0; i < kFR; ++i) {
    const int c = c0 + i;
    if (c < p.Lin && dst_block(c, l, p) >= 0) {
      const int e = (c * p.Lh + l) * p.Nr + m;
      Pr[e] = pr[i];
      Pi[e] = pi[i];
    }
  }
}

// Adjoint products.

// One step (l, m) of the chain of one (c, k): h^H (zr + i zi).
__device__ __forceinline__ void adj_step(float& ar, float& ai, float zr,
                                         float zi, float2 hv) {
  // (zr + i zi) * conj(h)
  ar = fmaf(zr, hv.x, ar);
  ar = fmaf(-zi, -hv.y, ar);
  ai = fmaf(zr, -hv.y, ai);
  ai = fmaf(zi, hv.x, ai);
}

// Antennas m0 .. m0+3 of tap l (those below Nr when kTail) for the kAR
// column blocks whose Z rows start at zrow[i] and the kAK x elements
// kel[a]; kVec: 16-byte reads of Z (Nr % 4 == 0, so no tail).
template <bool kVec, bool kTail>
__device__ __forceinline__ void adjoint_quad(
    const Params& p, const float2* hl, int m0, const int (&zrow)[kAR],
    const int (&kel)[kAK], const float* Zr, const float* Zi,
    float (&ar)[kAR][kAK], float (&ai)[kAR][kAK]) {
  float2 hv[4][kAK];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = kTail ? min(m0 + q, p.Nr - 1) : m0 + q;
#pragma unroll
    for (int a = 0; a < kAK; ++a) hv[q][a] = __ldg(hl + m * p.Nt + kel[a]);
  }
#pragma unroll
  for (int i = 0; i < kAR; ++i) {
    float zr[4], zi[4];
    if (kVec) {
      const float4 a = *reinterpret_cast<const float4*>(Zr + zrow[i] + m0);
      const float4 b = *reinterpret_cast<const float4*>(Zi + zrow[i] + m0);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        zr[q] = lane4(a, q);
        zi[q] = lane4(b, q);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = !kTail || m0 + q < p.Nr;
        zr[q] = in ? Zr[zrow[i] + m0 + q] : 0.f;
        zi[q] = in ? Zi[zrow[i] + m0 + q] : 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (!kTail || m0 + q < p.Nr)
#pragma unroll
        for (int a = 0; a < kAK; ++a)
          adj_step(ar[i][a], ai[i][a], zr[q], zi[q], hv[q][a]);
  }
}

// The adjoint of the kAK x elements k0, k0 + KS, ... (those below Nt) of
// column blocks c0 .. c0+kAR-1 and the pseudo-data xmap = xmmse + tau A^H
// Z (its imaginary part to xmap_g, stride 2).
template <bool kVec>
__device__ __forceinline__ void adjoint_tile(
    const Params& p, int c0, int k0, int KS, const float* Zr,
    const float* Zi, const float* xm_re, const float* xm_im,
    const float* tau, float* xmap_re, float* xmap_g, bool real_x) {
  int zrow[kAR], kel[kAK];
#pragma unroll
  for (int i = 0; i < kAR; ++i) zrow[i] = min(c0 + i, p.Lin - 1) * p.Lh * p.Nr;
#pragma unroll
  for (int a = 0; a < kAK; ++a) kel[a] = min(k0 + a * KS, p.Nt - 1);
  float ar[kAR][kAK], ai[kAR][kAK];
#pragma unroll
  for (int i = 0; i < kAR; ++i)
#pragma unroll
    for (int a = 0; a < kAK; ++a) ar[i][a] = ai[i][a] = 0.f;
  const size_t tap_stride = static_cast<size_t>(p.Nt) * p.Nr;
  for (int l = 0; l < p.Lh; ++l) {
    const float2* hl = p.h + l * tap_stride;
    const float* zr = Zr + l * p.Nr;
    const float* zi = Zi + l * p.Nr;
    int m0 = 0;
    for (; m0 + 4 <= p.Nr; m0 += 4)
      adjoint_quad<kVec, false>(p, hl, m0, zrow, kel, zr, zi, ar, ai);
    if (m0 < p.Nr)
      adjoint_quad<false, true>(p, hl, m0, zrow, kel, zr, zi, ar, ai);
  }
#pragma unroll
  for (int i = 0; i < kAR; ++i)
#pragma unroll
    for (int a = 0; a < kAK; ++a) {
      const int c = c0 + i;
      if (c < p.Lin && k0 + a * KS < p.Nt) {
        const int j = c * p.Nt + kel[a];
        const float tc = tau[c];
        xmap_re[j] = xm_re[j] + tc * ar[i][a];
        xmap_g[2 * j + 1] = real_x ? tc * ai[i][a] : xm_im[j] + tc * ai[i][a];
      }
    }
}

// Denoiser.

// decode::torch_sum of get(0..n-1) for n <= kMaxK (W = last_pow2(n)
// lanes, each holding elements t and t + W).  get is called with static
// indices only, so an array it reads stays in registers.
template <int W, class Get>
__device__ __forceinline__ float small_sum_w(int n, Get get) {
  float lane[W];
#pragma unroll
  for (int t = 0; t < W; ++t) {
    const float a1 =
        t + W < n ? 0.f + get(t + W < kMaxK ? t + W : kMaxK - 1) : 0.f;
    lane[t] = (((0.f + get(t)) + a1) + 0.f) + 0.f;
  }
#pragma unroll
  for (int off = W / 2; off >= 1; off >>= 1)
#pragma unroll
    for (int t = 0; t < off; ++t) lane[t] = lane[t] + lane[t + off];
  return lane[0];
}

template <class Get>
__device__ __forceinline__ float small_sum(int n, Get get) {
  switch (last_pow2(n)) {
    case 1: return small_sum_w<1>(n, get);
    case 2: return small_sum_w<2>(n, get);
    case 4: return small_sum_w<4>(n, get);
    case 8: return small_sum_w<8>(n, get);
    default: return small_sum_w<16>(n, get);
  }
}

// The posterior mean of segment j0 .. j0+M-1 (decode::segment_posterior
// <false> with tau_of(j) = tau), computed by the G lanes of one group (G =
// the lane count of PyTorch's reduction over M elements; lane t of the
// group, mask its lanes): the max and the segment sum through shuffles,
// each lane's share of the sum in lane_sum's order, then the mean of
// elements t, t+G, ..., written to xmmse.  A lane keeps the scaled
// pseudo-data and eta of its first element (its only one when M is a power
// of two up to 32) from pass to pass.
__device__ __forceinline__ void group_mean(
    int j0, int M, int K, int G, int t, unsigned mask, const float* sr,
    const float* si, bool real_x, const float* x_re, const float* xmap_g,
    float tau, float* xm_re, float* xm_im) {
  tau = tau / 2.f;
  // pseudo-data over tau of element i
  auto scaled = [&](int i, float& a, float& b) {
    const int j = j0 + i;
    a = x_re[j] / tau;
    b = real_x ? 0.f : xmap_g[2 * j + 1] / tau;
  };
  auto t_of = [&](float a, float b, int q) {
    return real_x ? a * sr[q] : re_conj_mul(a, b, sr[q], si[q]);
  };
  float a0, b0;
  scaled(t, a0, b0);
  float mx = -INFINITY;
  for (int q = 0; q < K; ++q) mx = fmaxf(mx, t_of(a0, b0, q));
  for (int i = t + G; i < M; i += G) {
    float a, b;
    scaled(i, a, b);
    for (int q = 0; q < K; ++q) mx = fmaxf(mx, t_of(a, b, q));
  }
  for (int off = G / 2; off >= 1; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(mask, mx, off, G));
  auto eta = [&](float a, float b, int q) {
    return expf(fminf(t_of(a, b, q) - mx, kExpMax));
  };
  // eta of one element for every symbol (K > 1)
  auto etas = [&](float a, float b, float (&e)[kMaxK]) {
#pragma unroll
    for (int q = 0; q < kMaxK; ++q) e[q] = q < K ? eta(a, b, q) : 0.f;
  };
  // eta summed over the symbols
  auto eta_m = [&](float a, float b) {
    if (K == 1) return eta(a, b, 0);
    float e[kMaxK];
    etas(a, b, e);
    return small_sum(K, [&](int q) { return e[q]; });
  };
  // ... then over the segment: element s of this lane goes to accumulator
  // s % 4 (lane_sum), the lanes join in a tree
  const float em0 = eta_m(a0, b0);
  float acc0 = 0.f + em0, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  int s = 1;
  for (int i = t + G; i < M; i += G, ++s) {
    float a, b;
    scaled(i, a, b);
    const float em = eta_m(a, b);
    switch (s & 3) {
      case 0: acc0 = acc0 + em; break;
      case 1: acc1 = acc1 + em; break;
      case 2: acc2 = acc2 + em; break;
      default: acc3 = acc3 + em; break;
    }
  }
  float sum = ((acc0 + acc1) + acc2) + acc3;
  for (int off = G / 2; off >= 1; off >>= 1)
    sum = sum + __shfl_down_sync(mask, sum, off, G);
  const float eta2 = __shfl_sync(mask, sum, 0, G);
  for (int i = t; i < M; i += G) {
    float a = a0, b = b0;
    if (i != t) scaled(i, a, b);
    float mr, mi;
    if (K == 1) {
      const float post = (i == t ? em0 : eta(a, b, 0)) / eta2;
      mr = sr[0] * post;
      mi = si[0] * post;
    } else {
      float e[kMaxK];
      etas(a, b, e);
      mr = small_sum(K, [&](int q) { return sr[q] * e[q]; }) / eta2;
      mi = small_sum(K, [&](int q) { return si[q] * e[q]; }) / eta2;
    }
    const int j = j0 + i;
    xm_re[j] = mr;
    if (!real_x) xm_im[j] = mi;
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    scamp_decode_kernel(Params p) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int N = p.Lin * p.Nt;
  const int n = p.Lout * p.Nr;
  const size_t xo = static_cast<size_t>(b) * N;
  const size_t yo = static_cast<size_t>(b) * n;
  const size_t po = static_cast<size_t>(b) * p.Lin;
  const size_t fo = static_cast<size_t>(b) * p.Lout;
  const bool real_x = p.real_x != 0;
  const bool est = p.estimate_phi != 0;
  int act = p.act_in[b];
  int T = p.T_in[b];

  if (!act || p.cap <= 0) {
    // Frozen trial: state passes through.
    for (int j = tid; j < N; j += blockDim.x) {
      p.xmap_out[xo + j] = p.xmap_in[xo + j];
      p.xmmse_out[xo + j] = p.xmmse_in[xo + j];
    }
    for (int o = tid; o < n; o += blockDim.x) p.z_out[yo + o] = p.z_in[yo + o];
    for (int c = tid; c < p.Lin; c += blockDim.x)
      p.psi_out[po + c] = p.psi_in[po + c];
    for (int r = tid; r < p.Lout; r += blockDim.x)
      p.phi_out[fo + r] = p.phi_in[fo + r];
    if (tid == 0) {
      p.act_out[b] = act;
      p.T_out[b] = T;
    }
    return;
  }

  // Shared-memory planes of this trial, in the order whose size
  // smem_bytes() in fused_scamp.py computes.  The two scratch planes come
  // first (S floats each, a multiple of 4): the forward products P[c, l, m]
  // at (c Lh + l) Nr + m, then in the same slots the adjoint inputs Z.
  extern __shared__ __align__(16) float sm[];
  const int S = (p.Lin * p.Lh * p.Nr + 3) & ~3;
  float* Pr = sm;
  float* Pi = Pr + S;
  float* xm_re = Pi + S;
  float* xm_im = xm_re + N;                 // absent for real alphabets
  float* xmap_re = xm_im + (real_x ? 0 : N);
  float* y_re = xmap_re + N;
  float* y_im = y_re + n;
  float* z_re = y_im + n;
  float* z_im = z_re + n;
  float* psi = z_im + n;
  float* tau = psi + p.Lin;
  float* phi = tau + p.Lin;
  float* ons = phi + p.Lout;                // b = gma / phi per row block
  // The pseudo-data's imaginary part lives in the output (stride 2).
  float* xmap_g = reinterpret_cast<float*>(p.xmap_out + xo);

  // Slots of (c, l) pairs that place no block stay zero: the adjoint
  // reads them as exact zeros.
  for (int e = tid; e < 2 * S; e += blockDim.x) sm[e] = 0.f;
  for (int j = tid; j < N; j += blockDim.x) {
    const float2 m = p.xmmse_in[xo + j];
    xm_re[j] = m.x;
    if (!real_x) xm_im[j] = m.y;
  }
  for (int o = tid; o < n; o += blockDim.x) {
    const float2 yy = p.y[yo + o];
    const float2 zz = p.z_in[yo + o];
    y_re[o] = yy.x;
    y_im[o] = yy.y;
    z_re[o] = zz.x;
    z_im[o] = zz.y;
  }
  for (int c = tid; c < p.Lin; c += blockDim.x) psi[c] = p.psi_in[po + c];
  for (int r = tid; r < p.Lout; r += blockDim.x) phi[r] = p.phi_in[fo + r];
  __syncthreads();

  const int cols = p.Lh * p.Nr;
  const int KS = (p.Nt + kAK - 1) / kAK;     // adjoint element stride
  const int fwd_tiles = (p.Lin + kFR - 1) / kFR * cols;
  const int adj_tiles = (p.Lin + kAR - 1) / kAR * KS;
  const bool vec_x = p.Nt % 4 == 0;
  const bool vec_z = p.Nr % 4 == 0;
  // segment groups of the denoiser
  const int G = p.M >= 32 ? 32 : last_pow2(p.M);
  const int gt = tid & (G - 1);
  const unsigned gmask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1) << (lane & ~(G - 1));
  for (int it = 0; it < p.cap; ++it) {
    // ---- gma: gma = psi W^T / Lin, b = gma / phi, phi' = sigma2 + gma;
    // warp per row block
    for (int r = warp; r < p.Lout; r += kWarps) {
      const float* Wr = p.W + r * p.Lin;
      const float s = warp_torch_sum(
          p.Lin, false, [&](int c) { return psi[c] * __ldg(Wr + c); });
      if (lane == 0) {
        const float g = s * p.inv_Lc;
        ons[r] = g / phi[r];
        if (!est) phi[r] = g + p.sigma2;
      }
    }
    __syncthreads();

    // ---- forward: thread per (kFR source blocks, tap column); tau on the
    // threads from the top, which the tiles leave idle at the main geometry
    for (int f = tid; f < fwd_tiles; f += blockDim.x) {
      const int g = f / cols;
      const int l = (f - g * cols) / p.Nr;
      const int m = f - g * cols - l * p.Nr;
      if (vec_x && real_x)
        forward_tile<true, true>(p, g * kFR, l, m, xm_re, xm_im, Pr, Pi);
      else if (vec_x)
        forward_tile<true, false>(p, g * kFR, l, m, xm_re, xm_im, Pr, Pi);
      else if (real_x)
        forward_tile<false, true>(p, g * kFR, l, m, xm_re, xm_im, Pr, Pi);
      else
        forward_tile<false, false>(p, g * kFR, l, m, xm_re, xm_im, Pr, Pi);
    }
    if (!est)
      for (int c = kThreads - 1 - tid; c < p.Lin; c += kThreads)
        tau[c] = tau_of(p, phi, c);
    __syncthreads();

    // ---- fold: thread per kFO outputs (r, m), their chains interleaved:
    // row sums, Onsager residual and (without estimate_phi) the adjoint
    // inputs in the slots just read
    for (int o0 = tid; o0 < n; o0 += kThreads * kFO) {
      int r[kFO], m[kFO];
      float hr[kFO], hi[kFO];
#pragma unroll
      for (int d = 0; d < kFO; ++d) {
        const int o = min(o0 + d * kThreads, n - 1);
        r[d] = o / p.Nr;
        m[d] = o - r[d] * p.Nr;
        hr[d] = hi[d] = 0.f;
      }
      for (int l = 0; l < p.Lh; ++l)
#pragma unroll
        for (int d = 0; d < kFO; ++d) {
          const int c = src_block(r[d], l, p);
          if (c < 0) continue;
          const int e = (c * p.Lh + l) * p.Nr + m[d];
          const float g = p.gains[l * p.Lin + c];
          hr[d] = hr[d] + g * Pr[e];
          hi[d] = hi[d] + g * Pi[e];
        }
      float wr[kFO], wi[kFO];
#pragma unroll
      for (int d = 0; d < kFO; ++d) {
        const int o = o0 + d * kThreads;
        if (o >= n) continue;
        const float br = ons[r[d]];
        const float zr = (y_re[o] - hr[d]) + br * z_re[o];
        const float zi = (y_im[o] - hi[d]) + br * z_im[o];
        z_re[o] = zr;
        z_im[o] = zi;
        if (!est) {
          wr[d] = zr / phi[r[d]];
          wi[d] = zi / phi[r[d]];
        }
      }
      if (!est) {
        for (int l = 0; l < p.Lh; ++l)
#pragma unroll
          for (int d = 0; d < kFO; ++d) {
            const int c = src_block(r[d], l, p);
            if (o0 + d * kThreads >= n || c < 0) continue;
            const int e = (c * p.Lh + l) * p.Nr + m[d];
            const float g = p.gains[l * p.Lin + c];
            Pr[e] = g * wr[d];
            Pi[e] = g * wi[d];
          }
      }
    }
    __syncthreads();

    if (est) {
      // phi' = mean |z'|^2 per row block: warp per block
      for (int r = warp; r < p.Lout; r += kWarps) {
        const float* zr = z_re + r * p.Nr;
        const float* zi = z_im + r * p.Nr;
        const float s = warp_torch_sum(
            p.Nr, false, [&](int m) { return abs2(zr[m], zi[m]); });
        if (lane == 0) phi[r] = s * p.inv_Mr;
      }
      __syncthreads();
      // tau and the adjoint inputs, in the forward products' slots
      for (int c = tid; c < p.Lin; c += blockDim.x) tau[c] = tau_of(p, phi, c);
      for (int e = tid; e < p.Lin * cols; e += blockDim.x) {
        const int c = e / cols;
        const int l = (e - c * cols) / p.Nr;
        const int m = e - c * cols - l * p.Nr;
        const int r = dst_block(c, l, p);
        if (r < 0) continue;  // stays zero
        const int o = r * p.Nr + m;
        const float g = p.gains[l * p.Lin + c];
        Pr[e] = g * (z_re[o] / phi[r]);
        Pi[e] = g * (z_im[o] / phi[r]);
      }
      __syncthreads();
    }

    // ---- adjoint: thread per (kAR column blocks, kAK x elements) --------
    for (int f = tid; f < adj_tiles; f += blockDim.x) {
      const int g = f / KS;
      if (vec_z)
        adjoint_tile<true>(p, g * kAR, f - g * KS, KS, Pr, Pi, xm_re, xm_im,
                           tau, xmap_re, xmap_g, real_x);
      else
        adjoint_tile<false>(p, g * kAR, f - g * KS, KS, Pr, Pi, xm_re,
                            xm_im, tau, xmap_re, xmap_g, real_x);
    }
    __syncthreads();

    // ---- denoiser: mean-only segmented posterior, a group of G lanes per
    // segment (a segment lies inside one column block: Nt % M == 0)
    for (int s = tid / G; s < N / p.M; s += kThreads / G) {
      const int j0 = s * p.M;
      group_mean(j0, p.M, p.K, G, gt, gmask, p.sym_re, p.sym_im, real_x,
                 xmap_re, xmap_g, tau[j0 / p.Nt], xm_re, xm_im);
    }
    __syncthreads();

    // ---- psi: psi' = 1 - sum |xmmse|^2 / Na per column block, warp per
    // block, then the allclose test on psi
    int bad = 0;
    for (int c = warp; c < p.Lin; c += kWarps) {
      const float* xr = xm_re + c * p.Nt;
      const float* xi = xm_im + c * p.Nt;
      const float s = warp_torch_sum(p.Nt, p.vec4_psi != 0, [&](int k) {
        return abs2(xr[k], real_x ? 0.f : xi[k]);
      });
      const float pn = 1.f - s * p.inv_Na;
      const float old = psi[c];
      bad |= !(fabsf(pn - old) <= kAtol + kRtol * fabsf(old));
      __syncwarp();
      if (lane == 0) psi[c] = pn;
    }
    ++T;
    if (!__syncthreads_or(bad)) {
      act = 0;
      break;
    }
  }

  for (int j = tid; j < N; j += blockDim.x) {
    xmap_g[2 * j] = xmap_re[j];
    p.xmmse_out[xo + j] = make_float2(xm_re[j], real_x ? 0.f : xm_im[j]);
  }
  for (int o = tid; o < n; o += blockDim.x)
    p.z_out[yo + o] = make_float2(z_re[o], z_im[o]);
  for (int c = tid; c < p.Lin; c += blockDim.x) p.psi_out[po + c] = psi[c];
  for (int r = tid; r < p.Lout; r += blockDim.x) p.phi_out[fo + r] = phi[r];
  if (tid == 0) {
    p.act_out[b] = act;
    p.T_out[b] = T;
  }
}

}  // namespace

extern "C" {

// Launch the decode of B trials on `stream` with `smem` bytes of dynamic
// shared memory per block.  Returns a cudaError_t code (0 on success): the
// attribute call's, or cudaGetLastError() after the launch.  The kernel
// allocates nothing; every buffer is the caller's.
int fused_scamp_decode(
    const void* y, const void* xmap_in, const void* xmmse_in,
    const void* psi_in, const void* phi_in, const void* z_in,
    const void* act_in, const void* T_in,
    void* xmap_out, void* xmmse_out, void* psi_out, void* phi_out,
    void* z_out, void* act_out, void* T_out,
    const void* h, const void* hT, const void* gains, const void* W,
    const void* sym_re, const void* sym_im,
    int B, int Nt, int Nr, int Lin, int Lout, int Lh, int trunc, int M,
    int K, int real_x, int estimate_phi, int vec4_psi, float sigma2,
    float L, float inv_Lc, float inv_Mr, float inv_Na, int cap, int smem,
    void* stream) {
  if (K < 1 || K > kMaxK || M < 1 || Nt % M != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.y = static_cast<const float2*>(y);
  p.xmap_in = static_cast<const float2*>(xmap_in);
  p.xmmse_in = static_cast<const float2*>(xmmse_in);
  p.psi_in = static_cast<const float*>(psi_in);
  p.phi_in = static_cast<const float*>(phi_in);
  p.z_in = static_cast<const float2*>(z_in);
  p.act_in = static_cast<const int*>(act_in);
  p.T_in = static_cast<const int*>(T_in);
  p.xmap_out = static_cast<float2*>(xmap_out);
  p.xmmse_out = static_cast<float2*>(xmmse_out);
  p.psi_out = static_cast<float*>(psi_out);
  p.phi_out = static_cast<float*>(phi_out);
  p.z_out = static_cast<float2*>(z_out);
  p.act_out = static_cast<int*>(act_out);
  p.T_out = static_cast<int*>(T_out);
  p.h = static_cast<const float2*>(h);
  p.hT = static_cast<const float2*>(hT);
  p.gains = static_cast<const float*>(gains);
  p.W = static_cast<const float*>(W);
  p.sym_re = static_cast<const float*>(sym_re);
  p.sym_im = static_cast<const float*>(sym_im);
  p.Nt = Nt;
  p.Nr = Nr;
  p.Lin = Lin;
  p.Lout = Lout;
  p.Lh = Lh;
  p.trunc = trunc;
  p.M = M;
  p.K = K;
  p.real_x = real_x;
  p.estimate_phi = estimate_phi;
  p.vec4_psi = vec4_psi;
  p.sigma2 = sigma2;
  p.L = L;
  p.inv_Lc = inv_Lc;
  p.inv_Mr = inv_Mr;
  p.inv_Na = inv_Na;
  p.cap = cap;
  cudaError_t err = cudaFuncSetAttribute(
      scamp_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  scamp_decode_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_scamp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
