// One BAMP iteration on an NVIDIA Hopper GPU, one thread block per trial
// with the trial's frame in shared memory.  Two kernels in one, chosen by
// the launch's `fused` flag:
//
// * K6 (fused): replaces amp_sparc_spatialmodulation_tpu/ops/pallas/
//   fused_bamp.py:567 _iteration_fused_kernel (FusedBandedIteration.
//   plane_call with fuse_denoiser=True): the linear part below, the K=1
//   segmented softmax denoiser with tau = cov / 2 and the closed-form
//   variance |s0|^2 p (1 - p) (_k1_denoiser, fused_bamp.py:551-564), the
//   freeze of x, var, z and u for trials whose act is 0 (their xmap is left
//   unwritten: the caller's loop keeps the old one, as on the TPU), and
//   notok, each trial's count of variance entries outside allclose(rtol=1e-5,
//   atol=1e-8) of the old ones (0 for a frozen trial).
// * K7 (not fused): replaces fused_bamp.py:359 _iteration_kernel
//   (FusedBandedIteration.__call__ with fuse_denoiser=False): the linear part
//   only, returning xmap, cov, z and u; the denoiser stays outside.
//
// The linear part of one iteration, for a complex posterior mean x:
//
//   v    = |H|^2 var                        (banded forward, Lh taps)
//   z'   = H x - v (y - z) / u              (banded forward + Onsager)
//   u'   = v + sigma2
//   cov  = 1 / (|H|^2^T (1/u'))             (banded adjoint)
//   xmap = x + cov H^H ((y - z') / u')      (banded adjoint)
//
// with any truncation (tail, trunc, cyclic: the band placement of
// decode_common.cuh) and gains that vary with the tap and the column block.
//
// Bound on this card: FP32 operations, as for the whole-decode kernel K1
// (fused_bamp_decode.cu), whose iteration body this kernel runs once: 10
// real banded products of 2 Lin Nt Lh Nr flop per trial-iteration for a
// complex x, about 3.7 MFLOP at the flagship geometry (55 ns at 67
// TFLOP/s), against the state read and written once (about 62 KB, 19 ns at
// 3.35 TB/s).  Unlike K1 it returns to device memory after every
// iteration, as the TPU kernels it replaces do: that is their contract.
// What holds a kernel of this shape back is the load pipe, not the FMAs
// (K1's header says why), so the passes are K1's, in a copy of their own
// here so that K1's build does not move:
//
// * forward: a thread owns one tap column (l, m) and kFR source blocks c:
//   per k it loads the tap once for kFR rows and x, var and the imaginary
//   part of x as 16-byte broadcasts of shared memory; the products P[c, l,
//   m] go to the scratch planes;
// * fold: a thread per output (r, m) sums its row over l, forms the
//   Onsager residual and u', then writes the gain-weighted adjoint inputs
//   Z[c, l, m] into the slots of the P it has just read (each slot belongs
//   to exactly one output);
// * adjoint: a thread owns one x element k of kAR column blocks: per
//   antenna m it loads the tap once for kAR rows and Z as broadcasts; it
//   writes cov, and xmap in place over x (the forward pass is done with x,
//   and the thread that owns element j reads x[j] right before it writes
//   xmap[j]);
// * K6's denoiser: a segment of M lanes is posterior'd by a group of G =
//   min(32, last_pow2(M)) lanes, the max and the segment sum joined by
//   warp shuffles in PyTorch's order, lane t storing element j0 + t, so
//   every warp store is coalesced; notok is summed per warp and added to
//   the block's count with one atomic per warp.
//
// That leaves 3 scratch planes, 4 x-side planes (x then xmap, var, cov) and
// 5 y-side planes in shared memory: 68,800 B at the flagship geometry, so
// three blocks share an SM, which holds a thread to 80 registers.  The
// state moves between device and shared memory in 16-byte copies where
// every plane allows them (the launch checks), which also takes a frozen
// trial's pass-through, most of a launch at the periter path's tail, to
// 0.64x its time in scalar copies (PERF.md, section 6).
//
// The flag is read at run time, not a template parameter: compiled as two
// template instances, the K7 instance got another register allocation and
// ran at more than twice K6's time at the flagship shape (PERF.md, section 6).
//
// Rounding: as K1's (built with -fmad=false; each banded product is one FMA
// chain over the contraction index in the order of the matrix library's
// complex GEMM; the forward chain of each (c, l, m) runs over k from zero,
// the taps are added to a row over l after their gains, the adjoint chain
// of each (c, k) runs over (l, m), and a tap that places no block (trunc)
// contributes exact zeros; segment sums in PyTorch's reduction order), so
// the kernel matches its plain version (fused_bamp_iteration.py) bit for
// bit, which chip_smoke.py checks on the card.
//
// Layouts: float32 planes, trial-major: x-side (B, Lin*Nt), y-side
// (B, Lout*Nr).  Taps h (Lh, Nr, Nt) and hT (Lh, Nt, Nr) complex64, |h|^2 in
// both orders, gains and gains^2 (Lh, Lin).

#include <cstdint>
#include <initializer_list>

#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int kThreads = 256;
constexpr int kFR = 7;  // forward: source blocks per thread
constexpr int kAR = 5;  // adjoint: column blocks per thread

struct Params {
  const float* xm_re;       // posterior mean, (B, N)
  const float* xm_im;
  const float* var;         // (B, N)
  const float* z_re;        // (B, n)
  const float* z_im;
  const float* u;
  const float* y_re;
  const float* y_im;
  const int* act;           // (B,), K6
  float* xmap_re;           // outputs, (B, N)
  float* xmap_im;
  float* xn_re;             // K6: posterior mean and variance; K7: cov in
  float* xn_im;             //     out_var
  float* out_var;
  float* zn_re;             // (B, n)
  float* zn_im;
  float* un;
  int* notok;               // (B,), K6
  const float2* h;          // (Lh, Nr, Nt)
  const float2* hT;         // (Lh, Nt, Nr)
  const float* a2;          // |h|^2, (Lh, Nr, Nt)
  const float* a2T;         // |h|^2, (Lh, Nt, Nr)
  const float* gains;       // (Lh, Lin)
  const float* gains2;
  float s0_re, s0_im;       // K6: the one symbol
  int Nt, Nr, Lin, Lout, Lh, trunc, M;
  float sigma2;
  int fused;
  int wide;  // every plane 16-byte aligned and N, n multiples of 4
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

// dst[i] = src[i] for i < cnt by the block's threads, 16 bytes a thread
// when wide (both 16-byte aligned, cnt a multiple of 4).
__device__ __forceinline__ void copy(float* dst, const float* src, int cnt,
                                     bool wide) {
  if (wide) {
    for (int i = threadIdx.x; i < cnt / 4; i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
  } else {
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) dst[i] = src[i];
  }
}

// Forward products.

// One step k of the chains of one (c, l, m): |h|^2 var and h x.
__device__ __forceinline__ void fwd_step(float& pv, float& pr, float& pi,
                                         float x, float xj, float v,
                                         float2 hv, float a) {
  pv = fmaf(v, a, pv);
  pr = fmaf(x, hv.x, pr);
  pr = fmaf(-xj, hv.y, pr);
  pi = fmaf(x, hv.y, pi);
  pi = fmaf(xj, hv.x, pi);
}

// The products of column (l, m) of the tap stack with source blocks c0 ..
// c0+kFR-1, written to P[c, l, m] (the rows past Lin repeat the last one
// and are dropped, as are the blocks tap l places nowhere).
template <bool kVec>
__device__ __forceinline__ void forward_tile(
    const Params& p, int c0, int l, int m, const float* xm_re,
    const float* xm_im, const float* var, float* Pv, float* Pr, float* Pi,
    int NrP) {
  const size_t tap = static_cast<size_t>(l) * p.Nt * p.Nr + m;
  const float2* ht = p.hT + tap;
  const float* at = p.a2T + tap;
  int row[kFR];
#pragma unroll
  for (int i = 0; i < kFR; ++i) row[i] = min(c0 + i, p.Lin - 1) * p.Nt;
  float pv[kFR], pr[kFR], pi[kFR];
#pragma unroll
  for (int i = 0; i < kFR; ++i) pv[i] = pr[i] = pi[i] = 0.f;
  int k = 0;
  for (; k + 4 <= p.Nt; k += 4) {
    float2 hv[4];
    float a[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      hv[q] = __ldg(ht + (k + q) * p.Nr);
      a[q] = __ldg(at + (k + q) * p.Nr);
    }
#pragma unroll
    for (int i = 0; i < kFR; ++i) {
      const float4 x = load4<kVec>(xm_re + row[i] + k);
      const float4 v = load4<kVec>(var + row[i] + k);
      const float4 xj = load4<kVec>(xm_im + row[i] + k);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        fwd_step(pv[i], pr[i], pi[i], lane4(x, q), lane4(xj, q),
                 lane4(v, q), hv[q], a[q]);
    }
  }
  for (; k < p.Nt; ++k) {
    const float2 hv = __ldg(ht + k * p.Nr);
    const float a = __ldg(at + k * p.Nr);
#pragma unroll
    for (int i = 0; i < kFR; ++i)
      fwd_step(pv[i], pr[i], pi[i], xm_re[row[i] + k], xm_im[row[i] + k],
               var[row[i] + k], hv, a);
  }
#pragma unroll
  for (int i = 0; i < kFR; ++i) {
    const int c = c0 + i;
    if (c < p.Lin && dst_block(c, l, p) >= 0) {
      const int e = (c * p.Lh + l) * NrP + m;
      Pv[e] = pv[i];
      Pr[e] = pr[i];
      Pi[e] = pi[i];
    }
  }
}

// Adjoint products.

// One step (l, m) of the chains of one (c, k): |h|^2^T Zc and h^H (Zr + i
// Zi).
__device__ __forceinline__ void adj_step(float& cs, float& ar, float& ai,
                                         float zc, float zr, float zi,
                                         float2 hv, float a) {
  cs = fmaf(zc, a, cs);
  // (zr + i zi) * conj(h)
  ar = fmaf(zr, hv.x, ar);
  ar = fmaf(-zi, -hv.y, ar);
  ai = fmaf(zr, -hv.y, ai);
  ai = fmaf(zi, hv.x, ai);
}

// Antennas m0 .. m0+3 of tap l (those below Nr when kTail) for the kAR
// column blocks whose Z rows start at zrow[i].
template <bool kTail>
__device__ __forceinline__ void adjoint_quad(
    const Params& p, const float2* hl, const float* al, int m0,
    const int (&zrow)[kAR], const float* Zc, const float* Zr,
    const float* Zi, float (&cs)[kAR], float (&ar)[kAR], float (&ai)[kAR]) {
  float2 hv[4];
  float a[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = kTail ? min(m0 + q, p.Nr - 1) : m0 + q;
    hv[q] = __ldg(hl + m * p.Nt);
    a[q] = __ldg(al + m * p.Nt);
  }
#pragma unroll
  for (int i = 0; i < kAR; ++i) {
    const float4 zc = *reinterpret_cast<const float4*>(Zc + zrow[i] + m0);
    const float4 zr = *reinterpret_cast<const float4*>(Zr + zrow[i] + m0);
    const float4 zi = *reinterpret_cast<const float4*>(Zi + zrow[i] + m0);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (!kTail || m0 + q < p.Nr)
        adj_step(cs[i], ar[i], ai[i], lane4(zc, q), lane4(zr, q),
                 lane4(zi, q), hv[q], a[q]);
  }
}

// The adjoint of x element k of column blocks c0 .. c0+kAR-1: cov, and
// xmap written over x in place.
__device__ __forceinline__ void adjoint_tile(
    const Params& p, int c0, int k, const float* Zc, const float* Zr,
    const float* Zi, int NrP, float* xm_re, float* xm_im, float* cov) {
  int zrow[kAR];
#pragma unroll
  for (int i = 0; i < kAR; ++i)
    zrow[i] = min(c0 + i, p.Lin - 1) * p.Lh * NrP;
  float cs[kAR], ar[kAR], ai[kAR];
#pragma unroll
  for (int i = 0; i < kAR; ++i) cs[i] = ar[i] = ai[i] = 0.f;
  const size_t tap_stride = static_cast<size_t>(p.Nt) * p.Nr;
  for (int l = 0; l < p.Lh; ++l) {
    const float2* hl = p.h + l * tap_stride + k;
    const float* al = p.a2 + l * tap_stride + k;
    const float* zc = Zc + l * NrP;
    const float* zr = Zr + l * NrP;
    const float* zi = Zi + l * NrP;
    int m0 = 0;
    for (; m0 + 4 <= p.Nr; m0 += 4)
      adjoint_quad<false>(p, hl, al, m0, zrow, zc, zr, zi, cs, ar, ai);
    if (m0 < p.Nr)
      adjoint_quad<true>(p, hl, al, m0, zrow, zc, zr, zi, cs, ar, ai);
  }
#pragma unroll
  for (int i = 0; i < kAR; ++i) {
    const int c = c0 + i;
    if (c < p.Lin) {
      const int j = c * p.Nt + k;
      const float cv = 1.f / cs[i];
      cov[j] = cv;
      xm_re[j] = xm_re[j] + cv * ar[i];
      xm_im[j] = xm_im[j] + cv * ai[i];
    }
  }
}

// K6's denoiser.

// The K=1 segmented posterior with tau = cov / 2 and the closed-form
// variance |s0|^2 post (1 - post) of segment j0 .. j0+M-1, computed by the
// G lanes of one group (lane t of the group, mask its lanes): the max and
// the segment sum through shuffles, each lane's share of the sum in
// lane_sum's order, then the mean and variance of elements t, t+G, ...,
// stored to the outputs (o, offset to the trial).  Returns the lane's count
// of variance entries outside the allclose tolerance of var.
__device__ __forceinline__ int group_k1(
    int j0, int M, int G, int t, unsigned mask, float sr, float si,
    float s2, const float* x_re, const float* x_im, const float* cov,
    const float* var, float* o_re, float* o_im, float* o_var) {
  // the softmax argument of element i: Re((x / tau) conj(s0))
  auto t_of = [&](int i) {
    const int j = j0 + i;
    const float tau = cov[j] / 2.f;
    return re_conj_mul(x_re[j] / tau, x_im[j] / tau, sr, si);
  };
  const float t0 = t_of(t);
  float mx = fmaxf(-INFINITY, t0);
  for (int i = t + G; i < M; i += G) mx = fmaxf(mx, t_of(i));
  for (int off = G / 2; off >= 1; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(mask, mx, off, G));
  auto eta = [&](float tv) { return expf(fminf(tv - mx, kExpMax)); };
  // element s of this lane goes to accumulator s % 4 (lane_sum), the
  // lanes join in a tree
  const float e0 = eta(t0);
  float acc0 = 0.f + e0, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  int s = 1;
  for (int i = t + G; i < M; i += G, ++s) {
    const float e = eta(t_of(i));
    switch (s & 3) {
      case 0: acc0 = acc0 + e; break;
      case 1: acc1 = acc1 + e; break;
      case 2: acc2 = acc2 + e; break;
      default: acc3 = acc3 + e; break;
    }
  }
  float sum = ((acc0 + acc1) + acc2) + acc3;
  for (int off = G / 2; off >= 1; off >>= 1)
    sum = sum + __shfl_down_sync(mask, sum, off, G);
  const float eta2 = __shfl_sync(mask, sum, 0, G);
  int bad = 0;
  for (int i = t; i < M; i += G) {
    const float post = (i == t ? e0 : eta(t_of(i))) / eta2;
    const float vn = s2 * post * (1.f - post);
    const int j = j0 + i;
    const float old = var[j];
    bad += !(fabsf(vn - old) <= kAtol + kRtol * fabsf(old));
    o_re[j] = sr * post;
    o_im[j] = si * post;
    o_var[j] = vn;
  }
  return bad;
}

__global__ void __launch_bounds__(kThreads, 3) iteration_kernel(Params p) {
  const bool fused = p.fused != 0;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int N = p.Lin * p.Nt;
  const int n = p.Lout * p.Nr;
  const int NrP = (p.Nr + 3) & ~3;
  const size_t xo = static_cast<size_t>(b) * N;
  const size_t yo = static_cast<size_t>(b) * n;
  const bool wide = p.wide != 0;

  if (fused && !p.act[b]) {
    // Frozen trial: the state passes through.
    copy(p.xn_re + xo, p.xm_re + xo, N, wide);
    copy(p.xn_im + xo, p.xm_im + xo, N, wide);
    copy(p.out_var + xo, p.var + xo, N, wide);
    copy(p.zn_re + yo, p.z_re + yo, n, wide);
    copy(p.zn_im + yo, p.z_im + yo, n, wide);
    copy(p.un + yo, p.u + yo, n, wide);
    if (tid == 0) p.notok[b] = 0;
    return;
  }

  // Shared-memory planes of this trial, in the order whose size
  // smem_bytes() in fused_bamp_iteration.py computes.  The scratch planes
  // come first (16-byte rows of NrP floats): the forward products P[c, l,
  // m], then in the same slots the adjoint inputs Z[c, l, m].  The adjoint
  // writes xmap over xm_re / xm_im.
  extern __shared__ __align__(16) float sm[];
  const int S = p.Lin * p.Lh * NrP;
  float* Zc = sm;
  float* Zr = Zc + S;
  float* Zi = Zr + S;
  float* xm_re = Zi + S;
  float* xm_im = xm_re + N;
  float* var = xm_im + N;
  float* cov = var + N;
  float* y_re = cov + N;
  float* y_im = y_re + n;
  float* z_re = y_im + n;
  float* z_im = z_re + n;
  float* u = z_im + n;
  __shared__ int s_bad;

  // Slots of (c, l) pairs that place no block, and the row padding, stay
  // zero: the adjoint reads them as exact zeros.
  for (int e = tid; e < 3 * S; e += blockDim.x) sm[e] = 0.f;
  copy(xm_re, p.xm_re + xo, N, wide);
  copy(xm_im, p.xm_im + xo, N, wide);
  copy(var, p.var + xo, N, wide);
  copy(y_re, p.y_re + yo, n, wide);
  copy(y_im, p.y_im + yo, n, wide);
  copy(z_re, p.z_re + yo, n, wide);
  copy(z_im, p.z_im + yo, n, wide);
  copy(u, p.u + yo, n, wide);
  if (tid == 0) s_bad = 0;
  __syncthreads();

  const int cols = p.Lh * p.Nr;
  const int fwd_tiles = (p.Lin + kFR - 1) / kFR * cols;
  const int adj_tiles = (p.Lin + kAR - 1) / kAR * p.Nt;
  const bool vec = p.Nt % 4 == 0;
  // ---- forward products: thread per (kFR source blocks, tap column) -----
  for (int f = tid; f < fwd_tiles; f += blockDim.x) {
    const int g = f / cols;
    const int l = (f - g * cols) / p.Nr;
    const int m = f - g * cols - l * p.Nr;
    if (vec)
      forward_tile<true>(p, g * kFR, l, m, xm_re, xm_im, var, Zc, Zr, Zi,
                         NrP);
    else
      forward_tile<false>(p, g * kFR, l, m, xm_re, xm_im, var, Zc, Zr, Zi,
                          NrP);
  }
  __syncthreads();

  // ---- fold, Onsager residual and adjoint inputs: thread per (r, m) -----
  for (int o = tid; o < n; o += blockDim.x) {
    const int r = o / p.Nr;
    const int m = o - r * p.Nr;
    float v = 0.f, hx_re = 0.f, hx_im = 0.f;
    for (int l = 0; l < p.Lh; ++l) {
      const int c = src_block(r, l, p);
      if (c < 0) continue;
      const int e = (c * p.Lh + l) * NrP + m;
      const float g = p.gains[l * p.Lin + c];
      v = v + p.gains2[l * p.Lin + c] * Zc[e];
      hx_re = hx_re + g * Zr[e];
      hx_im = hx_im + g * Zi[e];
    }
    const float uo = u[o];
    const float zr = hx_re - (v * (y_re[o] - z_re[o])) / uo;
    const float zi = hx_im - (v * (y_im[o] - z_im[o])) / uo;
    const float un = v + p.sigma2;
    z_re[o] = zr;
    z_im[o] = zi;
    u[o] = un;
    // gain-weighted adjoint inputs of every (c, l) feeding this row
    const float wc = 1.f / un;
    const float wr = (y_re[o] - zr) / un;
    const float wi = (y_im[o] - zi) / un;
    for (int l = 0; l < p.Lh; ++l) {
      const int c = src_block(r, l, p);
      if (c < 0) continue;
      const int e = (c * p.Lh + l) * NrP + m;
      Zc[e] = p.gains2[l * p.Lin + c] * wc;
      Zr[e] = p.gains[l * p.Lin + c] * wr;
      Zi[e] = p.gains[l * p.Lin + c] * wi;
    }
  }
  __syncthreads();

  // ---- adjoint products: thread per (kAR column blocks, x element) ------
  for (int f = tid; f < adj_tiles; f += blockDim.x) {
    const int g = f / p.Nt;
    adjoint_tile(p, g * kAR, f - g * p.Nt, Zc, Zr, Zi, NrP, xm_re, xm_im,
                 cov);
  }
  __syncthreads();

  // ---- denoiser: K6's, or for K7 cov to the outputs -------------------
  if (fused) {
    // A group of G lanes per segment: the max and sum of PyTorch's
    // reduction over M elements, G of its lanes.
    const int M = p.M;
    const int G = M >= 32 ? 32 : last_pow2(M);
    const int t = tid & (G - 1);
    const unsigned mask =
        G == 32 ? 0xffffffffu : ((1u << G) - 1) << ((tid & 31) & ~(G - 1));
    const float s2 = abs2(p.s0_re, p.s0_im);
    int bad = 0;
    for (int s = tid / G; s < N / M; s += blockDim.x / G)
      bad += group_k1(s * M, M, G, t, mask, p.s0_re, p.s0_im, s2, xm_re,
                      xm_im, cov, var, p.xn_re + xo, p.xn_im + xo,
                      p.out_var + xo);
    bad = __reduce_add_sync(0xffffffffu, bad);
    if ((tid & 31) == 0 && bad) atomicAdd(&s_bad, bad);
  } else {
    copy(p.out_var + xo, cov, N, wide);
  }
  __syncthreads();

  copy(p.xmap_re + xo, xm_re, N, wide);
  copy(p.xmap_im + xo, xm_im, N, wide);
  copy(p.zn_re + yo, z_re, n, wide);
  copy(p.zn_im + yo, z_im, n, wide);
  copy(p.un + yo, u, n, wide);
  if (fused && tid == 0) p.notok[b] = s_bad;
}

}  // namespace

extern "C" {

// Launch one iteration of B trials on `stream` with `smem` bytes of dynamic
// shared memory per block: K6 when fused is nonzero, else K7 (act, xn_*
// and notok are then not read or written, and out_var receives cov).
// Returns a cudaError_t code (0 on success): the attribute call's, or
// cudaGetLastError() after the launch.  The kernel allocates nothing; every
// buffer is the caller's.
int fused_bamp_iteration(
    int fused, const void* xm_re, const void* xm_im, const void* var,
    const void* z_re, const void* z_im, const void* u, const void* y_re,
    const void* y_im, const void* act, void* xmap_re, void* xmap_im,
    void* xn_re,
    void* xn_im, void* out_var, void* zn_re, void* zn_im, void* un,
    void* notok, const void* h, const void* hT, const void* a2,
    const void* a2T, const void* gains, const void* gains2, float s0_re,
    float s0_im, int B, int Nt, int Nr, int Lin, int Lout, int Lh, int trunc,
    int M, float sigma2, int smem, void* stream) {
  if (B < 1 || (fused && (M < 1 || Nt % M != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.xm_re = static_cast<const float*>(xm_re);
  p.xm_im = static_cast<const float*>(xm_im);
  p.var = static_cast<const float*>(var);
  p.z_re = static_cast<const float*>(z_re);
  p.z_im = static_cast<const float*>(z_im);
  p.u = static_cast<const float*>(u);
  p.y_re = static_cast<const float*>(y_re);
  p.y_im = static_cast<const float*>(y_im);
  p.act = static_cast<const int*>(act);
  p.xmap_re = static_cast<float*>(xmap_re);
  p.xmap_im = static_cast<float*>(xmap_im);
  p.xn_re = static_cast<float*>(xn_re);
  p.xn_im = static_cast<float*>(xn_im);
  p.out_var = static_cast<float*>(out_var);
  p.zn_re = static_cast<float*>(zn_re);
  p.zn_im = static_cast<float*>(zn_im);
  p.un = static_cast<float*>(un);
  p.notok = static_cast<int*>(notok);
  p.h = static_cast<const float2*>(h);
  p.hT = static_cast<const float2*>(hT);
  p.a2 = static_cast<const float*>(a2);
  p.a2T = static_cast<const float*>(a2T);
  p.gains = static_cast<const float*>(gains);
  p.gains2 = static_cast<const float*>(gains2);
  p.s0_re = s0_re;
  p.s0_im = s0_im;
  p.Nt = Nt;
  p.Nr = Nr;
  p.Lin = Lin;
  p.Lout = Lout;
  p.Lh = Lh;
  p.trunc = trunc;
  p.M = M;
  p.sigma2 = sigma2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  p.fused = fused;
  // 16-byte copies where every plane allows them (a null pointer, K7's
  // absent outputs, is aligned)
  bool aligned = (Lin * Nt) % 4 == 0 && (Lout * Nr) % 4 == 0;
  for (const void* q : {xm_re, xm_im, var, z_re, z_im, u, y_re, y_im,
                        static_cast<const void*>(xmap_re),
                        static_cast<const void*>(xmap_im),
                        static_cast<const void*>(xn_re),
                        static_cast<const void*>(xn_im),
                        static_cast<const void*>(out_var),
                        static_cast<const void*>(zn_re),
                        static_cast<const void*>(zn_im),
                        static_cast<const void*>(un)})
    aligned = aligned && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  p.wide = aligned;
  cudaError_t err = cudaFuncSetAttribute(
      iteration_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  iteration_kernel<<<B, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_bamp_iteration_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
