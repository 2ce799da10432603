// One frame-tiled BAMP iteration on an NVIDIA Hopper GPU, for geometries
// whose trial does not fit one block's shared memory (the massive-MIMO
// config: Nt=1344, Nr=73, Lin=32, Lh=6; one trial's x-side planes are
// 43008 floats each).
//
// Replaces the TPU kernel amp_sparc_spatialmodulation_tpu/ops/pallas/
// fused_bamp_tiled.py:47 _tiled_iteration_kernel (reached through
// TiledBandedIteration.plane_call).  One call computes, for every trial b
// of the batch with real posterior mean x (real alphabets, tail
// truncation, so Lout = Lin + Lh - 1),
//
//   v    = |H|^2 var,  hx = H x                 (banded forward)
//   z'   = hx - v (y - z) / u,  u' = v + sigma2  (Onsager)
//   cov  = 1 / (|H|^2^T (1/u'))                 (banded adjoint)
//   xmap = x + cov H^H ((y - z') / u')          (banded adjoint)
//
// then the general-K segmented softmax posterior with tau = cov / 2 and the
// decomposed variance (decode_common.cuh::segment_posterior, which kernel K1
// runs), the freeze of x, var, z and u for trials whose act is 0 (their
// xmap is left unwritten: the caller's loop keeps the old one, as the TPU
// kernel's does), and notok: each trial's count of variance entries outside
// allclose(rtol=1e-5, atol=1e-8) of the old ones (0 for a frozen trial).
//
// Design.  The banded operator is Lh taps h_l (Nr x Nt) with gains; block
// (c + l, c) of H is gains[l, c] h_l.  So the forward is one product of the
// (B Lin, Nt) x-side rows with the (Nt, Lh Nr) tap stack followed by the
// band fold out[r] = sum_l g_l P[r - l, tap l], and the adjoint is the
// gather of the y-side planes into (B Lin, Lh Nr) rows followed by one
// product with the (Lh Nr, Nt) taps.  A trial's state does not fit a block,
// so it lives in device memory and one call is four launches:
//
//   1. forward products: P_re, P_im (x with Re h, Im h) and P_v (var with
//      |h|^2), (B Lin, Lh Nr) each;
//   2. fold, Onsager and freeze of z and u, one thread per y-side element;
//      it also writes the adjoint inputs, gain-weighted, (B Lin, Lh Nr);
//   3. adjoint products: cov and xmap, (B Lin, Nt);
//   4. denoiser, freeze of x and var, and notok: one thread per segment.
//
// The TPU kernel recomputes an Lh - 1 row halo of the forward in every
// program (31% more forward work at F = 16, Lh = 6) because its grid
// programs cannot wait on each other; separate launches need no halo, and
// a launch costs microseconds against an iteration of milliseconds.  The
// products are 64 x 64 output tiles per block of 256 threads, each thread a
// 4 x 4 register tile, operands staged through shared memory in steps of 16
// of the contraction; tiles whose rows hold no active trial return at once.
//
// Bound on this card: FP32 operations.  One trial-iteration does 16 flop
// per tap element (forward A x 4, |A|^2 var 2, adjoint 8, |A|^2^T 2) over
// Lin Lh Nr Nt = 18,837,504 tap elements at the massive geometry, about
// 0.30 GFLOP (4.5 us at 67 TFLOP/s), against about 1 MB of state read and
// written (0.3 us at 3.35 TB/s).  All arithmetic is FP32 on the CUDA cores
// (the stop test needs full FP32: no TF32).
//
// Rounding.  The kernel rounds where the plain version (fused_bamp_tiled.py,
// one step of the plain loop: complex64 products through the matrix
// library) rounds: built with -fmad=false; every product is one FMA chain
// over the contraction index in order, in a complex product the real part
// before the imaginary part, as a library FP32 GEMM takes it at large
// batch; gains multiply the products' results and the taps are summed in
// order; the gain-weighted adjoint inputs are formed before the product;
// the segment sums follow PyTorch's reduction order (decode_common.cuh).
//
// Layouts: float32 planes, trial-major: x-side (B, Lin, Nt), y-side
// (B, Lout, Nr); the taps as (Lh Nr, Nt) planes (h[l, m, k] at row l Nr + m)
// of Re h, Im h and |h|^2; gains (Lh, Lin).

#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int kThreads = 256;
constexpr int kTile = 64;   // rows and columns of a product tile
constexpr int kDepth = 16;  // contraction steps staged in shared memory

struct Params {
  const float* xm;          // posterior mean (real), (B, Lin, Nt)
  const float* var;         // posterior variance, (B, Lin, Nt)
  const float* z_re;        // (B, Lout, Nr)
  const float* z_im;
  const float* u;
  const float* y_re;
  const float* y_im;
  const int* act;           // (B,)
  float* xmap_re;           // outputs, x-side (xmap: active trials only)
  float* xmap_im;
  float* xm_out;
  float* var_out;
  float* zn_re;             // outputs, y-side
  float* zn_im;
  float* un;
  int* notok;               // (B,)
  float* P_re;              // scratch (B Lin, Lh Nr)
  float* P_im;
  float* P_v;
  float* Z_c;               // scratch (B Lin, Lh Nr): adjoint inputs
  float* Z_re;
  float* Z_im;
  float* cov;               // scratch (B, Lin, Nt)
  const float* h_re;        // taps (Lh Nr, Nt)
  const float* h_im;
  const float* h_a2;
  const float* gains;       // (Lh, Lin)
  const float* gains2;
  const float* sym_re;      // (K,)
  const float* sym_im;
  int B, Nt, Nr, Lin, Lout, Lh, M, K;
  float sigma2;
};

// True when a row R0 .. R0 + 63 of the (B Lin)-row operand belongs to an
// active trial.  Called by the whole block.
__device__ __forceinline__ bool tile_live(const Params& p, int R0, int rows) {
  const int tid = threadIdx.x;
  int live = 0;
  if (tid < kTile && R0 + tid < rows) live = p.act[(R0 + tid) / p.Lin];
  return __syncthreads_or(live) != 0;
}

// ---- 1. forward products ---------------------------------------------------
// P_re[R][n] = sum_k x[R][k] Re h[n][k], P_im likewise with Im h, P_v[R][n]
// = sum_k var[R][k] |h[n][k]|^2: rows R < B Lin, columns n < Lh Nr,
// contraction k < Nt.
__global__ void __launch_bounds__(kThreads) forward_kernel(Params p) {
  __shared__ __align__(16) float sx[kDepth][kTile];
  __shared__ __align__(16) float sv[kDepth][kTile];
  __shared__ __align__(16) float sr[kDepth][kTile];
  __shared__ __align__(16) float si[kDepth][kTile];
  __shared__ __align__(16) float sa[kDepth][kTile];
  const int rows = p.B * p.Lin, W = p.Lh * p.Nr, K = p.Nt;
  const int R0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  if (!tile_live(p, R0, rows)) return;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  // loader: row (and tap row) lr of the tile, four consecutive k from lk
  const int lr = tid >> 2, lk = (tid & 3) * 4;
  const bool a_ok = R0 + lr < rows, b_ok = n0 + lr < W;
  const size_t arow = static_cast<size_t>(a_ok ? R0 + lr : 0) * K;
  const size_t brow = static_cast<size_t>(b_ok ? n0 + lr : 0) * K;
  float fx[4], fv[4], fr[4], fi[4], fa[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = k0 + lk + c;
      const bool ka = a_ok && k < K, kb = b_ok && k < K;
      fx[c] = ka ? p.xm[arow + k] : 0.f;
      fv[c] = ka ? p.var[arow + k] : 0.f;
      fr[c] = kb ? __ldg(p.h_re + brow + k) : 0.f;
      fi[c] = kb ? __ldg(p.h_im + brow + k) : 0.f;
      fa[c] = kb ? __ldg(p.h_a2 + brow + k) : 0.f;
    }
  };
  float accr[4][4], acci[4][4], accv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) accr[i][j] = acci[i][j] = accv[i][j] = 0.f;
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    __syncthreads();  // the previous step's reads are done
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      sx[lk + c][lr] = fx[c];
      sv[lk + c][lr] = fv[c];
      sr[lk + c][lr] = fr[c];
      si[lk + c][lr] = fi[c];
      sa[lk + c][lr] = fa[c];
    }
    __syncthreads();
    if (k0 + kDepth < K) fetch(k0 + kDepth);
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 x4 = *reinterpret_cast<const float4*>(&sx[kk][4 * ty]);
      const float4 v4 = *reinterpret_cast<const float4*>(&sv[kk][4 * ty]);
      const float4 r4 = *reinterpret_cast<const float4*>(&sr[kk][4 * tx]);
      const float4 i4 = *reinterpret_cast<const float4*>(&si[kk][4 * tx]);
      const float4 a4 = *reinterpret_cast<const float4*>(&sa[kk][4 * tx]);
      const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
      const float vs[4] = {v4.x, v4.y, v4.z, v4.w};
      const float rs[4] = {r4.x, r4.y, r4.z, r4.w};
      const float is[4] = {i4.x, i4.y, i4.z, i4.w};
      const float as[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          accr[i][j] = fmaf(xs[i], rs[j], accr[i][j]);
          acci[i][j] = fmaf(xs[i], is[j], acci[i][j]);
          accv[i][j] = fmaf(vs[i], as[j], accv[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int R = R0 + 4 * ty + i;
    if (R >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n >= W) continue;
      const size_t o = static_cast<size_t>(R) * W + n;
      p.P_re[o] = accr[i][j];
      p.P_im[o] = acci[i][j];
      p.P_v[o] = accv[i][j];
    }
  }
}

// ---- 2. band fold, Onsager, freeze of z and u, adjoint inputs -------------
// One thread per y-side element (b, r, m).  Tap l of output row r reads
// column block c = r - l (tail truncation: 0 <= c < Lin); the adjoint input
// of (b, c, l Nr + m) comes from row r = c + l, so each is written once.
__global__ void __launch_bounds__(kThreads) fold_kernel(Params p) {
  const int n = p.Lout * p.Nr, W = p.Lh * p.Nr;
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<size_t>(p.B) * n) return;
  const int b = static_cast<int>(e / n);
  const int o = static_cast<int>(e - static_cast<size_t>(b) * n);
  const int r = o / p.Nr, m = o - r * p.Nr;
  if (o == 0) p.notok[b] = 0;  // the denoiser launch counts into it
  const bool on = p.act[b] != 0;
  const size_t zrow = static_cast<size_t>(b) * p.Lin;
  if (!on) {
    p.zn_re[e] = p.z_re[e];
    p.zn_im[e] = p.z_im[e];
    p.un[e] = p.u[e];
    for (int l = 0; l < p.Lh; ++l) {
      const int c = r - l;
      if (c < 0 || c >= p.Lin) continue;
      const size_t q = (zrow + c) * W + l * p.Nr + m;
      p.Z_c[q] = p.Z_re[q] = p.Z_im[q] = 0.f;
    }
    return;
  }
  float v = 0.f, hr = 0.f, hi = 0.f;
  for (int l = 0; l < p.Lh; ++l) {
    const int c = r - l;
    if (c < 0 || c >= p.Lin) continue;
    const size_t q = (zrow + c) * W + l * p.Nr + m;
    const float g = p.gains[l * p.Lin + c];
    v = v + p.gains2[l * p.Lin + c] * p.P_v[q];
    hr = hr + g * p.P_re[q];
    hi = hi + g * p.P_im[q];
  }
  const float uo = p.u[e], yr = p.y_re[e], yi = p.y_im[e];
  const float zr = hr - (v * (yr - p.z_re[e])) / uo;
  const float zi = hi - (v * (yi - p.z_im[e])) / uo;
  const float uu = v + p.sigma2;
  p.zn_re[e] = zr;
  p.zn_im[e] = zi;
  p.un[e] = uu;
  const float ui = 1.f / uu, rr = (yr - zr) / uu, ri = (yi - zi) / uu;
  for (int l = 0; l < p.Lh; ++l) {
    const int c = r - l;
    if (c < 0 || c >= p.Lin) continue;
    const size_t q = (zrow + c) * W + l * p.Nr + m;
    const float g = p.gains[l * p.Lin + c];
    p.Z_c[q] = p.gains2[l * p.Lin + c] * ui;
    p.Z_re[q] = g * rr;
    p.Z_im[q] = g * ri;
  }
}

// ---- 3. adjoint products and xmap ------------------------------------------
// cs[R][k] = sum_w Z_c[R][w] |h[w][k]|^2 and (ar + i ai)[R][k] = sum_w
// (Z_re + i Z_im)[R][w] conj(h[w][k]): rows R < B Lin, columns k < Nt,
// contraction w < Lh Nr; then cov = 1 / cs and xmap = x + cov (ar + i ai).
__global__ void __launch_bounds__(kThreads) adjoint_kernel(Params p) {
  __shared__ __align__(16) float zc[kDepth][kTile];
  __shared__ __align__(16) float zr[kDepth][kTile];
  __shared__ __align__(16) float zi[kDepth][kTile];
  __shared__ __align__(16) float sa[kDepth][kTile];
  __shared__ __align__(16) float sr[kDepth][kTile];
  __shared__ __align__(16) float si[kDepth][kTile];
  const int rows = p.B * p.Lin, W = p.Lh * p.Nr, Nt = p.Nt;
  const int R0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  if (!tile_live(p, R0, rows)) return;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  // loaders: A by row lr and four consecutive w from lk; the taps by w row
  // bw and four consecutive columns from bn
  const int lr = tid >> 2, lk = (tid & 3) * 4;
  const int bw = tid >> 4, bn = (tid & 15) * 4;
  const bool a_ok = R0 + lr < rows;
  const size_t arow = static_cast<size_t>(a_ok ? R0 + lr : 0) * W;
  float fc[4], fr[4], fi[4], ga[4], gr[4], gi[4];
  auto fetch = [&](int w0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int w = w0 + lk + c;
      const bool ka = a_ok && w < W;
      fc[c] = ka ? p.Z_c[arow + w] : 0.f;
      fr[c] = ka ? p.Z_re[arow + w] : 0.f;
      fi[c] = ka ? p.Z_im[arow + w] : 0.f;
      const int wb = w0 + bw, k = n0 + bn + c;
      const bool kb = wb < W && k < Nt;
      const size_t q = static_cast<size_t>(wb) * Nt + k;
      ga[c] = kb ? __ldg(p.h_a2 + q) : 0.f;
      gr[c] = kb ? __ldg(p.h_re + q) : 0.f;
      gi[c] = kb ? __ldg(p.h_im + q) : 0.f;
    }
  };
  float cs[4][4], ar[4][4], ai[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) cs[i][j] = ar[i][j] = ai[i][j] = 0.f;
  fetch(0);
  for (int w0 = 0; w0 < W; w0 += kDepth) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      zc[lk + c][lr] = fc[c];
      zr[lk + c][lr] = fr[c];
      zi[lk + c][lr] = fi[c];
      sa[bw][bn + c] = ga[c];
      sr[bw][bn + c] = gr[c];
      si[bw][bn + c] = gi[c];
    }
    __syncthreads();
    if (w0 + kDepth < W) fetch(w0 + kDepth);
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 c4 = *reinterpret_cast<const float4*>(&zc[kk][4 * ty]);
      const float4 r4 = *reinterpret_cast<const float4*>(&zr[kk][4 * ty]);
      const float4 i4 = *reinterpret_cast<const float4*>(&zi[kk][4 * ty]);
      const float4 a4 = *reinterpret_cast<const float4*>(&sa[kk][4 * tx]);
      const float4 hr4 = *reinterpret_cast<const float4*>(&sr[kk][4 * tx]);
      const float4 hi4 = *reinterpret_cast<const float4*>(&si[kk][4 * tx]);
      const float zcs[4] = {c4.x, c4.y, c4.z, c4.w};
      const float zrs[4] = {r4.x, r4.y, r4.z, r4.w};
      const float zis[4] = {i4.x, i4.y, i4.z, i4.w};
      const float as[4] = {a4.x, a4.y, a4.z, a4.w};
      const float hrs[4] = {hr4.x, hr4.y, hr4.z, hr4.w};
      const float his[4] = {hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cs[i][j] = fmaf(zcs[i], as[j], cs[i][j]);
          // (zr + i zi) * conj(h)
          ar[i][j] = fmaf(zrs[i], hrs[j], ar[i][j]);
          ar[i][j] = fmaf(-zis[i], -his[j], ar[i][j]);
          ai[i][j] = fmaf(zrs[i], -his[j], ai[i][j]);
          ai[i][j] = fmaf(zis[i], hrs[j], ai[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int R = R0 + 4 * ty + i;
    if (R >= rows || !p.act[R / p.Lin]) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = n0 + 4 * tx + j;
      if (k >= Nt) continue;
      const size_t o = static_cast<size_t>(R) * Nt + k;
      const float cv = 1.f / cs[i][j];
      p.cov[o] = cv;
      p.xmap_re[o] = p.xm[o] + cv * ar[i][j];
      p.xmap_im[o] = cv * ai[i][j];  // the real posterior mean adds 0
    }
  }
}

// ---- 4. denoiser, freeze of x and var, notok --------------------------------
// Block (b, y) takes segments 256 y .. 256 y + 255 of trial b, a thread each.
__global__ void __launch_bounds__(kThreads) denoise_kernel(Params p) {
  __shared__ int s_bad;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int N = p.Lin * p.Nt, M = p.M;
  const int s = blockIdx.y * kThreads + tid;
  const size_t base = static_cast<size_t>(b) * N;
  if (tid == 0) s_bad = 0;
  __syncthreads();
  int bad = 0;
  if (s < N / M) {
    const float* vo = p.var + base;
    float* xo = p.xm_out + base;
    float* vn = p.var_out + base;
    const int j0 = s * M;
    if (p.act[b]) {
      const float* cv = p.cov + base;
      const float* xr = p.xmap_re + base;
      segment_posterior<true>(
          j0, M, p.K, p.sym_re, p.sym_im, true, xr, xr,
          [=](int j) { return cv[j]; },
          [=](int j, float mr, float, float v) {
            xo[j] = mr;
            vn[j] = v;
            return 0;
          });
      for (int j = j0; j < j0 + M; ++j)
        bad += !(fabsf(vn[j] - vo[j]) <= kAtol + kRtol * fabsf(vo[j]));
    } else {
      const float* xi = p.xm + base;
      for (int j = j0; j < j0 + M; ++j) {
        xo[j] = xi[j];
        vn[j] = vo[j];
      }
    }
  }
  for (int off = 16; off >= 1; off >>= 1)
    bad += __shfl_down_sync(0xffffffffu, bad, off);
  if ((tid & 31) == 0 && bad) atomicAdd(&s_bad, bad);
  __syncthreads();
  if (tid == 0 && s_bad) atomicAdd(p.notok + b, s_bad);
}

}  // namespace

extern "C" {

// Enqueue one iteration of B trials on `stream`: the four launches above, in
// order.  Returns a cudaError_t code (0 on success): cudaErrorInvalidValue
// for a geometry the kernel does not take, else the first error that
// cudaGetLastError() reports after a launch.  The kernel allocates nothing;
// every buffer, the scratch included, is the caller's.
int fused_bamp_tiled_iteration(
    const void* xm, const void* var, const void* z_re, const void* z_im,
    const void* u, const void* y_re, const void* y_im, const void* act,
    void* xmap_re, void* xmap_im, void* xm_out, void* var_out, void* zn_re,
    void* zn_im, void* un, void* notok, void* P_re, void* P_im, void* P_v,
    void* Z_c, void* Z_re, void* Z_im, void* cov, const void* h_re,
    const void* h_im, const void* h_a2, const void* gains,
    const void* gains2, const void* sym_re, const void* sym_im, int B,
    int Nt, int Nr, int Lin, int Lh, int M, int K, float sigma2,
    void* stream) {
  if (B < 1 || Nt < 1 || Nr < 1 || Lin < 1 || Lh < 1 || M < 1 ||
      Nt % M != 0 || K < 1 || K > kMaxK ||
      static_cast<long long>(B) * Lin >= (1ll << 31) ||
      static_cast<long long>(B) * (Lin + Lh - 1) * Nr >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.xm = static_cast<const float*>(xm);
  p.var = static_cast<const float*>(var);
  p.z_re = static_cast<const float*>(z_re);
  p.z_im = static_cast<const float*>(z_im);
  p.u = static_cast<const float*>(u);
  p.y_re = static_cast<const float*>(y_re);
  p.y_im = static_cast<const float*>(y_im);
  p.act = static_cast<const int*>(act);
  p.xmap_re = static_cast<float*>(xmap_re);
  p.xmap_im = static_cast<float*>(xmap_im);
  p.xm_out = static_cast<float*>(xm_out);
  p.var_out = static_cast<float*>(var_out);
  p.zn_re = static_cast<float*>(zn_re);
  p.zn_im = static_cast<float*>(zn_im);
  p.un = static_cast<float*>(un);
  p.notok = static_cast<int*>(notok);
  p.P_re = static_cast<float*>(P_re);
  p.P_im = static_cast<float*>(P_im);
  p.P_v = static_cast<float*>(P_v);
  p.Z_c = static_cast<float*>(Z_c);
  p.Z_re = static_cast<float*>(Z_re);
  p.Z_im = static_cast<float*>(Z_im);
  p.cov = static_cast<float*>(cov);
  p.h_re = static_cast<const float*>(h_re);
  p.h_im = static_cast<const float*>(h_im);
  p.h_a2 = static_cast<const float*>(h_a2);
  p.gains = static_cast<const float*>(gains);
  p.gains2 = static_cast<const float*>(gains2);
  p.sym_re = static_cast<const float*>(sym_re);
  p.sym_im = static_cast<const float*>(sym_im);
  p.B = B;
  p.Nt = Nt;
  p.Nr = Nr;
  p.Lin = Lin;
  p.Lout = Lin + Lh - 1;
  p.Lh = Lh;
  p.M = M;
  p.K = K;
  p.sigma2 = sigma2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * Lin, W = Lh * Nr;
  const int row_tiles = (rows + kTile - 1) / kTile;
  forward_kernel<<<dim3(row_tiles, (W + kTile - 1) / kTile), kThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ny = static_cast<long long>(B) * p.Lout * Nr;
  fold_kernel<<<static_cast<unsigned>((ny + kThreads - 1) / kThreads),
                kThreads, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  adjoint_kernel<<<dim3(row_tiles, (Nt + kTile - 1) / kTile), kThreads, 0,
                   s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int segs = Lin * Nt / M;
  denoise_kernel<<<dim3(B, (segs + kThreads - 1) / kThreads), kThreads, 0,
                   s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_bamp_tiled_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
