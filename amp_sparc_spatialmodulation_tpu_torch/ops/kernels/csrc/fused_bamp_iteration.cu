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
// (fused_bamp_decode.cu), whose loops this kernel runs once: 10 real banded
// products of 2 Lin Nt Lh Nr flop per trial-iteration for a complex x, about
// 3.7 MFLOP at the flagship geometry (55 ns at 67 TFLOP/s), against the
// state read and written once (about 62 KB, 19 ns at 3.35 TB/s).  The design
// keeps the trial's planes in shared memory for the iteration, reads the
// taps through the read-only path, and runs all arithmetic in FP32 on the
// CUDA cores (no TF32).  Unlike K1 it returns to device memory after every
// iteration, as the TPU kernels it replaces do: that is their contract.
//
// The flag is read at run time, not a template parameter: compiled as two
// template instances, the K7 instance got another register allocation and
// ran at more than twice K6's time at the flagship shape; one kernel with
// the flag runs both at about K6's time, with bit-identical results
// (PERF.md, section 6).
//
// Rounding: as K1's (built with -fmad=false; the banded products are FMA
// chains over the contraction index in the order of the matrix library's
// complex GEMM; segment sums in PyTorch's reduction order), so the kernel
// matches its plain version (fused_bamp_iteration.py), which chip_smoke.py
// checks on the card.
//
// Layouts: float32 planes, trial-major: x-side (B, Lin*Nt), y-side
// (B, Lout*Nr).  Taps h (Lh, Nr, Nt) and hT (Lh, Nt, Nr) complex64, |h|^2 in
// both orders, gains and gains^2 (Lh, Lin).

#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int kThreads = 256;

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
};

__global__ void __launch_bounds__(kThreads) iteration_kernel(Params p) {
  const bool fused = p.fused != 0;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int N = p.Lin * p.Nt;
  const int n = p.Lout * p.Nr;
  const int W = p.Lh * p.Nr;
  const size_t xo = static_cast<size_t>(b) * N;
  const size_t yo = static_cast<size_t>(b) * n;

  if (fused && !p.act[b]) {
    // Frozen trial: the state passes through.
    for (int j = tid; j < N; j += blockDim.x) {
      p.xn_re[xo + j] = p.xm_re[xo + j];
      p.xn_im[xo + j] = p.xm_im[xo + j];
      p.out_var[xo + j] = p.var[xo + j];
    }
    for (int o = tid; o < n; o += blockDim.x) {
      p.zn_re[yo + o] = p.z_re[yo + o];
      p.zn_im[yo + o] = p.z_im[yo + o];
      p.un[yo + o] = p.u[yo + o];
    }
    if (tid == 0) p.notok[b] = 0;
    return;
  }

  // Shared-memory planes of this trial, in the order whose size
  // smem_bytes() in fused_bamp_iteration.py computes.
  extern __shared__ float sm[];
  float* xm_re = sm;
  float* xm_im = xm_re + N;
  float* var = xm_im + N;
  float* xmap_re = var + N;
  float* xmap_im = xmap_re + N;
  float* cov = xmap_im + N;
  float* y_re = cov + N;
  float* y_im = y_re + n;
  float* z_re = y_im + n;
  float* z_im = z_re + n;
  float* u = z_im + n;
  // Gain-weighted adjoint inputs per (column block c, tap l, antenna m).
  float* Zc = u + n;
  float* Zr = Zc + p.Lin * W;
  float* Zi = Zr + p.Lin * W;
  __shared__ int s_bad;

  for (int j = tid; j < N; j += blockDim.x) {
    xm_re[j] = p.xm_re[xo + j];
    xm_im[j] = p.xm_im[xo + j];
    var[j] = p.var[xo + j];
  }
  for (int o = tid; o < n; o += blockDim.x) {
    y_re[o] = p.y_re[yo + o];
    y_im[o] = p.y_im[yo + o];
    z_re[o] = p.z_re[yo + o];
    z_im[o] = p.z_im[yo + o];
    u[o] = p.u[yo + o];
  }
  if (tid == 0) s_bad = 0;
  __syncthreads();

  const size_t tap_stride = static_cast<size_t>(p.Nt) * p.Nr;
  // ---- forward maps + Onsager residual: thread per output (r, m) ----------
  for (int o = tid; o < n; o += blockDim.x) {
    const int r = o / p.Nr;
    const int m = o - r * p.Nr;
    float v = 0.f, hx_re = 0.f, hx_im = 0.f;
    for (int l = 0; l < p.Lh; ++l) {
      const int c = src_block(r, l, p);
      if (c < 0) continue;
      const float2* ht = p.hT + l * tap_stride + m;
      const float* at = p.a2T + l * tap_stride + m;
      const float* xr = xm_re + c * p.Nt;
      const float* xi = xm_im + c * p.Nt;
      const float* vr = var + c * p.Nt;
      float pv = 0.f, pr = 0.f, pi = 0.f;
      for (int k = 0; k < p.Nt; ++k) {
        const float2 hv = __ldg(ht + k * p.Nr);
        const float x = xr[k], xj = xi[k];
        pv = fmaf(vr[k], __ldg(at + k * p.Nr), pv);
        pr = fmaf(x, hv.x, pr);
        pr = fmaf(-xj, hv.y, pr);
        pi = fmaf(x, hv.y, pi);
        pi = fmaf(xj, hv.x, pi);
      }
      const float g = p.gains[l * p.Lin + c];
      v = v + p.gains2[l * p.Lin + c] * pv;
      hx_re = hx_re + g * pr;
      hx_im = hx_im + g * pi;
    }
    const float uo = u[o];
    const float zr = hx_re - (v * (y_re[o] - z_re[o])) / uo;
    const float zi = hx_im - (v * (y_im[o] - z_im[o])) / uo;
    z_re[o] = zr;
    z_im[o] = zi;
    u[o] = v + p.sigma2;
  }
  __syncthreads();

  // ---- adjoint inputs, weighted by the gains of their (tap, column) -------
  for (int e = tid; e < p.Lin * W; e += blockDim.x) {
    const int c = e / W;
    const int l = (e - c * W) / p.Nr;
    const int m = e - c * W - l * p.Nr;
    const int r = dst_block(c, l, p);
    if (r < 0) continue;  // never read: the adjoint skips this tap
    const int o = r * p.Nr + m;
    const float un = u[o];
    Zc[e] = p.gains2[l * p.Lin + c] * (1.f / un);
    Zr[e] = p.gains[l * p.Lin + c] * ((y_re[o] - z_re[o]) / un);
    Zi[e] = p.gains[l * p.Lin + c] * ((y_im[o] - z_im[o]) / un);
  }
  __syncthreads();

  // ---- adjoint maps: thread per x-side element (c, k) ---------------------
  for (int j = tid; j < N; j += blockDim.x) {
    const int c = j / p.Nt;
    const int k = j - c * p.Nt;
    float cs = 0.f, ar = 0.f, ai = 0.f;
    for (int l = 0; l < p.Lh; ++l) {
      if (dst_block(c, l, p) < 0) continue;
      const float2* hl = p.h + l * tap_stride + k;
      const float* al = p.a2 + l * tap_stride + k;
      const float* zc = Zc + c * W + l * p.Nr;
      const float* zr = Zr + c * W + l * p.Nr;
      const float* zi = Zi + c * W + l * p.Nr;
      for (int m = 0; m < p.Nr; ++m) {
        const float2 hv = __ldg(hl + m * p.Nt);
        cs = fmaf(zc[m], __ldg(al + m * p.Nt), cs);
        // (zr + i zi) * conj(h)
        ar = fmaf(zr[m], hv.x, ar);
        ar = fmaf(-zi[m], -hv.y, ar);
        ai = fmaf(zr[m], -hv.y, ai);
        ai = fmaf(zi[m], hv.x, ai);
      }
    }
    const float cv = 1.f / cs;
    cov[j] = cv;
    xmap_re[j] = xm_re[j] + cv * ar;
    xmap_im[j] = xm_im[j] + cv * ai;
  }
  __syncthreads();

  if (fused) {
    // ---- K=1 denoiser with the closed-form variance: thread per segment -
    const float sr = p.s0_re, si = p.s0_im;
    const float s2 = abs2(sr, si);
    const int M = p.M;
    int bad = 0;
    for (int s = tid; s < N / M; s += blockDim.x) {
      const int j0 = s * M;
      auto t_of = [&](int i) {
        const int j = j0 + i;
        const float tau = cov[j] / 2.f;
        return re_conj_mul(xmap_re[j] / tau, xmap_im[j] / tau, sr, si);
      };
      float segmax = -INFINITY;
      for (int i = 0; i < M; ++i) segmax = fmaxf(segmax, t_of(i));
      auto eta = [&](int i) {
        return expf(fminf(t_of(i) - segmax, kExpMax));
      };
      const float eta2 = torch_sum(M, eta);
      for (int i = 0; i < M; ++i) {
        const int j = j0 + i;
        const float post = eta(i) / eta2;
        const float vn = s2 * post * (1.f - post);
        const float old = var[j];
        bad += !(fabsf(vn - old) <= kAtol + kRtol * fabsf(old));
        p.xn_re[xo + j] = sr * post;
        p.xn_im[xo + j] = si * post;
        p.out_var[xo + j] = vn;
      }
    }
    if (bad) atomicAdd(&s_bad, bad);
  } else {
    for (int j = tid; j < N; j += blockDim.x) p.out_var[xo + j] = cov[j];
  }

  for (int j = tid; j < N; j += blockDim.x) {
    p.xmap_re[xo + j] = xmap_re[j];
    p.xmap_im[xo + j] = xmap_im[j];
  }
  for (int o = tid; o < n; o += blockDim.x) {
    p.zn_re[yo + o] = z_re[o];
    p.zn_im[yo + o] = z_im[o];
    p.un[yo + o] = u[o];
  }
  if (fused) {
    __syncthreads();
    if (tid == 0) p.notok[b] = s_bad;
  }
}

}  // namespace

extern "C" {

// Launch one iteration of B trials on `stream` with `smem` bytes of dynamic
// shared memory per block: K6 when fused is nonzero, else K7 (act, xn_*
// and notok are then not read or written, and out_var receives cov).  Returns a cudaError_t code (0 on success): the attribute
// call's, or cudaGetLastError() after the launch.  The kernel allocates
// nothing; every buffer is the caller's.
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
