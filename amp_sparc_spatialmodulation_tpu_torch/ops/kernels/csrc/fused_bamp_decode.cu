// Whole BAMP decode on an NVIDIA Hopper GPU: one thread block per trial,
// with the iteration loop inside the block.
//
// Replaces the TPU kernel amp_sparc_spatialmodulation_tpu/ops/pallas/
// fused_bamp.py::_decode_kernel (reached through
// FusedBandedDecode.decode_call).  Each iteration of one trial runs
//
//   v    = |H|^2 var                        (banded forward, Lh taps)
//   z'   = H xmmse - v (y - z) / u          (banded forward + Onsager)
//   u'   = v + sigma2
//   cov  = 1 / (|H|^2^T (1/u'))             (banded adjoint)
//   xmap = xmmse + cov H^H ((y - z') / u')  (banded adjoint)
//
// then the segmented softmax denoiser (general K, tau/2 calibration,
// decomposed variance) or the Bernoulli-mixture denoiser (random mode),
// then the per-trial allclose(rtol=1e-5, atol=1e-8) test on the posterior
// variance.  A trial stops at its own convergence; frozen trials pass
// through unchanged, so the per-trial T equals the plain loop's.
//
// Bound on this card: FP32 operations.  At the flagship geometry (Nt=128,
// Nr=24, Lin=20, Lout=22, Lh=3, OOK) one iteration of one trial does 8
// real banded products of 2*Lin*Nt*Lh*Nr = 368,640 flop each, about 2.95
// MFLOP, against ~62 KB of device-memory traffic per decoded trial: at 67
// TFLOP/s FP32 and 3.35 TB/s that is ~44 ns per iteration per trial of
// compute against ~19 ns per trial of memory.  The design keeps every
// loop-carried plane of the trial in shared memory (no state returns to
// device memory between iterations), reads the taps through the read-only
// path, and runs all arithmetic in FP32 on the CUDA cores (no TF32).
//
// Rounding.  The stop test compares the posterior variance at rtol=1e-5,
// and a converged variance of a decided lane is 1 - p with p = eta/eta2
// one ulp-step below 1, so a trial's T depends on the last bit of the
// segment sums.  The kernel therefore rounds where the plain PyTorch
// version (decode_plain in fused_bamp.py) rounds: it is built with
// -fmad=false, so every elementwise expression rounds after each operation
// as PyTorch's separate elementwise kernels do; the banded products are
// sequential FMA chains over the contraction index (real part before
// imaginary part in a complex product), the order cuBLAS's FP32 GEMMs
// take at the decode's batch sizes; the gain-weighted adjoint input is
// formed before the product, as the plain adjoint does; and every sum over
// a segment or the symbol table follows the order of PyTorch's CUDA
// reduction over a contiguous innermost dimension (torch_sum in
// decode_common.cuh, which holds the helpers this kernel shares with the
// SCAMP kernel).  The
// kernel's state then matches the plain version's bit for bit, which
// chip_smoke.py checks on the card.
//
// Layouts: every state vector is per-trial contiguous, complex values
// interleaved (PyTorch complex64): x-side (B, Lin*Nt), y-side (B, Lout*Nr).
// Taps come as h (Lh, Nr, Nt) for the adjoint and hT (Lh, Nt, Nr) for the
// forward, so neighbouring threads read neighbouring addresses in both;
// gains are (Lh, Lin) per (tap, column block), taken as they come.

#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int kThreads = 256;
constexpr float kZeroTol = 1e-9f;

enum Denoiser { kSegmented = 0, kMixture = 1 };

struct Params {
  const float2* y;
  const float2* xmap_in;
  const float2* xmmse_in;
  const float* var_in;
  const float2* z_in;
  const float* u_in;
  const int* act_in;
  const int* T_in;
  float2* xmap_out;
  float2* xmmse_out;
  float* var_out;
  float2* z_out;
  float* u_out;
  int* act_out;
  int* T_out;
  const float2* h;      // (Lh, Nr, Nt)
  const float2* hT;     // (Lh, Nt, Nr)
  const float* a2;      // |h|^2, (Lh, Nr, Nt)
  const float* a2T;     // |h|^2, (Lh, Nt, Nr)
  const float* gains;   // (Lh, Lin)
  const float* gains2;  // gains^2, (Lh, Lin)
  const float* sym_re;  // (K,)
  const float* sym_im;  // (K,)
  int Nt, Nr, Lin, Lout, Lh, trunc, M, K, den, real_x;
  float Ps, P0, sigma2;
  int cap;  // remaining iteration budget
};

__global__ void __launch_bounds__(kThreads) bamp_decode_kernel(Params p) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int N = p.Lin * p.Nt;
  const int n = p.Lout * p.Nr;
  const int W = p.Lh * p.Nr;
  const size_t xo = static_cast<size_t>(b) * N;
  const size_t yo = static_cast<size_t>(b) * n;
  const bool real_x = p.real_x != 0;
  int act = p.act_in[b];
  int T = p.T_in[b];

  if (!act || p.cap <= 0) {
    // Frozen trial: state passes through.
    for (int j = tid; j < N; j += blockDim.x) {
      p.xmap_out[xo + j] = p.xmap_in[xo + j];
      p.xmmse_out[xo + j] = p.xmmse_in[xo + j];
      p.var_out[xo + j] = p.var_in[xo + j];
    }
    for (int o = tid; o < n; o += blockDim.x) {
      p.z_out[yo + o] = p.z_in[yo + o];
      p.u_out[yo + o] = p.u_in[yo + o];
    }
    if (tid == 0) {
      p.act_out[b] = act;
      p.T_out[b] = T;
    }
    return;
  }

  // Shared-memory planes of this trial, in the order whose size
  // smem_bytes() in fused_bamp.py computes.
  extern __shared__ float sm[];
  float* xm_re = sm;
  float* xm_im = xm_re + N;                 // absent for real alphabets
  float* var = xm_im + (real_x ? 0 : N);
  float* xmap_re = var + N;
  float* xmap_im = xmap_re + N;
  float* cov = xmap_im + N;
  float* y_re = cov + N;
  float* y_im = y_re + n;
  float* z_re = y_im + n;
  float* z_im = z_re + n;
  float* u = z_im + n;
  // Gain-weighted adjoint inputs per (column block c, tap l, antenna m):
  // gains2[l,c] / u', gains[l,c] (y - z') / u' at row block c + l.
  float* Zc = u + n;
  float* Zr = Zc + p.Lin * W;
  float* Zi = Zr + p.Lin * W;

  for (int j = tid; j < N; j += blockDim.x) {
    const float2 m = p.xmmse_in[xo + j];
    xm_re[j] = m.x;
    if (!real_x) xm_im[j] = m.y;
    var[j] = p.var_in[xo + j];
  }
  for (int o = tid; o < n; o += blockDim.x) {
    const float2 yy = p.y[yo + o];
    const float2 zz = p.z_in[yo + o];
    y_re[o] = yy.x;
    y_im[o] = yy.y;
    z_re[o] = zz.x;
    z_im[o] = zz.y;
    u[o] = p.u_in[yo + o];
  }
  __syncthreads();

  const size_t tap_stride = static_cast<size_t>(p.Nt) * p.Nr;
  for (int it = 0; it < p.cap; ++it) {
    // ---- forward maps + Onsager residual: thread per output (r, m) ----
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
        const float* vr = var + c * p.Nt;
        float pv = 0.f, pr = 0.f, pi = 0.f;
        if (real_x) {
          for (int k = 0; k < p.Nt; ++k) {
            const float2 hv = __ldg(ht + k * p.Nr);
            const float x = xr[k];
            pv = fmaf(vr[k], __ldg(at + k * p.Nr), pv);
            pr = fmaf(x, hv.x, pr);
            pi = fmaf(x, hv.y, pi);
          }
        } else {
          const float* xi = xm_im + c * p.Nt;
          for (int k = 0; k < p.Nt; ++k) {
            const float2 hv = __ldg(ht + k * p.Nr);
            const float x = xr[k], xj = xi[k];
            pv = fmaf(vr[k], __ldg(at + k * p.Nr), pv);
            pr = fmaf(x, hv.x, pr);
            pr = fmaf(-xj, hv.y, pr);
            pi = fmaf(x, hv.y, pi);
            pi = fmaf(xj, hv.x, pi);
          }
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

    // ---- adjoint inputs, weighted by the gains of their (tap, column) ---
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

    // ---- adjoint maps: thread per x-side element (c, k) -----------------
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
      xmap_im[j] = real_x ? cv * ai : xm_im[j] + cv * ai;
    }
    __syncthreads();

    // ---- denoiser, allclose test and state update -----------------------
    int bad = 0;
    const float* sr = p.sym_re;
    const float* si = p.sym_im;
    if (p.den == kSegmented) {
      // Thread per segment: the plain version's segmented posterior with
      // tau = cov / 2 and the decomposed variance.
      for (int s = tid; s < N / p.M; s += blockDim.x) {
        bad |= segment_posterior<true>(
            s * p.M, p.M, p.K, sr, si, real_x, xmap_re, xmap_im,
            [=](int j) { return cov[j]; },
            [=](int j, float mr, float mi, float vn) {
              const float old = var[j];
              xm_re[j] = mr;
              if (!real_x) xm_im[j] = mi;
              var[j] = vn;
              return int(fabsf(vn - old) > kAtol + kRtol * fabsf(old));
            });
      }
    } else {
      // Bernoulli-symbol mixture: lane-local, with the exponent clamps and
      // the zero-norm guard of the plain version.
      const int K = p.K;
      for (int j = tid; j < N; j += blockDim.x) {
        const float cv = cov[j];
        const float xr = xmap_re[j], xi = xmap_im[j];
        const float g0 = expf(-fminf(abs2(xr, xi) / cv, kExpMax));
        float g[kMaxK];
        for (int q = 0; q < K; ++q)
          g[q] = expf(-fminf(abs2(xr - sr[q], xi - si[q]) / cv, kExpMax));
        float norm = p.P0 * g0 + p.Ps * torch_sum(K, [&](int q) { return g[q]; });
        if (norm == 0.f) norm = kZeroTol;
        const float mr =
            (p.Ps * torch_sum(K, [&](int q) { return sr[q] * g[q]; })) / norm;
        const float mi =
            (p.Ps * torch_sum(K, [&](int q) { return si[q] * g[q]; })) / norm;
        const float second =
            (p.Ps * torch_sum(K, [&](int q) {
              return abs2(sr[q], si[q]) * g[q];
            })) / norm;
        const float vn = second - abs2(mr, mi);
        const float old = var[j];
        bad |= fabsf(vn - old) > kAtol + kRtol * fabsf(old);
        xm_re[j] = mr;
        if (!real_x) xm_im[j] = mi;
        var[j] = vn;
      }
    }
    ++T;
    if (!__syncthreads_or(bad)) {
      act = 0;
      break;
    }
  }

  for (int j = tid; j < N; j += blockDim.x) {
    p.xmap_out[xo + j] = make_float2(xmap_re[j], xmap_im[j]);
    p.xmmse_out[xo + j] = make_float2(xm_re[j], real_x ? 0.f : xm_im[j]);
    p.var_out[xo + j] = var[j];
  }
  for (int o = tid; o < n; o += blockDim.x) {
    p.z_out[yo + o] = make_float2(z_re[o], z_im[o]);
    p.u_out[yo + o] = u[o];
  }
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
int fused_bamp_decode(
    const void* y, const void* xmap_in, const void* xmmse_in,
    const void* var_in, const void* z_in, const void* u_in,
    const void* act_in, const void* T_in,
    void* xmap_out, void* xmmse_out, void* var_out, void* z_out,
    void* u_out, void* act_out, void* T_out,
    const void* h, const void* hT, const void* a2, const void* a2T,
    const void* gains, const void* gains2,
    const void* sym_re, const void* sym_im,
    int B, int Nt, int Nr, int Lin, int Lout, int Lh, int trunc, int M,
    int K, int den, int real_x, float Ps, float P0, float sigma2, int cap,
    int smem, void* stream) {
  if (K < 1 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.y = static_cast<const float2*>(y);
  p.xmap_in = static_cast<const float2*>(xmap_in);
  p.xmmse_in = static_cast<const float2*>(xmmse_in);
  p.var_in = static_cast<const float*>(var_in);
  p.z_in = static_cast<const float2*>(z_in);
  p.u_in = static_cast<const float*>(u_in);
  p.act_in = static_cast<const int*>(act_in);
  p.T_in = static_cast<const int*>(T_in);
  p.xmap_out = static_cast<float2*>(xmap_out);
  p.xmmse_out = static_cast<float2*>(xmmse_out);
  p.var_out = static_cast<float*>(var_out);
  p.z_out = static_cast<float2*>(z_out);
  p.u_out = static_cast<float*>(u_out);
  p.act_out = static_cast<int*>(act_out);
  p.T_out = static_cast<int*>(T_out);
  p.h = static_cast<const float2*>(h);
  p.hT = static_cast<const float2*>(hT);
  p.a2 = static_cast<const float*>(a2);
  p.a2T = static_cast<const float*>(a2T);
  p.gains = static_cast<const float*>(gains);
  p.gains2 = static_cast<const float*>(gains2);
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
  p.den = den;
  p.real_x = real_x;
  p.Ps = Ps;
  p.P0 = P0;
  p.sigma2 = sigma2;
  p.cap = cap;
  cudaError_t err = cudaFuncSetAttribute(
      bamp_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bamp_decode_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_bamp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
