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
// TF32).
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
// does so (vec4_psi).
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

__global__ void __launch_bounds__(kThreads) scamp_decode_kernel(Params p) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int N = p.Lin * p.Nt;
  const int n = p.Lout * p.Nr;
  const int W = p.Lh * p.Nr;
  const size_t xo = static_cast<size_t>(b) * N;
  const size_t yo = static_cast<size_t>(b) * n;
  const size_t po = static_cast<size_t>(b) * p.Lin;
  const size_t fo = static_cast<size_t>(b) * p.Lout;
  const bool real_x = p.real_x != 0;
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
  // smem_bytes() in fused_scamp.py computes.
  extern __shared__ float sm[];
  float* xm_re = sm;
  float* xm_im = xm_re + N;                 // absent for real alphabets
  float* xmap_re = xm_im + (real_x ? 0 : N);
  float* xmap_im = xmap_re + N;
  float* y_re = xmap_im + N;
  float* y_im = y_re + n;
  float* z_re = y_im + n;
  float* z_im = z_re + n;
  // Gain-weighted adjoint inputs per (column block c, tap l, antenna m):
  // gains[l,c] (z' / phi') at row block c + l.
  float* Zr = z_im + n;
  float* Zi = Zr + p.Lin * W;
  float* psi = Zi + p.Lin * W;
  float* tau = psi + p.Lin;
  float* phi = tau + p.Lin;
  float* ons = phi + p.Lout;                // b = gma / phi per row block

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

  const size_t tap_stride = static_cast<size_t>(p.Nt) * p.Nr;
  for (int it = 0; it < p.cap; ++it) {
    // ---- gma = psi W^T / Lin, b = gma / phi, phi' = sigma2 + gma --------
    for (int r = tid; r < p.Lout; r += blockDim.x) {
      const float* Wr = p.W + r * p.Lin;
      float g =
          torch_sum(p.Lin, [&](int c) { return psi[c] * __ldg(Wr + c); });
      g = g * p.inv_Lc;
      ons[r] = g / phi[r];
      if (!p.estimate_phi) phi[r] = g + p.sigma2;
    }
    __syncthreads();

    // ---- forward map + Onsager residual: thread per output (r, m) -------
    for (int o = tid; o < n; o += blockDim.x) {
      const int r = o / p.Nr;
      const int m = o - r * p.Nr;
      float hx_re = 0.f, hx_im = 0.f;
      for (int l = 0; l < p.Lh; ++l) {
        const int c = src_block(r, l, p);
        if (c < 0) continue;
        const float2* ht = p.hT + l * tap_stride + m;
        const float* xr = xm_re + c * p.Nt;
        float pr = 0.f, pi = 0.f;
        if (real_x) {
          for (int k = 0; k < p.Nt; ++k) {
            const float2 hv = __ldg(ht + k * p.Nr);
            const float x = xr[k];
            pr = fmaf(x, hv.x, pr);
            pi = fmaf(x, hv.y, pi);
          }
        } else {
          const float* xi = xm_im + c * p.Nt;
          for (int k = 0; k < p.Nt; ++k) {
            const float2 hv = __ldg(ht + k * p.Nr);
            const float x = xr[k], xj = xi[k];
            pr = fmaf(x, hv.x, pr);
            pr = fmaf(-xj, hv.y, pr);
            pi = fmaf(x, hv.y, pi);
            pi = fmaf(xj, hv.x, pi);
          }
        }
        const float g = p.gains[l * p.Lin + c];
        hx_re = hx_re + g * pr;
        hx_im = hx_im + g * pi;
      }
      const float br = ons[r];
      z_re[o] = (y_re[o] - hx_re) + br * z_re[o];
      z_im[o] = (y_im[o] - hx_im) + br * z_im[o];
    }
    __syncthreads();

    // ---- phi' = mean |z'|^2 per row block (estimate_phi): warp per block
    if (p.estimate_phi) {
      for (int r = warp; r < p.Lout; r += kWarps) {
        const float* zr = z_re + r * p.Nr;
        const float* zi = z_im + r * p.Nr;
        const float s = warp_torch_sum(
            p.Nr, false, [&](int m) { return abs2(zr[m], zi[m]); });
        if (lane == 0) phi[r] = s * p.inv_Mr;
      }
      __syncthreads();
    }

    // ---- tau = L / (W^T (1/phi')) / Nr, and the adjoint inputs ----------
    for (int c = tid; c < p.Lin; c += blockDim.x) {
      const float m = torch_sum(p.Lout, [&](int r) {
        return (1.f / phi[r]) * __ldg(p.W + r * p.Lin + c);
      });
      tau[c] = ((1.f / m) * p.L) * p.inv_Mr;
    }
    for (int e = tid; e < p.Lin * W; e += blockDim.x) {
      const int c = e / W;
      const int l = (e - c * W) / p.Nr;
      const int m = e - c * W - l * p.Nr;
      const int r = dst_block(c, l, p);
      if (r < 0) continue;  // never read: the adjoint skips this tap
      const int o = r * p.Nr + m;
      const float g = p.gains[l * p.Lin + c];
      Zr[e] = g * (z_re[o] / phi[r]);
      Zi[e] = g * (z_im[o] / phi[r]);
    }
    __syncthreads();

    // ---- adjoint map: thread per x-side element (c, k) ------------------
    for (int j = tid; j < N; j += blockDim.x) {
      const int c = j / p.Nt;
      const int k = j - c * p.Nt;
      float ar = 0.f, ai = 0.f;
      for (int l = 0; l < p.Lh; ++l) {
        if (dst_block(c, l, p) < 0) continue;
        const float2* hl = p.h + l * tap_stride + k;
        const float* zr = Zr + c * W + l * p.Nr;
        const float* zi = Zi + c * W + l * p.Nr;
        for (int m = 0; m < p.Nr; ++m) {
          const float2 hv = __ldg(hl + m * p.Nt);
          // (zr + i zi) * conj(h)
          ar = fmaf(zr[m], hv.x, ar);
          ar = fmaf(-zi[m], -hv.y, ar);
          ai = fmaf(zr[m], -hv.y, ai);
          ai = fmaf(zi[m], hv.x, ai);
        }
      }
      const float tc = tau[c];
      xmap_re[j] = xm_re[j] + tc * ar;
      xmap_im[j] = real_x ? tc * ai : xm_im[j] + tc * ai;
    }
    __syncthreads();

    // ---- mean-only segmented denoiser: thread per segment ---------------
    for (int s = tid; s < N / p.M; s += blockDim.x) {
      const int Nt = p.Nt;
      segment_posterior<false>(
          s * p.M, p.M, p.K, p.sym_re, p.sym_im, real_x, xmap_re, xmap_im,
          [=](int j) { return tau[j / Nt]; },
          [=](int j, float mr, float mi, float) {
            xm_re[j] = mr;
            if (!real_x) xm_im[j] = mi;
            return 0;
          });
    }
    __syncthreads();

    // ---- psi' = 1 - sum |xmmse|^2 / Na per column block: warp per block,
    // then the allclose test on psi --------------------------------------
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
    p.xmap_out[xo + j] = make_float2(xmap_re[j], xmap_im[j]);
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
