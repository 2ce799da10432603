// Whole vamp2 (damped Rangan VAMP) decode on an NVIDIA Hopper GPU: one
// thread block per tile of 64 trials, with the iteration loop inside the
// block.
//
// Replaces the TPU kernel amp_sparc_spatialmodulation_tpu/ops/pallas/
// fused_vamp2.py:39 _vamp2_decode_kernel (reached through
// FusedVamp2Decode.decode_call).  Each iteration of a tile runs, with s^2
// the squared singular values, eta = N / p and the damping rho,
//
//   1. per segment of M lanes the softmax posterior of r with effective
//      noise gamma, WITHOUT the tau/2 halving, second-moment variance;
//      xmmse = rho xmmse_new + (1 - rho) xmmse; the per-trial allclose of
//      the variance; alpha = mean(var) gamma;
//      r_tilde = (xmmse - alpha r) / (1 - alpha);
//      gamma_tilde = clip(gamma (1 - alpha) / alpha, 1e-11, 1e11);
//   2. d = s^2 / (s^2 + sigma2 gamma_tilde) and its mean over p;
//      gamma = rho gamma_tilde d_mean / (eta - d_mean) + (1 - rho) gamma;
//   3. w = (d / d_mean) (y_tilde - r_tilde Vh^T) (K = N);
//   4. r = r_tilde + eta w conj(Vh) (K = p).
//
// Trials already converged at the start of an iteration keep their state;
// the tile stops when its last trial has converged or the remaining budget
// cap is spent.  y_tilde is the whitened data (y U^*) / s, formed outside
// from the direct SVD.
//
// Bound on this card: FP32 operations, as for fused_vamp_decode.cu, whose
// design this kernel shares (vamp_common.cuh): the same two products with
// the factor per iteration (8 real products of 2 N p flop per trial and
// iteration, 4-product complex form), the state in device memory, the
// products streamed through a cp.async ring in shared memory into a
// 4-trial x 3- or 2-column complex register tile per thread, summed in
// chains of 16 over k with the running sums in registers, FP32 on the CUDA
// cores, two blocks of 256 threads per SM.
// r_tilde needs the whole row's variance sum before the first product, so
// step 1 writes it over r (the old r is not needed after it), and step 4
// adds the second product to it.
//
// The HIGH form (template kHigh; precision='high', the JAX kernel's
// make_dot(Precision.HIGH) = dot3): both products as the Gauss form's
// three real products in bf16 x 3 passes on the tensor cores
// (vamp_common.cuh, product_x3) on the wrapper's split tap planes
// (fused_vamp2.py:89-91, :102-104 of the JAX package), and alpha and
// d_mean, which JAX writes as products with ones (:72, :82), as sum(hi) +
// sum(lo).  Each product's trial side is split into bf16 once, where it is
// written: step 3 splits r_tilde, the first product's epilogue writes w
// split (no FP32 w), into the wrapper's scratch xs, one region per block.
// The HIGHEST instance (kHigh false) is the code above, unchanged.
//
// The DEFAULT form (kOne; precision='default', make_dot(Precision.DEFAULT),
// one bf16 pass) is the HIGH form's code with alpha and d_mean as sum(hi)
// (warp_rowsum1) and the products on K3's one-pass engine
// (vamp_common.cuh, product_x1, through product_x3<true>; the wrapper's
// fused_vamp.default_taps); its plain version is vamp2.plain_loop_default.
// On this card (NVIDIA H100 80GB HBM3 at 700 W, the main path,
// tests/torch_kernel_ab.py, PERF.md) it went from 314 ms on the HIGH
// layout, more than half of it in the denoiser, to 136 ms, bound as K3's
// DEFAULT form is (fused_vamp_decode.cu).
//
// Layouts: r, xmmse (B, N) complex64, var (B, N), gamma (B, 1), y_tilde
// (B, p) complex64; Vh (p, N) complex64, s^2 (p,); the scratch w (B, p)
// complex64.  Built with -fmad=false: every FMA is explicit.

#include "vamp_common.cuh"

namespace {

using namespace vamp;

constexpr float kVarMin = 1e-11f;  // vamp2.py:48-49
constexpr float kVarMax = 1e11f;

struct Params {
  float2* r;          // (B, N), in/out
  float* gamma;       // (B,), in/out
  float* var;         // (B, N), in/out
  float2* xm;         // xmmse (B, N), in/out
  int* act;           // (B,), in/out
  int* T;             // (B,), in/out
  const float2* yt;   // whitened y_tilde (B, p)
  const float* s2;    // (p,)
  const float2* Vh;   // (p, N)
  float2* w;          // scratch (B, p)
  const float* sym_re;
  const float* sym_im;
  int B, N, p, M, K, vec4_p, vec4_N;
  float sigma2, eta, rho, omr, inv_p, inv_N;  // omr = 1 - rho from double
  int cap;  // remaining iteration budget
  // HIGH form only: the split Gauss tap tiles (vamp_common.cuh,
  // product_x3: the forward's, then the adjoint's); ldf, ldb: N, p rounded
  // up to 16
  const __nv_bfloat16* taps;
  int ldf, ldb;
  // HIGH form only: the blocks' split operands (vamp_common.cuh,
  // split_at), per block the forward's r_tilde (ldf / 16 steps), then the
  // adjoint's w (ldb / 16 steps)
  __nv_bfloat16* xs;
};

template <bool kHigh, bool kOne>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    vamp2_decode_kernel(Params P) {
  const int tid = threadIdx.x;
  const int ty = tid / kTx, tx = tid % kTx;  // product tiles (vamp_common)
  const int warp = tid >> 5, lane = tid & 31;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * kBt;
  const int nrows = min(kBt, P.B - static_cast<int>(row0));
  const int N = P.N, p = P.p, M = P.M;
  const float2* Vh = P.Vh;
  const float* s2 = P.s2;
  float2* r = P.r + row0 * N;
  float* var = P.var + row0 * N;
  float2* xm = P.xm + row0 * N;
  const float2* yt = P.yt + row0 * p;
  float2* w = P.w + row0 * p;

  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  SmemX3& smx = *reinterpret_cast<SmemX3*>(smem_raw);
  const int kf = P.ldf / kBK, kb = P.ldb / kBK;  // k16 steps of each
  // the form's split step and tap tiles (DEFAULT: hi parts only)
  constexpr int kStep = kOne ? kSplitStep1 : kSplitStep;
  const __nv_bfloat16* tf = P.taps;
  const __nv_bfloat16* tb =
      tf + (kOne ? tap_tiles1_size(p, kf) : tap_tiles_size(p, kf));
  __nv_bfloat16* xsf =
      P.xs + static_cast<size_t>(blockIdx.x) * 3 * (kf + kb) * kStep;
  __nv_bfloat16* xsb = xsf + 3 * kf * kStep;
  __shared__ int s_act[kBt], s_T[kBt], s_bad[kBt];
  __shared__ float s_gamma[kBt], s_alpha[kBt], s_gt[kBt], s_dmean[kBt],
      s_gnext[kBt];

  if (tid < kBt) {
    const bool valid = tid < nrows;
    s_act[tid] = valid ? P.act[row0 + tid] : 0;
    s_T[tid] = valid ? P.T[row0 + tid] : 0;
    s_gamma[tid] = valid ? P.gamma[row0 + tid] : 1.f;
    s_bad[tid] = 0;
  }
  int ring;  // HIGH: the steps the product ring has served
  if constexpr (kHigh) {
    init_ring<kOne>(smx, ring);
    // the split operands' pad columns
    split_rows<kOne>(nullptr, 0, 0, (N + 1) & ~1, nrows, kf, xsf);
    split_rows<kOne>(nullptr, 0, 0, (p + 1) & ~1, nrows, kb, xsb);
  }

  for (int it = 0; it < P.cap; ++it) {
    if (!__syncthreads_or(tid < kBt && s_act[tid])) break;

    // ---- 1. denoiser with tau = gamma, damping, allclose: a lane group per
    // (trial, segment) -----------------------------------------------------
    {
      const float rho = P.rho, omr = P.omr;
      denoise_segments<true>(
          nrows, N, M, P.K, P.sym_re, P.sym_im, s_act, s_gamma, s_bad,
          [&](size_t j) { return LanePlanes{r[j], var[j], xm[j]}; },
          [&](size_t j, float mr, float mi, float v, LanePlanes d) {
            xm[j] = make_float2(rho * mr + omr * d.xm.x,
                                rho * mi + omr * d.xm.y);
            var[j] = v;
            return not_close(v, d.var);
          });
    }
    __syncthreads();

    // ---- 2. alpha = mean(var) gamma, gamma_tilde, d_mean over p and the
    // damped gamma: a warp per trial --------------------------------------
    for (int m = warp; m < nrows; m += kWarps) {
      if (!s_act[m]) continue;
      const float* vm = var + static_cast<size_t>(m) * N;
      const float gamma = s_gamma[m];
      auto get = [&](int j) { return vm[j]; };
      const float alpha =
          (kHigh ? warp_rowsum<kOne>(N, P.vec4_N, get) * P.inv_N
                 : warp_torch_mean(N, P.vec4_N, P.inv_N, get)) *
          gamma;
      const float gt = clampf(gamma * (1.f - alpha) / alpha, kVarMin, kVarMax);
      auto d = [&](int k) {
        const float sk = __ldg(s2 + k);
        return sk / (sk + P.sigma2 * gt);
      };
      const float dm = kHigh ? warp_rowsum<kOne>(p, P.vec4_p, d) * P.inv_p
                             : warp_torch_mean(p, P.vec4_p, P.inv_p, d);
      if (lane == 0) {
        s_alpha[m] = alpha;
        s_gt[m] = gt;
        s_dmean[m] = dm;
        s_gnext[m] = P.rho * (gt * dm / (P.eta - dm)) + P.omr * gamma;
      }
    }
    __syncthreads();

    // ---- 3. r_tilde = (xmmse - alpha r) / (1 - alpha), written over r ----
    // (HIGH: split for the first product as it is written)
    if constexpr (kHigh)
      for_each_split_pair<4, kOne>(
          nrows, N, kf, s_act, xsf,
          [&](int, size_t e, bool last) {
            const bool al = (N & 1) == 0;
            return last ? Pair2{{xm[e], {}}, {r[e], {}}}
                        : Pair2{load_pair(xm, e, al), load_pair(r, e, al)};
          },
          [&](int m, size_t e, Pair2 v, bool last) {
            const float alpha = s_alpha[m], oma = 1.f - alpha;
            auto rt_of = [&](float2 x, float2 u) {
              return make_float2((x.x - alpha * u.x) / oma,
                                 (x.y - alpha * u.y) / oma);
            };
            const Pair t = {rt_of(v.a.u0, v.b.u0), rt_of(v.a.u1, v.b.u1)};
            if (last)
              r[e] = t.u0;
            else
              store_pair(r, e, t, (N & 1) == 0);
            return t;
          });
    else
    for_each_row_element<4>(
        nrows, N, s_act,
        [&](int, size_t e) {
          const float2 x = xm[e], v = r[e];
          return make_float4(x.x, x.y, v.x, v.y);
        },
        [&](int m, size_t e, float4 v) {
          const float alpha = s_alpha[m], oma = 1.f - alpha;
          r[e] = make_float2((v.x - alpha * v.z) / oma,
                             (v.y - alpha * v.w) / oma);
        });
    __syncthreads();

    // ---- 4. w = (d / d_mean) (y_tilde - r_tilde Vh^T) ---------------------
    if constexpr (kHigh) {
      product_x3<kOne>(xsf, kf, tf, p, smx, ring,
                 [&](int m, int k, float cr0, float ci0, float cr1,
                     float ci1) {
        if (m >= nrows || !s_act[m]) return;
        const float gt = s_gt[m], dm = s_dmean[m];
        auto w_at = [&](int k, float cr, float ci) {
          const float sk = __ldg(s2 + k);
          const float sc = sk / (sk + P.sigma2 * gt) / dm;
          const float2 y = __ldg(yt + static_cast<size_t>(m) * p + k);
          return make_float2(sc * (y.x - cr), sc * (y.y - ci));
        };
        store_split<kOne>(xsb, kb, m, k, w_at(k, cr0, ci0),
                          k + 1 < p ? w_at(k + 1, cr1, ci1)
                                    : make_float2(0.f, 0.f));
      });
    } else
    for (int n0 = 0; n0 < p; n0 += kBN1) {
      float cr[kNI][kNJ1], ci[kNI][kNJ1];
      product_tile<true>(r, N, nrows, Vh, N, p, N, n0, sm, cr, ci);
#pragma unroll
      for (int i = 0; i < kNI; ++i) {
        const int m = kNI * ty + i;
        if (m >= nrows || !s_act[m]) continue;
        const float gt = s_gt[m], dm = s_dmean[m];
#pragma unroll
        for (int j = 0; j < kNJ1; ++j) {
          const int k = n0 + tx + kTx * j;
          if (k >= p) continue;
          const float sk = __ldg(s2 + k);
          const float sc = sk / (sk + P.sigma2 * gt) / dm;
          const float2 y = __ldg(yt + static_cast<size_t>(m) * p + k);
          w[static_cast<size_t>(m) * p + k] =
              make_float2(sc * (y.x - cr[i][j]), sc * (y.y - ci[i][j]));
        }
      }
    }
    __syncthreads();

    // ---- 5. r = r_tilde + eta w conj(Vh) ----------------------------------
    if constexpr (kHigh) {
      product_x3<kOne>(xsb, kb, tb, N, smx, ring,
                 [&](int m, int jc, float cr0, float ci0, float cr1,
                     float ci1) {
        if (m >= nrows || !s_act[m]) return;
        auto put = [&](int jc, float cr, float ci) {
          const size_t el = static_cast<size_t>(m) * N + jc;
          const float2 t = r[el];
          r[el] = make_float2(t.x + P.eta * cr, t.y + P.eta * ci);
        };
        put(jc, cr0, ci0);
        if (jc + 1 < N) put(jc + 1, cr1, ci1);
      });
    } else
    for (int n0 = 0; n0 < N; n0 += kBN2) {
      float cr[kNI][kNJ2], ci[kNI][kNJ2];
      product_tile<false>(w, p, nrows, Vh, N, N, p, n0, sm, cr, ci);
#pragma unroll
      for (int i = 0; i < kNI; ++i) {
        const int m = kNI * ty + i;
        if (m >= nrows || !s_act[m]) continue;
#pragma unroll
        for (int j = 0; j < kNJ2; ++j) {
          const int jc = n0 + tx + kTx * j;
          if (jc >= N) continue;
          const size_t e = static_cast<size_t>(m) * N + jc;
          const float2 t = r[e];
          r[e] = make_float2(t.x + P.eta * cr[i][j], t.y + P.eta * ci[i][j]);
        }
      }
    }
    __syncthreads();
    if (tid < nrows && s_act[tid]) {
      s_T[tid] = s_T[tid] + 1;
      s_gamma[tid] = s_gnext[tid];
      s_act[tid] = s_bad[tid];
    }
    if (tid < kBt) s_bad[tid] = 0;
  }

  __syncthreads();
  if (tid < nrows) {
    P.act[row0 + tid] = s_act[tid];
    P.T[row0 + tid] = s_T[tid];
    P.gamma[row0 + tid] = s_gamma[tid];
  }
}

}  // namespace

extern "C" {

// Launch the decode of B trials on `stream`, in the HIGHEST form (high ==
// 0: FP32 on the CUDA cores, Vh read) or the HIGH form (high == 1: bf16 x
// 3 on the tensor cores; high == 2, the DEFAULT form: one bf16 pass; both
// with the split tap tiles `taps` read, ldf and ldb the
// forward's and the adjoint's padded k, xs the scratch of the blocks' split
// operands: 6 kBt (ldf + ldb) bf16 for each of the ceil(B / kBt) blocks).  The state buffers are updated in
// place (the caller passes copies).  Returns a cudaError_t code (0 on
// success): cudaErrorInvalidValue for a geometry or form the kernel does
// not take, else cudaGetLastError() after the launch.  The kernel
// allocates nothing; every buffer is the caller's.
int fused_vamp2_decode(void* r, void* gamma, void* var, void* xm, void* act,
                       void* T, const void* yt, const void* s2,
                       const void* Vh, void* w, const void* sym_re,
                       const void* sym_im, int B, int N, int p, int M, int K,
                       int vec4_p, int vec4_N, float sigma2, float eta,
                       float rho, float omr, float inv_p, float inv_N,
                       int cap, int high, const void* taps, int ldf, int ldb,
                       void* xs, void* stream) {
  if (K < 1 || K > decode::kMaxK || M < 1 || N % M != 0 || B < 1 || p < 1 ||
      (high < 0 || high > 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (high && (taps == nullptr || xs == nullptr || ldf < N || ldf % 16 ||
               ldb < p || ldb % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P;
  P.r = static_cast<float2*>(r);
  P.gamma = static_cast<float*>(gamma);
  P.var = static_cast<float*>(var);
  P.xm = static_cast<float2*>(xm);
  P.act = static_cast<int*>(act);
  P.T = static_cast<int*>(T);
  P.yt = static_cast<const float2*>(yt);
  P.s2 = static_cast<const float*>(s2);
  P.Vh = static_cast<const float2*>(Vh);
  P.w = static_cast<float2*>(w);
  P.sym_re = static_cast<const float*>(sym_re);
  P.sym_im = static_cast<const float*>(sym_im);
  P.B = B;
  P.N = N;
  P.p = p;
  P.M = M;
  P.K = K;
  P.vec4_p = vec4_p;
  P.vec4_N = vec4_N;
  P.sigma2 = sigma2;
  P.eta = eta;
  P.rho = rho;
  P.omr = omr;
  P.inv_p = inv_p;
  P.inv_N = inv_N;
  P.cap = cap;
  P.taps = static_cast<const __nv_bfloat16*>(taps);
  P.ldf = ldf;
  P.ldb = ldb;
  P.xs = static_cast<__nv_bfloat16*>(xs);
  const dim3 grid((B + kBt - 1) / kBt);
  const auto kernel = high == 2   ? vamp2_decode_kernel<true, true>
                      : high == 1 ? vamp2_decode_kernel<true, false>
                                  : vamp2_decode_kernel<false, false>;
  const int smem =
      high == 2 ? kSmemBytesX1 : high ? kSmemBytesX3 : kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_vamp2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
