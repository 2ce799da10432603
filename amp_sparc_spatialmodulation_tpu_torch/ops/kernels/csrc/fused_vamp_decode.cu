// Whole VAMP decode on an NVIDIA Hopper GPU: one thread block per tile of 64
// trials, with the iteration loop inside the block.
//
// Replaces the TPU kernel amp_sparc_spatialmodulation_tpu/ops/pallas/
// fused_vamp.py:73 _vamp_decode_kernel (reached through
// FusedVampDecode.decode_call).  Each iteration of a tile runs, with s^2 the
// squared singular values and eta = p / N,
//
//   1. q = r_tilde Vh^T (K = N); scale = 1 / (s^2 + sigma2 / sigma2_tilde);
//      w = scale (y_tilde + (sigma2 / sigma2_tilde) q) - q; the sum of scale
//      over p gives var_lmmse = mean(scale) sigma2, then
//      x_var = eta var_lmmse + (1 - eta) sigma2_tilde,
//      alpha = clip(x_var / sigma2_tilde, 1e-5, 1 - 1e-5) and
//      tau = clip(alpha / (1 - alpha) sigma2_tilde, 1e-9, 1e5);
//   2. x_tilde = w conj(Vh) + r_tilde (K = p);
//      r = (x_tilde - alpha r_tilde) / (1 - alpha);
//   3. per segment of M lanes (contiguous in the flat index l*Nt + antenna)
//      the softmax posterior of r with effective noise tau, WITHOUT the
//      tau/2 halving, decomposed variance; the per-trial allclose of the
//      variance against the previous one; dxdr = clip(mean(var) / tau,
//      1e-5, 1 - 1e-5); r_tilde = (xmmse - dxdr r) / (1 - dxdr) and
//      sigma2_tilde = clip(tau dxdr / (1 - dxdr), 1e-9, 1e5).
//
// Trials that were already converged at the start of an iteration keep
// their state; the tile stops when its last trial has converged or the
// remaining budget cap is spent, so T per trial is the plain loop's.  Each
// block reads its realization's factor: the launch takes C stacked factors
// (C, p, N) and C * B_per trials, realization-major (the TPU kernel's
// batched mode, fused_vamp.py:101-116); C = 1 is the single decode.
//
// Bound on this card: FP32 operations.  The two products are 8 real
// products of 2 N p flop per trial and iteration (the 4-product complex
// form): at the main path (N = 2560, p = 528, 65536 trials, cap 10) about
// 1.42e13 flop, 212 ms at 67 TFLOP/s, against about 9.7 GB that the decode
// must read and write (2.9 ms at 3.35 TB/s).  Neither operand fits a
// block: Vh is 10.8 MB (it is served from the 50 MB L2 to every block) and
// a trial's state is 7 x 2560 floats.  So the tile's state stays in device
// memory, in the output buffers, and the products stream both operands
// through a cp.async ring in shared memory (vamp_common.cuh, product_tile):
// each thread holds a 4-trial x 3- or 2-column complex register tile of a
// 64-trial output tile, with the running sums in registers too, at 128
// registers so that two blocks share an SM (the passes between the
// products wait on memory and need the second block's warps; an 8-trial
// tile at one block per SM runs the products faster and the whole decode
// slower, PERF.md).  Every block reads Vh twice per iteration.  The column
// tiles divide the main geometry (48 columns for p = 528, 32 for N =
// 2560).  All arithmetic is FP32 on the CUDA cores: the stop test needs
// it (no TF32).  The complex products use the 4-product form, not the TPU
// kernel's Gauss 3-multiply form: it keeps the factor as it is (no
// combination planes) and has no cancellation in k1 - k3; the Gauss form
// would save a quarter of the multiplies.  The sum over k is blocked
// (chains of 16 added in k order), which keeps the mean T of decodes that
// stop by the allclose test near the float64 decode's.  The kernel does not
// match the plain version bit for bit (cuBLAS sums in another order, which
// also changes with the batch size); r, which divides by 1 - alpha (down to
// 1e-5), carries that order noise amplified.
//
// The HIGH form (template kHigh; precision='high', the JAX kernel's
// make_dot(Precision.HIGH) = dot3) runs both products as the Gauss form's
// three real products in bf16 x 3 passes on the tensor cores
// (vamp_common.cuh, product_x3) on the wrapper's split tap planes, and
// the two row sums JAX writes as products with ones (var_lmmse,
// fused_vamp.py:145-146, and dxdr, :173) as sum(hi) + sum(lo).  The trial
// side of each product is split into bf16 once, where it is written: the
// launch splits the incoming r_tilde, step 5 splits each new r_tilde, and
// the first product's epilogue writes w split (no FP32 w); the split
// operands are the wrapper's scratch xs, one region per block.  Its bound
// is the tensor cores': 36 N p flop per trial and iteration (3 products x
// 3 passes x 2 N p) at 989 TFLOP/s, about 32 ms at the main path, against
// the same 9.7 GB of state traffic (2.9 ms); the elementwise passes and the
// denoiser, which precision does not change, then take most of the time.
// The HIGHEST instance (kHigh false) is the code above, unchanged.
//
// The DEFAULT form (kOne; precision='default', make_dot(Precision.DEFAULT),
// one bf16 pass) is the HIGH form's code with the row sums as sum(hi)
// (warp_rowsum1) and the products on the one-pass engine
// (vamp_common.cuh, product_x1, reached through product_x3<true>): the
// hi parts alone (the wrapper's fused_vamp.default_taps, a split operand
// of half the HIGH size), ring slots of three k16 steps; its plain
// version is vamp.plain_loop_default.  Its bound is the tensor cores': 12
// N p flop per trial and iteration, about 9 ms at the main path.  What
// bounds it on this card (NVIDIA H100 80GB HBM3 at 700 W, the main path,
// tests/torch_vamp_probes.py --precision default and
// tests/torch_kernel_ab.py, PERF.md): on the HIGH engine's layout it took
// 280 ms, half of it in the denoiser (a thread per segment, its lanes one
// after the other) and a third in the products, which waited on the
// copies of halves they never multiplied.  The denoiser's lane groups
// (every form) and the one-pass engine took it to 135 ms; the products
// are then bound by each warp's chain of ldmatrix, mma and FP32 adds
// between barriers, and the passes outside them (the denoiser, step 5,
// the row sums) by their loads.
//
// Layouts: every state plane is per-trial contiguous, complex values
// interleaved (PyTorch complex64): r_tilde, r, xmmse (B, N), var (B, N),
// sigma2_tilde (B, 1), y_tilde (B, p); Vh (C, p, N) complex64, s^2 (C, p);
// the scratch w (B, p) complex64 holds the first product's epilogue.
// Built with -fmad=false like the other kernels: every FMA is explicit.

#include "vamp_common.cuh"

namespace {

using namespace vamp;

constexpr float kVrMin = 1e-5f;          // vamp.py:51-52
constexpr float kVrMax = 1.0f - 1e-5f;
constexpr float kVarMin = 1e-9f;         // vamp.py:53-54
constexpr float kVarMax = 1e5f;

struct Params {
  float2* rt;         // r_tilde (B, N), in/out
  float* s2t;         // sigma2_tilde (B,), in/out
  float2* r;          // (B, N), in/out
  float* var;         // (B, N), in/out
  float2* xm;         // xmmse (B, N), in/out
  int* act;           // (B,), in/out
  int* T;             // (B,), in/out
  const float2* yt;   // y_tilde (B, p)
  const float* s2;    // (C, p)
  const float2* Vh;   // (C, p, N)
  float2* w;          // scratch (B, p)
  const float* sym_re;
  const float* sym_im;
  int B_per, N, p, M, K, vec4_p, vec4_N;
  float sigma2, eta, ometa, inv_p, inv_N;  // ometa = 1 - eta from double
  int cap;  // remaining iteration budget
  // HIGH form only: the split Gauss tap tiles of each factor
  // (vamp_common.cuh, product_x3: the forward's, then the adjoint's), tap_c
  // bf16 values apart from one realization to the next
  const __nv_bfloat16* taps;
  size_t tap_c;
  int ldf, ldb;  // N and p rounded up to 16
  // HIGH form only: the blocks' split operands (vamp_common.cuh,
  // split_at), per block (c, blockIdx.x) the forward's r_tilde (ldf / 16
  // steps), then the adjoint's w (ldb / 16 steps)
  __nv_bfloat16* xs;
};

template <bool kHigh, bool kOne>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    vamp_decode_kernel(Params P) {
  const int tid = threadIdx.x;
  const int ty = tid / kTx, tx = tid % kTx;  // product tiles (vamp_common)
  const int warp = tid >> 5, lane = tid & 31;
  const int c = blockIdx.y;
  const int first = blockIdx.x * kBt;
  const int nrows = min(kBt, P.B_per - first);
  const size_t row0 = static_cast<size_t>(c) * P.B_per + first;
  const int N = P.N, p = P.p, M = P.M;
  const float2* Vh = P.Vh + static_cast<size_t>(c) * p * N;
  const float* s2 = P.s2 + static_cast<size_t>(c) * p;
  float2* rt = P.rt + row0 * N;
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
  const __nv_bfloat16* tf = P.taps + c * P.tap_c;
  const __nv_bfloat16* tb =
      tf + (kOne ? tap_tiles1_size(p, kf) : tap_tiles_size(p, kf));
  __nv_bfloat16* xsf =
      P.xs + (static_cast<size_t>(c) * gridDim.x + blockIdx.x) * 3 *
                 (kf + kb) * kStep;
  __nv_bfloat16* xsb = xsf + 3 * kf * kStep;
  __shared__ int s_act[kBt], s_T[kBt], s_bad[kBt];
  __shared__ float s_s2t[kBt], s_vr[kBt], s_alpha[kBt], s_tau[kBt],
      s_dxdr[kBt];

  if (tid < kBt) {
    const bool valid = tid < nrows;
    s_act[tid] = valid ? P.act[row0 + tid] : 0;
    s_T[tid] = valid ? P.T[row0 + tid] : 0;
    s_s2t[tid] = valid ? P.s2t[row0 + tid] : 1.f;
  }
  int ring;  // HIGH: the steps the product ring has served
  if constexpr (kHigh) {
    init_ring<kOne>(smx, ring);
    // the incoming r_tilde split for the first product; w's pad columns
    split_rows<kOne>(rt, N, N, 0, nrows, kf, xsf);
    split_rows<kOne>(nullptr, 0, 0, (p + 1) & ~1, nrows, kb, xsb);
  }

  for (int it = 0; it < P.cap; ++it) {
    if (!__syncthreads_or(tid < kBt && s_act[tid])) break;
    if (tid < kBt) s_bad[tid] = 0;

    // ---- per trial: sigma2 / sigma2_tilde, var_lmmse, alpha, tau ---------
    // (scale depends on the trial only through vr, so its mean over p is
    // taken before the product, a warp per trial)
    for (int m = warp; m < nrows; m += kWarps) {
      const float vr = (1.f / s_s2t[m]) * P.sigma2;
      auto scale = [&](int k) { return 1.f / (__ldg(s2 + k) + vr); };
      float mean;
      if constexpr (kHigh)
        mean = warp_rowsum<kOne>(p, P.vec4_p, scale) * P.inv_p;
      else
        mean = warp_torch_mean(p, P.vec4_p, P.inv_p, scale);
      if (lane == 0) {
        const float s2t = s_s2t[m];
        const float xv = P.eta * (mean * P.sigma2) + P.ometa * s2t;
        const float a = clampf(xv / s2t, kVrMin, kVrMax);
        s_vr[m] = vr;
        s_alpha[m] = a;
        s_tau[m] = clampf(a / (1.f - a) * s2t, kVarMin, kVarMax);
      }
    }
    __syncthreads();

    // ---- 1. q = r_tilde Vh^T, w = scale (y_tilde + vr q) - q ------------
    if constexpr (kHigh) {
      product_x3<kOne>(xsf, kf, tf, p, smx, ring,
                 [&](int m, int k, float cr0, float ci0, float cr1,
                     float ci1) {
        if (m >= nrows || !s_act[m]) return;
        const float vr = s_vr[m];
        auto w_at = [&](int k, float cr, float ci) {
          const float sc = 1.f / (__ldg(s2 + k) + vr);
          const float2 y = __ldg(yt + static_cast<size_t>(m) * p + k);
          const float xr = sc * (y.x + vr * cr);
          const float xi = sc * (y.y + vr * ci);
          return make_float2(xr - cr, xi - ci);
        };
        store_split<kOne>(xsb, kb, m, k, w_at(k, cr0, ci0),
                          k + 1 < p ? w_at(k + 1, cr1, ci1)
                                    : make_float2(0.f, 0.f));
      });
    } else
    for (int n0 = 0; n0 < p; n0 += kBN1) {
      float cr[kNI][kNJ1], ci[kNI][kNJ1];
      product_tile<true>(rt, N, nrows, Vh, N, p, N, n0, sm, cr, ci);
#pragma unroll
      for (int i = 0; i < kNI; ++i) {
        const int m = kNI * ty + i;
        if (m >= nrows || !s_act[m]) continue;
        const float vr = s_vr[m];
#pragma unroll
        for (int j = 0; j < kNJ1; ++j) {
          const int k = n0 + tx + kTx * j;
          if (k >= p) continue;
          const float sc = 1.f / (__ldg(s2 + k) + vr);
          const float2 y = __ldg(yt + static_cast<size_t>(m) * p + k);
          const float xr = sc * (y.x + vr * cr[i][j]);
          const float xi = sc * (y.y + vr * ci[i][j]);
          w[static_cast<size_t>(m) * p + k] =
              make_float2(xr - cr[i][j], xi - ci[i][j]);
        }
      }
    }
    __syncthreads();

    // ---- 2. x_tilde = w conj(Vh) + r_tilde, r = (x_tilde - a r_tilde)/(1-a)
    if constexpr (kHigh) {
      product_x3<kOne>(xsb, kb, tb, N, smx, ring,
                 [&](int m, int jc, float cr0, float ci0, float cr1,
                     float ci1) {
        if (m >= nrows || !s_act[m]) return;
        const float a = s_alpha[m], oma = 1.f - a;
        auto put = [&](int jc, float cr, float ci) {
          const size_t el = static_cast<size_t>(m) * N + jc;
          const float2 t = rt[el];
          const float xr = cr + t.x, xi = ci + t.y;
          r[el] = make_float2((xr - a * t.x) / oma, (xi - a * t.y) / oma);
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
        const float a = s_alpha[m], oma = 1.f - a;
#pragma unroll
        for (int j = 0; j < kNJ2; ++j) {
          const int jc = n0 + tx + kTx * j;
          if (jc >= N) continue;
          const size_t e = static_cast<size_t>(m) * N + jc;
          const float2 t = rt[e];
          const float xr = cr[i][j] + t.x, xi = ci[i][j] + t.y;
          r[e] = make_float2((xr - a * t.x) / oma, (xi - a * t.y) / oma);
        }
      }
    }
    __syncthreads();

    // ---- 3. denoiser and allclose: a lane group per (trial, segment) -----
    denoise_segments<false>(
        nrows, N, M, P.K, P.sym_re, P.sym_im, s_act, s_tau, s_bad,
        [&](size_t j) { return LanePlanes{r[j], var[j], {}}; },
        [&](size_t j, float mr, float mi, float v, LanePlanes d) {
          xm[j] = make_float2(mr, mi);
          var[j] = v;
          return not_close(v, d.var);
        });
    __syncthreads();

    // ---- 4. dxdr = mean(var) / tau and sigma2_tilde: a warp per trial ----
    for (int m = warp; m < nrows; m += kWarps) {
      if (!s_act[m]) continue;
      const float* vm = var + static_cast<size_t>(m) * N;
      auto get = [&](int j) { return vm[j]; };
      float mean;
      if constexpr (kHigh)
        mean = warp_rowsum<kOne>(N, P.vec4_N, get) * P.inv_N;
      else
        mean = warp_torch_mean(N, P.vec4_N, P.inv_N, get);
      if (lane == 0) {
        const float tau = s_tau[m];
        const float dxdr = clampf(mean / tau, kVrMin, kVrMax);
        s_dxdr[m] = dxdr;
        s_s2t[m] = clampf(tau * dxdr * (1.f / (1.f - dxdr)), kVarMin,
                          kVarMax);
        s_T[m] = s_T[m] + 1;
      }
    }
    __syncthreads();

    // ---- 5. r_tilde = (xmmse - dxdr r) / (1 - dxdr) -----------------------
    // (HIGH: split for the next first product as it is written)
    if constexpr (kHigh)
      for_each_split_pair<4, kOne>(
          nrows, N, kf, s_act, xsf,
          [&](int, size_t e, bool last) {
            const bool al = (N & 1) == 0;
            return last ? Pair2{{xm[e], {}}, {r[e], {}}}
                        : Pair2{load_pair(xm, e, al), load_pair(r, e, al)};
          },
          [&](int m, size_t e, Pair2 v, bool last) {
            const float dxdr = s_dxdr[m], norm = 1.f / (1.f - dxdr);
            auto rt_of = [&](float2 x, float2 u) {
              return make_float2((x.x - dxdr * u.x) * norm,
                                 (x.y - dxdr * u.y) * norm);
            };
            const Pair t = {rt_of(v.a.u0, v.b.u0), rt_of(v.a.u1, v.b.u1)};
            if (last)
              rt[e] = t.u0;
            else
              store_pair(rt, e, t, (N & 1) == 0);
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
          const float dxdr = s_dxdr[m], norm = 1.f / (1.f - dxdr);
          rt[e] = make_float2((v.x - dxdr * v.z) * norm,
                              (v.y - dxdr * v.w) * norm);
        });
    __syncthreads();
    if (tid < nrows && s_act[tid]) s_act[tid] = s_bad[tid];
  }

  __syncthreads();
  if (tid < nrows) {
    P.act[row0 + tid] = s_act[tid];
    P.T[row0 + tid] = s_T[tid];
    P.s2t[row0 + tid] = s_s2t[tid];
  }
}

}  // namespace

extern "C" {

// Launch the decode of C * B_per trials on C stacked factors on `stream`,
// in the HIGHEST form (high == 0: FP32 on the CUDA cores, Vh read) or the
// HIGH form (high == 1: bf16 x 3 on the tensor cores; high == 2, the
// DEFAULT form: one bf16 pass; both with the split tap tiles
// `taps` read, tap_c values per factor, ldf and ldb the forward's and the
// adjoint's padded k, xs the scratch of the blocks' split operands: 6 kBt
// (ldf + ldb) bf16 for each of the C ceil(B_per / kBt) blocks).  The state buffers are updated in place (the caller
// passes copies).  Returns a cudaError_t code (0 on success):
// cudaErrorInvalidValue for a geometry or form the kernel does not take,
// else cudaGetLastError() after the launch.  The kernel allocates nothing;
// every buffer is the caller's.
int fused_vamp_decode(void* rt, void* s2t, void* r, void* var, void* xm,
                      void* act, void* T, const void* yt, const void* s2,
                      const void* Vh, void* w, const void* sym_re,
                      const void* sym_im, int C, int B_per, int N, int p,
                      int M, int K, int vec4_p, int vec4_N, float sigma2,
                      float eta, float ometa, float inv_p, float inv_N,
                      int cap, int high, const void* taps, long long tap_c,
                      int ldf, int ldb, void* xs, void* stream) {
  if (K < 1 || K > decode::kMaxK || M < 1 || N % M != 0 || C < 1 ||
      C > 65535 || B_per < 1 || p < 1 || (high < 0 || high > 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tap_need =
      high == 2 ? tap_tiles1_size(p, ldf / 16) + tap_tiles1_size(N, ldb / 16)
                : tap_tiles_size(p, ldf / 16) + tap_tiles_size(N, ldb / 16);
  if (high && (taps == nullptr || xs == nullptr || ldf < N || ldf % 16 ||
               ldb < p || ldb % 16 || tap_c < tap_need))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P;
  P.rt = static_cast<float2*>(rt);
  P.s2t = static_cast<float*>(s2t);
  P.r = static_cast<float2*>(r);
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
  P.B_per = B_per;
  P.N = N;
  P.p = p;
  P.M = M;
  P.K = K;
  P.vec4_p = vec4_p;
  P.vec4_N = vec4_N;
  P.sigma2 = sigma2;
  P.eta = eta;
  P.ometa = ometa;
  P.inv_p = inv_p;
  P.inv_N = inv_N;
  P.cap = cap;
  P.taps = static_cast<const __nv_bfloat16*>(taps);
  P.tap_c = static_cast<size_t>(tap_c);
  P.ldf = ldf;
  P.ldb = ldb;
  P.xs = static_cast<__nv_bfloat16*>(xs);
  const dim3 grid((B_per + kBt - 1) / kBt, C);
  const auto kernel = high == 2   ? vamp_decode_kernel<true, true>
                      : high == 1 ? vamp_decode_kernel<true, false>
                                  : vamp_decode_kernel<false, false>;
  const int smem =
      high == 2 ? kSmemBytesX1 : high ? kSmemBytesX3 : kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_vamp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
