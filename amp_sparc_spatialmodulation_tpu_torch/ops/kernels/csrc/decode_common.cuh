// Device code shared by the whole-decode kernels (fused_bamp_decode.cu,
// fused_scamp_decode.cu): band placement of the tap-form operator, the
// cluster helpers (distributed shared memory), sums in the order of
// PyTorch's CUDA reduction, |x|^2 and the segmented softmax posterior.
// Every function rounds where the plain PyTorch version rounds; the
// sources are built with -fmad=false, so an expression rounds after each
// operation unless it calls fmaf().
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace decode {

constexpr float kExpMax = 87.72283905206835f;  // log(FLT_MAX) - 1
constexpr float kRtol = 1e-5f;
constexpr float kAtol = 1e-8f;
constexpr int kMaxK = 16;  // largest alphabet (16PSK, 16QAM)

enum Trunc { kTrunc = 0, kTail = 1, kCyclic = 2 };

// Column block feeding output row block r through tap l, or -1.  P holds
// the geometry fields trunc, Lin and Lout.
template <class P>
__device__ __forceinline__ int src_block(int r, int l, const P& p) {
  int c = r - l;
  if (p.trunc == kCyclic) {
    c %= p.Lin;
    return c < 0 ? c + p.Lin : c;
  }
  return (c >= 0 && c < p.Lin) ? c : -1;
}

// Output row block reached from column block c through tap l, or -1.
template <class P>
__device__ __forceinline__ int dst_block(int c, int l, const P& p) {
  const int r = c + l;
  if (p.trunc == kCyclic) return r % p.Lin;
  return r < p.Lout ? r : -1;
}

// Thread-block clusters (sm_90): the generic address of the same
// shared-memory location in block `rank` of this block's cluster (a plain
// load or store through it reaches that block's shared memory), and the
// cluster-wide barrier, which orders every block's shared-memory writes
// before it against every block's reads after it.  All threads of every
// block of the cluster call cluster_sync.
template <class T>
__device__ __forceinline__ T* map_rank(T* p, int rank) {
  unsigned long long out;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(out)
               : "l"(reinterpret_cast<unsigned long long>(p)), "r"(rank));
  return reinterpret_cast<T*>(out);
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int last_pow2(int n) {
  int w = 1;
  while (2 * w <= n) w *= 2;
  return w;
}

// Partial sum of lane t of w lanes, in the order of PyTorch's CUDA
// reduction over a contiguous innermost dimension of n elements
// (ATen/native/cuda/Reduce.cuh, thread_reduce_impl): lane t folds elements
// t, t+w, t+2w, ... into four accumulators in turn (groups of four
// strides, then the tail from accumulator 0) and combines them in order.
template <class Get>
__device__ __forceinline__ float lane_sum(int t, int w, int n, Get get) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int idx = t;
  while (idx + 3 * w < n) {
    for (int i = 0; i < 4; ++i) acc[i] = acc[i] + get(idx + i * w);
    idx += 4 * w;
  }
  for (int i = 0; i < 4 && idx < n; ++i, idx += w) acc[i] = acc[i] + get(idx);
  return ((acc[0] + acc[1]) + acc[2]) + acc[3];
}

// The same for the loads PyTorch vectorizes by four when the reduced
// dimension is long enough (input_vectorized_thread_reduce_impl; rows
// aligned to 16 bytes, so n % 4 == 0): lane t folds the four elements of
// vectors t, t+w, ... into four accumulators, lane t adds tail element
// 4*(n/4) + t to accumulator 0, and the four are combined in order.
template <class Get>
__device__ __forceinline__ float lane_sum_vec4(int t, int w, int n,
                                               Get get) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int v = t; 4 * v + 3 < n; v += w)
    for (int i = 0; i < 4; ++i) acc[i] = acc[i] + get(4 * v + i);
  const int tail = n - n % 4 + t;
  if (tail < n) acc[0] = acc[0] + get(tail);
  return ((acc[0] + acc[1]) + acc[2]) + acc[3];
}

// Sum of get(0..n-1) in the order of PyTorch's CUDA reduction over a
// contiguous innermost dimension of n elements, one thread: w =
// min(last_pow2(n), 32) lanes (PyTorch's block width when the reduction
// has at least 16 outputs), each lane's lane_sum, then lane t takes lane
// t + off for off = w/2, w/4, ..., 1 (the warp shuffle tree,
// block_x_reduce).  For n below PyTorch's vectorization threshold (every
// segment and symbol-table sum).
template <class Get>
__device__ float torch_sum(int n, Get get) {
  const int w = n >= 32 ? 32 : last_pow2(n);
  float lane[32];
  for (int t = 0; t < w; ++t) lane[t] = lane_sum(t, w, n, get);
  for (int off = w / 2; off >= 1; off >>= 1)
    for (int t = 0; t < off; ++t) lane[t] = lane[t] + lane[t + off];
  return lane[0];
}

// The same sum computed by a whole warp (all 32 lanes call it), returned
// on every lane.  vec4: PyTorch vectorizes the loads (n at or above its
// threshold, n % 4 == 0); the block width is then min(last_pow2(n/4), 32).
template <class Get>
__device__ float warp_torch_sum(int n, bool vec4, Get get) {
  const int lane = threadIdx.x & 31;
  const int units = vec4 ? n / 4 : n;
  const int w = units >= 32 ? 32 : last_pow2(units);
  float v = 0.f;
  if (lane < w) v = vec4 ? lane_sum_vec4(lane, w, n, get)
                         : lane_sum(lane, w, n, get);
  for (int off = w / 2; off >= 1; off >>= 1)
    v = v + __shfl_down_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

// |re + i im|^2 as PyTorch computes .abs() ** 2 of a complex64 value.
__device__ __forceinline__ float abs2(float re, float im) {
  const float a = hypotf(re, im);
  return a * a;
}

// Re((a + ib) * conj(s)) as PyTorch's complex64 product rounds it:
// fma(a, s_re, b * s_im).
__device__ __forceinline__ float re_conj_mul(float a, float b, float sr,
                                             float si) {
  return fmaf(a, sr, b * si);
}

// Posterior of the segment of M lanes j0 .. j0+M-1 under the
// one-active-per-segment prior, as the plain version's
// segmented_posterior(halve_tau=True) computes it: tau = tau_of(j) / 2,
// segment max, exp, the segment sums in PyTorch's order, the mean and,
// with kVar, the decomposed variance.  Calls emit(j, mean_re, mean_im,
// var) for every lane (var is 0 without kVar) and returns the OR of what
// the calls return.  real_x: every symbol is real, so the imaginary part of
// the pseudo-data does not enter.  Kept out of line, with callbacks that
// capture by value: inlined into the BAMP kernel, the same arithmetic made
// ptxas allocate that kernel's hot loops differently and ran 17% to 90%
// slower at the main path's phase-1 shape; out of line it runs 7% faster
// than the kernel's own inlined copy did (PERF.md, PR 2).
template <bool kVar, class TauOf, class Emit>
__device__ __noinline__ int segment_posterior(
    int j0, int M, int K, const float* sr, const float* si, bool real_x,
    const float* x_re, const float* x_im, TauOf tau_of, Emit emit) {
  auto t_of = [&](int i, int q) {
    const int j = j0 + i;
    const float tau = tau_of(j) / 2.f;
    const float a = x_re[j] / tau;
    if (real_x) return a * sr[q];
    return re_conj_mul(a, x_im[j] / tau, sr[q], si[q]);
  };
  float segmax = -INFINITY;
  for (int i = 0; i < M; ++i)
    for (int q = 0; q < K; ++q) segmax = fmaxf(segmax, t_of(i, q));
  auto eta = [&](int i, int q) {
    return expf(fminf(t_of(i, q) - segmax, kExpMax));
  };
  // eta summed over the symbols, then over the segment
  auto eta_m = [&](int i) {
    return K == 1 ? eta(i, 0)
                  : torch_sum(K, [&](int q) { return eta(i, q); });
  };
  const float eta2 = torch_sum(M, eta_m);
  int flag = 0;
  for (int i = 0; i < M; ++i) {
    float mr, mi, vn = 0.f;
    if (K == 1) {
      const float post = eta(i, 0) / eta2;
      mr = sr[0] * post;
      mi = si[0] * post;
      if (kVar)
        vn = abs2(mr, mi) * (1.f - post) +
             abs2(mr - sr[0], mi - si[0]) * post;
    } else {
      mr = torch_sum(K, [&](int q) { return sr[q] * eta(i, q); }) / eta2;
      mi = torch_sum(K, [&](int q) { return si[q] * eta(i, q); }) / eta2;
      if (kVar) {
        const float var0 = abs2(mr, mi) * (1.f - eta_m(i) / eta2);
        const float vs = torch_sum(K, [&](int q) {
          return abs2(mr - sr[q], mi - si[q]) * eta(i, q);
        });
        vn = var0 + vs / eta2;
      }
    }
    flag |= emit(j0 + i, mr, mi, vn);
  }
  return flag;
}

}  // namespace decode
