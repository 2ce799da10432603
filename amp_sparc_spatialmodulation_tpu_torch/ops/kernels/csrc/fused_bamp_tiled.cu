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
// decomposed variance (decode_common.cuh::segment_posterior's arithmetic),
// the freeze of x, var, z and u for trials whose act is 0 (their xmap is
// left unwritten: the caller's loop keeps the old one, as the TPU kernel's
// does), and notok: each trial's count of variance entries outside
// allclose(rtol=1e-5, atol=1e-8) of the old ones (0 for a frozen trial).
//
// Structure.  The banded operator is Lh taps h_l (Nr x Nt) with gains;
// block (c + l, c) of H is gains[l, c] h_l.  So the forward is one product
// of the (B Lin, Nt) x-side rows with the (Nt, W = Lh Nr) tap stack
// followed by the band fold out[r] = sum_l g_l P[r - l, tap l], and the
// adjoint is the gather of the y-side planes into (B Lin, W) rows followed
// by one product with the (W, Nt) taps.  A trial's state does not fit a
// block, so it lives in device memory and one call is four launches (the
// stage mask of the entry point selects them, for timing):
//
//   1. forward products: P_re, P_im (x with Re h, Im h) and P_v (var with
//      |h|^2), (B Lin, Wp) each, Wp = W rounded up to a multiple of 4;
//   2. fold, Onsager and freeze of z and u, one thread per y-side element;
//      it also writes the adjoint inputs, gain-weighted, (B Lin, Wp);
//   3. adjoint products: cov and xmap, (B Lin, Nt);
//   4. denoiser, freeze of x and var, and notok: a group of G lanes per
//      segment, lane t taking elements t, t + G, ...
//
// Bound on this card: FP32 operations.  At the massive geometry one
// trial-iteration does 16 flop per tap element (forward x with Re h and
// Im h, var with |h|^2; adjoint 1/u' with |h|^2 and the complex residual
// with conj h, four real products) over Lin Lh Nr Nt = 18,837,504 tap
// elements: 0.30 GFLOP, so 0.62 TFLOP for the phase-1 batch of 2048 trials
// (9.2 ms at 67 TFLOP/s) against about 5.4 GB moved by the four launches
// (1.6 ms at 3.35 TB/s; 2.3 GB of it the call's own inputs and outputs).  Phase 2 runs the same iteration on a handful of
// gathered trials (about 6 of 2048): 1.8 GFLOP, 27 us at the FP32 peak,
// so there the card is bound by how many blocks the products can spread
// over, and by the host between launches.
//
// The product engine, one for both products.  What holds it back on this
// card is the shared-memory pipe (the loads and copies that feed the FMAs)
// and the registers, more than the FMAs themselves (PERF.md, PR 10):
//
// * a thread keeps a kTM x kTN = 4 x 4 register tile of each of the three
//   outputs (48 accumulators): per four contraction steps it reads its 4 A
//   rows of each A plane (x, var; or the three adjoint inputs) as 16-byte
//   loads, then per step 3 tap fragments of 4 columns, 5 (forward) or 6
//   (adjoint) 16-byte loads per step for 48 or 80 FMAs; blocks of 256
//   threads (64 x 64 outputs), two per SM at 128 registers.  Larger
//   register tiles spill at that cap and ran slower, as did three blocks
//   per SM at 80 registers;
// * a warp is 4 x 8 threads of the tile, so that the rows it reads at
//   once are 4 and the tap fragments 128 contiguous bytes: one shared-
//   memory wavefront per load;
// * operands come through a ring of kStages slots of kDepth steps in shared
//   memory, filled by 16-byte cp.async (a partial chunk zero-fills) and
//   drained with one barrier per slot.  The A tiles lie as in device
//   memory with rows padded to kDepth + 4 floats, so that the 8 rows a
//   quarter-warp copies, and the 4 a warp reads, fall in different bank
//   groups; the taps lie along the output columns: the adjoint reads the
//   (W, Nt) taps as they are, the forward a (Nt, Wp) transposed copy that
//   the wrapper builds once per operator.  No tile is transposed on the
//   card, so no copy is 4 bytes wide (with 4-byte transposing copies the
//   forward ran 21% and the adjoint 17% slower);
// * the blocks of one row tile have adjacent indices (the column tile
//   varies fastest), so the resident blocks share their A rows in L2 and
//   each A row comes from device memory about once;
// * where a product's large form would launch fewer than two blocks per
//   SM, the wrapper picks its small form (tile_forms in
//   fused_bamp_tiled.py): 32 rows, one trial at Lin = 32, by 16 columns,
//   2 x 4 outputs per thread, so that a frozen trial's rows are skipped
//   exactly and phase 2's few trials still spread over the card;
// * tiles whose rows hold no active trial return at once.
//
// The TPU kernel recomputes an Lh - 1 row halo of the forward in every
// program because its grid programs cannot wait on each other; separate
// launches need no halo, and a launch costs microseconds.
//
// Rounding.  The kernel rounds where the plain version (fused_bamp_tiled.py,
// one step of the plain loop: complex64 products through the matrix
// library) rounds: built with -fmad=false; every product output is one FMA
// chain from 0 over the contraction index in order (padded steps add exact
// zero products, as before the register tiles), in a complex product the
// real part before the imaginary part, as a library FP32 GEMM takes it at
// large batch; no split of the contraction and no atomics on a product;
// gains multiply the products' results and the taps are summed in order;
// the gain-weighted adjoint inputs are formed before the product; the
// segment sums follow PyTorch's reduction order (decode_common.cuh).  The
// tiles change which thread computes an output, never the order of its
// sum, so every tile size gives the same bits.
//
// Layouts: float32 planes, trial-major: x-side (B, Lin, Nt), y-side
// (B, Lout, Nr); the taps as (W, Nt) planes (h[l, m, k] at row l Nr + m)
// of Re h, Im h and |h|^2, and the same transposed, (Nt, Wp) with zero
// pad columns; gains (Lh, Lin); scratch (B Lin, Wp).
//
// The HIGH form (precision='high', the TPU kernel with make_dot(HIGH) =
// dot3, fused_bamp_tiled.py:72) computes another function, that of one
// bamp.step with bamp.linear_step_high on bamp.gauss_taps: the per-tap gains
// folded into the seven Gauss tap planes of a real x (forward S_a2, Re S,
// Im S - Re S; adjoint S_a2^T, Re S^T, -Im S^T - Re S^T, Re S^T - Im S^T),
// the forward P_v = dot3(var, S_a2), P_re = k1 = dot3(x, Re S), P_im = k1 +
// dot3(x, Im S - Re S), the fold without gains and with the TPU kernel's
// Onsager arithmetic (w = v / u, z' = hx - w (y - z), the adjoint inputs
// 1/u', (y - z') / u' and their sum, the Gauss operand of k1), and the
// adjoint cov = 1 / dot3(Z_c, S_a2^T), k1 = dot3(Z_re + Z_im, Re S^T), k2 =
// dot3(Z_re, -Im S^T - Re S^T), k3 = dot3(Z_im, Re S^T - Im S^T), xmap = x +
// cov (k1 - k3) + i cov (k1 + k2).  Each of the 7 real products is three
// bf16 passes on the tensor cores (mma.sync m16n8k16), grouped as
// precision.dot3 groups them: hi hi in one FP32 sum, hi lo + lo hi in
// another, joined once.  The hi hi sum is kept by FP32 adds of each k16
// step's mma, started from zero, because the tensor cores truncate as they
// add into an accumulator (the variance product, a sum of 84 steps of
// positive terms, drifted by about 4e-6 where the accumulator carried it;
// tests/torch_k5_high_variants.py); the corrections, 2^-8 of it,
// accumulate in the tensor cores.  The product kernels (high_product_kernel)
// run a stage's products one after another in one launch: a block owns a
// BM x BN output tile of every product of its stage and streams the
// contraction of each in turn through one cp.async ring, so the ring stays
// full across products; each product's epilogue writes its outputs (the
// adjoint only for active trials), and a later product's epilogue reads
// back the earlier ones it joins (P_re; cov and k1, kept in xmap_re) from
// the block's own writes.  The trial side comes as the FP32 planes (the
// state and the fold's outputs) and is split into bf16 hi and lo as each
// warp loads its mma fragments; the taps come split and laid out by the
// wrapper (fused_bamp_tiled.py::high_taps), rows along the output columns
// and the contraction contiguous, padded with zeros to a multiple of 8, so
// each ring slot takes them as 16-byte copies and ldmatrix reads them.
// Pads: the copies zero-fill every A column past the contraction length and
// every tap row past the output columns, and the tap planes hold zeros in
// their pad columns, so a pad term is 0 x 0.  Bound on this card: the tensor
// cores, 7 products x 3 passes x 2 B Lin Nt Lh Nr flop per iteration (about
// 1.6 TFLOP at B = 2048, 1.6 ms at 989 TFLOP/s).  The HIGHEST instance (the
// product_kernel above and the fold's kHigh false instance) is unchanged.

#include <cuda_bf16.h>

#include <cstdint>

#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int kThreads = 256;  // fold and denoiser blocks
// Large form, both products: a 16 x 16 thread grid, each thread kTM rows
// x kTN columns, kMinBlocks blocks per SM, a ring of kStages slots of
// kDepth contraction steps.
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kMinBlocks = 2;
constexpr int kDepth = 16;
constexpr int kStages = 3;
// Small form, both products: kSBM rows x kSBN columns, each thread kSTM x
// kSTN, a ring of kSStages slots of kSDepth steps.
constexpr int kSBM = 32;
constexpr int kSBN = 16;
constexpr int kSTM = 2;
constexpr int kSTN = 4;
constexpr int kSDepth = 16;
constexpr int kSStages = 3;
constexpr int kSegRounds = 4;  // denoiser: segments per lane group

// Stage mask bits and product forms of the entry point.
constexpr int kStageForward = 1, kStageFold = 2, kStageAdjoint = 4,
              kStageDenoise = 8;
constexpr int kSmallForward = 1, kSmallAdjoint = 2;

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
  float* P_re;              // scratch (B Lin, Wp)
  float* P_im;
  float* P_v;
  float* Z_c;               // scratch (B Lin, Wp): adjoint inputs
  float* Z_re;
  float* Z_im;
  float* cov;               // scratch (B, Lin, Nt)
  const float* h_re;        // taps (W, Nt)
  const float* h_im;
  const float* h_a2;
  const float* hT_re;       // the taps transposed, (Nt, Wp), zero columns
  const float* hT_im;       //   from W on
  const float* hT_a2;
  const float* gains;       // (Lh, Lin)
  const float* gains2;
  const float* sym_re;      // (K,)
  const float* sym_im;
  // HIGH form only: the seven Gauss tap planes split into bf16 hi and lo,
  // per plane hi then lo; forward (W, kf) each (S_a2, Re S, Im S - Re S
  // transposed), then adjoint (Nt, ka) each (S_a2^T, Re S^T, -Im S^T -
  // Re S^T, Re S^T - Im S^T transposed); kf = Nt and ka = W rounded up to 8
  const __nv_bfloat16* taps_high;
  int B, Nt, Nr, Lin, Lout, Lh, M, K, W, Wp;
  int vec;                  // Nt % 4 == 0: 16-byte tap rows and x-side rows
  int kf, ka;
  float sigma2;
};

// Lanes of the group that takes a segment of M elements: torch_sum's lane
// count, min(32, last_pow2(M)).
__host__ __device__ inline int group_width(int M) {
  int w = 1;
  while (2 * w <= M && w < 32) w *= 2;
  return w;
}

// ---- product engine ----------------------------------------------------

// A 16-byte copy from global to shared memory: the first `bytes` come
// from src, the rest are zero.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// s[r][c] = g[r ld + c] for the ROWS x COLS block of a row-major matrix g
// (row stride ld, offset to the block's first element), zero where r >=
// rlimit or c >= climit; s has row stride LDS.  In 16-byte copies when vec
// (ld a multiple of 4, g 16-byte aligned), else 4-byte copies.  kRows8:
// the 8 lanes of a quarter-warp copy one 16-byte chunk of 8 rows (a warp
// 8 rows x 4 chunks), so that with a padded stride (LDS = COLS + 4, see
// Engine) they store to 8 different bank groups while every 64 bytes of a
// row still come from one instruction; else the lanes run along a row.
template <int ROWS, int COLS, int LDS, int NT, bool kRows8>
__device__ __forceinline__ void load_rows(float* s, const float* g, int ld,
                                          int rlimit, int climit, bool vec) {
  constexpr int C4 = COLS / 4, UNITS = ROWS * C4;
  static_assert(COLS % 4 == 0 && (!kRows8 || ROWS % 8 == 0), "copy shape");
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int i = 0; i < (UNITS + NT - 1) / NT; ++i) {
      const int u = tid + i * NT;
      if (UNITS % NT != 0 && u >= UNITS) break;
      const int r = kRows8 ? u / (8 * C4) * 8 + u % 8 : u / C4;
      const int c = (kRows8 ? (u / 8) % C4 : u % C4) * 4;
      const int n = r < rlimit ? min(max(climit - c, 0), 4) : 0;
      cp_async16(s + r * LDS + c, n ? g + (r * ld + c) : g, 4 * n);
    }
  } else {
#pragma unroll 4
    for (int u = tid; u < ROWS * COLS; u += NT) {
      const int r = u / COLS, c = u % COLS;
      const bool ok = r < rlimit && c < climit;
      cp_async4(s + r * LDS + c, ok ? g + (r * ld + c) : g, ok);
    }
  }
}

// N consecutive floats of shared memory (16- or 8-byte aligned reads).
template <int N>
__device__ __forceinline__ void frag(float (&v)[N], const float* s) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(s)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(s);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = s[q];
  }
}

// v[0 .. N) to row[n .. n+N), the entries below limit; 16-byte stores when
// vec (limit a multiple of 4 and n of 4).
template <int N>
__device__ __forceinline__ void put(float* row, int n, int limit,
                                    const float (&v)[N], bool vec) {
  if constexpr (N % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < N; q += 4)
        if (n + q < limit)
          *reinterpret_cast<float4*>(row + n + q) =
              make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < N; ++q)
    if (n + q < limit) row[n + q] = v[q];
}

// True when a row R0 .. R0 + BM - 1 of the (B Lin)-row operand belongs to
// an active trial.  Called by the whole block.
template <int BM>
__device__ __forceinline__ bool tile_live(const Params& p, int R0, int rows) {
  int live = 0;
  for (int r = threadIdx.x; r < BM; r += blockDim.x)
    if (R0 + r < rows) live |= p.act[(R0 + r) / p.Lin];
  return __syncthreads_or(live) != 0;
}

// One product form: a BM x BN block tile, a TM x TN thread tile, a ring of
// S slots of D contraction steps, MIN blocks per SM.
template <int BM_, int BN_, int TM_, int TN_, int D_, int S_, int MIN_>
struct Form {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, D = D_,
                       S = S_, MIN = MIN_;
  static constexpr int kTY = BM / TM, kTX = BN / TN, kNT = kTY * kTX;
  // a warp is WY x WX threads of the kTY x kTX grid
  static constexpr int WX = kTX < 8 ? kTX : 8, WY = 32 / WX;
};
using LargeForm =
    Form<16 * kTM, 16 * kTN, kTM, kTN, kDepth, kStages, kMinBlocks>;
using SmallForm = Form<kSBM, kSBN, kSTM, kSTN, kSDepth, kSStages, 1>;

// The shared-memory layout of form F for a product: a ring slot holds the
// kA A planes as they lie, BM rows x D steps with row stride kLA = D + 4
// (rows 16-byte aligned; with D a multiple of 8 a row spans an odd number
// of the 8 16-byte bank groups, so any 8 consecutive rows start in 8
// different groups: the WY rows a warp reads at once and the 8 rows a
// quarter-warp copies do not conflict), then the three tap planes as they
// lie, D steps x BN columns.  Forward (kFwd): A = x, var (rows of Nt), B = the
// transposed taps (Nt, Wp); adjoint: A = Z_c, Z_re, Z_im (rows of Wp),
// B = the taps (W, Nt).
template <bool kFwd, class F>
struct Engine {
  static constexpr int kA = kFwd ? 2 : 3;
  static constexpr int kLA = F::D + 4;
  static constexpr int kSlot = kA * F::BM * kLA + 3 * F::D * F::BN;
  static constexpr int kSmem = F::S * kSlot * 4;  // bytes
  static_assert(F::kNT % 32 == 0 && F::BM % 8 == 0 && F::BN % 4 == 0 &&
                    F::D % 8 == 0 && F::kTY % F::WY == 0 &&
                    F::kTX % F::WX == 0 && F::S >= 2 && F::WY <= 8,
                "tile shape");
};

// ---- 1. forward products / 3. adjoint products --------------------------
// Forward: P_re[R][n] = sum_k x[R][k] Re h[n][k], P_im likewise with Im h,
// P_v[R][n] = sum_k var[R][k] |h[n][k]|^2: rows R < B Lin, columns n < Wp
// (the transposed taps' columns n >= W are zero), contraction k < Nt.
// Adjoint: cs[R][k] = sum_w Z_c[R][w] |h[w][k]|^2 and (ar + i ai)[R][k] =
// sum_w (Z_re + i Z_im)[R][w] conj(h[w][k]): columns k < Nt, contraction
// w < W; then, for rows of active trials, cov = 1 / cs and xmap = x +
// cov (ar + i ai).
// Block i of the 1-D grid takes row tile i / col_tiles and column tile
// i % col_tiles; thread (ty, tx) takes rows ty + i kTY and columns
// tx TN + j of the tile.
template <bool kFwd, class F>
__global__ void __launch_bounds__(F::kNT, F::MIN) product_kernel(Params p) {
  using E = Engine<kFwd, F>;
  constexpr int BM = F::BM, BN = F::BN, TM = F::TM, TN = F::TN, D = F::D,
                S = F::S, kTY = F::kTY, LA = E::kLA;
  extern __shared__ __align__(16) float smem[];
  const int rows = p.B * p.Lin;
  const int cols = kFwd ? p.Wp : p.Nt;
  const int depth = kFwd ? p.Nt : p.W;
  const int col_tiles = (cols + BN - 1) / BN;
  const int R0 = static_cast<int>(blockIdx.x / col_tiles) * BM;
  const int n0 = static_cast<int>(blockIdx.x % col_tiles) * BN;
  if (!tile_live<BM>(p, R0, rows)) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp / (F::kTX / F::WX), wc = warp % (F::kTX / F::WX);
  const int ty = wr * F::WY + lane / F::WX, tx = wc * F::WX + lane % F::WX;
  const int lda = kFwd ? p.Nt : p.Wp;
  const size_t a0 = static_cast<size_t>(R0) * lda;
  const float* A[3] = {(kFwd ? p.xm : p.Z_c) + a0,
                       (kFwd ? p.var : p.Z_re) + a0,
                       kFwd ? nullptr : p.Z_im + a0};
  const int ldb = kFwd ? p.Wp : p.Nt;
  const float* Bt[3] = {(kFwd ? p.hT_re : p.h_re) + n0,
                        (kFwd ? p.hT_im : p.h_im) + n0,
                        (kFwd ? p.hT_a2 : p.h_a2) + n0};
  const bool vec_a = kFwd ? p.vec != 0 : true;
  const bool vec_b = kFwd ? true : p.vec != 0;

  auto load = [&](int slot, int k0) {
    float* s = smem + slot * E::kSlot;
#pragma unroll
    for (int a = 0; a < E::kA; ++a)
      load_rows<BM, D, LA, F::kNT, true>(s + a * BM * LA, A[a] + k0, lda,
                                         rows - R0, depth - k0, vec_a);
    float* sb = s + E::kA * BM * LA;
#pragma unroll
    for (int b = 0; b < 3; ++b)
      load_rows<D, BN, BN, F::kNT, false>(
          sb + b * D * BN, Bt[b] + static_cast<size_t>(k0) * ldb, ldb,
          depth - k0, cols - n0, vec_b);
  };

  float acc[3][TM][TN];
#pragma unroll
  for (int o = 0; o < 3; ++o)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[o][i][j] = 0.f;

  const int nk = (depth + D - 1) / D;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load(s, s * D);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    // slot kt has landed, and every thread is done with slot kt - 1
    cp_async_wait<S - 2>();
    __syncthreads();
    const int next = kt + S - 1;
    if (next < nk) load(next % S, next * D);
    cp_async_commit();
    const float* s = smem + (kt % S) * E::kSlot;
    const float* sa = s + ty * LA;
    const float* sb = s + E::kA * BM * LA + tx * TN;
#pragma unroll
    for (int k4 = 0; k4 < D; k4 += 4) {
      // four steps of the thread's A rows, then step by step the taps
      float a[E::kA][TM][4];
#pragma unroll
      for (int pl = 0; pl < E::kA; ++pl)
#pragma unroll
        for (int i = 0; i < TM; ++i)
          frag(a[pl][i], sa + (pl * BM + i * kTY) * LA + k4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float hr[TN], hi[TN], a2[TN];
        frag(hr, sb + (k4 + q) * BN);
        frag(hi, sb + (D + k4 + q) * BN);
        frag(a2, sb + (2 * D + k4 + q) * BN);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            if constexpr (kFwd) {
              const float x = a[0][i][q], v = a[1][i][q];
              acc[0][i][j] = fmaf(x, hr[j], acc[0][i][j]);
              acc[1][i][j] = fmaf(x, hi[j], acc[1][i][j]);
              acc[2][i][j] = fmaf(v, a2[j], acc[2][i][j]);
            } else {
              const float zc = a[0][i][q], zr = a[1][i][q],
                          zi = a[2][i][q];
              acc[0][i][j] = fmaf(zc, a2[j], acc[0][i][j]);
              // (zr + i zi) * conj(h)
              acc[1][i][j] = fmaf(zr, hr[j], acc[1][i][j]);
              acc[1][i][j] = fmaf(-zi, -hi[j], acc[1][i][j]);
              acc[2][i][j] = fmaf(zr, -hi[j], acc[2][i][j]);
              acc[2][i][j] = fmaf(zi, hr[j], acc[2][i][j]);
            }
          }
      }
    }
  }

  const int n = n0 + tx * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int R = R0 + ty + i * kTY;
    if (R >= rows) continue;
    if constexpr (kFwd) {
      const size_t o = static_cast<size_t>(R) * p.Wp;
      put(p.P_re + o, n, p.Wp, acc[0][i], true);
      put(p.P_im + o, n, p.Wp, acc[1][i], true);
      put(p.P_v + o, n, p.Wp, acc[2][i], true);
    } else {
      if (!p.act[R / p.Lin]) continue;
      const size_t o = static_cast<size_t>(R) * p.Nt;
      const bool vec = p.vec != 0;
      float cv[TN], xr[TN], xi[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int k = n + j;
        cv[j] = 1.f / acc[0][i][j];
        xr[j] = k < p.Nt ? p.xm[o + k] + cv[j] * acc[1][i][j] : 0.f;
        xi[j] = cv[j] * acc[2][i][j];  // the real posterior mean adds 0
      }
      put(p.cov + o, n, p.Nt, cv, vec);
      put(p.xmap_re + o, n, p.Nt, xr, vec);
      put(p.xmap_im + o, n, p.Nt, xi, vec);
    }
  }
}

// ---- 1. and 3. at HIGH: the bf16 x 3 products ------------------------------

// Contraction steps per ring slot (two k16 steps) and ring slots.
constexpr int kHK = 32;
constexpr int kHStages = 3;

// One HIGH product form: WM x WN warps, each MT m16 tiles of rows by NT n8
// tiles of columns, MIN blocks per SM.  A ring slot holds the A tile as
// FP32, BM rows x kHK steps with row stride kLA = kHK + 8 floats (a row is 8
// mod 32 words, so the 64-bit fragment reads of a half-warp, rows g = 0..3
// by words 2t, fall on 32 distinct banks), then the tap tile, hi then lo,
// BN rows x kHK steps of bf16 with row stride kLB = kHK + 8 (80 bytes: the
// 8 rows of an ldmatrix phase on 8 distinct 16-byte bank groups).
template <int WM_, int WN_, int MT_, int NT_, int MIN_>
struct HighForm {
  static constexpr int WM = WM_, WN = WN_, MT = MT_, NT = NT_, MIN = MIN_;
  static constexpr int BM = 16 * WM * MT, BN = 8 * WN * NT;
  static constexpr int kNT = 32 * WM * WN;
  static constexpr int kLA = kHK + 8, kLB = kHK + 8;
  static constexpr int kSlotA = BM * kLA * 4;      // bytes
  static constexpr int kSlot = kSlotA + 2 * BN * kLB * 2;
  static constexpr int kSmem = kHStages * kSlot;
  static_assert(kSlotA % 16 == 0 && kSlot % 16 == 0, "tile shape");
};
// Large: 128 rows (four trials at Lin = 32) x 64 columns, 8 warps of 32 x 32,
// two blocks per SM at 128 registers.  Small, where the large form would
// launch fewer than two blocks per SM (tile_forms): 32 x 32, 2 warps.
using HighLarge = HighForm<4, 2, 2, 4, 2>;
using HighSmall = HighForm<1, 2, 2, 2, 1>;

__device__ __forceinline__ void cp_async16_bf16(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

// s[r][c] = g[r ld + c] for the ROWS x kHK block of a bf16 matrix whose row
// stride ld is a multiple of 8 (its pad columns zero), zero where r >=
// rlimit or c >= climit (climit a multiple of 8); s has row stride kHK + 8.
// A quarter-warp copies one row (64 bytes).
template <int ROWS, int NT>
__device__ __forceinline__ void load_tap_rows(__nv_bfloat16* s,
                                              const __nv_bfloat16* g, int ld,
                                              int rlimit, int climit) {
  constexpr int C8 = kHK / 8, UNITS = ROWS * C8;
#pragma unroll
  for (int i = 0; i < (UNITS + NT - 1) / NT; ++i) {
    const int u = threadIdx.x + i * NT;
    if (UNITS % NT != 0 && u >= UNITS) break;
    const int r = u / C8, c = (u % C8) * 8;
    const bool ok = r < rlimit && c < climit;
    cp_async16_bf16(s + r * (kHK + 8) + c, ok ? g + (r * ld + c) : g,
                    ok ? 16 : 0);
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// d += a b for one m16n8k16 tile: a the 16 x 16 row-major fragment, (b0,
// b1) the 16 x 8 column fragment, d FP32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bf16 hi and lo pairs of two FP32 values (x ~ hi + lo, both rounded to
// nearest even, as precision.split_bf16), the lower k in the low half.
__device__ __forceinline__ void split_pair(float2 v, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v.x - hf.x, v.y - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// The products of one stage at HIGH.  Forward (kFwd), rows R < B Lin,
// columns n < Wp, contraction k < Nt, three products in turn: 0. P_v =
// dot3(var, S_a2); 1. P_re = dot3(x, Re S); 2. P_im = P_re + dot3(x, Im S -
// Re S).  Adjoint, columns k < Nt, contraction w < W, four products in turn
// on the fold's planes: 0. cov = 1 / dot3(Z_c, S_a2^T); 1. k1 = dot3(Z_re +
// Z_im, Re S^T) (the fold's sum, in P_v), parked in xmap_re; 2. xmap_im =
// cov (k1 + dot3(Z_re, -Im S^T - Re S^T)); 3. xmap_re = x + cov (k1 -
// dot3(Z_im, Re S^T - Im S^T)); written for rows of active trials only.
// Block i of the 1-D grid takes row tile i / col_tiles and column tile
// i % col_tiles; warp (wm, wn) the rows 16 MT wm .. and columns 8 NT wn ..
// of the tile; lane (g, t) of an m16n8 output tile rows g, g + 8 and
// columns 2t, 2t + 1.
template <bool kFwd, class F>
__global__ void __launch_bounds__(F::kNT, F::MIN)
    high_product_kernel(Params p) {
  constexpr int BM = F::BM, BN = F::BN, MT = F::MT, NT = F::NT,
                LA = F::kLA, LB = F::kLB, S = kHStages;
  constexpr int kPasses = kFwd ? 3 : 4;
  extern __shared__ __align__(16) unsigned char smem_high[];
  const int rows = p.B * p.Lin;
  const int cols = kFwd ? p.Wp : p.Nt;
  const int depth = kFwd ? p.Nt : p.W;
  const int col_tiles = (cols + BN - 1) / BN;
  const int R0 = static_cast<int>(blockIdx.x / col_tiles) * BM;
  const int n0 = static_cast<int>(blockIdx.x % col_tiles) * BN;
  if (!tile_live<BM>(p, R0, rows)) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / F::WN, wn = warp % F::WN;
  const int g = lane >> 2, t = lane & 3;
  const int lda = kFwd ? p.Nt : p.Wp;
  const size_t a0 = static_cast<size_t>(R0) * lda;
  // product q's A plane
  auto a_plane = [&](int q) -> const float* {
    if (kFwd) return (q == 0 ? p.var : p.xm) + a0;
    return (q == 0 ? p.Z_c : q == 1 ? p.P_v : q == 2 ? p.Z_re : p.Z_im) + a0;
  };
  // product q's taps: hi at taps + q plane, lo one half-plane further
  const int ldb = kFwd ? p.kf : p.ka;
  const int brows = kFwd ? p.W : p.Nt;
  const size_t bplane = static_cast<size_t>(brows) * ldb;
  const __nv_bfloat16* taps =
      p.taps_high + (kFwd ? 0 : 6 * static_cast<size_t>(p.W) * p.kf) +
      static_cast<size_t>(n0) * ldb;
  const bool vec_a = kFwd ? p.vec != 0 : true;
  const int nk = (depth + kHK - 1) / kHK;
  const int total = kPasses * nk;

  auto load = [&](int slot, int step) {
    unsigned char* s = smem_high + slot * F::kSlot;
    const int q = step / nk, k0 = (step - q * nk) * kHK;
    load_rows<BM, kHK, LA, F::kNT, false>(reinterpret_cast<float*>(s),
                                          a_plane(q) + k0, lda, rows - R0,
                                          depth - k0, vec_a);
    __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(s + F::kSlotA);
    const __nv_bfloat16* b = taps + 2 * q * bplane + k0;
#pragma unroll
    for (int part = 0; part < 2; ++part)
      load_tap_rows<BN, F::kNT>(sb + part * BN * LB, b + part * bplane, ldb,
                                brows - n0, ldb - k0);
  };

  float hh[MT][NT][4], cx[MT][NT][4];
  auto clear = [&]() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hh[i][j][e] = cx[i][j][e] = 0.f;
  };
  clear();

  // the block's outputs of product q, in FP32 (hh + cx), joined with the
  // earlier products' and written
  auto epilogue = [&](int q) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int R = R0 + 16 * (MT * wm + i) + g + 8 * h;
        if (R >= rows) continue;
        if (!kFwd && !p.act[R / p.Lin]) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int n = n0 + 8 * (NT * wn + j) + 2 * t + c;
            if (n >= cols) continue;
            const float v = hh[i][j][2 * h + c] + cx[i][j][2 * h + c];
            if constexpr (kFwd) {
              const size_t o = static_cast<size_t>(R) * p.Wp + n;
              if (q == 0) p.P_v[o] = v;
              else if (q == 1) p.P_re[o] = v;
              else p.P_im[o] = p.P_re[o] + v;
            } else {
              const size_t o = static_cast<size_t>(R) * p.Nt + n;
              if (q == 0) p.cov[o] = 1.f / v;
              else if (q == 1) p.xmap_re[o] = v;
              else if (q == 2) p.xmap_im[o] = p.cov[o] * (p.xmap_re[o] + v);
              else p.xmap_re[o] = p.xm[o] + p.cov[o] * (p.xmap_re[o] - v);
            }
          }
      }
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < total) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    // slot it has landed, and every thread is done with slot it - 1
    cp_async_wait<S - 2>();
    __syncthreads();
    const int next = it + S - 1;
    if (next < total) load(next % S, next);
    cp_async_commit();
    const unsigned char* s = smem_high + (it % S) * F::kSlot;
    const float* sa = reinterpret_cast<const float*>(s) +
                      (16 * MT * wm + g) * LA + 2 * t;
    // ldmatrix rows: lane l gives row l % 8 of matrix l / 8: hi k 0-7, hi
    // k 8-15, lo k 0-7, lo k 8-15 of the tile's rows 8 (NT wn + j) ..
    const __nv_bfloat16* sb =
        reinterpret_cast<const __nv_bfloat16*>(s + F::kSlotA) +
        ((lane >> 4) * BN + 8 * NT * wn + (lane & 7)) * LB +
        ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < kHK; ks += 16) {
      unsigned ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* a = sa + 16 * i * LA + ks;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // a0: row g, k 2t; a1: row g + 8; a2: k 2t + 8; a3: both
          const float2 v = *reinterpret_cast<const float2*>(
              a + (r & 1) * 8 * LA + (r >> 1) * 8);
          split_pair(v, ah[i][r], al[i][r]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        unsigned b[4];
        ldmatrix_x4(b, sb + 8 * j * LB + ks);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          // the hi hi products of this k16 step from zero, then an FP32
          // add (see the header: the accumulator truncates)
          float th[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(th, ah[i], b[0], b[1]);
          mma_bf16(cx[i][j], ah[i], b[2], b[3]);
          mma_bf16(cx[i][j], al[i], b[0], b[1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) hh[i][j][e] = hh[i][j][e] + th[e];
        }
      }
    }
    if ((it + 1) % nk == 0) {
      epilogue(it / nk);
      clear();
    }
  }
}

// ---- 2. band fold, Onsager, freeze of z and u, adjoint inputs -------------
// One thread per y-side element (b, r, m).  Tap l of output row r reads
// column block c = r - l (tail truncation: 0 <= c < Lin); the adjoint input
// of (b, c, l Nr + m) comes from row r = c + l, so each is written once.
// kHigh: the HIGH form's fold (the gains are in the taps; the Onsager
// arithmetic of bamp.linear_step_high), which also writes Z_re + Z_im, the
// operand of the adjoint's k1, over P_v.
template <bool kHigh>
__global__ void __launch_bounds__(kThreads) fold_kernel(Params p) {
  const int n = p.Lout * p.Nr, Wp = p.Wp;
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
      const size_t q = (zrow + c) * Wp + l * p.Nr + m;
      p.Z_c[q] = p.Z_re[q] = p.Z_im[q] = 0.f;
      if (kHigh) p.P_v[q] = 0.f;
    }
    return;
  }
  if constexpr (kHigh) {
    float v = 0.f, hr = 0.f, hi = 0.f;
    for (int l = 0; l < p.Lh; ++l) {
      const int c = r - l;
      if (c < 0 || c >= p.Lin) continue;
      const size_t q = (zrow + c) * Wp + l * p.Nr + m;
      v = v + p.P_v[q];
      hr = hr + p.P_re[q];
      hi = hi + p.P_im[q];
    }
    const float uo = p.u[e], yr = p.y_re[e], yi = p.y_im[e];
    const float w = v / uo;
    const float zr = hr - w * (yr - p.z_re[e]);
    const float zi = hi - w * (yi - p.z_im[e]);
    const float uu = v + p.sigma2;
    p.zn_re[e] = zr;
    p.zn_im[e] = zi;
    p.un[e] = uu;
    const float ui = 1.f / uu, rr = (yr - zr) * ui, ri = (yi - zi) * ui;
    for (int l = 0; l < p.Lh; ++l) {
      const int c = r - l;
      if (c < 0 || c >= p.Lin) continue;
      const size_t q = (zrow + c) * Wp + l * p.Nr + m;
      p.Z_c[q] = ui;
      p.Z_re[q] = rr;
      p.Z_im[q] = ri;
      p.P_v[q] = rr + ri;
    }
    return;
  }
  float v = 0.f, hr = 0.f, hi = 0.f;
  for (int l = 0; l < p.Lh; ++l) {
    const int c = r - l;
    if (c < 0 || c >= p.Lin) continue;
    const size_t q = (zrow + c) * Wp + l * p.Nr + m;
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
    const size_t q = (zrow + c) * Wp + l * p.Nr + m;
    const float g = p.gains[l * p.Lin + c];
    p.Z_c[q] = p.gains2[l * p.Lin + c] * ui;
    p.Z_re[q] = g * rr;
    p.Z_im[q] = g * ri;
  }
}

// ---- 4. denoiser, freeze of x and var, notok --------------------------------

// The posterior of segment j0 .. j0+M-1 computed by the G lanes of one
// group (lane t, mask the group's lanes), in segment_posterior's
// arithmetic for a real posterior mean (halve_tau, decomposed variance):
// the segment max and the sum of eta over the segment joined through
// shuffles, lane t folding its elements t, t+G, ... into accumulator s % 4
// for its s-th element (lane_sum's order; G is torch_sum's lane count), the
// lanes joined in torch_sum's tree; then the mean and variance of the
// lane's elements, stored to xo and vn.  Returns the lane's count of
// variance entries outside the allclose tolerance of var.
__device__ __forceinline__ int group_posterior(
    int j0, int M, int G, int t, unsigned mask, int K, const float* sr,
    const float* si, const float* cov, const float* x, const float* var,
    float* xo, float* vn) {
  auto t_of = [&](int i, int q) {
    const int j = j0 + i;
    const float tau = cov[j] / 2.f;
    const float a = x[j] / tau;
    return a * sr[q];
  };
  float mx = -INFINITY;
  for (int i = t; i < M; i += G)
    for (int q = 0; q < K; ++q) mx = fmaxf(mx, t_of(i, q));
  for (int off = G / 2; off >= 1; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(mask, mx, off, G));
  auto eta = [&](int i, int q) {
    return expf(fminf(t_of(i, q) - mx, kExpMax));
  };
  auto eta_m = [&](int i) {
    return K == 1 ? eta(i, 0)
                  : torch_sum(K, [&](int q) { return eta(i, q); });
  };
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  int s = 0;
  for (int i = t; i < M; i += G, ++s) {
    const float e = eta_m(i);
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
    float mr, mi, v;
    if (K == 1) {
      const float post = eta(i, 0) / eta2;
      mr = sr[0] * post;
      mi = si[0] * post;
      v = abs2(mr, mi) * (1.f - post) + abs2(mr - sr[0], mi - si[0]) * post;
    } else {
      mr = torch_sum(K, [&](int q) { return sr[q] * eta(i, q); }) / eta2;
      mi = torch_sum(K, [&](int q) { return si[q] * eta(i, q); }) / eta2;
      const float var0 = abs2(mr, mi) * (1.f - eta_m(i) / eta2);
      const float vs = torch_sum(K, [&](int q) {
        return abs2(mr - sr[q], mi - si[q]) * eta(i, q);
      });
      v = var0 + vs / eta2;
    }
    const int j = j0 + i;
    const float old = var[j];
    bad += !(fabsf(v - old) <= kAtol + kRtol * fabsf(old));
    xo[j] = mr;
    vn[j] = v;
  }
  return bad;
}

// Block (b, y) takes kSegRounds lane groups' worth of segments of trial b
// from segment y (kThreads / G) kSegRounds on; a frozen trial's elements
// pass through.
__global__ void __launch_bounds__(kThreads) denoise_kernel(Params p) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int N = p.Lin * p.Nt, M = p.M;
  const int G = group_width(M);
  const int per = kThreads / G * kSegRounds;
  const int s0 = blockIdx.y * per, s1 = min(s0 + per, N / M);
  const size_t base = static_cast<size_t>(b) * N;
  const float* vo = p.var + base;
  float* xo = p.xm_out + base;
  float* vn = p.var_out + base;
  if (!p.act[b]) {
    const float* xi = p.xm + base;
    for (int j = s0 * M + tid; j < s1 * M; j += kThreads) {
      xo[j] = xi[j];
      vn[j] = vo[j];
    }
    return;
  }
  const int t = tid & (G - 1);
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1) << ((tid & 31) & ~(G - 1));
  int bad = 0;
  for (int s = s0 + tid / G; s < s1; s += kThreads / G)
    bad += group_posterior(s * M, M, G, t, mask, p.K, p.sym_re, p.sym_im,
                           p.cov + base, p.xmap_re + base, vo, xo, vn);
  bad = __reduce_add_sync(0xffffffffu, bad);
  if ((tid & 31) == 0 && bad) atomicAdd(p.notok + b, bad);
}

// Launch a product kernel of block tile BM x BN, NT threads and smem bytes
// of dynamic shared memory on the 1-D grid of its tiles.
template <bool kFwd, int BM, int BN, int NT, int smem>
cudaError_t launch_tiles(void (*kernel)(Params), const Params& p,
                         cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(p.B) * p.Lin;
  const int cols = kFwd ? p.Wp : p.Nt;
  const long long tiles = (rows + BM - 1) / BM * ((cols + BN - 1) / BN);
  kernel<<<static_cast<unsigned>(tiles), NT, smem, s>>>(p);
  return cudaGetLastError();
}

template <bool kFwd, class F>
cudaError_t launch_form(const Params& p, cudaStream_t s) {
  return launch_tiles<kFwd, F::BM, F::BN, F::kNT, Engine<kFwd, F>::kSmem>(
      product_kernel<kFwd, F>, p, s);
}

template <bool kFwd, class F>
cudaError_t launch_high(const Params& p, cudaStream_t s) {
  return launch_tiles<kFwd, F::BM, F::BN, F::kNT, F::kSmem>(
      high_product_kernel<kFwd, F>, p, s);
}

}  // namespace

extern "C" {

// Enqueue one iteration of B trials on `stream`: the launches of the stages
// in `stages` (bits 1 forward, 2 fold, 4 adjoint, 8 denoiser; 15 for an
// iteration), in order, each product in its large form or, where its bit
// of `forms` is set (1 forward, 2 adjoint), its small form.  Wp is the row
// stride of the six scratch planes (B Lin, Wp): at least Lh Nr and a
// multiple of 4.  With `high` the HIGH form runs (products and fold) on
// the split Gauss taps `taps_high` (Params::taps_high; 16-byte aligned),
// and h_re .. gains2 are not read.  Returns a cudaError_t code (0 on
// success): cudaErrorInvalidValue for a geometry the kernel does not take,
// else the first error that a launch reports.  The kernel allocates
// nothing; every buffer, the scratch included, is the caller's.
int fused_bamp_tiled_iteration(
    const void* xm, const void* var, const void* z_re, const void* z_im,
    const void* u, const void* y_re, const void* y_im, const void* act,
    void* xmap_re, void* xmap_im, void* xm_out, void* var_out, void* zn_re,
    void* zn_im, void* un, void* notok, void* P_re, void* P_im, void* P_v,
    void* Z_c, void* Z_re, void* Z_im, void* cov, const void* h_re,
    const void* h_im, const void* h_a2, const void* hT_re,
    const void* hT_im, const void* hT_a2, const void* gains,
    const void* gains2, const void* sym_re, const void* sym_im, int B,
    int Nt, int Nr, int Lin, int Lh, int M, int K, int Wp, int forms,
    int stages, float sigma2, int high, const void* taps_high,
    void* stream) {
  if (B < 1 || Nt < 1 || Nr < 1 || Lin < 1 || Lh < 1 || M < 1 ||
      Nt % M != 0 || K < 1 || K > kMaxK || Wp < Lh * Nr || Wp % 4 != 0 ||
      static_cast<long long>(B) * Lin >= (1ll << 31) ||
      static_cast<long long>(B) * (Lin + Lh - 1) * Nr >= (1ll << 31) ||
      (high && (taps_high == nullptr ||
                reinterpret_cast<uintptr_t>(taps_high) % 16 != 0)))
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
  p.hT_re = static_cast<const float*>(hT_re);
  p.hT_im = static_cast<const float*>(hT_im);
  p.hT_a2 = static_cast<const float*>(hT_a2);
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
  p.W = Lh * Nr;
  p.Wp = Wp;
  p.vec = Nt % 4 == 0;
  p.taps_high = static_cast<const __nv_bfloat16*>(taps_high);
  p.kf = (Nt + 7) / 8 * 8;
  p.ka = (p.W + 7) / 8 * 8;
  p.sigma2 = sigma2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (stages & kStageForward) {
    if (high)
      err = forms & kSmallForward ? launch_high<true, HighSmall>(p, s)
                                  : launch_high<true, HighLarge>(p, s);
    else
      err = forms & kSmallForward ? launch_form<true, SmallForm>(p, s)
                                  : launch_form<true, LargeForm>(p, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (stages & kStageFold) {
    const long long ny = static_cast<long long>(B) * p.Lout * Nr;
    const unsigned blocks =
        static_cast<unsigned>((ny + kThreads - 1) / kThreads);
    if (high)
      fold_kernel<true><<<blocks, kThreads, 0, s>>>(p);
    else
      fold_kernel<false><<<blocks, kThreads, 0, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (stages & kStageAdjoint) {
    if (high)
      err = forms & kSmallAdjoint ? launch_high<false, HighSmall>(p, s)
                                  : launch_high<false, HighLarge>(p, s);
    else
      err = forms & kSmallAdjoint ? launch_form<false, SmallForm>(p, s)
                                  : launch_form<false, LargeForm>(p, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (stages & kStageDenoise) {
    const int per = kThreads / group_width(M) * kSegRounds;
    denoise_kernel<<<dim3(B, (Lin * Nt / M + per - 1) / per), kThreads, 0,
                     s>>>(p);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

// Shared memory of one block of a product (forward when `forward`, else
// the adjoint) in its small or large form, of the HIGH form when `high`,
// in bytes.
int fused_bamp_tiled_smem(int forward, int small, int high) {
  if (high) return small ? HighSmall::kSmem : HighLarge::kSmem;
  if (forward)
    return small ? Engine<true, SmallForm>::kSmem
                 : Engine<true, LargeForm>::kSmem;
  return small ? Engine<false, SmallForm>::kSmem
               : Engine<false, LargeForm>::kSmem;
}

const char* fused_bamp_tiled_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
