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
// bf16 passes on the tensor cores (mma.sync m16n8k16 on ldmatrix
// fragments), hi hi + hi lo + lo hi: each k16 step's three passes run from
// zero in the tensor cores and join the output's FP32 sum by one FP32 add,
// because the tensor cores truncate as they add into an accumulator (the
// variance product, a sum of 84 steps of positive terms, drifted by about
// 4e-6 where the accumulator carried the whole sum; PERF.md).  One
// FP32 sum instead of dot3's two (hi hi apart from the corrections) halves
// the accumulators; it changes the order of FP32 additions, not what is
// summed.
//
// Bound on this card: the tensor cores, 7 products x 3 passes x 2 B Lin Nt
// Lh Nr flop per iteration (about 1.6 TFLOP at B = 2048, 1.6 ms at 989
// TFLOP/s).  What held the first HIGH form back (PERF.md): the
// instructions around the mma (each warp split its FP32 A fragments into
// hi and lo, both column warps the same elements), 32 x 32 warp tiles, and
// epilogues that read back the block's own global writes.  This form:
//
// * the trial side comes split, once: the denoiser writes the new x and
//   var split as well (xs_next) for the next call, a small launch
//   (split_kernel) splits them where a call gets a state no call wrote (a
//   decode's first iteration, a gathered state), and the fold writes the
//   adjoint's four inputs split; the taps come split from the wrapper
//   (fused_bamp_tiled.py::high_taps, cached per operator).  All in one
//   tiled, swizzled layout (split_at), so that a ring slot takes one bulk
//   copy per operand tile (cp.async.bulk on an mbarrier) and both operands
//   are read by ldmatrix with no conversion in the inner loop;
// * a block owns a 128 x 112 output tile (8 warps of 32 x 56: per k16
//   step 4 A and 7 tap ldmatrix for 42 mma), one block per SM, and runs its
//   stage's products one after another through one ring, so the next
//   product's copies are in flight during an epilogue;
// * what later products join (P_re; k1, k1 + k2, k1 - k3) is parked in
//   shared memory, each thread in its own column, and every output leaves
//   at the last product: staged as a tile in the (then idle) ring and
//   written out a row a bulk copy, the adjoint's x brought in the same way
//   (the adjoint therefore takes cov last: 1 / v is wanted by every
//   output);
// * where the large form would launch fewer blocks than the card has SMs
//   (phase 2's handful of trials), a 32 x 16 form of 2 warps
//   (fused_bamp_tiled.py::tile_forms).
//
// The HIGHEST instance (the product_kernel above and the fold's kHigh
// false instance) is unchanged.
//
// The DEFAULT form (precision='default', make_dot(DEFAULT): one bf16 pass)
// runs the HIGH form's launches and functions on operands of its own and
// an engine of its own (default_product_kernel).  Its plain version is one
// bamp.step with bamp.linear_step_high on precision.dot1.  What held it
// back while it ran the HIGH engine with the hi·hi mma alone (PERF.md §6,
// probe builds) was not the bytes copied into shared memory (half of
// them, or none of one operand, gained nothing) but the work around the
// mma in a block alone on its SM: one barrier a ring slot, so the eight
// warps read their fragments and ran their mma in lockstep; tap ldmatrix
// that brought lo halves no mma read; every block's prologue; and a last
// epilogue that staged each output in the ring and waited for its stores
// before the next (0.17 ms of the forward's 1.78, 0.59 of the adjoint's
// 3.19).  This form:
//
// * hi halves only, in a layout of their own (split1_at): HIGH's tiles
//   with the next k16 step's hi where HIGH keeps the lo, which is also
//   wgmma's K-major 64-byte swizzle; the taps from the wrapper
//   (fused_bamp_tiled.py::default_taps), x and var from the split launch
//   or the previous call's denoiser, the adjoint inputs from the fold, each
//   writing hi alone (kOne instances);
// * the large form on wgmma: two warpgroups of 64 x 112 read both operands
//   from the ring (no ldmatrix), each k16 step's product from zero (scale-d
//   off), then one FP32 add; the small form on mma.sync (ldmatrix_x4 of a
//   tap row brings both k16 steps of a tile);
// * persistent blocks (one per SM; the small form four) that walk their
//   tiles with one ring running on from tile to tile, so the next tile's
//   copies are in flight during an epilogue and no block starts cold;
// * ring slots of several tiles (the forward three, the adjoint two: one
//   bulk copy per operand of 6 or 4 k16 steps): the copies cost by their
//   number, not their bytes (half the bytes a copy gained nothing, half the
//   copies 0.6 ms);
// * a full and an empty mbarrier per slot in place of the block barrier:
//   each warp frees a slot when it has read it, thread 0 refills the slot
//   of the step before, so warps run up to S - 2 slots apart (a warp of
//   its own for the copies, a ninth, capped every thread at 168 registers:
//   three warps share a sub-partition's 16K; it spilled and ran slower);
// * outputs stored from the registers and the parks (8-byte stores, a
//   warp's 8 rows x 32 bytes: whole sectors), the forward's each at the
//   epilogue that makes it final (P_re parked alone: one park), the
//   adjoint's at its last, x read first, every load before the first store:
//   no staging, no block barrier.  (Outputs staged in row-major parks and
//   sent by bulk copies cost a block barrier per output; the adjoint's
//   outputs spread over its epilogues, cov first; both ran slower: PERF.md
//   §6.)

// Each output is still one FP32 sum of its k16 steps in order, each step's
// hi·hi product from zero, so the results are the HIGH engine's one-pass
// results bit for bit.

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
  // HIGH form only, all in the split layout (high section below): the
  // seven Gauss tap planes, the output columns along the rows in tiles of
  // kHCols, the forward's (Re S, Im S - Re S, S_a2; ctf tiles of kxs k16
  // steps) then the adjoint's (Re S^T, -Im S^T - Re S^T, Re S^T - Im S^T,
  // S_a2^T; cta tiles of kas steps); the forward's trial-side operands (x,
  // var), written by the split launch; the adjoint's (Z_re + Z_im, Z_re,
  // Z_im, Z_c), written by the fold; both in rtiles tiles of kHRows rows;
  // where xs_next is given, the denoiser writes the new x and var split
  // into it as the split launch lays them out, for the next call.  DEFAULT
  // form: the same planes, hi alone, in split1_at's layout
  const __nv_bfloat16* taps_high;
  __nv_bfloat16* xs_high;
  __nv_bfloat16* zs_high;
  __nv_bfloat16* xs_next;   // the denoiser's split x and var (or null)
  int one;                  // DEFAULT: the split planes in split1_at's layout
  int B, Nt, Nr, Lin, Lout, Lh, M, K, W, Wp;
  int vec;                  // Nt % 4 == 0: 16-byte tap rows and x-side rows
  int kxs, kas, rtiles, ctf, cta;
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

// The split layout of a trial-side plane (x, var; the adjoint inputs) and of
// a tap plane: tiles of kHRows rows (trial side; kHCols output columns for
// the taps) by one k16 step, each tile contiguous (tile (t, s) of a plane
// of ks steps at (t ks + s) rows_per_tile rows), a row 64 bytes: the bf16
// hi of its 16 steps in chunks 0 and 1 (8 each), their lo in chunks 2 and
// 3, chunk c of row r stored at 16-byte position c ^ ((r / 2) % 4), so the
// eight rows an ldmatrix phase reads lie on eight different bank groups.
// The contraction is padded to an even number of steps (kSlotSteps).  A
// ring slot is two consecutive tiles (or a slice of their rows) of each
// operand, brought by one bulk copy per tile.  Pads (rows past the last,
// steps past the contraction) hold zeros in the tap planes and in the
// contraction pad of the trial side (rows past the last are left as they
// are: a row's outputs read only that row).
constexpr int kHRows = 128;
constexpr int kHCols = 112;
constexpr int kSlotSteps = 2;    // k16 steps of a ring slot
constexpr int kStageSplit = 16;  // stage bit: the split of x and var (HIGH)

__host__ __device__ __forceinline__ int split_chunk(int c, int r) {
  return c ^ ((r >> 1) & 3);
}
// Where part h (0 hi, 1 lo) of element (row R, step k) of a split plane of
// ks k16 steps and tiles of `tile` rows lies, in bf16.
__host__ __device__ __forceinline__ size_t split_at(int ks, int tile, int R,
                                                    int k, int h) {
  const int r = R % tile;
  return (static_cast<size_t>(R / tile * ks + (k >> 4)) * tile + r) * 32 +
         split_chunk(2 * h + ((k & 15) >> 3), r) * 8 + (k & 7);
}
// The DEFAULT form's layout, hi halves alone: tiles of `tile` rows by two
// k16 steps (ks / 2 of them along a plane of ks steps), a row 64 bytes, the
// hi of its 32 contraction steps in chunks 0 .. 3, swizzled as above: the
// HIGH layout with step 2 s + 1's hi where step 2 s's lo lies.  Where the
// hi of element (row R, step k) lies, in bf16.
__host__ __device__ __forceinline__ size_t split1_at(int ks, int tile, int R,
                                                     int k) {
  const int r = R % tile;
  return (static_cast<size_t>(R / tile * (ks >> 1) + (k >> 5)) * tile + r) *
             32 +
         split_chunk((k & 31) >> 3, r) * 8 + (k & 7);
}

// One HIGH product form: WM x WN warps, each MT m16 tiles of rows by NT n8
// tiles of columns, a ring of S slots of kSlotSteps k16 steps, MIN blocks
// per SM.
// Shared memory: the ring, then two parks (a thread's outputs of earlier
// products, in its own column), then the ring's mbarriers and, for the
// adjoint, that of its last epilogue's copies.
template <int WM_, int WN_, int MT_, int NT_, int S_, int MIN_>
struct HighForm {
  static constexpr int WM = WM_, WN = WN_, MT = MT_, NT = NT_, S = S_,
                       MIN = MIN_;
  static constexpr int BM = 16 * WM * MT, BN = 8 * WN * NT;
  static constexpr int kNT = 32 * WM * WN;
  static constexpr int kOut = 4 * MT * NT;      // a thread's outputs
  static constexpr int kTileA = BM * 64, kTileB = BN * 64;  // bytes
  static constexpr int kSlotA = kSlotSteps * kTileA;
  static constexpr int kSlotB = kSlotSteps * kTileB;
  static constexpr int kSlot = kSlotA + kSlotB;
  static constexpr int kPark = kOut * kNT * 4;
  static constexpr int smem(bool fwd) {
    return S * kSlot + 2 * kPark + 8 * (fwd ? S : S + 1);
  }
  static_assert(kHRows % BM == 0 && kHCols % BN == 0 && kSlot % 128 == 0 &&
                    S >= 2,
                "tile shape");
};
// Large: 128 rows (four trials at Lin = 32) x 112 columns (Wp = 440 in 4
// tiles, Nt = 1344 in 12), 8 warps of 32 x 56, one block per SM.  Small,
// where the large form would launch fewer blocks than the card has SMs
// (tile_forms): 32 x 16, 2 warps.
using HighLarge = HighForm<4, 2, 2, 7, 3, 1>;
using HighSmall = HighForm<2, 1, 1, 2, 3, 4>;

// One DEFAULT product form: WM x WN warps, each MT m16 tiles of rows by NT
// n8 tiles of columns (on wgmma: warpgroups of 64 rows), a ring of S slots
// of T split1_at tiles (two k16 steps each) of each operand, MIN
// persistent blocks per SM.  Shared memory: the ring, one park (forward)
// or two (adjoint), each a float per output of the block tile, each
// thread's in its own column, then a full and an empty mbarrier per slot.
template <int WM_, int WN_, int MT_, int NT_, int S_, int MIN_,
          bool WG_ = false, int T_ = 1>
struct DefaultForm {
  static constexpr int WM = WM_, WN = WN_, MT = MT_, NT = NT_, S = S_,
                       MIN = MIN_;
  static constexpr bool WG = WG_;  // wgmma: warpgroups of 64 x BN
  static constexpr int T = T_;     // split1_at tiles (2 k16 steps) a slot
  static constexpr int BM = 16 * WM * MT, BN = 8 * WN * NT;
  static constexpr int kNT = 32 * WM * WN, kWarps = WM * WN;
  static constexpr int kOut = 4 * MT * NT;      // a thread's outputs
  static constexpr int kTileA = BM * 64, kTileB = BN * 64;  // bytes
  static constexpr int kSlotA = T * kTileA, kSlot = T * (kTileA + kTileB);
  static constexpr int kPark = kOut * kNT * 4;
  // the forward parks P_re alone, the adjoint k1 and k1 + k2
  static constexpr int smem(bool fwd) {
    return S * kSlot + (fwd ? 1 : 2) * kPark + 16 * S;
  }
  // a slot's T tiles of an operand lie in one piece of its plane only
  // where the block takes whole layout tiles
  static_assert(kHRows % BM == 0 && kHCols % BN == 0 && kSlot % 512 == 0 &&
                    S >= 2 && (!WG || (WN == 1 && MT == 1 && WM % 4 == 0)) &&
                    (T == 1 || (BM == kHRows && BN == kHCols)),
                "tile shape");
};
// Large: HighLarge's 128 x 112 tiles, two warpgroups of 64 x 112 on wgmma
// (a warp's outputs those of an mma.sync warp of 16 x 112), one block per
// SM, 3 slots of three tiles in the forward (6 k16 steps: one 24 KB and
// one 21 KB copy; the copies cost by their number more than by their
// bytes; 195,632 B) and of two in the adjoint, whose two parks leave room
// for no more (206,896 B); small: HighSmall's 32 x 16 on mma.sync, 4 slots
// of a tile, four blocks per SM.
using DefaultLarge = DefaultForm<8, 1, 1, 14, 3, 1, true, 3>;
using DefaultLargeAdjoint = DefaultForm<8, 1, 1, 14, 3, 1, true, 2>;
using DefaultSmall = DefaultForm<2, 1, 1, 2, 4, 4>;

// wgmma on two shared-memory operands in split1_at's layout, which is the
// K-major 64-byte swizzle of wgmma (a row 64 bytes, 16-byte chunk c of row
// r at c ^ ((r / 2) % 4), the pattern repeating every 8 rows, 512 bytes):
// the descriptor of the operand starting at shared address `addr` (512-byte
// aligned, or 32 bytes past such a start for a tile's second k16 step),
// rows 512 bytes apart in groups of 8.
__device__ __forceinline__ unsigned long long wgmma_desc(unsigned addr) {
  return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4) |
         (1ull << 16) |                      // leading byte offset (unused)
         (static_cast<unsigned long long>(512 >> 4) << 32) |
         (2ull << 62);                       // 64-byte swizzle
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// d = a b from zero (scale-d off) for a 64 x 112 x 16 warpgroup tile: a
// the 64 rows of the trial side, b the 112 tap rows, both K-major; d in the
// mma.sync C layout of 14 n8 tiles (d[4 j + e]).
__device__ __forceinline__ void wgmma_m64n112_zero(float (&d)[56],
                                                   unsigned long long da,
                                                   unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55}, %56, %57, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
        "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]),
        "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
        "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]),
        "=f"(d[55])
      : "l"(da), "l"(db)
      : "memory");
}
// keep the compiler from reading d before the wait that completes it
__device__ __forceinline__ void wgmma_hold(float (&d)[56]) {
#pragma unroll
  for (int i = 0; i < 56; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// One arrival that also expects `bytes` of copies to complete on bar.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Wait until the phase of bar with the given parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// Order this thread's earlier accesses of shared memory before later ones
// of the copy engine (the async proxy) that a barrier orders after them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) from shared
// to device memory by the copy engine, in this thread's bulk group; then
// close the group, and wait until the engine has read every group's
// shared memory (its writes to device memory go on).
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_stores_read() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) from device
// to shared memory by the copy engine, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d = a b (from zero) and d += a b for one m16n8k16 tile: a the 16 x 16
// row-major fragment, (b0, b1) the 16 x 8 column fragment, d FP32.
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4],
                                              const unsigned (&a)[4],
                                              unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bf16 hi and lo of x (x ~ hi + lo, both rounded to nearest even, as
// precision.split_bf16).
__device__ __forceinline__ void split1(float x, __nv_bfloat16& hi,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}
__device__ __forceinline__ unsigned pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(a)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(b)) << 16);
}

// ---- 0. at HIGH and DEFAULT: x and var split into the forward's operands --
// One thread per (plane, row tile, tile step, row): the row's FP32 of the
// tile's contraction steps in (16 at HIGH, 32 at DEFAULT), its 64-byte
// split row out (consecutive threads on consecutive rows, so a warp writes
// 2 KB in one piece); x is plane 0, var plane 1; zeros past the
// contraction and past the last row.  kOne: the hi halves alone, in
// split1_at's layout.
template <bool kOne>
__global__ void __launch_bounds__(kThreads) split_kernel(Params p) {
  constexpr int kK = kOne ? 32 : 16;  // contraction steps of a tile's row
  const int nt = kOne ? p.kxs / 2 : p.kxs;  // tiles along the contraction
  const size_t per_plane = static_cast<size_t>(p.rtiles) * nt * kHRows;
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= 2 * per_plane) return;
  const int plane = static_cast<int>(e / per_plane);
  const size_t i = e - plane * per_plane;  // (tile, step, row) of the plane
  const int r = static_cast<int>(i % kHRows);
  const int ks = static_cast<int>(i / kHRows % nt);
  const int R = static_cast<int>(i / (static_cast<size_t>(kHRows) * nt)) *
                    kHRows + r;
  const int k0 = kK * ks;
  float v[kK];
  const float* src =
      (plane == 0 ? p.xm : p.var) + static_cast<size_t>(R) * p.Nt + k0;
  const bool in = R < p.B * p.Lin;
  if (in && p.vec && k0 + kK <= p.Nt) {
#pragma unroll
    for (int q = 0; q < kK / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(src)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kK; ++q) v[q] = in && k0 + q < p.Nt ? src[q] : 0.f;
  }
  unsigned w[4][4];  // chunk c: hi (c < 2) or lo of steps 8 (c % 2) ..;
                     // kOne: the hi of steps 8 c ..
  if constexpr (kOne) {
#pragma unroll
    for (int q = 0; q < 16; ++q)
      w[q >> 2][q & 3] = pack2(__float2bfloat16_rn(v[2 * q]),
                               __float2bfloat16_rn(v[2 * q + 1]));
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      __nv_bfloat16 h0, l0, h1, l1;
      split1(v[2 * q], h0, l0);
      split1(v[2 * q + 1], h1, l1);
      w[q >> 2][q & 3] = pack2(h0, h1);
      w[2 + (q >> 2)][q & 3] = pack2(l0, l1);
    }
  }
  uint4* dst = reinterpret_cast<uint4*>(p.xs_high + plane * per_plane * 32 +
                                        i * 32);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    dst[split_chunk(c, r)] = make_uint4(w[c][0], w[c][1], w[c][2], w[c][3]);
}

// The products of one stage at HIGH.  Forward (kFwd), rows R < B Lin,
// columns n < Wp, contraction k < Nt, three products in turn on the split
// x and var: 0. P_re = dot3(x, Re S); 1. P_im = P_re + dot3(x, Im S -
// Re S); 2. P_v = dot3(var, S_a2).  Adjoint, columns k < Nt, contraction
// w < W, four products in turn on the fold's split planes: 0. k1 =
// dot3(Z_re + Z_im, Re S^T); 1. k2 = dot3(Z_re, -Im S^T - Re S^T); 2. k3 =
// dot3(Z_im, Re S^T - Im S^T); 3. cov = 1 / dot3(Z_c, S_a2^T), xmap_re = x
// + cov (k1 - k3), xmap_im = cov (k1 + k2), written for rows of active
// trials only.  What a later product joins is parked in shared memory;
// every output leaves at the last product (last_epilogue).  Block i of the
// 1-D grid takes row tile i / col_tiles and column tile i % col_tiles; warp
// (wm, wn) the rows 16 MT wm .. and columns 8 NT wn .. of the tile; lane
// (g, t) of an m16n8 output tile rows g, g + 8 and columns 2t, 2t + 1.
// Thread 0 issues the copies of the slot S - 1 ahead after each slot's
// barrier; one pipeline runs over every (product, slot) of the block, so
// the next product's copies are in flight during an epilogue.
template <bool kFwd, class F>
__global__ void __launch_bounds__(F::kNT, F::MIN)
    high_product_kernel(Params p) {
  constexpr int BM = F::BM, BN = F::BN, MT = F::MT, NT = F::NT, S = F::S;
  constexpr int kPasses = kFwd ? 3 : 4;
  extern __shared__ __align__(128) unsigned char smem_high[];
  const int rows = p.B * p.Lin;
  const int cols = kFwd ? p.Wp : p.Nt;
  const int col_tiles = (cols + BN - 1) / BN;
  const int R0 = static_cast<int>(blockIdx.x / col_tiles) * BM;
  const int n0 = static_cast<int>(blockIdx.x % col_tiles) * BN;
  if (!tile_live<BM>(p, R0, rows)) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / F::WN, wn = warp % F::WN;
  const int g = lane >> 2, t = lane & 3;
  const int nks = kFwd ? p.kxs : p.kas;  // even (kSlotSteps)
  const int slots = nks / kSlotSteps;     // ring slots of a product
  const int total = kPasses * slots;
  float* park = reinterpret_cast<float*>(smem_high + S * F::kSlot);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(
      smem_high + S * F::kSlot + 2 * F::kPark);

  // the block's rows of trial-side plane a, and columns of tap plane b
  const size_t aplane = static_cast<size_t>(p.rtiles) * nks * kHRows * 32;
  const __nv_bfloat16* arows =
      (kFwd ? p.xs_high : p.zs_high) +
      (static_cast<size_t>(R0 / kHRows) * nks * kHRows + R0 % kHRows) * 32;
  const int ctiles = kFwd ? p.ctf : p.cta;
  const size_t bplane = static_cast<size_t>(ctiles) * nks * kHCols * 32;
  const __nv_bfloat16* bcols =
      p.taps_high +
      (kFwd ? 0 : 3 * static_cast<size_t>(p.ctf) * p.kxs * kHCols * 32) +
      (static_cast<size_t>(n0 / kHCols) * nks * kHCols + n0 % kHCols) * 32;
  // thread 0: the copies of slot f (product q, k16 steps ks, ks + 1) into
  // ring slot f % S
  auto load = [&](int f) {
    const int q = f / slots, ks = (f - q * slots) * kSlotSteps, slot = f % S;
    unsigned char* s = smem_high + slot * F::kSlot;
    const int a = kFwd ? (q == 2 ? 1 : 0) : q;
    mbar_expect(&bar[slot], F::kSlot);
#pragma unroll
    for (int k = 0; k < kSlotSteps; ++k) {
      bulk_copy(s + k * F::kTileA,
                arows + a * aplane +
                    static_cast<size_t>(ks + k) * kHRows * 32,
                F::kTileA, &bar[slot]);
      bulk_copy(s + F::kSlotA + k * F::kTileB,
                bcols + q * bplane +
                    static_cast<size_t>(ks + k) * kHCols * 32,
                F::kTileB, &bar[slot]);
    }
  };

  // ldmatrix rows: A rows 16 (MT wm + i) + lane % 16, hi chunk lane / 16
  // (lo 2 further); taps rows 8 (NT wn + j) + lane % 8, chunk lane / 8 (hi
  // k 0-7, hi k 8-15, lo k 0-7, lo k 8-15): the fragments b[0..3]
  int a_hi[MT], a_lo[MT], b_at[NT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = 16 * (MT * wm + i) + (lane & 15);
    a_hi[i] = r * 32 + split_chunk(lane >> 4, r) * 8;
    a_lo[i] = r * 32 + split_chunk(2 + (lane >> 4), r) * 8;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = 8 * (NT * wn + j) + (lane & 7);
    b_at[j] = n * 32 + split_chunk(lane >> 3, n) * 8;
  }

  float acc[MT][NT][4];
  auto clear = [&]() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  };
  clear();

  // A thread's output e of its tile (i, j) is park entry ((i NT + j) 4 +
  // e) of its column; park 1 lies a park further.
  auto park_at = [&](int i, int j, int e) {
    return park + ((i * NT + j) * 4 + e) * F::kNT + tid;
  };
  // the epilogue of every product but the last: the parks (forward: 0.
  // P_re, 1. P_im = P_re + the product; adjoint: 0. k1, 1. k1 + k2, 2.
  // k1 - k3 over k1)
  auto epilogue = [&](int q) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* p0 = park_at(i, j, e);
          float* p1 = p0 + F::kPark / 4;
          const float v = acc[i][j][e];
          if (q == 0) *p0 = v;
          else if (q == 1) *p1 = *p0 + v;
          else *p0 = *p0 - v;
        }
  };

  // The last epilogue, in the ring (free once the last slot is consumed):
  // each output is staged there as a BM x BN tile and leaves it a row a
  // bulk copy (with 16-byte rows; else by the threads), whose writes to
  // device memory go on as the next output is staged and after the block
  // ends (the forward's P_v, P_re, P_im; the adjoint's
  // xmap_re = x + cov (k1 - k3), cov = 1 / v, xmap_im = cov (k1 + k2), for
  // the rows of active trials).  The adjoint's x comes in first, one bulk
  // copy a row (with 16-byte rows; else by the threads).
  constexpr int XLD = BN + 8;  // row stride: the 4 rows of a half-warp's
                               // 8-byte accesses on 32 banks
  static_assert(BM * XLD * 4 <= S * F::kSlot, "staged tile in the ring");
  float* xt = reinterpret_cast<float*>(smem_high);
  const int nrows = min(BM, rows - R0), ncols = min(BN, cols - n0);
  const int ld = kFwd ? p.Wp : p.Nt;
  const bool vec4 = ld % 4 == 0;
  // the thread's two outputs at (i, h, j) in the staged tile
  auto staged = [&](int i, int h, int j) {
    return reinterpret_cast<float2*>(
        xt + (16 * (MT * wm + i) + g + 8 * h) * XLD + 8 * (NT * wn + j) +
        2 * t);
  };
  auto store_tile = [&](float* out) {
    if (vec4) {
      // a row a bulk copy, issued by the lanes of warp 0
      fence_proxy_async();  // the staged writes before the engine's reads
      __syncthreads();
      if (warp == 0) {
        for (int r = lane; r < nrows; r += 32)
          if (kFwd || p.act[(R0 + r) / p.Lin])
            bulk_store(out + static_cast<size_t>(R0 + r) * ld + n0,
                       xt + r * XLD, ncols * 4);
        bulk_stores_read();
      }
      __syncthreads();  // read out: the tile may be staged again
      return;
    }
    __syncthreads();  // the tile is complete
    for (int u = tid; u < nrows * BN; u += F::kNT) {
      const int r = u / BN, c = u % BN;
      if (c < ncols && (kFwd || p.act[(R0 + r) / p.Lin]))
        out[static_cast<size_t>(R0 + r) * ld + n0 + c] = xt[r * XLD + c];
    }
    __syncthreads();  // before the tile is staged again
  };
  // stage the outputs value(i, j, e) of every thread, then store them
  auto put_tile = [&](float* out, auto value) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          *staged(i, h, j) =
              make_float2(value(i, j, 2 * h), value(i, j, 2 * h + 1));
    store_tile(out);
  };
  auto last_epilogue = [&]() {
    if constexpr (kFwd) {
      __syncthreads();  // every warp is done with the ring
      put_tile(p.P_v, [&](int i, int j, int e) { return acc[i][j][e]; });
      put_tile(p.P_re, [&](int i, int j, int e) { return *park_at(i, j, e); });
      put_tile(p.P_im, [&](int i, int j, int e) {
        return park_at(i, j, e)[F::kPark / 4];
      });
    } else {
      fence_proxy_async();  // the ring's reads before the copies' writes
      __syncthreads();
      if (vec4) {
        if (tid == 0) {
          mbar_expect(&bar[S], nrows * ncols * 4);
          for (int r = 0; r < nrows; ++r)
            bulk_copy(xt + r * XLD,
                      p.xm + static_cast<size_t>(R0 + r) * p.Nt + n0,
                      ncols * 4, &bar[S]);
        }
        mbar_wait(&bar[S], 0);
      } else {
        for (int u = tid; u < nrows * BN; u += F::kNT) {
          const int r = u / BN, c = u % BN;
          xt[r * XLD + c] =
              c < ncols ? p.xm[static_cast<size_t>(R0 + r) * p.Nt + n0 + c]
                        : 0.f;
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 1.f / acc[i][j][e];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            float2* x = staged(i, h, j);
            const float2 xo = *x;
            *x = make_float2(
                xo.x + acc[i][j][2 * h] * *park_at(i, j, 2 * h),
                xo.y + acc[i][j][2 * h + 1] * *park_at(i, j, 2 * h + 1));
          }
      store_tile(p.xmap_re);
      put_tile(p.cov, [&](int i, int j, int e) { return acc[i][j][e]; });
      put_tile(p.xmap_im, [&](int i, int j, int e) {
        return acc[i][j][e] * park_at(i, j, e)[F::kPark / 4];
      });
    }
  };

  if (tid == 0) {
    for (int s = 0; s < S + (kFwd ? 0 : 1); ++s) mbar_init(&bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int f = 0; f < S - 1 && f < total; ++f) load(f);
  for (int f = 0; f < total; ++f) {
    const int slot = f % S;
    mbar_wait(&bar[slot], (f / S) & 1);
    __syncthreads();  // every warp is done with slot f - 1
    if (tid == 0 && f + S - 1 < total) load(f + S - 1);
    // the slot's k16 steps: every fragment of a step first, then per tile
    // its three passes
#pragma unroll
    for (int k = 0; k < kSlotSteps; ++k) {
      const __nv_bfloat16* sa = reinterpret_cast<const __nv_bfloat16*>(
          smem_high + slot * F::kSlot + k * F::kTileA);
      const __nv_bfloat16* sb = reinterpret_cast<const __nv_bfloat16*>(
          smem_high + slot * F::kSlot + F::kSlotA + k * F::kTileB);
      unsigned ah[MT][4], al[MT][4], b[NT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        ldmatrix_x4(ah[i], sa + a_hi[i]);
        ldmatrix_x4(al[i], sa + a_lo[i]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) ldmatrix_x4(b[j], sb + b_at[j]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          // this k16 step's three passes from zero, then an FP32 add (see
          // the header: the tensor cores truncate as they accumulate)
          float th[4];
          mma_bf16_zero(th, ah[i], b[j][0], b[j][1]);
          mma_bf16(th, ah[i], b[j][2], b[j][3]);
          mma_bf16(th, al[i], b[j][0], b[j][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = acc[i][j][e] + th[e];
        }
    }
    if (f + 1 == total) {
      last_epilogue();
    } else if ((f + 1) % slots == 0) {
      epilogue(f / slots);
      clear();
    }
  }
}

// The products of one stage at DEFAULT: the functions of
// high_product_kernel with one bf16 pass (0. P_re = dot1(x, Re S), 1. P_im
// = P_re + dot1(x, Im S - Re S), 2. P_v = dot1(var, S_a2); adjoint 0. k1,
// 1. k2, 2. k3, 3. cov and xmap, for the rows of active trials), on the
// hi-only operands of split1_at.  A block is persistent: it takes tiles
// blockIdx.x, + gridDim.x, ... (the column tile varying fastest, so the
// blocks at work share their trial-side rows in L2), skipping those whose
// rows hold no active trial, and one pipeline runs over every (tile,
// product, slot) of the block.  Warp (wm, wn) takes the rows 16 MT wm ..
// and columns 8 NT wn .. of a tile, lane (g, t) of an m16n8 output tile
// rows g, g + 8 and columns 2t, 2t + 1.  A slot's full barrier completes
// on its copies; each warp arrives on its empty barrier once it has read
// it; thread 0, once its warp has read step f, waits for step f - 1's slot
// to be free and refills it with step f - 1 + S, before its warp's adds.
template <bool kFwd, class F>
__global__ void __launch_bounds__(F::kNT, F::MIN)
    default_product_kernel(Params p) {
  constexpr int BM = F::BM, BN = F::BN, MT = F::MT, NT = F::NT, S = F::S;
  constexpr int kPasses = kFwd ? 3 : 4;
  extern __shared__ __align__(1024) unsigned char smem_one[];
  const int rows = p.B * p.Lin;
  const int cols = kFwd ? p.Wp : p.Nt;
  const int col_tiles = (cols + BN - 1) / BN;
  const int tiles = (rows + BM - 1) / BM * col_tiles;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / F::WN, wn = warp % F::WN;
  const int g = lane >> 2, t = lane & 3;
  const int nkt = (kFwd ? p.kxs : p.kas) / 2;  // tiles of a plane's row
  const int nslots = (nkt + F::T - 1) / F::T;  // ring slots of a product
  float* park = reinterpret_cast<float*>(smem_one + S * F::kSlot);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(
      smem_one + S * F::kSlot + (kFwd ? 1 : 2) * F::kPark);
  unsigned long long* empty = full + S;

  // a tile whose rows hold an active trial
  auto live = [&](int tile) {
    const int R0 = tile / col_tiles * BM;
    const int last = (min(R0 + BM, rows) - 1) / p.Lin;
    for (int b = R0 / p.Lin; b <= last; ++b)
      if (p.act[b]) return true;
    return false;
  };
  auto next_live = [&](int tile) {
    do tile += gridDim.x;
    while (tile < tiles && !live(tile));
    return tile;
  };

  // the block's rows of trial-side plane a, and columns of tap plane b
  const size_t aplane = static_cast<size_t>(p.rtiles) * nkt * kHRows * 32;
  const __nv_bfloat16* abase = kFwd ? p.xs_high : p.zs_high;
  const size_t bplane =
      static_cast<size_t>(kFwd ? p.ctf : p.cta) * nkt * kHCols * 32;
  const __nv_bfloat16* bbase =
      p.taps_high +
      (kFwd ? 0 : 3 * static_cast<size_t>(p.ctf) * (p.kxs / 2) * kHCols * 32);
  // the tiles of slot s of a product (the last may hold fewer)
  auto tiles_of = [&](int s) { return min(F::T, nkt - F::T * s); };
  // thread 0: the copies of tile `tile`'s product q, slot s (tiles T s ..
  // of each operand's row, in one piece), into ring slot `slot`
  auto load = [&](int tile, int q, int s, int slot) {
    const int R0 = tile / col_tiles * BM, n0 = tile % col_tiles * BN;
    const int a = kFwd ? (q == 2 ? 1 : 0) : q;
    const int n = tiles_of(s), k0 = F::T * s;
    unsigned char* dst = smem_one + slot * F::kSlot;
    mbar_expect(&full[slot], n * (F::kTileA + F::kTileB));
    bulk_copy(dst,
              abase + a * aplane +
                  ((static_cast<size_t>(R0 / kHRows) * nkt + k0) * kHRows +
                   R0 % kHRows) * 32,
              n * F::kTileA, &full[slot]);
    bulk_copy(dst + F::kSlotA,
              bbase + q * bplane +
                  ((static_cast<size_t>(n0 / kHCols) * nkt + k0) * kHCols +
                   n0 % kHCols) * 32,
              n * F::kTileB, &full[slot]);
  };

  // ldmatrix rows: A rows 16 (MT wm + i) + lane % 16, chunk lane / 16 of
  // step 0 (k 0-7, 8-15) or 2 + lane / 16 of step 1; taps rows 8 (NT wn +
  // j) + lane % 8, chunk lane / 8: the fragments b[0], b[1] of step 0 and
  // b[2], b[3] of step 1
  int a_at[2][MT], b_at[NT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = 16 * (MT * wm + i) + (lane & 15);
#pragma unroll
    for (int k = 0; k < 2; ++k)
      a_at[k][i] = r * 32 + split_chunk(2 * k + (lane >> 4), r) * 8;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = 8 * (NT * wn + j) + (lane & 7);
    b_at[j] = n * 32 + split_chunk(lane >> 3, n) * 8;
  }

  // A thread's output e of its tile (i, j) is park entry ((i NT + j) 4 +
  // e) of its column; park 1 lies a park further.  Every park entry is
  // written and read by its own thread alone.
  auto park_at = [&](int i, int j, int e) {
    return park + ((i * NT + j) * 4 + e) * F::kNT + tid;
  };
  // an output pair (row R, columns n, n + 1) to device memory (n + 1 may
  // lie past the last column)
  auto store2 = [&](float* out, int R, int n, float v0, float v1) {
    float* o = out + static_cast<size_t>(R) * cols + n;
    if (n + 1 < cols && cols % 2 == 0) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      o[0] = v0;
      if (n + 1 < cols) o[1] = v1;
    }
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s]);
      mbar_init(&empty[s], F::kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int first = live(blockIdx.x) ? static_cast<int>(blockIdx.x)
                                     : next_live(blockIdx.x);
  // thread 0's cursor: the next (tile, product, k32 step) to copy
  int ct = first, cq = 0, cs = 0;
  auto advance = [&]() {
    if (++cs == nslots) {
      cs = 0;
      if (++cq == kPasses) {
        cq = 0;
        ct = next_live(ct);
      }
    }
  };
  // thread 0, once its warp has read step f: step f - 1's slot, when every
  // warp has freed it, takes step f - 1 + S
  auto refill = [&](int f) {
    if (tid == 0 && f >= 1 && ct < tiles) {
      const int prev = (f - 1) % S;
      mbar_wait(&empty[prev], ((f - 1) / S) & 1);
      load(ct, cq, cs, prev);
      advance();
    }
  };
  if (tid == 0)
    for (int f = 0; f < S && ct < tiles; ++f) {
      load(ct, cq, cs, f);
      advance();
    }

  float acc[MT][NT][4];
  int f = 0;
  for (int tile = first; tile < tiles; tile = next_live(tile)) {
    const int R0 = tile / col_tiles * BM, n0 = tile % col_tiles * BN;
    for (int q = 0; q < kPasses; ++q) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      for (int s = 0; s < nslots; ++s, ++f) {
        const int slot = f % S;
        mbar_wait(&full[slot], (f / S) & 1);
        const int n = tiles_of(s);
        if constexpr (F::WG) {
          // per tile of the slot: the warpgroup's 64 rows and every tap
          // row, each k16 step from zero, then added in order
          const unsigned sa = smem_u32(smem_one + slot * F::kSlot);
          for (int u = 0; u < n; ++u) {
            const unsigned long long da = wgmma_desc(
                sa + u * F::kTileA + (warp >> 2) * 4096);
            const unsigned long long db =
                wgmma_desc(sa + F::kSlotA + u * F::kTileB);
            float d0[56], d1[56];
            wgmma_fence();
            wgmma_m64n112_zero(d0, da, db);
            wgmma_m64n112_zero(d1, da + 2, db + 2);  // 32 bytes on: step 1
            wgmma_commit_wait();
            wgmma_hold(d0);
            wgmma_hold(d1);
            if (u + 1 == n) {
              __syncwarp();
              if (lane == 0) mbar_arrive(&empty[slot]);
              refill(f);
            }
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[0][j][e] = acc[0][j][e] + d0[4 * j + e];
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[0][j][e] = acc[0][j][e] + d1[4 * j + e];
          }
        } else {
          static_assert(F::T == 1, "mma.sync: one tile a slot");
          const __nv_bfloat16* sa = reinterpret_cast<const __nv_bfloat16*>(
              smem_one + slot * F::kSlot);
          const __nv_bfloat16* sb = sa + F::kSlotA / 2;
          unsigned a[2][MT][4], b[NT][4];
#pragma unroll
          for (int k = 0; k < 2; ++k)
#pragma unroll
            for (int i = 0; i < MT; ++i) ldmatrix_x4(a[k][i], sa + a_at[k][i]);
#pragma unroll
          for (int j = 0; j < NT; ++j) ldmatrix_x4(b[j], sb + b_at[j]);
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[slot]);
          refill(f);
          // the slot's two k16 steps in order, each step's hi hi from zero
          // and then an FP32 add (the tensor cores truncate as they add)
#pragma unroll
          for (int k = 0; k < 2; ++k)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int i = 0; i < MT; ++i) {
                float th[4];
                mma_bf16_zero(th, a[k][i], b[j][2 * k], b[j][2 * k + 1]);
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] = acc[i][j][e] + th[e];
              }
        }
      }
      if constexpr (kFwd) {
        // the forward's epilogues, each output stored from the registers
        // and the park once it is final: 0. P_re, parked; 1. P_im = P_re +
        // the product; 2. P_v
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const int R = R0 + 16 * (MT * wm + i) + g + 8 * h;
              const int n = n0 + 8 * (NT * wn + j) + 2 * t;
              float* pk = park_at(i, j, 2 * h);
              const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
              if (q == 0) {
                pk[0] = v0;
                pk[F::kNT] = v1;
              }
              if (R >= rows || n >= cols) continue;
              if (q == 0) store2(p.P_re, R, n, v0, v1);
              else if (q == 1)
                store2(p.P_im, R, n, pk[0] + v0, pk[F::kNT] + v1);
              else store2(p.P_v, R, n, v0, v1);
            }
        continue;
      }
      if (q + 1 < kPasses) {
        // the adjoint's parks: 0. k1, 1. k1 + k2, 2. k1 - k3 over k1
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float* p0 = park_at(i, j, e);
              float* p1 = p0 + F::kPark / 4;
              const float v = acc[i][j][e];
              if (q == 0) *p0 = v;
              else if (q == 1) *p1 = *p0 + v;
              else *p0 = *p0 - v;
            }
        continue;
      }
      // the adjoint's last: cov = 1 / v, xmap_re = x + cov (k1 - k3),
      // xmap_im = cov (k1 + k2) for the rows of active trials; x comes in
      // first, every load before any store (a load after a store to memory
      // that may alias waits for it).  (Outputs stored at the epilogue that
      // makes them final, cov first, ran slower: PERF.md §6.)
      float2 xv[MT][2][NT];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int R = R0 + 16 * (MT * wm + i) + g + 8 * h;
            const int n = n0 + 8 * (NT * wn + j) + 2 * t;
            float2 x = make_float2(0.f, 0.f);
            if (R < rows && n < cols) {
              const float* xp = p.xm + static_cast<size_t>(R) * cols + n;
              if (n + 1 < cols && cols % 2 == 0) {
                x = *reinterpret_cast<const float2*>(xp);
              } else {
                x.x = xp[0];
                if (n + 1 < cols) x.y = xp[1];
              }
            }
            xv[i][h][j] = x;
          }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int R = R0 + 16 * (MT * wm + i) + g + 8 * h;
            const int n = n0 + 8 * (NT * wn + j) + 2 * t;
            if (R >= rows || n >= cols || !p.act[R / p.Lin]) continue;
            const float* p0 = park_at(i, j, 2 * h);
            const float* p1 = p0 + F::kPark / 4;
            const float c0 = 1.f / acc[i][j][2 * h];
            const float c1 = 1.f / acc[i][j][2 * h + 1];
            store2(p.xmap_re, R, n, xv[i][h][j].x + c0 * p0[0],
                   xv[i][h][j].y + c1 * p0[F::kNT]);
            store2(p.cov, R, n, c0, c1);
            store2(p.xmap_im, R, n, c0 * p1[0], c1 * p1[F::kNT]);
          }
    }
  }
}

// ---- 2. band fold, Onsager, freeze of z and u, adjoint inputs -------------
// One thread per y-side element (b, r, m).  Tap l of output row r reads
// column block c = r - l (tail truncation: 0 <= c < Lin); the adjoint input
// of (b, c, l Nr + m) comes from row r = c + l, so each is written once.
// kHigh: the HIGH form's fold (the gains are in the taps; the Onsager
// arithmetic of bamp.linear_step_high), which writes the adjoint inputs
// Z_re + Z_im (the Gauss operand of k1, summed in FP32), Z_re, Z_im and Z_c
// split into the adjoint's operand planes (zs_high, the split layout above,
// in the adjoint's product order), and zeros in their contraction pad (W <=
// w < 16 kas) of each row.  kOne: the DEFAULT form's fold, the same with
// the hi halves alone in split1_at's layout.
template <bool kHigh, bool kOne = false>
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
  // HIGH: adjoint input q of (row R, column w), split
  const size_t zplane = static_cast<size_t>(p.rtiles) *
                        (kOne ? p.kas / 2 : p.kas) * kHRows * 32;
  auto put = [&](int q, int R, int w, float v) {
    __nv_bfloat16* z = p.zs_high + q * zplane;
    if constexpr (kOne) {
      z[split1_at(p.kas, kHRows, R, w)] = __float2bfloat16_rn(v);
      return;
    }
    __nv_bfloat16 hi, lo;
    split1(v, hi, lo);
    z[split_at(p.kas, kHRows, R, w, 0)] = hi;
    z[split_at(p.kas, kHRows, R, w, 1)] = lo;
  };
  if (kHigh && r < p.Lin)
    for (int w = p.W + m; w < 16 * p.kas; w += p.Nr)
      for (int q = 0; q < 4; ++q) put(q, static_cast<int>(zrow) + r, w, 0.f);
  if (!on) {
    p.zn_re[e] = p.z_re[e];
    p.zn_im[e] = p.z_im[e];
    p.un[e] = p.u[e];
    for (int l = 0; l < p.Lh; ++l) {
      const int c = r - l;
      if (c < 0 || c >= p.Lin) continue;
      if (kHigh) {
        for (int q = 0; q < 4; ++q)
          put(q, static_cast<int>(zrow) + c, l * p.Nr + m, 0.f);
        continue;
      }
      const size_t q = (zrow + c) * Wp + l * p.Nr + m;
      p.Z_c[q] = p.Z_re[q] = p.Z_im[q] = 0.f;
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
      const int R = static_cast<int>(zrow) + c, w = l * p.Nr + m;
      put(0, R, w, rr + ri);
      put(1, R, w, rr);
      put(2, R, w, ri);
      put(3, R, w, ui);
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

// One element a lane, K = 1 (the massive geometry: M = G = 16, OOK): the
// posterior of element j, whose cov, x and old variance are c, xj and old,
// in group_posterior's operations and order below, each of them once (its
// loops, with M and G unknown to the compiler, compute an element's t
// three times and its exponential twice).  Returns 1 where the variance
// leaves the allclose tolerance.
template <class Put>
__device__ __forceinline__ int lane_posterior(int j, float c, float xj,
                                              float old, int G, unsigned mask,
                                              const float* sr,
                                              const float* si, float* xo,
                                              float* vn, Put put) {
  const float tau = c / 2.f;
  const float tv = xj / tau * sr[0];
  float mx = fmaxf(-INFINITY, tv);
  for (int off = G / 2; off >= 1; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(mask, mx, off, G));
  const float e = expf(fminf(tv - mx, kExpMax));
  float sum = ((0.f + e) + 0.f) + 0.f + 0.f;
  for (int off = G / 2; off >= 1; off >>= 1)
    sum = sum + __shfl_down_sync(mask, sum, off, G);
  const float eta2 = __shfl_sync(mask, sum, 0, G);
  const float post = e / eta2;
  const float mr = sr[0] * post, mi = si[0] * post;
  const float v =
      abs2(mr, mi) * (1.f - post) + abs2(mr - sr[0], mi - si[0]) * post;
  xo[j] = mr;
  vn[j] = v;
  put(j, mr, v);
  return !(fabsf(v - old) <= kAtol + kRtol * fabsf(old));
}

// The posterior of segment j0 .. j0+M-1 computed by the G lanes of one
// group (lane t, mask the group's lanes), in segment_posterior's
// arithmetic for a real posterior mean (halve_tau, decomposed variance):
// the segment max and the sum of eta over the segment joined through
// shuffles, lane t folding its elements t, t+G, ... into accumulator s % 4
// for its s-th element (lane_sum's order; G is torch_sum's lane count), the
// lanes joined in torch_sum's tree; then the mean and variance of the
// lane's elements, stored to xo and vn and, where given, split by put(j,
// mean, variance).  Returns the lane's count of variance entries outside
// the allclose tolerance of var.
template <class Put>
__device__ __forceinline__ int group_posterior(
    int j0, int M, int G, int t, unsigned mask, int K, const float* sr,
    const float* si, const float* cov, const float* x, const float* var,
    float* xo, float* vn, Put put) {
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
    put(j, mr, v);
  }
  return bad;
}

// Block (b, y) takes kSegRounds lane groups' worth of segments of trial b
// from segment y (kThreads / G) kSegRounds on; a frozen trial's elements
// pass through.  Where xs_next is given, the new x and var also go split
// into it (HIGH: split_at's layout, hi and lo; DEFAULT: split1_at's, hi
// alone).
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
  // element j of the trial's new x and var, split into the next call's
  // forward operand planes (xs_next: the split launch's layout)
  const size_t xplane = static_cast<size_t>(p.rtiles) *
                        (p.one ? p.kxs / 2 : p.kxs) * kHRows * 32;
  const int R0 = b * p.Lin;
  auto put = [&](int j, float xv, float vv) {
    if (p.xs_next == nullptr) return;
    const int R = R0 + j / p.Nt, k = j % p.Nt;
    if (p.one) {
      const size_t at = split1_at(p.kxs, kHRows, R, k);
      p.xs_next[at] = __float2bfloat16_rn(xv);
      p.xs_next[xplane + at] = __float2bfloat16_rn(vv);
      return;
    }
    const size_t hi_at = split_at(p.kxs, kHRows, R, k, 0);
    const size_t lo_at = split_at(p.kxs, kHRows, R, k, 1);
    __nv_bfloat16 h, l;
    split1(xv, h, l);
    p.xs_next[hi_at] = h;
    p.xs_next[lo_at] = l;
    split1(vv, h, l);
    p.xs_next[xplane + hi_at] = h;
    p.xs_next[xplane + lo_at] = l;
  };
  if (p.xs_next != nullptr && blockIdx.y == 0) {
    // the contraction pad of the trial's rows, zero in both planes
    const int pad = 16 * p.kxs - p.Nt;
    for (int e = tid; e < p.Lin * pad; e += kThreads) {
      const int R = R0 + e / pad, k = p.Nt + e % pad;
      if (p.one) {
        const size_t at = split1_at(p.kxs, kHRows, R, k);
        p.xs_next[at] = p.xs_next[xplane + at] = __float2bfloat16_rn(0.f);
        continue;
      }
      for (int h = 0; h < 2; ++h) {
        const size_t at = split_at(p.kxs, kHRows, R, k, h);
        p.xs_next[at] = p.xs_next[xplane + at] = __float2bfloat16_rn(0.f);
      }
    }
  }
  if (!p.act[b]) {
    const float* xi = p.xm + base;
    for (int j = s0 * M + tid; j < s1 * M; j += kThreads) {
      xo[j] = xi[j];
      vn[j] = vo[j];
      put(j, xi[j], vo[j]);
    }
    return;
  }
  const int t = tid & (G - 1);
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1) << ((tid & 31) & ~(G - 1));
  int bad = 0;
  if (M == G && p.K == 1) {
    // a lane's element of each of its group's rounds, every round's loads
    // first
    const float* cv = p.cov + base;
    const float* xv = p.xmap_re + base;
    const int s = s0 + tid / G, ds = kThreads / G;
    float c[kSegRounds], xj[kSegRounds], old[kSegRounds];
#pragma unroll
    for (int r = 0; r < kSegRounds; ++r)
      if (s + r * ds < s1) {
        const int j = (s + r * ds) * M + t;
        c[r] = cv[j];
        xj[r] = xv[j];
        old[r] = vo[j];
      }
#pragma unroll
    for (int r = 0; r < kSegRounds; ++r)
      if (s + r * ds < s1)
        bad += lane_posterior((s + r * ds) * M + t, c[r], xj[r], old[r], G,
                              mask, p.sym_re, p.sym_im, xo, vn, put);
  } else {
    for (int s = s0 + tid / G; s < s1; s += kThreads / G)
      bad += group_posterior(s * M, M, G, t, mask, p.K, p.sym_re, p.sym_im,
                             p.cov + base, p.xmap_re + base, vo, xo, vn,
                             put);
  }
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
  return launch_tiles<kFwd, F::BM, F::BN, F::kNT, F::smem(kFwd)>(
      high_product_kernel<kFwd, F>, p, s);
}

// The DEFAULT form's product kernel: as many persistent blocks as the card
// keeps at once, at most one per tile.
template <bool kFwd, class F>
cudaError_t launch_default(const Params& p, cudaStream_t s) {
  auto kernel = default_product_kernel<kFwd, F>;
  constexpr int smem = F::smem(kFwd);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, F::kNT, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long rows = static_cast<long long>(p.B) * p.Lin;
  const int cols = kFwd ? p.Wp : p.Nt;
  const long long tiles = (rows + F::BM - 1) / F::BM *
                          ((cols + F::BN - 1) / F::BN);
  const long long blocks =
      tiles < static_cast<long long>(sms) * per_sm ? tiles
                                                   : static_cast<long long>(
                                                         sms) * per_sm;
  kernel<<<static_cast<unsigned>(blocks), F::kNT, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Enqueue one iteration of B trials on `stream`: the launches of the stages
// in `stages` (bits 16 split (HIGH only), 1 forward, 2 fold, 4 adjoint, 8
// denoiser; 15 for an iteration, with 16 at HIGH unless the denoiser of the
// previous call split x and var), in order, each product in its large form
// or, where its bit of `forms` is set (1 forward, 2 adjoint), its small
// form.  Wp is the row stride of the six scratch planes (B Lin, Wp): at
// least Lh Nr and a multiple of 4.  With `high` 1 the HIGH form runs (split,
// products and fold) on the split Gauss taps `taps_high` and the split
// operand planes `xs_high` (2 rtiles 2 ceil(Nt / 32) kHRows 32 bf16) and
// `zs_high` (4 rtiles 2 ceil(Lh Nr / 32) kHRows 32 bf16), all 16-byte
// aligned (Params), and h_re .. gains2 and the scratch planes Z_c .. Z_im
// are not read; where `xs_next` (the size of xs_high) is not null, the
// denoiser also writes the new x and var split into it, so that the next
// call on them may leave out its split (stage bit 16).  With `high` 2 the
// DEFAULT form runs: the same with one bf16 pass in each product, on its
// own engine, with taps_high, xs_high (2 rtiles ceil(Nt / 32) kHRows 32
// bf16), zs_high (4 rtiles ceil(Lh Nr / 32) kHRows 32) and xs_next in
// split1_at's hi-only layout.
// Returns a cudaError_t code (0 on
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
    void* xs_high, void* zs_high, void* xs_next, void* stream) {
  if (B < 1 || Nt < 1 || Nr < 1 || Lin < 1 || Lh < 1 || M < 1 ||
      Nt % M != 0 || K < 1 || K > kMaxK || Wp < Lh * Nr || Wp % 4 != 0 ||
      static_cast<long long>(B) * Lin >= (1ll << 31) ||
      static_cast<long long>(B) * (Lin + Lh - 1) * Nr >= (1ll << 31) ||
      high < 0 || high > 2 ||
      (high && (taps_high == nullptr || xs_high == nullptr ||
                zs_high == nullptr ||
                (reinterpret_cast<uintptr_t>(taps_high) |
                 reinterpret_cast<uintptr_t>(xs_high) |
                 reinterpret_cast<uintptr_t>(zs_high)) % 16 != 0)))
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
  p.xs_high = static_cast<__nv_bfloat16*>(xs_high);
  p.zs_high = static_cast<__nv_bfloat16*>(zs_high);
  p.xs_next = high ? static_cast<__nv_bfloat16*>(xs_next) : nullptr;
  p.one = high == 2;
  p.kxs = (Nt + 16 * kSlotSteps - 1) / (16 * kSlotSteps) * kSlotSteps;
  p.kas = (p.W + 16 * kSlotSteps - 1) / (16 * kSlotSteps) * kSlotSteps;
  p.rtiles = static_cast<int>((static_cast<long long>(B) * Lin + kHRows - 1) /
                              kHRows);
  p.ctf = (p.W + kHCols - 1) / kHCols;
  p.cta = (Nt + kHCols - 1) / kHCols;
  p.sigma2 = sigma2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  const bool one = high == 2;
  if (high && (stages & kStageSplit)) {
    const long long n = 2LL * p.rtiles * (one ? p.kxs / 2 : p.kxs) * kHRows;
    const unsigned blocks =
        static_cast<unsigned>((n + kThreads - 1) / kThreads);
    if (one)
      split_kernel<true><<<blocks, kThreads, 0, s>>>(p);
    else
      split_kernel<false><<<blocks, kThreads, 0, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (stages & kStageForward) {
    if (one)
      err = forms & kSmallForward ? launch_default<true, DefaultSmall>(p, s)
                                  : launch_default<true, DefaultLarge>(p, s);
    else if (high)
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
    if (one)
      fold_kernel<true, true><<<blocks, kThreads, 0, s>>>(p);
    else if (high)
      fold_kernel<true><<<blocks, kThreads, 0, s>>>(p);
    else
      fold_kernel<false><<<blocks, kThreads, 0, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

  }
  if (stages & kStageAdjoint) {
    if (one)
      err = forms & kSmallAdjoint ? launch_default<false, DefaultSmall>(p, s)
                                  : launch_default<false,
                                                   DefaultLargeAdjoint>(p, s);
    else if (high)
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
// the adjoint) in its small or large form, of the HIGH form when `high` is
// 1, of the DEFAULT form when it is 2, in bytes.
int fused_bamp_tiled_smem(int forward, int small, int high) {
  if (high == 2)
    return small ? DefaultSmall::smem(forward != 0)
                 : forward ? DefaultLarge::smem(true)
                           : DefaultLargeAdjoint::smem(false);
  if (high)
    return small ? HighSmall::smem(forward != 0)
                 : HighLarge::smem(forward != 0);
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
