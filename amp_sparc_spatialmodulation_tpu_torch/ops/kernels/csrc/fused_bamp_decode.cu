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
// compute against ~19 ns per trial of memory.  What keeps a kernel of this
// shape from that bound is not the FMAs but the loads that feed them: a
// thread that computes one output issues a tap load and an x load from L1
// or shared memory for every one to three FMAs, and the load pipe (one
// warp-wide access per clock per SM) saturates at a tenth of the FMA rate.
//
// Register tiles over the block-Toeplitz taps.  The channel is
// block-Toeplitz: tap l couples source block c to row block c + l, the
// same Nr x Nt matrix h[l] for every c, with a scalar gain per (l, c)
// applied after the product.  So each pass is Lh small GEMMs that share
// their right operand across the Lin blocks:
//
// * forward: P[c, l, m] = sum_k x[c, k] h[l, m, k] (and |h|^2 var) for
//   every (c, l, m).  A thread owns one column (l, m) and kFR source blocks
//   c: per k it loads the tap once and uses it for kFR rows, and it loads
//   x[c, k..k+3] as one 16-byte word of shared memory (the same address
//   across the warp, a broadcast);
// * fold: the row sums y[r, m] = sum_l g[l, r-l] P[r-l, l, m], Onsager and
//   u' per output; the same thread then writes the gain-weighted adjoint
//   inputs Z[c, l, m] = g[l, c] (y - z') / u' into the slots of the P it
//   has just read (every (c, l, m) belongs to exactly one output), so P
//   and Z share one scratch area;
// * adjoint: a thread owns one x element k of kAR column blocks c: per
//   antenna m it loads the tap h[l, m, k] once for kAR rows and Z[c, l,
//   m..m+3] as one broadcast word;
// * denoiser: a segment of M lanes is posterior'd by a group of as many
//   lanes as PyTorch's reduction uses for its segment sum (16 at M = 16),
//   the sums joined by warp shuffles in PyTorch's order, with every
//   per-lane array indexed statically so it stays in registers.
//
// The x-side pseudo-data's imaginary part goes straight to the output
// (only the denoisers of complex alphabets and of random mode read it
// back), which puts the flagship block at 68,800 B of shared memory:
// three blocks per SM, which holds each thread to 80 registers.  The tile
// sizes are the largest that stay near that limit: at Lin = 20, kFR = 7
// gives three row groups (216 of 256 threads carry a forward tile) and kAR
// = 5 four (two full rounds of adjoint tiles); 10 x 10 spilled more and
// ran 12% slower (PERF.md, tests/torch_k1_passes.py --tiles).
//
// Rounding.  The stop test compares the posterior variance at rtol=1e-5,
// and a converged variance of a decided lane is 1 - p with p = eta/eta2
// one ulp-step below 1, so a trial's T depends on the last bit of the
// segment sums.  The kernel therefore rounds where the plain PyTorch
// version (decode_plain in fused_bamp.py) rounds: it is built with
// -fmad=false, so every elementwise expression rounds after each operation
// as PyTorch's separate elementwise kernels do; each banded product is one
// sequential FMA chain over the contraction index (real part before
// imaginary part in a complex product), the order cuBLAS's FP32 GEMMs
// take at the decode's batch sizes.  The tiles change which thread
// computes an output, never the order of its sum: the forward chain of
// each (c, l, m) runs over k = 0..Nt-1 from zero and the taps are added to
// a row in the order l = 0..Lh-1 after their gains; the adjoint chain of
// each (c, k) runs over (l, m) in order, and a tap that places no block
// (trunc) contributes exact zeros, as in the plain version's zero-filled
// input.  Every sum over a segment or the symbol table follows the order
// of PyTorch's CUDA reduction over a contiguous innermost dimension
// (lane_sum in decode_common.cuh).  The kernel's state then matches the
// plain version's bit for bit, which chip_smoke.py checks on the card.
//
// Layouts: every state vector is per-trial contiguous, complex values
// interleaved (PyTorch complex64): x-side (B, Lin*Nt), y-side (B, Lout*Nr).
// Taps come as h (Lh, Nr, Nt) for the adjoint and hT (Lh, Nt, Nr) for the
// forward, so neighbouring threads read neighbouring addresses in both;
// gains are (Lh, Lin) per (tap, column block), taken as they come.
//
// The HIGH form (template kHigh; precision='high', the JAX kernel's
// _linear_iteration with make_dot(Precision.HIGH) = dot3, fused_bamp.py:
// 144-352) computes another function, that of bamp.plain_loop_high: the
// per-tap gains folded into the tap planes where every column block shares
// them (else applied after the products, as above), the Gauss complex
// products k1 = (a + b) S_re, k2 = a (Im S - Re S), k3 = b (Re S + Im S)
// (k1 = a S_re for a real x) and the adjoint's on A + B, A, B, the
// Onsager step as w = v / u, z' = hx - w (y - z), cov = 1 / dot3(Zc,
// S_a2^T).  Each of its 7 real products per iteration (8 for a complex x)
// is three bf16 passes on the tensor cores (mma.sync m16n8k16, FP32
// accumulation: hi hi, then hi lo + lo hi in a second accumulator, joined
// once).  Per trial the products are small: forward M = Lin = 20-25, K =
// Nt = 128, N = Lh*Nr = 72-192.  They run transposed, the taps as the A
// operand (M = Lh*Nr, resp. Nt for the adjoint, in 16-row tiles; 72 pads to
// 80, a tenth wasted) and the trial's Lin column blocks as the N side
// (n8 tiles, 20 pads to 24), so that no m16 tile idles a third of its rows
// as M = Lin would.  A warp runs units of a pass: a 16-row tile, cut into
// ranges of its n8 tiles where the block has more warps than tiles (the
// QPSK flagship's adjoint: 8 tiles, 16 warps, two units a tile), each
// unit's Gauss products one after another (k1 parked in the slot of the
// output it combines into).  A k16 step loads the lanes' tap fragments
// (pre-split by the wrapper and laid out as the fragments: two 16-byte
// loads per lane, from L2) and their B words, then issues the hi hi mma of
// every n8 tile before the hi lo and the lo hi ones, so that four
// independent accumulations lie between two dependent mma; its addresses
// are set up once per unit and product.  The trial side is split into bf16
// hi and lo once, in shared memory, by the pass that writes it: the
// denoiser writes var, xm_re (and xm_re + xm_im, xm_im) split beside its
// FP32 state, the fold writes the adjoint's four inputs only split.  The
// forward's split operands and the adjoint's share one region (each is
// dead while the other lives), with row strides of 4 mod 8 words so that a
// fragment's eight rows hit distinct banks; the pad columns are rewritten
// as zeros by the pass that writes the region.  At the QPSK flagship that
// region is 80,000 B and the block 220,800 B, the one block an SM holds,
// so the block runs 16 warps; at the OOK flagship 28,160 B and 96,960 B,
// two blocks of 8 warps per SM (128 registers a thread either way;
// fused_bamp.py::high_threads).  The HIGH instances' denoiser is the
// HIGHEST one's arithmetic with the alphabet's size fixed at compile time
// for OOK and QPSK (the flagships').  Its bound is the tensor cores' (3
// passes x 2 Lin Nt Lh Nr flop per real product at 989 TFLOP/s, about 0.1
// us per OOK trial-iteration), far below the tap fragments' L2 stream
// (about 0.29 MB per trial-iteration at the OOK flagship) and the passes
// the precision does not change.  What holds it back was measured on an
// H100 (PERF.md, tests/torch_k1_passes.py --precision high): latency, with
// 8 warps to hide it at the QPSK flagship (the denoiser 45% of the time,
// the forward products 29%, the adjoint's 16%, the fold 9%, the tap
// fragments' loads 7%), then, with 16 warps, the mma's own rate (about
// 35% of the time at either flagship), the products' other instructions,
// and the denoiser (about 30%).  The HIGHEST
// instance (kHigh false) is the code above, unchanged.
//
// The HIGH layout takes a trial of any number of column blocks: a unit of
// a pass spans at most kMaxNT = 4 n8 tiles (32 column blocks), so a
// 16-row tile of a wider trial takes as many units as it needs
// (high_parts), each indexing its tiles from its first; up to 32 column
// blocks the units are the earlier ones.
//
// The DEFAULT form (kOne; precision='default', the JAX kernel with
// make_dot(Precision.DEFAULT), one bf16 pass, fused_bamp.py:58-59 and
// 81-93 there) is the HIGH form with one pass on the hi halves alone: each
// product issues only the hi hi mma, its tap fragments are 16 bytes a lane
// and k16 step (fused_bamp.py::default_taps), its split operands hi planes
// only (Form::kParts = 1), so its region is half the HIGH form's (180,800
// B a block at the QPSK flagship, 82,880 B at the OOK one: neither gains
// a block per SM, and it runs the HIGH form's threads); its plain version
// is bamp.plain_loop_default.  Measured on an H100 (PERF.md,
// tests/torch_k1_passes.py --precision default), what bounds it is the
// denoiser (about a third of the time: a chain of shuffles, divisions and
// exponentials per segment, latency-bound) and the mma's issue and
// latency in both products, not the tap stream (held in registers, the
// taps gain nothing).  So every form on the HIGH layout runs the
// denoiser two segments a round where a lane holds one element
// (pair_posterior: 7 rounds become 4 at the QPSK flagship, 10 become 5 at
// the OOK one), the same arithmetic per segment.
//
// The split forms (AMP_KERNEL_XMAP_PRECISION; the JAX kernel's
// _linear_iteration with dot = make_dot(precision) for the variance chain
// and dot_x = make_dot(x_precision) for the xmap chain, fused_bamp.py:
// 158-162, 184-185 there) compute the HIGH form's function with each
// chain's products at its own precision: the variance chain is Pv =
// dot(var, S_a2) and cov = 1 / dot(Zc, S_a2^T), which feed the stop test;
// the xmap chain the forward's and the adjoint's Gauss products.  Template
// <kVP, kXP> of the kernel: each chain's products take 3 or 1 bf16 mma
// passes (high_pass<kOne> per chain, the xmap chain's products q = 1.. in
// a second pass over the same units, so each element stays with its lane)
// or, at 'highest', FP32 FMA chains on the CUDA cores (fp32_pass: register
// tiles of 3-5 rows x 2 or 4 columns a thread, the products in turn,
// on the FP32 tap planes fused_bamp.py::fp32_taps staged panel by panel
// through shared memory by cp.async, into the split planes that chain
// leaves dead; the x side from the FP32 state, xm_re + xm_im and A + B
// formed once a pass).  The fold writes an FP32 chain's adjoint inputs
// (Zc, or A and B) in FP32 into the scratch slots it has just read, as the
// HIGHEST form does, so a split form's block is the HIGH form's: 96,960 B
// at the OOK flagship, 220,800 B at the QPSK one.  A form whose bf16 chain
// is 'default' reads default_taps and splits hi halves only.  In the two
// mixed forms <3, 1> and <1, 3> (one chain at 'high', the other at
// 'default') each chain keeps its own layout: the three-pass chain's
// operands hi and lo, on high_taps; the one-pass chain's hi alone, on
// default_taps (Params::taps1), 16 contiguous bytes a lane and k16 step
// (Form::kVParts, kXParts, plane_of, taps_of); the region holds only the
// planes the chains read (190,800 and 210,800 B a block at the QPSK
// flagship, 86,400 and 93,440 B at the OOK one, each still the HIGH
// form's blocks per SM).  The adjoint
// runs the variance chain first and the xmap chain after a barrier, since
// the xmap epilogue reads cov.  The six off-diagonal (variance, xmap)
// pairs are one instance each, compiled for 16 warps and launched with the
// HIGH form's 8 or 16; plain version bamp.plain_loop_split.  Measured on
// an H100 (PERF.md, tests/torch_k1_passes.py --xmap-precision), an FP32
// chain still bounds its form at about a quarter of the FP32 peak, held
// back neither by its loads, its barriers nor its tap stream from L2
// (cutting each gains little); what does hold it is not measured yet.
//
// Every form also runs as a thread-block cluster of 2, 4 or 8 blocks a
// trial, where one block's shared memory holds no trial (the cluster form,
// below Params: each block its own column blocks, the fold across blocks
// through distributed shared memory; the same bits as one block).  It is
// this source built with K1_CLUSTER set (fused_bamp_cluster.cu), into a
// library of its own: the one-block instances here compile without the
// cluster's fold, barriers and block spans, so their registers and times
// stay those of one block (with the cluster code in the same instances
// their spills grew and the split forms ran up to 13% slower), and both
// libraries build side by side.

#include <cuda_bf16.h>

#include <type_traits>

#include "decode_common.cuh"

#ifndef K1_CLUSTER
#define K1_CLUSTER 0
#endif

namespace {

using namespace decode;

constexpr int kThreads = 256;
constexpr int kFR = 7;  // forward: source blocks per thread
constexpr int kAR = 5;  // adjoint: column blocks per thread
constexpr float kZeroTol = 1e-9f;
constexpr int kMaxNT = 4;  // HIGH layout: n8 tiles a unit of a pass spans
// HIGH form's blocks (fused_bamp.py::high_threads picks one): 16 warps
// where one block fills an SM's shared memory, else 8 warps, two blocks per
// SM; 128 registers a thread either way.
constexpr int kHighThreads1 = 512;
constexpr int kHighThreads2 = 256;

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
  // every form but HIGHEST: the eight Gauss tap planes as mma A fragments
  // (fused_bamp.py::high_taps, or default_taps where no chain runs three
  // passes), and whether the gains are folded in
  const uint4* taps;
  int folded;
  // split forms with a chain at HIGHEST only: the eight Gauss tap planes in
  // FP32 (fused_bamp.py::fp32_taps)
  const float* taps32;
  // the mixed forms <3, 1> and <1, 3> only: the one-pass chain's tap
  // fragments, hi alone (fused_bamp.py::default_taps)
  const uint4* taps1;
  // blocks a trial (1, or the cluster's 2, 4 or 8) and the dynamic shared
  // memory of each block, whose last kFlagInts ints hold a cluster's stop
  // flags
  int ctas, smem;
};

// The cluster form.  Where one block's shared memory holds no trial
// (fused_bamp.py::cluster_plan), a trial runs on a thread-block cluster of
// ctas blocks: block i holds column blocks c0 .. c0 + nc - 1 (c0 = i Lin /
// ctas) and the output row blocks of the same numbers (the last block also
// those past Lin), each laid out as a one-block trial of lc column and rc
// output row blocks (the last block's, the largest), so that a slot lies
// at the same offset in every block.  The forward products, the adjoint
// and the denoiser of a column block are the block's own; only the fold
// crosses blocks: row r reads P[r - l, l, m] and writes the adjoint inputs
// of (r - l, l, m), in the block that holds column block r - l, through
// distributed shared memory (map_rank), its taps in the order l = 0 ..
// Lh - 1 as in one block.  Cluster barriers stand before and after the
// fold (every block's forward done before any fold reads it, every fold
// done before any adjoint reads its inputs) and at the stop test, an OR
// of the blocks' flags written into every block.  No partition changes
// the order of any sum, so the cluster form gives the one-block form's
// state and T bit for bit (chip_smoke.py, kernel_cluster_bamp).
constexpr bool kCluster = K1_CLUSTER != 0;
constexpr int kFlagInts = 8;  // fused_bamp.py::CLUSTER_FLAG_BYTES / 4

struct Span {
  int c0, nc;  // column blocks c0 .. c0 + nc - 1
  int r0, nr;  // output row blocks r0 .. r0 + nr - 1
  int lc, rc;  // column and output row blocks of the carve
  int rank;    // the block's rank in its cluster
};

// This block's span (fused_bamp.py::cluster_ranges; blocks of a cluster
// are consecutive in x, a trial b = blockIdx.x / ctas); one block:
// everything.
__device__ __forceinline__ Span block_span(const Params& p) {
  if constexpr (!kCluster) return {0, p.Lin, 0, p.Lout, p.Lin, p.Lout, 0};
  const int C = p.ctas;
  const int rank = blockIdx.x % C;
  const int c0 = rank * p.Lin / C, c1 = (rank + 1) * p.Lin / C;
  const int lc = (p.Lin + C - 1) / C;
  return {c0, c1 - c0, c0, (rank == C - 1 ? p.Lout : c1) - c0, lc,
          lc + p.Lout - p.Lin, rank};
}

// The block of the cluster that holds column block c, and c's index there.
__device__ __forceinline__ int owner_of(const Params& p, int c, int& local) {
  const int rank = ((c + 1) * p.ctas - 1) / p.Lin;
  local = c - rank * p.Lin / p.ctas;
  return rank;
}

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

// Forward products.

// One step k of the chains of one (c, l, m): |h|^2 var and h x.
template <bool kReal>
__device__ __forceinline__ void fwd_step(float& pv, float& pr, float& pi,
                                         float x, float xj, float v,
                                         float2 hv, float a) {
  pv = fmaf(v, a, pv);
  pr = fmaf(x, hv.x, pr);
  if (!kReal) pr = fmaf(-xj, hv.y, pr);
  pi = fmaf(x, hv.y, pi);
  if (!kReal) pi = fmaf(xj, hv.x, pi);
}

// The products of column (l, m) of the tap stack with the block's source
// blocks c0 .. c0+kFR-1, written to P[c, l, m] (the rows past the block's
// repeat its last one and are dropped, as are the blocks tap l places
// nowhere).
template <bool kVec, bool kReal>
__device__ __forceinline__ void forward_tile(
    const Params& p, const Span& sp, int c0, int l, int m,
    const float* xm_re, const float* xm_im, const float* var, float* Pv,
    float* Pr, float* Pi, int NrP) {
  const size_t tap = static_cast<size_t>(l) * p.Nt * p.Nr + m;
  const float2* ht = p.hT + tap;
  const float* at = p.a2T + tap;
  int row[kFR];
#pragma unroll
  for (int i = 0; i < kFR; ++i) row[i] = min(c0 + i, sp.nc - 1) * p.Nt;
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
      const float4 xj =
          kReal ? make_float4(0.f, 0.f, 0.f, 0.f)
                : load4<kVec>(xm_im + row[i] + k);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        fwd_step<kReal>(pv[i], pr[i], pi[i], lane4(x, q), lane4(xj, q),
                        lane4(v, q), hv[q], a[q]);
    }
  }
  for (; k < p.Nt; ++k) {
    const float2 hv = __ldg(ht + k * p.Nr);
    const float a = __ldg(at + k * p.Nr);
#pragma unroll
    for (int i = 0; i < kFR; ++i)
      fwd_step<kReal>(pv[i], pr[i], pi[i], xm_re[row[i] + k],
                      kReal ? 0.f : xm_im[row[i] + k], var[row[i] + k], hv,
                      a);
  }
#pragma unroll
  for (int i = 0; i < kFR; ++i) {
    const int c = c0 + i;
    if (c < sp.nc && dst_block(sp.c0 + c, l, p) >= 0) {
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

// The adjoint of x element k of the block's column blocks c0 ..
// c0+kAR-1 (nc of them): cov and the pseudo-data xmap (its imaginary part
// to xmap_g, stride 2).
__device__ __forceinline__ void adjoint_tile(
    const Params& p, int nc, int c0, int k, const float* Zc, const float* Zr,
    const float* Zi, int NrP, const float* xm_re, const float* xm_im,
    float* xmap_re, float* xmap_g, float* cov, bool real_x) {
  int zrow[kAR];
#pragma unroll
  for (int i = 0; i < kAR; ++i)
    zrow[i] = min(c0 + i, nc - 1) * p.Lh * NrP;
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
    if (c < nc) {
      const int j = c * p.Nt + k;
      const float cv = 1.f / cs[i];
      cov[j] = cv;
      xmap_re[j] = xm_re[j] + cv * ar[i];
      xmap_g[2 * j + 1] = real_x ? cv * ai[i] : xm_im[j] + cv * ai[i];
    }
  }
}

// The HIGH form's pieces.

// An instance on the HIGH layout (kVP, kXP: the passes of the variance and
// of the xmap chain, 3 or 1 bf16 passes on the tensor cores, 0 FP32 on the
// CUDA cores): the planes of each split operand and the 16-byte tap words
// a lane reads per k16 step for each chain, and the x-side operands the
// denoiser splits (kMask bit 0 var, bit 1 the xmap chain's; an FP32
// chain's are not).  kParts: 2 (hi and lo) where a chain runs three
// passes, else 1 (hi alone).  Where both chains run on the tensor cores,
// each chain's operands have its own planes (kVParts for operand 0, the
// variance chain's, kXParts for operands 1..3, the xmap chain's) and its
// chain reads its own tap words (kVParts or kXParts: 2 from
// fused_bamp.py::high_taps, 1 from default_taps, the one-pass chain of a
// mixed form <3, 1> or <1, 3> from Params::taps1); a form with an FP32
// chain keeps kParts planes for every operand (the dead ones hold that
// chain's staged taps) and kParts words.
template <int kVP, int kXP>
struct Form {
  static constexpr int kParts = kVP == 3 || kXP == 3 ? 2 : 1;
  static constexpr int kWords = kParts;
  static constexpr int kMask = (kVP != 0 ? 1 : 0) | (kXP != 0 ? 2 : 0);
  static constexpr bool kMixed = kVP != 0 && kXP != 0 && kVP != kXP;
  static constexpr int kVParts = kMixed ? (kVP == 3 ? 2 : 1) : kParts;
  static constexpr int kXParts = kMixed ? (kXP == 3 ? 2 : 1) : kParts;
  // the first plane of operand o, and its planes
  __host__ __device__ static constexpr int plane_of(int o) {
    return o == 0 ? 0 : kVParts + (o - 1) * kXParts;
  }
  __host__ __device__ static constexpr int parts_of(int o) {
    return o == 0 ? kVParts : kXParts;
  }
  // the tap fragments of the variance chain (v) or of the xmap chain
  __device__ static const uint4* taps_of(const Params& p, bool v) {
    return kMixed && (v ? kVParts : kXParts) == 1 ? p.taps1 : p.taps;
  }
};

// The HIGH layout's split operands in shared memory: plane part (part 0
// hi, 1 lo) of operand o is (Lin, ld) bf16 at base + (F::plane_of(o) +
// part) Lin ld, F a Form (its parts per operand).  The forward's x side: o
// = 0 var, 1 xm_re, and for a complex alphabet 2 xm_re + xm_im, 3 xm_im
// (ld = ldx); the adjoint's inputs, in the same place: o = 0 Zc, 1 A + B,
// 2 A, 3 B (ld = ldz).  An operand that only an FP32 chain reads is never
// split: its planes, and the region past the last operand, hold that
// chain's staged taps (split_end).
struct Split {
  __nv_bfloat16* base;
  int Nt, ld, plane;  // plane = Lin * ld
  template <class F>
  __device__ __forceinline__ __nv_bfloat16* at(int o, int part) const {
    return base + (F::plane_of(o) + part) * plane;
  }
  // Operand o of element off, as precision.split_bf16 computes it: hi (x
  // rounded to nearest even) and, where the operand has two planes, lo =
  // x - hi rounded.
  template <class F>
  __device__ __forceinline__ void put(int o, int off, float x) const {
    __nv_bfloat16* hi = base + F::plane_of(o) * plane + off;
    const __nv_bfloat16 h = __float2bfloat16_rn(x);
    *hi = h;
    if (F::parts_of(o) == 2)
      hi[plane] = __float2bfloat16_rn(x - __bfloat162float(h));
  }
  // The x side of element j = c Nt + k, as the denoiser writes it: var
  // where kMask has bit 0 (the variance chain on the tensor cores), the
  // xmap chain's operands where it has bit 1.
  template <int kMask, class F>
  __device__ __forceinline__ void store_x(int j, float mr, float mi,
                                          float vn, bool real_x) const {
    const int c = j / Nt;
    const int off = c * ld + (j - c * Nt);
    if (kMask & 1) put<F>(0, off, vn);
    if (kMask & 2) {
      put<F>(1, off, mr);
      if (!real_x) {
        put<F>(2, off, mr + mi);
        put<F>(3, off, mi);
      }
    }
  }
};

// d += a b for one m16n8k16 tile: a the 16 x 16 row-major fragment, (b0,
// b1) the 16 x 8 column fragment, d FP32 (a copy of vamp_common.cuh's).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A lane's tap fragment of one k16 step of a 16-row tile: its 8 hi then 8
// lo bf16 (fused_bamp.py::mma_tiles), from L2.
__device__ __forceinline__ void tap_load(uint4 (&f)[2], const uint4* p) {
  f[0] = __ldg(p);
  f[1] = __ldg(p + 1);
}

// Units of a pass of the HIGH products: each 16-row tile of the tap stack
// cut into `parts` ranges of its NT n8 tiles, as many as the block has
// warps per tile, and at least as many as keep each range within kMaxNT
// tiles (a trial of more than 8 kMaxNT column blocks); tests/
// test_torch_k1_high_tiles.py mirrors it.
__device__ __forceinline__ int high_parts(int mtiles, int warps, int NT) {
  const int s = warps / mtiles;
  const int parts = s < 1 ? 1 : (s > NT ? NT : s);
  const int least = (NT + kMaxNT - 1) / kMaxNT;
  return parts < least ? least : parts;
}

// One pass of the HIGH form's products under dot3: Gauss products q0 ..
// nq-1 of the 16-row tiles of one stack of tap planes (plane q at taps + q
// plane, ks k16 steps), product q on the split operand whose hi plane is
// operand(q) (its lo plane lo bf16 further; row c of the N side at c ld,
// rows past nrows - 1 read row nrows - 1 and are dropped).  Warp w runs
// units w, w + warps, ... (tile mt, n8 tiles n0 .. n1-1, at most kMaxNT),
// each unit's products one after another: out[i][e] = (A_hi B_hi) + (A_hi
// B_lo + A_lo B_hi) of n8 tile n0 + i, lane (g, t) holding rows g, g + 8
// (e / 2) and columns 2t, 2t + 1 (e % 2) of it, handed to epi(mt, q, n0,
// n1, out).  Per k16 step
// each n8 tile's B fragments come by four 32-bit loads (row g, columns 2t
// and 2t + 8, hi and lo), then the hi hi mma of every tile is issued, the
// hi lo, the lo hi: each accumulator's sums run in the order of one tile
// at a time.  The step does nothing else: every address is set up once
// per unit and product.
// kOne: the DEFAULT form's single pass, out[i][e] = A_hi B_hi (the hi lo
// and lo hi mma and their B words left out).  kWords: 16-byte tap words a
// lane reads per k16 step, 2 (hi then lo, fused_bamp.py::high_taps) or 1
// (hi alone, fused_bamp.py::default_taps: a warp's step is 512 contiguous
// bytes).
// The unit a lane runs and the elements it holds depend on the block's
// warps and the tiles alone, so two passes over the same stack (the split
// forms' two chains) give each element to the same lane.
template <bool kOne, int kWords, class Operand, class Epi>
__device__ __forceinline__ void high_pass(const uint4* taps, size_t plane,
                                          int mtiles, int ks, int q0, int nq,
                                          Operand operand, int lo, int ld,
                                          int nrows, int NT, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int parts = high_parts(mtiles, warps, NT);
  const int units = mtiles * parts;
  for (int u = warp; u < units; u += warps) {
    const int mt = u / parts, part = u - mt * parts;
    const int n0 = part * NT / parts, n1 = (part + 1) * NT / parts;
    const int nn = n1 - n0;
    // this lane's B fragment words in n8 tile n0 + i: row g, column 2t
    int boff[kMaxNT];
#pragma unroll
    for (int i = 0; i < kMaxNT; ++i)
      boff[i] =
          min((n0 + i) * 8 + (lane >> 2), nrows - 1) * ld + 2 * (lane & 3);
    const uint4* tile =
        taps + (static_cast<size_t>(mt) * ks * 32 + lane) * kWords;
    for (int q = q0; q < nq; ++q) {
      const uint4* ap = tile + q * plane;
      const __nv_bfloat16* b = operand(q);
      float hh[kMaxNT][4], cx[kMaxNT][4];
#pragma unroll
      for (int i = 0; i < kMaxNT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) hh[i][e] = cx[i][e] = 0.f;
      for (int k = 0; k < ks; ++k, ap += 32 * kWords, b += 16) {
        uint4 f[2];
        if (kOne)
          f[0] = f[1] = __ldg(ap);  // the hi half only (f[1] unused)
        else
          tap_load(f, ap);
        const unsigned ah[4] = {f[0].x, f[0].y, f[0].z, f[0].w};
        const unsigned al[4] = {f[1].x, f[1].y, f[1].z, f[1].w};
        unsigned bf[kMaxNT][4];
#pragma unroll
        for (int i = 0; i < kMaxNT; ++i)
          if (i < nn) {
            const __nv_bfloat16* r = b + boff[i];
            bf[i][0] = *reinterpret_cast<const unsigned*>(r);
            bf[i][1] = *reinterpret_cast<const unsigned*>(r + 8);
            if (!kOne) {
              bf[i][2] = *reinterpret_cast<const unsigned*>(r + lo);
              bf[i][3] = *reinterpret_cast<const unsigned*>(r + lo + 8);
            }
          }
#pragma unroll
        for (int i = 0; i < kMaxNT; ++i)
          if (i < nn) mma_bf16(hh[i], ah, bf[i][0], bf[i][1]);
        if (!kOne) {
#pragma unroll
          for (int i = 0; i < kMaxNT; ++i)
            if (i < nn) mma_bf16(cx[i], ah, bf[i][2], bf[i][3]);
#pragma unroll
          for (int i = 0; i < kMaxNT; ++i)
            if (i < nn) mma_bf16(cx[i], al, bf[i][0], bf[i][1]);
        }
      }
      if (!kOne)
#pragma unroll
        for (int i = 0; i < kMaxNT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) hh[i][e] = hh[i][e] + cx[i][e];
      epi(mt, q, n0, n1, hh);
    }
  }
}

// The one-pass products of a mixed form's one-pass chain, several in one
// k16 loop: products q0 .. nq-1 (at most kQ; hi-only tap fragments, one
// 16-byte word a lane and k16 step, plane q at taps + q plane) of each unit
// (high_pass's units, so each element stays with its lane), the step
// loading every product's tap word and B words and then issuing the hi hi
// mma of every (product, n8 tile): kQ times the independent accumulations
// of one product's loop between two dependent mma, where one product at a
// time waited on each mma's latency (tests/torch_k1_passes.py, Step 0 of
// the mixed forms in PERF.md).  Each accumulator still sums its product's
// k16 steps in order from zero, so the results are high_pass<true>'s bit
// for bit; epi(mt, q, n0, n1, out) is called for q0 .. nq-1 in turn.  (The
// DEFAULT form's four products in loops of two spilled and lost, in one
// loop of four gained nothing: it keeps high_pass, PERF.md.)
constexpr bool kFuseOnePass = true;

template <int kQ, class Operand, class Epi>
__device__ __forceinline__ void one_pass_products(
    const uint4* taps, size_t plane, int mtiles, int ks, int q0, int nq,
    Operand operand, int ld, int nrows, int NT, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int parts = high_parts(mtiles, warps, NT);
  const int units = mtiles * parts;
  const int nqq = nq - q0;
  for (int u = warp; u < units; u += warps) {
    const int mt = u / parts, part = u - mt * parts;
    const int n0 = part * NT / parts, n1 = (part + 1) * NT / parts;
    const int nn = n1 - n0;
    int boff[kMaxNT];
#pragma unroll
    for (int i = 0; i < kMaxNT; ++i)
      boff[i] =
          min((n0 + i) * 8 + (lane >> 2), nrows - 1) * ld + 2 * (lane & 3);
    const uint4* ap =
        taps + q0 * plane + static_cast<size_t>(mt) * ks * 32 + lane;
    const __nv_bfloat16* b[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) b[j] = operand(q0 + min(j, nqq - 1));
    float acc[kQ][kMaxNT][4];
#pragma unroll
    for (int j = 0; j < kQ; ++j)
#pragma unroll
      for (int i = 0; i < kMaxNT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][i][e] = 0.f;
    for (int k = 0; k < ks; ++k, ap += 32) {
      uint4 f[kQ];
#pragma unroll
      for (int j = 0; j < kQ; ++j)
        if (j < nqq) f[j] = __ldg(ap + j * plane);
      unsigned bf[kQ][kMaxNT][2];
#pragma unroll
      for (int j = 0; j < kQ; ++j)
#pragma unroll
        for (int i = 0; i < kMaxNT; ++i)
          if (j < nqq && i < nn) {
            const __nv_bfloat16* r = b[j] + boff[i];
            bf[j][i][0] = *reinterpret_cast<const unsigned*>(r);
            bf[j][i][1] = *reinterpret_cast<const unsigned*>(r + 8);
          }
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const unsigned a[4] = {f[j].x, f[j].y, f[j].z, f[j].w};
#pragma unroll
        for (int i = 0; i < kMaxNT; ++i)
          if (j < nqq && i < nn) mma_bf16(acc[j][i], a, bf[j][i][0],
                                          bf[j][i][1]);
      }
#pragma unroll
      for (int j = 0; j < kQ; ++j) b[j] += 16;
    }
#pragma unroll
    for (int j = 0; j < kQ; ++j)
      if (j < nqq) epi(mt, q0 + j, n0, n1, acc[j]);
  }
}

// cp.async of one 16-byte word from global to shared memory (L2 only),
// and its group fences.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// FP32 products on the CUDA cores: the chain of a split form that runs at
// 'highest' (bamp.plain_loop_split's torch.matmul).  kQ products that share
// their rows: out_q[c, j] = sum_kk x_q[c rs + off(kk)] A_q[kk, j] for rows
// c < rows and columns j < ncols, A_q the FP32 plane at a + q plane
// ((K, ncols), row-major, from fused_bamp.py::fp32_taps), x_q a plane of
// shared memory (a sum of two operands formed once into a plane by the
// caller), the contraction kk = l L2 + m (l < L1, m < L2) read from the
// row at off(kk) = l ls + m.  Each output is one FMA chain in kk order from
// zero, whoever computes it; epi(c, j, out) gets the kQ sums of one output.

//
// Register tiles (fp32_tiles): where the contraction is contiguous along a
// row (ls = L2, or L1 = 1), K, rs and ncols multiples of 4 and the staging
// buffer holds two panels of 4 steps, a thread owns kR rows x kC adjacent
// columns (kC = 2 in a pass of one product, 4 in a pass of several; kR of
// 3, 4 or 5, the one that fills the block's threads in fewest rounds of
// least work) and runs the kQ products one after another, the finished
// ones' sums held in registers for the epilogue.  The block stages each
// plane's taps in panels of KC contraction steps through shared memory by
// 16-byte cp.async copies, the next panel in flight while one is read and
// one barrier a panel, so every tap comes from L2 once per block, round
// and iteration; per 4 steps a thread reads each of its rows' x values as
// one 16-byte word (the same address across its warp, which shares a row
// group) and per step its kC taps as one vector word, by ld.shared at
// 32-bit addresses.  Elsewhere (fp32_rows, the earlier loop): a thread per
// column and kRows32 rows, its taps from L2 at every step.
constexpr int kRows32 = 4;

template <int kQ, class Epi>
__device__ __forceinline__ void fp32_rows(const float* a, size_t plane,
                                          int ncols, int rows, int rs,
                                          int L1, int ls, int L2,
                                          const float* const (&x)[kQ],
                                          Epi epi) {
  const int groups = (rows + kRows32 - 1) / kRows32;
  for (int f = threadIdx.x; f < groups * ncols; f += blockDim.x) {
    const int g = f / ncols;
    const int j = f - g * ncols;
    int row[kRows32];
#pragma unroll
    for (int i = 0; i < kRows32; ++i)
      row[i] = min(g * kRows32 + i, rows - 1) * rs;
    float acc[kRows32][kQ];
#pragma unroll
    for (int i = 0; i < kRows32; ++i)
#pragma unroll
      for (int q = 0; q < kQ; ++q) acc[i][q] = 0.f;
    const float* t = a + j;
    for (int l = 0; l < L1; ++l)
      for (int m = 0; m < L2; ++m, t += ncols) {
        float av[kQ];
#pragma unroll
        for (int q = 0; q < kQ; ++q) av[q] = __ldg(t + q * plane);
        const int off = l * ls + m;
#pragma unroll
        for (int i = 0; i < kRows32; ++i)
#pragma unroll
          for (int q = 0; q < kQ; ++q)
            acc[i][q] = fmaf(x[q][row[i] + off], av[q], acc[i][q]);
      }
#pragma unroll
    for (int i = 0; i < kRows32; ++i)
      if (g * kRows32 + i < rows) epi(g * kRows32 + i, j, acc[i]);
  }
}

// Columns of an FP32 register tile (2, 4 or 8: 8, 16 or 32 bytes of taps a
// step) for a pass of one product and for a pass of several.
constexpr int kColsOne32 = 2;
constexpr int kColsMany32 = 4;

// Shared-memory loads at a 32-bit shared address (the tiles' pointers pass
// through arrays and ranges where the compiler no longer sees that they
// point into shared memory, and would load through the generic path with
// 64-bit addresses).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ float4 lds128(unsigned a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ float2 lds64(unsigned a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a));
  return v;
}

// kC taps at shared address a of a staged panel, one vector word.
template <int kC>
__device__ __forceinline__ void tap_words(float (&t)[kC], unsigned a) {
  if constexpr (kC >= 4) {
#pragma unroll
    for (int h = 0; h < kC / 4; ++h) {
      const float4 v = lds128(a + 16 * h);
      t[4 * h] = v.x;
      t[4 * h + 1] = v.y;
      t[4 * h + 2] = v.z;
      t[4 * h + 3] = v.w;
    }
  } else {
    const float2 v = lds64(a);
    t[0] = v.x;
    t[1] = v.y;
  }
}

template <int kQ, int kR, int kC, class Epi>
__device__ __forceinline__ void fp32_tiles(const float* a, size_t plane,
                                           int ncols, int rows, int rs,
                                           int K, const float* const (&x)[kQ],
                                           float* stage, int KC, Epi epi) {
  const int cgroups = ncols / kC;
  const int items = (rows + kR - 1) / kR * cgroups;
  const int chunks = (K + KC - 1) / KC;
  const int panel = KC * ncols;  // floats of one staged panel
  // the panel of steps ci KC .. of plane q into buffer n & 1, as one
  // cp.async group
  auto stage_panel = [&](int q, int ci, int n) {
    const int k0 = ci * KC, n4 = min(KC, K - k0) * ncols / 4;
    float* buf = stage + (n & 1) * panel;
    const float* src = a + q * plane + static_cast<size_t>(k0) * ncols;
    for (int w = threadIdx.x; w < n4; w += blockDim.x) {
      cp_async16(buf + 4 * w, src + 4 * w);  // fp32 tap panel
    }
    cp_async_commit();
  };
  const unsigned tstep = 4 * ncols;  // bytes from one step's taps to the next
  for (int base = 0; base < items; base += blockDim.x) {
    const int item = base + threadIdx.x;
    const bool live = item < items;
    const int g = live ? item / cgroups : 0;
    const int j0 = live ? (item - g * cgroups) * kC : 0;
    // the products one after another, each over every panel of its plane;
    // the finished products' sums wait in res for the epilogue
    float res[kQ][kR][kC];
    stage_panel(0, 0, 0);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      float acc[kR][kC];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
      for (int ci = 0; ci < chunks; ++ci) {
        // panels run on across the products: panel n = q chunks + ci.  Once
        // it has landed and every thread is past this barrier (so done with
        // panel n - 1), the next panel goes into n - 1's buffer while this
        // one is read: one barrier a panel
        const int n = q * chunks + ci;
        cp_async_wait<0>();
        __syncthreads();
        if (ci + 1 < chunks)
          stage_panel(q, ci + 1, n + 1);
        else if (q + 1 < kQ)
          stage_panel(q + 1, 0, n + 1);
        if (live) {
          const int k0 = ci * KC, kc = min(KC, K - k0);
          // shared addresses in bytes, stepped along the panel: this
          // panel's taps of column j0, the x rows at step k0
          unsigned tp = smem_addr(stage + (n & 1) * panel + j0);
          unsigned xp[kR];
#pragma unroll
          for (int i = 0; i < kR; ++i)
            xp[i] = smem_addr(x[q] + min(g * kR + i, rows - 1) * rs + k0);
          for (int kk = 0; kk < kc; kk += 4) {  // fp32 tile step loop
            float4 xv[kR];
#pragma unroll
            for (int i = 0; i < kR; ++i) xv[i] = lds128(xp[i]);
#pragma unroll
            for (int st = 0; st < 4; ++st) {
              float t[kC];
              tap_words<kC>(t, tp + st * tstep);
#pragma unroll
              for (int i = 0; i < kR; ++i) {
                const float xs = lane4(xv[i], st);
#pragma unroll
                for (int c = 0; c < kC; ++c)
                  acc[i][c] = fmaf(xs, t[c], acc[i][c]);
              }
            }
            tp += 4 * tstep;
#pragma unroll
            for (int i = 0; i < kR; ++i) xp[i] += 16;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int c = 0; c < kC; ++c) res[q][i][c] = acc[i][c];
    }
    // every panel read: the staging region is free for the next round
    __syncthreads();
    if (live)
#pragma unroll
      for (int i = 0; i < kR; ++i)
        if (g * kR + i < rows)
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            float o[kQ];
#pragma unroll
            for (int q = 0; q < kQ; ++q) o[q] = res[q][i][c];
            epi(g * kR + i, j0 + c, o);
          }
  }
}

// The FP32 pass: register tiles where they apply (see above), with the tap
// panels staged in [stage, stage_end), else fp32_rows.
template <int kQ, class Epi>
__device__ __forceinline__ void fp32_pass(const float* a, size_t plane,
                                          int ncols, int rows, int rs,
                                          int L1, int ls, int L2,
                                          const float* const (&x)[kQ],
                                          float* stage,
                                          const float* stage_end, Epi epi) {
  const int K = L1 * L2;
  // steps of a panel: two panels fit, a multiple of 4, at most K
  int KC = static_cast<int>((stage_end - stage) / (2 * ncols)) & ~3;
  KC = min(KC, K);
  size_t align = reinterpret_cast<size_t>(stage);
#pragma unroll
  for (int q = 0; q < kQ; ++q) align |= reinterpret_cast<size_t>(x[q]);
  constexpr int kC = kQ > 1 ? kColsMany32 : kColsOne32;
  const bool tiles = (ls == L2 || L1 == 1) && K % 4 == 0 && rs % 4 == 0 &&
                     ncols % 4 == 0 && ncols % kC == 0 && KC >= 4 &&
                     (align & 15) == 0;
  if (!tiles) {
    fp32_rows<kQ>(a, plane, ncols, rows, rs, L1, ls, L2, x, epi);
    return;
  }
  // the row tile that fills the threads in fewest rounds of least work
  const int threads = blockDim.x, cgroups = ncols / kC;
  auto cost = [&](int kR) {
    const int items = (rows + kR - 1) / kR * cgroups;
    return (items + threads - 1) / threads * kR;
  };
  int kR = 5;
  if (cost(4) < cost(kR)) kR = 4;
  if (cost(3) < cost(kR)) kR = 3;
  if (kR == 5)
    fp32_tiles<kQ, 5, kC>(a, plane, ncols, rows, rs, K, x, stage, KC, epi);
  else if (kR == 4)
    fp32_tiles<kQ, 4, kC>(a, plane, ncols, rows, rs, K, x, stage, KC, epi);
  else
    fp32_tiles<kQ, 3, kC>(a, plane, ncols, rows, rs, K, x, stage, KC, epi);
}

// The floats of shared memory from bf16 address a (rounded up to 16
// bytes) to b.
struct Range {
  float* lo;
  const float* hi;
};
__device__ __forceinline__ Range float_range(__nv_bfloat16* a,
                                             const __nv_bfloat16* b) {
  const size_t u = (reinterpret_cast<size_t>(a) + 15) & ~size_t(15);
  return {reinterpret_cast<float*>(u), reinterpret_cast<const float*>(b)};
}
// The end of a split form's region (the HIGH form's whole, of the carve's
// lc column blocks: fused_bamp.py::high_split_elems).
__device__ __forceinline__ const __nv_bfloat16* split_end(
    const Split& s, int lc, int kx, int kz, bool real_x) {
  return s.base + max((real_x ? 4 : 8) * lc * (kx + 8), 8 * lc * (kz + 8));
}
// The larger of an FP32 variance chain's two dead ranges of a split
// region: its operand's planes, or the region past the xmap chain's nops
// operands.
template <class F>
__device__ __forceinline__ Range dead_var(const Split& s, int nops,
                                          const __nv_bfloat16* end) {
  const Range a = float_range(s.base, s.at<F>(1, 0));
  const Range b = float_range(s.at<F>(nops, 0), end);
  return (a.hi - a.lo) >= (b.hi - b.lo) ? a : b;
}

// The forward products of the HIGH layout's forms (column j = l Nr + m of
// the tap stack along the rows): P[c, l, m] for every column block c whose
// tap l places a block: the variance chain's Pv = dot(var, S_a2) and the
// xmap chain's Pr = k1 (- k3), Pi = k1 + k2, k1 parked in Pr's slot until
// the last product.  The gains, where not folded, multiply in the fold.
// The HIGH and DEFAULT forms (kVP == kXP) run the four products in one
// pass; a split form runs the variance chain's, then the xmap chain's: a
// chain on the tensor cores as those forms do, a chain in FP32 by
// fp32_pass on the FP32 planes var, or xm_re and xm_im with xm_re + xm_im
// formed once into a plane, its taps staged through the split planes it
// leaves dead.
template <int kVP, int kXP>
__device__ __forceinline__ void forward_high(
    const Params& p, const Span& sp, const Split& xs, int kx, int kz,
    bool real_x,
    const float* xm_re, const float* xm_im, const float* var, float* Pv,
    float* Pr, float* Pi, int NrP) {
  using F = Form<kVP, kXP>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int W = p.Lh * p.Nr;
  const int mtiles = kz / 16, ks = kx / 16, NT = (sp.nc + 7) / 8;
  // a tap plane's 16-byte words per word a lane reads a k16 step, and the
  // plane of the form's and of each chain's tap fragments
  const size_t words = static_cast<size_t>(mtiles) * ks * 32;
  const size_t plane = words * F::kWords;
  const size_t vplane = words * F::kVParts, xplane = words * F::kXParts;
  const int nq = real_x ? 3 : 4;
  // the products' operands: var, k1's (xm_re, or xm_re + xm_im), xm_re,
  // xm_im
  const int o1 = real_x ? 1 : 2;
  auto operand = [&](int q) {
    return xs.at<F>(q == 0 ? 0 : q == 1 ? o1 : q == 2 ? 1 : 3, 0);
  };
  auto epi = [&](int mt, int q, int n0, int n1,
                 const float (&v)[kMaxNT][4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = mt * 16 + g + 8 * h;
      if (j >= W) continue;
      const int l = j / p.Nr;
      const int row = l * NrP + (j - l * p.Nr);
#pragma unroll
      for (int i = 0; i < kMaxNT; ++i) {
        if (n0 + i >= n1) continue;
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const int c = (n0 + i) * 8 + 2 * t + w;
          if (c >= sp.nc || dst_block(sp.c0 + c, l, p) < 0) continue;
          const int slot = c * p.Lh * NrP + row;
          const float val = v[i][2 * h + w];
          if (q == 0) Pv[slot] = val;
          else if (q == 1) Pr[slot] = val;  // k1
          else if (q == 2) Pi[slot] = Pr[slot] + val;
          else Pr[slot] = Pr[slot] - val;
        }
      }
    }
  };
  if constexpr (kVP == kXP) {
    high_pass<kVP == 1, F::kWords>(p.taps, plane, mtiles, ks, 0, nq,
                                   operand, xs.plane, xs.ld, sp.nc, NT, epi);
  } else {
    // the FP32 planes (Nt, W): S_a2, S_re, Im S - Re S, Re S + Im S
    const size_t p32 = static_cast<size_t>(p.Nt) * W;
    // the slot of output (c, j) where tap l = j / Nr places a block, else -1
    auto slot_of = [&](int c, int j) {
      const int l = j / p.Nr;
      return dst_block(sp.c0 + c, l, p) < 0
                 ? -1
                 : (c * p.Lh + l) * NrP + (j - l * p.Nr);
    };
    if constexpr (kVP != 0) {
      high_pass<kVP == 1, F::kVParts>(F::taps_of(p, true), vplane, mtiles,
                                      ks, 0, 1, operand, xs.plane, xs.ld,
                                      sp.nc, NT, epi);
    } else {
      const float* const xv[1] = {var};
      const Range st = dead_var<F>(
          xs, real_x ? 2 : 4, split_end(xs, sp.lc, kx, kz, real_x));
      fp32_pass<1>(p.taps32, p32, W, sp.nc, p.Nt, 1, 0, p.Nt, xv, st.lo,
                   st.hi, [&](int c, int j, const float (&o)[1]) {
                     const int e = slot_of(c, j);
                     if (e >= 0) Pv[e] = o[0];
                   });
    }
    if constexpr (F::kMixed && kXP == 1 && kFuseOnePass) {
      one_pass_products<3>(F::taps_of(p, false), xplane, mtiles, ks, 1, nq,
                           operand, xs.ld, sp.nc, NT, epi);
    } else if constexpr (kXP != 0) {
      high_pass<kXP == 1, F::kXParts>(F::taps_of(p, false), xplane, mtiles,
                                      ks, 1, nq, operand, xs.plane, xs.ld,
                                      sp.nc, NT, epi);
    } else {
      // dead from the variance chain's planes on
      Range st = float_range(xs.at<F>(1, 0),
                             split_end(xs, sp.lc, kx, kz, real_x));
      if (real_x) {
        const float* const xr[2] = {xm_re, xm_re};
        fp32_pass<2>(p.taps32 + p32, p32, W, sp.nc, p.Nt, 1, 0, p.Nt, xr,
                     st.lo, st.hi, [&](int c, int j, const float (&o)[2]) {
                       const int e = slot_of(c, j);
                       if (e < 0) return;
                       Pr[e] = o[0];
                       Pi[e] = o[0] + o[1];
                     });
      } else {
        // k1's operand xm_re + xm_im, formed once
        float* sum = st.lo;
        const int N = sp.nc * p.Nt;
        for (int i = threadIdx.x; i < N; i += blockDim.x)
          sum[i] = xm_re[i] + xm_im[i];
        __syncthreads();
        st.lo = sum + ((N + 3) & ~3);
        const float* const xc[3] = {sum, xm_re, xm_im};
        fp32_pass<3>(p.taps32 + p32, p32, W, sp.nc, p.Nt, 1, 0, p.Nt, xc,
                     st.lo, st.hi, [&](int c, int j, const float (&o)[3]) {
                       const int e = slot_of(c, j);
                       if (e < 0) return;
                       Pr[e] = o[0] - o[2];
                       Pi[e] = o[0] + o[1];
                     });
      }
    }
  }
}

// Where the fold finds column block c (a global number): its index q in
// the block that holds it and that block's rank, and a pointer of this
// block's shared memory moved to the same offset in that block's (kClu,
// the cluster form; one block: c itself, here).
template <bool kClu>
__device__ __forceinline__ int home_of(const Params& p, int c, int& q) {
  if (!kClu) {
    q = c;
    return 0;
  }
  return owner_of(p, c, q);
}
template <bool kClu, class T>
__device__ __forceinline__ T* in_block(T* ptr, int rank) {
  return kClu ? map_rank(ptr, rank) : ptr;
}

// The fold of the HIGHEST form, output (r, m) per thread (the block's
// output rows): the taps summed in order after their gains, Onsager, u',
// then the gain-weighted adjoint inputs Z[c, l, m] of every (c, l)
// feeding the row, written into the slots of the P just read (in the
// block that holds c: kClu).
template <bool kClu>
__device__ __forceinline__ void fold_fp32(const Params& p, const Span& sp,
                                          float* Zc, float* Zr, float* Zi,
                                          int NrP, const float* y_re,
                                          const float* y_im, float* z_re,
                                          float* z_im, float* u) {
  const int n = sp.nr * p.Nr;
  for (int o = threadIdx.x; o < n; o += blockDim.x) {
    const int rl = o / p.Nr;
    const int m = o - rl * p.Nr;
    const int r = sp.r0 + rl;
    float v = 0.f, hx_re = 0.f, hx_im = 0.f;
    for (int l = 0; l < p.Lh; ++l) {
      const int c = src_block(r, l, p);
      if (c < 0) continue;
      int q;
      const int rank = home_of<kClu>(p, c, q);
      const int e = (q * p.Lh + l) * NrP + m;
      const float g = p.gains[l * p.Lin + c];
      v = v + p.gains2[l * p.Lin + c] * in_block<kClu>(Zc, rank)[e];
      hx_re = hx_re + g * in_block<kClu>(Zr, rank)[e];
      hx_im = hx_im + g * in_block<kClu>(Zi, rank)[e];
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
      int q;
      const int rank = home_of<kClu>(p, c, q);
      const int e = (q * p.Lh + l) * NrP + m;
      in_block<kClu>(Zc, rank)[e] = p.gains2[l * p.Lin + c] * wc;
      in_block<kClu>(Zr, rank)[e] = p.gains[l * p.Lin + c] * wr;
      in_block<kClu>(Zi, rank)[e] = p.gains[l * p.Lin + c] * wi;
    }
  }
}

// The fold of the HIGH layout's forms, output (r, m) per thread (the
// block's output rows): the taps summed in order (after their gains unless
// folded), w = v / u, z' = hx - w (y - z), u' = v + sigma2, then the
// adjoint's inputs Zc = 1/u', A = (y - z'_re) / u', B = (y - z'_im) / u'
// (gains^2 and gains applied unless folded) of every (c, l) feeding the
// row, in the block that holds c (kClu): split into bf16 (hi, and lo at
// kParts 2) for a chain on the tensor cores (Zc for the variance chain; A
// + B, A, B for the xmap chain), in FP32 for a chain at kVP or kXP = 0 (Zc
// in Pv's slot, A and B in Pr's and Pi's, which this thread has just read;
// the slots of the (c, l) that place no block stay zero from the launch).
// The split slots no output writes (the pad columns, the (c, l) that place
// no block) are written zero in the planes a chain reads, a pad column or
// a (c, l) at a time, each block its own column blocks'.
template <int kVP, int kXP, bool kClu>
__device__ __forceinline__ void fold_high(const Params& p, const Span& sp,
                                          const Split& zs, int kz, float* Pv,
                                          float* Pr, float* Pi, int NrP,
                                          const float* y_re,
                                          const float* y_im, float* z_re,
                                          float* z_im, float* u) {
  using F = Form<kVP, kXP>;
  const int n = sp.nr * p.Nr;
  const bool folded = p.folded != 0;
  for (int o = threadIdx.x; o < n; o += blockDim.x) {
    const int rl = o / p.Nr;
    const int m = o - rl * p.Nr;
    const int r = sp.r0 + rl;
    float v = 0.f, hx_re = 0.f, hx_im = 0.f;
    for (int l = 0; l < p.Lh; ++l) {
      const int c = src_block(r, l, p);
      if (c < 0) continue;
      int q;
      const int rank = home_of<kClu>(p, c, q);
      const int e = (q * p.Lh + l) * NrP + m;
      if (folded) {
        v = v + in_block<kClu>(Pv, rank)[e];
        hx_re = hx_re + in_block<kClu>(Pr, rank)[e];
        hx_im = hx_im + in_block<kClu>(Pi, rank)[e];
      } else {
        const float gn = p.gains[l * p.Lin + c];
        v = v + (gn * gn) * in_block<kClu>(Pv, rank)[e];
        hx_re = hx_re + gn * in_block<kClu>(Pr, rank)[e];
        hx_im = hx_im + gn * in_block<kClu>(Pi, rank)[e];
      }
    }
    const float w = v / u[o];
    const float zr = hx_re - w * (y_re[o] - z_re[o]);
    const float zi = hx_im - w * (y_im[o] - z_im[o]);
    const float un = v + p.sigma2;
    const float uinv = 1.f / un;
    const float rr = (y_re[o] - zr) * uinv;
    const float ri = (y_im[o] - zi) * uinv;
    z_re[o] = zr;
    z_im[o] = zi;
    u[o] = un;
    for (int l = 0; l < p.Lh; ++l) {
      const int c = src_block(r, l, p);
      if (c < 0) continue;
      int q;
      const int rank = home_of<kClu>(p, c, q);
      const float gn = folded ? 1.f : p.gains[l * p.Lin + c];
      const float zc = folded ? uinv : (gn * gn) * uinv;
      const float za = folded ? rr : gn * rr;
      const float zb = folded ? ri : gn * ri;
      const int off = q * zs.ld + l * p.Nr + m;
      const int e = (q * p.Lh + l) * NrP + m;
      Split zt = zs;
      zt.base = in_block<kClu>(zs.base, rank);
      if (kVP != 0)
        zt.put<F>(0, off, zc);
      else
        in_block<kClu>(Pv, rank)[e] = zc;
      if (kXP != 0) {
        zt.put<F>(1, off, za + zb);
        zt.put<F>(2, off, za);
        zt.put<F>(3, off, zb);
      } else {
        in_block<kClu>(Pr, rank)[e] = za;
        in_block<kClu>(Pi, rank)[e] = zb;
      }
    }
  }
  const int W = p.Lh * p.Nr;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  auto zero_slot = [&](int c, int j) {
#pragma unroll
    for (int q = 0; q < F::plane_of(4); ++q)
      if (q < F::kVParts ? kVP != 0 : kXP != 0)
        zs.base[q * zs.plane + c * zs.ld + j] = zero;
  };
  // the pad columns W .. kz-1 of every column block
  const int pad = kz - W;
  for (int i = threadIdx.x; i < sp.nc * pad; i += blockDim.x) {
    const int c = i / pad;
    zero_slot(c, W + (i - c * pad));
  }
  // the Nr slots of every (c, l) that places no block
  for (int i = threadIdx.x; i < sp.nc * p.Lh; i += blockDim.x) {
    const int c = i / p.Lh;
    const int l = i - c * p.Lh;
    if (dst_block(sp.c0 + c, l, p) >= 0) continue;
    for (int m = 0; m < p.Nr; ++m) zero_slot(c, l * p.Nr + m);
  }
}

// The adjoint products of the HIGH layout's forms (x element k along the
// rows): the variance chain's cov = 1 / dot(Zc, S_a2^T), then the xmap
// chain's adj = (k1 - k3) + i (k1 + k2) on A + B, A, B, xmap = xmmse + cov
// adj (its imaginary part to xmap_g, stride 2); k1 parked in xmap_re until
// the last product.  The HIGH and DEFAULT forms run the four products in
// one pass; the split forms run the variance chain first, then, once
// every cov is written, the xmap chain (an FP32 chain reads Zc, or A and B
// with A + B formed once into a plane, from the FP32 planes the fold
// wrote, its taps staged as in forward_high).
template <int kVP, int kXP>
__device__ __forceinline__ void adjoint_high(
    const Params& p, const Span& sp, const Split& zs, int kx, int kz,
    bool real_x,
    const float* xm_re, const float* xm_im, float* xmap_re, float* xmap_g,
    float* cov, const float* Zc, const float* A, const float* B, int NrP) {
  using F = Form<kVP, kXP>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mtiles = kx / 16, ks = kz / 16, NT = (sp.nc + 7) / 8;
  // as in forward_high; the adjoint's planes follow the forward's four
  const size_t words = static_cast<size_t>(mtiles) * ks * 32;
  const size_t plane = words * F::kWords;
  const size_t vplane = words * F::kVParts, xplane = words * F::kXParts;
  auto operand = [&](int q) { return zs.at<F>(q, 0); };
  auto epi = [&](int mt, int q, int n0, int n1,
                 const float (&v)[kMaxNT][4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = mt * 16 + g + 8 * h;
      if (k >= p.Nt) continue;
#pragma unroll
      for (int i = 0; i < kMaxNT; ++i) {
        if (n0 + i >= n1) continue;
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const int c = (n0 + i) * 8 + 2 * t + w;
          if (c >= sp.nc) continue;
          const int j = c * p.Nt + k;
          const float val = v[i][2 * h + w];
          if (q == 0) {
            cov[j] = 1.f / val;
          } else if (q == 1) {
            xmap_re[j] = val;  // k1
          } else if (q == 2) {
            const float im = cov[j] * (xmap_re[j] + val);
            xmap_g[2 * j + 1] = real_x ? im : xm_im[j] + im;
          } else {
            xmap_re[j] = xm_re[j] + cov[j] * (xmap_re[j] - val);
          }
        }
      }
    }
  };
  if constexpr (kVP == kXP) {
    high_pass<kVP == 1, F::kWords>(p.taps + 4 * plane, plane, mtiles, ks,
                                   0, 4, operand, zs.plane, zs.ld, sp.nc,
                                   NT, epi);
  } else {
    // the FP32 planes (W, Nt): S_a2^T, Re S^T, -Im S^T - Re S^T, Re S^T -
    // Im S^T, after the forward's four
    const size_t p32 = static_cast<size_t>(p.Nt) * p.Lh * p.Nr;
    const float* t32 = p.taps32 + 4 * p32;
    const int rs = p.Lh * NrP;
    if constexpr (kVP != 0) {
      high_pass<kVP == 1, F::kVParts>(F::taps_of(p, true) + 4 * vplane,
                                      vplane, mtiles, ks, 0, 1, operand,
                                      zs.plane, zs.ld, sp.nc, NT, epi);
    } else {
      const float* const xv[1] = {Zc};
      const Range st =
          dead_var<F>(zs, 4, split_end(zs, sp.lc, kx, kz, real_x));
      fp32_pass<1>(t32, p32, p.Nt, sp.nc, rs, p.Lh, NrP, p.Nr, xv, st.lo,
                   st.hi, [&](int c, int k, const float (&o)[1]) {
                     cov[c * p.Nt + k] = 1.f / o[0];
                   });
    }
    // k1's operand A + B of an FP32 xmap chain, formed once (dead from the
    // variance chain's planes on)
    Range st = float_range(zs.at<F>(1, 0),
                           split_end(zs, sp.lc, kx, kz, real_x));
    const int S = sp.nc * rs;
    if (kXP == 0)
      for (int e = threadIdx.x; e < S; e += blockDim.x) st.lo[e] = A[e] + B[e];
    __syncthreads();
    if constexpr (F::kMixed && kXP == 1 && kFuseOnePass) {
      one_pass_products<3>(F::taps_of(p, false) + 4 * xplane, xplane,
                           mtiles, ks, 1, 4, operand, zs.ld, sp.nc, NT, epi);
    } else if constexpr (kXP != 0) {
      high_pass<kXP == 1, F::kXParts>(F::taps_of(p, false) + 4 * xplane,
                                      xplane, mtiles, ks, 1, 4, operand,
                                      zs.plane, zs.ld, sp.nc, NT, epi);
    } else {
      const float* const xa[3] = {st.lo, A, B};
      fp32_pass<3>(
          t32 + p32, p32, p.Nt, sp.nc, rs, p.Lh, NrP, p.Nr, xa,
          st.lo + ((S + 3) & ~3), st.hi,
          [&](int c, int k, const float (&o)[3]) {
            const int j = c * p.Nt + k;
            xmap_re[j] = xm_re[j] + cov[j] * (o[0] - o[2]);
            const float im = cov[j] * (o[0] + o[1]);
            xmap_g[2 * j + 1] = real_x ? im : xm_im[j] + im;
          });
    }
  }
}

// Zeros in the pad columns Nt .. kx-1 of the forward's split operands
// that a chain on the tensor cores reads, in the block's nc rows.
template <int kVP, int kXP>
__device__ __forceinline__ void zero_x_pad(const Split& xs, int nc, int kx,
                                           bool real_x) {
  using F = Form<kVP, kXP>;
  const int pad = kx - xs.Nt;
  const int o0 = kVP != 0 ? 0 : 1;
  const int o1 = kXP == 0 ? 1 : real_x ? 2 : 4;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < nc * pad; i += blockDim.x) {
    const int c = i / pad;
    const int off = c * xs.ld + xs.Nt + (i - c * pad);
    for (int q = F::plane_of(o0); q < F::plane_of(o1); ++q)
      xs.base[q * xs.plane + off] = zero;
  }
}

// Denoisers.

// decode::torch_sum of get(0..n-1) for n <= kMaxK (W = last_pow2(n)
// lanes, each holding elements t and t + W).  get is called with static
// indices only, so an array it reads stays in registers.
template <int W, class Get>
__device__ __forceinline__ float small_sum_w(int n, Get get) {
  float lane[W];
#pragma unroll
  for (int t = 0; t < W; ++t) {
    const float a1 =
        t + W < n ? 0.f + get(t + W < kMaxK ? t + W : kMaxK - 1) : 0.f;
    lane[t] = (((0.f + get(t)) + a1) + 0.f) + 0.f;
  }
#pragma unroll
  for (int off = W / 2; off >= 1; off >>= 1)
#pragma unroll
    for (int t = 0; t < off; ++t) lane[t] = lane[t] + lane[t + off];
  return lane[0];
}

template <class Get>
__device__ __forceinline__ float small_sum(int n, Get get) {
  switch (last_pow2(n)) {
    case 1: return small_sum_w<1>(n, get);
    case 2: return small_sum_w<2>(n, get);
    case 4: return small_sum_w<4>(n, get);
    case 8: return small_sum_w<8>(n, get);
    default: return small_sum_w<16>(n, get);
  }
}

// The segmented posterior (decode::segment_posterior<true> with tau =
// cov / 2) of segment j0 .. j0+M-1, computed by the G lanes of one group
// (G = the lane count of PyTorch's reduction over M elements; lane t of
// the group, mask its lanes): the max and the segment sum through
// shuffles, each lane's share of the sum in lane_sum's order, then the
// mean and decomposed variance of elements t, t+G, ..., written to the
// state.  A lane keeps the scaled pseudo-data and eta of its first element
// (its only one when M is a power of two up to 32) from pass to pass.
// Returns the OR of the lanes' allclose failures.  kMask != 0: also writes
// the new state's operands of kMask split into xs (Split::store_x).  KS >
// 0: the alphabet's size K, known to the compiler (the same arithmetic, no
// loop over kMaxK symbols); 0: K as it comes.
template <int kMask, class F, int KS = 0>
__device__ __forceinline__ int group_posterior(
    int j0, int M, int K_in, int G, int t, unsigned mask, const float* sr,
    const float* si, bool real_x, const float* x_re, const float* xmap_g,
    const float* cov, float* xm_re, float* xm_im, float* var,
    const Split& xs) {
  const int K = KS > 0 ? KS : K_in;
  // pseudo-data over tau of element i
  auto scaled = [&](int i, float& a, float& b) {
    const int j = j0 + i;
    const float tau = cov[j] / 2.f;
    a = x_re[j] / tau;
    b = real_x ? 0.f : xmap_g[2 * j + 1] / tau;
  };
  auto t_of = [&](float a, float b, int q) {
    return real_x ? a * sr[q] : re_conj_mul(a, b, sr[q], si[q]);
  };
  float a0, b0;
  scaled(t, a0, b0);
  float mx = -INFINITY;
  for (int q = 0; q < K; ++q) mx = fmaxf(mx, t_of(a0, b0, q));
  for (int i = t + G; i < M; i += G) {
    float a, b;
    scaled(i, a, b);
    for (int q = 0; q < K; ++q) mx = fmaxf(mx, t_of(a, b, q));
  }
  for (int off = G / 2; off >= 1; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(mask, mx, off, G));
  auto eta = [&](float a, float b, int q) {
    return expf(fminf(t_of(a, b, q) - mx, kExpMax));
  };
  // eta of one element for every symbol (K > 1)
  auto etas = [&](float a, float b, float (&e)[kMaxK]) {
#pragma unroll
    for (int q = 0; q < kMaxK; ++q) e[q] = q < K ? eta(a, b, q) : 0.f;
  };
  // eta summed over the symbols
  auto eta_m = [&](float a, float b) {
    if (K == 1) return eta(a, b, 0);
    float e[kMaxK];
    etas(a, b, e);
    return small_sum(K, [&](int q) { return e[q]; });
  };
  // ... then over the segment: element s of this lane goes to accumulator
  // s % 4 (lane_sum), the lanes join in a tree
  const float em0 = eta_m(a0, b0);
  float acc0 = 0.f + em0, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  int s = 1;
  for (int i = t + G; i < M; i += G, ++s) {
    float a, b;
    scaled(i, a, b);
    const float em = eta_m(a, b);
    switch (s & 3) {
      case 0: acc0 = acc0 + em; break;
      case 1: acc1 = acc1 + em; break;
      case 2: acc2 = acc2 + em; break;
      default: acc3 = acc3 + em; break;
    }
  }
  float sum = ((acc0 + acc1) + acc2) + acc3;
  for (int off = G / 2; off >= 1; off >>= 1)
    sum = sum + __shfl_down_sync(mask, sum, off, G);
  const float eta2 = __shfl_sync(mask, sum, 0, G);
  int flag = 0;
  for (int i = t; i < M; i += G) {
    float a = a0, b = b0;
    if (i != t) scaled(i, a, b);
    float mr, mi, vn;
    if (K == 1) {
      const float post = (i == t ? em0 : eta(a, b, 0)) / eta2;
      mr = sr[0] * post;
      mi = si[0] * post;
      vn = abs2(mr, mi) * (1.f - post) + abs2(mr - sr[0], mi - si[0]) * post;
    } else {
      float e[kMaxK];
      etas(a, b, e);
      mr = small_sum(K, [&](int q) { return sr[q] * e[q]; }) / eta2;
      mi = small_sum(K, [&](int q) { return si[q] * e[q]; }) / eta2;
      const float var0 =
          abs2(mr, mi) *
          (1.f - small_sum(K, [&](int q) { return e[q]; }) / eta2);
      const float vs = small_sum(K, [&](int q) {
        return abs2(mr - sr[q], mi - si[q]) * e[q];
      });
      vn = var0 + vs / eta2;
    }
    const int j = j0 + i;
    const float old = var[j];
    xm_re[j] = mr;
    if (!real_x) xm_im[j] = mi;
    var[j] = vn;
    if (kMask) xs.store_x<kMask, F>(j, mr, mi, vn, real_x);
    flag |= int(fabsf(vn - old) > kAtol + kRtol * fabsf(old));
  }
  return flag;
}

// Two segments of M = G elements (one a lane) posterior'd by one group at
// once, j0[0] and j0[1]: group_posterior's arithmetic for each, step by
// step side by side (the same operations in the same order per segment,
// so the same bits), so that the shuffles, divisions and loads of one
// overlap the other's.  K known to the compiler (KS > 0).
template <int kMask, class F, int KS>
__device__ __forceinline__ int pair_posterior(
    const int (&j0)[2], int G, int t, unsigned mask, const float* sr,
    const float* si, bool real_x, const float* x_re, const float* xmap_g,
    const float* cov, float* xm_re, float* xm_im, float* var,
    const Split& xs) {
  constexpr int K = KS;
  auto t_of = [&](float a, float b, int q) {
    return real_x ? a * sr[q] : re_conj_mul(a, b, sr[q], si[q]);
  };
  int j[2];
  float a[2], b[2], old[2], mx[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    j[s] = j0[s] + t;
    const float tau = cov[j[s]] / 2.f;
    a[s] = x_re[j[s]] / tau;
    b[s] = real_x ? 0.f : xmap_g[2 * j[s] + 1] / tau;
    old[s] = var[j[s]];
    mx[s] = -INFINITY;
#pragma unroll
    for (int q = 0; q < K; ++q) mx[s] = fmaxf(mx[s], t_of(a[s], b[s], q));
  }
  for (int off = G / 2; off >= 1; off >>= 1)
#pragma unroll
    for (int s = 0; s < 2; ++s)
      mx[s] = fmaxf(mx[s], __shfl_xor_sync(mask, mx[s], off, G));
  // eta of every symbol, summed over the symbols, then over the segment
  float e[2][K], sum[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int q = 0; q < K; ++q)
      e[s][q] = expf(fminf(t_of(a[s], b[s], q) - mx[s], kExpMax));
    const float em =
        K == 1 ? e[s][0] : small_sum(K, [&](int q) { return e[s][q]; });
    sum[s] = (((0.f + em) + 0.f) + 0.f) + 0.f;
  }
  for (int off = G / 2; off >= 1; off >>= 1)
#pragma unroll
    for (int s = 0; s < 2; ++s)
      sum[s] = sum[s] + __shfl_down_sync(mask, sum[s], off, G);
  int flag = 0;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float eta2 = __shfl_sync(mask, sum[s], 0, G);
    float mr, mi, vn;
    if (K == 1) {
      const float post = e[s][0] / eta2;
      mr = sr[0] * post;
      mi = si[0] * post;
      vn = abs2(mr, mi) * (1.f - post) + abs2(mr - sr[0], mi - si[0]) * post;
    } else {
      mr = small_sum(K, [&](int q) { return sr[q] * e[s][q]; }) / eta2;
      mi = small_sum(K, [&](int q) { return si[q] * e[s][q]; }) / eta2;
      const float var0 =
          abs2(mr, mi) *
          (1.f - small_sum(K, [&](int q) { return e[s][q]; }) / eta2);
      const float vs = small_sum(K, [&](int q) {
        return abs2(mr - sr[q], mi - si[q]) * e[s][q];
      });
      vn = var0 + vs / eta2;
    }
    xm_re[j[s]] = mr;
    if (!real_x) xm_im[j[s]] = mi;
    var[j[s]] = vn;
    if (kMask) xs.store_x<kMask, F>(j[s], mr, mi, vn, real_x);
    flag |= int(fabsf(vn - old[s]) > kAtol + kRtol * fabsf(old[s]));
  }
  return flag;
}

// The Bernoulli-symbol mixture posterior of element j, with the exponent
// clamps and the zero-norm guard of the plain version (kMask != 0: also
// split into xs).
template <int kMask, class F>
__device__ __forceinline__ int mixture_posterior(
    const Params& p, int j, bool real_x, const float* x_re,
    const float* xmap_g, const float* cov, float* xm_re, float* xm_im,
    float* var, const Split& xs) {
  const float* sr = p.sym_re;
  const float* si = p.sym_im;
  const int K = p.K;
  const float cv = cov[j];
  const float xr = x_re[j], xi = xmap_g[2 * j + 1];
  const float g0 = expf(-fminf(abs2(xr, xi) / cv, kExpMax));
  float g[kMaxK];
#pragma unroll
  for (int q = 0; q < kMaxK; ++q)
    g[q] = q < K ? expf(-fminf(abs2(xr - sr[q], xi - si[q]) / cv, kExpMax))
                 : 0.f;
  float norm = p.P0 * g0 + p.Ps * small_sum(K, [&](int q) { return g[q]; });
  if (norm == 0.f) norm = kZeroTol;
  const float mr =
      (p.Ps * small_sum(K, [&](int q) { return sr[q] * g[q]; })) / norm;
  const float mi =
      (p.Ps * small_sum(K, [&](int q) { return si[q] * g[q]; })) / norm;
  const float second = (p.Ps * small_sum(K, [&](int q) {
                          return abs2(sr[q], si[q]) * g[q];
                        })) / norm;
  const float vn = second - abs2(mr, mi);
  const float old = var[j];
  xm_re[j] = mr;
  if (!real_x) xm_im[j] = mi;
  var[j] = vn;
  if (kMask) xs.store_x<kMask, F>(j, mr, mi, vn, real_x);
  return int(fabsf(vn - old) > kAtol + kRtol * fabsf(old));
}

// kVP, kXP: the passes of the variance chain and of the xmap chain (0 FP32
// on the CUDA cores, 1 one bf16 pass, 3 three).  <0, 0> is the HIGHEST form
// on its own layout and engine; every other pair runs on the HIGH layout:
// <3, 3> the HIGH form, <1, 1> the DEFAULT form, the rest the split forms.
template <int kVP, int kXP, int kBlock, int kMinBlocks>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    bamp_decode_kernel(Params p) {
  constexpr bool kHigh = kVP != 0 || kXP != 0;
  // a split form with an FP32 chain, which reads the scratch planes whole
  constexpr bool kFP32 = kHigh && (kVP == 0 || kXP == 0);
  using F = Form<kVP, kXP>;
  constexpr int kMask = kHigh ? F::kMask : 0;
  // the denoiser's segments two at a time where each lane holds one element
  // and K is fixed (pair_posterior): every form on the HIGH layout
  constexpr bool kPair = kHigh;
  const Span sp = block_span(p);
  const int b = kCluster ? blockIdx.x / p.ctas : blockIdx.x;
  const int tid = threadIdx.x;
  // this block's x-side elements and y-side outputs, and the trial's
  const int N = sp.nc * p.Nt;
  const int n = sp.nr * p.Nr;
  const int NrP = (p.Nr + 3) & ~3;
  const size_t xo = static_cast<size_t>(b) * (p.Lin * p.Nt) +
                    static_cast<size_t>(sp.c0) * p.Nt;
  const size_t yo = static_cast<size_t>(b) * (p.Lout * p.Nr) +
                    static_cast<size_t>(sp.r0) * p.Nr;
  const bool real_x = p.real_x != 0;
  int act = p.act_in[b];
  int T = p.T_in[b];

  if (!act || p.cap <= 0) {
    // Frozen trial: state passes through (every block of a cluster takes
    // this branch and copies its own ranges; no block reads another's).
    for (int j = tid; j < N; j += blockDim.x) {
      p.xmap_out[xo + j] = p.xmap_in[xo + j];
      p.xmmse_out[xo + j] = p.xmmse_in[xo + j];
      p.var_out[xo + j] = p.var_in[xo + j];
    }
    for (int o = tid; o < n; o += blockDim.x) {
      p.z_out[yo + o] = p.z_in[yo + o];
      p.u_out[yo + o] = p.u_in[yo + o];
    }
    if (tid == 0 && sp.rank == 0) {
      p.act_out[b] = act;
      p.T_out[b] = T;
    }
    return;
  }

  // Shared-memory planes of this trial (of the block's carve of lc column
  // and rc output row blocks), in the order whose size block_bytes() in
  // fused_bamp.py computes.  The scratch planes come first (16-byte rows of
  // NrP floats): the forward products P[c, l, m], then in the same slots the
  // adjoint inputs Z[c, l, m].
  extern __shared__ __align__(16) float sm[];
  const int S = sp.lc * p.Lh * NrP;
  const int NX = sp.lc * p.Nt, NY = sp.rc * p.Nr;
  float* Zc = sm;
  float* Zr = Zc + S;
  float* Zi = Zr + S;
  float* xm_re = Zi + S;
  float* xm_im = xm_re + NX;                // absent for real alphabets
  float* var = xm_im + (real_x ? 0 : NX);
  float* xmap_re = var + NX;
  float* cov = xmap_re + NX;
  float* y_re = cov + NX;
  float* y_im = y_re + NY;
  float* z_re = y_im + NY;
  float* z_im = z_re + NY;
  float* u = z_im + NY;
  // The pseudo-data's imaginary part lives in the output (stride 2).
  float* xmap_g = reinterpret_cast<float*>(p.xmap_out + xo);
  // HIGH form: the split operands after the FP32 planes, the forward's x
  // side (xs) and the adjoint's inputs (zs) in one region; contractions
  // padded to 16 (kx, kz), rows kx + 8 and kz + 8 bf16 apart: kParts
  // planes per operand (fused_bamp.py::high_split_elems; a split form's
  // region is the HIGH form's whole).
  const int kx = (p.Nt + 15) & ~15;
  const int kz = (p.Lh * p.Nr + 15) & ~15;
  __nv_bfloat16* split = reinterpret_cast<__nv_bfloat16*>(u + NY);
  const Split xs{split, p.Nt, kx + 8, sp.lc * (kx + 8)};
  const Split zs{split, p.Nt, kz + 8, sp.lc * (kz + 8)};

  // Slots of (c, l) pairs that place no block, and the row padding, stay
  // zero: the adjoint reads them as exact zeros.
  if (!kHigh || kFP32)
    for (int e = tid; e < 3 * S; e += blockDim.x) sm[e] = 0.f;
  for (int j = tid; j < N; j += blockDim.x) {
    const float2 m = p.xmmse_in[xo + j];
    xm_re[j] = m.x;
    if (!real_x) xm_im[j] = m.y;
    var[j] = p.var_in[xo + j];
    if (kHigh) xs.store_x<kMask, F>(j, m.x, m.y, var[j], real_x);
  }
  if (kHigh) zero_x_pad<kVP, kXP>(xs, sp.nc, kx, real_x);
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

  // The barrier around the fold: the block's own, or the cluster's, whose
  // fold reads and writes the other blocks' slots (the first one also
  // waits for every block of the cluster to have started).
  auto fold_barrier = [&]() {
    if constexpr (kCluster)
      cluster_sync();
    else
      __syncthreads();
  };
  const int cols = p.Lh * p.Nr;
  const int fwd_tiles = (sp.nc + kFR - 1) / kFR * cols;
  const int adj_tiles = (sp.nc + kAR - 1) / kAR * p.Nt;
  const bool vec = p.Nt % 4 == 0;
  for (int it = 0; it < p.cap; ++it) {
    if (kHigh) {
      // ---- the HIGH layout's linear half: each chain on the tensor cores
      // or, in a split form, in FP32 on the CUDA cores ---
      forward_high<kVP, kXP>(p, sp, xs, kx, kz, real_x, xm_re, xm_im, var,
                             Zc, Zr, Zi, NrP);
      fold_barrier();
      fold_high<kVP, kXP, kCluster>(p, sp, zs, kz, Zc, Zr, Zi, NrP, y_re,
                                    y_im, z_re, z_im, u);
      fold_barrier();
      adjoint_high<kVP, kXP>(p, sp, zs, kx, kz, real_x, xm_re, xm_im,
                             xmap_re, xmap_g, cov, Zc, Zr, Zi, NrP);
      __syncthreads();
    } else {
    // ---- forward products: thread per (kFR source blocks, tap column) ---
    for (int f = tid; f < fwd_tiles; f += blockDim.x) {
      const int g = f / cols;
      const int l = (f - g * cols) / p.Nr;
      const int m = f - g * cols - l * p.Nr;
      if (vec && real_x)
        forward_tile<true, true>(p, sp, g * kFR, l, m, xm_re, xm_im, var, Zc,
                                 Zr, Zi, NrP);
      else if (vec)
        forward_tile<true, false>(p, sp, g * kFR, l, m, xm_re, xm_im, var,
                                  Zc, Zr, Zi, NrP);
      else if (real_x)
        forward_tile<false, true>(p, sp, g * kFR, l, m, xm_re, xm_im, var,
                                  Zc, Zr, Zi, NrP);
      else
        forward_tile<false, false>(p, sp, g * kFR, l, m, xm_re, xm_im, var,
                                   Zc, Zr, Zi, NrP);
    }
    fold_barrier();

    // ---- fold, Onsager residual and adjoint inputs: thread per (r, m) ---
    fold_fp32<kCluster>(p, sp, Zc, Zr, Zi, NrP, y_re, y_im, z_re, z_im, u);
    fold_barrier();

    // ---- adjoint products: thread per (kAR column blocks, x element) ---
    for (int f = tid; f < adj_tiles; f += blockDim.x) {
      const int g = f / p.Nt;
      adjoint_tile(p, sp.nc, g * kAR, f - g * p.Nt, Zc, Zr, Zi, NrP, xm_re,
                   xm_im, xmap_re, xmap_g, cov, real_x);
    }
    __syncthreads();
    }

    int bad = 0;
    // ---- denoiser, allclose test and state update -----------------------
    if (p.den == kSegmented) {
      // A group of G lanes per segment, tau = cov / 2, decomposed variance.
      const int G = p.M >= 32 ? 32 : last_pow2(p.M);
      const int t = tid & (G - 1);
      const unsigned mask =
          G == 32 ? 0xffffffffu : ((1u << G) - 1) << ((tid & 31) & ~(G - 1));
      // every segment of the block's column blocks, K known to the compiler
      // where KS > 0; group g takes segments g, g + groups, ..., at kPair
      // two at a time
      auto segments = [&](auto ks) {
        constexpr int KS = decltype(ks)::value;
        const int nseg = N / p.M, groups = blockDim.x / G;
        int s = tid / G;
        if constexpr (kPair && KS > 0) {
          if (G == p.M)
            for (; s + groups < nseg; s += 2 * groups) {
              const int j0[2] = {s * p.M, (s + groups) * p.M};
              bad |= pair_posterior<kMask, F, KS>(
                  j0, G, t, mask, p.sym_re, p.sym_im, real_x, xmap_re,
                  xmap_g, cov, xm_re, xm_im, var, xs);
            }
        }
        for (; s < nseg; s += groups)
          bad |= group_posterior<kMask, F, KS>(
              s * p.M, p.M, p.K, G, t, mask, p.sym_re, p.sym_im, real_x,
              xmap_re, xmap_g, cov, xm_re, xm_im, var, xs);
      };
      // HIGH form: OOK and QPSK (the flagships' alphabets) with their K
      // fixed (kStaticK)
      constexpr bool kStaticK = kHigh;
      if constexpr (kStaticK) {
        if (p.K == 1)
          segments(std::integral_constant<int, 1>());
        else if (p.K == 4)
          segments(std::integral_constant<int, 4>());
        else
          segments(std::integral_constant<int, 0>());
      } else {
        segments(std::integral_constant<int, 0>());
      }
    } else {
      for (int j = tid; j < N; j += blockDim.x)
        bad |= mixture_posterior<kMask, F>(
            p, j, real_x, xmap_re, xmap_g, cov, xm_re, xm_im, var, xs);
    }
    if (kHigh) zero_x_pad<kVP, kXP>(xs, sp.nc, kx, real_x);
    ++T;
    int any = __syncthreads_or(bad);
    if constexpr (kCluster) {
      // the OR across the cluster: each block's flag into slot rank of
      // every block (the last kFlagInts ints of its dynamic shared memory,
      // past the carve), then the cluster barrier (the slots are written
      // again only after the next iteration's fold barriers, by which time
      // every block has read them)
      int* flags = reinterpret_cast<int*>(reinterpret_cast<char*>(sm) +
                                          p.smem) - kFlagInts;
      if (tid < p.ctas) map_rank(flags, tid)[sp.rank] = any;
      cluster_sync();
      any = 0;
      for (int i = 0; i < p.ctas; ++i) any |= flags[i];
    }
    if (!any) {
      act = 0;
      break;
    }
  }

  for (int j = tid; j < N; j += blockDim.x) {
    xmap_g[2 * j] = xmap_re[j];
    p.xmmse_out[xo + j] = make_float2(xm_re[j], real_x ? 0.f : xm_im[j]);
    p.var_out[xo + j] = var[j];
  }
  for (int o = tid; o < n; o += blockDim.x) {
    p.z_out[yo + o] = make_float2(z_re[o], z_im[o]);
    p.u_out[yo + o] = u[o];
  }
  // the trial's T and activity, from the first block of its cluster
  // (every block holds the same)
  if (tid == 0 && sp.rank == 0) {
    p.act_out[b] = act;
    p.T_out[b] = T;
  }
  // no block leaves while another of its cluster may still reach its
  // shared memory
  if constexpr (kCluster) cluster_sync();
}

using Kernel = void (*)(Params);

// The passes of a chain at form code f (0 HIGHEST, 1 HIGH, 2 DEFAULT).
constexpr int passes_of(int f) { return f == 0 ? 0 : f == 1 ? 3 : 1; }

// The split form of variance form vf and xmap form xf (vf != xf): one
// instance each, compiled for the 16-warp block and launched with 8 or 16
// warps (128 registers a thread either way).
template <int vf, int xf>
Kernel split_kernel() {
  return bamp_decode_kernel<passes_of(vf), passes_of(xf), kHighThreads1, 1>;
}

Kernel split_instance(int vf, int xf) {
  switch (vf * 3 + xf) {
    case 1: return split_kernel<0, 1>();
    case 2: return split_kernel<0, 2>();
    case 3: return split_kernel<1, 0>();
    case 5: return split_kernel<1, 2>();
    case 6: return split_kernel<2, 0>();
    case 7: return split_kernel<2, 1>();
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Launch the decode of B trials on `stream` with `smem` bytes of dynamic
// shared memory per block; high: the form of the variance chain, xhigh:
// that of the xmap chain (0 HIGHEST, 1 HIGH, 2 DEFAULT).  high == xhigh:
// the HIGHEST, HIGH or DEFAULT form; else a split form.  Every form but
// HIGHEST runs on the tap fragments `taps` (folded: the gains are in them)
// with `threads` threads a block; a split form with a chain at HIGHEST
// also on the FP32 tap planes `taps32` (fused_bamp.py::fp32_taps), a mixed
// form (one chain 'high', the other 'default') its one-pass chain on the
// hi-only fragments `taps1` (fused_bamp.py::default_taps).  ctas: the
// blocks a trial, 1 in the one-block library, a cluster of 2, 4 or 8 in
// the cluster form's (K1_CLUSTER; fused_bamp.py::cluster_plan: the grid B
// ctas blocks, cudaLaunchKernelEx with the cluster dimension, after
// cudaOccupancyMaxActiveClusters has found a cluster of them can be
// resident; where it finds none, cudaErrorInvalidConfiguration, and
// nothing runs).  Returns a cudaError_t code (0 on success): the
// attribute or occupancy call's, or the launch's and cudaGetLastError()
// after it.  The kernel allocates nothing; every buffer is the caller's.
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
    int smem, int high, int xhigh, const void* taps, const void* taps32,
    const void* taps1, int folded, int threads, int ctas, void* stream) {
  if (K < 1 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (!(kCluster ? ctas == 2 || ctas == 4 || ctas == 8 : ctas == 1) ||
      ctas > Lin ||
      (kCluster && smem < kFlagInts * static_cast<int>(sizeof(int))))
    return static_cast<int>(cudaErrorInvalidValue);
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
  p.taps = static_cast<const uint4*>(taps);
  p.taps32 = static_cast<const float*>(taps32);
  p.taps1 = static_cast<const uint4*>(taps1);
  p.folded = folded;
  p.ctas = ctas;
  p.smem = smem;
  const bool split = high != xhigh;
  if (high < 0 || high > 2 || xhigh < 0 || xhigh > 2 ||
      ((high || xhigh) && taps == nullptr) ||
      (split && !(high && xhigh) && taps32 == nullptr) ||
      (split && high && xhigh && taps1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Kernel kernel = bamp_decode_kernel<0, 0, kThreads, 3>;
  const bool one = high == 2;
  if (!high && !xhigh)
    threads = kThreads;
  else if (threads != kHighThreads1 && threads != kHighThreads2)
    return static_cast<int>(cudaErrorInvalidValue);
  else if (split)
    kernel = split_instance(high, xhigh);
  else if (threads == kHighThreads1)
    kernel = one ? bamp_decode_kernel<1, 1, kHighThreads1, 1>
                 : bamp_decode_kernel<3, 3, kHighThreads1, 1>;
  else
    kernel = one ? bamp_decode_kernel<1, 1, kHighThreads2, 2>
                 : bamp_decode_kernel<3, 3, kHighThreads2, 2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!kCluster) {
    kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(B) * ctas);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaLaunchKernelEx(&config, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_bamp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
