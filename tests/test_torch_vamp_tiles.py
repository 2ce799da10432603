"""What the VAMP product engine (``ops/kernels/csrc/vamp_common.cuh``, used
by the whole-decode kernels K3 ``fused_vamp_decode.cu`` and K4
``fused_vamp2_decode.cu``) rests on, checked on the CPU: its thread maps
cover every output of both products, every operand element of a ring slot
and every denoiser segment exactly once; its shared-memory stores and
reads are free of bank conflicts; its carve-out and registers fit the
blocks per SM it is built for; and its blocked order of the sums over k
errs against float64 no more than chains of 16 do.  The constants are
read from the source.  The kernels themselves run only on the card
(``chip_smoke.py``)."""
import math
import re

import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.models import montecarlo
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import build
from amp_sparc_spatialmodulation_tpu_torch.utils.device import make_generator

COMMON = (build.CSRC / "vamp_common.cuh").read_text()
KERNELS = {name: (build.CSRC / f"{name}.cu").read_text()
           for name in ("fused_vamp_decode", "fused_vamp2_decode")}


def constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", COMMON).group(1))


THREADS, TY, TX = constant("kThreads"), constant("kTy"), constant("kTx")
NI, NJ1, NJ2 = constant("kNI"), constant("kNJ1"), constant("kNJ2")
BK, STAGES = constant("kBK"), constant("kStages")
PAD, MIN_BLOCKS = constant("kPad"), constant("kMinBlocks")
BT = TY * NI
BN1, BN2 = TX * NJ1, TX * NJ2
BN_MAX = max(BN1, BN2)

# An SM's shared memory and the part a block may take (CUDA reserves 1 KB
# per block); an SM's registers and a thread's most.
SM_SMEM, BLOCK_SMEM, RESERVE = 228 * 1024, 232448, 1024
SM_REGS, MAX_REGS = 65536, 255

SMALL = dict(Nt=16, Na=4, Nr=10, Lin=8, Lh=3, mode="segmented",
             profile="uniform", trunc="tail", alphabet="OOK")
MAIN = dict(Nt=128, Na=8, Nr=24, Lin=20, Lh=3, mode="segmented",
            alphabet="OOK", profile="uniform", trunc="tail")
FINAL = dict(Nt=128, Na=16, Nr=32, Lin=25, Lh=6, mode="segmented",
             alphabet="QPSK", profile="uniform", trunc="tail")
# chip_smoke.py's K3/K4 geometries: (config, trials per realization,
# realizations in one launch).
GEOMETRIES = {
    "main": (MAIN, 65536, 1),
    "main_4096": (MAIN, 4096, 1),
    "vampfinal": (FINAL, 1024, 1),
    "small": (SMALL, 1024, 1),
    "small_qpsk_toeplitz": (dict(SMALL, alphabet="QPSK"), 1024, 1),
    "small_batched": (SMALL, 1024, 3),
    "ragged": (SMALL, 1000, 2),
}


def dims(spec):
    cfg = Config(**spec)
    return cfg, cfg.N, min(cfg.n, cfg.N)


def tile_count(nrows, ncols, nj):
    """How often each output (m, n) of one block's product is produced by
    product_tile's thread map, over the column tiles n0 = 0, 16 nj, ..."""
    count = np.zeros((nrows, ncols), dtype=np.int64)
    ty, tx, i, j = np.meshgrid(np.arange(TY), np.arange(TX), np.arange(NI),
                               np.arange(nj), indexing="ij")
    for n0 in range(0, ncols, TX * nj):
        m, n = NI * ty + i, n0 + tx + TX * j
        ok = (m < nrows) & (n < ncols)
        np.add.at(count, (m[ok], n[ok]), 1)
    return count


def test_constants_as_designed():
    assert TY * TX == THREADS == 256
    assert BT == 64 and BN1 == 48 and BN2 == 32
    assert BK == 16 and MIN_BLOCKS == 2
    # the column tiles divide the main geometry: no wasted FMAs there
    _, N, p = dims(MAIN)
    assert (N, p) == (2560, 528)
    assert p % BN1 == 0 and N % BN2 == 0
    # both kernels are held to the engine's blocks per SM
    for src in KERNELS.values():
        assert "__launch_bounds__(kThreads, kMinBlocks)" in src
        assert "kGroup" not in src and "e / N" not in src


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_products_cover_every_output_once(geometry):
    """Every (trial, column) of q = r_tilde Vh^T (B x p) and of x = w
    conj(Vh) (B x N) comes from exactly one thread of one block, on the
    grid (ceil(B_per / kBt), C) that the launch functions set."""
    spec, b_per, C = GEOMETRIES[geometry]
    _, N, p = dims(spec)
    for src in KERNELS.values():
        assert "(B + kBt - 1) / kBt" in src or \
            "(B_per + kBt - 1) / kBt" in src
    blocks = -(-b_per // BT)
    rows = np.zeros(C * b_per, dtype=np.int64)
    for c in range(C):
        for bx in range(blocks):
            first = bx * BT
            nrows = min(BT, b_per - first)
            rows[c * b_per + first:c * b_per + first + nrows] += 1
    assert (rows == 1).all()
    # a full block and the ragged last one
    for nrows in sorted({BT if b_per >= BT else b_per,
                         b_per - (blocks - 1) * BT}):
        assert (tile_count(nrows, p, NJ1) == 1).all()
        assert (tile_count(nrows, N, NJ2) == 1).all()


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_denoiser_covers_every_segment_once(geometry):
    """denoise_segments: lane group tid / G of G = min(last_pow2(M), 32)
    lanes takes items tid / G, tid / G + kThreads / G, ..., item -> (m, sg)
    = divmod(item, N / M) over the block's nrows trials, at flat offset
    item * M; lane tid % G of the group the segment's lanes tid % G,
    tid % G + G, ...: every lane of every segment once."""
    spec, b_per, _ = GEOMETRIES[geometry]
    cfg, N, _ = dims(spec)
    assert N % cfg.M == 0
    nseg = N // cfg.M
    nrows = min(BT, b_per)
    items = nrows * nseg
    G = 32 if cfg.M >= 32 else 1 << (cfg.M.bit_length() - 1)
    per = THREADS // G
    seen = np.concatenate([np.arange(tid // G, items, per)
                           for tid in range(0, THREADS, G)])
    m, sg = np.divmod(seen, nseg)
    assert (m * N + sg * cfg.M == seen * cfg.M).all()
    assert sorted(seen.tolist()) == list(range(items))
    lanes = [j for item in range(min(items, per)) for t in range(G)
             for j in range(item * cfg.M + t, (item + 1) * cfg.M, G)]
    assert sorted(lanes) == list(range(min(items, per) * cfg.M))


def loader_map(nj, factor_rows):
    """(thread, slot element) pairs of one ring slot, as product_tile's
    load() assigns them: the A tile a[k][m] and the B tile b[k][n]."""
    a, b = [], []
    for tid in range(THREADS):
        ly, lx = tid >> 4, tid & 15
        for c in range(BT // 16):
            a.append((tid, lx, ly + 16 * c))
        for c in range(nj):
            b.append((tid, lx, ly + 16 * c) if factor_rows
                     else (tid, ly, lx + 16 * c))
    return a, b


def wavefronts(addresses):
    """Shared-memory wavefronts of one warp's 8-byte accesses at float
    offsets ``addresses``: the most distinct 8-byte words on one bank."""
    words = {}
    for addr in set(addresses):
        for bank in (addr % 32, (addr + 1) % 32):
            words.setdefault(bank, set()).add(addr)
    return max(len(w) for w in words.values())


@pytest.mark.parametrize("nj,factor_rows", [(NJ1, True), (NJ2, False),
                                            (NJ1, False), (NJ2, True)])
def test_ring_slot_loaded_once_without_bank_conflicts(nj, factor_rows):
    bn = TX * nj
    a, b = loader_map(nj, factor_rows)
    assert sorted((k, m) for _, k, m in a) == [
        (k, m) for k in range(BK) for m in range(BT)]
    assert sorted((k, n) for _, k, n in b) == [
        (k, n) for k in range(BK) for n in range(bn)]
    stride_a, stride_b = 2 * (BT + PAD), 2 * (BN_MAX + PAD)
    for tiles, stride in ((a, stride_a), (b, stride_b)):
        per_instr = {}
        for idx, (tid, k, m) in enumerate(tiles):
            per_instr.setdefault((tid // 32, idx % (len(tiles) // THREADS)),
                                 []).append(k * stride + 2 * m)
        for addrs in per_instr.values():
            assert len(addrs) == 32
            # 32 x 8 bytes is two 128-byte wavefronts at best
            assert wavefronts(addrs) == 2
    # 16 consecutive threads on 16 consecutive 8-byte words of one row:
    # the device-memory side of each copy instruction is two 128-byte lines
    # (k along the rows of A, and of Vh when factor_rows; n otherwise)
    for tiles, along_k in ((a, True), (b, factor_rows)):
        per = len(tiles) // THREADS
        for idx0 in range(0, len(tiles), 32 * per):
            for c in range(per):
                half = [tiles[idx0 + per * t + c][1:] for t in range(32)]
                for h in (half[:16], half[16:]):
                    along = [x[0] if along_k else x[1] for x in h]
                    across = {x[1] if along_k else x[0] for x in h}
                    assert len(across) == 1
                    assert along == list(range(along[0], along[0] + 16))
                    assert along[0] % 16 == 0


def test_compute_reads_are_aligned_broadcasts():
    """A thread's kNI trials are kNI / 2 16-byte reads; a warp reads two
    distinct A addresses and 16 consecutive B words per k."""
    assert (BT + PAD) * 8 % 16 == 0 and (BN_MAX + PAD) * 8 % 16 == 0
    assert NI % 2 == 0
    for warp in range(THREADS // 32):
        tids = range(32 * warp, 32 * warp + 32)
        assert len({NI * (t // TX) for t in tids}) == 2
        for j in range(max(NJ1, NJ2)):
            assert wavefronts([2 * (t % TX + TX * j) for t in tids]) == 1


def test_carve_out_and_registers_fit_the_blocks_per_sm():
    stage = 8 * (BK * (BT + PAD) + BK * (BN_MAX + PAD))
    smem = STAGES * stage
    assert smem == 29696
    static = 8 * BT * 4   # the per-trial int and float arrays of K3 and K4
    for src in KERNELS.values():
        decl = re.findall(r"__shared__ (?:int|float) ([^;]+);", src)
        assert sum(len(d.split(",")) for d in decl) == 8
    assert smem + static <= BLOCK_SMEM
    assert MIN_BLOCKS * (smem + static + RESERVE) <= SM_SMEM
    # the registers under __launch_bounds__(256, kMinBlocks) hold the
    # chains and running sums (2 x 2 x kNI x NJ) and one k's operands
    cap = min(MAX_REGS, SM_REGS // (THREADS * MIN_BLOCKS))
    assert cap == 128
    need = 4 * NI * max(NJ1, NJ2) + 2 * (NI + max(NJ1, NJ2))
    assert need <= cap


def _f32(t):
    return t.float().double()


def blocked(ar, ai, br, bi, chain):
    """The engine's sum over k in float32, emulated in float64: chains of
    ``chain`` FMAs from zero (each FMA rounded once: a float32 product is
    exact in float64), added in k order to running sums that start at
    -0.  ``chain`` >= K is one chain over all of K."""
    R, K = ar.shape
    C = br.shape[1]
    sr = torch.full((R, C), -0.0, dtype=torch.float64)
    si = sr.clone()
    for k0 in range(0, K, chain):
        cr = torch.zeros((R, C), dtype=torch.float64)
        ci = cr.clone()
        for k in range(k0, min(k0 + chain, K)):
            a_r, a_i = ar[:, k, None], ai[:, k, None]
            b_r, b_i = br[None, k], bi[None, k]
            cr = _f32(a_r * b_r + cr)
            cr = _f32(-a_i * b_i + cr)
            ci = _f32(a_r * b_i + ci)
            ci = _f32(a_i * b_r + ci)
        sr, si = _f32(sr + cr), _f32(si + ci)
    return sr, si


@pytest.fixture(scope="module")
def main_operands():
    """Seeded rows at the main geometry: 6 trials' complex Gaussian rows
    for each product and the factor Vh of a main-shape dense channel."""
    cfg = Config(**MAIN, iterations=10)
    snr = 10 ** ((8.0 + 10 * math.log10(cfg.code_rate)) / 10)
    r = montecarlo.with_svd("vamp", montecarlo.generate_realization(
        make_generator(torch.device("cpu"), 5), cfg, "sparc", "dense", 2,
        snr))
    Vh = r.dec.Vh
    rng = np.random.default_rng(7)

    def rows(n):
        z = rng.standard_normal((6, n)) + 1j * rng.standard_normal((6, n))
        return torch.from_numpy((z / math.sqrt(2)).astype(np.complex64))

    p, N = Vh.shape
    # product 1: q = r_tilde Vh^T (K = N); product 2: x = w conj(Vh) (K = p)
    return {"product1": (rows(N), Vh.T.contiguous()),
            "product2": (rows(p), Vh.conj().resolve_conj().contiguous())}


@pytest.mark.parametrize("product", ["product1", "product2"])
def test_blocked_order_errs_no_more_than_chains_of_16(product,
                                                      main_operands):
    A, B = main_operands[product]
    ar, ai = A.real.double(), A.imag.double()
    br, bi = B.real.double(), B.imag.double()
    exact = A.to(torch.complex128) @ B.to(torch.complex128)

    def err(chain):
        sr, si = blocked(ar, ai, br, bi, chain)
        return torch.maximum((sr - exact.real).abs(),
                             (si - exact.imag).abs())

    new, old = err(BK), err(16)
    assert float(new.mean()) <= float(old.mean())
    assert float(new.max()) <= float(old.max())
    # the emulation sees the order: one chain over all of K rounds coarser
    single = err(A.shape[1])
    assert float(single.mean()) > float(old.mean())
