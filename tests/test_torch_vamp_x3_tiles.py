"""What the HIGH product engine of K3 and K4 (``vamp_common.cuh::
product_x3``, the bf16 x 3 tensor-core form of ``fused_vamp_decode.cu`` and
``fused_vamp2_decode.cu``) rests on, checked on the CPU: its warp and
fragment maps produce every output of a product exactly once, over the
tiles that cover the chip_smoke geometries; its shared-memory carve-out
(ring, k1 park, barriers) fits two blocks per SM; the swizzled rows that
the bulk copies bring in put every ldmatrix phase on distinct banks and
hand the mma the fragments it expects; the split operand and the
wrapper's tap tiles are laid out where the engine reads them; and running
the three Gauss products as three passes (k1, then k2, then k3, each
output's hi.hi and hi.lo + lo.hi accumulators joined at the end of its
pass) gives the same bits as running them at once; the DEFAULT form's
one pass (``product_x3<true>``, hi.hi alone on the same layout) is
``precision.dot1`` of the Gauss form.  The constants are read
from the source; the kernels themselves run only on the card
(``chip_smoke.py``)."""
import re

import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.ops import precision as prec
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import build
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_vamp

COMMON = (build.CSRC / "vamp_common.cuh").read_text()
KERNELS = {name: (build.CSRC / f"{name}.cu").read_text()
           for name in ("fused_vamp_decode", "fused_vamp2_decode")}


def constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", COMMON).group(1))


THREADS, BK, MIN_BLOCKS = (constant("kThreads"), constant("kBK"),
                           constant("kMinBlocks"))
BT = constant("kTy") * constant("kNI")
BN3, STAGES = constant("kBN3"), constant("kStagesX3")
NB3 = BN3 // 16            # n8 blocks of a warp (kNB3)
OUT3 = 4 * NB3             # a thread's outputs of one product (kOut3)
SPLIT_STEP = BT * 2 * BK   # bf16 of a split operand step (kSplitStep)
TAP_STEP = BN3 * 2 * BK    # bf16 of a tap tile step (kTapStep)
ROW = 2 * BK               # bf16 of an operand row: 16 hi, 16 lo

# An SM's shared memory and the part a block may take (CUDA reserves 1 KB
# per block); the kernels' static per-trial arrays (8 of kBt words).
SM_SMEM, BLOCK_SMEM, RESERVE = 228 * 1024, 232448, 1024
STATIC = 8 * BT * 4

SMALL = dict(Nt=16, Na=4, Nr=10, Lin=8, Lh=3, mode="segmented",
             profile="uniform", trunc="tail", alphabet="OOK")
MAIN = dict(Nt=128, Na=8, Nr=24, Lin=20, Lh=3, mode="segmented",
            alphabet="OOK", profile="uniform", trunc="tail")
FINAL = dict(Nt=128, Na=16, Nr=32, Lin=25, Lh=6, mode="segmented",
             alphabet="QPSK", profile="uniform", trunc="tail")
# chip_smoke.py's HIGH geometries (the small ones' alphabets change M, not
# the product shapes)
GEOMETRIES = {"main": MAIN, "vampfinal": FINAL, "small": SMALL,
              "small_8psk": dict(SMALL, alphabet="8PSK")}


def dims(spec):
    """(N, p): the columns of the adjoint and of the forward product."""
    cfg = Config(**spec)
    return cfg.N, min(cfg.n, cfg.N)


def x3_row(tid, e):
    warp, lane = tid >> 5, tid & 31
    return 16 * (warp & 3) + (lane >> 2) + 8 * (e >> 1)


def x3_col(tid, n0, j, e):
    warp, lane = tid >> 5, tid & 31
    return n0 + BN3 // 2 * (warp >> 2) + 8 * j + 2 * (lane & 3) + (e & 1)


def x3_chunk(c, n):
    return c ^ ((n >> 1) & 3)


def split_at(ksteps, o, m, k, h):
    return ((o * ksteps + (k >> 4)) * SPLIT_STEP + m * ROW
            + x3_chunk(2 * h + ((k & 15) >> 3), m) * 8 + (k & 7))


def tiles_of(ncols):
    return -(-ncols // BN3)


def test_constants_as_designed():
    assert (THREADS, BT, BK, MIN_BLOCKS) == (256, 64, 16, 2)
    assert BN3 == 96 and NB3 == 6 and OUT3 == 24 and STAGES == 4
    assert re.search(r"constexpr int kNB3 = kBN3 / 16;", COMMON)
    assert re.search(r"constexpr int kOut3 = 4 \* kNB3;", COMMON)
    assert re.search(r"constexpr int kSplitStep = kBt \* 2 \* kBK;", COMMON)
    assert re.search(r"constexpr int kTapStep = kBN3 \* 2 \* kBK;", COMMON)
    # the wrapper's mirrors of the block and tile sizes
    assert fused_vamp.BLOCK_TRIALS == BT and fused_vamp.TILE_COLS == BN3
    # both kernels run the HIGH (and DEFAULT) products on the engine,
    # nothing else
    for src in KERNELS.values():
        assert src.count("product_x3<kOne>(") == 2
        assert "product_tile_x3" not in src and "cp_async16" not in src


@pytest.mark.parametrize("name,ncols,tiles,before",
                         [("p", 528, 6, 17), ("N", 2560, 27, 80)])
def test_tiles_of_the_main_geometry(name, ncols, tiles, before):
    """Six 96-column tiles cover p = 528 and 27 cover N = 2560, where the
    32-column tiles of the all-at-once engine took 17 and 80."""
    N, p = dims(MAIN)
    assert {"p": p, "N": N}[name] == ncols
    assert tiles_of(ncols) == tiles
    assert -(-ncols // 32) == before
    # the trial side is read once per pass of each tile, 4 bytes an element
    # (hi and lo bf16), where the old engine read 8 (FP32) once per tile
    assert 3 * 4 * tiles < 8 * before


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("product", ["forward", "adjoint"])
def test_products_cover_every_output_once(geometry, product):
    """Each thread's pairs (e = 0, 1 and e = 2, 3: columns n, n + 1, n even)
    over every tile, as product_x3 hands them to the epilogues (a pair with
    n < ncols; its second column only if n + 1 < ncols): every (trial,
    column) of the block is written exactly once."""
    N, p = dims(GEOMETRIES[geometry])
    ncols = p if product == "forward" else N
    count = np.zeros((BT, ncols), dtype=np.int64)
    for t in range(tiles_of(ncols)):
        for tid in range(THREADS):
            for j in range(NB3):
                for e in (0, 2):
                    m, n = x3_row(tid, e), x3_col(tid, t * BN3, j, e)
                    assert x3_row(tid, e + 1) == m
                    assert x3_col(tid, t * BN3, j, e + 1) == n + 1
                    assert n % 2 == 0
                    if n >= ncols:
                        continue
                    count[m, n] += 1
                    if n + 1 < ncols:
                        count[m, n + 1] += 1
    assert (count == 1).all()


def test_warp_tiles_partition_the_block_tile():
    """Warp (warp % 4, warp / 4) owns 16 trials x 48 columns; its 32 lanes
    own the 16 x 48 outputs once each (the m16n8 accumulator layout)."""
    seen = {}
    for tid in range(THREADS):
        for j in range(NB3):
            for e in range(4):
                key = (x3_row(tid, e), x3_col(tid, 0, j, e))
                assert key not in seen
                seen[key] = tid >> 5
    assert sorted(seen) == [(m, n) for m in range(BT) for n in range(BN3)]
    for (m, n), warp in seen.items():
        assert (m // 16, n // (BN3 // 2)) == (warp & 3, warp >> 2)


def smem_layout():
    """Byte offsets of the SmemX3 fields: the ring's slots (trial side,
    then taps), the park, the barriers; the struct is 128-byte aligned."""
    stage = 2 * SPLIT_STEP + 2 * TAP_STEP
    assert stage % 128 == 0
    park = STAGES * stage
    full = park + 2 * OUT3 * THREADS * 4
    size = -(-(full + 8 * STAGES) // 128) * 128
    return stage, park, full, size


def test_carve_out_fits_two_blocks_per_sm():
    stage, park, full, size = smem_layout()
    assert stage == 10240 and park == 40960 and full == 90112
    assert size == 90240
    # the struct in the source is the one mirrored here
    assert re.search(r"struct __align__\(128\) StageX3 \{\s*"
                     r"__nv_bfloat16 a\[kSplitStep\];[^\n]*\n\s*"
                     r"__nv_bfloat16 b\[kTapStep\];", COMMON)
    assert re.search(r"struct __align__\(128\) SmemX3 \{\s*"
                     r"StageX3 st\[kStagesX3\];\s*"
                     r"float park\[2\]\[kOut3\]\[kThreads\];[^\n]*\n\s*"
                     r"unsigned long long full\[kStagesX3\];", COMMON)
    # the k1 park is 24 KB per value a thread parks (k1, then k1 + k2)
    assert OUT3 * THREADS * 4 == 24 * 1024
    assert size + STATIC <= BLOCK_SMEM
    assert MIN_BLOCKS * (size + STATIC + RESERVE) <= SM_SMEM
    # the bulk copies land on 16-byte boundaries, the barriers on 8
    assert all(x % 16 == 0 for x in (stage, 2 * SPLIT_STEP, park))
    assert full % 8 == 0


def banks(byte_addr):
    return {(byte_addr // 4 + i) % 32 for i in range(4)}


def ldmatrix_rows(warp, lane):
    """(A hi, A lo, B hi of pair q = 0, B lo of pair q = 0): the bf16
    offsets in a ring slot that lane ``lane`` of ``warp`` gives ldmatrix,
    as product_x3 computes them."""
    wm, wn = warp & 3, warp >> 2
    ar, ac = 16 * wm + (lane & 15), lane >> 4
    br = BN3 // 2 * wn + (lane & 7) + ((lane >> 4) << 3)
    bc = (lane >> 3) & 1
    b0 = SPLIT_STEP   # the taps follow the trial side in the slot
    return (ar * ROW + x3_chunk(ac, ar) * 8,
            ar * ROW + x3_chunk(ac + 2, ar) * 8,
            b0 + br * ROW + x3_chunk(bc, br) * 8,
            b0 + br * ROW + x3_chunk(bc + 2, br) * 8)


def decode(offset):
    """(operand, row, logical chunk) of a slot's bf16 offset."""
    side, off = ("a", offset) if offset < SPLIT_STEP else (
        "b", offset - SPLIT_STEP)
    row, phys = divmod(off, ROW)
    assert phys % 8 == 0
    return side, row, x3_chunk(phys // 8, row)


@pytest.mark.parametrize("q", range(NB3 // 2))
def test_ldmatrix_phases_hit_distinct_banks(q):
    """Each of the four 8-lane phases of every ldmatrix.x4 reads eight
    16-byte rows on 32 distinct banks; without the swizzle the 64-byte rows
    would put four rows on the same banks."""
    for warp in range(THREADS // 32):
        for which in range(4):
            for phase in range(4):
                addrs = []
                for lane in range(8 * phase, 8 * phase + 8):
                    off = ldmatrix_rows(warp, lane)[which]
                    if which >= 2:
                        off += q * 16 * ROW
                    addrs.append(2 * off)
                got = set()
                for a in addrs:
                    assert not banks(a) & got
                    got |= banks(a)
                assert len(got) == 32
    plain = [2 * (r * ROW) for r in range(8)]
    assert len(set().union(*map(banks, plain))) == 8


def test_ldmatrix_hands_the_mma_its_fragments():
    """Matrix i of the x4 reads (rows, logical chunk): A rows 0-7 / 8-15 of
    the warp's 16 at hi k 0-7, then at hi k 8-15 (the m16n8k16 A fragment
    a0..a3; lo two chunks further); taps columns 0-7 at k 0-7, 0-7 at
    k 8-15, 8-15 at k 0-7, 8-15 at k 8-15 (b0, b1 of n8 blocks 0 and 1)."""
    for warp in range(THREADS // 32):
        wm, wn = warp & 3, warp >> 2
        for i in range(4):
            lanes = range(8 * i, 8 * i + 8)
            for which, part in ((0, 0), (1, 1)):
                got = [decode(ldmatrix_rows(warp, ln)[which]) for ln in lanes]
                rows = [16 * wm + 8 * (i & 1) + r for r in range(8)]
                assert got == [("a", r, 2 * part + (i >> 1)) for r in rows]
            for which, part in ((2, 0), (3, 1)):
                got = [decode(ldmatrix_rows(warp, ln)[which]) for ln in lanes]
                cols = [BN3 // 2 * wn + 8 * (i >> 1) + r for r in range(8)]
                assert got == [("b", n, 2 * part + (i & 1)) for n in cols]


@pytest.mark.parametrize("ksteps", [1, 33, 160])
def test_split_operand_layout(ksteps):
    """split_at maps (operand, trial, k, part) one to one onto the block's
    3 ksteps kSplitStep bf16, each k16 step of an operand one contiguous
    4 KB block (one bulk copy), pairs (k, k + 1) 4-byte aligned."""
    o, m, k, h = np.meshgrid(np.arange(3), np.arange(BT),
                             np.arange(16 * ksteps), np.arange(2),
                             indexing="ij")
    off = split_at(ksteps, o, m, k, h)
    assert np.array_equal(np.sort(off.ravel()),
                          np.arange(3 * ksteps * SPLIT_STEP))
    step = (o * ksteps + k // 16)
    assert (off // SPLIT_STEP == step).all()
    assert (off[..., ::2, :] % 2 == 0).all()
    assert (off[..., 1::2, :] == off[..., ::2, :] + 1).all()
    # the wrapper's scratch holds each block's two operands
    for blocks, ldf, ldb in ((1024, 2560, 528), (3, 160, 112)):
        xs = fused_vamp.split_scratch(blocks, ldf, ldb, torch.device("cpu"))
        assert xs.dtype == torch.bfloat16
        assert xs.numel() == blocks * 3 * (ldf + ldb) // 16 * SPLIT_STEP


@pytest.mark.parametrize("geometry", ["main", "small"])
def test_tap_tiles_are_where_the_engine_reads(geometry):
    """high_taps lays each Gauss plane out as the engine's bulk copies read
    it: plane g's tile t, step s at ((g tiles + t) ksteps + s) kTapStep,
    row n's k at n 32 + x3_chunk(2 h + (k % 16) / 8, n) 8 + k % 8, the
    padding zero; the forward's planes, then the adjoint's."""
    N, p = dims(GEOMETRIES[geometry])
    rng = np.random.default_rng(3)
    vh = (rng.standard_normal((p, N)) + 1j * rng.standard_normal((p, N)))
    Vh = torch.from_numpy(vh.astype(np.complex64))
    taps, ldf, ldb = fused_vamp.high_taps(Vh)
    from amp_sparc_spatialmodulation_tpu_torch.models import vamp
    planes = vamp.gauss_taps(Vh)
    at = 0
    for direction, (ncols, ld) in enumerate(((p, ldf), (N, ldb))):
        ksteps, tiles = ld // 16, tiles_of(ncols)
        size = 3 * tiles * ksteps * TAP_STEP
        region = taps[at:at + size]
        seen = torch.zeros(size, dtype=torch.bool)
        for g in range(3):
            hi, lo = prec.split_bf16(planes[3 * direction + g].T.contiguous())
            n, k = np.meshgrid(np.arange(ncols), np.arange(hi.shape[1]),
                               indexing="ij")
            t, r = np.divmod(n, BN3)
            for h, part in ((0, hi), (1, lo)):
                off = (((g * tiles + t) * ksteps + k // 16) * TAP_STEP
                       + r * ROW + x3_chunk(2 * h + (k & 15) // 8, r) * 8
                       + (k & 7))
                off = torch.from_numpy(off)
                assert torch.equal(region[off], part)
                seen[off] = True
        assert not bool(region[~seen].float().any())
        at += size
    assert at == taps.numel()


def mma(acc, a, b):
    """An m16n8k16 pass emulated: a fixed function of the accumulator and
    the bf16 row and column (here their exact dot product added in float64
    and rounded once); the engine's claim is only that each output sees the
    same passes in the same order."""
    return (acc.astype(np.float64)
            + a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def split(x):
    hi, lo = prec.split_bf16(torch.from_numpy(np.ascontiguousarray(x)))
    return hi.float().numpy(), lo.float().numpy()


@pytest.fixture(scope="module")
def gauss_operands():
    """Seeded Gauss operands of one complex product: the trial side's a + b,
    a, b split into hi and lo, the three tap planes split; K = 48 (three
    k16 steps), 16 trials x 8 columns."""
    rng = np.random.default_rng(11)
    K, R, C = 48, 16, 8
    a, b = (rng.standard_normal((2, R, K)) * 3).astype(np.float32)
    taps = (rng.standard_normal((3, K, C))).astype(np.float32)
    ops = [(a + b).astype(np.float32), a, b]
    return [split(x) for x in ops], [split(t) for t in taps], K, ops, taps


def joint_order(xs, ts, K):
    """The all-at-once engine this one replaced: every k16 step runs all
    three products."""
    R, C = xs[0][0].shape[0], ts[0][0].shape[1]
    hh = [np.zeros((R, C), np.float32) for _ in range(3)]
    cx = [np.zeros((R, C), np.float32) for _ in range(3)]
    for k0 in range(0, K, 16):
        ks = slice(k0, k0 + 16)
        for g in range(3):
            (ah, al), (bh, bl) = xs[g], ts[g]
            hh[g] = mma(hh[g], ah[:, ks], bh[ks])
            cx[g] = mma(cx[g], ah[:, ks], bl[ks])
            cx[g] = mma(cx[g], al[:, ks], bh[ks])
    k = [hh[g] + cx[g] for g in range(3)]
    return k[0] - k[2], k[0] + k[1]


def pass_order(xs, ts, K, merged=False, one=False):
    """This engine: pass g over all of K, k1 parked, k1 + k2 beside it;
    ``merged`` sums hi.hi and hi.lo + lo.hi in one accumulator (the form
    that was not shipped); ``one`` is the DEFAULT form, hi.hi alone."""
    R, C = xs[0][0].shape[0], ts[0][0].shape[1]
    park = [None, None]
    for g in range(3):
        (ah, al), (bh, bl) = xs[g], ts[g]
        hh = np.zeros((R, C), np.float32)
        cx = np.zeros((R, C), np.float32)
        for k0 in range(0, K, 16):
            ks = slice(k0, k0 + 16)
            if merged:
                hh = mma(hh, ah[:, ks], bh[ks])
                hh = mma(hh, ah[:, ks], bl[ks])
                hh = mma(hh, al[:, ks], bh[ks])
                continue
            hh = mma(hh, ah[:, ks], bh[ks])
            if one:
                continue
            cx = mma(cx, ah[:, ks], bl[ks])
            cx = mma(cx, al[:, ks], bh[ks])
        k = hh if one else hh + cx
        if g == 0:
            park[0] = k
        elif g == 1:
            park[1] = park[0] + k
        else:
            return park[0] - k, park[1]


def test_pass_order_is_bit_identical_to_joint_order(gauss_operands):
    xs, ts, K, _, _ = gauss_operands
    cr, ci = joint_order(xs, ts, K)
    pr, pi = pass_order(xs, ts, K)
    assert np.array_equal(cr.view(np.uint32), pr.view(np.uint32))
    assert np.array_equal(ci.view(np.uint32), pi.view(np.uint32))
    # the emulation sees the order: one accumulator per output differs
    mr, mi = pass_order(xs, ts, K, merged=True)
    assert not (np.array_equal(cr, mr) and np.array_equal(ci, mi))


def test_pass_order_is_dot3_of_the_gauss_form(gauss_operands):
    """Against precision.dot3 on the same Gauss operands (re = k1 - k3,
    im = k1 + k2), the engine's passes agree to float32 rounding of the
    sums: within 1e-5 of the largest |k|."""
    xs, ts, K, ops, taps = gauss_operands
    pr, pi = pass_order(xs, ts, K)
    k = [prec.dot3(torch.from_numpy(x), torch.from_numpy(t)).numpy()
         for x, t in zip(ops, taps)]
    scale = max(float(np.abs(x).max()) for x in k)
    assert np.abs(pr - (k[0] - k[2])).max() <= 1e-5 * scale
    assert np.abs(pi - (k[0] + k[1])).max() <= 1e-5 * scale


def test_one_pass_is_dot1_of_the_gauss_form(gauss_operands):
    """The DEFAULT form's engine (``product_x3<true>``, instantiated by
    both kernels' DEFAULT instances): each pass hi.hi alone, parked as the
    HIGH form parks; against precision.dot1 on the same Gauss operands
    within 1e-5 of the largest |k|, and apart from the three passes."""
    assert "template <bool kOne = false, class Epi>" in COMMON
    for name, src in KERNELS.items():
        assert "product_x3<kOne>(" in src and "<true, true>" in src, name
    xs, ts, K, ops, taps = gauss_operands
    pr, pi = pass_order(xs, ts, K, one=True)
    k = [prec.dot1(torch.from_numpy(x), torch.from_numpy(t)).numpy()
         for x, t in zip(ops, taps)]
    scale = max(float(np.abs(x).max()) for x in k)
    assert np.abs(pr - (k[0] - k[2])).max() <= 1e-5 * scale
    assert np.abs(pi - (k[0] + k[1])).max() <= 1e-5 * scale
    hr, _ = pass_order(xs, ts, K)
    assert np.abs(pr - hr).max() > 1e-4 * scale
