"""What the DEFAULT form's product engine of K3 and K4 (``vamp_common.cuh::
product_x1``, reached through ``product_x3<true>`` by the DEFAULT instances
of ``fused_vamp_decode.cu`` and ``fused_vamp2_decode.cu``) and the
denoiser's lane-group map rest on, checked on the CPU: the wrapper's DEFAULT
tap tiles and the DEFAULT split operand hold the hi planes of the Gauss
taps and of the trial side where the engine reads them, with zero pads;
the 32-byte rows' swizzle puts every ldmatrix phase on distinct banks and
hands the mma the fragments it expects; the tiles cover every output once
at chip_smoke's geometries; the carve-out (ring, park, barriers) fits two
blocks per SM; the engine's step order gives the bits of the HIGH
engine's one pass (``product_x3<true>`` before it had an engine of its
own); and the denoiser's groups sum each segment in ``torch_sum``'s order,
bit for bit.  The constants are read from the source; the kernels
themselves run only on the card (``chip_smoke.py``)."""
import re

import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.models import vamp
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
BN1, STAGES = constant("kBNX1"), constant("kStagesX1")
SLOT_STEPS = constant("kSlotSteps")   # k16 steps of one ring slot
NB1 = BN1 // 16            # n8 blocks of a warp (kNB1)
OUT1 = 4 * NB1             # a thread's outputs of one product (kOut1)
SPLIT_STEP = BT * BK       # bf16 of a split operand step (kSplitStep1)
TAP_STEP = BN1 * BK        # bf16 of a tap tile step (kTapStep1)
ROW = BK                   # bf16 of an operand row: 16 hi

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
# chip_smoke.py's DEFAULT geometries (the small ones' alphabets change M,
# not the product shapes)
GEOMETRIES = {"main": MAIN, "vampfinal": FINAL, "small": SMALL,
              "small_8psk": dict(SMALL, alphabet="8PSK")}


def dims(spec):
    """(N, p): the columns of the adjoint and of the forward product."""
    cfg = Config(**spec)
    return cfg.N, min(cfg.n, cfg.N)


def x1_row(tid, e):
    warp, lane = tid >> 5, tid & 31
    return 16 * (warp & 3) + (lane >> 2) + 8 * (e >> 1)


def x1_col(tid, n0, j, e):
    warp, lane = tid >> 5, tid & 31
    return n0 + BN1 // 2 * (warp >> 2) + 8 * j + 2 * (lane & 3) + (e & 1)


def x1_chunk(c, n):
    return c ^ ((n >> 2) & 1)


def split1_at(ksteps, o, m, k):
    return ((o * ksteps + (k >> 4)) * SPLIT_STEP + m * ROW
            + x1_chunk((k & 15) >> 3, m) * 8 + (k & 7))


def tiles_of(ncols):
    return -(-ncols // BN1)


def test_constants_as_designed():
    assert (THREADS, BT, BK, MIN_BLOCKS) == (256, 64, 16, 2)
    assert BN1 == 96 and NB1 == 6 and OUT1 == 24
    assert STAGES == 4 and SLOT_STEPS == 3
    assert re.search(r"constexpr int kNB1 = kBNX1 / 16;", COMMON)
    assert re.search(r"constexpr int kOut1 = 4 \* kNB1;", COMMON)
    assert re.search(r"constexpr int kSplitStep1 = kBt \* kBK;", COMMON)
    assert re.search(r"constexpr int kTapStep1 = kBNX1 \* kBK;", COMMON)
    # the wrapper's mirror of the tile; the DEFAULT form reaches the engine
    # through product_x3<true>, both kernels launch it with its carve-out
    assert fused_vamp.DEFAULT_TILE_COLS == BN1
    # the source's static_assert: a warp's kBNX1 / 2 columns are ldmatrix.x4
    # pairs of n8 blocks and, for an odd count, one .x2
    assert re.search(r"static_assert\(kBNX1 % 16 == 0 && kStagesX1 >= 2 && "
                     r"kSlotSteps >= 1,", COMMON)
    assert BN1 % 16 == 0 and STAGES >= 2 and SLOT_STEPS >= 1
    assert re.search(r"if constexpr \(kOne\) \{\s*product_x1\(", COMMON)
    for src in KERNELS.values():
        assert "high == 2 ? kSmemBytesX1" in src
        assert "init_ring<kOne>(smx, ring);" in src
        assert src.count("store_split<kOne>(") == 1


@pytest.mark.parametrize("geometry,tiles_p,tiles_n",
                         [("main", 6, 27), ("vampfinal", 10, 34),
                          ("small", 2, 2), ("small_8psk", 2, 2)])
def test_tiles_of_the_geometries(geometry, tiles_p, tiles_n):
    """96-column tiles, as the HIGH engine's: six cover p = 528 and 27
    cover N = 2560; each pass of a tile reads the trial side once, 2 bytes
    an element (the HIGH form's 4), and K in slots of kSlotSteps steps, the
    last slot of a pass holding what is left."""
    N, p = dims(GEOMETRIES[geometry])
    assert (tiles_of(p), tiles_of(N)) == (tiles_p, tiles_n)
    if geometry == "main":
        assert (N, p) == (2560, 528)
        kf, kb = 2560 // 16, 528 // 16
        slots = [-(-k // SLOT_STEPS) for k in (kf, kb)]
        assert slots == [54, 11]
        # steps of the last slot of a pass, forward and adjoint
        assert [k - (s - 1) * SLOT_STEPS for k, s in zip((kf, kb), slots)] \
            == [1, 3]
        # a block and iteration's ring slots: 2,241 barriers, where the
        # layout of one step a slot took 5,553
        assert 3 * (tiles_p * slots[0] + tiles_n * slots[1]) == 1863
        one = tiles_p * N + tiles_n * p
        high = -(-p // 96) * N + -(-N // 96) * p
        assert 2 * one == 4 * high // 2


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("product", ["forward", "adjoint"])
def test_products_cover_every_output_once(geometry, product):
    """Each thread's pairs (e = 0, 1 and e = 2, 3: columns n, n + 1, n even)
    over every tile, as product_x1 hands them to the epilogues (a pair with
    n < ncols): every (trial, column) of the block is written once."""
    N, p = dims(GEOMETRIES[geometry])
    ncols = p if product == "forward" else N
    count = np.zeros((BT, ncols), dtype=np.int64)
    for t in range(tiles_of(ncols)):
        for tid in range(THREADS):
            for j in range(NB1):
                for e in (0, 2):
                    m, n = x1_row(tid, e), x1_col(tid, t * BN1, j, e)
                    assert x1_row(tid, e + 1) == m
                    assert x1_col(tid, t * BN1, j, e + 1) == n + 1
                    assert n % 2 == 0
                    if n >= ncols:
                        continue
                    count[m, n] += 1
                    if n + 1 < ncols:
                        count[m, n + 1] += 1
    assert (count == 1).all()


def test_warp_tiles_partition_the_block_tile():
    """Warp (warp % 4, warp / 4) owns 16 trials x kBNX1 / 2 columns; its
    lanes own them once each (the m16n8 accumulator layout, kNB1 n8
    blocks)."""
    seen = {}
    for tid in range(THREADS):
        for j in range(NB1):
            for e in range(4):
                key = (x1_row(tid, e), x1_col(tid, 0, j, e))
                assert key not in seen
                seen[key] = tid >> 5
    assert sorted(seen) == [(m, n) for m in range(BT) for n in range(BN1)]
    for (m, n), warp in seen.items():
        assert (m // 16, n // (BN1 // 2)) == (warp & 3, warp >> 2)


def smem_layout():
    """Byte offsets of the SmemX1 fields: the ring's slots (kSlotSteps
    trial-side steps, then as many tap steps), the park, the barriers; the
    struct is 128-byte aligned."""
    stage = SLOT_STEPS * (2 * SPLIT_STEP + 2 * TAP_STEP)
    assert stage % 128 == 0
    park = STAGES * stage
    full = park + 2 * OUT1 * THREADS * 4
    size = -(-(full + 8 * STAGES) // 128) * 128
    return stage, park, full, size


def test_carve_out_fits_two_blocks_per_sm():
    stage, park, full, size = smem_layout()
    assert stage == 15360 and park == 61440 and full == 110592
    assert size == 110720
    assert re.search(r"struct __align__\(128\) StageX1 \{\s*"
                     r"__nv_bfloat16 a\[kSlotSteps\]\[kSplitStep1\];[^\n]*\n"
                     r"\s*__nv_bfloat16 b\[kSlotSteps\]\[kTapStep1\];",
                     COMMON)
    assert re.search(r"struct __align__\(128\) SmemX1 \{\s*"
                     r"StageX1 st\[kStagesX1\];\s*"
                     r"float park\[2\]\[kOut1\]\[kThreads\];[^\n]*\n\s*"
                     r"unsigned long long full\[kStagesX1\];", COMMON)
    assert size + STATIC <= BLOCK_SMEM
    assert MIN_BLOCKS * (size + STATIC + RESERVE) <= SM_SMEM
    # a fifth slot would not fit two blocks
    assert MIN_BLOCKS * (size + stage + STATIC + RESERVE) > SM_SMEM
    # the source's bound is this one
    limit = int(re.search(r"static_assert\(kSmemBytesX1 <= (\d+),",
                          COMMON).group(1))
    assert size <= limit and MIN_BLOCKS * (limit + STATIC + RESERVE) <= SM_SMEM
    assert all(x % 16 == 0 for x in (stage, 2 * SPLIT_STEP, park))
    assert full % 8 == 0


def banks(byte_addr):
    return {(byte_addr // 4 + i) % 32 for i in range(4)}


def ldmatrix_rows(warp, lane):
    """(A, B of pair q = 0): the bf16 offsets in a ring slot that lane
    ``lane`` of ``warp`` gives ldmatrix, as product_x1 computes them (the
    .x2 of an odd last n8 block reads B's offset plus kNB1 // 2 x 16
    rows)."""
    wm, wn = warp & 3, warp >> 2
    ar, ac = 16 * wm + (lane & 15), lane >> 4
    br = BN1 // 2 * wn + (lane & 7) + ((lane >> 4) << 3)
    bc = (lane >> 3) & 1
    return (ar * ROW + x1_chunk(ac, ar) * 8,
            SPLIT_STEP + br * ROW + x1_chunk(bc, br) * 8)


def decode(offset):
    """(operand, row, logical chunk) of a slot's bf16 offset."""
    side, off = ("a", offset) if offset < SPLIT_STEP else (
        "b", offset - SPLIT_STEP)
    row, phys = divmod(off, ROW)
    assert phys % 8 == 0
    return side, row, x1_chunk(phys // 8, row)


def phases(which, q):
    """The 8-lane phases of one ldmatrix: four of the .x4 (A, B pairs q <
    kNB1 // 2), two of the .x2 of an odd last n8 block (lanes 0-15)."""
    return range(2 if which == 1 and q == NB1 // 2 else 4)


B_LOADS = range(-(-NB1 // 2))   # B's ldmatrix per step: pairs, odd last


@pytest.mark.parametrize("q", B_LOADS)
def test_ldmatrix_phases_hit_distinct_banks(q):
    """Each 8-lane phase of every ldmatrix reads eight 16-byte rows on 32
    distinct banks; without the swizzle the 32-byte rows would put rows n
    and n + 4 on the same banks."""
    for warp in range(THREADS // 32):
        for which in range(2):
            if which == 0 and q:
                continue
            for phase in phases(which, q):
                got = set()
                for lane in range(8 * phase, 8 * phase + 8):
                    off = ldmatrix_rows(warp, lane)[which]
                    if which:
                        off += q * 16 * ROW
                    assert not banks(2 * off) & got
                    got |= banks(2 * off)
                assert len(got) == 32
    plain = [2 * (r * ROW) for r in range(8)]
    assert len(set().union(*map(banks, plain))) == 16


def test_ldmatrix_hands_the_mma_its_fragments():
    """Matrix i of the .x4 reads (rows, logical chunk): A rows 0-7 / 8-15
    of the warp's 16 at k 0-7, then at k 8-15 (the m16n8k16 A fragment
    a0..a3); taps columns 0-7 at k 0-7, 0-7 at k 8-15, 8-15 at k 0-7, 8-15
    at k 8-15 (b0, b1 of n8 blocks 2q and 2q + 1); an .x2 of an odd last
    n8 block its 8 columns at k 0-7, then at k 8-15."""
    for warp in range(THREADS // 32):
        wm, wn = warp & 3, warp >> 2
        for i in range(4):
            lanes = range(8 * i, 8 * i + 8)
            got = [decode(ldmatrix_rows(warp, ln)[0]) for ln in lanes]
            rows = [16 * wm + 8 * (i & 1) + r for r in range(8)]
            assert got == [("a", r, i >> 1) for r in rows]
            for q in B_LOADS:
                if q == NB1 // 2 and i >= 2:
                    continue
                got = [decode(ldmatrix_rows(warp, ln)[1] + q * 16 * ROW)
                       for ln in lanes]
                cols = [BN1 // 2 * wn + 16 * q + 8 * (i >> 1) + r
                        for r in range(8)]
                assert got == [("b", n, i & 1) for n in cols]


@pytest.mark.parametrize("ksteps", [1, 33, 160])
def test_split_operand_layout(ksteps):
    """split1_at maps (operand, trial, k) one to one onto the block's 3
    ksteps kSplitStep1 bf16, each k16 step of an operand one contiguous 2 KB
    block (one bulk copy), pairs (k, k + 1) 4-byte aligned; the wrapper's
    DEFAULT scratch is half the HIGH one."""
    o, m, k = np.meshgrid(np.arange(3), np.arange(BT),
                          np.arange(16 * ksteps), indexing="ij")
    off = split1_at(ksteps, o, m, k)
    assert np.array_equal(np.sort(off.ravel()),
                          np.arange(3 * ksteps * SPLIT_STEP))
    assert (off // SPLIT_STEP == o * ksteps + k // 16).all()
    assert (off[..., ::2] % 2 == 0).all()
    assert (off[..., 1::2] == off[..., ::2] + 1).all()
    for blocks, ldf, ldb in ((1024, 2560, 528), (3, 160, 112)):
        cpu = torch.device("cpu")
        xs = fused_vamp.split_scratch(blocks, ldf, ldb, cpu, "default")
        high = fused_vamp.split_scratch(blocks, ldf, ldb, cpu, "high")
        assert xs.dtype == torch.bfloat16
        assert xs.numel() == blocks * 3 * (ldf + ldb) // 16 * SPLIT_STEP
        assert 2 * xs.numel() == high.numel()


def test_split_operand_holds_the_hi_planes():
    """The split the kernels write (store_split<true>: the bf16 hi of a + b
    summed in FP32, of a and of b, at split1_at) read back through the
    layout: the hi planes of precision.split_bf16 of the three Gauss
    operands, zeros in the pad columns (split_rows' zero pairs)."""
    rng = np.random.default_rng(5)
    K, ksteps = 37, 3
    x = (rng.standard_normal((BT, K)) + 1j * rng.standard_normal((BT, K))
         ).astype(np.complex64)
    a, b = x.real.astype(np.float32), x.imag.astype(np.float32)
    ops = [(a + b).astype(np.float32), a, b]
    xs = np.zeros(3 * ksteps * SPLIT_STEP, dtype=np.float32)
    for o, plane in enumerate(ops):
        pad = np.zeros((BT, 16 * ksteps), np.float32)
        hi_plane = prec.split_bf16(torch.from_numpy(plane))[0]
        pad[:, :K] = hi_plane.float().numpy()
        m, k = np.meshgrid(np.arange(BT), np.arange(16 * ksteps),
                           indexing="ij")
        xs[split1_at(ksteps, o, m, k)] = pad
    for o, plane in enumerate(ops):
        m, k = np.meshgrid(np.arange(BT), np.arange(16 * ksteps),
                           indexing="ij")
        back = xs[split1_at(ksteps, o, m, k)]
        hi = prec.split_bf16(torch.from_numpy(plane))[0].float().numpy()
        assert np.array_equal(back[:, :K], hi)
        assert not back[:, K:].any()


@pytest.mark.parametrize("geometry", ["main", "small", "vampfinal"])
def test_default_taps_are_where_the_engine_reads(geometry):
    """default_taps lays each Gauss plane's hi part out as the engine's
    bulk copies read it: plane g's tile t, step s at ((g tiles + t) ksteps
    + s) kTapStep1, row n's k at n 16 + x1_chunk((k % 16) / 8, n) 8 + k %
    8, the padding zero; the forward's planes, then the adjoint's; a stack
    of factors gives each factor's buffer."""
    N, p = dims(GEOMETRIES[geometry])
    rng = np.random.default_rng(3)
    vh = (rng.standard_normal((p, N)) + 1j * rng.standard_normal((p, N)))
    Vh = torch.from_numpy(vh.astype(np.complex64))
    taps, ldf, ldb = fused_vamp.default_taps(Vh)
    assert taps.dtype == torch.bfloat16
    assert (ldf, ldb) == (fused_vamp.padded_k(N), fused_vamp.padded_k(p))
    planes = vamp.gauss_taps(Vh)
    at = 0
    for direction, (ncols, ld) in enumerate(((p, ldf), (N, ldb))):
        ksteps, tiles = ld // 16, tiles_of(ncols)
        size = 3 * tiles * ksteps * TAP_STEP
        region = taps[at:at + size]
        seen = torch.zeros(size, dtype=torch.bool)
        for g in range(3):
            hi = prec.split_bf16(planes[3 * direction + g].T.contiguous())[0]
            n, k = np.meshgrid(np.arange(ncols), np.arange(hi.shape[1]),
                               indexing="ij")
            t, r = np.divmod(n, BN1)
            off = (((g * tiles + t) * ksteps + k // 16) * TAP_STEP
                   + r * ROW + x1_chunk((k & 15) // 8, r) * 8 + (k & 7))
            off = torch.from_numpy(off)
            assert torch.equal(region[off], hi)
            seen[off] = True
        assert not bool(region[~seen].float().any())
        at += size
    assert at == taps.numel()
    if geometry == "small":
        stack = fused_vamp.default_taps(torch.stack([Vh, Vh]))[0]
        assert torch.equal(stack[1], taps)
        # the form's taps: HIGH keeps its own layout
        assert fused_vamp.form_taps(Vh, "default")[0].numel() == taps.numel()
        assert torch.equal(fused_vamp.form_taps(Vh, "high")[0],
                           fused_vamp.high_taps(Vh)[0])


def test_chunk_order1_is_x1_chunk():
    where = fused_vamp.chunk_order1(24)
    for n in range(24):
        for c in range(2):
            assert int(where[n, c]) == x1_chunk(c, n)
            assert int(where[n, where[n, c]]) == c


def mma(acc, a, b):
    """An m16n8k16 pass emulated: a fixed function of the accumulator and
    the bf16 row and column (their exact dot product added in float64 and
    rounded once); the claim is only that each output sees the same passes
    in the same order."""
    return (acc.astype(np.float64)
            + a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def step_from_zero(acc, a, b):
    """A k16 step's mma from zero, then an FP32 add (both engines)."""
    return (acc + mma(np.zeros_like(acc), a, b)).astype(np.float32)


def hi(x):
    return prec.split_bf16(torch.from_numpy(np.ascontiguousarray(x)))[
        0].float().numpy()


def engine(ops, taps, cols, slot_steps=1):
    """An engine over column tiles of ``cols``: per tile, pass g over all of
    K in ring slots of ``slot_steps`` k16 steps (each step from zero, added
    in FP32), k1 parked, k1 + k2 beside it, re = k1 - k3."""
    K, C = taps[0].shape
    R = ops[0].shape[0]
    re = np.zeros((R, C), np.float32)
    im = np.zeros((R, C), np.float32)
    for n0 in range(0, C, cols):
        cs = slice(n0, min(n0 + cols, C))
        park = [None, None]
        for g in range(3):
            acc = np.zeros((R, cs.stop - n0), np.float32)
            for c0 in range(0, K, 16 * slot_steps):
                for k0 in range(c0, min(c0 + 16 * slot_steps, K), 16):
                    ks = slice(k0, k0 + 16)
                    acc = step_from_zero(acc, ops[g][:, ks],
                                         taps[g][ks, cs])
            if g == 0:
                park[0] = acc
            elif g == 1:
                park[1] = (park[0] + acc).astype(np.float32)
            else:
                re[:, cs] = park[0] - acc
                im[:, cs] = park[1]
    return re, im


@pytest.fixture(scope="module")
def gauss_operands():
    """Seeded hi parts of one complex product's Gauss operands: the trial
    side's a + b, a, b and the three tap planes; K = 80 (five k16 steps:
    a slot of three and a last of two), 16 trials x 200 columns (three
    96-column tiles, two of 176)."""
    rng = np.random.default_rng(17)
    K, R, C = 80, 16, 200
    a, b = (rng.standard_normal((2, R, K)) * 3).astype(np.float32)
    taps = rng.standard_normal((3, K, C)).astype(np.float32)
    ops = [(a + b).astype(np.float32), a, b]
    return [hi(x) for x in ops], [hi(t) for t in taps], ops, taps


@pytest.mark.parametrize("cols,slot_steps", [(96, 1), (176, 1), (112, 2)])
def test_engine_gives_the_one_pass_bits_of_the_high_layout(gauss_operands,
                                                           cols, slot_steps):
    """product_x1 (kBNX1 columns, kSlotSteps steps a slot) against the HIGH
    engine's one pass (96-column tiles, one step a slot: ``product_x3<true>``
    before the DEFAULT form had an engine of its own) and the variants
    timed (176 x 1, 112 x 2): each output's steps, passes and park are the
    same, so are its bits; a sum carried in one accumulator (the tensor
    cores' own) is not."""
    xs, ts, _, _ = gauss_operands
    r1, i1 = engine(xs, ts, BN1, SLOT_STEPS)
    r3, i3 = engine(xs, ts, cols, slot_steps)
    assert np.array_equal(r1.view(np.uint32), r3.view(np.uint32))
    assert np.array_equal(i1.view(np.uint32), i3.view(np.uint32))
    carried = [np.zeros_like(r1) for _ in range(3)]
    for g in range(3):
        for k0 in range(0, 80, 16):
            carried[g] = mma(carried[g], xs[g][:, k0:k0 + 16],
                             ts[g][k0:k0 + 16])
    assert not np.array_equal(carried[0] - carried[2], r1)


def test_engine_is_dot1_of_the_gauss_form(gauss_operands):
    """Against precision.dot1 on the same Gauss operands (re = k1 - k3, im
    = k1 + k2) within 1e-5 of the largest |k|."""
    xs, ts, ops, taps = gauss_operands
    pr, pi = engine(xs, ts, BN1)
    k = [prec.dot1(torch.from_numpy(x), torch.from_numpy(t)).numpy()
         for x, t in zip(ops, taps)]
    scale = max(float(np.abs(x).max()) for x in k)
    assert np.abs(pr - (k[0] - k[2])).max() <= 1e-5 * scale
    assert np.abs(pi - (k[0] + k[1])).max() <= 1e-5 * scale


# ---- the denoiser's lane groups (denoise_segments) -------------------------

def last_pow2(n):
    w = 1
    while 2 * w <= n:
        w *= 2
    return w


def torch_sum(v):
    """decode_common.cuh::torch_sum of float32 values v, one thread."""
    n = len(v)
    w = 32 if n >= 32 else last_pow2(n)
    f = np.float32
    lane = []
    for t in range(w):
        acc = [f(0)] * 4
        idx = t
        while idx + 3 * w < n:
            for i in range(4):
                acc[i] = f(acc[i] + v[idx + i * w])
            idx += 4 * w
        i = 0
        while i < 4 and idx < n:
            acc[i] = f(acc[i] + v[idx])
            i, idx = i + 1, idx + w
        lane.append(f(f(f(acc[0] + acc[1]) + acc[2]) + acc[3]))
    off = w // 2
    while off >= 1:
        for t in range(off):
            lane[t] = f(lane[t] + lane[t + off])
        off //= 2
    return lane[0]


def group_sum(v):
    """denoise_segments' sum of a segment: G = min(last_pow2(M), 32) lanes,
    lane t folds elements t, t + G, ... into accumulator s % 4 for its s-th
    element, then the shuffle tree (lane t + off into lane t)."""
    M = len(v)
    G = 32 if M >= 32 else last_pow2(M)
    f = np.float32
    lanes = []
    for t in range(G):
        acc = [f(0)] * 4
        for s, i in enumerate(range(t, M, G)):
            acc[s & 3] = f(acc[s & 3] + v[i])
        lanes.append(f(f(f(acc[0] + acc[1]) + acc[2]) + acc[3]))
    off = G // 2
    while off >= 1:
        # __shfl_down_sync: every lane reads lane + off (its own past G)
        lanes = [f(lanes[t] + lanes[t + off]) if t + off < G else
                 f(lanes[t] + lanes[t]) for t in range(G)]
        off //= 2
    return lanes[0]


@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 8, 12, 16, 24, 32, 40, 64,
                               100, 160])
def test_group_sum_is_torch_sum_bit_for_bit(M):
    rng = np.random.default_rng(M)
    for _ in range(20):
        v = np.exp(rng.standard_normal(M) * 8).astype(np.float32)
        assert group_sum(v).view(np.uint32) == torch_sum(v).view(np.uint32)


@pytest.mark.parametrize("nrows,N,M", [(64, 2560, 16), (64, 3200, 8),
                                       (37, 128, 4), (64, 60, 3),
                                       (5, 640, 64)])
def test_groups_cover_every_segment_once(nrows, N, M):
    """Round base of kThreads / G segments, thread tid in group tid / G:
    every (trial, segment) of the block has one group, and the groups of
    a warp's 32 lanes read consecutive elements where G = M."""
    G = 32 if M >= 32 else last_pow2(M)
    nseg, items = N // M, nrows * (N // M)
    per = THREADS // G
    count = np.zeros(items, np.int64)
    for base in range(0, items, per):
        for tid in range(0, THREADS, G):
            item = base + tid // G
            if item < items:
                count[item] += 1
    assert (count == 1).all()
    if G == M:
        base = 0
        elems = [(base + tid // G) * M + (tid & (G - 1))
                 for tid in range(32)]
        assert elems == list(range(32))
    assert re.search(r"const int G = M >= 32 \? 32 : decode::last_pow2\(M\);",
                     COMMON)
    assert re.search(r"const int per = kThreads / G;", COMMON)


@pytest.mark.parametrize("nrows,N", [(64, 2560), (37, 127), (1, 3)])
def test_split_pass_covers_every_pair_once(nrows, N):
    """for_each_split_pair's items (trial, pair) in kUnroll x kThreads
    rounds: every pair (k, k + 1), k even, of every trial once; the lone
    element of an odd row is marked last."""
    pairs = (N + 1) // 2
    items = nrows * pairs
    seen = np.zeros((nrows, N), np.int64)
    unroll = 4
    for i0 in range(0, items, unroll * THREADS):
        for tid in range(THREADS):
            for u in range(unroll):
                item = i0 + tid + u * THREADS
                if item >= items:
                    continue
                m, k = divmod(item, pairs)
                k *= 2
                seen[m, k] += 1
                if k + 1 < N:
                    seen[m, k + 1] += 1
                else:
                    assert N % 2 == 1 and k == N - 1
    assert (seen == 1).all()
    for src in KERNELS.values():
        assert src.count("for_each_split_pair<4, kOne>(") == 1
