"""The host-side mirrors of K1's one-pass path and of its split forms' FP32
chains (``fused_bamp_decode.cu``), checked on the CPU in a few seconds:

* ``fused_bamp.default_taps``: the hi halves of the eight Gauss planes laid
  out as one 16-byte A fragment per lane and k16 step, zero in every pad;
* the carve-out of the DEFAULT form (hi planes alone, half the HIGH form's
  split region) and of the six split forms (the HIGH form's, but for the
  mixed forms <3, 1> and <1, 3>: each chain's operands on their own
  planes, hi and lo for the three-pass chain, hi alone for the one-pass
  one, ``Form::plane_of``), their fit and threads, within 227 KB at both
  flagships and the test geometries; the mixed forms' tap buffers (the
  three-pass chain on ``high_taps``, the one-pass chain on
  ``default_taps``);
* the two-segment denoiser rounds (``pair_posterior``): each group's
  segments, two a round, then one, are the one-a-round loop's;
* the FP32 chains' register tiles (``fp32_pass`` / ``fp32_tiles``): the
  row tile chosen, every output once, the staged panels inside the split
  planes the form leaves dead and off the live ones;
* a NumPy emulation of the tiles' loop order (product by product, panels
  of KC steps, 4 steps a turn): each output's FMA chain runs over the
  contraction in order from zero on the same operands as the earlier
  per-column loop (``fp32_rows``), so the bits are the same.

The kernel itself is held against its plain versions on the card by
``chip_smoke.py`` (``kernels_bamp_default``, ``kernels_bamp_xmap``).
"""
import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu_torch.config import (
    Config, flagship_bamp_ook, flagship_bamp_qpsk)
from amp_sparc_spatialmodulation_tpu_torch.models import bamp
from amp_sparc_spatialmodulation_tpu_torch.ops import precision as prec
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
from amp_sparc_spatialmodulation_tpu_torch.ops.operators import (
    BandedOperator)

SMALL = dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, mode="segmented",
             profile="uniform")
GEOMETRIES = {
    "ook_flagship": flagship_bamp_ook,
    "qpsk_flagship": flagship_bamp_qpsk,
    "ook_trunc": lambda: Config(**SMALL, alphabet="OOK", trunc="trunc"),
    "8psk_tail": lambda: Config(**SMALL, alphabet="8PSK", trunc="tail"),
    "qpsk_lin32": lambda: Config(**dict(SMALL, Lin=32), alphabet="QPSK",
                                 trunc="tail"),
}
PAIRS = (("highest", "high"), ("highest", "default"), ("high", "default"),
         ("high", "highest"), ("default", "high"), ("default", "highest"))


def _op(cfg, seed=5):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((cfg.Lh, cfg.Nr, cfg.Nt))
         + 1j * rng.standard_normal((cfg.Lh, cfg.Nr, cfg.Nt))) / 8
    gains = rng.uniform(0.5, 1.5, (cfg.Lh, cfg.Lin))
    return BandedOperator(torch.tensor(h, dtype=torch.complex64),
                          torch.tensor(gains, dtype=torch.float32), cfg.Lin,
                          cfg.Lout, cfg.trunc)


@pytest.mark.parametrize("name", ["8psk_tail", "ook_trunc"])
def test_default_taps_are_the_hi_planes(name):
    """Lane (g, t) of a tile's k16 step holds the bf16 hi of rows g, g + 8
    and columns 2t, 2t + 1, 2t + 8, 2t + 9 (a0..a3), 16 bytes; the planes
    follow ``high_taps``' order; pads zero; the buffer is the hi words of
    ``high_taps``' fragments."""
    cfg = GEOMETRIES[name]()
    op = _op(cfg)
    taps, folded = fused_bamp.default_taps(op)
    assert taps.dtype == torch.bfloat16
    assert folded == fused_bamp.high_taps(op)[1]
    assert fused_bamp.instance_taps(op, "default")[0] is taps
    assert fused_bamp.instance_taps(op, "highest", "default")[0] is taps
    assert fused_bamp.instance_taps(op, "high", "default")[0] is (
        fused_bamp.high_taps(op)[0])
    assert fused_bamp.instance_taps(op, "default", "high")[0] is (
        fused_bamp.high_taps(op)[0])
    assert fused_bamp.instance_taps(op) == (None, False)
    t = bamp.gauss_taps(op)
    kx = fused_bamp.padded16(cfg.Nt)
    kz = fused_bamp.padded16(cfg.Lh * cfg.Nr)
    size = kx * kz
    planes = (t.s_a2, t.s_re, t.dmc, t.cpd, t.st_a2, t.st_re, t.amc, t.adm)
    assert taps.numel() == 8 * size
    for q, plane in enumerate(planes):
        A = plane.T.contiguous()
        R, K = A.shape
        Mt, Kt = (kz // 16, kx // 16) if q < 4 else (kx // 16, kz // 16)
        f = taps[q * size:(q + 1) * size].float().numpy().reshape(
            Mt, Kt, 32, 8)
        got = np.full((Mt * 16, Kt * 16), np.nan, np.float32)
        for lane in range(32):
            g, tt = divmod(lane, 4)
            for reg in range(4):
                row = g + 8 * (reg & 1)
                col = 2 * tt + 8 * (reg >> 1)
                for h in range(2):
                    got[row::16, col + h::16] = f[:, :, lane, 2 * reg + h]
        hi, _ = prec.split_bf16(A)
        np.testing.assert_array_equal(got[:R, :K], hi.float().numpy())
        assert not got[R:].any() and not got[:, K:].any()
    high = fused_bamp.high_taps(op)[0].reshape(-1, 2, 8)[:, 0]
    assert torch.equal(taps.reshape(-1, 8), high)


def _region(cfg, parts_all=2):
    return 2 * fused_bamp.high_split_elems(cfg) * parts_all // 2


def plane_of(o, pv, px):
    """The first plane of split operand o (csrc: ``Form::plane_of``):
    operand 0 (var, Zc) of the variance chain's ``pv`` planes, operands
    1.. of the xmap chain's ``px``."""
    return 0 if o == 0 else pv + (o - 1) * px


def _mixed_region(cfg, pv, px):
    """bf16 bytes of a mixed form's region: the forward's x side (var and
    the xmap chain's 1 or 3 operands) and, in the same place, the
    adjoint's 4 inputs."""
    nx = 2 if fused_bamp.real_x(cfg) else 4
    ld = fused_bamp.split_ld
    return 2 * max(plane_of(nx, pv, px) * cfg.Lin * ld(cfg.Nt),
                   plane_of(4, pv, px) * cfg.Lin * ld(cfg.Lh * cfg.Nr))


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_carve_outs_fits_and_threads(name):
    """DEFAULT: the FP32 planes and the split region's hi planes (half the
    HIGH form's region); the split forms with an FP32 chain: the HIGH
    form's; the mixed forms: each chain's planes (:func:`plane_of`); every
    form the HIGH form's threads; within 227 KB wherever the HIGH form
    fits."""
    cfg = GEOMETRIES[name]()
    nrp = -(-cfg.Nr // 4) * 4
    fp32 = 4 * (3 * cfg.Lin * cfg.Lh * nrp
                + (4 if fused_bamp.real_x(cfg) else 5) * cfg.N + 5 * cfg.n)
    high = fused_bamp.smem_bytes(cfg, "high")
    assert high == fp32 + _region(cfg)
    assert fused_bamp.smem_bytes(cfg, "default") == fp32 + _region(cfg, 1)
    assert fused_bamp.split_parts("default") == 1
    assert fused_bamp.split_parts("high") == 2
    for pair in PAIRS:
        smem = fused_bamp.smem_bytes(cfg, *pair)
        if fused_bamp.mixed(*pair):
            pv, px = fused_bamp.chain_parts(*pair)
            assert smem == fp32 + _mixed_region(cfg, pv, px) < high
            assert fused_bamp.fits(cfg, *pair)
        else:
            assert smem == high
            assert fused_bamp.fits(cfg, *pair) == fused_bamp.fits(cfg,
                                                                  "high")
        assert fused_bamp.split_parts(*pair) == (1 if "high" not in pair
                                                 else 2)
    assert fused_bamp.fits(cfg, "high") and fused_bamp.fits(cfg, "default")
    assert high <= fused_bamp.SMEM_LIMIT
    assert fused_bamp.high_threads(cfg) in (256, 512)


def test_carve_outs_at_the_flagships():
    """180,800 B (QPSK) and 82,880 B (OOK) for DEFAULT: neither flagship
    gains a block per SM (the OOK flagship already runs two), so DEFAULT
    keeps the HIGH form's 512 and 256 threads."""
    q, o = flagship_bamp_qpsk(), flagship_bamp_ook()
    assert fused_bamp.smem_bytes(q, "default") == 180800
    assert fused_bamp.smem_bytes(o, "default") == 82880
    assert fused_bamp.smem_bytes(q, "high") == 220800
    assert fused_bamp.smem_bytes(o, "high") == 96960
    assert 2 * (180800 + 1024) > fused_bamp.SM_SMEM
    assert 3 * (82880 + 1024) > fused_bamp.SM_SMEM
    assert fused_bamp.high_threads(q) == 512
    assert fused_bamp.high_threads(o) == 256


MIXED = (("high", "default"), ("default", "high"))


def test_mixed_forms_chain_parts():
    """Only <3, 1> and <1, 3> are mixed; each chain's planes: 2 for the
    'high' chain, 1 for the 'default' one; every other form keeps
    ``split_parts`` planes for every operand."""
    assert [p for p in PAIRS if fused_bamp.mixed(*p)] == list(MIXED)
    assert fused_bamp.chain_parts("high", "default") == (2, 1)
    assert fused_bamp.chain_parts("default", "high") == (1, 2)
    for pair in PAIRS + (("high", None), ("default", None)):
        if not fused_bamp.mixed(*pair):
            n = fused_bamp.split_parts(*pair)
            assert fused_bamp.chain_parts(*pair) == (n, n)


@pytest.mark.parametrize("pair", MIXED)
@pytest.mark.parametrize("real", [True, False])
def test_mixed_forms_planes_tile_the_region(pair, real):
    """The operands' planes follow each other without gap or overlap (hi
    then lo where a chain runs three passes), the forward's x side and the
    adjoint's inputs each within the region; with equal parts the uniform
    layout ``kParts o + part``."""
    pv, px = fused_bamp.chain_parts(*pair)
    nx = 2 if real else 4
    for n_ops in (nx, 4):
        planes = [plane_of(o, pv, px) + part for o in range(n_ops)
                  for part in range(pv if o == 0 else px)]
        assert planes == list(range(plane_of(n_ops, pv, px)))
    for k in (1, 2):
        assert [plane_of(o, k, k) for o in range(5)] == [k * o
                                                         for o in range(5)]


def test_mixed_carve_outs_at_the_flagships():
    """<3, 1>: 190,800 B (QPSK) and 86,400 B (OOK); <1, 3>: 210,800 B and
    93,440 B, against the HIGH form's 220,800 and 96,960; neither gains a
    block per SM, so both keep the HIGH form's threads."""
    q, o = flagship_bamp_qpsk(), flagship_bamp_ook()
    assert fused_bamp.smem_bytes(q, *MIXED[0]) == 190800
    assert fused_bamp.smem_bytes(o, *MIXED[0]) == 86400
    assert fused_bamp.smem_bytes(q, *MIXED[1]) == 210800
    assert fused_bamp.smem_bytes(o, *MIXED[1]) == 93440
    assert 2 * (190800 + 1024) > fused_bamp.SM_SMEM
    assert 3 * (86400 + 1024) > fused_bamp.SM_SMEM


def test_mixed_forms_read_both_tap_buffers():
    """The launch of a mixed form passes the three-pass chain's
    ``high_taps`` as ``taps`` and the one-pass chain's ``default_taps`` as
    ``taps1`` (the hi words of the same fragments); the kernel picks a
    chain's buffer and words by its planes (``Form::taps_of``)."""
    cfg = flagship_bamp_ook()
    op = _op(cfg)
    high, _ = fused_bamp.high_taps(op)
    one, _ = fused_bamp.default_taps(op)
    for pair in MIXED:
        assert fused_bamp.instance_taps(op, *pair)[0] is high
    assert torch.equal(one.reshape(-1, 8), high.reshape(-1, 2, 8)[:, 0])
    src = (fused_bamp.build.CSRC / "fused_bamp_decode.cu").read_text()
    assert "kMixed && (v ? kVParts : kXParts) == 1 ? p.taps1 : p.taps" in src
    assert ("split && high && xhigh && taps1 == nullptr" in src)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("nq", [3, 4])
def test_fused_one_pass_products_are_the_separate_sums(nq, seed):
    """The mixed forms' one-pass chain (``one_pass_products<3>``, products
    q0 = 1 .. nq-1: two for a real x, three for a complex one) issues every
    product's mma of a k16 step before the next step, where high_pass<true>
    ran the products one after another; each accumulator still sums its
    own product's steps in order from zero, so every sum is the same bit
    for bit, and the epilogues run in the order 1 .. nq-1 (k1 parked in its
    slot before the products that read it)."""
    rng = np.random.default_rng(10 * nq + seed)
    a = rng.standard_normal((nq, 16, 128)).astype(np.float32)
    b = rng.standard_normal((nq, 128, 8)).astype(np.float32)
    alone, order = {}, []
    for q in range(1, nq):
        acc = np.zeros((16, 8), np.float32)
        for k in range(0, 128, 16):
            acc = acc + a[q][:, k:k + 16] @ b[q][k:k + 16]
        alone[q] = acc
    fused = {q: np.zeros((16, 8), np.float32) for q in range(1, nq)}
    for k in range(0, 128, 16):
        for q in fused:
            fused[q] = fused[q] + a[q][:, k:k + 16] @ b[q][k:k + 16]
    for q in fused:
        order.append(q)
        assert np.array_equal(fused[q], alone[q])
    assert order == list(range(1, nq)) and len(order) <= 3


def test_one_pass_products_in_the_source():
    """The mixed forms' one-pass chain runs its products in one k16 loop
    (forward and adjoint), switched by kFuseOnePass; the DEFAULT form and
    the other forms keep high_pass."""
    src = (fused_bamp.build.CSRC / "fused_bamp_decode.cu").read_text()
    assert "constexpr bool kFuseOnePass = true;" in src
    assert src.count("one_pass_products<3>(") == 2
    assert src.count("if constexpr (F::kMixed && kXP == 1 && "
                     "kFuseOnePass)") == 2
    assert "one_pass_products<" not in src.split(
        "if constexpr (kVP == kXP) {")[1].split("} else {")[0]


# ---- the FP32 chains --------------------------------------------------

def cols_of(kQ):
    """fp32_pass's tile columns: 4 in a pass of several products, 2 in a
    pass of one."""
    return 4 if kQ > 1 else 2


def row_tile(rows, ncols, threads, kC=2):
    """fp32_pass's row tile kR of 5, 4 or 3: fewest rounds x kR, ties to
    the larger."""
    cost = lambda kR: -(-(-(-rows // kR) * (ncols // kC)) // threads) * kR  # noqa: E731,E501
    kR = 5
    for c in (4, 3):
        if cost(c) < cost(kR):
            kR = c
    return kR


def panel_steps(floats, ncols, K):
    """KC: two panels of one plane's KC steps x ncols floats fit, a
    multiple of 4, at most K."""
    return min((floats // (2 * ncols)) & ~3, K)


def chains(cfg):
    """The FP32 passes of each split form with a chain at 'highest' at
    ``cfg``: (pair, side, kQ, ncols, K) with side 'forward' or 'adjoint'
    and the chain ('var' or 'xmap')."""
    real = fused_bamp.real_x(cfg)
    W = cfg.Lh * cfg.Nr
    out = []
    for v, x in PAIRS:
        if v == "highest":
            out += [((v, x), "forward", "var", 1, W, cfg.Nt),
                    ((v, x), "adjoint", "var", 1, cfg.Nt, W)]
        if x == "highest":
            out += [((v, x), "forward", "xmap", 2 if real else 3, W, cfg.Nt),
                    ((v, x), "adjoint", "xmap", 3, cfg.Nt, W)]
    return out


def stage_range(cfg, pair, side, chain):
    """The bf16 offsets [lo, hi) of the split region that the FP32 chain's
    sum plane and panels may use, and the live planes [(lo, hi), ...] the
    other chain reads, as forward_high / adjoint_high take them."""
    parts = fused_bamp.split_parts(*pair)
    real = fused_bamp.real_x(cfg)
    ld = fused_bamp.split_ld(cfg.Nt if side == "forward" else cfg.Lh * cfg.Nr)
    plane = cfg.Lin * ld
    end = fused_bamp.high_split_elems(cfg)
    nops = 2 if side == "forward" and real else 4
    if chain == "xmap":
        return (parts * plane, end), [(0, parts * plane)]
    a, b = (0, parts * plane), (parts * nops * plane, end)
    live = [(parts * plane, parts * nops * plane)]
    return (a if a[1] - a[0] >= b[1] - b[0] else b), live


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_fp32_tiles_cover_every_output_once(name):
    """Every split form's FP32 pass at ``name``: the row tile's items on
    the block's threads cover every (row, column) once; the staged region
    holds the sum plane and two panels of at least 4 steps, inside the
    split region and off the other chain's planes."""
    cfg = GEOMETRIES[name]()
    threads = fused_bamp.high_threads(cfg)
    for pair, side, chain, kQ, ncols, K in chains(cfg):
        rows, kC = cfg.Lin, cols_of(kQ)
        kR = row_tile(rows, ncols, threads, kC)
        cg = ncols // kC
        items = -(-rows // kR) * cg
        seen = np.zeros((rows, ncols), int)
        for item in range(items):
            g, c0 = divmod(item, cg)
            for i in range(kR):
                if g * kR + i < rows:
                    seen[g * kR + i, kC * c0:kC * c0 + kC] += 1
        assert (seen == 1).all(), (pair, side, chain)
        (lo, hi), live = stage_range(cfg, pair, side, chain)
        assert 0 <= lo <= hi <= fused_bamp.high_split_elems(cfg)
        assert all(hi <= a or lo >= b for a, b in live)
        floats = (hi - -(-lo // 8) * 8) // 2
        if chain == "xmap" and (kQ == 3):
            S = (cfg.N if side == "forward"
                 else cfg.Lin * cfg.Lh * fused_bamp.scratch_row(cfg))
            floats -= -(-S // 4) * 4
        KC = panel_steps(floats, ncols, K)
        assert KC >= 4 and KC % 4 == 0, (pair, side, chain, KC)


def test_fp32_tiles_at_the_flagships():
    """The row tiles and panels the flagships run.  A pass of one product
    (2 columns a thread): QPSK (512 threads) 5 rows for the forward's 192
    columns (480 items), 4 for the adjoint's 128 (448); OOK (256 threads)
    3 for the forward's 72 (252), 5 for the adjoint's 128 (256).  A pass
    of several (4 columns): 3 rows everywhere (QPSK 432 and 288 items, OOK
    126 and 224).  (default, highest)'s panels 36 and 48 steps at QPSK."""
    q, o = flagship_bamp_qpsk(), flagship_bamp_ook()
    assert row_tile(25, 192, 512) == 5
    assert row_tile(25, 128, 512) == 4
    assert row_tile(20, 72, 256) == 3
    assert row_tile(20, 128, 256) == 5
    assert row_tile(25, 192, 512, 4) == 3
    assert row_tile(25, 128, 512, 4) == 3
    assert row_tile(20, 72, 256, 4) == 3
    assert row_tile(20, 128, 256, 4) == 3
    got = {}
    for pair, side, chain, kQ, ncols, K in chains(q):
        (lo, hi), _ = stage_range(q, pair, side, chain)
        floats = (hi - lo) // 2
        if chain == "xmap":
            floats -= (q.N if side == "forward"
                       else q.Lin * q.Lh * fused_bamp.scratch_row(q))
        got[(pair, side)] = panel_steps(floats, ncols, K)
    assert got[(("default", "highest"), "forward")] == 36
    assert got[(("default", "highest"), "adjoint")] == 48
    assert all(v >= 16 for v in got.values()), got
    assert o.Nt % 4 == 0 and o.Nr % 4 == 0


def fmaf(x, a, acc):
    """fmaf on float32 operands (the product exact in float64, one
    rounding of the sum but for the rare double rounding, the same in
    both emulations)."""
    return (x.astype(np.float64) * a + acc).astype(np.float32)


def chain_rows(x, a, rows, rs, L1, ls, L2):
    """fp32_rows' order (the earlier loop): out[c, j] = fmaf over l, m."""
    ncols = a.shape[1]
    out = np.zeros((rows, ncols), np.float32)
    for c in range(rows):
        acc = np.zeros(ncols, np.float32)
        for l in range(L1):
            for m in range(L2):
                acc = fmaf(np.float32(x[c * rs + l * ls + m]),
                           a[l * L2 + m], acc)
        out[c] = acc
    return out


def chain_tiles(xs, planes, rows, rs, K, kR, KC, kC=2):
    """fp32_tiles' order: per item (row group, kC columns), product by
    product, per panel of KC steps, per 4 steps, step by step, row by row:
    acc[q][i][c] = fmaf(x_q[row_i + k], A_q[k, j0 + c], acc)."""
    kQ, ncols = len(planes), planes[0].shape[1]
    out = [np.full((rows, ncols), np.nan, np.float32) for _ in range(kQ)]
    for g in range(-(-rows // kR)):
        row = [min(g * kR + i, rows - 1) * rs for i in range(kR)]
        for j0 in range(0, ncols, kC):
            acc = np.zeros((kQ, kR, kC), np.float32)
            for q in range(kQ):
                for k0 in range(0, K, KC):
                    for kk in range(0, min(KC, K - k0), 4):
                        xv = [xs[q][r + k0 + kk:r + k0 + kk + 4] for r in row]
                        for st in range(4):
                            t = planes[q][k0 + kk + st, j0:j0 + kC]
                            for i in range(kR):
                                acc[q, i] = fmaf(np.float32(xv[i][st]), t,
                                                 acc[q, i])
            for q in range(kQ):
                for i in range(kR):
                    if g * kR + i < rows:
                        out[q][g * kR + i, j0:j0 + kC] = acc[q, i]
    return out


@pytest.mark.parametrize("side,kR,KC,kC", [("forward", 5, 12, 4),
                                           ("adjoint", 4, 8, 4),
                                           ("forward", 3, 4, 2)])
def test_fp32_tile_order_gives_the_parents_bits(side, kR, KC, kC):
    """The complex xmap chain at a small geometry (Lin 7, Nt 24, Lh 3, Nr
    8): the tiles' three products, x_0 the sum plane formed once, equal the
    earlier loop's, whose k1 operand was the same FP32 sum formed at every
    FMA, bit for bit."""
    rng = np.random.default_rng(17)
    Lin, Nt, Lh, Nr = 7, 24, 3, 8
    if side == "forward":
        K, ncols, rs, L1, ls, L2 = Nt, Lh * Nr, Nt, 1, 0, Nt
    else:
        K, ncols, rs, L1, ls, L2 = Lh * Nr, Nt, Lh * Nr, Lh, Nr, Nr
    re = rng.standard_normal(Lin * rs).astype(np.float32)
    im = rng.standard_normal(Lin * rs).astype(np.float32)
    planes = [rng.standard_normal((K, ncols)).astype(np.float32)
              for _ in range(3)]
    sum_plane = (re + im).astype(np.float32)
    tiles = chain_tiles([sum_plane, re, im], planes, Lin, rs, K, kR, KC, kC)
    parent = [chain_rows(np.asarray(x, np.float32), planes[q], Lin, rs, L1,
                         ls, L2)
              for q, x in enumerate(([re[i] + im[i] for i in range(re.size)],
                                     re, im))]
    for q in range(3):
        np.testing.assert_array_equal(tiles[q], parent[q])



def segment_rounds(nseg, groups, pair):
    """The denoiser's rounds of each group g: segments g, g + groups, ...,
    two a round (pair_posterior) while two remain, then one."""
    out = []
    for g in range(groups):
        segs, rounds = list(range(g, nseg, groups)), []
        while pair and len(segs) >= 2:
            rounds.append(tuple(segs[:2]))
            segs = segs[2:]
        rounds += [(s,) for s in segs]
        out.append(rounds)
    return out


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_pair_rounds_take_each_segment_once(name):
    """At every geometry, the pair rounds give each group the segments the
    one-a-round loop gives it, each once; at the flagships the rounds fall
    from 7 to 4 (QPSK: 400 segments of 8 on 64 groups) and from 10 to 5
    (OOK: 160 segments of 16 on 16 groups)."""
    cfg = GEOMETRIES[name]()
    threads = fused_bamp.high_threads(cfg)
    G = min(32, 1 << (cfg.M.bit_length() - 1))
    nseg, groups = cfg.N // cfg.M, threads // G
    one = segment_rounds(nseg, groups, False)
    two = segment_rounds(nseg, groups, G == cfg.M)
    for a, b in zip(one, two):
        assert sorted(s for r in b for s in r) == [s for r in a for s in r]
    if name == "qpsk_flagship":
        assert (max(map(len, one)), max(map(len, two))) == (7, 4)
    if name == "ook_flagship":
        assert (max(map(len, one)), max(map(len, two))) == (10, 5)

