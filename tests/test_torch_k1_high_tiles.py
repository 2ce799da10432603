"""The host-side mirrors of K1's HIGH form (``fused_bamp_decode.cu``, the
``kHigh`` instances) checked on the CPU:

* its shared memory is that of the earlier form (a copy of the earlier
  formula is kept here), and it fits wherever its planes fit one block:
  where the earlier form fit (at most 32 column blocks), and past that;
* the rule that picks the block (``fused_bamp.high_threads``): 16 warps
  where one block fills an SM's shared memory, else 8 warps and two blocks
  per SM, 128 registers a thread either way;
* the units of each pass (mirrored here from ``high_pass``): every
  (16-row tile, n8 tile) of a product once, spread over the warps, no
  unit over more than four n8 tiles (kMaxNT: at Lin 33-48, five or six
  n8 tiles, a tile takes two units at least), and at Lin <= 32 the units
  of the earlier rule;
* the tap fragments the wrapper lays out (``high_taps``): the bf16 split of
  ``bamp.gauss_taps``'s planes, zero in every pad;
* the B fragment words a lane reads from the split operands: those the
  mma takes, the 32 lanes' words of a load on 32 banks;
* a NumPy mirror of the engine (units, the products one after another, k1
  parked in the forward's P_re slot and in the adjoint's xmap_re, 1/cov in
  cov) equal to the Gauss combinations of whole products;
* the DEFAULT form (the ``kOne`` instances, one bf16 pass): the HIGH
  form's block on half its split region (hi planes alone), its tap loads
  one hi word a fragment, and its pass the hi hi products alone (its own
  tiles in ``test_torch_k1_default_tiles.py``).

The kernel itself is held against its plain HIGH version on the card by
``chip_smoke.py`` (``kernels_bamp_high``).
"""
import dataclasses
import itertools

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
# chip_smoke.py's kernels_bamp_high geometries, both flagships at Lin = 32,
# 40 and 48, and the small QPSK geometry at Lin 33 and 48
GEOMETRIES = {
    "ook_tail": dict(SMALL, alphabet="OOK", trunc="tail"),
    "ook_trunc": dict(SMALL, alphabet="OOK", trunc="trunc"),
    "ook_cyclic": dict(SMALL, alphabet="OOK", trunc="cyclic"),
    "qpsk_tail": dict(SMALL, alphabet="QPSK", trunc="tail"),
    "8psk_tail": dict(SMALL, alphabet="8PSK", trunc="tail"),
    "ook_m6": dict(SMALL, alphabet="OOK", trunc="tail", Nt=24),
    "random_qpsk": dict(SMALL, alphabet="QPSK", trunc="tail",
                        mode="random"),
    "qpsk_lin32": dict(SMALL, alphabet="QPSK", trunc="tail", Lin=32),
    "qpsk_lin33": dict(SMALL, alphabet="QPSK", trunc="tail", Lin=33),
    "ook_lin48": dict(SMALL, alphabet="OOK", trunc="trunc", Lin=48),
}
FLAGSHIPS = {"ook_flagship": flagship_bamp_ook, "qpsk_flagship":
             flagship_bamp_qpsk}


def config(name: str) -> Config:
    if name in FLAGSHIPS:
        return FLAGSHIPS[name]()
    return Config(**GEOMETRIES[name])


WIDE = [f"{f}_lin{lin}" for f in FLAGSHIPS for lin in (32, 40, 48)]
NAMES = list(GEOMETRIES) + list(FLAGSHIPS) + WIDE


def _config(name: str) -> Config:
    if name in WIDE:
        flag, lin = name.rsplit("_lin", 1)
        return dataclasses.replace(config(flag), Lin=int(lin))
    return config(name)


# n8 tiles a unit of a HIGH pass spans at most (csrc: kMaxNT)
MAX_NT = 4


def high_parts(mtiles: int, warps: int, NT: int) -> int:
    """Ranges of its ``NT`` n8 tiles that each 16-row tile of a HIGH pass
    is cut into (csrc: ``high_parts``): as many as the block has warps
    per tile, at least 1, at most NT, and at least as many as keep each
    range within ``MAX_NT`` tiles."""
    return max(parent_high_parts(mtiles, warps, NT), -(-NT // MAX_NT))


def parent_high_parts(mtiles: int, warps: int, NT: int) -> int:
    """The earlier rule, for at most 32 column blocks (NT <= 4)."""
    return max(1, min(NT, warps // mtiles))


def high_units(cfg: Config, threads: int):
    """The units of the HIGH passes at ``cfg`` with blocks of ``threads``,
    as ``high_pass`` hands them out: per pass (``'forward'``,
    ``'adjoint'``) the list of (tile, first n8 tile, end n8 tile) of each
    warp, in the order the warp runs them (units w, w + warps, ...)."""
    warps = threads // 32
    NT = -(-cfg.Lin // 8)
    out = {}
    for name, rows in (("forward", fused_bamp.padded16(cfg.Lh * cfg.Nr)),
                       ("adjoint", fused_bamp.padded16(cfg.Nt))):
        mtiles = rows // 16
        parts = high_parts(mtiles, warps, NT)
        units = mtiles * parts
        out[name] = [[(u // parts, u % parts * NT // parts,
                       (u % parts + 1) * NT // parts)
                      for u in range(w, units, warps)]
                     for w in range(warps)]
    return out


def parent_smem_high(cfg: Config) -> int:
    """The HIGH form's shared memory as the earlier form computed it: the
    FP32 planes (3 scratch planes of (Lin, Lh, Nr rounded up to 4), 4 or 5
    x-side planes, 5 y-side planes) and the split region."""
    real = bool(np.all(np.asarray(cfg.symbols).imag == 0))
    nrp = -(-cfg.Nr // 4) * 4
    fp32 = 4 * (3 * cfg.Lin * cfg.Lh * nrp + (4 if real else 5) * cfg.N
                + 5 * cfg.n)
    ld = lambda k: -(-k // 16) * 16 + 8  # noqa: E731
    nx = 2 if real else 4
    split = max(2 * nx * cfg.Lin * ld(cfg.Nt),
                8 * cfg.Lin * ld(cfg.Lh * cfg.Nr))
    return fp32 + 2 * split


def parent_fits_high(cfg: Config) -> bool:
    """The earlier fit: the planes in one block and at most 32 column
    blocks."""
    return parent_smem_high(cfg) <= 232448 and cfg.Lin <= 32


def fits_high(cfg: Config) -> bool:
    """The fit now: the planes in one block, any number of column
    blocks."""
    return parent_smem_high(cfg) <= 232448


# the geometries whose HIGH block passes the shared memory
TOO_BIG = {"qpsk_flagship_lin32", "qpsk_flagship_lin40",
           "qpsk_flagship_lin48"}


@pytest.mark.parametrize("name", NAMES)
def test_smem_and_fit_as_before(name):
    cfg = _config(name)
    assert fused_bamp.smem_bytes(cfg, "high") == parent_smem_high(cfg)
    assert fused_bamp.fits(cfg, "high") == fits_high(cfg)
    if cfg.Lin <= 32:
        assert fused_bamp.fits(cfg, "high") == parent_fits_high(cfg)
    assert fused_bamp.fits(cfg, "high") == (name not in TOO_BIG)


def test_fit_as_before_over_a_grid():
    """Every geometry of a grid around the repo's configs fits at 'high'
    exactly where the earlier form fit at up to 32 column blocks, and
    where its planes fit one block past that."""
    n = wide = 0
    for Nt, Nr, Lin, Lh, alphabet in itertools.product(
            (16, 24, 32, 64, 128), (4, 8, 24, 32, 48), (4, 8, 20, 25, 32, 40),
            (1, 3, 6), ("OOK", "QPSK")):
        cfg = Config(Nt=Nt, Na=4, Nr=Nr, Lin=Lin, Lh=Lh, mode="segmented",
                     profile="uniform", alphabet=alphabet, trunc="tail")
        fit = fused_bamp.fits(cfg, "high")
        assert fit == fits_high(cfg), cfg
        if Lin <= 32:
            assert fit == parent_fits_high(cfg), cfg
        n += fit
        wide += fit and Lin > 32
    assert n > 100 and wide > 20


@pytest.mark.parametrize("name", NAMES)
def test_block_rule(name):
    """8 warps and two blocks per SM where two blocks' shared memory (and
    their 1 KB each) fit the SM's 228 KB, else 16 warps and one block;
    128 registers a thread either way."""
    cfg = _config(name)
    smem = fused_bamp.smem_bytes(cfg, "high")
    threads = fused_bamp.high_threads(cfg)
    two = 2 * (smem + 1024) <= 233472
    assert threads == (256 if two else 512)
    blocks = 2 if two else 1
    assert blocks * threads * 128 == 65536
    if fused_bamp.fits(cfg, "high"):
        assert blocks * (smem + 1024) <= fused_bamp.SM_SMEM


def test_block_rule_at_the_flagships():
    assert fused_bamp.high_threads(flagship_bamp_ook()) == 256
    assert fused_bamp.high_threads(flagship_bamp_qpsk()) == 512


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("threads", [256, 512])
def test_units_cover_every_tile_once(name, threads):
    """Every (16-row tile, n8 tile) once, the warps' loads within one unit
    of each other, no unit over MAX_NT n8 tiles, and at most 32 column
    blocks the units of the earlier rule."""
    cfg = _config(name)
    NT = -(-cfg.Lin // 8)
    units = high_units(cfg, threads)
    for pas, rows in (("forward", cfg.Lh * cfg.Nr), ("adjoint", cfg.Nt)):
        mtiles = fused_bamp.padded16(rows) // 16
        seen = [(mt, nt) for warp in units[pas] for mt, n0, n1 in warp
                for nt in range(n0, n1)]
        assert sorted(seen) == [(mt, nt) for mt in range(mtiles)
                                for nt in range(NT)], pas
        sizes = [len(w) for w in units[pas]]
        assert max(sizes) - min(sizes) <= 1, pas
        parts = high_parts(mtiles, threads // 32, NT)
        assert all(n1 - n0 in (NT // parts, -(-NT // parts))
                   for warp in units[pas] for _, n0, n1 in warp)
        assert all(0 < n1 - n0 <= MAX_NT
                   for warp in units[pas] for _, n0, n1 in warp), pas
        if cfg.Lin <= 32:
            assert parts == parent_high_parts(mtiles, threads // 32, NT)
        else:
            assert NT > MAX_NT and parts >= 2


@pytest.mark.parametrize("lin,NT", [(33, 5), (40, 5), (48, 6)])
def test_units_past_32_column_blocks(lin, NT):
    """Five and six n8 tiles: at the OOK flagship's 8 warps (forward 5
    tiles, adjoint 8) every tile takes two units (of 2-3 tiles); at 16
    warps the forward's tiles take three where the block has the warps."""
    cfg = dataclasses.replace(flagship_bamp_ook(), Lin=lin)
    assert -(-cfg.Lin // 8) == NT
    for threads, want in ((256, {"forward": 2, "adjoint": 2}),
                          (512, {"forward": 3, "adjoint": 2})):
        units = high_units(cfg, threads)
        for pas, n in want.items():
            mtiles = len({mt for w in units[pas] for mt, _, _ in w})
            assert sum(len(w) for w in units[pas]) == n * mtiles, (pas,
                                                                    threads)
            assert {n1 - n0 for w in units[pas] for _, n0, n1 in w} == {
                NT // n, -(-NT // n)}


def test_units_at_the_qpsk_flagship():
    """16 warps: the forward's 12 tiles one a warp (4 warps idle), the
    adjoint's 8 tiles two units of two n8 tiles each, one a warp."""
    units = high_units(flagship_bamp_qpsk(), 512)
    assert [len(w) for w in units["forward"]] == [1] * 12 + [0] * 4
    assert all(w[0][2] - w[0][1] == 4 for w in units["forward"][:12])
    assert [w for w in units["adjoint"]] == [
        [(u // 2, 2 * (u % 2), 2 * (u % 2) + 2)] for u in range(16)]
    ook = high_units(flagship_bamp_ook(), 256)
    assert [len(w) for w in ook["forward"]] == [1] * 5 + [0] * 3
    assert [len(w) for w in ook["adjoint"]] == [1] * 8


def _unfragment(buf: torch.Tensor, Mt: int, Kt: int) -> np.ndarray:
    """(2, Mt*16, Kt*16) hi and lo of an mma_tiles buffer: lane (g, t)'s
    8 bf16 of part h are rows g, g + 8 and columns 2t, 2t + 1, 2t + 8,
    2t + 9 of its 16 x 16 tile (a0: row g, k 2t..; a1: row g + 8; a2: row
    g, k 2t + 8..; a3: row g + 8, k 2t + 8..)."""
    f = buf.float().numpy().reshape(Mt, Kt, 32, 2, 8)
    out = np.full((2, Mt * 16, Kt * 16), np.nan, np.float32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for reg in range(4):
            row = g + 8 * (reg & 1)
            col = 2 * t + 8 * (reg >> 1)
            for h in range(2):
                out[:, row::16, col + h::16] = np.moveaxis(
                    f[:, :, lane, :, 2 * reg + h], 2, 0)
    return out


@pytest.mark.parametrize("name", ["qpsk_tail", "ook_m6", "ook_cyclic"])
def test_tap_fragments_are_split_gauss_planes(name):
    cfg = _config(name)
    rng = np.random.default_rng(7)
    h = (rng.standard_normal((cfg.Lh, cfg.Nr, cfg.Nt))
         + 1j * rng.standard_normal((cfg.Lh, cfg.Nr, cfg.Nt))) / 8
    gains = rng.uniform(0.5, 1.5, (cfg.Lh, cfg.Lin))
    op = BandedOperator(torch.tensor(h, dtype=torch.complex64),
                        torch.tensor(gains, dtype=torch.float32), cfg.Lin,
                        cfg.Lout, cfg.trunc)
    taps, _ = fused_bamp.high_taps(op)
    t = bamp.gauss_taps(op)
    kx = fused_bamp.padded16(cfg.Nt)
    kz = fused_bamp.padded16(cfg.Lh * cfg.Nr)
    size = 2 * kx * kz
    planes = (t.s_a2, t.s_re, t.dmc, t.cpd, t.st_a2, t.st_re, t.amc, t.adm)
    for q, plane in enumerate(planes):
        A = plane.T.contiguous()
        R, K = A.shape
        Mt, Kt = (kz // 16, kx // 16) if q < 4 else (kx // 16, kz // 16)
        got = _unfragment(taps[q * size:(q + 1) * size], Mt, Kt)
        hi, lo = prec.split_bf16(A)
        np.testing.assert_array_equal(got[0, :R, :K], hi.float().numpy())
        np.testing.assert_array_equal(got[1, :R, :K], lo.float().numpy())
        assert not got[:, R:].any() and not got[:, :, K:].any()


@pytest.mark.parametrize("name", NAMES)
def test_split_rows_on_distinct_banks(name):
    """Each split plane starts on a 32-bit word, and the row stride of 4
    mod 8 words puts the eight rows (g) of a B fragment load on distinct
    bank quads: the 32 lanes' words (row g, column 2t) hit 32 banks."""
    cfg = _config(name)
    for k in (cfg.Nt, cfg.Lh * cfg.Nr):
        ld = fused_bamp.split_ld(k)
        assert ld % 2 == 0 and cfg.Lin * ld % 2 == 0
        assert (ld // 2) % 8 == 4
        for col in (0, 8):
            banks = {(g * ld + 2 * t + col) // 2 % 32 for g in range(8)
                     for t in range(4)}
            assert len(banks) == 32


@pytest.mark.parametrize("k,nrows", [(128, 25), (192, 25), (80, 20),
                                     (16, 8)])
def test_b_words_are_the_mma_fragments(k, nrows):
    """The kernel's B words (lane (g, t) of n8 tile nt at k16 step ks: row
    min(8 nt + g, nrows - 1), column 16 ks + 2t, + 8, in the hi then the
    lo plane) hold the m16n8k16 B fragments b0 (k = 2t, 2t + 1) and b1 (k
    = 2t + 8, 2t + 9) of column n = g, with the rows past the last read as
    the last."""
    ld = fused_bamp.split_ld(k)
    plane = nrows * ld
    rng = np.random.default_rng(3)
    mem = rng.standard_normal(2 * plane).astype(np.float32)
    B = [mem[part * plane:(part + 1) * plane].reshape(nrows, ld)
         for part in range(2)]
    for nt in range(-(-nrows // 8)):
        for ks in range(k // 16):
            for lane in range(32):
                g, t = divmod(lane, 4)
                boff = min(nt * 8 + g, nrows - 1) * ld + 2 * t
                r = boff + 16 * ks
                words = [mem[r:r + 2], mem[r + 8:r + 10],
                         mem[r + plane:r + plane + 2],
                         mem[r + plane + 8:r + plane + 10]]
                row = min(nt * 8 + g, nrows - 1)
                for part in range(2):
                    col = 16 * ks + 2 * t
                    np.testing.assert_array_equal(
                        words[2 * part], B[part][row, col:col + 2])
                    np.testing.assert_array_equal(
                        words[2 * part + 1], B[part][row, col + 8:col + 10])


def _engine(units, nq, prods, epi):
    """The engine's order in NumPy: per warp, per unit, product q of its
    tile and n8 tiles, handed to epi(mt, q, n0, n1, out) with out[i] the
    (16, 8) block of product ``prods[q]`` at tile mt, n8 tile n0 + i (at
    most MAX_NT of them, indexed from the unit's first)."""
    for warp in units:
        for mt, n0, n1 in warp:
            assert n1 - n0 <= MAX_NT
            for q in range(nq):
                out = [prods[q][mt * 16:mt * 16 + 16, nt * 8:nt * 8 + 8]
                       for nt in range(n0, n1)]
                epi(mt, q, n0, n1, out)


@pytest.mark.parametrize("name,threads", [("qpsk_flagship", 512),
                                          ("ook_flagship", 256),
                                          ("qpsk_tail", 256),
                                          ("ook_cyclic", 512),
                                          ("ook_flagship_lin40", 256),
                                          ("qpsk_lin33", 512),
                                          ("ook_lin48", 256)])
def test_engine_parks_give_the_gauss_combinations(name, threads):
    """The units and the parked epilogues of forward_high and adjoint_high
    write, for every output, what the Gauss combinations of whole products
    give: P_v, P_re = k1 (- k3), P_im = k1 + k2 (k1 parked in P_re's slot);
    cov = 1 / v, xmap_im = cov (k1 + k2) (+ xm_im), xmap_re = xm_re + cov
    (k1 - k3) (k1 parked in xmap_re)."""
    cfg = _config(name)
    real = fused_bamp.real_x(cfg)
    rng = np.random.default_rng(11)
    Lin, Nt, W = cfg.Lin, cfg.Nt, cfg.Lh * cfg.Nr
    NT8 = -(-Lin // 8) * 8
    units = high_units(cfg, threads)
    nq = 3 if real else 4
    kx, kz = fused_bamp.padded16(Nt), fused_bamp.padded16(W)

    # forward: A (kz, kx) taps, B (NT8, kx) x side, slots P[c, j]
    A = [rng.standard_normal((kz, kx)) for _ in range(4)]
    B = [rng.standard_normal((NT8, kx)) for _ in range(4)]
    P = {name: np.full((Lin, W), np.nan) for name in ("v", "re", "im")}

    def fwd(mt, q, n0, n1, out):
        for i in range(n1 - n0):
            for r, col in itertools.product(range(16), range(8)):
                j, c = mt * 16 + r, (n0 + i) * 8 + col
                if j >= W or c >= Lin:
                    continue
                val = out[i][r, col]
                if q == 0:
                    P["v"][c, j] = val
                elif q == 1:
                    P["re"][c, j] = val
                elif q == 2:
                    P["im"][c, j] = P["re"][c, j] + val
                else:
                    P["re"][c, j] = P["re"][c, j] - val

    prods = [A[q] @ B[q].T for q in range(4)]
    _engine(units["forward"], nq, prods, fwd)
    k = [prods[q][:W, :Lin].T for q in range(4)]
    np.testing.assert_array_equal(P["v"], k[0])
    np.testing.assert_array_equal(P["im"], k[1] + k[2])
    np.testing.assert_array_equal(P["re"], k[1] if real else k[1] - k[3])

    # adjoint: A (kx, kz) taps, B (NT8, kz) adjoint inputs
    A = [rng.standard_normal((kx, kz)) for _ in range(4)]
    B = [rng.standard_normal((NT8, kz)) for _ in range(4)]
    xm_re = rng.standard_normal((Lin, Nt))
    xm_im = rng.standard_normal((Lin, Nt))
    cov, xmap_re, xmap_im = (np.full((Lin, Nt), np.nan) for _ in range(3))

    def adj(mt, q, n0, n1, out):
        for i in range(n1 - n0):
            for r, col in itertools.product(range(16), range(8)):
                kk, c = mt * 16 + r, (n0 + i) * 8 + col
                if kk >= Nt or c >= Lin:
                    continue
                val = out[i][r, col]
                if q == 0:
                    cov[c, kk] = 1.0 / val
                elif q == 1:
                    xmap_re[c, kk] = val
                elif q == 2:
                    im = cov[c, kk] * (xmap_re[c, kk] + val)
                    xmap_im[c, kk] = im if real else xm_im[c, kk] + im
                else:
                    xmap_re[c, kk] = xm_re[c, kk] + cov[c, kk] * (
                        xmap_re[c, kk] - val)

    prods = [A[q] @ B[q].T for q in range(4)]
    _engine(units["adjoint"], 4, prods, adj)
    k = [prods[q][:Nt, :Lin].T for q in range(4)]
    cv = 1.0 / k[0]
    np.testing.assert_array_equal(cov, cv)
    im = cv * (k[1] + k[2])
    np.testing.assert_array_equal(xmap_im, im if real else xm_im + im)
    np.testing.assert_array_equal(xmap_re, xm_re + cv * (k[1] - k[3]))


@pytest.mark.parametrize("name", NAMES)
def test_imaginary_part_fits_the_scratch(name):
    """The HIGH kernel keeps the pseudo-data's imaginary part in its three
    scratch planes (dead from the adjoint to the next forward) where a
    trial's N values fit there (N <= 3 Lin Lh scratch_row), else in the
    output; at every geometry here they fit."""
    cfg = _config(name)
    scratch = 3 * cfg.Lin * cfg.Lh * fused_bamp.scratch_row(cfg)
    assert cfg.N <= scratch
    assert 4 * scratch <= fused_bamp.smem_bytes(cfg, "high")


SOURCE = (fused_bamp.build.CSRC / "fused_bamp_decode.cu").read_text()


@pytest.mark.parametrize("name", NAMES)
def test_default_form_shares_the_high_block(name):
    """The DEFAULT form runs the HIGH form's block (its threads, from the
    HIGH form's carve-out) on the HIGH layout with the hi planes alone: its
    carve-out is the HIGH form's with half the split region, so it fits
    wherever the HIGH form fits."""
    cfg = _config(name)
    high = fused_bamp.smem_bytes(cfg, "high")
    region = 2 * fused_bamp.high_split_elems(cfg)
    assert fused_bamp.smem_bytes(cfg, "default") == high - region // 2
    assert fused_bamp.split_parts("default") == 1
    if fused_bamp.fits(cfg, "high"):
        assert fused_bamp.fits(cfg, "default")
    assert fused_bamp.FORM == {"highest": 0, "high": 1, "default": 2}


def test_default_pass_is_the_hi_hi_product():
    """The source's one-pass form: ``high_pass<kOne, kWords, ...>`` loads
    one 16-byte tap word a lane and k16 step (the hi word of
    ``high_taps``' fragments, alone in ``default_taps``) and issues the hi
    hi mma alone; the launcher maps form 2 to the kOne instances of both
    blocks (one pass in both chains: ``<1, 1, ...>``), whose split
    operands are hi planes only (``Form::kParts``).  On the fragments, the
    hi halves alone give ``precision.dot1``: the hi plane of
    ``default_taps`` is the bf16 of the tap plane."""
    assert "template <bool kOne, int kWords, class Operand, class Epi>" in (
        SOURCE)
    assert "f[0] = f[1] = __ldg(ap);" in SOURCE
    assert "ap += 32 * kWords" in SOURCE
    assert ("static constexpr int kParts = kVP == 3 || kXP == 3 ? 2 : 1;"
            in SOURCE)
    for tag, blocks in ((1, 1), (2, 2)):
        assert (f"bamp_decode_kernel<1, 1, kHighThreads{tag}, "
                f"{blocks}>") in SOURCE
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((40, 50)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((50, 24)).astype(np.float32))
    frag = fused_bamp.mma_tiles(*prec.split_bf16(a))
    hi = _unfragment(frag.reshape(-1), 3, 4)[0][:40, :50]
    assert np.array_equal(hi, a.bfloat16().float().numpy())
    np.testing.assert_allclose(
        hi.astype(np.float64) @ b.bfloat16().double().numpy(),
        prec.dot1(a, b).numpy(), rtol=0, atol=1e-5)
