"""What the register-tiled frame-tiled iteration K5
(``ops/kernels/csrc/fused_bamp_tiled.cu``) rests on, checked on the CPU:
its tile constants against the wrapper's mirror, the tile maps of both
products in both forms, the 1-D grid's order, the bank pattern of its
operand copies and reads, the padded scratch stride, its shared memory
per block, the rule that picks the small form, the order of each output's
FMA chain, and its lane-group denoiser against the plain version's
arithmetic.  The kernel itself runs only on the card (``chip_smoke.py``)."""
import dataclasses
import re
from fractions import Fraction

import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu_torch.config import Config, massive_mimo
from amp_sparc_spatialmodulation_tpu_torch.models import bamp
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
    build, fused_bamp_tiled as k5)
from test_torch_k1_tiles import _last_pow2, _torch_sum

SOURCE = (build.CSRC / "fused_bamp_tiled.cu").read_text()


def kernel_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


TM, TN, STM, STN = (kernel_constant(k) for k in ("kTM", "kTN", "kSTM",
                                                 "kSTN"))
SBM, SBN = kernel_constant("kSBM"), kernel_constant("kSBN")
SMEM_PER_SM, SMEM_PER_BLOCK, RESERVED = 233472, 232448, 1024

# The two product forms, each taken by both products, as (rows, columns)
# of a block tile and of a thread tile; the large form runs a 16 x 16
# thread grid.
FORMS = {"large": ((16 * TM, 16 * TN), (TM, TN)),
         "small": ((SBM, SBN), (STM, STN))}
DEPTHS = {"large": kernel_constant("kDepth"),
          "small": kernel_constant("kSDepth")}
SLOTS = {"large": kernel_constant("kStages"),
         "small": kernel_constant("kSStages")}
DEPTH = DEPTHS["large"]

SMALL = dict(Nt=16, Na=4, Nr=10, Lin=8, Lh=3, mode="segmented",
             alphabet="OOK", profile="uniform", trunc="tail")
# chip_smoke.py's tiled geometries: (config, batch sizes)
GEOMETRIES = {
    "massive": (massive_mimo(), (2048, 1, 2, 3, 4, 5, 6, 7, 8)),
    "ook_8_3": (Config(**SMALL), (1024,)),
    "ook_12_5": (Config(**dict(SMALL, Lin=12, Lh=5)), (1024,)),
    "bpsk_8_3": (Config(**dict(SMALL, alphabet="BPSK")), (1024,)),
    "ook_ragged_37": (Config(**SMALL), (37,)),
}
CASES = [(g, B) for g, (_, bs) in GEOMETRIES.items() for B in bs]


def test_wrapper_mirrors_the_kernel_constants():
    for name, ((BM, BN), _) in FORMS.items():
        assert k5.FORMS[name] == (BM, BN, DEPTHS[name], SLOTS[name])
    assert k5.FORMS["large"][:2] == (64, 64)
    assert k5.FORMS["small"][:2] == (32, 16)
    assert "constexpr int kMinBlocks = 2;" in SOURCE
    assert "__launch_bounds__(F::kNT, F::MIN)" in SOURCE
    assert k5.ALL_STAGES == 15
    for name, bit in k5.STAGES.items():
        stage = {"denoise": "Denoise"}.get(name, name.capitalize())
        assert f"kStage{stage} = {bit}" in SOURCE


def _thread_grid(form):
    """(ty, tx) of each thread of a block of ``form``: warps of WY x WX
    threads (WX = min(8, kTX)) laid over the kTY x kTX grid row by row."""
    (BM, BN), (tm, tn) = FORMS[form]
    kTY, kTX = BM // tm, BN // tn
    WX = min(8, kTX)
    WY = 32 // WX
    out = []
    for tid in range(kTY * kTX):
        warp, lane = divmod(tid, 32)
        wr, wc = divmod(warp, kTX // WX)
        out.append((wr * WY + lane // WX, wc * WX + lane % WX))
    return out


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("geometry,B", CASES)
def test_tiles_cover_every_output_once(geometry, B, form):
    """Rows (trial, column block) and columns of both products in a form:
    every output is owned by exactly one (block, thread, register)
    of the grid the launch builds (thread (ty, tx) holds rows ty + i kTY
    and columns tx TN + j); the forward's stores reach the padded columns
    of its rows and no column past a row."""
    cfg = GEOMETRIES[geometry][0]
    (BM, BN), (tm, tn) = FORMS[form]
    kTY = BM // tm
    rows, W, Wp = B * cfg.Lin, cfg.Lh * cfg.Nr, k5.scratch_stride(cfg)
    grid = _thread_grid(form)
    assert len(set(grid)) == len(grid) == kTY * (BN // tn)
    tile = np.zeros((BM, BN), int)
    for ty, tx in grid:
        for i in range(tm):
            tile[ty + i * kTY, tx * tn:(tx + 1) * tn] += 1
    assert np.all(tile == 1)
    row_tiles = -(-rows // BM)
    for cols in (Wp, cfg.Nt):   # forward, adjoint
        col_tiles = -(-cols // BN)
        # the 1-D grid: block i is row tile i // col_tiles, column tile
        # i % col_tiles, each pair once; the tiles cover the outputs
        grid1 = np.arange(row_tiles * col_tiles)
        pairs = set(zip(grid1 // col_tiles, grid1 % col_tiles))
        assert len(pairs) == row_tiles * col_tiles
        assert row_tiles * BM >= rows and col_tiles * BN >= cols
        assert (row_tiles - 1) * BM < rows and (col_tiles - 1) * BN < cols
    assert -(-W // BN) == -(-Wp // BN)  # the form rule counts W
    assert len(grid) % 32 == 0


def test_column_tiles_of_a_row_tile_are_adjacent():
    """At the massive phase-1 shape the column tile varies fastest: the 7
    forward (21 adjoint) blocks of a row tile have consecutive indices, so
    the blocks resident together share their A rows in L2."""
    cfg = massive_mimo()
    for cols, n_tiles in ((cfg.Lh * cfg.Nr, 7), (cfg.Nt, 21)):
        col_tiles = -(-cols // k5.FORMS["large"][1])
        assert col_tiles == n_tiles
        blocks = np.arange(2048 * cfg.Lin // k5.FORMS["large"][0]
                           * col_tiles)
        row_tile = blocks // col_tiles
        starts = np.flatnonzero(np.diff(row_tile)) + 1
        assert np.all(np.diff(starts) == col_tiles)
        assert np.all(row_tile[:col_tiles] == 0)


def _banks16(addr):
    """The 4-bank group of a 16-byte shared access at float offset addr."""
    assert addr % 4 == 0
    return (addr // 4) % 8


def _a_copies(R, D, NT):
    """load_rows' 16-byte copies of an R x D A tile (kRows8): per
    warp-wide instruction, the (row, chunk) of each lane."""
    C4 = D // 4
    units = R * C4
    out = []
    for i in range(-(-units // NT)):
        for warp in range(NT // 32):
            lanes = []
            for lane in range(32):
                u = warp * 32 + lane + i * NT
                if u < units:
                    lanes.append((u // (8 * C4) * 8 + u % 8,
                                  (u // 8) % C4 * 4))
            out.append(lanes)
    return out


@pytest.mark.parametrize("form", list(FORMS))
def test_operand_tiles_are_free_of_bank_conflicts(form):
    """The A tiles lie as in device memory with rows padded to D + 4
    floats: each quarter-warp of a 16-byte copy stores 8 rows of one
    chunk to 8 different bank groups, the copies cover the tile once and
    a row's chunks come from one instruction; the WY rows a warp reads at
    once (one per thread row ty) fall in different bank groups, and its WX
    tap fragments are 128 contiguous bytes."""
    (BM, BN), (tm, tn) = FORMS[form]
    D, NT = DEPTHS[form], len(_thread_grid(form))
    LA = D + 4
    seen = []
    for lanes in _a_copies(BM, D, NT):
        for q in range(0, len(lanes), 8):
            quarter = lanes[q:q + 8]
            groups = {_banks16(r * LA + c) for r, c in quarter}
            assert len(groups) == len(quarter)
        rows = {r for r, _ in lanes}
        for r in rows:
            if D <= 16:
                assert sorted(c for rr, c in lanes if rr == r) \
                    == list(range(0, D, 4))
        seen += lanes
    assert sorted(seen) == [(r, c) for r in range(BM) for c in range(0, D, 4)]
    grid = _thread_grid(form)
    for w in range(len(grid) // 32):
        warp = grid[32 * w:32 * w + 32]
        tys = sorted({ty for ty, _ in warp})
        for i in range(tm):
            groups = {_banks16((ty + i * (BM // tm)) * LA) for ty in tys}
            assert len(groups) == len(tys)
        txs = sorted({tx for _, tx in warp})
        assert txs == list(range(txs[0], txs[0] + len(txs)))
        assert len(txs) * tn * 4 <= 128 or tn * 4 == 16


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_scratch_stride_pads_rows_to_16_bytes(geometry):
    cfg = GEOMETRIES[geometry][0]
    W, Wp = cfg.Lh * cfg.Nr, k5.scratch_stride(cfg)
    assert Wp >= W and Wp % 4 == 0 and Wp - W < 4
    if geometry == "massive":
        assert (W, Wp) == (438, 440)
    B = 3
    ps = bamp.PlaneState(*[torch.zeros((B, cfg.N)) for _ in range(5)],
                         *[torch.zeros((B, cfg.n)) for _ in range(3)],
                         torch.ones(B, dtype=torch.bool),
                         torch.zeros(B, dtype=torch.int32), 0)
    out, scratch, cov = k5._buffers(ps, cfg)
    assert len(scratch) == 6
    assert all(t.shape == (B * cfg.Lin, Wp) for t in scratch)
    assert cov.shape == (B, cfg.N) and out.notok.shape == (B,)


def test_shared_memory_gives_two_large_blocks_per_sm():
    """A ring of 3 slots of 16 steps: 67,584 B (forward) and 82,944 B
    (adjoint) per large block, two of which fit an SM with the 1 KB CUDA
    reserves for each; the small form is far below."""
    for forward in (True, False):
        for small in (False, True):
            b = k5.smem_bytes(forward, small)
            assert b <= SMEM_PER_BLOCK
            assert 2 * (b + RESERVED) <= SMEM_PER_SM
            name = "small" if small else "large"
            (BM, BN), _ = FORMS[name]
            D = DEPTHS[name]
            assert b == 4 * SLOTS[name] * (
                (2 if forward else 3) * BM * (D + 4) + 3 * D * BN)
    if (DEPTHS["large"], SLOTS["large"]) == (16, 3):
        assert k5.smem_bytes(True, False) == 67584
        assert k5.smem_bytes(False, False) == 82944


@pytest.mark.parametrize("B", [2048, 1, 2, 3, 4, 5, 6, 7, 8])
def test_small_form_rule(B):
    cfg = massive_mimo()
    W = cfg.Lh * cfg.Nr
    forms = k5.tile_forms(B, cfg.Lin, W, cfg.Nt)
    assert forms == (0 if B == 2048 else 3)
    if B == 6:
        rows = B * cfg.Lin
        assert -(-rows // SBM) * -(-W // SBN) >= 132       # forward
        assert -(-rows // SBM) * -(-cfg.Nt // SBN) >= 132  # adjoint
        # one small row tile is one trial: a frozen trial's rows are
        # skipped exactly
        assert SBM == cfg.Lin


def _fma32(a, b, c):
    """fmaf on float32 arrays, rounded once: the float64 product is exact,
    the sum's rounding error comes from TwoSum, and a float64 sum that
    lies on a float32 tie is rounded toward the error's side."""
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    other = np.nextafter(r, np.where(s > r, np.inf, -np.inf).astype(
        np.float32))
    tie = (err != 0) & (r.astype(np.float64) != s) & (
        s == (r.astype(np.float64) + other.astype(np.float64)) / 2)
    up = np.maximum(r, other)
    down = np.minimum(r, other)
    return np.where(tie, np.where(err > 0, up, down), r).astype(np.float32)


def _fma32_exact(a, b, c):
    """fmaf by exact rational arithmetic: the float32 nearest to a b + c,
    ties to even."""
    q = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(q))
    cands = [r, np.nextafter(r, np.float32(np.inf)),
             np.nextafter(r, np.float32(-np.inf))]
    dist = [abs(Fraction(float(v)) - q) for v in cands]
    best = min(dist)
    ties = [v for v, d in zip(cands, dist) if d == best]
    return min(ties, key=lambda v: int(v.view(np.uint32)) & 1)


def test_fma32_rounds_once():
    rng = np.random.default_rng(7)
    a = rng.standard_normal(3000).astype(np.float32)
    b = (rng.standard_normal(3000)
         * 2.0 ** rng.integers(-30, 30, 3000)).astype(np.float32)
    c = (rng.standard_normal(3000)
         * 2.0 ** rng.integers(-40, 40, 3000)).astype(np.float32)
    # near-cancellations and products far below the addend's ulp
    c[:1000] = -(a[:1000] * b[:1000]).astype(np.float32)
    c[1000:2000] = np.float32(1.0)
    b[1000:2000] = np.float32(2.0 ** -24) * (1 + rng.integers(
        -3, 4, 1000) * np.float32(2.0 ** -23))
    got = _fma32(a, b, c)
    want = np.array([_fma32_exact(*t) for t in zip(a, b, c)], np.float32)
    assert got.tobytes() == want.tobytes()


def _chain(a, b, depth_pad=0):
    """One output's FMA chain from 0 over k in order (a, b: (..., K)),
    with ``depth_pad`` zero steps at the end."""
    acc = np.zeros(a.shape[:-1], np.float32)
    for k in range(a.shape[-1]):
        acc = _fma32(a[..., k], b[..., k], acc)
    for _ in range(depth_pad):
        acc = _fma32(np.float32(0), np.float32(0), acc)
    return acc


def _engine(A, Bt, BM, BN, tm, tn):
    """The engine's product of A (rows, K) and the tap plane Bt (cols, K)
    emulated per block tile, thread and register: slot by slot of DEPTH
    steps (zero past K), each thread's tm x tn accumulators (rows ty +
    i kTY, columns tx tn + j)."""
    rows, K = A.shape
    cols = Bt.shape[0]
    nk = -(-K // DEPTH)
    Ap = np.zeros((-(-rows // BM) * BM, nk * DEPTH), np.float32)
    Bp = np.zeros((-(-cols // BN) * BN, nk * DEPTH), np.float32)
    Ap[:rows, :K], Bp[:cols, :K] = A, Bt
    out = np.full((Ap.shape[0], Bp.shape[0]), np.nan, np.float32)
    for R0 in range(0, Ap.shape[0], BM):
        for n0 in range(0, Bp.shape[0], BN):
            for ty in range(BM // tm):
                for tx in range(BN // tn):
                    r = R0 + ty + (BM // tm) * np.arange(tm)
                    n = n0 + tx * tn + np.arange(tn)
                    acc = np.zeros((tm, tn), np.float32)
                    for slot in range(nk):
                        for kk in range(DEPTH):
                            k = slot * DEPTH + kk
                            acc = _fma32(Ap[r, k][:, None], Bp[n, k][None],
                                         acc)
                    out[np.ix_(r, n)] = acc
    return out[:rows, :cols]


@pytest.mark.parametrize("K", [38, 48])
def test_every_output_is_one_chain_in_k_order(K):
    """The engine's result at each tile size equals one FMA chain per
    output from 0 over k in order, the order of the kernel before the
    register tiles and of the matrix library at large batch; the zero
    steps past K (K = 38 pads to 48) change no bit."""
    rng = np.random.default_rng(K)
    A = rng.standard_normal((40, K)).astype(np.float32)
    Bt = rng.standard_normal((20, K)).astype(np.float32)
    want = _chain(A[:, None, :], Bt[None, :, :])
    assert np.array_equal(want, _chain(A[:, None, :], Bt[None, :, :],
                                       depth_pad=-K % DEPTH))
    for (BM, BN), (tm, tn) in [((64, 64), (4, 4)), *FORMS.values()]:
        got = _engine(A, Bt, BM, BN, tm, tn)
        assert got.tobytes() == want.tobytes()
    # the adjoint's complex chain: the real part's two FMAs, then the
    # imaginary part's, per k (zr h_re + zi h_im, then zi h_re - zr h_im)
    zr, zi, hr, hi = (rng.standard_normal(K).astype(np.float32)
                      for _ in range(4))
    ar = ai = np.float32(0)
    for k in range(K):
        ar = _fma32(zr[k], hr[k], ar)
        ar = _fma32(-zi[k], -hi[k], ar)
        ai = _fma32(zr[k], -hi[k], ai)
        ai = _fma32(zi[k], hr[k], ai)
    body = SOURCE[SOURCE.index("(zr + i zi) * conj(h)"):]
    assert body.index("acc[1][i][j] = fmaf(zr, hr[j]") \
        < body.index("acc[1][i][j] = fmaf(-zi, -hi[j]") \
        < body.index("acc[2][i][j] = fmaf(zr, -hi[j]") \
        < body.index("acc[2][i][j] = fmaf(zi, hr[j]")
    assert np.isfinite(ar) and np.isfinite(ai)


def _cuda_order_sum(orig):
    """Tensor.sum of a float32 tensor over its last dimension, or over
    dimension 2 of a 3-d one (keepdim), in the order of PyTorch's CUDA
    reduction (torch_sum), as on the card."""
    def sum_(self, *args, **kw):
        dim = args[0] if args else kw.get("dim")
        keep = kw.get("keepdim", False)
        if self.dtype != torch.float32 or dim not in (-1, 2) \
                or (dim == 2 and self.ndim != 3):
            return orig(self, *args, **kw)
        a = self.numpy()
        if dim == 2:
            a = np.moveaxis(a, 2, -1)
        rows = a.reshape(-1, a.shape[-1])
        out = np.array([_torch_sum(list(r)) for r in rows],
                       np.float32).reshape(a.shape[:-1])
        out = torch.as_tensor(out)
        return out.unsqueeze(dim) if keep else out
    return sum_


def _group_posterior(x, cov, old, sr, si, M):
    """The kernel's group_posterior over one trial (real x): G lanes per
    segment, lane t holding elements t, t+G, ...; the segment max and the
    sum of eta through the shuffle trees; segment_posterior's mean and
    decomposed variance; the count outside the allclose tolerance."""
    f = np.float32
    K = len(sr)
    G = 32 if M >= 32 else _last_pow2(M)
    exp = lambda a: torch.exp(torch.as_tensor(f(a))).numpy()[()]  # noqa
    abs2 = lambda re, im: f(np.hypot(re, im)) * f(np.hypot(re, im))  # noqa
    mean, var = np.empty(len(x), f), np.empty(len(x), f)
    bad = 0
    for j0 in range(0, len(x), M):
        def t_of(i, q):
            tau = cov[j0 + i] / f(2)
            return (x[j0 + i] / tau) * sr[q]

        mx = f(max(max(t_of(i, q) for i in range(t, M, G) for q in range(K))
                   for t in range(G)))
        eta = [[exp(min(t_of(i, q) - mx, f(87.72283905206835)))
                for q in range(K)] for i in range(M)]
        eta_m = [e[0] if K == 1 else _torch_sum(e) for e in eta]
        lanes = []
        for t in range(G):
            acc = [f(0)] * 4
            for s, i in enumerate(range(t, M, G)):
                acc[s % 4] = acc[s % 4] + eta_m[i]
            lanes.append(((acc[0] + acc[1]) + acc[2]) + acc[3])
        off = G // 2
        while off >= 1:
            lanes = [lanes[t] + lanes[t + off] if t < off else lanes[t]
                     for t in range(G)]
            off //= 2
        eta2 = lanes[0]
        for i in range(M):
            if K == 1:
                post = eta[i][0] / eta2
                mr, mi = sr[0] * post, si[0] * post
                v = abs2(mr, mi) * (f(1) - post) \
                    + abs2(mr - sr[0], mi - si[0]) * post
            else:
                mr = _torch_sum([sr[q] * eta[i][q] for q in range(K)]) / eta2
                mi = _torch_sum([si[q] * eta[i][q] for q in range(K)]) / eta2
                var0 = abs2(mr, mi) * (f(1) - eta_m[i] / eta2)
                vs = _torch_sum([abs2(mr - sr[q], mi - si[q]) * eta[i][q]
                                 for q in range(K)])
                v = var0 + vs / eta2
            o = old[j0 + i]
            bad += not abs(v - o) <= f(1e-8) + f(1e-5) * abs(o)
            mean[j0 + i], var[j0 + i] = mr, v
    return mean, var, bad


@pytest.mark.parametrize("alphabet,M", [("OOK", 4), ("OOK", 16),
                                        ("OOK", 64), ("BPSK", 8),
                                        ("BPSK", 32)])
def test_group_posterior_matches_the_plain_denoiser(alphabet, M,
                                                    monkeypatch):
    """The lane-group denoiser gives ``bamp.make_denoiser``'s posterior
    mean and decomposed variance bit for bit (the imaginary part of the
    pseudo-data does not enter: real alphabet), and its notok count
    equals the plain step's.  The plain version runs here with PyTorch's
    CUDA reduction order for the segment and symbol sums, which the kernel
    and the card's plain version share."""
    cfg = Config(Nt=4 * M, Na=4, Nr=8, Lin=2, Lh=1, mode="segmented",
                 alphabet=alphabet, profile="uniform", trunc="tail")
    assert cfg.M == M and k5.covers(cfg)
    rng = np.random.default_rng(M + len(alphabet))
    B, N = 2, cfg.N
    x = (rng.standard_normal((B, N))
         + 1j * rng.standard_normal((B, N))).astype(np.complex64)
    x.real[:, ::M] += np.float32(2.0)       # a leading lane per segment
    cov = rng.uniform(0.05, 2.0, (B, N)).astype(np.float32)
    den = bamp.make_denoiser(cfg, torch.device("cpu"))
    monkeypatch.setattr(torch.Tensor, "sum", _cuda_order_sum(torch.Tensor.sum))
    mean, var = den(torch.as_tensor(x), torch.as_tensor(cov))
    old = var.numpy().copy()
    pick = rng.random((B, N))
    old[pick < 0.3] *= np.float32(1 + 1e-3)
    old[(pick >= 0.3) & (pick < 0.6)] *= np.float32(1 + 1e-7)
    notok = bamp._notok_rows(var, torch.as_tensor(old))
    monkeypatch.undo()
    syms = np.asarray(cfg.symbols, np.complex64)
    sr, si = syms.real.astype(np.float32), syms.imag.astype(np.float32)
    for b in range(B):
        m_b, v_b, bad = _group_posterior(x[b].real, cov[b], old[b], sr, si, M)
        assert m_b.tobytes() == mean[b].numpy().real.astype(
            np.float32).tobytes()
        assert v_b.tobytes() == var[b].numpy().tobytes()
        assert bad == int(notok[b]) and 0 < bad < N


def test_denoiser_group_width_is_torch_sums():
    for M in (1, 2, 3, 12, 16, 31, 32, 64, 100):
        want = 32 if M >= 32 else _last_pow2(M)
        w = 1
        while 2 * w <= M and w < 32:
            w *= 2
        assert w == want
    assert "while (2 * w <= M && w < 32) w *= 2;" in SOURCE


def test_massive_config_is_what_the_forms_were_sized_for():
    cfg = dataclasses.replace(massive_mimo(), iterations=300)
    assert (cfg.Nt, cfg.Nr, cfg.Lin, cfg.Lh, cfg.M) == (1344, 73, 32, 6, 16)
    assert k5.covers(cfg)
