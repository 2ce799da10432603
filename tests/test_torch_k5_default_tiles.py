"""The host-side mirrors of K5's DEFAULT form (``fused_bamp_tiled.cu``'s
``default_product_kernel``, the split launch, the fold and the denoiser at
``precision='default'``), checked on the CPU in a few seconds:

* the hi-only layout (``split1_at``, ``split_tiles(..., 'default')``)
  against a NumPy rebuild, as the HIGH layout with step 2 s + 1's hi
  where step 2 s's lo lies (so the HIGH engine's lane addresses give both
  steps' fragments), and as wgmma's K-major 64-byte swizzle (the large
  form's descriptors);
* ``default_taps``: the hi halves of ``high_taps``' seven planes, zero in
  every pad, cached per operator;
* the DEFAULT forms (``DefaultLarge``, ``DefaultSmall``) against the
  wrapper's mirror: ``split_sizes``, ``smem_bytes`` (both forms within 227
  KB), ``tile_forms`` at 2048 and 6 trials, ``engine_bytes``;
* the persistent blocks' walk over the tiles and the copy warp's cursor:
  every live tile once, in the consumers' order;
* the denoiser's hi-only split writes, a warp's turn one tile row;
* ``kept_split``: a call takes only the split planes of its own form.

The kernel itself is held against its plain version on the card by
``chip_smoke.py`` (``kernels_tiled_default``).
"""
import re

import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu_torch.config import Config, massive_mimo
from amp_sparc_spatialmodulation_tpu_torch.models import bamp
from amp_sparc_spatialmodulation_tpu_torch.ops import precision as prec
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
    build, fused_bamp_tiled as k5)
from amp_sparc_spatialmodulation_tpu_torch.ops.operators import (
    BandedOperator)

SOURCE = (build.CSRC / "fused_bamp_tiled.cu").read_text()
SMEM_PER_BLOCK = 232448
SMALL = Config(Nt=16, Na=4, Nr=10, Lin=8, Lh=3, mode="segmented",
               alphabet="OOK", profile="uniform", trunc="tail")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def default_form(name):
    """(WM, WN, MT, NT, S, MIN, wgmma, tiles a slot) of the kernel's
    DEFAULT form ``name``."""
    m = re.search(rf"using {name} = DefaultForm<([\d, ]+?)"
                  r"(, true(, (\d+))?)?>;", SOURCE)
    return (*(int(v) for v in m.group(1).split(",")), bool(m.group(2)),
            int(m.group(4) or 1))


FORMS = {("large", True): default_form("DefaultLarge"),
         ("large", False): default_form("DefaultLargeAdjoint"),
         ("small", True): default_form("DefaultSmall"),
         ("small", False): default_form("DefaultSmall")}


def numpy_split1(m: np.ndarray, tile: int) -> np.ndarray:
    """The DEFAULT layout rebuilt in NumPy from its description: rows
    padded to tiles of ``tile``, the contraction to a multiple of 32; tile
    (t, s) holds rows t tile .., steps 32 s .. 32 s + 31, each row 4
    chunks of 8 bf16, chunk c stored at position c ^ ((r // 2) % 4)."""
    rows, K = m.shape
    rt, kt = -(-rows // tile), -(-K // 32)
    full = np.zeros((rt * tile, kt * 32), dtype=np.float32)
    full[:rows, :K] = m
    hi = torch.from_numpy(full).bfloat16().float().numpy()
    out = np.zeros((rt, kt, tile, 4, 8), dtype=np.float32)
    for t in range(rt):
        for s in range(kt):
            for r in range(tile):
                for c in range(4):
                    out[t, s, r, c ^ ((r >> 1) & 3)] = \
                        hi[t * tile + r, 32 * s + 8 * c:32 * s + 8 * c + 8]
    return out.reshape(-1)


@pytest.mark.parametrize("rows,K,tile", [(150, 40, 128), (112, 438, 112),
                                         (37, 16, 128), (5, 70, 32)])
def test_split1_tiles_is_the_numpy_rebuild_and_split1_at(rows, K, tile):
    """``split_tiles(..., 'default')`` equals the NumPy rebuild of the
    layout bit for bit; every hi sits where ``split1_at`` puts it and
    every other bf16 (row and contraction pads) is zero; half the size of
    the HIGH buffer."""
    g = torch.Generator().manual_seed(rows + K)
    m = torch.randn(rows, K, generator=g, dtype=torch.float32)
    buf = k5.split_tiles(m, tile, "default")
    assert buf.dtype == torch.bfloat16
    assert torch.equal(buf.float(), torch.from_numpy(numpy_split1(
        m.numpy(), tile)))
    assert 2 * buf.numel() == k5.split_tiles(m, tile).numel()
    steps = k5.split_steps(K)
    idx = torch.tensor([[k5.split1_at(steps, tile, R, k) for k in range(K)]
                        for R in range(rows)])
    assert torch.equal(buf.float()[idx], m.bfloat16().float())
    seen = torch.zeros(buf.numel(), dtype=torch.bool)
    seen[idx.flatten()] = True
    assert int(seen.sum()) == rows * K
    assert not buf.float()[~seen].any()


def test_split1_at_is_high_layout_with_the_next_steps_hi():
    """Element (R, k) of the DEFAULT layout lies where the HIGH layout
    keeps part (k // 16) % 2 of step 2 (k // 32): hi of even steps in
    place, hi of odd steps where the even step's lo lies; so a slot's tile
    read at HIGH's hi (a_hi, b chunks 0-1) and lo (a_lo, b chunks 2-3)
    addresses gives steps 2 s and 2 s + 1."""
    steps, tile = 6, 128
    for R in (0, 1, 5, 127, 128, 300):
        for k in range(16 * steps):
            s2, h = k // 32, (k // 16) % 2
            high = k5.split_at(steps, tile, R, 32 * s2 + k % 16, h)
            # the HIGH plane has twice the steps: its tile s2 is tile
            # 2 s2 of a plane of twice the steps
            r = R % tile
            base = ((R // tile * steps + 2 * s2) * tile + r) * 32
            assert high - base == k5.split1_at(steps, tile, R, k) - (
                ((R // tile * (steps // 2) + s2) * tile + r) * 32)
    assert "split_chunk((k & 31) >> 3, r) * 8 + (k & 7);" in SOURCE


def test_split1_tiles_are_the_wgmma_64_byte_swizzle():
    """A tile of ``split1_at``'s layout is wgmma's K-major operand with the
    64-byte swizzle, as the large form's descriptors read it: element (row
    r, k) of a tile whose start is 512-byte aligned lies at byte r 64 + k 2
    with address bits 4-5 XOR bits 7-8; a warpgroup's 64 rows start 4096
    bytes on, a tile's second k16 step 32 bytes on (added to the
    descriptor's start before the swizzle), core groups of 8 rows 512
    bytes apart."""
    steps = 2
    sw64 = lambda addr: addr ^ (((addr >> 7) & 3) << 4)
    for rows in (128, 112, 32, 16):
        for r in range(rows):
            for k in range(32):
                got = 2 * k5.split1_at(steps, rows, r, k)
                step, kk = k // 16, k % 16
                start = 64 * (r // 64) * 64 + 32 * step   # warpgroup, step
                logical = start + (r % 64) // 8 * 512 + (r % 8) * 64 + 2 * kk
                assert got == sw64(logical)
    assert "(static_cast<unsigned long long>(512 >> 4) << 32) |" in SOURCE
    assert "(2ull << 62);" in SOURCE
    assert "sa + u * F::kTileA + (warp >> 2) * 4096);" in SOURCE


def _op(cfg, seed=3):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((cfg.Lh, cfg.Nr, cfg.Nt))
         + 1j * rng.standard_normal((cfg.Lh, cfg.Nr, cfg.Nt))) / 8
    g = rng.uniform(0.5, 1.5, (cfg.Lh, 1)) * np.ones((1, cfg.Lin))
    return BandedOperator(torch.tensor(h, dtype=torch.complex64),
                          torch.tensor(g, dtype=torch.float32), cfg.Lin,
                          cfg.Lout, cfg.trunc)


def test_default_taps_are_the_hi_halves_of_high_taps():
    """``default_taps`` holds, plane by plane in ``high_taps``' order, the
    bf16 hi of each Gauss plane (the hi half of ``high_taps``) in the
    DEFAULT layout of ``HIGH_COLS``-column tiles, zero in every pad; built
    once per operator."""
    op = _op(SMALL)
    t = bamp.gauss_taps(op)
    planes = (t.s_re, t.dmc, t.s_a2, t.st_re, t.amc, t.adm, t.st_a2)
    buf = k5.default_taps(op)
    high = k5.high_taps(op).float()
    assert buf is k5.default_taps(op) and buf.dtype == torch.bfloat16
    assert 2 * buf.numel() == high.numel()
    at = hat = 0
    for plane in planes:
        m = plane.T.contiguous()
        cols, K = m.shape
        steps = k5.split_steps(K)
        size = -(-cols // k5.HIGH_COLS) * k5.HIGH_COLS * steps * 16
        got = buf[at:at + size].float()
        idx = torch.tensor([[k5.split1_at(steps, k5.HIGH_COLS, n, k)
                             for k in range(K)] for n in range(cols)])
        hidx = torch.tensor([[k5.split_at(steps, k5.HIGH_COLS, n, k, 0)
                              for k in range(K)] for n in range(cols)])
        assert torch.equal(got[idx], high[hat:hat + 2 * size][hidx])
        assert torch.equal(got[idx], prec.split_bf16(m)[0].float())
        seen = torch.zeros(size, dtype=torch.bool)
        seen[idx.flatten()] = True
        assert not got[~seen].any()
        at, hat = at + size, hat + 2 * size
    assert at == buf.numel() and hat == high.numel()
    assert k5.form_taps(op, "default") is buf
    assert k5.form_taps(op, "high") is k5.high_taps(op)


def test_wrapper_mirrors_the_default_forms():
    """The DEFAULT forms: HighLarge's and HighSmall's tiles (so
    ``tile_forms`` picks as at HIGH), the large form on two warpgroups
    (wgmma) with 3 ring slots of three tiles of each operand in the forward
    and of two in the adjoint, the small one on mma.sync with 4 slots of
    one tile (64 bytes a row); one park in the forward, two in the adjoint;
    a full and an empty mbarrier per slot; every product block within the
    227 KB a block may use; one large block per SM."""
    for (form, fwd), (WM, WN, MT, NT, S, MIN, wg, T) in FORMS.items():
        BM, BN = k5.FORMS_DEFAULT[form]
        assert (16 * WM * MT, 8 * WN * NT) == (BM, BN)
        assert (BM, BN) == k5.FORMS_HIGH[form][:2]
        assert (S, T) == k5.DEFAULT_RINGS[(form, fwd)]
        assert wg == (form == "large") and MIN == (1 if wg else 4)
        smem = k5.smem_bytes(fwd, form == "small", "default")
        assert smem == (S * T * 64 * (BM + BN) + (1 if fwd else 2) * 4 * BM
                        * BN + 16 * S)
        assert smem <= SMEM_PER_BLOCK
        # a slot's tiles of an operand are one piece of its plane: the
        # block takes whole layout tiles where a slot has more than one
        assert T == 1 or (BM, BN) == (k5.HIGH_ROWS, k5.HIGH_COLS)
    assert k5.PER_SM["default"] == 1
    assert ("return S * kSlot + (fwd ? 1 : 2) * kPark + 16 * S;"
            in SOURCE)
    assert "static constexpr int kPark = kOut * kNT * 4;" in SOURCE
    assert "unsigned long long* empty = full + S;" in SOURCE


@pytest.mark.parametrize("B,forms", [(2048, 0), (6, 3), (37, 3), (64, 1),
                                     (129, 0)])
def test_default_form_rule_at_the_massive_geometry(B, forms):
    """The small form where the large one has fewer tiles than the H100's
    132 SMs: phase 1's 2048 trials in the large form, phase 2's handful
    (6) in the small one, as at HIGH."""
    m = massive_mimo()
    W = m.Lh * m.Nr
    assert k5.tile_forms(B, m.Lin, W, m.Nt, "default") == forms
    assert k5.tile_forms(B, m.Lin, W, m.Nt, "high") == forms


def test_default_split_sizes_and_engine_bytes():
    """The DEFAULT split buffers are half the HIGH ones (hi alone); the
    ring's copies per call at the massive main shape: forward 2048 tiles x
    3 products x 42 slots of 128 trial-side and 112 tap rows of 64 bytes,
    adjoint 6144 x 4 x 14; half of HIGH's."""
    m = massive_mimo()
    for B, cfg in ((2048, m), (37, SMALL)):
        hi = k5.split_sizes(B, cfg)
        assert k5.split_sizes(B, cfg, "default") == (hi[0] // 2, hi[1] // 2)
    assert k5.split_sizes(2048, m, "default") == (2 * 512 * 128 * 32 * 42,
                                                  4 * 512 * 128 * 32 * 14)
    got = k5.engine_bytes(2048, m, "default")
    assert got == {"forward": {"trial_side": 2048 * 3 * 42 * 128 * 64,
                               "taps": 2048 * 3 * 42 * 112 * 64},
                   "adjoint": {"trial_side": 6144 * 4 * 14 * 128 * 64,
                               "taps": 6144 * 4 * 14 * 112 * 64}}
    high = k5.engine_bytes(2048, m, "high")
    for stage in got:
        for side in got[stage]:
            assert 2 * got[stage][side] == high[stage][side]
    small = k5.engine_bytes(6, m, "default")["forward"]
    assert small["trial_side"] == 6 * 28 * 3 * 42 * 32 * 64


def walk(act, Lin, rows, BM, col_tiles, grid):
    """The kernel's tiles of each block (``first`` and ``next_live``)."""
    tiles = -(-rows // BM) * col_tiles

    def live(tile):
        R0 = tile // col_tiles * BM
        last = (min(R0 + BM, rows) - 1) // Lin
        return any(act[b] for b in range(R0 // Lin, last + 1))

    def next_live(tile):
        tile += grid
        while tile < tiles and not live(tile):
            tile += grid
        return tile

    blocks = []
    for bx in range(min(grid, tiles)):
        first = bx if live(bx) else next_live(bx)
        mine, t = [], first
        while t < tiles:
            mine.append(t)
            t = next_live(t)
        blocks.append(mine)
    return blocks, live


@pytest.mark.parametrize("B,Lin,BM,cols,grid", [(37, 32, 128, 4, 132),
                                                 (6, 32, 32, 28, 528),
                                                 (300, 8, 128, 12, 7)])
def test_persistent_walk_takes_every_live_tile_once(B, Lin, BM, cols, grid):
    """Blocks blockIdx.x, + gridDim.x, ... together take every tile whose
    rows hold an active trial exactly once and no other; the copy warp's
    cursor (products, then steps, then the next live tile) copies each
    consumed (tile, product, step) once, in the order the consumer warps
    consume them."""
    rng = np.random.default_rng(B)
    act = rng.random(B) < 0.6
    rows = B * Lin
    blocks, live = walk(act, Lin, rows, BM, cols, grid)
    taken = sorted(t for mine in blocks for t in mine)
    assert taken == [t for t in range(-(-rows // BM) * cols) if live(t)]
    passes, nkt = 4, 3
    for mine in blocks:
        consumed = [(t, q, s) for t in mine for q in range(passes)
                    for s in range(nkt)]
        copies, cur = [], (mine[0] if mine else None, 0, 0)
        for _ in consumed:
            copies.append(cur)
            t, q, s = cur
            s += 1
            if s == nkt:
                s, q = 0, q + 1
                if q == passes:
                    q = 0
                    nxt = mine.index(t) + 1
                    t = mine[nxt] if nxt < len(mine) else None
            cur = (t, q, s)
        assert copies == consumed
    assert "do tile += gridDim.x;\n    while (tile < tiles && !live(tile));" \
        in SOURCE


def test_denoiser_warp_writes_one_row():
    """At the massive geometry (M = 16, lane groups of G = 16, a warp two
    segments in a row) each lane holds one element, and the 32 elements of
    a warp's turn (32-aligned: Nt is a multiple of 32) fill one 64-byte row
    of a ``split1_at`` tile in each plane: its hi-only split writes cover
    whole rows, where HIGH's split them over hi and lo of two tiles."""
    m = massive_mimo()
    assert (m.M, m.Nt % 32) == (16, 0)
    steps = k5.split_steps(m.Nt)
    for warp_turn in (0, 1, 41, 42, 42 * 31 + 7):
        j0 = 32 * warp_turn
        R, k0 = j0 // m.Nt, j0 % m.Nt
        at = sorted(k5.split1_at(steps, k5.HIGH_ROWS, R, k0 + i)
                    for i in range(32))
        assert at == list(range(at[0], at[0] + 32)) and at[0] % 32 == 0
        high = {k5.split_at(steps, k5.HIGH_ROWS, R, k0 + i, h) // 32
                for i in range(32) for h in range(2)}
        assert len(high) == 2
    assert "const size_t at = split1_at(p.kxs, kHRows, R, k);" in SOURCE


def test_kept_split_takes_its_own_form():
    """A call's denoiser leaves its split x and var on ``out.xm_re`` with
    its form; the next call takes them only at the same precision, and
    not once x or var changed (the layouts of HIGH and DEFAULT differ)."""
    x, var = torch.zeros(2, 3), torch.zeros(2, 3)
    ps = bamp.PlaneState(*[x if f == "xm_re" else var if f == "var" else None
                           for f in bamp.PlaneState._fields])
    buf = torch.zeros(4, dtype=torch.bfloat16)
    x._k5_split = ("default", buf, var, x._version, var._version)
    assert k5.kept_split(ps, "default") is buf
    assert k5.kept_split(ps, "high") is None
    assert k5.kept_split(ps) is None
    var.add_(1.0)
    assert k5.kept_split(ps, "default") is None
