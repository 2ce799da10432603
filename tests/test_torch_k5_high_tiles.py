"""What the HIGH form of the frame-tiled iteration K5
(``ops/kernels/csrc/fused_bamp_tiled.cu``, ``high_product_kernel``) rests
on, checked on the CPU: its form constants against the wrapper's mirror,
the split layout of its operands (``split_at``, ``split_tiles``) with its
zero pads, the fold's pad cover, the ldmatrix fragments the layout gives
each lane (the mma operands, free of bank conflicts), a NumPy mirror of
both forms' products through that layout and their epilogue's output map
against ``precision.dot3``'s three passes (and, for the DEFAULT form's
own engine on its hi-only layout, its one pass against
``precision.dot1``), the rule that
picks the small form, and the BAMP route's refusal of the JAX package's
xmap-precision knob.  The kernel itself runs only on the card (``chip_smoke.py``)."""
import re

import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu_torch.config import Config, massive_mimo
from amp_sparc_spatialmodulation_tpu_torch.models import bamp
from amp_sparc_spatialmodulation_tpu_torch.ops import precision as prec
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
    build, fused_bamp_tiled as k5)

SOURCE = (build.CSRC / "fused_bamp_tiled.cu").read_text()


def high_form(name):
    """(WM, WN, MT, NT, S, MIN) of the kernel's form ``name``."""
    m = re.search(rf"using {name} = HighForm<([\d, ]+)>;", SOURCE)
    return tuple(int(v) for v in m.group(1).split(","))


FORMS = {"large": high_form("HighLarge"), "small": high_form("HighSmall")}


def dims(form):
    WM, WN, MT, NT, S, _ = FORMS[form]
    return 16 * WM * MT, 8 * WN * NT, S


def test_wrapper_mirrors_the_high_forms():
    for form in FORMS:
        assert dims(form) == k5.FORMS_HIGH[form]
    for name, value in (("kHRows", k5.HIGH_ROWS), ("kHCols", k5.HIGH_COLS),
                        ("kStageSplit", k5.SPLIT_STAGE)):
        assert re.search(rf"constexpr int {name} = {value};", SOURCE)
    # a form's tiles slice the layout's tiles, with the swizzle's phase
    for form in FORMS:
        BM, BN, _ = dims(form)
        assert k5.HIGH_ROWS % BM == 0 and k5.HIGH_COLS % BN == 0
        assert BM % 8 == 0 and BN % 8 == 0
    assert FORMS["large"][5] == k5.PER_SM["high"] == 1
    # the carve-out smem_bytes mirrors: the ring, two parks, then the
    # mbarriers (one more for the adjoint's last epilogue)
    assert "smem_high + S * F::kSlot + 2 * F::kPark);" in SOURCE
    assert "return S * kSlot + 2 * kPark + 8 * (fwd ? S : S + 1);" in SOURCE


@pytest.mark.parametrize("rows,K,tile", [(150, 40, 128), (112, 438, 112),
                                         (37, 16, 128), (1, 5, 112)])
def test_split_tiles_is_split_at(rows, K, tile):
    """Every hi and lo of a split matrix sits where ``split_at`` puts it;
    every other bf16 (row and contraction pads) is zero."""
    g = torch.Generator().manual_seed(rows * K)
    m = torch.randn(rows, K, generator=g, dtype=torch.float32)
    buf = k5.split_tiles(m, tile).float()
    steps = k5.split_steps(K)
    assert steps % 2 == 0 and 16 * steps >= K > 16 * (steps - 2)
    assert buf.numel() == -(-rows // tile) * tile * steps * 32
    seen = torch.zeros(buf.numel(), dtype=torch.bool)
    for h, half in enumerate(prec.split_bf16(m)):
        idx = torch.tensor([[k5.split_at(steps, tile, R, k, h)
                             for k in range(K)] for R in range(rows)])
        assert torch.equal(buf[idx], half.float())
        seen[idx.flatten()] = True
    assert int(seen.sum()) == 2 * rows * K
    assert not buf[~seen].any()


def test_fold_covers_the_contraction_pad_once():
    """The HIGH fold's thread (b, r, m), r < Lin, zeros the pad columns W +
    m, W + m + Nr, ... < 16 kas (kas = ``split_steps(W)``) of row b Lin +
    r: each pad column of each row exactly once, at the massive and the
    small geometries."""
    for Nr, Lh in ((73, 6), (10, 3), (12, 5), (3, 2)):
        W = Nr * Lh
        end = 16 * k5.split_steps(W)
        got = [w for m in range(Nr) for w in range(W + m, end, Nr)]
        assert sorted(got) == list(range(W, end))


def ldmatrix(slot, addr):
    """ldmatrix.x4 from bf16 array ``slot`` with lane addresses ``addr``
    (32 bf16 offsets of 8-element rows): regs[m][T] = the pair (row T // 4,
    elements 2 (T % 4), + 1) of matrix m, whose rows lanes 8 m .. 8 m + 7
    address.  Returns (4, 32, 2) values (each of slot's trailing shape)."""
    out = np.empty((4, 32, 2) + slot.shape[1:], dtype=slot.dtype)
    for mat in range(4):
        for T in range(32):
            base = addr[8 * mat + T // 4] + 2 * (T % 4)
            out[mat, T] = slot[base:base + 2]
    return out


def bank_groups_distinct(addr):
    """Each ldmatrix phase (8 lanes, one 16-byte row each) on 8 different
    16-byte bank groups."""
    return all(len({(addr[l] * 2 // 16) % 8 for l in range(8 * p, 8 * p + 8)})
               == 8 for p in range(4))


def lane_addresses(form, wm, wn):
    """The kernel's ldmatrix addresses (bf16 offsets in a slot's A or tap
    tile) of each lane: a_hi[i], a_lo[i], b_at[j]."""
    _, _, MT, NT, _, _ = FORMS[form]
    chunk = lambda c, r: c ^ ((r >> 1) & 3)
    a_hi, a_lo, b_at = [], [], []
    for i in range(MT):
        rs = [16 * (MT * wm + i) + (l & 15) for l in range(32)]
        a_hi.append([r * 32 + chunk(l >> 4, r) * 8 for l, r in enumerate(rs)])
        a_lo.append([r * 32 + chunk(2 + (l >> 4), r) * 8
                     for l, r in enumerate(rs)])
    for j in range(NT):
        ns = [8 * (NT * wn + j) + (l & 7) for l in range(32)]
        b_at.append([n * 32 + chunk(l >> 3, n) * 8 for l, n in enumerate(ns)])
    return a_hi, a_lo, b_at


@pytest.mark.parametrize("form", ["large", "small"])
def test_fragments_are_the_mma_operands(form):
    """On a tile of index triples, the lanes' ldmatrix reads give each lane
    the m16n8k16 operands the mma takes: A (rows g, g + 8; k 2t.., 2t + 8..)
    of hi and lo, the taps (k 2t.., 2t + 8..; column g) of hi then lo; with
    no bank conflict."""
    BM, BN, _ = dims(form)
    WM, WN, MT, NT, _, _ = FORMS[form]
    tag = lambda rows: np.array([(r, k, h) for r in range(rows)
                                 for h in range(2) for k in range(16)])

    def tile_of(rows):
        # the slot's bf16, each the (row, k, half) it holds: split_at's
        # layout restricted to one tile of one step
        slot = np.empty((rows * 32, 3), dtype=np.int64)
        for r, k, h in tag(rows):
            slot[k5.split_at(1, rows, r, k, h)] = (r, k, h)
        return slot

    sa, sb = tile_of(BM), tile_of(BN)
    g, t = np.arange(32) // 4, np.arange(32) % 4
    for wm in range(WM):
        for wn in range(WN):
            a_hi, a_lo, b_at = lane_addresses(form, wm, wn)
            for i in range(MT):
                for h, addr in enumerate((a_hi[i], a_lo[i])):
                    assert bank_groups_distinct(addr)
                    regs = ldmatrix(sa, addr)
                    r0 = 16 * (MT * wm + i)
                    for mat in range(4):
                        for e in range(2):
                            want_r = r0 + g + 8 * (mat & 1)
                            want_k = 2 * t + 8 * (mat >> 1) + e
                            assert (regs[mat, :, e, 0] == want_r).all()
                            assert (regs[mat, :, e, 1] == want_k).all()
                            assert (regs[mat, :, e, 2] == h).all()
            for j in range(NT):
                assert bank_groups_distinct(b_at[j])
                regs = ldmatrix(sb, b_at[j])
                for mat in range(4):
                    for e in range(2):
                        assert (regs[mat, :, e, 0]
                                == 8 * (NT * wn + j) + g).all()
                        assert (regs[mat, :, e, 1]
                                == 2 * t + 8 * (mat & 1) + e).all()
                        assert (regs[mat, :, e, 2] == mat >> 1).all()


def mirror_product(form, A, Bt, one=False):
    """The kernel's product of one stage pass through the split layout, in
    float64: A (rows, K) and the taps Bt (cols, K) split and laid out as
    the wrapper and the split launch lay them (``split_tiles``); each block
    (the 1-D grid's order) copies each k16 step's slices of both tiles as
    the ring's bulk copies do; each warp reads its fragments at the lane
    addresses and runs hi hi + hi lo + lo hi per n8 x m16 tile, joined per
    step; the epilogue's map puts each lane's outputs at (R, n).  Returns
    (rows, cols).  ``one``: the DEFAULT form's engine
    (``default_product_kernel``): the hi halves alone in ``split1_at``'s
    layout, a slot one tile of two k16 steps of each operand, the lane
    addresses that give HIGH's hi and lo fragments giving step 0's and step
    1's hi, each step's hi hi from zero, joined in order."""
    BM, BN, _ = dims(form)
    WM, WN, MT, NT, _, _ = FORMS[form]
    rows, K = A.shape
    cols = Bt.shape[0]
    steps = k5.split_steps(K)
    layout = "default" if one else "high"
    xs = k5.split_tiles(A, k5.HIGH_ROWS, layout).float().numpy().astype(
        np.float64)
    ts = k5.split_tiles(Bt, k5.HIGH_COLS, layout).float().numpy().astype(
        np.float64)
    out = np.full((rows, cols), np.nan)
    col_tiles = -(-cols // BN)
    g, t = np.arange(32) // 4, np.arange(32) % 4

    def frag_a(regs):     # (4, 32, 2) -> 16 x 16
        m = np.zeros((16, 16))
        for mat in range(4):
            for e in range(2):
                m[g + 8 * (mat & 1), 2 * t + 8 * (mat >> 1) + e] = regs[mat, :, e]
        return m

    def frag_b(regs, half):   # -> 16 (k) x 8 (n)
        m = np.zeros((16, 8))
        for mat in (2 * half, 2 * half + 1):
            for e in range(2):
                m[2 * t + 8 * (mat & 1) + e, g] = regs[mat, :, e]
        return m

    tiles = steps // 2 if one else steps    # tiles along the contraction
    for blk in range(-(-rows // BM) * col_tiles):
        R0, n0 = blk // col_tiles * BM, blk % col_tiles * BN
        acc = {}
        for ks in range(tiles):
            a0 = ((R0 // k5.HIGH_ROWS * tiles + ks) * k5.HIGH_ROWS
                  + R0 % k5.HIGH_ROWS) * 32
            b0 = ((n0 // k5.HIGH_COLS * tiles + ks) * k5.HIGH_COLS
                  + n0 % k5.HIGH_COLS) * 32
            sa, sb = xs[a0:a0 + BM * 32], ts[b0:b0 + BN * 32]
            for wm in range(WM):
                for wn in range(WN):
                    a_hi, a_lo, b_at = lane_addresses(form, wm, wn)
                    for j in range(NT):
                        b = ldmatrix(sb, b_at[j])
                        bh, bl = frag_b(b, 0), frag_b(b, 1)
                        for i in range(MT):
                            ah = frag_a(ldmatrix(sa, a_hi[i]))
                            al = frag_a(ldmatrix(sa, a_lo[i]))
                            key = (wm, wn, i, j)
                            if one:     # step 2 ks, then step 2 ks + 1
                                acc[key] = acc.get(key, 0.0) + ah @ bh
                                acc[key] = acc[key] + al @ bl
                                continue
                            th = ah @ bh + ah @ bl + al @ bh
                            acc[key] = acc.get(key, 0.0) + th
        for (wm, wn, i, j), c in acc.items():
            R, n = np.meshgrid(R0 + 16 * (MT * wm + i) + np.arange(16),
                               n0 + 8 * (NT * wn + j) + np.arange(8),
                               indexing="ij")
            keep = (R < rows) & (n < cols)
            out[R[keep], n[keep]] = c[keep]
    return out


@pytest.mark.parametrize("form,rows,cols,K", [("large", 200, 130, 40),
                                              ("small", 70, 40, 24)])
def test_mirror_product_is_the_three_passes(form, rows, cols, K):
    """Both forms' products through the layout, the ring's copies, the
    fragments and the output map equal hi hi + hi lo + lo hi of the split
    operands (``precision.dot3``'s passes) in float64, on a ragged batch
    of rows, columns and contraction."""
    g = torch.Generator().manual_seed(rows + cols + K)
    A = torch.randn(rows, K, generator=g)
    Bt = torch.randn(cols, K, generator=g)
    got = mirror_product(form, A, Bt)
    (ah, al), (bh, bl) = (tuple(p.double() for p in prec.split_bf16(m))
                          for m in (A, Bt))
    want = (ah @ bh.T + ah @ bl.T + al @ bh.T).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # and the FP32 function within its rounding
    np.testing.assert_allclose(got, prec.dot3(A, Bt.T).numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("form,rows,cols,K", [("large", 200, 130, 40),
                                              ("small", 70, 40, 24)])
def test_mirror_product_one_pass_is_dot1(form, rows, cols, K):
    """The DEFAULT form's products (``default_product_kernel``: the hi hi
    mma alone on hi-only operands, two k16 steps a tile) through its
    copies, fragments and output map equal hi hi of the operands in
    float64, and ``precision.dot1`` within its rounding."""
    assert "default_product_kernel(Params p) {" in SOURCE
    assert ("a_at[k][i] = r * 32 + split_chunk(2 * k + (lane >> 4), r) * 8;"
            in SOURCE)
    assert ("mma_bf16_zero(th, a[k][i], b[j][2 * k], b[j][2 * k + 1]);"
            in SOURCE)
    g = torch.Generator().manual_seed(rows + cols + K + 1)
    A = torch.randn(rows, K, generator=g)
    Bt = torch.randn(cols, K, generator=g)
    got = mirror_product(form, A, Bt, one=True)
    want = (A.bfloat16().double() @ Bt.bfloat16().double().T).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, prec.dot1(A, Bt.T).numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("B,forms", [(2048, 0), (37, 3), (3, 3), (6, 3),
                                     (41, 1), (128, 1), (129, 0)])
def test_high_form_rule_at_the_massive_geometry(B, forms):
    """The small form where the large one would launch fewer blocks than
    the H100's 132 SMs: the forward (4 column tiles of 112) through 128
    trials, the adjoint (12 tiles) through 40; the ragged batch of 37."""
    m = massive_mimo()
    assert k5.tile_forms(B, m.Lin, m.Lh * m.Nr, m.Nt, "high") == forms


def test_split_sizes():
    """The split operand buffers: 2 planes of 2 ceil(Nt / 32) k16 steps
    for the forward, 4 of 2 ceil(W / 32) for the adjoint, in 128-row tiles
    of 64 bytes a row."""
    m = massive_mimo()
    assert k5.split_sizes(2048, m) == (2 * 512 * 128 * 32 * 84,
                                       4 * 512 * 128 * 32 * 28)
    small = Config(Nt=16, Na=4, Nr=10, Lin=8, Lh=3, mode="segmented",
                   alphabet="OOK", profile="uniform", trunc="tail")
    assert k5.split_sizes(37, small) == (2 * 3 * 128 * 32 * 2,
                                         4 * 3 * 128 * 32 * 2)


@pytest.mark.parametrize("value,raises", [("highest", False),
                                          ("HIGH", True), ("", False)])
def test_route_refuses_the_xmap_precision_knob(monkeypatch, value, raises):
    """The JAX package's K1 reads ``AMP_KERNEL_XMAP_PRECISION``
    (``fused_bamp.py:990-991`` there) and runs its xmap products at that
    precision; the port's K1 has that form (its split forms), so at 'high'
    the route takes K1 for 'highest' and refuses, naming the variable, only
    what JAX's ``make_dot`` refuses ('HIGH'), where K1 is taken; empty is
    unset.  tests/test_torch_xmap_split.py holds the rest of the route."""
    small = Config(Nt=16, Na=4, Nr=10, Lin=8, Lh=3, mode="segmented",
                   alphabet="OOK", profile="uniform", trunc="tail")
    monkeypatch.setenv("AMP_KERNEL_XMAP_PRECISION", value)
    if raises:
        with pytest.raises(ValueError, match="AMP_KERNEL_XMAP_PRECISION"):
            bamp.route_of(small, True, precision="high")
    else:
        assert bamp.route_of(small, True, precision="high") == "whole"
