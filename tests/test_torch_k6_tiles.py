"""What the register-tiled per-iteration kernel K6/K7
(``ops/kernels/csrc/fused_bamp_iteration.cu``) rests on, checked on the
CPU: its shared-memory carve-out against the one before the tiles and the
routes that depend on it, the tile maps of its forward and adjoint passes,
the fold's in-place reuse of the forward products' slots, xmap written over
x in place, and its lane-group K=1 denoiser against the plain version's
arithmetic.  The kernel itself runs only on the card (``chip_smoke.py``)."""
import re

import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu_torch import config as tconfig
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.models import bamp
from amp_sparc_spatialmodulation_tpu_torch.ops import operators
from amp_sparc_spatialmodulation_tpu_torch.ops.channel import band_indices
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
    build, fused_bamp, fused_bamp_iteration as fbi)
from amp_sparc_spatialmodulation_tpu_torch.utils.device import make_generator
from test_torch_k1_tiles import (ROUTES, _dst_block, _group_sum, _last_pow2,
                                 _src_block, _torch_sum, make_config)

SOURCE = (build.CSRC / "fused_bamp_iteration.cu").read_text()


def kernel_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


KFR, KAR, KTHREADS = (kernel_constant(k) for k in ("kFR", "kAR", "kThreads"))

SMALL = dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, mode="segmented",
             profile="uniform")
# chip_smoke.py's K6/K7 geometries (phase_kernels_periter)
PERITER = {
    "ook_tail": dict(SMALL, alphabet="OOK", trunc="tail"),
    "ook_trunc": dict(SMALL, alphabet="OOK", trunc="trunc"),
    "ook_cyclic": dict(SMALL, alphabet="OOK", trunc="cyclic"),
    "qpsk": dict(SMALL, alphabet="QPSK", trunc="tail"),
    "8psk": dict(SMALL, alphabet="8PSK", trunc="tail"),
    "flagship": "flagship_bamp_ook",
}


def old_smem_bytes(cfg):
    """The carve-out of the kernel before the register tiles: 6 x-side
    planes, 5 y-side planes and 3 adjoint-input planes."""
    return 4 * (6 * cfg.N + 5 * cfg.n + 3 * cfg.Lin * cfg.Lh * cfg.Nr)


def test_flagship_carve_out_gives_three_blocks_per_sm():
    flag = tconfig.flagship_bamp_ook()
    assert fbi.smem_bytes(flag) == 68800
    assert old_smem_bytes(flag) == 89280
    # three blocks, with the 1 KB CUDA reserves for each, fit an SM's
    # 228 KB, as __launch_bounds__ asks
    assert 3 * (fbi.smem_bytes(flag) + 1024) <= 228 * 1024
    assert "__launch_bounds__(kThreads, 3)" in SOURCE
    # Nr = 10 pads each scratch row to 12 floats (16-byte rows)
    odd = Config(**dict(SMALL, Nr=10, alphabet="OOK", trunc="tail"))
    assert fbi.smem_bytes(odd) == 4 * (3 * 8 * 3 * 12 + 4 * 128 + 5 * 100)


@pytest.mark.parametrize("name", list(PERITER))
def test_carve_out_no_larger_than_before(name):
    cfg = make_config(PERITER[name])
    assert fbi.fits(cfg)
    assert fbi.smem_bytes(cfg) <= old_smem_bytes(cfg)
    # the scratch planes end on 16 bytes, so the x-side rows that follow
    # take the forward tiles' 16-byte reads
    assert (3 * cfg.Lin * cfg.Lh * fused_bamp.scratch_row(cfg)) % 4 == 0


ROUTE_CASES = [(name, spec) for name, spec, _ in ROUTES] + [
    (f"periter_{k}", v) for k, v in PERITER.items()]


@pytest.mark.parametrize("mode", ["whole", "periter"])
@pytest.mark.parametrize("name,spec", ROUTE_CASES,
                         ids=[c[0] for c in ROUTE_CASES])
def test_routes_unchanged(name, spec, mode, monkeypatch):
    """The smaller carve-out admits more geometries to K6, but every route
    of K1's and chip_smoke's periter configs stays what it was under the
    old one, and massive MIMO still declines K6."""
    monkeypatch.setenv("AMP_PALLAS_MODE", mode)
    cfg = make_config(spec)
    gen = make_generator(torch.device("cpu"), 3)
    op = (operators.banded_toeplitz(gen, cfg) if cfg.mode == "random"
          else operators.banded_sparc(gen, cfg)[1])
    now = bamp.route(cfg, op, 64, "cpu")
    monkeypatch.setattr(fbi, "smem_bytes", old_smem_bytes)
    assert bamp.route(cfg, op, 64, "cpu") == now
    if name == "massive":
        monkeypatch.undo()
        assert not fbi.fits(cfg) and now == "tiled"


def _placed(cfg):
    return {(int(c), l) for l in range(cfg.Lh)
            for c in band_indices(cfg.Lin, cfg.Lout, l, cfg.trunc)[1]}


TILE_CASES = {
    "tail": dict(SMALL, alphabet="OOK", trunc="tail"),
    "trunc": dict(SMALL, alphabet="OOK", trunc="trunc"),
    "cyclic": dict(SMALL, alphabet="OOK", trunc="cyclic"),
    "lin25": dict(SMALL, alphabet="OOK", trunc="tail", Lin=25, Nr=10, Lh=6),
    "flagship": "flagship_bamp_ook",
}


@pytest.mark.parametrize("name", list(TILE_CASES))
def test_tiles_cover_every_product_once(name):
    """The kernel's tile maps (mirrored from fused_bamp_iteration.cu): the
    forward tiles produce every (c, l, m) of a placed block once and the
    adjoint tiles every x element once."""
    cfg = make_config(TILE_CASES[name])
    Lin, Lh, Nr, Nt = cfg.Lin, cfg.Lh, cfg.Nr, cfg.Nt
    cols = Lh * Nr
    produced = []
    for f in range(-(-Lin // KFR) * cols):
        g = f // cols
        l, m = divmod(f - g * cols, Nr)
        produced += [(c, l, m) for c in range(g * KFR, g * KFR + KFR)
                     if c < Lin and _dst_block(c, l, cfg) >= 0]
    want = sorted((c, l, m) for c, l in _placed(cfg) for m in range(Nr))
    assert sorted(produced) == want
    adj = []
    for f in range(-(-Lin // KAR) * Nt):
        g, k = divmod(f, Nt)
        adj += [(c, k) for c in range(g * KAR, g * KAR + KAR) if c < Lin]
    assert sorted(adj) == [(c, k) for c in range(Lin) for k in range(Nt)]
    if name == "flagship":
        # one round of forward tiles, two full rounds of adjoint tiles
        assert -(-Lin // KFR) * cols <= KTHREADS
        assert -(-Lin // KAR) * Nt == 2 * KTHREADS


@pytest.mark.parametrize("name", list(TILE_CASES))
def test_fold_reads_and_rewrites_its_own_slots(name):
    """Each output (r, m) of the fold reads the slots P[c, l, m] of the
    taps that place a block on row block r and writes the adjoint inputs
    into exactly those slots: the slots of two outputs never meet, every
    placed slot is rewritten, and the slots of unplaced (c, l) and the row
    padding stay zero."""
    cfg = make_config(TILE_CASES[name])
    Lh, Nr = cfg.Lh, cfg.Nr
    NrP = fused_bamp.scratch_row(cfg)
    slot = {}
    for r in range(cfg.Lout):
        for m in range(Nr):
            for l in range(Lh):
                c = _src_block(r, l, cfg)
                if c >= 0:
                    e = (c * Lh + l) * NrP + m
                    assert e not in slot
                    slot[e] = (r, m)
    placed = {(c * Lh + l) * NrP + m for c, l in _placed(cfg)
              for m in range(Nr)}
    assert set(slot) == placed
    assert all(e % NrP < Nr for e in slot)


def _section(start, end, text=SOURCE):
    i = text.index(start)
    return text[i:text.index(end, i)]


@pytest.mark.parametrize("name", list(TILE_CASES))
def test_xmap_overwrites_x_in_place(name):
    """xmap goes over x: every x element belongs to one adjoint thread
    (one tile), which reads it and then writes xmap there; the adjoint
    tiles read no other x element, and barriers close the forward pass
    (the last reader of x) before the adjoint pass and the adjoint pass
    before the denoiser."""
    cfg = make_config(TILE_CASES[name])
    owner = {}
    for f in range(-(-cfg.Lin // KAR) * cfg.Nt):
        g, k = divmod(f, cfg.Nt)
        for c in range(g * KAR, min(g * KAR + KAR, cfg.Lin)):
            j = c * cfg.Nt + k
            assert j not in owner
            owner[j] = f % KTHREADS
    assert sorted(owner) == list(range(cfg.N))
    tile = _section("__device__ __forceinline__ void adjoint_tile(",
                    "// K6's denoiser.")
    body = tile[tile.index("{"):]
    assert re.findall(r"xm_(?:re|im)\[[^\]]*\]", body) == [
        "xm_re[j]", "xm_re[j]", "xm_im[j]", "xm_im[j]"]
    assert "xm_re[j] = xm_re[j] + cv * ar[i];" in body
    kernel = SOURCE[SOURCE.index("iteration_kernel(Params p)"):]
    order = [kernel.index(h) for h in (
        "// ---- forward", "// ---- fold", "// ---- adjoint",
        "// ---- denoiser", "copy(p.xmap_re + xo, xm_re, N, wide);")]
    assert order == sorted(order)
    for a, b in zip(order, order[1:]):
        assert "__syncthreads();" in kernel[a:b]


def _fmaf(a, b, c):
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _exp(a):
    """The exponential of the CPU plain version (PyTorch's), elementwise."""
    return torch.exp(torch.as_tensor(np.float32(a))).numpy()[()]


def _k6_denoiser(x, cov, old, s0, M):
    """The kernel's group_k1 over one trial: G lanes per segment, lane t
    holding elements t, t+G, ...; the max and the sum through the shuffle
    trees; the closed-form variance; the count of variance entries outside
    the allclose tolerance of ``old``."""
    f = np.float32
    sr, si = f(s0.real), f(s0.imag)
    s2 = f(np.hypot(sr, si)) * f(np.hypot(sr, si))
    G = 32 if M >= 32 else _last_pow2(M)
    mean, var = np.empty(len(x), np.complex64), np.empty(len(x), f)
    bad = 0
    for j0 in range(0, len(x), M):
        def t_of(i):
            tau = cov[j0 + i] / f(2)
            return _fmaf(x[j0 + i].real / tau, sr, (x[j0 + i].imag / tau) * si)

        lane_max = [max(t_of(i) for i in range(t, M, G)) for t in range(G)]
        mx = f(max(lane_max))
        eta = [_exp(min(t_of(i) - mx, f(87.72283905206835)))
               for i in range(M)]
        eta2 = _group_sum(eta)
        for i in range(M):
            post = eta[i] / eta2
            vn = s2 * post * (f(1) - post)
            o = old[j0 + i]
            bad += not abs(vn - o) <= f(1e-8) + f(1e-5) * abs(o)
            mean[j0 + i] = np.complex64(complex(sr * post, si * post))
            var[j0 + i] = vn
    return mean, var, bad


def _cuda_order_sum(orig):
    """Tensor.sum with the last dimension of a 3-d float32 tensor summed in
    the order of PyTorch's CUDA reduction (torch_sum), as on the card."""
    def sum_(self, *args, **kw):
        dim = args[0] if args else kw.get("dim")
        if dim != -1 or self.ndim != 3 or self.dtype != torch.float32:
            return orig(self, *args, **kw)
        rows = self.numpy().reshape(-1, self.shape[-1])
        return torch.as_tensor(np.array([_torch_sum(list(r)) for r in rows],
                                        np.float32).reshape(self.shape[:-1]))
    return sum_


@pytest.mark.parametrize("M", [2, 4, 8, 16, 32, 64])
def test_group_denoiser_matches_make_k1_denoiser(M, monkeypatch):
    """The lane-group K=1 denoiser gives ``bamp.make_k1_denoiser``'s
    posterior mean and closed-form variance bit for bit, and its notok
    count equals the plain step's.  PyTorch sums a segment on the CPU in
    another order than its CUDA reduction, which the kernel and the card's
    plain version share, so the plain version runs here with that
    reduction's order (``_torch_sum``, pinned against the kernel's group
    sum by test_torch_k1_tiles.py)."""
    cfg = Config(Nt=4 * M, Na=4, Nr=8, Lin=2, Lh=1, mode="segmented",
                 alphabet="OOK", profile="uniform", trunc="tail")
    assert cfg.M == M and fbi.covers(cfg)
    rng = np.random.default_rng(M)
    B, N = 3, cfg.N
    x = (rng.standard_normal((B, N))
         + 1j * rng.standard_normal((B, N))).astype(np.complex64)
    x[:, ::M] += np.complex64(2.0)          # a leading lane per segment
    cov = rng.uniform(0.05, 2.0, (B, N)).astype(np.float32)
    den = bamp.make_k1_denoiser(cfg, torch.device("cpu"))
    monkeypatch.setattr(torch.Tensor, "sum", _cuda_order_sum(torch.Tensor.sum))
    mean, var = den(torch.as_tensor(x), torch.as_tensor(cov))
    # old variances: some equal, some within the tolerance, some outside
    old = var.numpy().copy()
    pick = rng.random((B, N))
    old[pick < 0.3] *= np.float32(1 + 1e-3)
    old[(pick >= 0.3) & (pick < 0.6)] *= np.float32(1 + 1e-7)
    notok = bamp._notok_rows(var, torch.as_tensor(old))
    monkeypatch.undo()
    s0 = np.asarray(cfg.symbols, np.complex64)[0]
    for b in range(B):
        m_b, v_b, bad = _k6_denoiser(x[b], cov[b], old[b], s0, M)
        assert m_b.tobytes() == mean[b].numpy().tobytes()
        assert v_b.tobytes() == var[b].numpy().tobytes()
        assert bad == int(notok[b]) and 0 < bad < N
