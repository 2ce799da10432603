"""What the register-tiled SCAMP whole-decode kernel K2
(``ops/kernels/csrc/fused_scamp_decode.cu``) rests on, checked on the CPU:
its shared-memory carve-out against the one before the tiles, its blocks
per SM at the main geometry, the tile maps of its forward and adjoint
passes, the fold's in-place reuse of the forward products' slots for the
adjoint inputs, and the order of its sums and its lane-group denoiser
against the thread-per-segment form it replaced.  The kernel itself runs
only on the card (``chip_smoke.py``)."""
import re

import numpy as np
import pytest

from amp_sparc_spatialmodulation_tpu_torch.config import Config, flagship_scamp
from amp_sparc_spatialmodulation_tpu_torch.ops.channel import band_indices
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import build, fused_scamp
from test_torch_k1_tiles import (_dst_block, _group_sum, _last_pow2,
                                 _small_sum, _src_block, _torch_sum)

SOURCE = (build.CSRC / "fused_scamp_decode.cu").read_text()


def kernel_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


KFR, KAR, KAK = (kernel_constant(k) for k in ("kFR", "kAR", "kAK"))
KTHREADS, KMIN = kernel_constant("kThreads"), kernel_constant("kMinBlocks")
KFO = kernel_constant("kFO")

SMALL = dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, mode="sparc", profile="uniform")
MAIN = dict(Nt=128, Na=8, Nr=24, Lin=20, Lh=3, mode="sparc", alphabet="OOK",
            profile="uniform", trunc="tail")
# chip_smoke.py's K2 geometries (ook_estimate_phi shares ook_tail's planes)
GEOMETRIES = {
    "ook_tail": dict(SMALL, alphabet="OOK", trunc="tail"),
    "ook_trunc": dict(SMALL, alphabet="OOK", trunc="trunc"),
    "ook_cyclic": dict(SMALL, alphabet="OOK", trunc="cyclic"),
    "qpsk_tail": dict(SMALL, alphabet="QPSK", trunc="tail"),
    "8psk_tail": dict(SMALL, alphabet="8PSK", trunc="tail"),
    "main": MAIN,
    "flagship_scamp": None,
}


def make_config(spec):
    return flagship_scamp() if spec is None else Config(**spec)


def old_smem_bytes(cfg):
    """The carve-out of the kernel before the register tiles: 3 x-side
    planes (4 complex), 4 y-side planes, 2 adjoint-input planes and the
    psi, tau, phi and Onsager vectors."""
    return 4 * ((3 if fused_scamp.real_x(cfg) else 4) * cfg.N + 4 * cfg.n
                + 2 * cfg.Lin * cfg.Lh * cfg.Nr + 2 * (cfg.Lin + cfg.Lout))


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_carve_out_no_larger_than_before(name):
    cfg = make_config(GEOMETRIES[name])
    assert fused_scamp.covers(cfg) and fused_scamp.fits(cfg)
    assert fused_scamp.smem_bytes(cfg) <= old_smem_bytes(cfg)
    # the scratch planes end on 16 bytes, so the x-side rows that follow
    # take the forward tiles' 16-byte reads
    assert fused_scamp.scratch_plane(cfg) % 4 == 0


def test_main_geometry_blocks_per_sm():
    cfg = Config(**MAIN)
    assert fused_scamp.scratch_plane(cfg) == 1440
    assert fused_scamp.smem_bytes(cfg) == 40784
    assert old_smem_bytes(cfg) == 51024
    # an SM's 228 KB, with the 1 KB CUDA reserves for each block: five
    # blocks fit, at least as many as the registers are held to
    per_sm = 228 * 1024 // (fused_scamp.smem_bytes(cfg) + 1024)
    assert per_sm == 5 and per_sm >= KMIN


TILE_CASES = {
    "tail": dict(SMALL, alphabet="OOK", trunc="tail"),
    "trunc": dict(SMALL, alphabet="OOK", trunc="trunc"),
    "cyclic": dict(SMALL, alphabet="OOK", trunc="cyclic"),
    "lin25": dict(SMALL, alphabet="OOK", trunc="tail", Lin=25, Nr=10, Lh=6),
    "main": MAIN,
    "flagship_scamp": None,
}


def _placed(cfg):
    return {(int(c), l) for l in range(cfg.Lh)
            for c in band_indices(cfg.Lin, cfg.Lout, l, cfg.trunc)[1]}


@pytest.mark.parametrize("name", list(TILE_CASES))
def test_tiles_cover_every_product_once(name):
    """The kernel's tile maps (mirrored from fused_scamp_decode.cu): the
    forward tiles produce every (c, l, m) of a placed block once, the
    adjoint tiles every x element once, and the threads from the top form
    tau of every column block once."""
    cfg = make_config(TILE_CASES[name])
    Lin, Lh, Nr, Nt = cfg.Lin, cfg.Lh, cfg.Nr, cfg.Nt
    cols = Lh * Nr
    KS = -(-Nt // KAK)
    fwd_tiles = -(-Lin // KFR) * cols
    produced = []
    for f in range(fwd_tiles):
        g = f // cols
        l, m = divmod(f - g * cols, Nr)
        produced += [(c, l, m) for c in range(g * KFR, g * KFR + KFR)
                     if c < Lin and _dst_block(c, l, cfg) >= 0]
    want = sorted((c, l, m) for c, l in _placed(cfg) for m in range(Nr))
    assert sorted(produced) == want
    adj = []
    for f in range(-(-Lin // KAR) * KS):
        g, k0 = divmod(f, KS)
        adj += [(c, k) for c in range(g * KAR, g * KAR + KAR) if c < Lin
                for k in range(k0, k0 + KAK * KS, KS) if k < Nt]
    assert sorted(adj) == [(c, k) for c in range(Lin) for k in range(Nt)]
    tau = [c for tid in range(KTHREADS)
           for c in range(KTHREADS - 1 - tid, Lin, KTHREADS)]
    assert sorted(tau) == list(range(Lin))
    # the fold's kFO interleaved outputs per thread, each output once
    fold = [o for tid in range(KTHREADS)
            for o0 in range(tid, cfg.n, KTHREADS * KFO)
            for o in range(o0, o0 + KTHREADS * KFO, KTHREADS) if o < cfg.n]
    assert sorted(fold) == list(range(cfg.n))
    if name == "main":
        # there the tau threads carry no forward tile
        assert fwd_tiles <= KTHREADS - Lin


@pytest.mark.parametrize("name", list(TILE_CASES))
def test_fold_reads_and_rewrites_its_own_slots(name):
    """Each output (r, m) of the fold reads the slots P[c, l, m] of the
    taps that place a block on row block r and writes the adjoint inputs
    into exactly those slots: the slots of two outputs never meet, so the
    in-place write races with no read, every placed slot is rewritten and
    the slots of unplaced (c, l) stay zero."""
    cfg = make_config(TILE_CASES[name])
    Lh, Nr = cfg.Lh, cfg.Nr
    slot = {}
    for r in range(cfg.Lout):
        for m in range(Nr):
            for l in range(Lh):
                c = _src_block(r, l, cfg)
                if c >= 0:
                    e = (c * Lh + l) * Nr + m
                    assert e not in slot
                    slot[e] = (r, m)
    placed = {(c * Lh + l) * Nr + m for c, l in _placed(cfg)
              for m in range(Nr)}
    assert set(slot) == placed
    # the estimate_phi pass writes the same slots, each from the output
    # r = dst_block(c, l) the fold read it for
    for e, (r, m) in slot.items():
        c, rest = divmod(e, Lh * Nr)
        l, m2 = divmod(rest, Nr)
        assert (_dst_block(c, l, cfg), m2) == (r, m)


def _section(start, end):
    i = SOURCE.index(start)
    return SOURCE[i:SOURCE.index(end, i)]


def test_in_place_adjoint_inputs_only_without_estimate_phi():
    """The fold writes the adjoint inputs only when estimate_phi is false;
    with it, phi' waits for the row block's mean of |z'|^2 and a pass of
    its own writes them after that, where tau is formed too."""
    fold = _section("// ---- fold", "__syncthreads();")
    assert "if (!est) {" in fold
    assert fold.index("if (!est) {") < fold.index("Pr[e] = g * wr[d];")
    forward = _section("// ---- forward", "__syncthreads();")
    assert "if (!est)" in forward and "tau[c] = tau_of(p, phi, c);" in forward
    est = _section("if (est) {", "// ---- adjoint")
    assert est.index("phi[r] = s * p.inv_Mr;") \
        < est.index("tau[c] = tau_of(p, phi, c);") \
        < est.index("Pr[e] = g * (z_re[o] / phi[r]);")
    gma = _section("// ---- gma", "__syncthreads();")
    assert "if (!est) phi[r] = g + p.sigma2;" in gma


def test_sums_follow_pytorch_order():
    """The kernel's lane-group segment sum and register-only symbol sum
    (K2's copies of K1's) and the warp-wide gma sum give torch_sum's
    result bit for bit (values over 12 orders of magnitude and both
    signs, so another order would differ)."""
    rng = np.random.default_rng(1)
    for n in range(1, 97):
        v = list((rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)
                  ).astype(np.float32))
        ref = _torch_sum(v).tobytes()
        assert _group_sum(v).tobytes() == ref, n
        assert _warp_sum(v).tobytes() == ref, n
        if n <= 16:
            assert _small_sum(v).tobytes() == ref, n


def _warp_sum(v):
    """decode_common.cuh's warp_torch_sum (no vectorized loads): lanes
    below w take lane_sum, then the shfl_down tree."""
    n, f = len(v), np.float32
    w = 32 if n >= 32 else _last_pow2(n)
    lanes = [f(0)] * 32
    for t in range(w):
        lanes[t] = _torch_lane(v, t, w)
    off = w // 2
    while off >= 1:
        lanes = [lanes[t] + lanes[t + off] if t + off < 32 else lanes[t]
                 for t in range(32)]
        off //= 2
    return lanes[0]


def _torch_lane(v, t, w):
    """lane_sum of lane t of w lanes over v."""
    n, f = len(v), np.float32
    acc, idx = [f(0)] * 4, t
    while idx + 3 * w < n:
        for i in range(4):
            acc[i] = acc[i] + v[idx + i * w]
        idx += 4 * w
    for i in range(4):
        if idx >= n:
            break
        acc[i] = acc[i] + v[idx]
        idx += w
    return ((acc[0] + acc[1]) + acc[2]) + acc[3]


def _fmaf(a, b, c):
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _t_of(a, b, sr, si, real):
    """Re((a + ib) conj(s)) as the kernel rounds it."""
    return a * sr if real else _fmaf(a, sr, b * si)


def _eta(t, mx):
    return np.exp(np.minimum(t - mx, np.float32(87.72283905206835)))


def _segment_mean(x, tau, sr, si, real):
    """decode_common.cuh's segment_posterior<false> (one thread per
    segment), the denoiser K2 ran before the lane groups."""
    M, K = len(x), len(sr)
    tau = tau / np.float32(2)
    t = [[_t_of(x[i].real / tau, x[i].imag / tau, sr[q], si[q], real)
          for q in range(K)] for i in range(M)]
    mx = np.float32(max(max(row) for row in t))
    e = [[_eta(t[i][q], mx) for q in range(K)] for i in range(M)]
    em = [e[i][0] if K == 1 else _torch_sum(e[i]) for i in range(M)]
    eta2 = _torch_sum(em)
    out = []
    for i in range(M):
        if K == 1:
            post = e[i][0] / eta2
            out.append((sr[0] * post, si[0] * post))
        else:
            out.append((_torch_sum([sr[q] * e[i][q] for q in range(K)]) / eta2,
                        _torch_sum([si[q] * e[i][q] for q in range(K)]) / eta2))
    return out


def _group_mean(x, tau, sr, si, real):
    """The kernel's group_mean: G lanes, lane t holding elements t, t+G,
    ...; the max and the sum through the shuffle trees; register-only
    symbol sums."""
    M, K = len(x), len(sr)
    G = 32 if M >= 32 else _last_pow2(M)
    tau = tau / np.float32(2)

    def t_of(i, q):
        return _t_of(x[i].real / tau, x[i].imag / tau, sr[q], si[q], real)

    mx = np.float32(max(t_of(i, q) for i in range(M) for q in range(K)))

    def eta_m(i):
        e = [_eta(t_of(i, q), mx) for q in range(K)]
        return e[0] if K == 1 else _small_sum(e)

    lanes = []
    for t in range(G):
        acc = [np.float32(0)] * 4
        for s, i in enumerate(range(t, M, G)):
            acc[s % 4] = acc[s % 4] + eta_m(i)
        lanes.append(((acc[0] + acc[1]) + acc[2]) + acc[3])
    off = G // 2
    while off >= 1:
        for t in range(off):
            lanes[t] = lanes[t] + lanes[t + off]
        off //= 2
    eta2 = lanes[0]
    out = []
    for i in range(M):
        e = [_eta(t_of(i, q), mx) for q in range(K)]
        if K == 1:
            post = e[0] / eta2
            out.append((sr[0] * post, si[0] * post))
        else:
            out.append((_small_sum([sr[q] * e[q] for q in range(K)]) / eta2,
                        _small_sum([si[q] * e[q] for q in range(K)]) / eta2))
    return out


@pytest.mark.parametrize("alphabet,M", [("OOK", 16), ("OOK", 6),
                                        ("QPSK", 4), ("8PSK", 64)])
def test_group_mean_matches_segment_posterior(alphabet, M):
    """The lane-group denoiser gives the thread-per-segment posterior
    means bit for bit, for one symbol (OOK), a segment that is not a power
    of two, and complex alphabets over one and two lane rounds."""
    Nt = M * 4
    cfg = Config(Nt=Nt, Na=4, Nr=8, Lin=2, Lh=1, mode="sparc",
                 alphabet=alphabet, profile="uniform", trunc="tail")
    assert cfg.M == M
    sym = np.asarray(cfg.symbols, dtype=np.complex64)
    sr, si = sym.real.astype(np.float32), sym.imag.astype(np.float32)
    real = fused_scamp.real_x(cfg)
    rng = np.random.default_rng(M)
    for _ in range(3):
        x = (rng.standard_normal(M) + (0 if real else 1j)
             * rng.standard_normal(M)).astype(np.complex64)
        x[rng.integers(M)] += np.complex64(3.0)
        tau = np.float32(rng.uniform(0.05, 2.0))
        got = _group_mean(x, tau, sr, si, real)
        want = _segment_mean(x, tau, sr, si, real)
        assert np.array(got, np.float32).tobytes() \
            == np.array(want, np.float32).tobytes()
