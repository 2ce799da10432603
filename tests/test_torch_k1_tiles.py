"""What the register-tiled whole-decode kernel K1
(``ops/kernels/csrc/fused_bamp_decode.cu``) rests on, checked on the CPU:
its shared-memory carve-out and the routes that depend on it, the tile
maps of its forward and adjoint passes, the in-place reuse of the forward
products' slots for the adjoint inputs, and the order of its segment and
symbol sums against PyTorch's reduction order.  The kernel itself runs
only on the card (``chip_smoke.py``)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu_torch import config as tconfig
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.models import bamp
from amp_sparc_spatialmodulation_tpu_torch.ops import operators
from amp_sparc_spatialmodulation_tpu_torch.ops.channel import band_indices
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import build, fused_bamp
from amp_sparc_spatialmodulation_tpu_torch.utils.device import make_generator

SOURCE = (build.CSRC / "fused_bamp_decode.cu").read_text()


def kernel_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


KFR, KAR = kernel_constant("kFR"), kernel_constant("kAR")

SMALL = dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, mode="segmented",
             profile="uniform")
# chip_smoke.py's small K1 geometries, the flagship configs and massive
# MIMO, with the route each takes.
ROUTES = [
    ("ook_tail", dict(SMALL, alphabet="OOK", trunc="tail"), "whole"),
    ("ook_trunc", dict(SMALL, alphabet="OOK", trunc="trunc"), "whole"),
    ("ook_cyclic", dict(SMALL, alphabet="OOK", trunc="cyclic"), "whole"),
    ("qpsk_tail", dict(SMALL, alphabet="QPSK", trunc="tail"), "whole"),
    ("8psk_tail", dict(SMALL, alphabet="8PSK", trunc="tail"), "whole"),
    ("ook_m6", dict(SMALL, alphabet="OOK", trunc="tail", Nt=24), "whole"),
    ("random_qpsk", dict(SMALL, alphabet="QPSK", trunc="tail",
                         mode="random"), "whole"),
    ("flagship_ook", "flagship_bamp_ook", "whole"),
    ("flagship_qpsk", "flagship_bamp_qpsk", "whole"),
    ("massive", "massive_mimo", "tiled"),
]


def make_config(spec):
    return getattr(tconfig, spec)() if isinstance(spec, str) \
        else Config(**spec)


def old_smem_bytes(cfg):
    """The carve-out of the kernel before the register tiles: 5 x-side
    planes (6 complex), 5 y-side and 3 adjoint-input planes."""
    return 4 * ((5 if fused_bamp.real_x(cfg) else 6) * cfg.N + 5 * cfg.n
                + 3 * cfg.Lin * cfg.Lh * cfg.Nr)


@pytest.mark.parametrize("name,spec,route", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_route_and_fit(name, spec, route, monkeypatch):
    monkeypatch.delenv("AMP_PALLAS_MODE", raising=False)
    cfg = make_config(spec)
    gen = make_generator(torch.device("cpu"), 3)
    op = (operators.banded_toeplitz(gen, cfg) if cfg.mode == "random"
          else operators.banded_sparc(gen, cfg)[1])
    assert bamp.route(cfg, op, 64, "cpu") == route
    assert fused_bamp.fits(cfg) == (route == "whole")
    # the tiles never need more shared memory than the kernel before them
    if route == "whole":
        assert fused_bamp.smem_bytes(cfg) <= old_smem_bytes(cfg)


def test_flagship_carve_out_gives_three_blocks_per_sm():
    flag = tconfig.flagship_bamp_ook()
    assert fused_bamp.scratch_row(flag) == 24
    assert fused_bamp.smem_bytes(flag) == 68800
    # three blocks, with the 1 KB CUDA reserves for each, fit an SM's 228 KB
    assert 3 * (fused_bamp.smem_bytes(flag) + 1024) <= 228 * 1024
    assert old_smem_bytes(flag) == 79040
    # Nr = 10 pads each scratch row to 12 floats (16-byte rows)
    odd = Config(**dict(SMALL, Nr=10, alphabet="QPSK", trunc="tail"))
    assert fused_bamp.scratch_row(odd) == 12
    assert fused_bamp.smem_bytes(odd) == 4 * (3 * 8 * 3 * 12 + 5 * 128
                                              + 5 * 100)


def _src_block(r, l, cfg):
    c = r - l
    if cfg.trunc == "cyclic":
        return c % cfg.Lin
    return c if 0 <= c < cfg.Lin else -1


def _dst_block(c, l, cfg):
    r = c + l
    if cfg.trunc == "cyclic":
        return r % cfg.Lin
    return r if r < cfg.Lout else -1


TILE_CASES = [dict(SMALL, alphabet="OOK", trunc=t) for t in
              ("tail", "trunc", "cyclic")] + [
    dict(SMALL, alphabet="OOK", trunc="tail", Lin=25, Nr=10, Lh=6),
    dict(Nt=128, Na=8, Nr=24, Lin=20, Lh=3, mode="segmented",
         alphabet="OOK", profile="uniform", trunc="tail")]


@pytest.mark.parametrize("kw", TILE_CASES,
                         ids=["tail", "trunc", "cyclic", "lin25", "flagship"])
def test_tiles_cover_every_product_once(kw):
    """The kernel's tile maps (mirrored from fused_bamp_decode.cu): the
    forward tiles produce every (c, l, m) of a placed block once, the fold
    reads and rewrites exactly those slots, one output each, and the
    adjoint tiles produce every x element once."""
    cfg = Config(**kw)
    Lin, Lh, Nr, Nt = cfg.Lin, cfg.Lh, cfg.Nr, cfg.Nt
    placed = {(int(c), l) for l in range(Lh)
              for c in band_indices(Lin, cfg.Lout, l, cfg.trunc)[1]}
    cols = Lh * Nr
    produced = []
    for f in range(-(-Lin // KFR) * cols):
        g = f // cols
        l, m = divmod(f - g * cols, Nr)
        produced += [(c, l, m) for c in range(g * KFR, g * KFR + KFR)
                     if c < Lin and _dst_block(c, l, cfg) >= 0]
    want = sorted((c, l, m) for c, l in placed for m in range(Nr))
    assert sorted(produced) == want
    folded = [(_src_block(r, l, cfg), l, m) for r in range(cfg.Lout)
              for m in range(Nr) for l in range(Lh)
              if _src_block(r, l, cfg) >= 0]
    assert sorted(folded) == want
    adj = []
    for f in range(-(-Lin // KAR) * Nt):
        g, k = divmod(f, Nt)
        adj += [(c, k) for c in range(g * KAR, g * KAR + KAR) if c < Lin]
    assert sorted(adj) == [(c, k) for c in range(Lin) for k in range(Nt)]


def _last_pow2(n):
    w = 1
    while 2 * w <= n:
        w *= 2
    return w


def _torch_sum(v):
    """decode_common.cuh's torch_sum: lane_sum per lane, then the tree."""
    n, f = len(v), np.float32
    w = 32 if n >= 32 else _last_pow2(n)
    lanes = []
    for t in range(w):
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
        lanes.append(((acc[0] + acc[1]) + acc[2]) + acc[3])
    off = w // 2
    while off >= 1:
        for t in range(off):
            lanes[t] = lanes[t] + lanes[t + off]
        off //= 2
    return lanes[0]


def _group_sum(v):
    """The kernel's group sum: element s of lane t to accumulator s % 4,
    then the shuffle tree over the group's lanes."""
    n, f = len(v), np.float32
    G = 32 if n >= 32 else _last_pow2(n)
    lanes = []
    for t in range(G):
        acc = [f(0)] * 4
        for s, i in enumerate(range(t, n, G)):
            acc[s % 4] = acc[s % 4] + v[i]
        lanes.append(((acc[0] + acc[1]) + acc[2]) + acc[3])
    off = G // 2
    while off >= 1:
        for t in range(off):
            lanes[t] = lanes[t] + lanes[t + off]
        off //= 2
    return lanes[0]


def _small_sum(v):
    """The kernel's small_sum_w for n <= 16: lane t holds t and t + W."""
    n, f = len(v), np.float32
    W = _last_pow2(n)
    lanes = []
    for t in range(W):
        a1 = f(0) + v[t + W] if t + W < n else f(0)
        lanes.append((((f(0) + v[t]) + a1) + f(0)) + f(0))
    off = W // 2
    while off >= 1:
        for t in range(off):
            lanes[t] = lanes[t] + lanes[t + off]
        off //= 2
    return lanes[0]


def test_sums_follow_pytorch_order():
    """The kernel's lane-group segment sum and its register-only symbol
    sum give torch_sum's result bit for bit (values spread over 12 orders
    of magnitude and both signs, so another order would differ)."""
    rng = np.random.default_rng(0)
    for n in range(1, 97):
        v = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)
             ).astype(np.float32)
        v[rng.random(n) < 0.1] = np.float32(-0.0)
        assert _group_sum(list(v)).tobytes() == \
            _torch_sum(list(v)).tobytes(), n
        if n <= 16:
            assert _small_sum(list(v)).tobytes() == \
                _torch_sum(list(v)).tobytes(), n
