"""The HIGH form of the port's frame-tiled iteration kernel K5
(``precision='high'``) against the JAX package on the CPU.

The plain HIGH iteration (``fused_bamp_tiled.iteration_plain(...,
'high')``: one ``bamp.step`` with ``bamp.linear_step_high`` on
``bamp.gauss_taps``, the function the kernel's HIGH form computes) against
JAX's ``TiledBandedIteration(precision=Precision.HIGH)`` in interpret mode,
on the shared inputs of ``tests/test_torch_tiled.py``:

* one step from ``mid_state``: the y-side planes (z, u) within 1e-6, the
  x-side planes (xmap, xm, var) within 1e-5 (the kernels sum their
  products in other orders and the denoiser's softmax amplifies it), notok
  equal on the active trials; JAX's HIGHEST step lies outside the 1e-6
  y-side tolerance, so the test tells the precisions apart;
* the plane loop at HIGH against JAX's plane loop on its K5 at HIGH, under
  the rule of ``tests/test_pallas_tiled.py:55-58``;
* the wrapper's split taps, forms and shared memory, the route at HIGH
  and the sweep engine at 'high' and 'auto' on a forced-tiled geometry;
  the massive geometry itself only built (its generation's products at
  HIGH against JAX's ``dot3``, the sweep's precision check), never
  decoded here at width.

The CUDA kernel is held against the plain HIGH version on the card by
``chip_smoke.py`` (``kernels_tiled_high``); the test here that needs the
card is marked ``cuda`` and skips without one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu.models import bamp as jbamp
from amp_sparc_spatialmodulation_tpu.ops.pallas.fused_bamp_tiled import (
    TiledBandedIteration)
from amp_sparc_spatialmodulation_tpu_torch import config as tconfig
from amp_sparc_spatialmodulation_tpu_torch import interop
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
from amp_sparc_spatialmodulation_tpu_torch.ops import precision as prec
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
    fused_bamp_tiled)
from amp_sparc_spatialmodulation_tpu_torch.utils import metrics
from amp_sparc_spatialmodulation_tpu_torch.utils.device import make_generator

from test_torch_bamp_high import _jmm, _maps
from test_torch_tiled import (TILES, assert_step_matches, force_tiled,
                              jax_initial, jax_planes, massive_op,
                              mid_state, shared)

HIGH = jax.lax.Precision.HIGH
# (Lin, Lh, F, alphabet): the TILES of tests/test_torch_tiled.py and BPSK
CASES = [(*t, "OOK") for t in TILES] + [(8, 3, 4, "BPSK")]
IDS = [f"{a}_{lin}_{lh}_F{f}" for lin, lh, f, a in CASES]


def jax_step(jop, jcfg, ps, cfg, y, s2, F, precision):
    """One ``plane_call`` of JAX's frame-tiled kernel in interpret mode."""
    tiled = TiledBandedIteration(jop, y.shape[0], interpret=True,
                                 symbols=jcfg.symbols, M=jcfg.M, F=F,
                                 tile=8, precision=precision)
    act = jnp.asarray(ps.active.numpy().astype(np.float32)[:, None])
    yp = lambda t: jnp.asarray(interop.plane_to_jax(t, cfg.Lout))
    return tiled.plane_call(jnp.float32(s2), *jax_planes(ps, cfg),
                            yp(y.real.contiguous()),
                            yp(y.imag.contiguous()), act=act)


def y_side_err(out, ref, cfg) -> float:
    """Largest |port - JAX| over the y-side planes z_re, z_im, u."""
    err = 0.0
    for name, want in (("z_re", ref[5]), ("z_im", ref[6]), ("u", ref[7])):
        d = getattr(out, name) - interop.plane_from_jax(want, "cpu")
        err = max(err, float(d.abs().max()))
    return err


def high_step(case):
    lin, lh, F, alphabet = case
    cfg, op, y, s2, jcfg, jop, jy = shared(Lin=lin, Lh=lh, alphabet=alphabet)
    ps = mid_state(cfg, op, y, s2)
    out = fused_bamp_tiled.iteration(op, ps, y.real.contiguous(),
                                     y.imag.contiguous(), s2, cfg, "high")
    return cfg, op, y, s2, jcfg, jop, ps, F, out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_step_high_matches_jax_tiled_kernel_high(case):
    cfg, op, y, s2, jcfg, jop, ps, F, out = high_step(case)
    ref = jax_step(jop, jcfg, ps, cfg, y, s2, F, HIGH)
    assert y_side_err(out, ref, cfg) <= 1e-6
    assert_step_matches(out, ref, ps, cfg, tol=1e-5)
    assert int(out.notok.numpy()[ps.active.numpy()].min()) > 0


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_step_highest_lies_outside_the_high_tolerance(case):
    """JAX's HIGHEST step parts from the port's HIGH step by more than the
    1e-6 y-side tolerance: the test separates the precisions."""
    cfg, op, y, s2, jcfg, jop, ps, F, out = high_step(case)
    ref = jax_step(jop, jcfg, ps, cfg, y, s2, F,
                   jax.lax.Precision.HIGHEST)
    assert y_side_err(out, ref, cfg) > 1e-6


def plane_loops_high(case):
    """T, xmmse and var of the port's plane-loop decode on K5's plain HIGH
    version and of the JAX plane loop on its K5 at HIGH, from the same
    realization."""
    lin, lh, F, alphabet = case
    cfg, op, y, s2, jcfg, jop, jy = shared(Lin=lin, Lh=lh, alphabet=alphabet)
    s0 = bamp.initial_state(y, cfg.N, float(np.float32(s2)))
    port = fused_bamp_tiled.decode_plain(op, s0, y, s2, cfg.N_Layers, cfg,
                                         "high")
    tiled = TiledBandedIteration(jop, y.shape[0], interpret=True,
                                 symbols=jcfg.symbols, M=jcfg.M, F=F, tile=8,
                                 precision=HIGH)
    ref = jbamp._fused_plane_loop(tiled, jax_initial(jy, s2, cfg.N), jy,
                                  jnp.float32(s2), cfg.N_Layers)
    return cfg, port, ref


def state_gap(port, ref, rows) -> float:
    """Largest |port - JAX| of xmmse and var over the trials ``rows``."""
    return max(float(np.abs(getattr(port, f).numpy()[rows]
                            - np.asarray(getattr(ref, f))[rows]).max())
               for f in ("xmmse", "var"))


@pytest.mark.parametrize("case", CASES[:-1], ids=IDS[:-1])
def test_plane_loop_high_matches_jax_tiled_kernel_high(case):
    """The port's plane-loop decode on K5's plain HIGH version against the
    JAX plane loop on its K5 at HIGH, under tests/test_pallas_tiled.py's
    rule (dT <= 1, >= 90% exact, values within 1e-4)."""
    cfg, port, ref = plane_loops_high(case)
    dT = np.abs(port.T.numpy() - np.asarray(ref.T))
    assert dT.max() <= 1 and (dT == 0).mean() >= 0.9, dT
    assert state_gap(port, ref, slice(None)) < 1e-4


def test_plane_loop_high_bpsk_within_the_parity_rule():
    """The BPSK case under the parity rule (|d mean T| within 2% of the
    cap), the state within 1e-4 on the trials whose T agrees.  Two correct
    HIGH decodes part on the T of a trial that converges slowly: here one
    trial stops at 13 in the port and 16 in JAX (both HIGHEST decodes: 16),
    as the three-pass products' error sits near the 1e-5 allclose test."""
    cfg, port, ref = plane_loops_high(CASES[-1])
    pT, jT = port.T.numpy(), np.asarray(ref.T)
    assert abs(float(pT.mean()) - float(jT.mean())) <= 0.02 * cfg.N_Layers
    assert (pT == jT).mean() >= 0.8
    assert state_gap(port, ref, pT == jT) < 1e-4


def test_high_taps_are_the_split_gauss_planes():
    """The wrapper's split taps: the seven Gauss planes of a real x in
    their products' order (the forward's Re S, Im S - Re S, S_a2; the
    adjoint's Re S^T, -Im S^T - Re S^T, Re S^T - Im S^T, S_a2^T), transposed so
    that the output columns lie along the rows, split into bf16 hi and lo
    in the split layout (``split_at``: tiles of 112 columns by 16
    contraction steps, an even number of steps, zero pads); cached per
    operator."""
    cfg, op, *_ = shared(Lin=12, Lh=5)
    buf = fused_bamp_tiled.high_taps(op)
    assert buf.dtype == torch.bfloat16 and buf is fused_bamp_tiled.high_taps(op)
    t = bamp.gauss_taps(op)
    W, Nt = cfg.Lh * cfg.Nr, cfg.Nt
    cols = fused_bamp_tiled.HIGH_COLS
    planes = [t.s_re, t.dmc, t.s_a2, t.st_re, t.amc, t.adm, t.st_a2]
    sizes = [-(-p.shape[1] // cols) * cols
             * fused_bamp_tiled.split_steps(p.shape[0]) * 32 for p in planes]
    assert sizes[:3] == [112 * 2 * 32] * 3 and sizes[3:] == [112 * 4 * 32] * 4
    assert buf.numel() == sum(sizes)
    at = 0
    for plane, size in zip(planes, sizes):
        m = plane.T.contiguous()            # (output columns, contraction)
        rows, K = m.shape
        got = buf[at:at + size].float()
        steps = fused_bamp_tiled.split_steps(K)
        seen = torch.zeros(size, dtype=torch.bool)
        for h, half in enumerate(prec.split_bf16(m)):
            idx = torch.tensor([[fused_bamp_tiled.split_at(steps, cols, R, k, h)
                                 for k in range(K)] for R in range(rows)])
            assert torch.equal(got[idx], half.float())
            seen[idx.flatten()] = True
        assert not got[~seen].any()         # the pads are zero
        at += size
    assert at == buf.numel()


def test_high_forms_and_shared_memory():
    """The HIGH form's product blocks (128 x 112 large, one per SM: a
    3-slot ring of two k16 steps of both split operands, 64 bytes a row,
    two parks of a float per output, an mbarrier per slot and one more
    for the adjoint's last epilogue; 32 x 16 small) and its form rule at
    the massive
    geometry: phase 1's 2048 trials take the large form, phase 2's handful
    the small one; the HIGHEST forms are unchanged."""
    m = tconfig.massive_mimo()
    W = m.Lh * m.Nr
    ring = 3 * 2 * 64 * (128 + 112)
    assert fused_bamp_tiled.smem_bytes(True, False, "high") == (
        ring + 2 * 4 * 128 * 112 + 24) == 206872
    assert fused_bamp_tiled.smem_bytes(False, False, "high") == (
        ring + 2 * 4 * 128 * 112 + 32) == 206880
    assert fused_bamp_tiled.smem_bytes(True, True, "high") == (
        3 * 2 * 64 * (32 + 16) + 2 * 4 * 32 * 16 + 24) == 22552
    assert fused_bamp_tiled.smem_bytes(False, True, "high") == 22560
    assert fused_bamp_tiled.smem_bytes(True, False) == 4 * 3 * (
        2 * 64 * 20 + 3 * 16 * 64)
    assert fused_bamp_tiled.smem_bytes(False, False, "high") <= 232448
    tf = fused_bamp_tiled.tile_forms
    assert tf(2048, m.Lin, W, m.Nt, "high") == 0
    assert tf(6, m.Lin, W, m.Nt, "high") == 3
    # 32 trials: 8 row tiles of 128 x 12 adjoint column tiles = 96 < 132
    assert tf(32, m.Lin, W, m.Nt, "high") == 3
    assert tf(64, m.Lin, W, m.Nt, "high") == 1
    assert tf(64, m.Lin, W, m.Nt) == 1
    # the DEFAULT form runs the HIGH form's launches on the HIGH form's
    # tiles (its forms), with a carve-out of its own: 3 ring slots of three
    # hi-only tiles of each operand in the forward, of two in the adjoint
    # (small: 4 of one), one park in the forward, two in the adjoint, a
    # full and an empty mbarrier per slot
    # (tests/test_torch_k5_default_tiles.py)
    for B in (2048, 64, 32, 6):
        assert tf(B, m.Lin, W, m.Nt, "default") == tf(B, m.Lin, W, m.Nt,
                                                       "high")
    sb = fused_bamp_tiled.smem_bytes
    assert sb(True, False, "default") == (
        3 * 3 * 64 * (128 + 112) + 4 * 128 * 112 + 16 * 3) == 195632
    assert sb(False, False, "default") == (
        3 * 2 * 64 * (128 + 112) + 2 * 4 * 128 * 112 + 16 * 3) == 206896
    assert sb(True, True, "default") == (
        4 * 64 * (32 + 16) + 4 * 32 * 16 + 16 * 4) == 14400
    assert sb(False, True, "default") == 14400 + 4 * 32 * 16
    with pytest.raises(ValueError):
        tf(64, m.Lin, W, m.Nt, "low")


def test_cpu_wrapper_high_is_the_plain_high_step():
    """On CPU tensors the wrapper at 'high' runs the plain HIGH step and
    launches nothing; it differs from the HIGHEST step; at 'default' it is
    the plain DEFAULT step (one bf16 pass) and launches nothing; unknown
    precisions raise."""
    cfg, op, y, s2, *_ = shared()
    ps = mid_state(cfg, op, y, s2)
    y_re, y_im = y.real.contiguous(), y.imag.contiguous()
    before = (fused_bamp_tiled.launches, fused_bamp_tiled.launches_high)
    got = fused_bamp_tiled.iteration(op, ps, y_re, y_im, s2, cfg, "high")
    want = bamp.step_planes(
        op, ps, y_re, y_im, s2, bamp.make_denoiser(cfg, "cpu"),
        lambda *a: bamp.linear_step_high(*a, taps=bamp.gauss_taps(op),
                                         real_x=True))
    assert (fused_bamp_tiled.launches,
            fused_bamp_tiled.launches_high) == before
    for f in bamp.IterOut._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    highest = fused_bamp_tiled.iteration(op, ps, y_re, y_im, s2, cfg)
    assert not torch.equal(got.z_re, highest.z_re)
    before = (fused_bamp_tiled.launches, fused_bamp_tiled.launches_high,
              fused_bamp_tiled.launches_default)
    one = fused_bamp_tiled.iteration(op, ps, y_re, y_im, s2, cfg, "default")
    want = bamp.step_planes(
        op, ps, y_re, y_im, s2, bamp.make_denoiser(cfg, "cpu"),
        lambda *a: bamp.linear_step_high(*a, taps=bamp.gauss_taps(op),
                                         real_x=True, dot=prec.dot1))
    assert (fused_bamp_tiled.launches, fused_bamp_tiled.launches_high,
            fused_bamp_tiled.launches_default) == before
    for f in bamp.IterOut._fields:
        assert torch.equal(getattr(one, f), getattr(want, f)), f
    assert not torch.equal(one.z_re, got.z_re)
    with pytest.raises(ValueError):
        fused_bamp_tiled.iteration(op, ps, y_re, y_im, s2, cfg, "low")


def test_decode_high_on_the_tiled_route(monkeypatch):
    """``bamp.decode(precision='high')`` on the tiled route drives the
    plane loop with K5's HIGH iteration, one call per iteration, and
    equals the plain HIGH plane loop; split at 5 and resumed it gives the
    same trajectory."""
    force_tiled(monkeypatch)
    cfg, op, y, s2, *_ = shared(B=37, seed=3)
    assert bamp.route(cfg, op, 37, "cuda") == "tiled"
    assert bamp.route(cfg, op, 37, "cuda", "high") == "tiled"
    calls = []
    real = fused_bamp_tiled.iteration
    monkeypatch.setattr(fused_bamp_tiled, "iteration",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    got = bamp.decode(op, y, s2, cfg, precision="high")
    assert len(calls) == int(got.T.max())
    assert all(k == {"precision": "high"} for k in calls)
    s0 = bamp.initial_state(y, cfg.N, float(np.float32(s2)))
    want = fused_bamp_tiled.decode_plain(op, s0, y, s2, cfg.N_Layers, cfg,
                                         "high")
    part = fused_bamp_tiled.decode_plain(op, s0, y, s2, 5, cfg, "high")
    resumed = fused_bamp_tiled.decode_plain(op, part, y, s2, cfg.N_Layers,
                                            cfg, "high")
    for st in (want, resumed):
        assert torch.equal(got.T, st.T)
        for f in ("xmap", "xmmse", "var"):
            assert torch.equal(getattr(got, f), getattr(st, f)), f
    highest = bamp.decode(op, y, s2, cfg)
    assert not torch.equal(got.xmap, highest.xmap)
    assert bamp.route(cfg, op, 37, "cuda", "high", use_pallas=False) == \
        "plain"


def _manual_sums(cfg, res, snr, seed, precision):
    """One realization's metric sums composed by hand at ``precision``."""
    gen = make_generator(torch.device("cpu"), seed, 0, 0)
    r = montecarlo.generate_realization(gen, cfg, "sparc", "banded", res,
                                        snr, precision)
    out = montecarlo.decode("bamp", r, r.y, cfg, precision=precision)
    return metrics.finalize(metrics.evaluate_sums(
        out.xmap, out.xmmse, r.msg, out.T, cfg), cfg)


def test_simulator_high_and_auto_on_the_tiled_route(monkeypatch, tmp_path):
    """On a forced-tiled geometry 'high' generates at HIGH and decodes
    through K5's HIGH form (the sums composed by hand); 'auto' takes
    HIGHEST on a first point and HIGH after a cap-pinned one."""
    force_tiled(monkeypatch)
    cfg = Config(Nt=16, Na=4, Nr=10, Lin=8, Lh=3, mode="segmented",
                 alphabet="OOK", profile="uniform", trunc="tail",
                 iterations=8)
    precisions = []
    real = fused_bamp_tiled.iteration
    monkeypatch.setattr(fused_bamp_tiled, "iteration",
                        lambda *a, **k: precisions.append(
                            k.get("precision", "highest")) or real(*a, **k))
    kw = dict(algo="bamp", device="cpu", progress=lambda s: None,
              out_root=str(tmp_path), seed=4)
    ebn0, res = 5.0, 32
    snr = 10 ** ((ebn0 + 10 * np.log10(cfg.code_rate)) / 10)
    high = montecarlo.Simulator(cfg, precision="high", **kw).run_point(
        ebn0, epochs=res, res=res)
    assert precisions and set(precisions) == {"high"}
    assert high == _manual_sums(cfg, res, snr, 4, "high")
    highest = montecarlo.Simulator(cfg, **kw).run_point(ebn0, epochs=res,
                                                        res=res)
    assert high != highest
    auto = montecarlo.Simulator(cfg, precision="auto", **kw)
    assert auto.run_point(ebn0, epochs=res, res=res) == highest
    auto._last_meanT = float(cfg.N_Layers)
    del precisions[:]
    assert auto.run_point(ebn0, epochs=res, res=res) == high
    assert set(precisions) == {"high"}


def test_massive_generation_at_high_matches_jax_dot3():
    """The generation's product at HIGH on the tail-truncated massive
    geometry (``BandedOperator.apply(x, 'high')``, and the other three
    maps) equals the same maps written with JAX's ``dot3`` within 1e-6
    relative to the maps of the absolute values; two trials, no decode."""
    cfg = tconfig.massive_mimo()
    op = massive_op(cfg)
    rng = np.random.default_rng(11)
    B = 2
    x = (rng.random((B, cfg.N)) < 1 / cfg.M).astype(np.complex64)
    z = (rng.standard_normal((B, cfg.n)) + 1j * rng.standard_normal(
        (B, cfg.n))).astype(np.complex64)
    tx, tz = torch.from_numpy(x), torch.from_numpy(z)
    v, u = torch.rand(B, cfg.N), tz.abs() ** 2
    got = (op.apply(tx, "high"), op.apply_adj(tz, "high"),
           op.apply_abs2(v, "high"), op.apply_abs2T(u, "high"))
    args = (x, z, v.numpy(), u.numpy())
    ref = _maps(op, *args, _jmm)
    scale = _maps(op, *(np.abs(a) for a in args),
                  lambda p, q: np.abs(p) @ np.abs(q))
    for g, r, s in zip(got, ref, scale):
        assert float(np.max(np.abs(g.numpy() - r) / np.abs(s))) < 1e-6


@pytest.mark.cuda
def test_high_kernel_matches_plain_on_card():
    """K5's HIGH form against its plain HIGH version on the card, one
    iteration at the small geometry (chip_smoke.py's control limit on the
    median |d xmap|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import chip_smoke
    cfg = dataclasses.replace(chip_smoke.tiled_small_config(), iterations=8)
    gen = make_generator(torch.device("cuda"), 3)
    r = montecarlo.generate_realization(gen, cfg, "sparc", "banded", 256,
                                        10 ** 0.8, "high")
    ps = bamp.to_planes(bamp.initial_state(r.y, cfg.N, r.sigma2))
    y_re, y_im = r.y.real.contiguous(), r.y.imag.contiguous()
    before = fused_bamp_tiled.launches_high
    k = fused_bamp_tiled.iteration(r.A, ps, y_re, y_im, r.sigma2, cfg,
                                   "high")
    p = fused_bamp_tiled.iteration_plain(r.A, ps, y_re, y_im, r.sigma2, cfg,
                                         "high")
    assert fused_bamp_tiled.launches_high == before + 1
    d = (k.xmap_re - p.xmap_re).abs().flatten()
    assert float(d.median()) < chip_smoke.HIGH_CONTROL_TOL
