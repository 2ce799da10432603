"""The port's matrix-product precision (``ops/precision.py``), the HIGH form
of the VAMP and vamp2 decodes and the sweep engine's ``precision`` and
``chans_per_batch``, against the JAX package on the CPU.

* ``split_bf16`` is bit-identical to JAX's ``_split_bf16``; ``dot3`` and
  ``rowsum3`` agree with JAX's ``dot3`` (``fused_bamp.py:60-78``) within
  1e-6 relative.
* The plain HIGH versions of kernels K3 and K4
  (``decode_plain(precision='high')``) against the JAX kernels at
  ``Precision.HIGH``, run in interpret mode as
  ``tests/test_pallas_vamp.py:55-66`` runs them, on shared factors and a
  shared ``y_tilde`` on the geometries of ``tests/test_torch_vamp.py`` and
  ``tests/test_torch_vamp2.py``, with the tolerances those files state:
  per-trial T identical, ``xmmse`` and ``var`` within 1e-3, ``r`` within
  5e-2 (it divides by ``1 - alpha``, which amplifies float32
  summation-order noise up to 1e5).
* ``Simulator(precision='auto')`` picks the precision of JAX's policy
  (``tests/test_two_phase.py:158-176``) number for number; 'high' and
  'auto' run on every route, as in JAX (BAMP on a dense operator, SCAMP
  where K2 does not fit, VAMP's random mode: the plain loops at HIGH, held
  to JAX's XLA decodes in ``tests/test_torch_plain_high.py``); every entry
  point takes 'default' too (held to the patched JAX package in
  ``tests/test_torch_default.py``) and raises on an unknown precision.
* ``chans_per_batch=2`` gives the sums of 1 and rounds
  ``trials_per_point`` as JAX does.

The kernels themselves are held against these plain versions on the card
by ``chip_smoke.py`` (``kernel_*_high``); the one test here that needs the
card is marked ``cuda`` and skips without one.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu.config import Config as JConfig
from amp_sparc_spatialmodulation_tpu.models import montecarlo as jmc
from amp_sparc_spatialmodulation_tpu.models import vamp as jvamp
from amp_sparc_spatialmodulation_tpu.models import vamp2 as jvamp2
from amp_sparc_spatialmodulation_tpu.ops.pallas import fused_bamp as jfb
from amp_sparc_spatialmodulation_tpu_torch import cli
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.models import montecarlo as mc
from amp_sparc_spatialmodulation_tpu_torch.models import bamp, vamp, vamp2
from amp_sparc_spatialmodulation_tpu_torch.ops import precision as prec
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (fused_vamp,
                                                               fused_vamp2)
from test_torch_vamp import SMALL, assert_same_decode, shared_inputs

HIGH = jax.lax.Precision.HIGH

# (algo, name, config overrides, SNR exponent): the kernel geometries of
# tests/test_torch_vamp.py and tests/test_torch_vamp2.py, and a converging
# QPSK point at cap 30 where trials stop after 10-20 iterations
DECODES = [
    ("vamp", "ook", dict(), 1.5),
    ("vamp", "qpsk", dict(alphabet="QPSK"), 1.9),
    ("vamp", "8psk", dict(alphabet="8PSK"), 2.0),
    ("vamp", "qpsk_cap30", dict(alphabet="QPSK", iterations=30), 1.2),
    ("vamp2", "ook", dict(iterations=12), 1.5),
    ("vamp2", "qpsk", dict(alphabet="QPSK", iterations=12), 1.9),
    ("vamp2", "8psk", dict(alphabet="8PSK", iterations=12), 2.0),
    ("vamp2", "qpsk_cap30", dict(alphabet="QPSK", iterations=30), 1.2),
]


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


def _values(seed=0):
    """float32 values with bf16 ties, tiny, huge and signed-zero cases.
    No subnormals: XLA on the CPU flushes them (ROADMAP.md Queue 3), the
    port and the card keep them."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((37, 53)) * 10.0 ** rng.integers(
        -30, 30, (37, 53))).astype(np.float32)
    x[0, :8] = np.array([0.0, -0.0, 1.0, 1.00390625, 1.01171875, 2.0 ** -126,
                         -3.4e38, 1.0 + 2 ** -9], np.float32)
    return x


def test_split_bf16_bit_identical():
    x = _values()
    hi, lo = prec.split_bf16(torch.from_numpy(x))
    jhi, jlo = jfb._split_bf16(jnp.asarray(x))
    assert hi.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(hi.view(torch.int16).numpy().view(
        np.uint16), _bits(jhi))
    np.testing.assert_array_equal(lo.view(torch.int16).numpy().view(
        np.uint16), _bits(jlo))


@pytest.mark.parametrize("shape", [(8, 100, 128), (33, 2560, 17)])
def test_dot3_and_rowsum3_match_jax(shape):
    """dot3 within 1e-6 of JAX's relative to the product's scale; rowsum3
    equals JAX's dot3 with a ones column the same way, and the hi.lo term
    it leaves out is exactly zero."""
    m, k, n = shape
    rng = np.random.default_rng(k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    a = rng.standard_normal((k, n)).astype(np.float32)
    got = prec.dot3(torch.from_numpy(x), torch.from_numpy(a)).numpy()
    ref = np.asarray(jfb.dot3(jnp.asarray(x), jnp.asarray(a)))
    scale = np.abs(x) @ np.abs(a)
    assert float(np.max(np.abs(got - ref) / scale)) < 1e-6
    # and dot3 is HIGH, not HIGHEST: it differs from the float32 product
    assert float(np.max(np.abs(got - x @ a) / scale)) > 1e-7
    rs = prec.rowsum3(torch.from_numpy(x)).numpy()
    jrs = np.asarray(jfb.dot3(jnp.asarray(x), jnp.ones((k, 1), jnp.float32)))
    np.testing.assert_allclose(rs, jrs, rtol=1e-6,
                               atol=1e-6 * float(np.abs(x).sum(1).max()))
    _, x_lo = prec.split_bf16(torch.from_numpy(x))
    ones_hi, ones_lo = prec.split_bf16(torch.ones(k, 1))
    assert torch.equal(ones_hi.float(), torch.ones(k, 1))
    assert not bool(ones_lo.float().any())


def test_complex_matmul_high_is_four_dot3():
    """At 'high' a complex product is four real dot3 products (JAX's dot3 on
    the same planes, within 1e-6 of the scale); at 'highest' it is exactly
    ``x @ a``; a conjugated view is read as what it means."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((16, 40)) + 1j * rng.standard_normal((16, 40))
         ).astype(np.complex64)
    U = (rng.standard_normal((40, 12)) + 1j * rng.standard_normal((40, 12))
         ).astype(np.complex64)
    tx, tU = torch.from_numpy(x), torch.from_numpy(U)
    got = prec.matmul(tx, tU.conj(), "high").numpy()
    a = np.conj(U)
    d = lambda p, q: np.asarray(jfb.dot3(jnp.asarray(p), jnp.asarray(q)))
    ref = (d(x.real, a.real) - d(x.imag, a.imag)) + 1j * (
        d(x.real, a.imag) + d(x.imag, a.real))
    scale = np.abs(x) @ np.abs(a)
    assert float(np.max(np.abs(got - ref) / scale)) < 1e-6
    assert torch.equal(prec.matmul(tx, tU.conj(), "highest"),
                       tx @ tU.conj())
    # at 'default' four real one-pass products, formed the same way
    xr, xi, ar, ai = tx.real, tx.imag, tU.real, tU.imag
    want = torch.complex(prec.dot1(xr, ar) - prec.dot1(xi, ai),
                         prec.dot1(xr, ai) + prec.dot1(xi, ar))
    assert torch.equal(prec.matmul(tx, tU, "default"), want)
    with pytest.raises(ValueError):
        prec.matmul(tx, tU, "low")


def _jax_y_tilde(algo, jdec, jy):
    """y_tilde as the JAX decode forms it at HIGH on the CPU
    (``vamp.py:165``, ``vamp2.py:123``), shared with the port."""
    U, s, _ = jdec
    q = jnp.matmul(jy, jnp.conj(U), precision=HIGH)
    return np.array(s[None, :] * q if algo == "vamp"
                    else q / s[None, :].astype(jy.dtype))


@pytest.mark.parametrize("algo,name,kw,snr_exp", DECODES,
                         ids=[f"{d[0]}-{d[1]}" for d in DECODES])
def test_plain_high_matches_jax_kernel(algo, name, kw, snr_exp):
    """The port's plain HIGH decode against the JAX kernel at
    Precision.HIGH in interpret mode, on shared factors and y_tilde."""
    cfg, dec, y, s2, jcfg, jdec, jy = shared_inputs(kw, snr_exp)
    jmod, mod, kern = ((jvamp, vamp, fused_vamp) if algo == "vamp"
                       else (jvamp2, vamp2, fused_vamp2))
    ref = jmod.decode(jdec, jy, s2, jcfg, use_pallas=True, precision=HIGH)
    yt = torch.from_numpy(_jax_y_tilde(algo, jdec, jy))
    before = mod.plain_decodes
    st = kern.decode_plain(dec.Vh, dec.s ** 2, yt, mod.initial_state(y, cfg),
                           s2, cfg.N_Layers, cfg, precision="high")
    assert mod.plain_decodes == before + 1
    assert_same_decode(vamp.DecodeResult(st.r, st.xmmse, st.var, st.T), ref)
    # the HIGH form is the one that ran: it differs from HIGHEST somewhere
    hst = kern.decode_plain(dec.Vh, dec.s ** 2, yt, mod.initial_state(y, cfg),
                            s2, cfg.N_Layers, cfg)
    assert not torch.equal(hst.r, st.r)


def test_plain_high_steps_are_the_kernels():
    """One iteration of the plain HIGH VAMP loop equals the JAX kernel's
    body written out with JAX's dot3 on the Gauss tap planes (the port's
    gauss_taps equal the JAX wrapper's, fused_vamp.py:310-321)."""
    from amp_sparc_spatialmodulation_tpu.ops.pallas.fused_vamp import (
        FusedVampDecode)
    cfg, dec, y, s2, jcfg, jdec, jy = shared_inputs(dict(alphabet="QPSK"),
                                                    1.9)
    fused = FusedVampDecode(jdec.Vh, 8, interpret=True, symbols=jcfg.symbols,
                            M=jcfg.M, precision=HIGH)
    for port_t, jax_t in zip(vamp.gauss_taps(dec.Vh), fused.taps):
        np.testing.assert_array_equal(port_t.numpy(), np.asarray(jax_t))
    # and each kernel tap plane is the split of its Gauss plane, padded
    # (the engine's tiles of TILE_COLS output columns and 16 k, 16-byte
    # chunks in chunk_order, read back into (part, row, k) planes here)
    taps, ldf, ldb = fused_vamp.high_taps(dec.Vh)
    p, N = dec.Vh.shape
    assert (ldf, ldb) == (fused_vamp.padded_k(N), fused_vamp.padded_k(p))
    assert taps.dtype == torch.bfloat16
    cols = fused_vamp.TILE_COLS
    rows_f, rows_b = -(-p // cols) * cols, -(-N // cols) * cols
    assert taps.shape == (6 * rows_f * ldf + 6 * rows_b * ldb,)
    tiles = taps[:6 * rows_f * ldf].reshape(3, rows_f // cols, ldf // 16,
                                            cols, 4, 8)
    where = fused_vamp.chunk_order(cols)
    tiles = tiles.gather(-2, where[..., None].expand(tiles.shape))
    planes = tiles.reshape(3, rows_f // cols, ldf // 16, cols, 2, 16
                           ).permute(0, 4, 1, 3, 2, 5).reshape(3, 2, rows_f,
                                                               ldf)
    hi, lo = prec.split_bf16(vamp.gauss_taps(dec.Vh)[1].T.contiguous())
    assert torch.equal(planes[1, 0, :p, :N], hi) and torch.equal(
        planes[1, 1, :p, :N], lo)
    assert not bool(planes[:, :, :, N:].float().any())
    assert not bool(planes[:, :, p:].float().any())
    assert torch.equal(fused_vamp.high_taps(dec.Vh)[0], taps)
    stack = torch.stack([dec.Vh, dec.Vh])
    assert torch.equal(fused_vamp.high_taps(stack)[0][1], taps)


def test_wrapper_high_on_cpu_is_plain_high():
    """On CPU tensors the wrapper at 'high' is the plain HIGH loop and
    launches nothing; at 'default' it is the plain DEFAULT loop and
    launches nothing; unknown precisions raise."""
    cfg, dec, y, s2, *_ = shared_inputs(dict(alphabet="QPSK"), 1.9)
    yt, sq = vamp.project(dec, y, "high"), dec.s ** 2
    s0 = vamp.initial_state(y, cfg)
    before = (fused_vamp.launches, fused_vamp.launches_high)
    done = fused_vamp.whole_decode(dec.Vh, sq, yt, s0, s2, 10, cfg, "high")
    want = vamp.plain_loop_high(dec.Vh, sq, yt, s0, s2, 10, cfg)
    assert (fused_vamp.launches, fused_vamp.launches_high) == before
    for f in ("r", "xmmse", "var", "T", "sigma2_tilde"):
        assert torch.equal(getattr(done, f), getattr(want, f)), f
    before = (fused_vamp.launches, fused_vamp.launches_high,
              fused_vamp.launches_default)
    one = fused_vamp.whole_decode(dec.Vh, sq, yt, s0, s2, 10, cfg, "default")
    ref = vamp.plain_loop_default(dec.Vh, sq, yt, s0, s2, 10, cfg)
    assert (fused_vamp.launches, fused_vamp.launches_high,
            fused_vamp.launches_default) == before
    for f in ("r", "xmmse", "var", "T", "sigma2_tilde"):
        assert torch.equal(getattr(one, f), getattr(ref, f)), f
    assert not torch.equal(one.r, done.r)
    with pytest.raises(ValueError):
        fused_vamp.whole_decode(dec.Vh, sq, yt, s0, s2, 10, cfg, "low")
    with pytest.raises(ValueError):
        vamp2.decode(dec, y, s2, cfg, precision="low")


@pytest.mark.parametrize("algo", ["vamp", "vamp2"])
def test_decode_high_split_and_resume(algo):
    """The HIGH decode is resumable: split at 3 and resumed, the unsplit
    trajectory; K3's batched form at HIGH equals separate decodes."""
    mod = vamp if algo == "vamp" else vamp2
    cfg, dec, y, s2, *_ = shared_inputs(dict(alphabet="QPSK",
                                             iterations=12), 1.2)
    _, full = mod.decode(dec, y, s2, cfg, precision="high",
                         return_state=True)
    _, part = mod.decode(dec, y, s2, cfg, precision="high", iter_cap=3,
                         return_state=True)
    _, res = mod.decode(dec, y, s2, cfg, precision="high", state0=part,
                        return_state=True)
    assert torch.equal(full.T, res.T) and torch.equal(full.var, res.var)
    if algo == "vamp":
        As = torch.stack([torch.as_tensor((dec.U * dec.s) @ dec.Vh)] * 2)
        out = vamp.decode_batched(As, torch.stack([y, y]), s2, cfg, "high")
        one = vamp.decode(vamp.svd(As[0]), y, s2, cfg, precision="high")
        for c in range(2):
            assert torch.equal(out.T[c], one.T)
            assert torch.equal(out.xmmse[c], one.xmmse)


def test_random_mode_raises_at_high():
    """The random mode, which no kernel covers, decodes at HIGH through the
    plain loop at HIGH (a decode of its own, not HIGHEST's); only
    ``use_pallas=True`` raises there, JAX's honest knob."""
    cfg, dec, y, s2, *_ = shared_inputs(dict(alphabet="QPSK",
                                             mode="random"), 1.9)
    for mod in (vamp, vamp2):
        before = mod.plain_decodes
        high = mod.decode(dec, y, s2, cfg, precision="high")
        assert mod.plain_decodes == before + 1
        highest = mod.decode(dec, y, s2, cfg, precision="highest")
        assert not torch.equal(high.xmap, highest.xmap)
        assert int(high.T.max()) <= cfg.N_Layers
        with pytest.raises(ValueError, match="kernels cover"):
            mod.decode(dec, y, s2, cfg, precision="high", use_pallas=True)


POLICY_CFG = dict(Nt=16, Na=4, Nr=10, Lin=6, Lh=3, mode="segmented",
                  alphabet="OOK", profile="uniform", trunc="tail",
                  iterations=40)


def _jax_name(p) -> str:
    if isinstance(p, str):
        p = jax.lax.Precision(p)
    return {jax.lax.Precision.HIGH: "high",
            jax.lax.Precision.HIGHEST: "highest"}[p]


@pytest.mark.parametrize("algo", ["vamp", "vamp2"])
def test_precision_auto_policy_matches_jax(tmp_path, algo):
    """The cases of tests/test_two_phase.py:158-176, number for number:
    HIGH exactly when the previous point's mean T pinned at the cap."""
    cfg, jcfg = Config(**POLICY_CFG), JConfig(**POLICY_CFG)
    kw = dict(algo=algo, out_root=str(tmp_path), progress=lambda s: None)
    s = mc.Simulator(cfg, precision="auto", device="cpu", **kw)
    js = jmc.Simulator(jcfg, precision="auto", **kw)
    for last in (None, 11.2, float(cfg.N_Layers), cfg.N_Layers - 0.5,
                 cfg.N_Layers + 0.0, 0.0):
        s._last_meanT = js._last_meanT = last
        assert s._effective_precision() == _jax_name(
            js._effective_precision()), last
    for fixed in ("highest", "high"):
        s2 = mc.Simulator(cfg, precision=fixed, device="cpu", **kw)
        js2 = jmc.Simulator(jcfg, precision=fixed, **kw)
        s2._last_meanT = js2._last_meanT = float(cfg.N_Layers)
        assert s2._effective_precision() == fixed == _jax_name(
            js2._effective_precision())


def test_precision_auto_runs_high_point(tmp_path):
    """A cap-running 'auto' simulator runs its next point at HIGH: the sums
    of a precision='high' run, not of 'highest'; the point's mean T is then
    recorded for the next one."""
    cfg = Config(**dict(SMALL, iterations=8))
    kw = dict(algo="vamp", device="cpu", progress=lambda s: None,
              out_root=str(tmp_path))
    auto = mc.Simulator(cfg, precision="auto", **kw)
    auto._last_meanT = float(cfg.N_Layers)
    a = auto.run_point(2.0, epochs=64, res=32)
    h = mc.Simulator(cfg, precision="high", **kw).run_point(2.0, epochs=64,
                                                            res=32)
    assert a == h and auto._last_meanT == a["T"]
    assert np.isfinite(a["fer"]) and 0 < a["T"] <= cfg.N_Layers


# (algo, config, operator form, decoded here): BAMP on the dense operator
# (the plain loop), SCAMP on a geometry K2 does not fit (the plain loop;
# built only, at this width nothing is decoded on the CPU)
NO_HIGH = [
    ("bamp", dict(POLICY_CFG, mode="sparc", iterations=10), "dense", True),
    ("scamp", dict(Nt=1344, Na=84, Nr=73, Lin=32, Lh=6, mode="sparc",
                   alphabet="OOK", trunc="tail"), "auto", False),
]
MASSIVE = dict(Nt=1344, Na=84, Nr=73, Lin=32, Lh=6, mode="segmented",
               alphabet="OOK", trunc="tail")


@pytest.mark.parametrize("precision", ["high", "auto"])
def test_bamp_massive_takes_high(tmp_path, precision):
    """BAMP on the massive geometry (the frame-tiled route, K5, whose HIGH
    form runs there) accepts 'high' and 'auto': the sweep engine builds
    without raising (built only; nothing is decoded at this width here)."""
    cfg = Config(**MASSIVE)
    assert bamp.route_of(cfg, True) == "tiled"
    assert bamp.route_of(cfg, True, precision="high") == "tiled"
    sim = mc.Simulator(cfg, algo="bamp", precision=precision, device="cpu",
                       out_root=str(tmp_path))
    assert sim._effective_precision() == ("high" if precision == "high"
                                          else "highest")
    sim._last_meanT = float(cfg.N_Layers)
    assert sim._effective_precision() == "high"
    assert callable(mc.make_realization_fn(cfg, "bamp", "sparc", 8,
                                           precision=precision))


@pytest.mark.parametrize("precision", ["high", "auto"])
@pytest.mark.parametrize("algo,kw,form,decoded", NO_HIGH,
                         ids=["bamp-dense", "scamp-nofit"])
def test_bamp_scamp_raise_without_high_kernels(tmp_path, algo, kw, form,
                                               decoded, precision):
    """Where no kernel has a HIGH form (the plain loops), 'high' and 'auto'
    build as in JAX; the dense BAMP point at 'high' (and 'auto' after a
    cap-pinned point) runs the plain loop at HIGH, whose sums are not
    HIGHEST's."""
    cfg = Config(**kw)
    assert mc.resolve_use_pallas("auto", cfg, algo,
                                 "dense" if form == "dense" else "banded",
                                 8) is False
    kw = dict(algo=algo, device="cpu", operator_form=form,
              out_root=str(tmp_path), progress=lambda s: None)
    sim = mc.Simulator(cfg, precision=precision, **kw)
    assert callable(mc.make_realization_fn(cfg, algo, "sparc", 8,
                                           operator_form=form,
                                           precision=precision))
    if not decoded:
        return
    sim._last_meanT = float(cfg.N_Layers)
    before = bamp.plain_decodes
    got = sim.run_point(6.0, epochs=16, res=16)
    assert bamp.plain_decodes == before + 1
    highest = mc.Simulator(cfg, **kw).run_point(6.0, epochs=16, res=16)
    assert got != highest and np.isfinite(got["fer"])


@pytest.mark.parametrize("algo", ["bamp", "scamp", "vamp", "vamp2"])
def test_default_precision_raises(tmp_path, algo):
    """Every decoder's sweep takes 'default' and runs a point with it, as
    JAX's does (its function is held to the patched JAX package in
    tests/test_torch_default.py); an unknown precision raises."""
    cfg = Config(**dict(POLICY_CFG, mode="sparc"))
    kw = dict(algo=algo, device="cpu", out_root=str(tmp_path),
              progress=lambda s: None)
    sim = mc.Simulator(cfg, precision="default", **kw)
    assert sim._effective_precision() == "default"
    got = sim.run_point(6.0, epochs=16, res=16)
    assert 0 < got["T"] <= cfg.N_Layers and np.isfinite(got["fer"])
    with pytest.raises(ValueError, match="unknown precision"):
        mc.Simulator(cfg, precision="low", **kw)


def test_random_mode_simulator_raises(tmp_path):
    """VAMP's random mode builds at 'high' and 'auto' and runs a point at
    'high' (the plain loop at HIGH); ``use_pallas=True`` raises there."""
    cfg = Config(**dict(POLICY_CFG, mode="random", alphabet="QPSK",
                        iterations=10))
    kw = dict(algo="vamp", device="cpu", out_root=str(tmp_path),
              progress=lambda s: None)
    for precision in ("high", "auto"):
        mc.Simulator(cfg, precision=precision, **kw)
    got = mc.Simulator(cfg, precision="high", **kw).run_point(
        8.0, epochs=16, res=16)
    assert 0 < got["T"] <= cfg.N_Layers and np.isfinite(got["fer"])
    with pytest.raises(ValueError, match="use_pallas=True"):
        mc.Simulator(cfg, precision="high", use_pallas=True, **kw)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_chans_per_batch_sums_equal_one(tmp_path, precision):
    """C = 2 only rounds the realization count: with a count that is a
    multiple of 2 it decodes the same realizations (seed, point, c), one
    after another, and gives the sums of C = 1."""
    cfg = Config(**SMALL)
    kw = dict(algo="vamp", device="cpu", precision=precision,
              progress=lambda s: None, out_root=str(tmp_path))
    one = mc.Simulator(cfg, **kw).run_point(9.0, epochs=128, res=32)
    sim = mc.Simulator(cfg, chans_per_batch=2, **kw)
    calls = []
    real = vamp.decode
    try:
        vamp.decode = lambda *a, **k: calls.append(1) or real(*a, **k)
        two = sim.run_point(9.0, epochs=128, res=32)
    finally:
        vamp.decode = real
    assert len(calls) == 4
    assert two == one


@pytest.mark.parametrize("epochs,res,C,two_phase",
                         [(100, 32, 2, None), (128, 32, 2, None),
                          (96, 32, 4, None), (100, 32, 3, 4),
                          (10, 32, 5, None), (64, 64, 1, None)])
def test_trials_per_point_rounds_as_jax(tmp_path, epochs, res, C, two_phase):
    cfg, jcfg = Config(**SMALL), JConfig(**SMALL)
    kw = dict(algo="vamp", out_root=str(tmp_path), chans_per_batch=C,
              two_phase=two_phase)
    port = mc.Simulator(cfg, device="cpu", **kw).trials_per_point(epochs,
                                                                 res)
    assert port == jmc.Simulator(jcfg, **kw).trials_per_point(epochs, res)


def test_cli_sweep_high_chans_on_cpu(tmp_path):
    rc = cli.main(["sweep", "--algo", "vamp", "--Nt", "16", "--Na", "4",
                   "--Nr", "10", "--Lin", "8", "--Lh", "3", "--iterations",
                   "10", "--epochs", "48", "--res", "16", "--start", "8",
                   "--final", "8", "--precision", "high", "--chans", "2",
                   "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 0
    root = os.path.join(str(tmp_path), "VAMP", Config(**SMALL).name)
    with open(os.path.join(root, "8.0.json")) as f:
        point = json.load(f)
    assert point["EbN0dB"] == 8.0 and 1.0 <= point["T"] <= 10.0
    manifest = json.dumps(json.load(open(os.path.join(
        root, next(f for f in os.listdir(root) if "manifest" in f)))))
    assert "64" in manifest            # 48 trials round up to 2 x 2 x 16
    with pytest.raises(SystemExit):
        cli.main(["sweep", "--Nt", "16", "--Na", "4", "--Nr", "10", "--Lin",
                  "8", "--Lh", "3", "--precision", "low"])


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["vamp", "vamp2"])
def test_high_kernel_matches_plain_on_card(algo):
    """K3 or K4 at HIGH against its plain HIGH version on the card, at the
    small QPSK geometry (chip_smoke.py's every_trial rule, 256 trials)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import chip_smoke
    mod, kern = (vamp, fused_vamp) if algo == "vamp" else (vamp2, fused_vamp2)
    data = vamp.project if algo == "vamp" else vamp2.whiten
    cfg = Config(**dict(SMALL, alphabet="QPSK", iterations=12))
    gen = mc.make_generator(torch.device("cuda"), 3)
    r = mc.with_svd(algo, mc.generate_realization(gen, cfg, "sparc", "dense",
                                                  256, 10 ** 1.9, "high"))
    yt, sq = data(r.dec, r.y, "high"), r.dec.s ** 2
    s0 = mod.initial_state(r.y, cfg)
    before = kern.launches_high
    sk = kern.whole_decode(r.dec.Vh, sq, yt, s0, r.sigma2, 12, cfg, "high")
    sp = kern.decode_plain(r.dec.Vh, sq, yt, s0, r.sigma2, 12, cfg, "high")
    assert kern.launches_high == before + 1
    failed = []
    chip_smoke.compare_vamp(f"test_{algo}_high", sk, sp, 1e-3, failed,
                            "every_trial", chip_smoke.VAMP_R_TOL)
    assert not failed
