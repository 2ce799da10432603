"""The plain decode loops at ``precision='high'`` against the JAX package's
XLA decodes at ``Precision.HIGH`` on the CPU, on shared inputs.

The witness: XLA on the CPU computes a product at HIGH in float32, so the
unpatched JAX decode is no witness of the TPU's function.  For these tests
only, ``jnp.matmul`` at HIGH in JAX's ``ops/operators.py`` and
``models/{scamp,vamp,vamp2}.py`` goes through JAX's own
``ops/pallas/fused_bamp.dot3``, four real products per complex one
(``ops/precision.py::matmul``'s form,
``tests/test_torch_precision.py::test_complex_matmul_high_is_four_dot3``),
by replacing each module's global ``jnp`` with a proxy; no JAX file is
edited.

Rules: per-trial T identical and the state within 1e-4 on the trials that
converged, within 1e-3 on those that ran to the cap without converging
(AMP that does not decode has no fixed point and amplifies the FP32
summation order of XLA's and PyTorch's products, as
``tests/test_torch_bamp_high.py`` states).  The SCAMP geometries run
through ``base_product``'s three passes on the base matrix, the port's
product-plus-sum form of JAX's ``mm(psi, Wt)``.

Also the route chain at HIGH: where the chain skips K1
(``AMP_PALLAS_MODE=periter``), BAMP falls through to K6 at HIGHEST (OOK),
to K5 at HIGH (a real alphabet with K > 1) or to the plain loop at HIGH
(QPSK), as JAX's chain does where its K1 declines (``bamp.py:241-283``);
at Lin > 32 K1 now takes the trial (where JAX's K1 does), and where the
port's block holds none, K1's cluster form does; only where no cluster
holds one, K1's plain version (``'whole_plain'``).
Those decodes are held to the port's own routes here, and to JAX's K1 by
``tests/test_torch_k1_wide.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu.config import Config as JConfig
from amp_sparc_spatialmodulation_tpu.models import bamp as jbamp
from amp_sparc_spatialmodulation_tpu.models import scamp as jscamp
from amp_sparc_spatialmodulation_tpu.models import vamp as jvamp
from amp_sparc_spatialmodulation_tpu.models import vamp2 as jvamp2
from amp_sparc_spatialmodulation_tpu.ops import channel as jchannel
from amp_sparc_spatialmodulation_tpu.ops import message as jmessage
from amp_sparc_spatialmodulation_tpu.ops import operators as joperators
from amp_sparc_spatialmodulation_tpu.ops.pallas import fused_bamp as jfb
from amp_sparc_spatialmodulation_tpu_torch import interop
from amp_sparc_spatialmodulation_tpu_torch.config import (Config,
                                                          flagship_bamp_qpsk)
from amp_sparc_spatialmodulation_tpu_torch.models import (bamp, scamp, vamp,
                                                          vamp2)
from amp_sparc_spatialmodulation_tpu_torch.ops import operators
from amp_sparc_spatialmodulation_tpu_torch.ops import precision as prec
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
    fused_bamp, fused_bamp_tiled, fused_scamp)
import test_torch_vamp

HIGH = jax.lax.Precision.HIGH
BASE = dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, mode="segmented",
            profile="uniform", trunc="tail")
# The SCAMP 8PSK sweep geometry (reference_scamp_8psk_golden.json,
# tests/test_golden_artifacts.py:32-33), at a cap cut to 8 for the CPU.
SCAMP_8PSK = dict(Nt=480, Na=30, Nr=57, Lin=32, Lh=6, mode="sparc",
                  alphabet="8PSK", profile="uniform", trunc="tail",
                  iterations=8)


@pytest.fixture(autouse=True)
def one_thread():
    """PyTorch on one thread in these tests: the test workers share the
    CPU, where PyTorch's intra-op threads contend on a decode of thousands
    of trials (the probe's 2048 took minutes beside five busy workers,
    eight seconds on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class HighJnp:
    """``jax.numpy`` whose ``matmul`` at HIGH is JAX's ``dot3``: one for
    real operands, four for a complex product."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def matmul(a, b, precision=None, **kw):
        if precision not in (HIGH, "high"):
            return jnp.matmul(a, b, precision=precision, **kw)
        if not (jnp.iscomplexobj(a) or jnp.iscomplexobj(b)):
            return jfb.dot3(a, b)
        d = jfb.dot3
        ar, ai, br, bi = jnp.real(a), jnp.imag(a), jnp.real(b), jnp.imag(b)
        return jax.lax.complex(d(ar, br) - d(ai, bi), d(ar, bi) + d(ai, br))


@pytest.fixture
def witness(monkeypatch):
    for mod in (joperators, jscamp, jvamp, jvamp2):
        monkeypatch.setattr(mod, "jnp", HighJnp())


def banded_inputs(kw, seed, snr_exp, batch=8, base=BASE):
    """A banded realization drawn by the JAX package, carried over through
    NumPy: (port config, port operator, W, y, sigma2, JAX config, JAX
    operator at HIGH, JAX y)."""
    b = dict(base, **kw)
    jcfg, cfg = JConfig(**b), Config(**b)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    W, jop = joperators.banded_sparc(k1, jcfg)
    msg = jmessage.generate_message(k2, jcfg, batch)
    snr = 10 ** snr_exp
    jy = jop.apply(msg.x) + jchannel.awgn(k3, jcfg, snr, batch)
    op = interop.operator_from_numpy(np.asarray(jop.h), np.asarray(jop.gains),
                                     cfg.Lin, cfg.Lout, cfg.trunc,
                                     device="cpu")
    jop_high = joperators.BandedOperator(jop.h, jop.gains, jcfg.Lin,
                                         jcfg.Lout, jcfg.trunc,
                                         precision=HIGH)
    return (cfg, op, np.asarray(W), torch.as_tensor(np.array(jy)),
            jcfg.sigma2(snr), jcfg, jop_high, jy)


def assert_same_high(port, ref, active, tol=1e-4, tol_unconverged=1e-3):
    """T identical; the state within ``tol`` on the trials that converged,
    within ``tol_unconverged`` on those still active at the cap."""
    np.testing.assert_array_equal(port.T.numpy(), np.asarray(ref.T))
    act = active.numpy()
    for f in ("xmap", "xmmse", "var"):
        d = np.abs(getattr(port, f).numpy() - np.asarray(getattr(ref, f)))
        d = d.reshape(d.shape[0], -1).max(axis=1)
        assert float(d[~act].max(initial=0.0)) < tol, f
        assert float(d[act].max(initial=0.0)) < tol_unconverged, f


# (name, config overrides, seed, SNR exponent, operator form, the state
# bound on unconverged trials): BAMP on a dense operator, in the
# real-channel mode and at Lin = 33 (QPSK: K1 takes it at HIGH, as JAX's
# K1 does; the plain loop is asked for by use_pallas=False), each the
# plain loop at HIGH.  In the real mode no trial converges within
# the cap of 10, and the gap between two decodes grows about threefold an
# iteration: at HIGHEST from 1.2e-7 after one iteration to 9.4e-5 after
# ten, at HIGH from 8.9e-8 to 1.1e-3 (a one-ulp change of an operand can
# move its bf16 split, and so a three-pass product by up to 2^-17 of its
# size), hence 5e-3 there.
BAMP_CASES = [
    ("dense_qpsk", dict(alphabet="QPSK", iterations=8), 0, 1.5, "dense",
     1e-3),
    ("dense_ook", dict(alphabet="OOK", iterations=12), 0, 1.2, "dense",
     1e-3),
    ("real_bpsk", dict(alphabet="BPSK", is_complex=False, iterations=10), 9,
     1.3, "banded", 5e-3),
    ("qpsk_lin33", dict(alphabet="QPSK", Lin=33, iterations=8), 1, 1.5,
     "banded", 1e-3),
]


@pytest.mark.parametrize("name,kw,seed,snr_exp,form,tol_unconverged",
                         BAMP_CASES, ids=[c[0] for c in BAMP_CASES])
def test_bamp_plain_high_matches_xla_high(witness, name, kw, seed, snr_exp,
                                          form, tol_unconverged):
    cfg, op, _, y, s2, jcfg, jop, jy = banded_inputs(kw, seed, snr_exp)
    H, jH = op, jop
    if form == "dense":
        H, jH = op.densify(), jop.densify()
    knob = False if name == "qpsk_lin33" else "auto"
    assert bamp.route(cfg, operators.as_operator(H), 8, "cpu",
                      "high") == ("plain" if knob else "whole")
    assert bamp.route(cfg, operators.as_operator(H), 8, "cpu", "high",
                      knob) == "plain"
    before = bamp.plain_decodes
    port, st = bamp.decode(H, y, s2, cfg, precision="high",
                           return_state=True, use_pallas=knob)
    assert bamp.plain_decodes == before + 1
    ref = jbamp.decode(jH, jy, s2, jcfg, precision=HIGH)
    assert_same_high(port, ref, st.active, tol_unconverged=tol_unconverged)
    # the HIGH products are the ones that ran: HIGHEST differs somewhere
    assert not torch.equal(bamp.decode(H, y, s2, cfg).xmap, port.xmap)


def test_bamp_falls_through_at_high(monkeypatch):
    """Lin = 33: K1's HIGH layout now holds a trial of more than 32 column
    blocks (a unit of its products spans at most four n8 tiles), so at HIGH
    every alphabet takes K1, as JAX's K1 does there, and the decode is K1's
    plain HIGH version.  Only where the chain skips K1
    (``AMP_PALLAS_MODE=periter``) does it still fall through: OOK to K6 at
    HIGHEST (its decode at HIGH is the HIGHEST one bit for bit), BPSK to K5
    at HIGH (the plain HIGH plane loop), QPSK to the plain loop.  Where
    JAX's K1 takes the batch and the port's block holds no trial, the
    route is K1's cluster form (``'whole'``); where no cluster holds one
    either (a plan made to say so), K1's plain version
    (``'whole_plain'``)."""
    geo = dict(BASE, Lin=33)
    assert fused_bamp.fits(Config(**geo), "high")
    assert fused_bamp.fits(Config(**geo))
    alphabets = ("OOK", "BPSK", "QPSK")
    for a in alphabets:
        cfg = Config(**dict(geo, alphabet=a))
        assert bamp.route_of(cfg, True, precision="high", batch=8) == "whole"
        assert bamp.route_of(cfg, True, batch=8) == "whole"
    cfg, op, _, y, s2, *_ = banded_inputs(
        dict(alphabet="OOK", Lin=33, iterations=12), 0, 1.2)
    high = bamp.decode(op, y, s2, cfg, precision="high")
    s0 = bamp.initial_state(y, cfg.N, float(np.float32(s2)))
    want = fused_bamp.decode_plain_high(op, s0, y, s2, cfg.N_Layers, cfg)
    assert torch.equal(high.T, want.T) and torch.equal(high.xmap, want.xmap)
    monkeypatch.setenv("AMP_PALLAS_MODE", "periter")
    routes = {a: bamp.route_of(Config(**dict(geo, alphabet=a)), True,
                               precision="high", batch=8)
              for a in alphabets}
    assert routes == {"OOK": "periter", "BPSK": "tiled", "QPSK": "plain"}
    high = bamp.decode(op, y, s2, cfg, precision="high")
    highest = bamp.decode(op, y, s2, cfg)
    assert torch.equal(high.T, highest.T)
    assert torch.equal(high.xmap, highest.xmap)
    cfg, op, _, y, s2, *_ = banded_inputs(
        dict(alphabet="BPSK", Lin=33, iterations=10), 2, 1.3)
    high = bamp.decode(op, y, s2, cfg, precision="high")
    s0 = bamp.initial_state(y, cfg.N, float(np.float32(s2)))
    want = fused_bamp_tiled.decode_plain(op, s0, y, s2, cfg.N_Layers, cfg,
                                         "high")
    assert torch.equal(high.T, want.T) and torch.equal(high.xmap, want.xmap)
    monkeypatch.delenv("AMP_PALLAS_MODE")
    # a block that holds no trial, where JAX's K1 takes the batch
    flag = dataclasses.replace(flagship_bamp_qpsk(), Lin=32)
    assert not fused_bamp.fits(flag, "high") and fused_bamp.jax_fits(flag, 8)
    assert fused_bamp.cluster_plan(flag, "high").ctas == 2
    assert bamp.route_of(flag, True, precision="high", batch=8) == "whole"
    monkeypatch.setattr(fused_bamp, "fits", lambda *a: False)
    monkeypatch.setattr(fused_bamp, "cluster_plan",
                        lambda *a, **k: fused_bamp.ClusterPlan(
                            0, (), (), (), 0, 0))
    assert bamp.route(cfg, op, 8, "cpu", "high") == "whole_plain"
    before = bamp.plain_decodes
    high = bamp.decode(op, y, s2, cfg, precision="high")
    assert bamp.plain_decodes == before + 1
    want = fused_bamp.decode_plain_high(op, s0, y, s2, cfg.N_Layers, cfg)
    assert torch.equal(high.T, want.T) and torch.equal(high.xmap, want.xmap)


# (name, config overrides, seed, SNR exponent, operator form, trials,
# base): SCAMP on a dense operator, and at the 8PSK sweep geometry (which
# K2 does not fit) at its 7 dB point
SCAMP_CASES = [
    ("dense_ook", dict(mode="sparc", alphabet="OOK", iterations=30), 0, 1.5,
     "dense", 8, BASE),
    ("dense_qpsk", dict(mode="sparc", alphabet="QPSK", iterations=30), 1,
     1.8, "dense", 8, BASE),
    ("8psk_sweep", dict(), 0,
     (7.0 + 10 * np.log10(Config(**SCAMP_8PSK).code_rate)) / 10, "banded",
     4, SCAMP_8PSK),
]


@pytest.mark.parametrize("name,kw,seed,snr_exp,form,batch,base",
                         SCAMP_CASES, ids=[c[0] for c in SCAMP_CASES])
def test_scamp_plain_high_matches_xla_high(witness, name, kw, seed, snr_exp,
                                           form, batch, base):
    cfg, op, W, y, s2, jcfg, jop, jy = banded_inputs(kw, seed, snr_exp,
                                                     batch, base)
    A, jA = op, jop
    if form == "dense":
        A, jA = op.densify(), jop.densify()
    else:
        assert fused_scamp.covers(cfg) and not fused_scamp.fits(cfg)
    assert not scamp.kernel_route(cfg, form == "banded")
    before = scamp.plain_decodes
    port, st = scamp.decode(W, A, y, s2, cfg, precision="high",
                            return_state=True)
    assert scamp.plain_decodes == before + 1
    ref = jscamp.decode(jnp.asarray(W), jA, jy, s2, jcfg, precision=HIGH)
    assert_same_high(port, ref, st.active)
    assert not torch.equal(scamp.decode(W, A, y, s2, cfg).xmap, port.xmap)


def test_base_product_is_dot3():
    """``base_product`` at HIGH is JAX's ``dot3(a, m.T)`` within 1e-6 of
    the scale, its three passes grouped as dot3 groups them; at HIGHEST
    the plain product-plus-sum."""
    rng = np.random.default_rng(3)
    a = rng.uniform(0.0, 1.0, (64, 21)).astype(np.float32)
    m = rng.uniform(0.0, 1.0, (23, 21)).astype(np.float32)
    ta, tm = torch.from_numpy(a), torch.from_numpy(m)
    got = scamp.base_product(ta, tm, "high").numpy()
    ref = np.asarray(jfb.dot3(jnp.asarray(a), jnp.asarray(m.T)))
    assert float(np.max(np.abs(got - ref) / (a @ m.T))) < 1e-6
    assert float(np.max(np.abs(got - a @ m.T) / (a @ m.T))) > 1e-7
    assert torch.equal(scamp.base_product(ta, tm),
                       (ta[:, None, :] * tm).sum(-1))


@pytest.mark.parametrize("algo", ["vamp", "vamp2"])
def test_vamp_random_mode_plain_high_matches_xla_high(witness, algo):
    """VAMP and vamp2 in the random mode (no kernel covers it) at HIGH: the
    plain loop with its two products at HIGH against JAX's XLA decode at
    HIGH on shared factors, under test_torch_vamp.py's rule (r within
    5e-2, xmmse and var within 1e-3)."""
    cfg, dec, y, s2, jcfg, jdec, jy = test_torch_vamp.shared_inputs(
        dict(alphabet="QPSK", mode="random"), 1.9)
    mod, jmod = (vamp, jvamp) if algo == "vamp" else (vamp2, jvamp2)
    before = mod.plain_decodes
    port = mod.decode(dec, y, s2, cfg, precision="high")
    assert mod.plain_decodes == before + 1
    ref = jmod.decode(jdec, jy, s2, jcfg, precision=HIGH)
    test_torch_vamp.assert_same_decode(port, ref)
    assert not torch.equal(mod.decode(dec, y, s2, cfg).xmap, port.xmap)


@pytest.mark.parametrize("algo", ["vamp", "vamp2"])
def test_vamp_plain_loop_at_highest_unchanged(algo):
    """``plain_loop(precision='highest')`` is the loop it was: its products
    are ``x @ a`` exactly (``prec.matmul``), so a decode with
    ``use_pallas=False`` at HIGHEST equals the plain version of the kernel
    at HIGHEST on the CPU, and at HIGH it runs the XLA body, not the
    kernel's HIGH body (``plain_loop_high``)."""
    cfg, dec, y, s2, *_ = test_torch_vamp.shared_inputs(
        dict(alphabet="QPSK"), 1.9)
    mod = vamp if algo == "vamp" else vamp2
    plain = mod.decode(dec, y, s2, cfg, use_pallas=False)
    kern = mod.decode(dec, y, s2, cfg)
    assert torch.equal(plain.T, kern.T) and torch.equal(plain.xmap,
                                                        kern.xmap)
    xla_high = mod.decode(dec, y, s2, cfg, precision="high",
                          use_pallas=False)
    kern_high = mod.decode(dec, y, s2, cfg, precision="high")
    assert not torch.equal(xla_high.xmap, kern_high.xmap)
    assert prec.matmul(y, dec.U.conj(), "highest").equal(y @ dec.U.conj())
