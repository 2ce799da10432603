"""The port's SCAMP decoder and the plain version of its whole-decode kernel
(``ops/kernels/fused_scamp.py::decode_plain``, the function the CUDA kernel
computes) against the JAX package's SCAMP on shared inputs: its XLA decode
and its Pallas whole-decode kernel, run in interpret mode on the CPU
(``use_pallas=True``), on the geometries of ``tests/test_pallas_scamp.py``.
Per-trial T must be identical and the state within 1e-4, the JAX package's
own kernel-against-XLA tolerances.  The CUDA kernel itself is checked
against this plain version on the card by ``chip_smoke.py``."""
import json
import os

import jax
import numpy as np
import pytest
import torch

import oracle
from amp_sparc_spatialmodulation_tpu.config import Config as JConfig
from amp_sparc_spatialmodulation_tpu.models import scamp as jscamp
from amp_sparc_spatialmodulation_tpu.ops import channel as jchannel
from amp_sparc_spatialmodulation_tpu.ops import message as jmessage
from amp_sparc_spatialmodulation_tpu.ops import operators as joperators
from amp_sparc_spatialmodulation_tpu_torch import cli, interop
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.models import montecarlo as mc
from amp_sparc_spatialmodulation_tpu_torch.models import scamp
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_scamp

B = 8

# (name, config overrides, estimate_phi, SNR exponent):
# tests/test_pallas_scamp.py:13-56
GEOMETRIES = [
    ("ook_tail", dict(trunc="tail"), False, 1.5),
    ("ook_trunc", dict(trunc="trunc"), False, 1.5),
    ("ook_cyclic", dict(trunc="cyclic"), False, 1.5),
    ("qpsk_tail", dict(alphabet="QPSK"), False, 1.8),
    ("ook_estimate_phi", dict(), True, 1.5),
]


def shared_inputs(kw, snr_exp, batch=B, seed=0, cfg_fn=None):
    """A SPARC realization drawn by the JAX package, carried over through
    NumPy: (port config, W, port operator, y, sigma2, JAX config, JAX W,
    JAX operator, JAX y)."""
    if cfg_fn is None:
        base = dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, mode="sparc",
                    alphabet="OOK", profile="uniform", trunc="tail",
                    iterations=10)
        base.update(kw)
        jcfg, cfg = JConfig(**base), Config(**base)
    else:
        jcfg, cfg = cfg_fn
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    jW, jop = joperators.banded_sparc(k1, jcfg)
    msg = jmessage.generate_message(k2, jcfg, batch)
    snr = 10 ** snr_exp
    jy = jop.apply(msg.x) + jchannel.awgn(k3, jcfg, snr, batch)
    op = interop.operator_from_numpy(np.asarray(jop.h), np.asarray(jop.gains),
                                     cfg.Lin, cfg.Lout, cfg.trunc,
                                     device="cpu")
    W = torch.as_tensor(np.array(jW))
    return (cfg, W, op, torch.as_tensor(np.array(jy)), jcfg.sigma2(snr),
            jcfg, jW, jop, jy)


def assert_same_decode(port, ref, tol=1e-4):
    """T identical, xmap, xmmse and var = 1 - psi within ``tol``."""
    np.testing.assert_array_equal(port.T.numpy(), np.asarray(ref.T))
    for f in ("xmap", "xmmse", "var"):
        got = getattr(port, f) if hasattr(port, f) else 1.0 - port.psi
        d = np.abs(got.numpy() - np.asarray(getattr(ref, f)))
        assert float(d.max()) < tol, f


def plain_decode(op, W, y, sigma2, cfg, cap=None, state0=None,
                 estimate_phi=False):
    s0 = state0 if state0 is not None else scamp.initial_state(y, cfg)
    return fused_scamp.decode_plain(
        op, W, s0, y, sigma2, cfg.N_Layers if cap is None else cap, cfg,
        estimate_phi)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("name,kw,est,snr_exp", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_plain_matches_jax(name, kw, est, snr_exp, use_pallas):
    cfg, W, op, y, s2, jcfg, jW, jop, jy = shared_inputs(kw, snr_exp)
    assert fused_scamp.covers(cfg) and fused_scamp.fits(cfg)
    ref = jscamp.decode(jW, jop, jy, s2, jcfg, estimate_phi=est,
                        use_pallas=use_pallas)
    assert_same_decode(plain_decode(op, W, y, s2, cfg, estimate_phi=est), ref)
    # the decoder's own entry point takes the same path on the CPU
    assert_same_decode(scamp.decode(W, op, y, s2, cfg, estimate_phi=est), ref)


def test_split_and_resume_matches_unsplit():
    """Split at iter_cap=3 and resume: the trajectory of the unsplit
    decode, in the port and against the JAX kernel's resumed run
    (tests/test_pallas_scamp.py:58-65)."""
    cfg, W, op, y, s2, jcfg, jW, jop, jy = shared_inputs(
        dict(iterations=12), 1.2)
    full = plain_decode(op, W, y, s2, cfg)
    part = plain_decode(op, W, y, s2, cfg, cap=3)
    assert part.t == 3 and bool(part.active.any())
    resumed = plain_decode(op, W, y, s2, cfg, state0=part)
    assert torch.equal(full.T, resumed.T)
    for f in ("xmmse", "psi", "phi"):
        assert float((getattr(full, f) - getattr(resumed, f)).abs().max()) \
            < 1e-5
    _, jst = jscamp.decode(jW, jop, jy, s2, jcfg, use_pallas=True,
                           iter_cap=3, return_state=True)
    jres = jscamp.decode(jW, jop, jy, s2, jcfg, use_pallas=True, state0=jst)
    assert_same_decode(resumed, jres)


def test_resume_state_from_jax():
    """A JAX SCAMPState carried over through NumPy (interop) resumes in the
    port to the JAX decode's final state; the round trip keeps every
    field."""
    cfg, W, op, y, s2, jcfg, jW, jop, jy = shared_inputs(
        dict(alphabet="QPSK"), 1.8)
    _, jst = jscamp.decode(jW, jop, jy, s2, jcfg, iter_cap=2,
                           return_state=True)
    s0 = interop.scamp_state_from_numpy(*[np.asarray(v) for v in jst],
                                        device="cpu")
    assert s0.t == 2 and bool(torch.isfinite(s0.phi).all())
    back = interop.scamp_state_to_numpy(s0)
    for f in jst._fields:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jst, f)))
    _, port = scamp.decode(W, op, y, s2, cfg, state0=s0, return_state=True)
    _, ref = jscamp.decode(jW, jop, jy, s2, jcfg, state0=jst,
                           return_state=True)
    assert port.t == int(ref.t)
    assert_same_decode(port, _with_var(ref))
    for f in ("phi", "z"):
        d = np.abs(getattr(port, f).numpy() - np.asarray(getattr(ref, f)))
        assert float(d.max()) < 1e-4, f


def _with_var(st):
    """A JAX state seen as a DecodeResult (``var = 1 - psi``)."""
    return jscamp.DecodeResult(xmap=st.xmap, xmmse=st.xmmse,
                               var=1.0 - st.psi, T=st.T)


def test_main_path_geometry_matches_xla():
    """The main path's geometry (Nt=128, Na=8, Nr=24, Lin=20, Lh=3, OOK,
    sparc, tail) at Eb/N0 = 8 dB, one shared realization of 256 trials.
    At this geometry per-trial T depends on the last bits of the products,
    so the two packages' CPU matrix products let a few percent of the
    trials stop an iteration apart: T identical on >= 95% of the trials,
    |d mean T| <= 0.1, state within 1e-4 where T agrees."""
    base = dict(Nt=128, Na=8, Nr=24, Lin=20, Lh=3, mode="sparc",
                alphabet="OOK", profile="uniform", trunc="tail",
                iterations=100)
    cfg = Config(**base)
    snr_exp = (8.0 + 10 * np.log10(cfg.code_rate)) / 10
    cfg, W, op, y, s2, jcfg, jW, jop, jy = shared_inputs(
        None, snr_exp, batch=256, cfg_fn=(JConfig(**base), cfg))
    ref = jscamp.decode(jW, jop, jy, s2, jcfg)
    port = scamp.decode(W, op, y, s2, cfg)
    jT, pT = np.asarray(ref.T), port.T.numpy()
    agree = jT == pT
    assert agree.mean() >= 0.95
    assert abs(pT.mean() - jT.mean()) <= 0.1
    for f in ("xmap", "xmmse", "var"):
        d = np.abs(getattr(port, f).numpy()[agree]
                   - np.asarray(getattr(ref, f))[agree])
        assert float(d.max()) < 1e-4, f


def test_flagship_scamp_matches_xla():
    """``config.flagship_scamp()`` (QPSK, Nt=128, Na=16, Nr=16, Lin=40,
    Lh=9) at its full width, 16 trials, cap 6."""
    from amp_sparc_spatialmodulation_tpu.config import (
        flagship_scamp as jflagship)
    from amp_sparc_spatialmodulation_tpu_torch.config import flagship_scamp
    cfg = flagship_scamp()
    assert fused_scamp.covers(cfg) and fused_scamp.fits(cfg)
    snr_exp = (10.0 + 10 * np.log10(cfg.code_rate)) / 10
    cfg, W, op, y, s2, jcfg, jW, jop, jy = shared_inputs(
        None, snr_exp, batch=16, cfg_fn=(jflagship(), cfg))
    ref = jscamp.decode(jW, jop, jy, s2, jcfg, iter_cap=6)
    assert_same_decode(scamp.decode(W, op, y, s2, cfg, iter_cap=6), ref)


def test_matches_numpy_oracle():
    """The NumPy oracle of the reference equations as a third witness, on
    a dense SPARC matrix (tests/test_decoders.py:98-110, at that test's
    tolerances: T within 1, xmmse within 2e-2)."""
    base = dict(Nt=16, Na=4, Nr=10, Lin=6, Lh=3, mode="sparc",
                iterations=30, alphabet="QPSK", profile="uniform",
                trunc="tail")
    jcfg, cfg = JConfig(**base), Config(**base)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(2), 3)
    W, A = jchannel.generate_as_sparc(k1, jcfg)
    msg = jmessage.generate_message(k2, jcfg, 3)
    snr = 10 ** 1.6
    y = np.asarray(msg.x @ A.T + jchannel.awgn(k3, jcfg, snr, 3))
    W, A, sigma2 = np.asarray(W), np.asarray(A), jcfg.E / snr
    before = scamp.plain_decodes
    res = scamp.decode(W, torch.as_tensor(np.array(A)),
                       torch.as_tensor(np.array(y)), sigma2, cfg)
    assert scamp.plain_decodes == before + 1      # dense: the plain loop
    symbols = np.asarray(cfg.symbols)
    for b in range(y.shape[0]):
        _, xmmse_ref, _, T_ref = oracle.scamp(
            W, A, y[b], sigma2, symbols, cfg.Na, cfg.Lc, cfg.Lr, cfg.Mc,
            cfg.Mr, cfg.N_Layers)
        assert abs(int(res.T[b]) - T_ref) <= 1
        np.testing.assert_allclose(res.xmmse[b].numpy(), xmmse_ref,
                                   atol=2e-2)


def test_global_counter_rule_and_cpu_dispatch():
    """``t`` runs to the cap while any trial is active, else stops at the
    slowest trial's T (scamp.py:72-73); on CPU tensors the wrapper is its
    plain version and launches nothing."""
    cfg, W, op, y, s2, *_ = shared_inputs(dict(), 1.5)
    s0 = scamp.initial_state(y, cfg)
    before = fused_scamp.launches
    done = fused_scamp.whole_decode(op, W, s0, y, s2, cfg.N_Layers, cfg)
    want = plain_decode(op, W, y, s2, cfg)
    assert fused_scamp.launches == before
    for f in scamp.SCAMPState._fields:
        a, b = getattr(done, f), getattr(want, f)
        assert (a == b) if f == "t" else torch.equal(a, b), f
    assert not bool(done.active.any()) and done.t == int(done.T.max())
    capped = plain_decode(op, W, y, s2, cfg, cap=2)
    assert bool(capped.active.any()) and capped.t == 2
    assert int(capped.T.max()) == 2
    with pytest.raises(ValueError):
        fused_scamp.whole_decode(op, W, s0, y.to("meta"), s2, 10, cfg)


def test_coverage_rule_and_shared_memory():
    """The JAX FusedScampDecode.covers rule, plus the shared-memory fit:
    the main geometry and flagship_scamp() fit one block, the SCAMP 8PSK
    geometry (Nt=480, Lin=32) does not and runs the plain loop."""
    from amp_sparc_spatialmodulation_tpu.ops.pallas.fused_scamp import (
        FusedScampDecode)
    from amp_sparc_spatialmodulation_tpu_torch.config import flagship_scamp
    for kw in (dict(mode="sparc", alphabet="OOK"),
               dict(mode="sparc", alphabet="QPSK"),
               dict(mode="segmented", alphabet="8PSK"),
               dict(mode="random", alphabet="QPSK"),
               dict(mode="sparc", alphabet="BPSK", is_complex=False)):
        base = dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, **kw)
        assert fused_scamp.covers(Config(**base)) \
            == FusedScampDecode.covers(JConfig(**base)), kw
    main = Config(Nt=128, Na=8, Nr=24, Lin=20, Lh=3, mode="sparc",
                  alphabet="OOK", trunc="tail")
    assert fused_scamp.smem_bytes(main) == 4 * (2 * 1440 + 2 * 2560
                                                + 4 * 528 + 2 * 42)
    assert fused_scamp.fits(main) and fused_scamp.fits(flagship_scamp())
    psk8 = Config(Nt=480, Na=30, Nr=57, Lin=32, Lh=6, mode="sparc",
                  alphabet="8PSK")
    assert not fused_scamp.fits(psk8)


def test_simulator_needs_the_sparc_channel(tmp_path):
    cfg = Config(Nt=16, Na=4, Nr=10, Lin=8, Lh=3, mode="sparc")
    for kind in ("toeplitz", "iid"):
        with pytest.raises(ValueError, match="sparc"):
            mc.Simulator(cfg, algo="scamp", channel_kind=kind, device="cpu")
        with pytest.raises(ValueError, match="sparc"):
            mc.make_two_phase_fn(cfg, "scamp", kind, 32, 4)


def test_cli_sweep_scamp_estimate_phi_on_cpu(tmp_path):
    rc = cli.main(["sweep", "--algo", "scamp", "--mode", "sparc",
                   "--estimate-phi", "--Nt", "16", "--Na", "4", "--Nr", "10",
                   "--Lin", "8", "--Lh", "3", "--iterations", "20",
                   "--epochs", "32", "--res", "32", "--start", "8",
                   "--final", "8", "--two-phase", "4", "--device", "cpu",
                   "--out", str(tmp_path)])
    assert rc == 0
    path = os.path.join(str(tmp_path), "SCAMP", Config(
        Nt=16, Na=4, Nr=10, Lin=8, Lh=3, mode="sparc", alphabet="OOK",
        profile="uniform", trunc="tail", iterations=20).name, "8.0.json")
    with open(path) as f:
        point = json.load(f)
    assert point["EbN0dB"] == 8.0 and 1.0 <= point["T"] <= 20.0
