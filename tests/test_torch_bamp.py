"""The port's ``bamp.decode`` against the JAX package's XLA decode
(``use_pallas=False``) on shared inputs: per-trial T identical, state
within 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu.config import Config as JConfig
from amp_sparc_spatialmodulation_tpu.models import bamp as jbamp
from amp_sparc_spatialmodulation_tpu.ops import channel as jchannel
from amp_sparc_spatialmodulation_tpu.ops import message as jmessage
from amp_sparc_spatialmodulation_tpu.ops import operators as joperators
from amp_sparc_spatialmodulation_tpu_torch import interop
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.models import bamp

from test_torch_fused_bamp import GEOMETRIES, assert_same_decode, shared_inputs


@pytest.mark.parametrize("name,kw,seed,snr_exp", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_decode_matches_xla(name, kw, seed, snr_exp):
    cfg, op, y, s2, jcfg, jop, jy = shared_inputs(kw, seed, snr_exp)
    ref = jbamp.decode(jop, jy, s2, jcfg)
    port = bamp.decode(op, y, s2, cfg)
    assert_same_decode(port, ref)


def test_dense_operator_matches_xla():
    """A dense matrix takes the plain loop; it matches the JAX dense
    decode."""
    cfg, op, y, s2, jcfg, jop, jy = shared_inputs(GEOMETRIES[3][1], 0, 1.5)
    A = jop.densify()
    ref = jbamp.decode(A, jy, s2, jcfg)
    before = bamp.plain_decodes
    port = bamp.decode(torch.as_tensor(np.array(A)), y, s2, cfg)
    assert bamp.plain_decodes == before + 1
    assert_same_decode(port, ref)


def test_real_channel_mode_matches_xla():
    """The real-valued channel mode (no tau halving, doubled mixture
    covariance) is outside the kernel and runs the plain loop."""
    base = dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, mode="segmented",
                alphabet="BPSK", profile="uniform", trunc="tail",
                is_complex=False, iterations=10)
    jcfg, cfg = JConfig(**base), Config(**base)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(9), 3)
    _, jop = joperators.banded_sparc(k1, jcfg)
    msg = jmessage.generate_message(k2, jcfg, 8)
    snr = 10 ** 1.3
    jy = jop.apply(msg.x) + jchannel.awgn(k3, jcfg, snr, 8)
    op = interop.operator_from_numpy(np.asarray(jop.h), np.asarray(jop.gains),
                                     cfg.Lin, cfg.Lout, cfg.trunc,
                                     device="cpu")
    ref = jbamp.decode(jop, jy, jcfg.sigma2(snr), jcfg)
    port = bamp.decode(op, torch.as_tensor(np.array(jy)), jcfg.sigma2(snr),
                       cfg)
    np.testing.assert_array_equal(port.T.numpy(), np.asarray(ref.T))
    for f in ("xmap", "xmmse", "var"):
        d = np.abs(getattr(port, f).numpy() - np.asarray(getattr(ref, f)))
        assert float(d.max()) < 1e-4, f


def test_flagship_decode_matches_xla():
    """``flagship_bamp_ook()`` at Eb/N0 = 8 dB, one shared realization of
    256 trials drawn by the JAX package.  At this geometry per-trial T
    depends on the last bits of the products, so the two packages' CPU
    matrix products let a few percent of the trials stop an iteration
    apart: T identical on >= 95% of the trials, |d mean T| <= 0.1, state
    within 1e-4 where T agrees.  (tests/torch_parity_flagship.py measures
    the mean-T difference over many realizations.)"""
    from amp_sparc_spatialmodulation_tpu.config import (
        flagship_bamp_ook as jflagship)
    from amp_sparc_spatialmodulation_tpu_torch.config import flagship_bamp_ook
    jcfg, cfg = jflagship(), flagship_bamp_ook()
    B, snr = 256, 10 ** ((8.0 + 10 * np.log10(cfg.code_rate)) / 10)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    _, jop = joperators.banded_sparc(k1, jcfg)
    msg = jmessage.generate_message(k2, jcfg, B)
    jy = jop.apply(msg.x) + jchannel.awgn(k3, jcfg, snr, B)
    s2 = jcfg.sigma2(snr)
    op = interop.operator_from_numpy(np.asarray(jop.h), np.asarray(jop.gains),
                                     cfg.Lin, cfg.Lout, cfg.trunc,
                                     device="cpu")
    ref = jbamp.decode(jop, jy, s2, jcfg)
    port = bamp.decode(op, torch.as_tensor(np.array(jy)), s2, cfg)
    jT, pT = np.asarray(ref.T), port.T.numpy()
    agree = jT == pT
    assert agree.mean() >= 0.95
    assert abs(pT.mean() - jT.mean()) <= 0.1
    for f in ("xmap", "xmmse", "var"):
        d = np.abs(getattr(port, f).numpy()[agree]
                   - np.asarray(getattr(ref, f))[agree])
        assert float(d.max()) < 1e-4, f


@pytest.mark.parametrize("cap", [1, 3, 7])
def test_iter_cap_and_return_state(cap):
    cfg, op, y, s2, jcfg, jop, jy = shared_inputs(GEOMETRIES[1][1], 0, 1.2)
    jres, jst = jbamp.decode(jop, jy, s2, jcfg, iter_cap=cap,
                             return_state=True)
    res, st = bamp.decode(op, y, s2, cfg, iter_cap=cap, return_state=True)
    assert_same_decode(res, jres)
    assert st.t == int(jst.t)
    np.testing.assert_array_equal(st.active.numpy(), np.asarray(jst.active))
    for f in ("z", "u"):
        d = np.abs(getattr(st, f).numpy() - np.asarray(getattr(jst, f)))
        assert float(d.max()) < 1e-4, f
    resumed = bamp.decode(op, y, s2, cfg, state0=st)
    assert_same_decode(resumed, jbamp.decode(jop, jy, s2, jcfg))


def test_allclose_rows_and_freeze():
    a = torch.tensor([[1.0, 2.0], [1.0, 2.0]])
    b = torch.tensor([[1.0, 2.0 + 1e-5], [1.0, 2.1]])
    np.testing.assert_array_equal(
        bamp._allclose_rows(a, b).numpy(),
        np.asarray(jbamp._allclose_rows(jnp.asarray(a.numpy()),
                                        jnp.asarray(b.numpy()))))
    mask = torch.tensor([True, False])
    new = torch.tensor([[float("nan"), 1.0], [float("inf"), 2.0]])
    old = torch.zeros(2, 2)
    out = bamp._freeze(mask, new, old)
    assert torch.equal(out[1], old[1])      # selection: no inf/nan leaks
    assert torch.equal(bamp._freeze(mask, torch.ones(2), torch.zeros(2)),
                       torch.tensor([1.0, 0.0]))


@pytest.mark.parametrize("mode,alphabet,is_complex", [
    ("segmented", "OOK", True), ("sparc", "QPSK", True),
    ("random", "QPSK", True), ("random", "BPSK", False)])
def test_make_denoiser_matches_jax(mode, alphabet, is_complex):
    base = dict(Nt=16, Na=4, Nr=8, Lin=4, Lh=2, mode=mode,
                alphabet=alphabet, is_complex=is_complex)
    jden = jbamp.make_denoiser(JConfig(**base))
    tden = bamp.make_denoiser(Config(**base), torch.device("cpu"))
    rng = np.random.default_rng(0)
    r = (rng.normal(size=(3, 64)) + 1j * rng.normal(size=(3, 64))).astype(
        np.complex64)
    if not is_complex:
        r = r.real.copy()
    cov = rng.uniform(0.1, 0.5, (3, 64)).astype(np.float32)
    jm, jv = jden(jnp.asarray(r), jnp.asarray(cov))
    tm, tv = tden(torch.as_tensor(r), torch.as_tensor(cov))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
