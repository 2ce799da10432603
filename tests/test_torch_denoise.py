"""The port's denoisers against the JAX package's on shared (r, cov)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu.ops import denoise as jdenoise
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.ops import denoise

TOL = 1e-5


def _inputs(cfg, B, seed, tau_shape):
    rng = np.random.default_rng(seed)
    # pseudo-data near the transmitted symbols plus noise, as a decode sees
    x = np.zeros((B, cfg.L, cfg.M), np.complex64)
    idx = rng.integers(0, cfg.M, (B, cfg.L))
    sym = cfg.symbols[rng.integers(0, cfg.K, (B, cfg.L))]
    np.put_along_axis(x, idx[..., None], sym[..., None], axis=-1)
    r = (x.reshape(B, cfg.N)
         + 0.4 * (rng.normal(size=(B, cfg.N))
                  + 1j * rng.normal(size=(B, cfg.N)))).astype(np.complex64)
    if tau_shape == "scalar":
        tau = np.float32(0.3)
    elif tau_shape == "row":
        tau = rng.uniform(0.05, 0.5, (B, 1)).astype(np.float32)
    else:
        tau = rng.uniform(0.05, 0.5, (B, cfg.N)).astype(np.float32)
    return r, tau


def _t(a):
    return torch.as_tensor(np.asarray(a)) if np.ndim(a) else float(a)


@pytest.mark.parametrize("variance", ["decomposed", "second_moment", None])
@pytest.mark.parametrize("halve", [True, False])
@pytest.mark.parametrize("alphabet", ["OOK", "QPSK", "8PSK"])
def test_segmented_posterior_matches_jax(alphabet, halve, variance):
    cfg = Config(Nt=16, Na=4, Nr=8, Lin=6, Lh=3, mode="segmented",
                 alphabet=alphabet)
    assert cfg.K == {"OOK": 1, "QPSK": 4, "8PSK": 8}[alphabet]
    for tau_shape in ("scalar", "row", "full"):
        r, tau = _inputs(cfg, 6, 1, tau_shape)
        syms = cfg.symbols
        jm, jv = jdenoise.segmented_posterior(
            jnp.asarray(r), jnp.asarray(tau), jnp.asarray(syms), cfg.L,
            cfg.M, halve_tau=halve, variance=variance)
        tm, tv = denoise.segmented_posterior(
            torch.as_tensor(r), _t(tau), torch.as_tensor(syms), cfg.L,
            cfg.M, halve_tau=halve, variance=variance)
        assert tm.dtype == torch.complex64
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=TOL,
                                   atol=TOL)
        if variance is None:
            assert tv is None and jv is None
        else:
            assert tv.dtype == torch.float32
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL,
                                       atol=TOL)


def test_segmented_posterior_real_pseudo_data():
    """Real-channel mode: real r gives a float32 posterior mean."""
    cfg = Config(Nt=16, Na=4, Nr=8, Lin=6, Lh=3, mode="segmented",
                 alphabet="BPSK", is_complex=False)
    r, tau = _inputs(cfg, 4, 2, "full")
    r = r.real.copy()
    jm, jv = jdenoise.segmented_posterior(
        jnp.asarray(r), jnp.asarray(tau), jnp.asarray(cfg.symbols), cfg.L,
        cfg.M, halve_tau=False)
    tm, tv = denoise.segmented_posterior(
        torch.as_tensor(r), torch.as_tensor(tau),
        torch.as_tensor(cfg.symbols), cfg.L, cfg.M, halve_tau=False)
    assert tm.dtype == torch.float32
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)


def test_segmented_posterior_bad_variance_form():
    cfg = Config(Nt=16, Na=4, Nr=8, Lin=6, Lh=3, mode="segmented")
    r, tau = _inputs(cfg, 2, 3, "scalar")
    with pytest.raises(ValueError):
        denoise.segmented_posterior(torch.as_tensor(r), 0.3,
                                    torch.as_tensor(cfg.symbols), cfg.L,
                                    cfg.M, halve_tau=True, variance="x")


@pytest.mark.parametrize("alphabet", ["OOK", "QPSK", "8PSK", "16QAM"])
def test_bernoulli_mixture_matches_jax(alphabet):
    cfg = Config(Nt=16, Na=4, Nr=8, Lin=6, Lh=3, mode="random",
                 alphabet=alphabet)
    r, tau = _inputs(cfg.replace(mode="segmented"), 5, 4, "full")
    jm, jv = jdenoise.bernoulli_mixture_posterior(
        jnp.asarray(r), jnp.asarray(tau), jnp.asarray(cfg.symbols),
        cfg.Ps, cfg.P0)
    tm, tv = denoise.bernoulli_mixture_posterior(
        torch.as_tensor(r), torch.as_tensor(tau),
        torch.as_tensor(cfg.symbols), cfg.Ps, cfg.P0)
    assert np.all(np.isfinite(tm.numpy())) and np.all(np.isfinite(tv.numpy()))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)
    tm2, tv2 = denoise.bernoulli_mixture_posterior(
        torch.as_tensor(r), torch.as_tensor(tau),
        torch.as_tensor(cfg.symbols), cfg.Ps, cfg.P0, with_variance=False)
    assert tv2 is None and torch.equal(tm2, tm)


def test_bernoulli_mixture_far_out_stays_finite():
    """Entries far from every symbol hit the exponent clamp; the clamp
    keeps every likelihood (a float32 subnormal at worst) finite, so the
    posterior stays finite.  (XLA on the CPU flushes those subnormals to
    zero and takes the zero-norm guard instead: no value comparison.)"""
    cfg = Config(Nt=16, Na=4, Nr=8, Lin=6, Lh=3, mode="random",
                 alphabet="QPSK")
    r = torch.full((2, cfg.N), 40.0 + 40.0j, dtype=torch.complex64)
    tau = torch.full((2, cfg.N), 1e-3)
    m, v = denoise.bernoulli_mixture_posterior(
        r, tau, torch.as_tensor(cfg.symbols), cfg.Ps, cfg.P0)
    assert bool(torch.isfinite(m).all()) and bool(torch.isfinite(v).all())


def test_regularizers():
    a = torch.tensor([0.0, 1.0, 200.0])
    assert denoise.regularize_zero(a)[0] == pytest.approx(1e-9)
    assert float(denoise.regularize_exp(a)[2]) == pytest.approx(
        float(jdenoise.regularize_exp(jnp.asarray(200.0))))
    z = torch.tensor([1.0 + 2.0j], dtype=torch.complex64)
    d = torch.tensor([3.0])
    got = denoise.div_real(z, d)
    assert got.real.item() == np.float32(1.0) / np.float32(3.0)
    assert got.imag.item() == np.float32(2.0) / np.float32(3.0)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("tau_shape", ["scalar", "full"])
@pytest.mark.parametrize("alphabet", ["OOK", "QPSK", "8PSK"])
def test_shrink_with_derivative_matches_jax(alphabet, tau_shape):
    """Posterior mean and its analytic derivative (`shrink.py:98-119`)
    against the JAX package's on shared (r, cov); the mean is the
    Bernoulli mixture's within 1e-3 relative (the same prior; the norm
    there has a zero guard, here 1e-9 added, which moves the norms of
    1e-6 these inputs reach by 1e-3)."""
    cfg = Config(Nt=16, Na=4, Nr=8, Lin=6, Lh=3, mode="random",
                 alphabet=alphabet)
    r, tau = _inputs(cfg.replace(mode="segmented"), 4, 6, tau_shape)
    sym = cfg.symbols
    jm, jd = jdenoise.shrink_with_derivative(
        jnp.asarray(r), jnp.asarray(tau), jnp.asarray(sym), cfg.Ps, cfg.P0)
    tm, td = denoise.shrink_with_derivative(
        torch.as_tensor(r), _t(tau), torch.as_tensor(sym), cfg.Ps, cfg.P0)
    assert tm.dtype == td.dtype == torch.complex64
    _close(tm.numpy(), jm)
    _close(td.numpy(), jd, 1e-4)
    bm, _ = denoise.bernoulli_mixture_posterior(
        torch.as_tensor(r), _t(tau), torch.as_tensor(sym), cfg.Ps, cfg.P0)
    np.testing.assert_allclose(tm.numpy(), bm.numpy(), rtol=1e-3,
                               atol=1e-6)


@pytest.mark.parametrize("tau_shape", ["scalar", "full"])
def test_lasso_matches_jax(tau_shape):
    cfg = Config(Nt=16, Na=4, Nr=8, Lin=6, Lh=3)
    r, tau = _inputs(cfg, 4, 7, tau_shape)
    jF, jG = jdenoise.lasso(jnp.asarray(r), jnp.asarray(tau), 0.7)
    tF, tG = denoise.lasso(torch.as_tensor(r), _t(tau), 0.7)
    # |r| of a complex number rounds by an ulp apart in XLA and PyTorch
    _close(tF.numpy(), jF, 1e-6)
    np.testing.assert_array_equal(tG.numpy(), np.asarray(jG))
    # closed form: G is cov where |r| >= cov and 0 below it
    full = np.broadcast_to(tau, r.shape)
    np.testing.assert_array_equal(tG.numpy(),
                                  np.where(np.abs(r) < full, 0.0, full))


@pytest.mark.parametrize("cov", [0.5, "row"])
def test_shrink_ook_matches_jax_and_the_mixture(cov):
    """The LLR-form OOK posterior against the JAX package's, and its mean
    against the Bernoulli-mixture posterior of OOK
    (tests/test_denoise.py:109-120, within 1e-4)."""
    rng = np.random.default_rng(4)
    Ps, P0 = 0.1, 0.9
    r = (rng.normal(size=(3, 8)) * 0.5 + 0.5).astype(np.complex64)
    if cov == "row":
        cov = rng.uniform(0.2, 0.8, (3, 1)).astype(np.float32)
    jm, jd = jdenoise.shrink_ook(jnp.asarray(r), jnp.asarray(cov), Ps, P0)
    tm, td = denoise.shrink_ook(torch.as_tensor(r), _t(cov), Ps, P0)
    assert tm.dtype == torch.complex64 and td.ndim == 0
    _close(tm.numpy(), jm)
    _close(td.numpy(), jd)
    bm, _ = denoise.bernoulli_mixture_posterior(
        torch.as_tensor(r), _t(cov), torch.tensor([1.0 + 0j]), Ps, P0)
    np.testing.assert_allclose(tm.numpy().real, bm.numpy().real, atol=1e-4)


def test_sw_shrink_ook_matches_jax_and_segment_posterior():
    """The segment-wise OOK softmax against the JAX package's on shared
    (r, cov), and tests/test_denoise.py:123-130's closed form: shapes, the
    mean in [0, 1], the variance mean (1 - mean)."""
    rng = np.random.default_rng(5)
    L, M = 3, 4
    r = rng.normal(size=(2, L * M)).astype(np.complex64)
    for cov in (0.3, rng.uniform(0.1, 0.5, (2, L * M)).astype(np.float32)):
        jm, jv = jdenoise.sw_shrink_ook(jnp.asarray(r), jnp.asarray(cov), L,
                                        M)
        tm, tv = denoise.sw_shrink_ook(torch.as_tensor(r), _t(cov), L, M)
        assert tm.shape == tv.shape == (2, L * M)
        assert tm.dtype == torch.complex64 and tv.dtype == torch.float32
        _close(tm.numpy(), jm)
        _close(tv.numpy(), jv)
        m = tm.numpy().real
        assert np.all((m >= 0) & (m <= 1))
        np.testing.assert_allclose(tv.numpy(), m * (1 - m), atol=1e-7)
