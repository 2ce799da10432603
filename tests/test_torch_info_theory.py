"""The port's ``utils/info_theory.py`` against the JAX package's on shared
NumPy inputs: every function equal to rtol 1e-12 (both run float64 NumPy
on the host), the real-alphabet ``mi_awgn2`` case of
``tests/test_analysis.py`` and the closed forms of that file included."""
import numpy as np
import pytest

from amp_sparc_spatialmodulation_tpu.utils import info_theory as jit_
from amp_sparc_spatialmodulation_tpu_torch.utils import info_theory as it

RTOL = 1e-12

QPSK = np.array([1 + 1j, -1 + 1j, -1 - 1j, 1 - 1j]) / np.sqrt(2)
ALPHABETS = {
    "bpsk": (np.array([-1.0, 1.0]), np.array([0.5, 0.5])),
    "ask4": (np.array([-3.0, -1.0, 1.0, 3.0]), np.full(4, 0.25)),
    "qpsk": (QPSK, np.full(4, 0.25)),
    "ook_sparse": (np.array([1.0 + 0j, 0.0 + 0j]), np.array([0.1, 0.9])),
}


def _dmc(seed, n_in, n_out):
    rng = np.random.default_rng(seed)
    pmf_y_x = rng.random((n_out, n_in))
    pmf_y_x[rng.random((n_out, n_in)) < 0.2] = 0.0
    pmf_y_x += 1e-3 * (pmf_y_x.sum(0, keepdims=True) == 0)
    pmf_y_x /= pmf_y_x.sum(0, keepdims=True)
    pmf_x = rng.random(n_in)
    return pmf_x / pmf_x.sum(), pmf_y_x


@pytest.mark.parametrize("seed,n_in,n_out", [(0, 2, 2), (1, 3, 5),
                                             (2, 8, 4)])
def test_mi_dmc_matches_jax(seed, n_in, n_out):
    pmf_x, pmf_y_x = _dmc(seed, n_in, n_out)
    np.testing.assert_allclose(it.mi_dmc(pmf_x, pmf_y_x),
                               jit_.mi_dmc(pmf_x, pmf_y_x), rtol=RTOL)


def test_mi_dmc_bsc_closed_form():
    p = 0.11
    pmf_y_x = np.array([[1 - p, p], [p, 1 - p]])
    h2 = -p * np.log2(p) - (1 - p) * np.log2(1 - p)
    assert it.mi_dmc(np.array([0.5, 0.5]), pmf_y_x) == pytest.approx(
        1 - h2, rel=1e-6)


@pytest.mark.parametrize("name", sorted(ALPHABETS))
@pytest.mark.parametrize("N", [50, 201])
def test_integration_grid_and_mi_single_match_jax(name, N):
    x, pmf = ALPHABETS[name]
    np.testing.assert_allclose(it._integration_grid(x, 0.7, N),
                               jit_._integration_grid(x, 0.7, N), rtol=RTOL)
    for s2, gain in ((0.3, 1.0), (2.0, 0.5)):
        np.testing.assert_allclose(it._mi_single(x, pmf, s2, N, gain),
                                   jit_._mi_single(x, pmf, s2, N, gain),
                                   rtol=RTOL)


@pytest.mark.parametrize("name", sorted(ALPHABETS))
def test_mi_awgn_matches_jax(name):
    x, pmf = ALPHABETS[name]
    snr = np.array([-10.0, 0.0, 6.0, 15.0])
    np.testing.assert_allclose(it.mi_awgn(x, pmf, snrdB=snr, N=120),
                               jit_.mi_awgn(x, pmf, snrdB=snr, N=120),
                               rtol=RTOL)
    var = np.array([0.05, 0.5, 3.0])
    np.testing.assert_allclose(it.mi_awgn(x, pmf, noise_var=var, N=80),
                               jit_.mi_awgn(x, pmf, noise_var=var, N=80),
                               rtol=RTOL)


def test_mi_awgn_needs_snr_or_variance():
    x, pmf = ALPHABETS["bpsk"]
    for mod in (it, jit_):
        with pytest.raises(ValueError):
            mod.mi_awgn(x, pmf)


def test_mi_awgn_limits():
    x, pmf = ALPHABETS["bpsk"]
    hi = it.mi_awgn(x, pmf, snrdB=np.array([15.0]), N=400)
    lo = it.mi_awgn(x, pmf, snrdB=np.array([-25.0]), N=400)
    assert hi[0] == pytest.approx(1.0, abs=0.02)
    assert lo[0] == pytest.approx(0.0, abs=0.02)


def test_mi_awgn2_real_alphabet_matches_jax():
    """The real-alphabet case of
    ``test_analysis.py::test_mi_awgn2_matches_reference_routine_real_
    alphabet``: the sigma^2 doubling lives there."""
    x = np.array([-3.0, -1.0, 1.0, 3.0])
    pmf_x = np.full(4, 0.25)
    noise_var = np.array([0.1, 0.5, 2.0])
    np.testing.assert_allclose(it.mi_awgn2(x, pmf_x, noise_var, N=801),
                               jit_.mi_awgn2(x, pmf_x, noise_var, N=801),
                               rtol=RTOL)
    xc = np.array([1 + 0j, -1 + 0j, 1j, -1j])
    np.testing.assert_allclose(it.mi_awgn2(xc, pmf_x, np.array([0.5]), N=81),
                               jit_.mi_awgn2(xc, pmf_x, np.array([0.5]),
                                             N=81), rtol=RTOL)
    # doubled variance for the real alphabet: not the complex embedding's
    assert not np.allclose(it.mi_awgn2(x, pmf_x, noise_var, N=801),
                           it.mi_awgn2(x.astype(complex), pmf_x, noise_var,
                                       N=801))


@pytest.mark.parametrize("mode,inputs", [("MI", [0.0, 0.5, 4.0, 9.0, 30.0]),
                                         ("VAR", [0.05, 0.3, 0.6, 0.9])])
def test_calc_mi_matches_jax(mode, inputs):
    np.testing.assert_allclose(it.calc_mi(inputs, mode),
                               jit_.calc_mi(inputs, mode), rtol=RTOL)


def test_calc_mi_roundtrip_and_mode_check():
    var = np.array([4.0, 9.0])
    mi = it.calc_mi(var, "MI")
    assert np.all((mi > 0) & (mi < 1))
    np.testing.assert_allclose(it.calc_mi(mi, "VAR"), var, rtol=0.3)
    with pytest.raises(ValueError):
        it.calc_mi(var, "X")
