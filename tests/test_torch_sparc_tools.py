"""The port's ``models/sparc_tools.py`` against the JAX package's.

Rate math, power allocation and the power-allocated base matrix equal
JAX's exactly.  A trial drawn by JAX (taps, gains, message, y) is carried
across through ``interop`` and decoded by both packages:

* the evaluation of one decoded output (JAX's, carried across) equals
  JAX's: ser, fer, C and rate exactly, nmse to rtol 1e-5;
* the first three iterations of each decoder agree to 1e-4 (the state),
  which holds the plumbing of W, sigma2 and ``estimate_phi``;
* the whole decode gives the same ser and fer on every trial.  Per-trial
  T is not exact: at a batch of one, as at any batch, the two packages'
  CPU products let a trial whose allclose stop is marginal stop an
  iteration apart, and a trial that does not decode (no fixed point) stop
  anywhere (T agreed on 44-83% of the flagship-geometry trials at 6-8 dB,
  power-allocated ones included: tests/torch_analysis_reference.py
  --part parity).  So every trial that decodes in both must stop within
  one iteration of JAX's, with the state within 1e-4 where T agrees.

Geometries: JAX's test geometry (Nt 16, Na 2, Nr 12, Lin 6, Lh 2, QPSK)
and the flagship SPARC geometry (Nt 128, Na 8, Nr 24, Lin 20, Lh 3, OOK,
cap 100), each with and without power allocation.  On the CPU the port
decodes through the kernels' plain versions (``use_pallas='auto'``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu.config import Config as JConfig
from amp_sparc_spatialmodulation_tpu.models import bamp as jbamp
from amp_sparc_spatialmodulation_tpu.models import scamp as jscamp
from amp_sparc_spatialmodulation_tpu.models import sparc_tools as jst
from amp_sparc_spatialmodulation_tpu_torch import interop
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.models import bamp, scamp
from amp_sparc_spatialmodulation_tpu_torch.models import sparc_tools as st
from amp_sparc_spatialmodulation_tpu_torch.ops.message import dense_x

GEOMETRIES = {
    "small": dict(Nt=16, Na=2, Nr=12, Lin=6, Lh=2, mode="sparc",
                  alphabet="QPSK", profile="uniform", trunc="tail",
                  iterations=40),
    "flagship": dict(Nt=128, Na=8, Nr=24, Lin=20, Lh=3, mode="sparc",
                     alphabet="OOK", profile="uniform", trunc="tail",
                     iterations=100),
}
# (Eb/N0 points, seeds) of the whole-decode cases: the small geometry
# across its waterfall, the flagship at its middle (FER 0.19 / 0.31 for
# SCAMP / BAMP at 7 dB, tests/torch_analysis_reference.py)
DRAWS = {"small": ((6.0, 8.0, 14.0), range(6)),
         "flagship": ((7.0,), range(3))}
ALGOS = [("bamp", False), ("scamp", False), ("scamp", True)]


def configs(name):
    return JConfig(**GEOMETRIES[name]), Config(**GEOMETRIES[name])


def power_allocation(cfg, ebn0, on):
    if not on:
        return None
    rate = jst.segmented_sparc_rate_nats(cfg.Nt, cfg.Na, cfg.Nr, cfg.Lin,
                                         cfg.Lh, cfg.K)
    return jst.exp_power_allocation(
        10 ** ((ebn0 + 10 * np.log10(rate)) / 10), cfg.Lin)


def shared_trial(name, ebn0, pa_on, seed):
    """A trial drawn by the JAX package and the same trial as the port's
    :class:`sparc_tools.Trial` on the CPU: (JAX config, JAX draw, port
    config, port trial)."""
    jcfg, cfg = configs(name)
    pa = power_allocation(jcfg, ebn0, pa_on)
    draw = jst._build_trial(jcfg, ebn0, pa, seed)
    W, jop, msg, y, sigma2, snr, rate = draw
    op = interop.operator_from_numpy(np.array(jop.h), np.array(jop.gains),
                                     cfg.Lin, cfg.Lout, cfg.trunc,
                                     device="cpu")
    m = interop.message_from_numpy(np.array(msg.x), np.array(msg.ant),
                                   np.array(msg.sym), np.array(msg.gray),
                                   np.array(msg.flat), device="cpu")
    trial = st.Trial(W=np.array(W), op=op, msg=m,
                     y=torch.as_tensor(np.array(y)), sigma2=sigma2, snr=snr,
                     rate=rate)
    return jcfg, draw, cfg, trial


def jax_decode(algo, estimate_phi, draw, jcfg, **kw):
    W, jop, _, y, sigma2, _, _ = draw
    if algo == "bamp":
        return jbamp.decode(jop, y, sigma2, jcfg, **kw)
    return jscamp.decode(jnp.asarray(W), jop, y, sigma2, jcfg,
                         estimate_phi=estimate_phi, **kw)


@pytest.mark.parametrize("args", [(128, 4, 20, 3, 32), (16, 1, 6, 2, 12),
                                  (64, 8, 32, 6, 24), (480, 8, 32, 6, 57)])
def test_rate_math_matches_jax(args):
    Nt, K, Lt, Lh, Nr = args
    assert st.sparc_rate_nats(Nt, K, Lt, Lh, Nr) == \
        jst.sparc_rate_nats(Nt, K, Lt, Lh, Nr)
    Na = 8
    r = st.segmented_sparc_rate_nats(Nt, Na, Nr, Lt, Lh, K)
    assert r == jst.segmented_sparc_rate_nats(Nt, Na, Nr, Lt, Lh, K)
    assert st.ebn0_min_db(r) == jst.ebn0_min_db(r)
    assert st.ebn0_min_db(1.0) == pytest.approx(0.0)


@pytest.mark.parametrize("snr,Lt,f,a", [(10.0, 16, None, None),
                                        (3.5, 20, None, None),
                                        (10.0, 16, 0.5, 1.0),
                                        (50.0, 32, 0.25, 0.7)])
def test_exp_power_allocation_matches_jax(snr, Lt, f, a):
    got = st.exp_power_allocation(snr, Lt, f, a)
    np.testing.assert_array_equal(got, jst.exp_power_allocation(snr, Lt, f,
                                                                a))
    assert got.shape == (Lt,) and got[0] == pytest.approx(1.0)
    assert np.all(np.diff(got) <= 0)


@pytest.mark.parametrize("f,a", [(2.0, 1.0), (0.5, None), (None, 1.0)])
def test_exp_power_allocation_rejects_what_jax_rejects(f, a):
    for mod in (st, jst):
        with pytest.raises(ValueError):
            mod.exp_power_allocation(10.0, 16, f, a)


@pytest.mark.parametrize("profile", ["uniform", "exponential"])
@pytest.mark.parametrize("pa_on", [False, True])
def test_base_matrix_pa_matches_jax(profile, pa_on):
    cfg = Config(Nt=16, Na=2, Nr=12, Lin=8, Lh=3, mode="sparc",
                 alphabet="QPSK", profile=profile, trunc="tail")
    pa = st.exp_power_allocation(5.0, 8) if pa_on else None
    W = st.base_matrix_pa(8, 3, cfg.pdp, pa)
    np.testing.assert_array_equal(W, jst.base_matrix_pa(8, 3, cfg.pdp, pa))
    # the decoders' normalization of _build_trial (`sparc_tools.py:114-116`
    # there): mean Na/Nr in float32
    Wt = st._build_trial(cfg, 8.0, pa, 0, "cpu").W
    Wj = jst.base_matrix_pa(cfg.Lin, cfg.Lh, cfg.pdp, pa)
    np.testing.assert_array_equal(
        Wt, (Wj / Wj.mean() * cfg.Na / cfg.Nr).astype(np.float32))
    assert Wt.dtype == np.float32


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
@pytest.mark.parametrize("pa_on", [False, True])
def test_carried_trial_is_jax_trial(name, pa_on):
    """The carried operator maps the message to JAX's noiseless y, and the
    port's own draw builds its operator from the same base matrix."""
    jcfg, draw, cfg, trial = shared_trial(name, 8.0, pa_on, 0)
    W, jop, msg, *_ = draw
    np.testing.assert_allclose(
        trial.op.apply(dense_x(trial.msg, cfg)).numpy(),
        np.asarray(jop.apply(msg.x)), atol=1e-5)
    own = st._build_trial(cfg, 8.0, power_allocation(jcfg, 8.0, pa_on), 0,
                          "cpu")
    np.testing.assert_array_equal(own.W, np.asarray(W))
    np.testing.assert_array_equal(
        own.op.gains.numpy(), np.asarray(jop.gains))
    assert own.y.shape == (1, cfg.n) and own.y.dtype == torch.complex64
    assert (own.rate, own.snr, own.sigma2) == (trial.rate, trial.snr,
                                               trial.sigma2)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
@pytest.mark.parametrize("algo,estimate_phi", ALGOS)
def test_eval_trial_matches_jax(name, algo, estimate_phi):
    """JAX's decoded output of a shared trial scored by both packages."""
    jcfg, draw, cfg, trial = shared_trial(name, 7.0, True, 1)
    out = jax_decode(algo, estimate_phi, draw, jcfg)
    want = jst._eval_trial(out, draw[2], jcfg, draw[5], draw[6])
    carried = bamp.DecodeResult(
        xmap=torch.as_tensor(np.array(out.xmap)),
        xmmse=torch.as_tensor(np.array(out.xmmse)),
        var=torch.as_tensor(np.array(out.var)),
        T=torch.as_tensor(np.array(out.T)))
    got = st._eval_trial(carried, trial.msg, cfg, trial.snr, trial.rate)
    assert (got.ser, got.fer, got.C, got.rate) == (want.ser, want.fer,
                                                   want.C, want.rate)
    np.testing.assert_allclose(got.nmse, want.nmse, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
@pytest.mark.parametrize("algo,estimate_phi", ALGOS)
def test_first_iterations_match_jax(name, algo, estimate_phi):
    """Three iterations of each decoder on a power-allocated trial, state
    within 1e-4: the port decodes what JAX decodes."""
    jcfg, draw, cfg, trial = shared_trial(name, 7.0, True, 2)
    _, js = jax_decode(algo, estimate_phi, draw, jcfg, iter_cap=3,
                       return_state=True)
    if algo == "bamp":
        _, ps = bamp.decode(trial.op, trial.y, trial.sigma2, cfg,
                            iter_cap=3, return_state=True)
        fields = ("xmap", "xmmse", "var", "z")
    else:
        _, ps = scamp.decode(trial.W, trial.op, trial.y, trial.sigma2, cfg,
                             estimate_phi=estimate_phi, iter_cap=3,
                             return_state=True)
        fields = ("xmap", "xmmse", "psi", "phi", "z")
    for f in fields:
        d = np.abs(getattr(ps, f).numpy() - np.asarray(getattr(js, f)))
        assert float(d.max()) < 1e-4, f


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
@pytest.mark.parametrize("pa_on", [False, True])
@pytest.mark.parametrize("algo,estimate_phi", ALGOS)
def test_single_trial_decode_matches_jax(name, pa_on, algo, estimate_phi):
    """The whole single-trial decode and evaluation on shared trials (module
    docstring): ser and fer on every trial; a trial decoded by both within
    one iteration of JAX's T, its state within 1e-4 where T agrees."""
    ebn0s, seeds = DRAWS[name]
    for ebn0 in ebn0s:
        for seed in seeds:
            jcfg, draw, cfg, trial = shared_trial(name, ebn0, pa_on, seed)
            jout = jax_decode(algo, estimate_phi, draw, jcfg)
            want = jst._eval_trial(jout, draw[2], jcfg, draw[5], draw[6])
            pout = st._decode(algo, trial, cfg, estimate_phi)
            got = st._eval_trial(pout, trial.msg, cfg, trial.snr,
                                 trial.rate)
            assert (got.ser, got.fer, got.C, got.rate) == \
                (want.ser, want.fer, want.C, want.rate), (ebn0, seed)
            if got.fer:
                continue
            jT, pT = int(np.asarray(jout.T)[0]), int(pout.T[0])
            assert abs(pT - jT) <= 1, (ebn0, seed, jT, pT)
            if jT == pT:
                for f in ("xmap", "xmmse"):
                    d = np.abs(getattr(pout, f).numpy()
                               - np.asarray(getattr(jout, f)))
                    assert float(d.max()) < 1e-4, (f, ebn0, seed)


@pytest.mark.parametrize("pa_on,estimate_phi", [(False, False),
                                                (True, False),
                                                (False, True)])
def test_compare_single_trial_equals_solo_runs(pa_on, estimate_phi):
    """Head-to-head on ONE shared draw (`sparc.py:453-474`) equals the
    per-algorithm runs with the same seed, on the port's own draws."""
    _, cfg = configs("small")
    pa = power_allocation(cfg, 10.0, pa_on)
    both = st.compare_single_trial(cfg, 10.0, power_allocation=pa,
                                   estimate_phi=estimate_phi, seed=3,
                                   device="cpu")
    assert list(both) == ["scamp", "bamp"]
    for algo in ("scamp", "bamp"):
        solo = st.run_single_trial(cfg, 10.0, algo=algo,
                                   power_allocation=pa,
                                   estimate_phi=estimate_phi, seed=3,
                                   device="cpu")
        assert both[algo] == solo
        assert isinstance(solo, st.SingleTrialResult)


def test_draws_depend_on_the_seed_alone():
    _, cfg = configs("small")
    a = st._build_trial(cfg, 9.0, None, 5, "cpu")
    b = st._build_trial(cfg, 9.0, None, 5, "cpu")
    c = st._build_trial(cfg, 9.0, None, 6, "cpu")
    assert torch.equal(a.y, b.y) and torch.equal(a.op.h, b.op.h)
    assert not torch.equal(a.y, c.y)
    np.testing.assert_allclose(a.W.mean(), cfg.Na / cfg.Nr, rtol=1e-6)


def test_run_single_trial_high_snr_decodes():
    """The port's twin of ``test_sparc_tools.py::
    test_run_single_trial_high_snr_decodes`` and its power-allocated
    case."""
    _, cfg = configs("small")
    res = st.run_single_trial(cfg, 14.0, algo="bamp", seed=1, device="cpu")
    assert res.fer in (0.0, 1.0) and res.nmse < 0.5
    res2 = st.run_single_trial(cfg, 14.0, algo="scamp", estimate_phi=True,
                               seed=1, device="cpu")
    assert 0.0 <= res2.ser <= 1.0
    ook = Config(**dict(GEOMETRIES["small"], alphabet="OOK"))
    pa = st.exp_power_allocation(8.0, Lt=ook.Lin)
    res3 = st.run_single_trial(ook, 12.0, algo="scamp", power_allocation=pa,
                               seed=2, device="cpu")
    assert np.isfinite(res3.nmse)
    with pytest.raises(ValueError, match="unknown algo"):
        st.run_single_trial(cfg, 14.0, algo="vamp", device="cpu")
