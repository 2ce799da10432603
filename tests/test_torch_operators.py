"""The port's channel, operator and message modules against the JAX
package's, on shared NumPy inputs; the generators by statistics (JAX draws
from threefry, PyTorch from Philox)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu.config import Config as JConfig
from amp_sparc_spatialmodulation_tpu.ops import channel as jchannel
from amp_sparc_spatialmodulation_tpu.ops import operators as joperators
from amp_sparc_spatialmodulation_tpu_torch import interop
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.ops import channel, message
from amp_sparc_spatialmodulation_tpu_torch.ops import operators
from amp_sparc_spatialmodulation_tpu_torch.utils.device import make_generator

CPU = torch.device("cpu")


def _cfg(trunc="tail", **kw):
    base = dict(Nt=8, Na=2, Nr=4, Lin=6, Lh=3, mode="segmented",
                alphabet="QPSK", profile="exponential", trunc=trunc)
    base.update(kw)
    return Config(**base), JConfig(**base)


def _taps(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.Lh, cfg.Nr, cfg.Nt)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _gains(cfg, seed):
    """Column-dependent gains: every (tap, column block) its own value."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 1.5, (cfg.Lh, cfg.Lin)).astype(np.float32)


def _ops(cfg, jcfg, seed):
    h, g = _taps(cfg, seed), _gains(cfg, seed + 1)
    top = interop.operator_from_numpy(h, g, cfg.Lin, cfg.Lout, cfg.trunc,
                                      device="cpu")
    jop = joperators.BandedOperator(jnp.asarray(h), g, jcfg.Lin, jcfg.Lout,
                                    jcfg.trunc)
    return top, jop


@pytest.mark.parametrize("trunc", ["tail", "trunc", "cyclic"])
def test_banded_maps_match_jax(trunc):
    cfg, jcfg = _cfg(trunc)
    top, jop = _ops(cfg, jcfg, 0)
    rng = np.random.default_rng(2)
    B = 5
    x = (rng.normal(size=(B, cfg.N))
         + 1j * rng.normal(size=(B, cfg.N))).astype(np.complex64)
    r = (rng.normal(size=(B, cfg.n))
         + 1j * rng.normal(size=(B, cfg.n))).astype(np.complex64)
    v = rng.uniform(0, 1, (B, cfg.N)).astype(np.float32)
    w = rng.uniform(0, 1, (B, cfg.n)).astype(np.float32)
    pairs = [(top.apply(torch.as_tensor(x)), jop.apply(jnp.asarray(x))),
             (top.apply_adj(torch.as_tensor(r)), jop.apply_adj(jnp.asarray(r))),
             (top.apply_abs2(torch.as_tensor(v)),
              jop.apply_abs2(jnp.asarray(v))),
             (top.apply_abs2T(torch.as_tensor(w)),
              jop.apply_abs2T(jnp.asarray(w))),
             (top.densify(), jop.densify())]
    for got, want in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert top.shape == tuple(jop.shape)


@pytest.mark.parametrize("trunc", ["tail", "trunc", "cyclic"])
def test_densify_matches_dense_matrices(trunc):
    cfg, jcfg = _cfg(trunc)
    h = _taps(cfg, 3)
    W = channel.base_matrix(cfg)
    got = channel.dense_sparc_from_taps(torch.as_tensor(h), W, cfg).numpy()
    want = np.asarray(jchannel.dense_sparc_from_taps(jnp.asarray(h), W, jcfg))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    op = interop.operator_from_numpy(h, operators.sparc_gains(cfg, W),
                                     cfg.Lin, cfg.Lout, cfg.trunc,
                                     device="cpu")
    np.testing.assert_allclose(op.densify().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    got_t = channel.dense_from_taps(torch.as_tensor(h), cfg).numpy()
    want_t = np.asarray(jchannel.dense_from_taps(jnp.asarray(h), jcfg))
    np.testing.assert_array_equal(got_t, want_t)


@pytest.mark.parametrize("profile", ["uniform", "exponential"])
@pytest.mark.parametrize("trunc", ["tail", "trunc", "cyclic"])
def test_base_matrix_and_gains_exact(profile, trunc):
    cfg, jcfg = _cfg(trunc, profile=profile)
    W = channel.base_matrix(cfg)
    np.testing.assert_array_equal(W, jchannel.base_matrix(jcfg))
    np.testing.assert_array_equal(operators.sparc_gains(cfg, W),
                                  joperators.sparc_gains(jcfg, W))


def test_trunc_with_more_taps_than_blocks():
    """trunc with Lh > Lin: tap 2 places no block.  The JAX banded maps
    index an empty tap there; the port skips it and matches the dense
    SPARC matrix."""
    cfg, jcfg = _cfg("trunc", Nt=8, Lin=2, Lh=3, profile="uniform")
    h = _taps(cfg, 4)
    W = channel.base_matrix(cfg)
    op = interop.operator_from_numpy(h, operators.sparc_gains(cfg, W),
                                     cfg.Lin, cfg.Lout, cfg.trunc,
                                     device="cpu")
    jop = joperators.BandedOperator(jnp.asarray(h),
                                    joperators.sparc_gains(jcfg, W),
                                    jcfg.Lin, jcfg.Lout, jcfg.trunc)
    x = np.random.default_rng(5).normal(size=(3, cfg.N)).astype(np.complex64)
    with pytest.raises(IndexError):
        jop.apply(jnp.asarray(x))
    A = np.asarray(jchannel.dense_sparc_from_taps(jnp.asarray(h), W, jcfg))
    np.testing.assert_allclose(op.densify().numpy(), A, rtol=1e-6, atol=1e-6)
    r = np.random.default_rng(6).normal(size=(3, cfg.n)).astype(np.complex64)
    np.testing.assert_allclose(op.apply(torch.as_tensor(x)).numpy(), x @ A.T,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(op.apply_adj(torch.as_tensor(r)).numpy(),
                               r @ A.conj(), rtol=1e-5, atol=1e-5)
    v = np.abs(x.real)
    np.testing.assert_allclose(op.apply_abs2(torch.as_tensor(v)).numpy(),
                               v @ (np.abs(A) ** 2).T, rtol=1e-5, atol=1e-5)


def test_dense_operator_maps():
    cfg, _ = _cfg("tail")
    A = torch.as_tensor(_taps(cfg, 7)[0])             # any (n, N) matrix
    op = operators.as_operator(A)
    x = torch.randn(3, A.shape[1], dtype=torch.complex64)
    np.testing.assert_allclose(op.apply(x).numpy(), (x @ A.T).numpy(),
                               rtol=1e-6)
    assert operators.as_operator(op) is op


def test_sparc_tap_statistics():
    cfg, _ = _cfg(Nt=32, Nr=16, Lin=8, Na=4)
    h = torch.stack([channel.sample_sparc_taps(make_generator(CPU, i), cfg)
                     for i in range(32)])
    var = float((h.abs() ** 2).mean())
    assert var == pytest.approx(1.0 / (cfg.Na * cfg.Lin), rel=0.03)
    assert abs(float(h.real.mean())) < 0.01 and abs(float(h.imag.mean())) < 0.01
    assert float((h.real ** 2).mean()) == pytest.approx(
        float((h.imag ** 2).mean()), rel=0.05)


@pytest.mark.parametrize("profile", ["uniform", "exponential"])
def test_toeplitz_tap_statistics(profile):
    cfg, _ = _cfg(Nt=32, Nr=16, Lin=8, profile=profile)
    h = torch.stack([channel.sample_taps(make_generator(CPU, i), cfg)
                     for i in range(32)])
    per_tap = (h.abs() ** 2).mean(dim=(0, 2, 3)).numpy()
    want = cfg.pdp * cfg.Lout / cfg.Nr / cfg.Lin
    np.testing.assert_allclose(per_tap, want, rtol=0.05)
    assert channel.dense_from_taps(h[0], cfg).shape == (cfg.n, cfg.N)


def test_toeplitz_column_energy():
    cfg, _ = _cfg(Lin=8, Nr=16, Nt=16)
    e = [float((channel.generate_channel(make_generator(CPU, i), cfg).abs()
                ** 2).sum(dim=0).mean()) for i in range(8)]
    assert np.mean(e) == pytest.approx(cfg.Lout / cfg.Lin, rel=0.05)


def test_sparc_received_power():
    cfg, _ = _cfg(Lin=8, Nr=16, Nt=32, Na=4)
    p = []
    for i in range(8):
        gen = make_generator(CPU, i)
        _, A = channel.generate_as_sparc(gen, cfg)
        msg = message.generate_message(gen, cfg, 16)
        p.append(float(((msg.x @ A.T).abs() ** 2).mean()))
    assert np.mean(p) == pytest.approx(cfg.Na / cfg.Nr, rel=0.1)


def test_awgn_and_iid_variance():
    cfg, _ = _cfg()
    snr = 4.0
    w = channel.awgn(make_generator(CPU, 3), cfg, snr, 512)
    assert w.shape == (512, cfg.n) and w.dtype == torch.complex64
    assert float((w.abs() ** 2).mean()) == pytest.approx(
        cfg.Na / cfg.Nr / snr, rel=0.05)
    H = channel.generate_as_random(make_generator(CPU, 4), cfg)
    assert float((H.abs() ** 2).mean()) == pytest.approx(
        1.0 / (cfg.Lin * cfg.Nr), rel=0.05)


def test_real_channel_mode_is_real():
    cfg, _ = _cfg(alphabet="BPSK", is_complex=False)
    assert channel.sample_sparc_taps(make_generator(CPU, 0), cfg).dtype \
        == torch.float32
    w = channel.awgn(make_generator(CPU, 1), cfg, 2.0, 4096)
    assert float((w ** 2).mean()) == pytest.approx(cfg.Na / cfg.Nr / 2.0,
                                                   rel=0.05)


def test_segmented_message_structure():
    cfg, _ = _cfg(Nt=16, Na=4, Nr=8, Lin=5, Lh=2, trunc="tail")
    msg = message.generate_message(make_generator(CPU, 0), cfg, 7)
    x = msg.x.numpy()
    assert x.shape == (7, cfg.N)
    seg = x.reshape(7, cfg.L, cfg.M)
    assert np.all(np.count_nonzero(seg, axis=-1) == 1)
    ant, sym = msg.ant.numpy(), msg.sym.numpy()
    np.testing.assert_array_equal(
        np.take_along_axis(seg, ant[..., None], -1)[..., 0],
        cfg.symbols[sym])
    np.testing.assert_array_equal(np.sort(msg.flat.numpy().ravel()),
                                  np.flatnonzero(x.ravel()))
    np.testing.assert_array_equal(msg.gray.numpy(), cfg.gray[sym])
    np.testing.assert_array_equal(message.dense_x(msg, cfg).numpy(), x)


def test_random_message_structure():
    cfg, _ = _cfg(Nt=16, Na=3, Nr=8, Lin=5, Lh=2, mode="random",
                  alphabet="8PSK", trunc="trunc")
    msg = message.generate_message(make_generator(CPU, 1), cfg, 6)
    x = msg.x.numpy().reshape(6, cfg.Lin, cfg.Nt)
    assert np.all(np.count_nonzero(x, axis=-1) == cfg.Na)
    ant = msg.ant.numpy()
    assert np.all(np.diff(ant, axis=-1) > 0)
    vals = np.take_along_axis(x, ant, axis=-1)
    assert np.allclose(vals, vals[..., :1])
    np.testing.assert_array_equal(np.sort(msg.flat.numpy().ravel()),
                                  np.flatnonzero(msg.x.numpy().ravel()))
    np.testing.assert_array_equal(message.dense_x(msg, cfg).numpy(),
                                  msg.x.numpy())


@pytest.mark.parametrize("mode", ["segmented", "random"])
def test_message_uniformity(mode):
    cfg, _ = _cfg(Nt=8, Na=2, Nr=4, Lin=2, Lh=1, mode=mode, trunc="trunc")
    msg = message.generate_message(make_generator(CPU, 2), cfg, 4096)
    if mode == "segmented":
        checks = ((msg.ant.numpy().ravel(), cfg.M),
                  (msg.sym.numpy().ravel(), cfg.K))
    else:
        checks = ((msg.ant.numpy().ravel(), cfg.Nt),
                  (msg.sym.numpy().ravel(), cfg.K))
    for arr, card in checks:
        freqs = np.bincount(arr, minlength=card) / arr.size
        assert np.all(np.abs(freqs - 1.0 / card) < 0.02)


def test_generators_are_reproducible():
    cfg, _ = _cfg()
    a = message.generate_message(make_generator(CPU, 0, 1, 2), cfg, 4)
    b = message.generate_message(make_generator(CPU, 0, 1, 2), cfg, 4)
    c = message.generate_message(make_generator(CPU, 0, 1, 3), cfg, 4)
    assert torch.equal(a.x, b.x) and not torch.equal(a.x, c.x)


def test_message_from_numpy_roundtrip():
    cfg, _ = _cfg()
    msg = message.generate_message(make_generator(CPU, 5), cfg, 3)
    back = interop.message_from_numpy(msg.x.numpy(), msg.ant.numpy(),
                                      msg.sym.numpy(), msg.gray.numpy(),
                                      msg.flat.numpy(), device="cpu")
    for f in msg._fields:
        assert torch.equal(getattr(back, f), getattr(msg, f)), f
