"""The port's ``models/capacity.py`` against the JAX package's on the CPU.

* the squared singular values of JAX-drawn channels within rtol 1e-4 of
  JAX's ``_gains`` (the Gram on the short side, ``eigvalsh``);
* the device MI function on shared gains within rtol 1e-4 of JAX's
  ``_mi_device_fn`` and 2e-4 of the host routine (the bound of
  ``test_analysis.py::test_capacity_device_mi_matches_host_routine``);
* water-filling and the host MI routine equal JAX's to 1e-12, the CSV
  byte for byte;
* ``simulate``: Cawgn equal to JAX's, Cwf and Mi within 4 sigma of JAX's
  (the two packages' random streams differ: sigma from both packages'
  spread over 4 seeds), and results that do not depend on the chunk.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu.config import Config as JConfig
from amp_sparc_spatialmodulation_tpu.models.capacity import InfoTheory as JIT
from amp_sparc_spatialmodulation_tpu.ops import channel as jchannel
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.models import capacity

BASE = dict(Nt=8, Na=2, Nr=4, Lin=4, Lh=2, mode="segmented",
            alphabet="QPSK", trunc="tail", profile="uniform", iterations=10)
CASES = {"qpsk_tail": {}, "ook": dict(alphabet="OOK"),
         "8psk": dict(alphabet="8PSK"), "tall": dict(Nt=4, Nr=8),
         "cyclic": dict(trunc="cyclic"), "trunc": dict(trunc="trunc"),
         "exponential": dict(profile="exponential", Lh=3)}


def configs(case):
    kw = dict(BASE, **CASES[case])
    return JConfig(**kw), Config(**kw)


def pair(case, root):
    jcfg, cfg = configs(case)
    return (JIT(jcfg, out_root=str(root / "jax")),
            capacity.InfoTheory(cfg, out_root=str(root / "port"),
                                device="cpu"))


def jax_gains(jit, jcfg, n=6, seed=3):
    keys = jax.vmap(lambda e: jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 e))(jnp.arange(n))
    H = np.array(jax.vmap(lambda k: jchannel.generate_channel(k, jcfg))(
        keys))
    return H, np.array(jit._gains(keys))


@pytest.mark.parametrize("case", sorted(CASES))
def test_gains_match_jax(case, tmp_path):
    jit, _ = pair(case, tmp_path)
    H, want = jax_gains(jit, jit.cfg)
    got = capacity.gram_eigvalsh(torch.as_tensor(H))
    assert got.dtype == torch.float32
    assert got.shape == (H.shape[0], min(H.shape[1:]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


@pytest.mark.parametrize("case", ["qpsk_tail", "ook", "8psk", "tall"])
@pytest.mark.parametrize("snr", [0.5, 3.0, 20.0])
def test_device_mi_matches_jax_and_host(case, snr, tmp_path):
    jit, it = pair(case, tmp_path)
    _, g = jax_gains(jit, jit.cfg)
    want = np.array(jit._mi_device_fn(50)(g, jnp.float32(snr)))
    got = capacity.mutual_information(it.cfg, torch.as_tensor(g),
                                      float(np.float32(snr)), 50).numpy()
    host = np.array([it._mutual_information(gi, snr, N=50) for gi in g])
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(got, host, rtol=2e-4)


def test_device_mi_matches_host_routine(tmp_path):
    """The port's twin of ``test_analysis.py::
    test_capacity_device_mi_matches_host_routine``."""
    _, it = pair("qpsk_tail", tmp_path)
    rng = np.random.default_rng(0)
    g = np.sort(rng.gamma(2.0, 1.0, size=12))[::-1].astype(np.float32)
    snr = 10 ** 0.8
    host = it._mutual_information(g, snr, N=50)
    dev = float(capacity.mutual_information(
        it.cfg, torch.as_tensor(g.copy())[None, :], float(np.float32(snr)),
        50)[0])
    np.testing.assert_allclose(dev, host, rtol=2e-4)


@pytest.mark.parametrize("case", ["qpsk_tail", "ook", "tall"])
@pytest.mark.parametrize("sigma2", [0.05, 0.5, 5.0])
def test_water_filling_and_host_mi_match_jax(case, sigma2, tmp_path):
    jit, it = pair(case, tmp_path)
    _, g = jax_gains(jit, jit.cfg, n=2)
    for gi in g:
        gs = np.sort(gi.astype(np.float64))[::-1]
        np.testing.assert_allclose(it._water_filling(gs, sigma2),
                                   jit._water_filling(gs, sigma2),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(
            it._mutual_information(gi, 1 / sigma2, N=30),
            jit._mutual_information(gi, 1 / sigma2, N=30), rtol=1e-12)


def test_csv_is_jax_csv(tmp_path):
    jit, it = pair("qpsk_tail", tmp_path)
    rows = np.array([[2.0, 2.79181246, 1.5369838, 0.0, 8.0386751,
                      5.24246311], [3.0, 3.7918124604762484, 1.76, 0.0,
                                    1 / 3, 2 ** 0.5]])
    jit._export_csv(rows)
    it._export_csv(rows)
    (jname,) = os.listdir(jit.path)
    assert os.listdir(it.path) == [jname]
    assert it.csv_path() == os.path.join(it.path, jname)
    with open(os.path.join(jit.path, jname), "rb") as a, \
            open(it.csv_path(), "rb") as b:
        data = b.read()
        assert data == a.read()
    assert data.startswith(b",EbN0dB,SNRdB,Cawgn,Cfs,Cwf,Mi\n")


SIM = dict(epochs=16, start=2.0, final=4.0, grid_points=40)
SEEDS = range(4)


def test_simulate_matches_jax_within_seed_spread(tmp_path):
    jcfg, cfg = configs("qpsk_tail")
    quiet = dict(progress=lambda s: None)
    J = np.array([JIT(jcfg, out_root=str(tmp_path / "jax"), seed=s)
                  .simulate(**SIM, **quiet) for s in SEEDS])
    P = np.array([capacity.InfoTheory(cfg, out_root=str(tmp_path / "port"),
                                      seed=s, device="cpu")
                  .simulate(**SIM, **quiet) for s in SEEDS])
    assert P.shape == J.shape == (len(SEEDS), 3, 4)
    np.testing.assert_array_equal(P[:, :, 0], J[:, :, 0])      # Cawgn
    np.testing.assert_array_equal(P[:, :, 1], 0.0)             # Cfs
    for k in (2, 3):                                           # Cwf, Mi
        sigma = np.sqrt((J[:, :, k].var(0, ddof=1)
                         + P[:, :, k].var(0, ddof=1)) / len(SEEDS))
        assert np.all(np.abs(P[:, :, k].mean(0) - J[:, :, k].mean(0))
                      <= 4 * sigma), (k, P[:, :, k], J[:, :, k])
    assert np.all(P[:, :, 2] > 0) and np.all(P[:, :, 3] > 0)


def test_simulate_does_not_depend_on_the_chunk(tmp_path, monkeypatch):
    _, cfg = configs("ook")
    it = capacity.InfoTheory(cfg, out_root=str(tmp_path), seed=5,
                             device="cpu")
    assert it.chunk(SIM["epochs"], SIM["grid_points"]) == SIM["epochs"]
    whole = it.simulate(**SIM, progress=lambda s: None)
    monkeypatch.setattr(capacity, "MI_CHUNK_BYTES", 1.0)
    assert it.chunk(SIM["epochs"], SIM["grid_points"]) == 1
    one = it.simulate(**SIM, progress=lambda s: None)
    np.testing.assert_array_equal(one, whole)


def test_simulate_defaults_and_csv(tmp_path):
    """The port's twin of ``test_analysis.py::test_capacity_simulate``, and
    the default grid: from ceil(Shannon limit) to 10 dB above it."""
    _, cfg = configs("qpsk_tail")
    it = capacity.InfoTheory(cfg, out_root=str(tmp_path), device="cpu")
    lines = []
    out = it.simulate(epochs=2, start=2.0, final=3.0, step=1.0,
                      grid_points=40, progress=lines.append)
    assert out.shape == (2, 4) and np.all(out[:, 2] > 0)
    assert len(lines) == 2 and lines[0].startswith("EbN0dB=2.0 Cawgn=")
    csvs = [f for f in os.listdir(it.path) if f.endswith(".csv")]
    assert len(csvs) == 1
    out = it.simulate(epochs=1, grid_points=10, progress=lambda s: None)
    assert out.shape == (11, 4)
    with open(it.csv_path()) as f:
        rows = f.read().splitlines()[1:]
    assert float(rows[0].split(",")[1]) == np.ceil(cfg.shannon_limit_dB)
    np.testing.assert_allclose(out[:, 0], np.log2(1 + 10 ** (
        (np.arange(11) + np.ceil(cfg.shannon_limit_dB)
         + 10 * np.log10(cfg.code_rate)) / 10)), rtol=1e-15)


def test_overridden_host_routine_replaces_the_device_function(tmp_path):
    """An instance-level ``_mutual_information`` takes precedence over the
    batched device function, as in the JAX package."""
    _, cfg = configs("qpsk_tail")
    it = capacity.InfoTheory(cfg, out_root=str(tmp_path), device="cpu")
    seen = []

    def fake(g, snr, N=100):
        seen.append((len(g), N))
        return 42.0

    it._mutual_information = fake
    out = it.simulate(epochs=3, start=2.0, final=2.0, grid_points=20,
                      progress=lambda s: None)
    assert out[0, 3] == 42.0 and seen == [(cfg.n, 20)] * 3
