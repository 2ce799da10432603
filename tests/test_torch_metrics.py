"""The port's metrics and artifacts against the JAX package's on shared
decoder outputs and messages."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu.config import Config as JConfig
from amp_sparc_spatialmodulation_tpu.ops import message as jmessage
from amp_sparc_spatialmodulation_tpu.utils import artifacts as jartifacts
from amp_sparc_spatialmodulation_tpu.utils import metrics as jmetrics
from amp_sparc_spatialmodulation_tpu_torch import interop
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.utils import artifacts, metrics

COUNT_KEYS = ("trials", "T", "fer", "ver", "verf", "verm", "verL", "ier",
              "ser", "iber_", "sber_")
NMSE_KEYS = ("nMSE", "nMSEf", "nMSEm", "nMSEL")

CASES = [("segmented", "OOK"), ("segmented", "QPSK"), ("sparc", "8PSK"),
         ("sparc", "16QAM"), ("random", "QPSK"), ("random", "OOK")]


def _case(mode, alphabet, B=24, seed=0):
    base = dict(Nt=16, Na=4, Nr=8, Lin=6, Lh=2, mode=mode, alphabet=alphabet)
    jcfg, cfg = JConfig(**base), Config(**base)
    msg = jmessage.generate_message(jax.random.PRNGKey(seed), jcfg, B)
    rng = np.random.default_rng(seed)
    x = np.asarray(msg.x)
    noise = np.linspace(0.0, 0.5, B)[:, None]   # clean to noisy trials
    xmap = (x + noise * (rng.normal(size=x.shape)
                         + 1j * rng.normal(size=x.shape))).astype(np.complex64)
    xmmse = (x + 0.2 * rng.normal(size=x.shape)).astype(np.complex64)
    T = rng.integers(1, 30, B).astype(np.int32)
    tmsg = interop.message_from_numpy(*[np.asarray(v) for v in msg],
                                      device="cpu")
    return jcfg, cfg, msg, tmsg, xmap, xmmse, T


def _compare(t_sums, j_sums):
    t = metrics.fetch_sums(t_sums)
    j = jmetrics.fetch_sums(j_sums)
    assert set(t) == set(j) == set(metrics.SUM_KEYS)
    for k in COUNT_KEYS:
        assert t[k] == j[k], k
    for k in NMSE_KEYS:
        assert t[k] == pytest.approx(j[k], rel=1e-5), k
    return t


@pytest.mark.parametrize("mode,alphabet", CASES)
def test_evaluate_sums_match_jax(mode, alphabet):
    jcfg, cfg, msg, tmsg, xmap, xmmse, T = _case(mode, alphabet)
    j = jmetrics.evaluate_sums(jnp.asarray(xmap), jnp.asarray(xmmse), msg,
                               jnp.asarray(T), jcfg)
    t = metrics.evaluate_sums(torch.as_tensor(xmap), torch.as_tensor(xmmse),
                              tmsg, torch.as_tensor(T), cfg)
    sums = _compare(t, j)
    assert sums["fer"] > 0
    # a message whose dense x was dropped is rebuilt from its truth
    t2 = metrics.evaluate_sums(torch.as_tensor(xmap), torch.as_tensor(xmmse),
                               tmsg._replace(x=None), torch.as_tensor(T), cfg)
    _compare(t2, j)


@pytest.mark.parametrize("mode,alphabet", CASES)
def test_weighted_sums_match_jax(mode, alphabet):
    jcfg, cfg, msg, tmsg, xmap, xmmse, T = _case(mode, alphabet, seed=3)
    w = (np.arange(xmap.shape[0]) % 3 != 0).astype(np.float32)
    j = jmetrics.evaluate_sums(jnp.asarray(xmap), jnp.asarray(xmmse), msg,
                               jnp.asarray(T), jcfg, weight=jnp.asarray(w))
    t = metrics.evaluate_sums(torch.as_tensor(xmap), torch.as_tensor(xmmse),
                              tmsg, torch.as_tensor(T), cfg,
                              weight=torch.as_tensor(w))
    assert _compare(t, j)["trials"] == float(w.sum())


@pytest.mark.parametrize("mode,alphabet", CASES)
def test_decisions_match_jax(mode, alphabet):
    jcfg, cfg, msg, tmsg, xmap, _, _ = _case(mode, alphabet, seed=4)
    jd = jmetrics.decide(jnp.asarray(xmap), jcfg)
    td = metrics.decide(torch.as_tensor(xmap), cfg)
    for f in ("xhat", "gray", "flat"):
        np.testing.assert_array_equal(getattr(td, f).numpy(),
                                      np.asarray(getattr(jd, f)), err_msg=f)
    jdd = jmetrics.dumb_decision(jnp.asarray(xmap), jcfg)
    tdd = metrics.dumb_decision(torch.as_tensor(xmap), cfg)
    for f in ("xhat", "gray", "flat"):
        np.testing.assert_array_equal(getattr(tdd, f).numpy(),
                                      np.asarray(getattr(jdd, f)), err_msg=f)


def test_perfect_decode_has_no_errors():
    jcfg, cfg, msg, tmsg, xmap, xmmse, T = _case("segmented", "QPSK")
    x = tmsg.x
    sums = metrics.fetch_sums(metrics.evaluate_sums(
        x, x, tmsg, torch.as_tensor(T), cfg))
    for k in ("fer", "ver", "ier", "ser", "iber_", "sber_", "nMSE"):
        assert sums[k] == 0.0, k


def test_accumulate_and_finalize_match_jax():
    jcfg, cfg, msg, tmsg, xmap, xmmse, T = _case("segmented", "QPSK")
    jt = jtot = None
    for s in range(3):
        jcfg, cfg, msg, tmsg, xmap, xmmse, T = _case("segmented", "QPSK",
                                                     seed=s)
        jtot = jmetrics.accumulate(jtot, jmetrics.evaluate_sums(
            jnp.asarray(xmap), jnp.asarray(xmmse), msg, jnp.asarray(T), jcfg))
        jt = metrics.accumulate(jt, metrics.evaluate_sums(
            torch.as_tensor(xmap), torch.as_tensor(xmmse), tmsg,
            torch.as_tensor(T), cfg))
    a, b = metrics.finalize(jt, cfg), jmetrics.finalize(jtot, jcfg)
    assert set(a) == set(b) == {"T", *metrics.METRIC_KEYS}
    for k in b:
        assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-12), k
    # host floats finalize the same way
    assert metrics.finalize(metrics.fetch_sums(jt), cfg) == a


def test_artifact_json_matches_jax(tmp_path):
    jcfg, cfg, msg, tmsg, xmap, xmmse, T = _case("segmented", "OOK")
    avg = metrics.finalize(metrics.evaluate_sums(
        torch.as_tensor(xmap), torch.as_tensor(xmmse), tmsg,
        torch.as_tensor(T), cfg), cfg)
    snr_db = 8.0 + 10 * np.log10(cfg.code_rate)
    pt = artifacts.export_point(str(tmp_path / "t"), 8.0, snr_db, cfg, avg)
    pj = jartifacts.export_point(str(tmp_path / "j"), 8.0, snr_db, jcfg, avg)
    assert os.path.basename(pt) == os.path.basename(pj) == "8.0.json"
    with open(pt) as f:
        t = json.load(f)
    with open(pj) as f:
        j = json.load(f)
    assert list(t) == list(j)
    assert t == j
    artifacts.update_manifest(str(tmp_path / "t"), 8.0, 96, 0)
    jartifacts.update_manifest(str(tmp_path / "j"), 8.0, 96, 0)
    assert artifacts.load_manifest(str(tmp_path / "t")) \
        == jartifacts.load_manifest(str(tmp_path / "j"))
    assert artifacts.load_points(str(tmp_path / "t")) \
        == jartifacts.load_points(str(tmp_path / "j"))
