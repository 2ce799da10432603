"""The port's sweep engine: two-phase equals single-phase, one shared
realization gives the JAX package's sums, and the Monte-Carlo statistics
agree with the JAX Simulator's."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu.config import Config as JConfig
from amp_sparc_spatialmodulation_tpu.models import bamp as jbamp
from amp_sparc_spatialmodulation_tpu.models import montecarlo as jmc
from amp_sparc_spatialmodulation_tpu.ops import channel as jchannel
from amp_sparc_spatialmodulation_tpu.ops import message as jmessage
from amp_sparc_spatialmodulation_tpu.ops import operators as joperators
from amp_sparc_spatialmodulation_tpu.utils import metrics as jmetrics
from amp_sparc_spatialmodulation_tpu_torch import cli, interop
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.models import bamp
from amp_sparc_spatialmodulation_tpu_torch.models import montecarlo as mc
from amp_sparc_spatialmodulation_tpu_torch.utils import metrics
from amp_sparc_spatialmodulation_tpu_torch.utils.device import make_generator

# the config of tests/test_two_phase.py, and for SCAMP the one of
# tests/test_pallas_scamp.py:74-76
BASE = dict(Nt=16, Na=4, Nr=10, Lin=6, Lh=3, mode="segmented",
            alphabet="OOK", profile="uniform", trunc="tail", iterations=40)
CONFIGS = {"bamp": BASE,
           "scamp": dict(BASE, mode="sparc", Lin=8, iterations=30)}
CPU = torch.device("cpu")


def _sim(tmp_path, name, algo="bamp", **kw):
    return mc.Simulator(Config(**CONFIGS[algo]), algo=algo,
                        out_root=str(tmp_path / name), device="cpu",
                        progress=lambda s: None, **kw)


@pytest.mark.parametrize("algo,k1,ebn0,res,rel", [
    ("bamp", 4, 6.0, 64, 1e-5), ("bamp", 12, 6.0, 64, 1e-5),
    ("scamp", 6, 8.0, 32, 1e-4)], ids=["4", "12", "scamp-6"])
def test_two_phase_matches_single_phase(tmp_path, algo, k1, ebn0, res, rel):
    """Two-phase sums equal single-phase ones (SCAMP at the tolerance of
    tests/test_pallas_scamp.py:68-84)."""
    a1 = _sim(tmp_path, "a", algo).run_point(ebn0, epochs=4 * res, res=res)
    a2 = _sim(tmp_path, "b", algo, two_phase=k1).run_point(
        ebn0, epochs=4 * res, res=res)
    for k, v in a1.items():
        assert a2[k] == pytest.approx(v, rel=rel, abs=1e-9), k


def test_two_phase_auto_matches_static(tmp_path):
    s_static = _sim(tmp_path, "a", two_phase=12)
    s_auto = _sim(tmp_path, "b", two_phase="auto")
    for i, ebn0 in enumerate([5.0, 7.0]):
        a = s_static.run_point(ebn0, epochs=128, res=64, snr_idx=i)
        b = s_auto.run_point(ebn0, epochs=128, res=64, snr_idx=i)
        for k, v in a.items():
            assert b[k] == pytest.approx(v, rel=1e-5, abs=1e-9), (ebn0, k)
    assert s_auto._last_meanT == pytest.approx(a["T"])


def test_state_take_and_merge_roundtrip():
    for algo in ("bamp", "scamp"):
        cfg = Config(**CONFIGS[algo])
        r = mc.generate_realization(make_generator(CPU, 1), cfg, "sparc",
                                    "banded", 32, 10.0)
        _, st = mc.decode(algo, r, r.y, cfg, iter_cap=3, return_state=True)
        idx = torch.tensor([1, 5, 7])
        sub = mc.state_take_trials(st, idx)
        assert sub.xmap.shape[0] == 3 and sub.t == st.t
        merged = mc.state_merge_trials(st, sub, idx)
        for f in st._fields:
            a, b = getattr(st, f), getattr(merged, f)
            assert (a == b) if f == "t" else torch.equal(a, b), (algo, f)


def test_one_shared_realization_matches_jax():
    """Taps, message and noise drawn by the JAX package and carried over
    through NumPy give the same metric sums in both packages: every
    decision count exactly.  At this geometry a few trials stop one
    float32 rounding away from the stop tolerance, and their T flips by
    one iteration between any two decodes whose sums round differently, as
    it does between the JAX package's own XLA and Pallas decodes of the
    same realization; so the iteration total agrees to 1% and NMSE, which
    those trials move by about their last update, to 1e-4."""
    jcfg, cfg = JConfig(**BASE), Config(**BASE)
    res = 64
    snr = float(10 ** ((8.0 + 10 * np.log10(cfg.code_rate)) / 10))
    k_chan, k_msg, k_noise = jax.random.split(jax.random.PRNGKey(7), 3)
    _, jop = joperators.banded_sparc(k_chan, jcfg)
    msg = jmessage.generate_message(k_msg, jcfg, res)
    jy = jop.apply(msg.x) + jchannel.awgn(k_noise, jcfg, snr, res)
    sigma2 = jcfg.sigma2(snr)
    jout = jbamp.decode(jop, jy, sigma2, jcfg)
    jsums = jmetrics.fetch_sums(jmetrics.evaluate_sums(
        jout.xmap, jout.xmmse, msg, jout.T, jcfg))

    op = interop.operator_from_numpy(np.asarray(jop.h), np.asarray(jop.gains),
                                     cfg.Lin, cfg.Lout, cfg.trunc,
                                     device="cpu")
    tmsg = interop.message_from_numpy(*[np.asarray(v) for v in msg],
                                      device="cpu")
    out = bamp.decode(op, torch.as_tensor(np.array(jy)), sigma2, cfg)
    sums = metrics.fetch_sums(metrics.evaluate_sums(
        out.xmap, out.xmmse, tmsg._replace(x=None), out.T, cfg))
    assert 0 < jsums["fer"] < res
    for k, v in jsums.items():
        if k.startswith("nMSE"):
            assert sums[k] == pytest.approx(v, rel=1e-4), k
        elif k == "T":
            assert sums[k] == pytest.approx(v, rel=1e-2), k
        else:
            assert sums[k] == v, k


def test_run_point_statistics_match_jax(tmp_path):
    """FER and mean T of the port's Simulator within 4 sigma of the JAX
    Simulator's at the same size (independent channel draws)."""
    epochs, res, ebn0 = 512, 128, 6.0
    port = _sim(tmp_path, "t", two_phase=12).run_point(ebn0, epochs=epochs,
                                                       res=res)
    ref = jmc.Simulator(JConfig(**BASE), algo="bamp",
                        out_root=str(tmp_path / "j"), two_phase=12,
                        progress=lambda s: None).run_point(
                            ebn0, epochs=epochs, res=res)
    pa, pb = port["fer"], ref["fer"]
    sd = np.sqrt((pa * (1 - pa) + pb * (1 - pb)) / epochs)
    assert abs(pa - pb) <= 4 * sd + 1.0 / epochs
    # per-trial T spread from one port realization
    cfg = Config(**BASE)
    snr = float(10 ** ((ebn0 + 10 * np.log10(cfg.code_rate)) / 10))
    r = mc.generate_realization(make_generator(CPU, 99), cfg, "sparc",
                                "banded", res, snr)
    T = bamp.decode(r.A, r.y, r.sigma2, cfg).T.float()
    sd_T = float(T.std()) * np.sqrt(2.0 / epochs)
    assert abs(port["T"] - ref["T"]) <= 4 * sd_T
    assert 0.0 < port["fer"] < 1.0 and 1.0 <= port["T"] <= cfg.N_Layers


def test_auto_k1_matches_jax():
    for mean_t in (None, 3.0, 6.1, 10.92, 56.6, 99.0, 500.0):
        for cap in (10, 100):
            assert mc.auto_k1(mean_t, cap) == jmc.auto_k1(mean_t, cap)


def test_simulate_writes_artifacts_stops_and_resumes(tmp_path):
    sim = _sim(tmp_path, "s", two_phase=4)
    out = sim.simulate(epochs=64, start=6.0, final=30.0, step=6.0, res=32)
    grid = sorted(out)
    assert grid[0] == 6.0 and len(grid) < 5        # stopped at FER < 1e-3
    assert out[grid[-1]]["fer"] < 1e-3
    manifest = json.load(open(os.path.join(sim.path, "manifest.json")))
    assert set(manifest["points"]) == {str(e) for e in grid}
    assert manifest["points"]["6.0"]["trials"] == sim.trials_per_point(64, 32)
    with open(os.path.join(sim.path, "6.0.json")) as f:
        point = json.load(f)
    assert list(point)[:2] == ["T", "fer"] and point["EbN0dB"] == 6.0
    again = _sim(tmp_path, "s", two_phase=4)
    resumed = again.simulate(epochs=64, start=6.0, final=30.0, step=6.0,
                             res=32, resume=True)
    for e in grid:
        assert resumed[e]["fer"] == pytest.approx(out[e]["fer"])


@pytest.mark.parametrize("algo", ["vamp", "vamp2"])
def test_other_algorithms_raise(algo):
    """VAMP and vamp2 construct (dense form under 'auto'); the banded form
    and an unknown algorithm raise."""
    sim = mc.Simulator(Config(**BASE), algo=algo, device="cpu")
    assert sim.path.split(os.sep)[-4] == mc.ALGO_DIRS[algo]
    assert mc.resolve_operator_form("sparc", "auto", algo) == "dense"
    with pytest.raises(ValueError, match="dense"):
        mc.Simulator(Config(**BASE), algo=algo, device="cpu",
                     operator_form="banded")
    with pytest.raises(ValueError):
        mc.Simulator(Config(**BASE), algo="nope", device="cpu")


def test_cli_sweep_on_cpu(tmp_path):
    rc = cli.main(["sweep", "--Nt", "16", "--Na", "4", "--Nr", "10",
                   "--Lin", "6", "--Lh", "3", "--iterations", "20",
                   "--epochs", "32", "--res", "32", "--start", "8",
                   "--final", "8", "--two-phase", "4", "--device", "cpu",
                   "--out", str(tmp_path)])
    assert rc == 0
    path = os.path.join(str(tmp_path), "BAMP", Config(
        Nt=16, Na=4, Nr=10, Lin=6, Lh=3, mode="segmented", alphabet="OOK",
        profile="uniform", trunc="tail", iterations=20).name, "8.0.json")
    assert os.path.isfile(path)
