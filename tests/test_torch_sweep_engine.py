"""The sweep engine's ``use_pallas`` knob and the probe of
``two_phase='auto'`` against the JAX package on the CPU.

* ``resolve_use_pallas`` against JAX's as it resolves on a TPU
  (``jax.default_backend`` patched to ``'tpu'``) over a table of
  (algorithm, mode, alphabet, operator form, geometry, batch).  The one
  case of the table where the two differ is named in ``DIFFERENCES``:
  JAX's K5 needs a batch that is a multiple of 8.  Elsewhere the port's
  ``fits`` (shared memory per trial, none for K3 and K4, whose state is in
  device memory) and JAX's (VMEM trial tiles of the batch) agree on this
  table, the massive and VAMPfinal geometries included.  ``'auto'`` is
  exactly where the port's decoders route to a kernel; ``True`` raises
  wherever JAX's ``make_realization_fn`` raises; ``False`` runs the plain
  loops: no wrapper is called, ``plain_decodes`` rises, and the sums are
  the kernels' (their plain versions on the CPU, bit for bit).
* The probe: JAX's ``auto_k1`` cases (``tests/test_two_phase.py:124-134``);
  the auto sweep's sums equal the static sweep's (``:137-156``), with the
  probe and with ``AMP_AUTO_PROBE=0``; the probe decodes ``min(2048,
  res)`` trials at the point's precision (HIGH once ``'auto'`` flips).
  Both avoid faults of JAX's probe (ADVICE.md, ``montecarlo.py:969``): it
  decodes a fixed 2048 trials whatever ``res`` is, and compiles once, at
  the first point's precision, so after ``'auto'`` flips it still probes
  at HIGHEST.  The probe's mean T is within 3 sigma of JAX's
  ``_probe_meanT`` at a small config, sigma from the scatter of the port's
  probe-sized realizations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu.config import Config as JConfig
from amp_sparc_spatialmodulation_tpu.models import montecarlo as jmc
from amp_sparc_spatialmodulation_tpu_torch import cli
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.models import (bamp, scamp, vamp,
                                                          vamp2)
from amp_sparc_spatialmodulation_tpu_torch.models import montecarlo as mc
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
    fused_bamp, fused_scamp, fused_vamp, fused_vamp2)
from amp_sparc_spatialmodulation_tpu_torch.utils.device import make_generator

SMALL = dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, profile="uniform",
             trunc="tail")
MASSIVE = dict(Nt=1344, Na=84, Nr=73, Lin=32, Lh=6, profile="uniform",
               trunc="tail")
# the VAMPfinal family (BASELINE.md:38-48)
VAMPFINAL = dict(Nt=128, Na=16, Nr=32, Lin=25, Lh=6, profile="uniform",
                 trunc="tail")
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


# tests/test_two_phase.py's config
PROBE_CFG = dict(Nt=16, Na=4, Nr=10, Lin=6, Lh=3, mode="segmented",
                 alphabet="OOK", profile="uniform", trunc="tail",
                 iterations=40)

# (algo, mode, alphabet, is_complex, operator form, geometry, batch)
TABLE = [
    (algo, mode, alphabet, True, form, "small", 64)
    for algo in ("bamp", "scamp")
    for mode, alphabet in (("segmented", "OOK"), ("sparc", "OOK"),
                           ("segmented", "QPSK"), ("segmented", "8PSK"),
                           ("random", "QPSK"))
    for form in ("banded", "dense")
] + [
    (algo, mode, alphabet, True, "dense", "small", 64)
    for algo in ("vamp", "vamp2")
    for mode, alphabet in (("segmented", "OOK"), ("sparc", "QPSK"),
                           ("random", "QPSK"))
] + [
    (algo, "segmented", "BPSK", False, form, "small", 64)
    for algo, form in (("bamp", "banded"), ("scamp", "banded"),
                       ("vamp", "dense"))
] + [
    ("bamp", "segmented", "OOK", True, "banded", "massive", 64),
    ("bamp", "segmented", "QPSK", True, "banded", "massive", 64),
    ("bamp", "segmented", "BPSK", True, "banded", "massive", 64),
    ("scamp", "sparc", "OOK", True, "banded", "massive", 64),
    ("bamp", "segmented", "OOK", True, "banded", "massive", 37),
    ("vamp", "segmented", "QPSK", True, "dense", "vampfinal", 4096),
    ("vamp2", "segmented", "QPSK", True, "dense", "vampfinal", 4096),
]
GEOMETRY = {"small": SMALL, "massive": MASSIVE, "vampfinal": VAMPFINAL}
# Where the port's 'auto' resolution differs from JAX's on a TPU, and why:
# (algo, mode, alphabet, form, geometry, batch) -> (port, JAX)
DIFFERENCES = {
    # JAX's K5 takes only batches that are a multiple of 8
    # (TiledBandedIteration.covers); the port's masks the ragged tile
    ("bamp", "segmented", "OOK", "banded", "massive", 37): (True, False),
}


def _ids(case):
    algo, mode, alphabet, cplx, form, geo, batch = case
    return (f"{algo}-{mode}-{alphabet}{'' if cplx else '-real'}-{form}-"
            f"{geo}-{batch}")


def _configs(case):
    algo, mode, alphabet, cplx, form, geo, batch = case
    kw = dict(GEOMETRY[geo], mode=mode, alphabet=alphabet, is_complex=cplx)
    return Config(**kw), JConfig(**kw)


def _port_route(algo, cfg, form):
    """Does the port's decoder take a kernel for ``cfg`` in ``form``?"""
    banded = form == "banded"
    if algo == "bamp":
        return bamp.route_of(cfg, banded) != "plain"
    if algo == "scamp":
        return scamp.kernel_route(cfg, banded)
    return (fused_vamp if algo == "vamp" else fused_vamp2).covers(cfg)


@pytest.mark.parametrize("case", TABLE, ids=[_ids(c) for c in TABLE])
def test_resolve_use_pallas_as_jax_on_tpu(monkeypatch, case):
    algo, mode, alphabet, cplx, form, geo, batch = case
    cfg, jcfg = _configs(case)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    port = mc.resolve_use_pallas("auto", cfg, algo, form, batch)
    want = jmc.resolve_use_pallas("auto", jcfg, algo, form, batch=batch)
    key = (algo, mode, alphabet, form, geo, batch)
    assert (port, want) == DIFFERENCES.get(key, (want, want))
    # 'auto' keeps the decoders' own routes
    assert port == _port_route(algo, cfg, form)
    # False is False everywhere; True raises exactly where JAX's raises
    assert mc.resolve_use_pallas(False, cfg, algo, form, batch) is False
    try:
        jmc.make_realization_fn(jcfg, algo, "sparc", batch,
                                operator_form=form, use_pallas=True)
        jax_raises = False
    except ValueError:
        jax_raises = True
    if jax_raises:
        with pytest.raises(ValueError, match="use_pallas=True"):
            mc.resolve_use_pallas(True, cfg, algo, form, batch)
    else:
        assert mc.resolve_use_pallas(True, cfg, algo, form, batch) is True


def test_resolve_use_pallas_rejects_other_values():
    cfg = Config(**dict(SMALL, mode="segmented", alphabet="OOK"))
    for bad in ("true", None, 2):
        with pytest.raises(ValueError, match="use_pallas"):
            mc.resolve_use_pallas(bad, cfg, "bamp", "banded", 8)
    assert mc.kernel_module("bamp") is fused_bamp
    assert mc.kernel_module("random") is None
    with pytest.raises(ValueError, match="use_pallas=True"):
        mc.resolve_use_pallas(True, cfg, "random", "banded", 8)


# (algo, config overrides, two-phase k1, Eb/N0)
PLAIN_RUNS = [
    ("bamp", dict(mode="segmented", alphabet="OOK", iterations=30), 4, 6.0),
    ("scamp", dict(mode="sparc", alphabet="OOK", iterations=30), 6, 8.0),
    ("vamp", dict(mode="segmented", alphabet="QPSK", iterations=10), None,
     8.0),
    ("vamp2", dict(mode="segmented", alphabet="QPSK", iterations=10), None,
     8.0),
]
WRAPPERS = {"bamp": fused_bamp, "scamp": fused_scamp, "vamp": fused_vamp,
            "vamp2": fused_vamp2}
DECODERS = {"bamp": bamp, "scamp": scamp, "vamp": vamp, "vamp2": vamp2}


@pytest.mark.parametrize("algo,kw,k1,ebn0", PLAIN_RUNS,
                         ids=[r[0] for r in PLAIN_RUNS])
def test_use_pallas_false_runs_the_plain_loops(tmp_path, monkeypatch, algo,
                                               kw, k1, ebn0):
    """``Simulator(use_pallas=False)``: the kernel's wrapper is never
    called, the plain loop runs once per phase of every realization, and
    the sums are those of ``'auto'`` (the wrappers' plain versions on the
    CPU, which are the plain loops at HIGHEST)."""
    cfg = Config(**dict(SMALL, **kw))
    sims = {u: mc.Simulator(cfg, algo=algo, device="cpu", two_phase=k1,
                            use_pallas=u, out_root=str(tmp_path / str(u)),
                            progress=lambda s: None)
            for u in ("auto", False)}
    wrapper = WRAPPERS[algo]
    calls = []
    real = wrapper.whole_decode
    monkeypatch.setattr(wrapper, "whole_decode",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    auto = sims["auto"].run_point(ebn0, epochs=64, res=32)
    assert calls
    calls.clear()
    mod = DECODERS[algo]
    before = (mod.plain_decodes, wrapper.launches)
    plain = sims[False].run_point(ebn0, epochs=64, res=32)
    assert not calls and wrapper.launches == before[1]
    # two realizations, each a plain loop per phase
    assert mod.plain_decodes - before[0] == 2 * (2 if k1 else 1)
    assert plain == auto


def test_use_pallas_true_raises_at_construction(tmp_path):
    kw = dict(device="cpu", use_pallas=True, out_root=str(tmp_path))
    dense = Config(**dict(SMALL, mode="segmented", alphabet="OOK"))
    with pytest.raises(ValueError, match="banded operator form"):
        mc.Simulator(dense, algo="bamp", operator_form="dense", **kw)
    rnd = Config(**dict(SMALL, mode="random", alphabet="QPSK"))
    with pytest.raises(ValueError, match="does not cover"):
        mc.Simulator(rnd, algo="vamp", **kw)
    mc.Simulator(dense, algo="bamp", **kw)
    with pytest.raises(ValueError, match="use_pallas=True"):
        bamp.decode(torch.zeros(8, dense.n, dtype=torch.complex64),
                    torch.zeros(2, dense.n, dtype=torch.complex64), 0.1,
                    dense, use_pallas=True)


def test_cli_use_pallas(tmp_path, monkeypatch):
    args = ["sweep", "--Nt", "16", "--Na", "4", "--Nr", "8", "--Lin", "8",
            "--Lh", "3", "--iterations", "20", "--epochs", "32", "--res",
            "32", "--start", "8", "--final", "8", "--device", "cpu",
            "--out", str(tmp_path)]
    seen = []
    real = mc.Simulator.__init__

    def spy(self, *a, **k):
        seen.append(k["use_pallas"])
        real(self, *a, **k)

    monkeypatch.setattr(mc.Simulator, "__init__", spy)
    for value in ("auto", "true", "false"):
        assert cli.main(args + ["--use-pallas", value]) == 0
    assert seen == ["auto", True, False]
    with pytest.raises(ValueError, match="use_pallas=True"):
        cli.main(args + ["--use-pallas", "true", "--operator", "dense"])
    with pytest.raises(SystemExit):
        cli.main(args + ["--use-pallas", "yes"])


def test_auto_k1_grid_as_jax():
    """tests/test_two_phase.py:124-134, case for case."""
    for mean_t, cap, k1 in ((10.92, 100, 12), (56.6, 100, 64), (6.1, 100, 8),
                            (None, 100, 16), (99.0, 100, 100),
                            (3.0, 100, 4)):
        assert mc.auto_k1(mean_t, cap) == k1 == jmc.auto_k1(mean_t, cap)


def _probe_sim(tmp_path, name, **kw):
    return mc.Simulator(Config(**PROBE_CFG), algo="bamp", device="cpu",
                        out_root=str(tmp_path / name),
                        progress=lambda s: None, **kw)


def test_auto_sweep_sums_equal_static(tmp_path, monkeypatch):
    """tests/test_two_phase.py:137-156: the auto sweep's sums are the
    static sweep's, with the probe and without it (AMP_AUTO_PROBE=0); the
    probe sets k1 from this point's own mean T."""
    static = _probe_sim(tmp_path, "static", two_phase=12)
    auto = _probe_sim(tmp_path, "auto", two_phase="auto")
    off = _probe_sim(tmp_path, "off", two_phase="auto")
    for i, ebn0 in enumerate([5.0, 7.0]):
        a = static.run_point(ebn0, epochs=256, res=64, snr_idx=i)
        last = auto._last_meanT
        b = auto.run_point(ebn0, epochs=256, res=64, snr_idx=i)
        assert auto.probe_meanT is not None
        assert auto.k1 == mc.auto_k1(auto.probe_meanT, 40)
        with monkeypatch.context() as m:
            m.setenv("AMP_AUTO_PROBE", "0")
            c = off.run_point(ebn0, epochs=256, res=64, snr_idx=i)
        assert off.probe_meanT is None
        assert off.k1 == mc.auto_k1(last, 40)
        assert a == b == c, ebn0
    assert auto._last_meanT == a["T"]


def test_probe_size_and_precision(tmp_path, monkeypatch):
    """The probe decodes min(2048, res) trials at the point's precision
    and use_pallas, HIGH once 'auto' flips (JAX's probes 2048 trials at
    the first point's precision)."""
    made = []
    real = mc.make_realization_fn

    def spy(cfg, algo, channel_kind, res, *a, **k):
        made.append((res,) + a)
        return real(cfg, algo, channel_kind, 8, *a, **k)  # record, decode 8

    monkeypatch.setattr(mc, "make_realization_fn", spy)
    sim = _probe_sim(tmp_path, "p", two_phase="auto", precision="auto",
                     use_pallas=False)
    sim.run_point(7.0, epochs=64, res=64)
    assert made == [(64, "auto", False, "highest", False)]
    made.clear()
    sim._last_meanT = 40.0
    sim._probe_meanT(10.0, 0, 4096)
    assert made == [(2048, "auto", False, "high", False)]


def test_probe_meanT_matches_jax(tmp_path):
    """The probe's mean T at 7 dB against JAX's ``_probe_meanT`` (2048
    trials, one realization each): within 3 sigma of the difference of two
    probes, sigma from the scatter of 8 port probe-sized realizations; the
    probe is one realization of the generator (seed, point, 0x9A0BE, 0)."""
    cfg, jcfg = Config(**PROBE_CFG), JConfig(**PROBE_CFG)
    ebn0, n = 7.0, 2048
    snr = float(10 ** ((ebn0 + 10 * np.log10(cfg.code_rate)) / 10))
    sim = _probe_sim(tmp_path, "p", two_phase="auto", seed=3)
    port = sim._probe_meanT(snr, 1, n)
    fn = mc.make_realization_fn(cfg, "bamp", "sparc", n)
    gen = make_generator(torch.device("cpu"), 3, 1, mc.PROBE_ENTROPY, 0)
    from amp_sparc_spatialmodulation_tpu_torch.utils import metrics
    assert port == metrics.finalize(fn(gen, snr), cfg)["T"]
    scatter = [metrics.finalize(fn(make_generator(torch.device("cpu"), 3, 1,
                                                  c), snr), cfg)["T"]
               for c in range(8)]
    js = jmc.Simulator(jcfg, algo="bamp", seed=3, two_phase="auto",
                       out_root=str(tmp_path / "j"))
    base = jax.random.fold_in(jax.random.PRNGKey(3), 1)
    want = float(js._probe_meanT(jnp.asarray(snr, jnp.float32), base))
    sigma = np.sqrt(2.0) * float(np.std(scatter, ddof=1))
    assert abs(port - want) <= 3 * sigma, (port, want, sigma)
