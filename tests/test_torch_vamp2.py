"""The port's vamp2 (damped Rangan VAMP) decoder and the plain version of its
whole-decode kernel (``ops/kernels/fused_vamp2.py::decode_plain``) against
the JAX package's vamp2 on shared inputs: its XLA decode and its Pallas
whole-decode kernel run in interpret mode on the CPU (``use_pallas=True``),
on the geometries of ``tests/test_pallas_vamp2.py``.

Both packages get the same direct-SVD factors ``(U, s, Vh)`` (singular
vectors are defined only up to a phase each), drawn by the JAX package and
carried over through NumPy.  Tolerances are those of the JAX package's own
kernel-against-XLA test (``tests/test_pallas_vamp2.py:27-39``): T
identical, ``xmmse`` and ``var`` within 1e-3, and the pseudo-data ``r``
within 5e-2, because ``r_tilde`` divides by ``1 - alpha``, which amplifies
float32 summation-order noise.  The CUDA kernel itself is checked against
this plain version on the card by ``chip_smoke.py``."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu.config import Config as JConfig
from amp_sparc_spatialmodulation_tpu.models import vamp2 as jvamp2
from amp_sparc_spatialmodulation_tpu_torch import cli, interop
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.models import montecarlo as mc
from amp_sparc_spatialmodulation_tpu_torch.models import vamp, vamp2
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_vamp2
from test_torch_vamp import SMALL, assert_same_decode, shared_inputs

# (name, config overrides, SNR exponent): tests/test_pallas_vamp2.py:27,
# plus 8PSK and the random mode (Bernoulli-mixture denoiser, no kernel)
GEOMETRIES = [
    ("ook", dict(iterations=12), 1.5),
    ("qpsk", dict(alphabet="QPSK", iterations=12), 1.9),
    ("8psk", dict(alphabet="8PSK", iterations=12), 2.0),
    ("random_qpsk", dict(alphabet="QPSK", mode="random", iterations=12),
     1.9),
]


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("name,kw,snr_exp", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_plain_matches_jax(name, kw, snr_exp, use_pallas):
    cfg, dec, y, s2, jcfg, jdec, jy = shared_inputs(kw, snr_exp)
    if cfg.mode == "random":
        assert not fused_vamp2.covers(cfg)
        if use_pallas:
            with pytest.raises(ValueError):
                jvamp2.decode(jdec, jy, s2, jcfg, use_pallas=True)
            return
    ref = jvamp2.decode(jdec, jy, s2, jcfg, use_pallas=use_pallas)
    assert_same_decode(vamp2.decode(dec, y, s2, cfg), ref)


def test_split_and_resume_matches_unsplit():
    """Split at iter_cap=4 and resume: the unsplit trajectory, in the port
    and against the JAX kernel's resumed run
    (tests/test_pallas_vamp2.py:42-52)."""
    cfg, dec, y, s2, jcfg, jdec, jy = shared_inputs(dict(iterations=10), 1.5)
    _, full = vamp2.decode(dec, y, s2, cfg, return_state=True)
    _, part = vamp2.decode(dec, y, s2, cfg, iter_cap=4, return_state=True)
    assert part.t == 4 and bool(part.active.any())
    _, resumed = vamp2.decode(dec, y, s2, cfg, state0=part,
                              return_state=True)
    assert torch.equal(full.T, resumed.T) and resumed.t == full.t
    for f in ("r", "gamma", "xmmse", "var"):
        assert float((getattr(full, f) - getattr(resumed, f)).abs().max()) \
            < 1e-6, f
    _, jst = jvamp2.decode(jdec, jy, s2, jcfg, use_pallas=True, iter_cap=4,
                           return_state=True)
    jres = jvamp2.decode(jdec, jy, s2, jcfg, use_pallas=True, state0=jst)
    assert_same_decode(vamp.DecodeResult(resumed.r, resumed.xmmse,
                                         resumed.var, resumed.T), jres)


def test_resume_state_from_jax():
    """A JAX VAMP2State carried over through NumPy resumes in the port to
    the JAX decode's final state; the round trip keeps every field."""
    cfg, dec, y, s2, jcfg, jdec, jy = shared_inputs(
        dict(alphabet="QPSK", iterations=12), 1.9)
    _, jst = jvamp2.decode(jdec, jy, s2, jcfg, iter_cap=3, return_state=True)
    s0 = interop.vamp2_state_from_numpy(*[np.asarray(v) for v in jst],
                                        device="cpu")
    assert s0.t == 3 and s0.gamma.shape == (8, 1)
    back = interop.state_to_numpy(s0)
    for f in jst._fields:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jst, f)))
    _, port = vamp2.decode(dec, y, s2, cfg, state0=s0, return_state=True)
    _, ref = jvamp2.decode(jdec, jy, s2, jcfg, state0=jst, return_state=True)
    assert port.t == int(ref.t)
    np.testing.assert_array_equal(port.T.numpy(), np.asarray(ref.T))
    for f in ("xmmse", "var"):
        d = np.abs(getattr(port, f).numpy() - np.asarray(getattr(ref, f)))
        assert float(d.max()) < 1e-3, f
    np.testing.assert_allclose(port.gamma.numpy(), np.asarray(ref.gamma),
                               rtol=1e-3)


def test_main_path_geometry_matches_xla():
    """The main path's geometry (N = 2560, p = 528, OOK, segmented) at
    Eb/N0 = 8 dB and its cap of 10, 128 shared trials: T identical on >= 95%
    of the trials and |d mean T| <= 0.1 (the bounds of the SCAMP
    main-geometry test).  Every trial runs to the cap here, where vamp2
    does not decode, so only T is held; the states are compared on the
    small geometries and on the card."""
    b = dict(Nt=128, Na=8, Nr=24, Lin=20, Lh=3, mode="segmented",
             alphabet="OOK", profile="uniform", trunc="tail", iterations=10)
    snr_exp = (8.0 + 10 * np.log10(Config(**b).code_rate)) / 10
    cfg, dec, y, s2, jcfg, jdec, jy = shared_inputs({}, snr_exp, batch=128,
                                                    base=b, svd_by="port")
    jT = np.asarray(jvamp2.decode(jdec, jy, s2, jcfg).T)
    pT = vamp2.decode(dec, y, s2, cfg).T.numpy()
    assert (jT == pT).mean() >= 0.95
    assert abs(pT.mean() - jT.mean()) <= 0.1


def test_wrapper_runs_plain_on_cpu_and_counts():
    """On CPU tensors the wrapper is its plain version and launches
    nothing; the global counter follows vamp2.py:67-68; a tensor on
    another device raises."""
    cfg, dec, y, s2, *_ = shared_inputs(dict(iterations=12), 1.5)
    yt, sq = vamp2.whiten(dec, y), dec.s ** 2
    s0 = vamp2.initial_state(y, cfg)
    before, plain = fused_vamp2.launches, vamp2.plain_decodes
    done = fused_vamp2.whole_decode(dec.Vh, sq, yt, s0, s2, 12, cfg)
    want = vamp2.plain_loop(dec.Vh, sq, yt, s0, s2, 12, cfg)
    assert fused_vamp2.launches == before
    assert vamp2.plain_decodes == plain + 2
    for f in vamp2.VAMP2State._fields:
        a, b = getattr(done, f), getattr(want, f)
        assert (a == b) if f == "t" else torch.equal(a, b), f
    capped = fused_vamp2.whole_decode(dec.Vh, sq, yt, s0, s2, 2, cfg)
    assert bool(capped.active.any()) and capped.t == 2
    assert torch.equal(capped.xmap, capped.r)
    assert torch.equal(capped.gamma, vamp2.decode(
        dec, y, s2, cfg, iter_cap=2, return_state=True)[1].gamma)
    with pytest.raises(ValueError):
        fused_vamp2.whole_decode(dec.Vh, sq, yt.to("meta"), s0, s2, 12, cfg)


def test_coverage_rule_matches_jax():
    """covers equals the JAX FusedVamp2Decode.covers rule on the presets
    and the alphabet configs."""
    from amp_sparc_spatialmodulation_tpu import config as jconfig
    from amp_sparc_spatialmodulation_tpu.ops.pallas.fused_vamp2 import (
        FusedVamp2Decode)
    from amp_sparc_spatialmodulation_tpu_torch import config as tconfig
    for kw in (dict(mode="segmented", alphabet="OOK"),
               dict(mode="segmented", alphabet="QPSK"),
               dict(mode="sparc", alphabet="8PSK"),
               dict(mode="random", alphabet="QPSK"),
               dict(mode="segmented", alphabet="BPSK", is_complex=False)):
        b = dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, **kw)
        assert fused_vamp2.covers(Config(**b)) \
            == FusedVamp2Decode.covers(JConfig(**b)), kw
    for name in ("flagship_bamp_ook", "flagship_scamp", "massive_mimo"):
        assert fused_vamp2.covers(getattr(tconfig, name)()) \
            == FusedVamp2Decode.covers(getattr(jconfig, name)()), name


def test_sweep_takes_the_direct_svd():
    """The sweep gives vamp2 the direct SVD whatever 'auto' picks, VAMP
    the 'auto' one; other decoders get none."""
    cfg = Config(**SMALL)
    r = mc.generate_realization(mc.make_generator(torch.device("cpu"), 1),
                                cfg, "sparc", "dense", 4, 10 ** 1.5)
    direct = vamp.svd(r.A, method="direct")
    for algo in ("vamp", "vamp2"):
        dec = mc.with_svd(algo, r).dec
        assert torch.equal(dec.s, direct.s) and torch.equal(dec.Vh, direct.Vh)
    assert mc.with_svd("bamp", r).dec is None


def test_two_phase_matches_single_phase(tmp_path):
    """Two-phase sums equal single-phase ones: the SVD is shared by both
    phases and decoding is per trial."""
    cfg = Config(**dict(SMALL, iterations=15))
    kw = dict(algo="vamp2", device="cpu", progress=lambda s: None)
    a1 = mc.Simulator(cfg, out_root=str(tmp_path / "a"), **kw).run_point(
        8.0, epochs=64, res=32)
    a2 = mc.Simulator(cfg, out_root=str(tmp_path / "b"), two_phase=4,
                      **kw).run_point(8.0, epochs=64, res=32)
    assert 1.0 <= a1["T"] <= 15.0
    for k, v in a1.items():
        assert a2[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k


def test_cli_sweep_vamp2_on_cpu(tmp_path):
    rc = cli.main(["sweep", "--algo", "vamp2", "--Nt", "16", "--Na", "4",
                   "--Nr", "10", "--Lin", "8", "--Lh", "3", "--iterations",
                   "10", "--epochs", "32", "--res", "32", "--start", "8",
                   "--final", "8", "--device", "cpu", "--out",
                   str(tmp_path)])
    assert rc == 0
    path = os.path.join(str(tmp_path), "VAMP2", Config(**SMALL).name,
                        "8.0.json")
    with open(path) as f:
        point = json.load(f)
    assert point["EbN0dB"] == 8.0 and 1.0 <= point["T"] <= 10.0
