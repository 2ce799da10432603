"""The port's VAMP decoder and the plain version of its whole-decode kernel
(``ops/kernels/fused_vamp.py::decode_plain``, the function the CUDA kernel
computes) against the JAX package's VAMP on shared inputs: its XLA decode
and its Pallas whole-decode kernel run in interpret mode on the CPU
(``use_pallas=True``), on the geometries of ``tests/test_pallas_vamp.py``.

Singular vectors are defined only up to a phase each, so both packages get
the same factors ``(U, s, Vh)``, computed once by the JAX package and
carried over through NumPy.  Tolerances are those of the JAX package's own
kernel-against-XLA test (``tests/test_pallas_vamp.py:32-37``): per-trial T
identical, ``xmmse`` and ``var`` within 1e-3, and the pseudo-data ``r``
within 5e-2, because it divides by ``1 - alpha`` with alpha clipped at
``1 - 1e-5``, which amplifies float32 summation-order noise up to 1e5.
The CUDA kernel itself is checked against this plain version on the card
by ``chip_smoke.py``."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from amp_sparc_spatialmodulation_tpu.config import Config as JConfig
from amp_sparc_spatialmodulation_tpu.models import vamp as jvamp
from amp_sparc_spatialmodulation_tpu.ops import channel as jchannel
from amp_sparc_spatialmodulation_tpu.ops import message as jmessage
from amp_sparc_spatialmodulation_tpu_torch import cli, interop
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.models import montecarlo as mc
from amp_sparc_spatialmodulation_tpu_torch.models import vamp
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import build, fused_vamp

SMALL = dict(Nt=16, Na=4, Nr=10, Lin=8, Lh=3, mode="segmented",
             alphabet="OOK", profile="uniform", trunc="tail", iterations=10)

# (name, config overrides, SNR exponent): tests/test_pallas_vamp.py:26, plus
# 8PSK and the random mode (Bernoulli-mixture denoiser, no kernel)
GEOMETRIES = [
    ("ook", dict(), 1.5),
    ("qpsk", dict(alphabet="QPSK"), 1.9),
    ("8psk", dict(alphabet="8PSK"), 2.0),
    ("random_qpsk", dict(alphabet="QPSK", mode="random"), 1.9),
]


def shared_inputs(kw, snr_exp, batch=8, seed=0, base=SMALL,
                  svd_by="jax"):
    """A dense SPARC realization drawn by the JAX package and its direct
    SVD, computed by the JAX package (``svd_by='jax'``) or by the port, and
    carried over through NumPy: (port config, port SVD, y, sigma2, JAX
    config, JAX SVD, JAX y)."""
    b = dict(base, **kw)
    jcfg, cfg = JConfig(**b), Config(**b)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    _, A = jchannel.generate_as_sparc(k1, jcfg)
    msg = jmessage.generate_message(k2, jcfg, batch)
    snr = 10 ** snr_exp
    jy = msg.x @ A.T + jchannel.awgn(k3, jcfg, snr, batch)
    if svd_by == "jax":
        jdec = jvamp.svd(A, method="direct")
        dec = interop.svd_from_numpy(*[np.asarray(v) for v in jdec],
                                     device="cpu")
    else:
        dec = vamp.svd(torch.as_tensor(np.array(A)), method="direct")
        jdec = jvamp.SVD(*[jnp.asarray(t.numpy()) for t in dec])
    return (cfg, dec, torch.as_tensor(np.array(jy)), jcfg.sigma2(snr), jcfg,
            jdec, jy)


def assert_same_decode(port, ref, r_tol=5e-2, tol=1e-3):
    """T identical, r within ``r_tol``, xmmse and var within ``tol``."""
    np.testing.assert_array_equal(port.T.numpy(), np.asarray(ref.T))
    for f, bound in (("xmap", r_tol), ("xmmse", tol), ("var", tol)):
        d = np.abs(getattr(port, f).numpy() - np.asarray(getattr(ref, f)))
        assert float(d.max()) < bound, f


@pytest.mark.parametrize("method", ["direct", "gram"])
@pytest.mark.parametrize("tall", [False, True], ids=["wide", "tall"])
def test_svd_factors(method, tall):
    """Both methods and both branches of the Gram route
    (tests/test_decoders.py:70-95): the factors reconstruct A, U and Vh
    are orthonormal (1e-4, float32 products of width 100), and s equals
    the JAX package's (1e-4)."""
    b = dict(SMALL, Lin=6, alphabet="QPSK")
    jcfg = JConfig(**b)
    _, A = jchannel.generate_as_sparc(jax.random.PRNGKey(3), jcfg)
    A = np.asarray(A)
    if tall:
        A = A.conj().T
    dec = vamp.svd(torch.from_numpy(A.copy()), method=method)
    U, s, Vh = (t.numpy() for t in dec)
    np.testing.assert_allclose((U * s[None, :]) @ Vh, A, atol=1e-4)
    np.testing.assert_allclose(U.conj().T @ U, np.eye(U.shape[1]), atol=1e-4)
    np.testing.assert_allclose(Vh @ Vh.conj().T, np.eye(Vh.shape[0]),
                               atol=1e-4)
    js = np.asarray(jvamp.svd(jnp.asarray(A), method=method).s)
    np.testing.assert_allclose(s, js, atol=1e-4)
    assert dec.s.dtype == torch.float32


def test_gram_zero_singular_values_are_the_vamp2_hazard():
    """An ill-conditioned matrix (tests/test_decoders.py:148-171): the
    direct SVD keeps every singular value positive, the Gram route returns
    exact zeros, which vamp2's whitening would divide by."""
    rng = np.random.default_rng(0)
    n, N = 32, 128
    U0, _ = np.linalg.qr(rng.standard_normal((n, n))
                         + 1j * rng.standard_normal((n, n)))
    V0, _ = np.linalg.qr(rng.standard_normal((N, n))
                         + 1j * rng.standard_normal((N, n)))
    A = torch.as_tensor(((U0 * np.geomspace(1.0, 1e-5, n)) @ V0.conj().T)
                        .astype(np.complex64))
    assert float(vamp.svd(A, method="direct").s.min()) > 0
    assert float(vamp.svd(A, method="gram").s.min()) == 0.0
    with pytest.raises(ValueError):
        vamp.svd(A, method="qr")


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("name,kw,snr_exp", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_plain_matches_jax(name, kw, snr_exp, use_pallas):
    cfg, dec, y, s2, jcfg, jdec, jy = shared_inputs(kw, snr_exp)
    if cfg.mode == "random":
        # no kernel covers the random mode, in either package
        assert not fused_vamp.covers(cfg)
        if use_pallas:
            with pytest.raises(ValueError):
                jvamp.decode(jdec, jy, s2, jcfg, use_pallas=True)
            return
    ref = jvamp.decode(jdec, jy, s2, jcfg, use_pallas=use_pallas)
    assert_same_decode(vamp.decode(dec, y, s2, cfg), ref)


def test_matches_numpy_oracle():
    """The NumPy oracle of the reference equations as a third witness, at
    the bounds of tests/test_decoders.py:55-67 (T within 1, xmmse within
    2e-2)."""
    b = dict(Nt=16, Na=4, Nr=10, Lin=6, Lh=3, mode="segmented",
             iterations=30, alphabet="QPSK", profile="uniform", trunc="tail")
    cfg, dec, y, s2, *_ = shared_inputs({}, 1.4, batch=3, seed=1, base=b)
    res = vamp.decode(dec, y, s2, cfg)
    U, s, Vh = (t.numpy() for t in dec)
    for i in range(y.shape[0]):
        _, xmmse_ref, _, T_ref = oracle.vamp(
            U, s, Vh, y[i].numpy(), s2, cfg.sparsity, np.asarray(cfg.symbols),
            cfg.L, cfg.M, cfg.N_Layers)
        assert abs(int(res.T[i]) - T_ref) <= 1
        np.testing.assert_allclose(res.xmmse[i].numpy(), xmmse_ref,
                                   atol=2e-2)


def test_split_and_resume_matches_unsplit():
    """Split at iter_cap=3 and resume: the unsplit trajectory, in the port
    and against the JAX kernel's resumed run
    (tests/test_pallas_vamp.py:69-76)."""
    cfg, dec, y, s2, jcfg, jdec, jy = shared_inputs(
        dict(iterations=8, alphabet="QPSK"), 1.2)
    _, full = vamp.decode(dec, y, s2, cfg, return_state=True)
    _, part = vamp.decode(dec, y, s2, cfg, iter_cap=3, return_state=True)
    assert part.t == 3 and bool(part.active.any())
    _, resumed = vamp.decode(dec, y, s2, cfg, state0=part, return_state=True)
    assert torch.equal(full.T, resumed.T) and resumed.t == full.t
    for f in ("r_tilde", "sigma2_tilde", "xmmse", "var"):
        assert float((getattr(full, f) - getattr(resumed, f)).abs().max()) \
            < 1e-5, f
    _, jst = jvamp.decode(jdec, jy, s2, jcfg, use_pallas=True, iter_cap=3,
                          return_state=True)
    jres = jvamp.decode(jdec, jy, s2, jcfg, use_pallas=True, state0=jst)
    assert_same_decode(vamp.DecodeResult(resumed.r, resumed.xmmse,
                                         resumed.var, resumed.T), jres)


def test_resume_state_from_jax():
    """A JAX VAMPState carried over through NumPy resumes in the port to the
    JAX decode's final state; the round trip keeps every field."""
    cfg, dec, y, s2, jcfg, jdec, jy = shared_inputs(dict(alphabet="QPSK"),
                                                    1.9)
    _, jst = jvamp.decode(jdec, jy, s2, jcfg, iter_cap=2, return_state=True)
    s0 = interop.vamp_state_from_numpy(*[np.asarray(v) for v in jst],
                                       device="cpu")
    assert s0.t == 2 and s0.sigma2_tilde.shape == (8, 1)
    back = interop.state_to_numpy(s0)
    for f in jst._fields:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jst, f)))
    _, port = vamp.decode(dec, y, s2, cfg, state0=s0, return_state=True)
    _, ref = jvamp.decode(jdec, jy, s2, jcfg, state0=jst, return_state=True)
    assert port.t == int(ref.t)
    np.testing.assert_array_equal(port.T.numpy(), np.asarray(ref.T))
    for f in ("xmmse", "var", "sigma2_tilde"):
        d = np.abs(getattr(port, f).numpy() - np.asarray(getattr(ref, f)))
        assert float(d.max()) < 1e-3, f


def test_decode_batched_matches_separate_decodes():
    """Three realizations in one launch of the batched form equal three
    separate decodes (tests/test_pallas_vamp.py:96-124): on the CPU the
    plain version runs each realization's rows, so T is identical and the
    state within 1e-5."""
    cfg = Config(**SMALL)
    As, ys = [], []
    for c in range(3):
        gen = mc.make_generator(torch.device("cpu"), 7, c)
        r = mc.generate_realization(gen, cfg, "sparc", "dense", 8, 10 ** 1.5)
        As.append(r.A)
        ys.append(r.y)
    sigma2 = r.sigma2
    before = vamp.plain_decodes
    out = vamp.decode_batched(torch.stack(As), torch.stack(ys), sigma2, cfg)
    assert vamp.plain_decodes == before + 3
    assert out.T.shape == (3, 8) and out.xmmse.shape == (3, 8, cfg.N)
    for c in range(3):
        ref = vamp.decode(vamp.svd(As[c], method="direct"), ys[c], sigma2,
                          cfg)
        assert torch.equal(out.T[c], ref.T)
        for f in ("xmap", "xmmse", "var"):
            assert float((getattr(out, f)[c] - getattr(ref, f)).abs().max()) \
                < 1e-5, f
    with pytest.raises(ValueError):
        vamp.decode_batched(torch.stack(As), torch.stack(ys), sigma2,
                            Config(**dict(SMALL, mode="random")))


def test_main_path_geometry_matches_xla():
    """The main path's geometry (Nt=128, Na=8, Nr=24, Lin=20, Lh=3, OOK,
    segmented, tail; N = 2560, p = 528) at Eb/N0 = 8 dB and its cap of 10,
    128 shared trials.  At this width the two packages' CPU matrix products
    round differently and a trial may stop an iteration apart: T identical
    on >= 95% of the trials, |d mean T| <= 0.1 (the bounds of the SCAMP
    main-geometry test), xmmse and var within 1e-3 where T agrees.  The
    shared factors come from the port's SVD: the JAX package's takes about
    ten times as long on the CPU at this width."""
    b = dict(Nt=128, Na=8, Nr=24, Lin=20, Lh=3, mode="segmented",
             alphabet="OOK", profile="uniform", trunc="tail", iterations=10)
    snr_exp = (8.0 + 10 * np.log10(Config(**b).code_rate)) / 10
    cfg, dec, y, s2, jcfg, jdec, jy = shared_inputs({}, snr_exp, batch=128,
                                                    base=b, svd_by="port")
    ref = jvamp.decode(jdec, jy, s2, jcfg)
    port = vamp.decode(dec, y, s2, cfg)
    jT, pT = np.asarray(ref.T), port.T.numpy()
    agree = jT == pT
    assert agree.mean() >= 0.95
    assert abs(pT.mean() - jT.mean()) <= 0.1
    for f in ("xmmse", "var"):
        d = np.abs(getattr(port, f).numpy()[agree]
                   - np.asarray(getattr(ref, f))[agree])
        assert float(d.max()) < 1e-3, f


def test_wrapper_runs_plain_on_cpu_and_counts():
    """On CPU tensors the wrapper is its plain version and launches
    nothing; the global counter runs to the cap while a trial is active,
    else stops at the slowest trial (vamp.py:137-138); a tensor on another
    device raises."""
    cfg, dec, y, s2, *_ = shared_inputs(dict(iterations=12), 1.5)
    yt, sq = vamp.project(dec, y), dec.s ** 2
    s0 = vamp.initial_state(y, cfg)
    before, plain = fused_vamp.launches, vamp.plain_decodes
    done = fused_vamp.whole_decode(dec.Vh, sq, yt, s0, s2, 12, cfg)
    want = vamp.plain_loop(dec.Vh, sq, yt, s0, s2, 12, cfg)
    assert fused_vamp.launches == before
    assert vamp.plain_decodes == plain + 2
    for f in vamp.VAMPState._fields:
        a, b = getattr(done, f), getattr(want, f)
        assert (a == b) if f == "t" else torch.equal(a, b), f
    assert not bool(done.active.any()) and done.t == int(done.T.max())
    capped = fused_vamp.whole_decode(dec.Vh, sq, yt, s0, s2, 2, cfg)
    assert bool(capped.active.any()) and capped.t == 2
    assert torch.equal(capped.xmap, capped.r)
    with pytest.raises(ValueError):
        fused_vamp.whole_decode(dec.Vh, sq, yt.to("meta"), s0, s2, 12, cfg)


def test_coverage_rule_matches_jax():
    """covers equals the JAX FusedVampDecode.covers rule on the presets and
    the alphabet configs; the kernel sources are built with the others."""
    from amp_sparc_spatialmodulation_tpu import config as jconfig
    from amp_sparc_spatialmodulation_tpu.ops.pallas.fused_vamp import (
        FusedVampDecode)
    from amp_sparc_spatialmodulation_tpu_torch import config as tconfig
    for kw in (dict(mode="segmented", alphabet="OOK"),
               dict(mode="segmented", alphabet="QPSK"),
               dict(mode="sparc", alphabet="8PSK"),
               dict(mode="random", alphabet="QPSK"),
               dict(mode="segmented", alphabet="BPSK", is_complex=False)):
        b = dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, **kw)
        assert fused_vamp.covers(Config(**b)) \
            == FusedVampDecode.covers(JConfig(**b)), kw
    for name in ("flagship_bamp_ook", "flagship_scamp", "massive_mimo"):
        assert fused_vamp.covers(getattr(tconfig, name)()) \
            == FusedVampDecode.covers(getattr(jconfig, name)()), name
    assert {"fused_vamp_decode", "fused_vamp2_decode"} <= set(build.SOURCES)
    heads = {f.name for f in build._local_includes(
        build.CSRC / "fused_vamp_decode.cu")}
    assert {"vamp_common.cuh", "decode_common.cuh"} <= heads
    # the BAMP kernel's build key does not see the VAMP header
    assert "vamp_common.cuh" not in {f.name for f in build._local_includes(
        build.CSRC / "fused_bamp_decode.cu")}


def test_two_phase_matches_single_phase(tmp_path):
    """Two-phase sums equal single-phase ones (tests/test_pallas_vamp.py:
    79-93): the SVD is shared by both phases and decoding is per trial."""
    cfg = Config(**dict(SMALL, iterations=20))
    kw = dict(algo="vamp", device="cpu", progress=lambda s: None)
    a1 = mc.Simulator(cfg, out_root=str(tmp_path / "a"), **kw).run_point(
        9.0, epochs=64, res=32)
    a2 = mc.Simulator(cfg, out_root=str(tmp_path / "b"), two_phase=4,
                      **kw).run_point(9.0, epochs=64, res=32)
    assert 1.0 <= a1["T"] <= 20.0
    for k, v in a1.items():
        assert a2[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k


def test_cli_sweep_vamp_on_cpu(tmp_path):
    rc = cli.main(["sweep", "--algo", "vamp", "--Nt", "16", "--Na", "4",
                   "--Nr", "10", "--Lin", "8", "--Lh", "3", "--iterations",
                   "10", "--epochs", "32", "--res", "32", "--start", "8",
                   "--final", "8", "--two-phase", "4", "--device", "cpu",
                   "--out", str(tmp_path)])
    assert rc == 0
    path = os.path.join(str(tmp_path), "VAMP", Config(**SMALL).name,
                        "8.0.json")
    with open(path) as f:
        point = json.load(f)
    assert point["EbN0dB"] == 8.0 and 1.0 <= point["T"] <= 10.0
