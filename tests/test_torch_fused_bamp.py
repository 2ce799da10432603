"""The plain version of the port's whole-decode kernel (the function the
CUDA kernel computes, ``ops/kernels/fused_bamp.py::decode_plain``) against
the JAX package's Pallas whole-decode kernel, run in interpret mode on the
CPU through ``bamp.decode(..., use_pallas=True)``, on the geometries of
``tests/test_pallas.py``.  Per-trial T must be identical and the state
within 1e-4, the JAX package's own kernel-against-XLA tolerances.  The
CUDA kernel itself is checked against this plain version on the card by
``chip_smoke.py``."""
import jax
import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu.config import Config as JConfig
from amp_sparc_spatialmodulation_tpu.models import bamp as jbamp
from amp_sparc_spatialmodulation_tpu.ops import channel as jchannel
from amp_sparc_spatialmodulation_tpu.ops import message as jmessage
from amp_sparc_spatialmodulation_tpu.ops import operators as joperators
from amp_sparc_spatialmodulation_tpu_torch import interop
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.models import bamp
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp

B = 16

# (name, config overrides, seed, SNR exponent): tests/test_pallas.py:13-127
GEOMETRIES = [
    ("ook_tail", dict(alphabet="OOK", trunc="tail", iterations=12), 0, 1.2),
    ("ook_trunc", dict(alphabet="OOK", trunc="trunc", iterations=12), 0, 1.2),
    ("ook_cyclic", dict(alphabet="OOK", trunc="cyclic", iterations=12), 0,
     1.2),
    ("qpsk_tail", dict(alphabet="QPSK", trunc="tail", iterations=8), 0, 1.5),
    ("8psk_tail", dict(alphabet="8PSK", trunc="tail", iterations=10), 0, 1.6),
    ("ook_m6", dict(alphabet="OOK", trunc="tail", iterations=10, Nt=24), 2,
     1.3),
    ("random_qpsk", dict(alphabet="QPSK", trunc="tail", iterations=10,
                         mode="random"), 5, 1.4),
]


def shared_inputs(kw, seed, snr_exp, batch=B):
    """A realization drawn by the JAX package, carried over through NumPy:
    (port config, port operator, y, sigma2, JAX config, JAX operator)."""
    base = dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, mode="segmented",
                profile="uniform")
    base.update(kw)
    jcfg, cfg = JConfig(**base), Config(**base)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    if jcfg.mode == "random":
        jop = joperators.banded_toeplitz(k1, jcfg)
    else:
        _, jop = joperators.banded_sparc(k1, jcfg)
    msg = jmessage.generate_message(k2, jcfg, batch)
    snr = 10 ** snr_exp
    y = jop.apply(msg.x) + jchannel.awgn(k3, jcfg, snr, batch)
    op = interop.operator_from_numpy(np.asarray(jop.h), np.asarray(jop.gains),
                                     cfg.Lin, cfg.Lout, cfg.trunc,
                                     device="cpu")
    y_np = np.array(y)
    return cfg, op, torch.as_tensor(y_np), jcfg.sigma2(snr), jcfg, jop, y


def assert_same_decode(port, ref, tol=1e-4):
    np.testing.assert_array_equal(port.T.numpy(), np.asarray(ref.T))
    for f in ("xmap", "xmmse", "var"):
        d = np.abs(getattr(port, f).numpy() - np.asarray(getattr(ref, f)))
        assert float(d.max()) < tol, f


def plain_decode(op, y, sigma2, cfg, cap=None, state0=None):
    s0 = state0 if state0 is not None else bamp.initial_state(
        y, cfg.N, float(np.float32(sigma2)))
    return fused_bamp.decode_plain(op, s0, y, sigma2,
                                   cfg.N_Layers if cap is None else cap, cfg)


@pytest.mark.parametrize("name,kw,seed,snr_exp", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_plain_matches_pallas_kernel(name, kw, seed, snr_exp):
    cfg, op, y, s2, jcfg, jop, jy = shared_inputs(kw, seed, snr_exp)
    assert fused_bamp.covers(cfg) and fused_bamp.fits(cfg)
    ref = jbamp.decode(jop, jy, s2, jcfg, use_pallas=True)
    assert_same_decode(plain_decode(op, y, s2, cfg), ref)


def test_split_and_resume_matches_unsplit():
    """Split at iter_cap=3 and resume: the trajectory of the unsplit
    decode, in the port and against the JAX kernel's resumed run
    (tests/test_pallas.py:129-139)."""
    cfg, op, y, s2, jcfg, jop, jy = shared_inputs(GEOMETRIES[0][1], 0, 1.2)
    full = plain_decode(op, y, s2, cfg)
    part = plain_decode(op, y, s2, cfg, cap=3)
    assert part.t == 3
    resumed = plain_decode(op, y, s2, cfg, state0=part)
    assert torch.equal(full.T, resumed.T)
    for f in ("xmmse", "var"):
        assert float((getattr(full, f) - getattr(resumed, f)).abs().max()) \
            < 1e-5
    _, jst = jbamp.decode(jop, jy, s2, jcfg, use_pallas=True, iter_cap=3,
                          return_state=True)
    jres = jbamp.decode(jop, jy, s2, jcfg, use_pallas=True, state0=jst)
    assert_same_decode(resumed, jres)


def test_resume_state_from_jax():
    """A JAX state carried over through NumPy resumes in the port to the
    JAX kernel's final state."""
    cfg, op, y, s2, jcfg, jop, jy = shared_inputs(GEOMETRIES[3][1], 0, 1.5)
    _, jst = jbamp.decode(jop, jy, s2, jcfg, use_pallas=True, iter_cap=2,
                          return_state=True)
    s0 = interop.state_from_numpy(*[np.asarray(v) for v in jst],
                                  device="cpu")
    assert s0.t == 2
    back = interop.state_to_numpy(s0)
    np.testing.assert_array_equal(back["var"], np.asarray(jst.var))
    assert back["t"] == 2
    port = plain_decode(op, y, s2, cfg, state0=s0)
    ref = jbamp.decode(jop, jy, s2, jcfg, use_pallas=True, state0=jst)
    assert_same_decode(port, ref)


def test_global_counter_rule():
    """``t`` runs to the cap while any trial is active, else stops at the
    slowest trial's T (bamp.py:156-159)."""
    cfg, op, y, s2, *_ = shared_inputs(GEOMETRIES[0][1], 0, 1.2)
    done = plain_decode(op, y, s2, cfg)
    assert not bool(done.active.any())
    assert done.t == int(done.T.max())
    capped = plain_decode(op, y, s2, cfg, cap=2)
    assert bool(capped.active.any()) and capped.t == 2
    assert int(capped.T.max()) == 2


def test_cpu_tensors_take_the_plain_version():
    cfg, op, y, s2, *_ = shared_inputs(GEOMETRIES[3][1], 0, 1.5)
    before = fused_bamp.launches
    s0 = bamp.initial_state(y, cfg.N, float(np.float32(s2)))
    got = fused_bamp.whole_decode(op, s0, y, s2, cfg.N_Layers, cfg)
    want = fused_bamp.decode_plain(op, s0, y, s2, cfg.N_Layers, cfg)
    assert fused_bamp.launches == before
    for f in bamp.BAMPState._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert (a == b) if f == "t" else torch.equal(a, b), f


def test_coverage_rule():
    """The JAX FusedBandedDecode.covers rule, plus the shared-memory fit."""
    from amp_sparc_spatialmodulation_tpu.ops.pallas.fused_bamp import (
        FusedBandedDecode)
    from amp_sparc_spatialmodulation_tpu_torch import config as tconfig
    cases = [dict(mode="segmented", alphabet="OOK"),
             dict(mode="segmented", alphabet="QPSK"),
             dict(mode="sparc", alphabet="8PSK"),
             dict(mode="random", alphabet="QPSK"),
             dict(mode="segmented", alphabet="BPSK", is_complex=False),
             dict(mode="random", alphabet="OOK", is_complex=False)]
    for kw in cases:
        base = dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, **kw)
        assert fused_bamp.covers(Config(**base)) \
            == FusedBandedDecode.covers(JConfig(**base)), kw
    flag = tconfig.flagship_bamp_ook()
    assert fused_bamp.fits(flag)
    assert fused_bamp.smem_bytes(flag) == 4 * (3 * 1440 + 4 * 2560 + 5 * 528)
    assert not fused_bamp.fits(tconfig.massive_mimo())


def test_wrapper_rejects_other_devices():
    cfg, op, y, s2, *_ = shared_inputs(GEOMETRIES[0][1], 0, 1.2)
    s0 = bamp.initial_state(y, cfg.N, float(np.float32(s2)))
    with pytest.raises(ValueError):
        fused_bamp.whole_decode(op, s0, y.to("meta"), s2, 12, cfg)


def _fake_toolkit(tmp_path, monkeypatch, script):
    """A CUDA_HOME whose bin/nvcc is ``script`` and a source dir with one
    kernel source, both under tmp_path."""
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import build
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + script)
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// v1\n")
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    return build, csrc


def test_build_is_keyed_on_source_and_cached(tmp_path, monkeypatch):
    # the fake compiler writes its -o argument
    build, csrc = _fake_toolkit(tmp_path, monkeypatch, (
        'while [ "$1" != "-o" ]; do shift; done; echo lib > "$2"\n'
        'echo "ptxas info    : Used 1 registers"\n'))
    first = build.library_path("k")
    report = build.build(["k"])
    assert not report["k"]["cached"] and first.is_file()
    assert "registers" in report["k"]["ptxas"]
    assert build.build(["k"])["k"]["cached"]
    (csrc / "k.cu").write_text("// v2\n")
    assert build.library_path("k") != first
    assert not build.build(["k"])["k"]["cached"]


def test_build_is_keyed_on_included_headers(tmp_path, monkeypatch):
    """A header under csrc/ that a source includes, directly or through
    another header, is part of the library's key; other files are not."""
    build, csrc = _fake_toolkit(tmp_path, monkeypatch, "exit 0\n")
    (csrc / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n')
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (csrc / "b.cuh").write_text("// v1\n")
    (csrc / "other.cuh").write_text("// v1\n")
    first = build.library_path("k")
    (csrc / "other.cuh").write_text("// v2\n")
    assert build.library_path("k") == first
    (csrc / "b.cuh").write_text("// v2\n")
    second = build.library_path("k")
    assert second != first
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// x\n')
    assert build.library_path("k") not in (first, second)


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    build, _ = _fake_toolkit(tmp_path, monkeypatch,
                             'echo "error: no such intrinsic"; exit 1\n')
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        build.build(["k"])
    assert not list((tmp_path / "out").glob("*.so"))
