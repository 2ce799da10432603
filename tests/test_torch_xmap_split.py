"""K1's xmap-precision split (``AMP_KERNEL_XMAP_PRECISION``) against the
JAX package on the CPU.

JAX's whole-decode kernel reads the variable when ``FusedBandedDecode`` is
built (``fused_bamp.py:990-991`` there) and, where it is set, runs the
xmap chain of ``_linear_iteration`` (the Gauss products of the forward
pseudo-data and of the adjoint) with ``dot_x = make_dot(x_precision)`` and
the variance chain (``Pv``, ``cov``; the stop test reads them) at the
decode's precision (``:184-185``).  The port's plain version is
``bamp.plain_loop_split``; its CUDA instances are held to it on the card
by ``chip_smoke.py`` (``kernels_bamp_xmap``, ``main_bamp_xmap``).

Witnesses: JAX's K1 in interpret mode with the variable set (by
``monkeypatch.setenv`` before the decode builds the kernel) at the decode's
precision; for a pair with a ``'default'`` side under the patched
``make_dot`` (``tests/test_torch_default.py``: XLA on the CPU computes
DEFAULT in float32, the TPU in one bf16 pass).  Rules, those of
``test_plain_high_matches_jax_kernel`` and
``test_k1_plain_default_matches_jax_kernel``: per-trial T identical; the
state within 1e-4 on the trials that stopped before the cap, and (no
``'default'`` side) within 1e-3 on every trial.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu.models import bamp as jbamp
from amp_sparc_spatialmodulation_tpu.ops.pallas import fused_bamp as jfb
from amp_sparc_spatialmodulation_tpu_torch import cli
from amp_sparc_spatialmodulation_tpu_torch.config import (
    Config, flagship_bamp_ook, flagship_bamp_qpsk, flagship_scamp,
    massive_mimo)
from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
from amp_sparc_spatialmodulation_tpu_torch.ops import precision as prec
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
from amp_sparc_spatialmodulation_tpu_torch.utils import metrics
from amp_sparc_spatialmodulation_tpu_torch.utils.device import make_generator

from test_torch_default import patched_make_dot
from test_torch_fused_bamp import GEOMETRIES, shared_inputs

VAR = "AMP_KERNEL_XMAP_PRECISION"
JAX_PRECISION = {"highest": jax.lax.Precision.HIGHEST,
                 "high": jax.lax.Precision.HIGH,
                 "default": jax.lax.Precision.DEFAULT}
# The six (variance chain, xmap chain) pairs JAX takes off the diagonal.
PAIRS = [("highest", "high"), ("highest", "default"), ("high", "default"),
         ("high", "highest"), ("default", "high"), ("default", "highest")]
# A small OOK and a small QPSK geometry of tests/test_torch_fused_bamp.py.
SPLIT_GEOMETRIES = [GEOMETRIES[0], GEOMETRIES[3]]
SMALL = dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, mode="segmented",
             profile="uniform")


@pytest.fixture(autouse=True)
def one_thread():
    """PyTorch on one thread, as in tests/test_torch_plain_high.py: the
    test workers share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def same_state(a, b) -> None:
    for f in bamp.BAMPState._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x == y) if f == "t" else torch.equal(x, y), f


# ---- the parser -------------------------------------------------------------


@pytest.mark.parametrize("value", ["", "highest", "high", "default",
                                   "float32", "tensorfloat32", "bfloat16",
                                   "fastest", "HIGHEST", "foo"])
def test_parser_takes_what_jax_takes(monkeypatch, value):
    """``precision.xmap_precision`` accepts and rejects each value as
    ``jax.lax.Precision`` does in the JAX imported here, and names the
    precision JAX's does; empty is unset, as ``FusedBandedDecode`` reads
    it."""
    monkeypatch.setenv(VAR, value)
    if value == "":
        assert prec.xmap_precision() is None
        return
    try:
        want = jax.lax.Precision(value).name.lower()
    except ValueError:
        with pytest.raises(ValueError, match=VAR):
            prec.xmap_precision()
        return
    assert prec.xmap_precision() == want
    monkeypatch.delenv(VAR)
    assert prec.xmap_precision() is None


# ---- the plain version against JAX's K1 -------------------------------------


@pytest.mark.parametrize("geometry", SPLIT_GEOMETRIES,
                         ids=[g[0] for g in SPLIT_GEOMETRIES])
@pytest.mark.parametrize("pair", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_plain_split_matches_jax_kernel(monkeypatch, pair, geometry):
    """``plain_loop_split`` against JAX's K1 in interpret mode with the
    variable set to the xmap chain's precision (the rules of the module
    docstring); the split decodes another function than the form at the
    decode's precision, in JAX and in the port."""
    precision, x = pair
    _, kw, seed, snr_exp = geometry
    cfg, op, y, s2, jcfg, jop, jy = shared_inputs(kw, seed, snr_exp)
    if "default" in pair:
        monkeypatch.setattr(jfb, "make_dot", patched_make_dot)
    jp = JAX_PRECISION[precision]
    same = jbamp.decode(jop, jy, s2, jcfg, use_pallas=True, precision=jp)
    monkeypatch.setenv(VAR, x)
    ref = jbamp.decode(jop, jy, s2, jcfg, use_pallas=True, precision=jp)
    assert not np.array_equal(np.asarray(ref.xmap), np.asarray(same.xmap))
    s0 = bamp.initial_state(y, cfg.N, float(np.float32(s2)))
    before = bamp.plain_decodes
    st = fused_bamp.decode_plain_split(op, s0, y, s2, cfg.N_Layers, cfg,
                                       precision, x)
    assert bamp.plain_decodes == before + 1
    np.testing.assert_array_equal(st.T.numpy(), np.asarray(ref.T))
    done = ~st.active.numpy()
    for f in ("xmap", "xmmse", "var"):
        d = np.abs(getattr(st, f).numpy() - np.asarray(getattr(ref, f)))
        row = d.reshape(d.shape[0], -1).max(axis=1)
        assert float(row[done].max(initial=0.0)) < 1e-4, f
        if "default" not in pair:
            assert float(row.max()) < 1e-3, f
    form = fused_bamp.PLAIN[precision](op, s0, y, s2, cfg.N_Layers, cfg)
    assert not torch.equal(st.xmap, form.xmap)


def test_split_planes_keep_the_forms():
    """``linear_step_high`` with ``dot_x`` the same product as ``dot`` is
    the HIGH (DEFAULT) step bit for bit; the FP32 taps are the Gauss planes
    in order."""
    cfg, op, y, s2, *_ = shared_inputs(GEOMETRIES[3][1], 0, 1.5)
    s = bamp.initial_state(y, cfg.N, float(np.float32(s2)))
    s = bamp.plain_loop_high(op, s, y, s2, 2, cfg)
    taps = bamp.gauss_taps(op)
    for d in (prec.dot3, prec.dot1):
        a = bamp.linear_step_high(op, s.xmmse, s.var, s.z, s.u, y, s2,
                                  taps=taps, real_x=False, dot=d)
        b = bamp.linear_step_high(op, s.xmmse, s.var, s.z, s.u, y, s2,
                                  taps=taps, real_x=False, dot=d, dot_x=d)
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    buf = fused_bamp.fp32_taps(op)
    W = cfg.Lh * cfg.Nr
    planes = (taps.s_a2, taps.s_re, taps.dmc, taps.cpd, taps.st_a2,
              taps.st_re, taps.amc, taps.adm)
    assert buf.numel() == 8 * cfg.Nt * W
    for i, t in enumerate(planes):
        assert torch.equal(buf[i * cfg.Nt * W:(i + 1) * cfg.Nt * W],
                           t.reshape(-1))


# ---- the diagonal: the form at the decode's precision -----------------------


@pytest.mark.parametrize("precision,value", [
    ("highest", "highest"), ("highest", "float32"), ("high", "high"),
    ("high", "tensorfloat32"), ("default", "default"),
    ("default", "bfloat16")])
def test_diagonal_is_the_unset_decode(monkeypatch, precision, value):
    """The variable naming the decode's own precision (or an alias of it)
    gives the decode of the unset variable bit for bit, as JAX's ``dot_x``
    is then ``dot``."""
    cfg, op, y, s2, *_ = shared_inputs(GEOMETRIES[3][1], 0, 1.5)
    want = bamp.decode(op, y, s2, cfg, precision=precision)
    monkeypatch.setenv(VAR, value)
    assert bamp.xmap_split(precision) is None
    got = bamp.decode(op, y, s2, cfg, precision=precision)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# ---- the route (the three cases of tests/test_torch_k5_high_tiles.py::
# test_route_refuses_the_xmap_precision_knob turned round, and these) -------


def test_split_on_the_cpu_is_the_plain_split(monkeypatch):
    """With the variable set, ``bamp.decode`` takes K1, whose wrapper runs
    ``plain_loop_split`` on CPU tensors and launches nothing."""
    cfg, op, y, s2, *_ = shared_inputs(GEOMETRIES[3][1], 0, 1.5)
    s0 = bamp.initial_state(y, cfg.N, float(np.float32(s2)))
    want = bamp.plain_loop_split(op, s0, y, s2, cfg.N_Layers, cfg,
                                 "highest", "default")
    counts = lambda: (fused_bamp.launches, fused_bamp.launches_high,
                      fused_bamp.launches_default, fused_bamp.launches_xmap)
    before = counts()
    same_state(fused_bamp.whole_decode(op, s0, y, s2, cfg.N_Layers, cfg,
                                       "highest", "default"), want)
    same_state(fused_bamp.whole_decode(op, s0, y, s2, cfg.N_Layers, cfg,
                                       "highest", "highest"),
               fused_bamp.decode_plain(op, s0, y, s2, cfg.N_Layers, cfg))
    monkeypatch.setenv(VAR, "bfloat16")
    assert bamp.route(cfg, op, 16, "cpu") == "whole"
    _, got = bamp.decode(op, y, s2, cfg, return_state=True)
    same_state(got, want)
    assert counts() == before


@pytest.mark.parametrize("knob", ["use_pallas_false", "xla", "periter",
                                  "massive_k5"])
def test_knob_ignored_off_k1(monkeypatch, knob):
    """Where the chain does not take K1 the variable is not read, as in
    JAX: a bad value does not raise and a good one changes nothing
    (``use_pallas=False``, ``AMP_PALLAS_MODE=xla|periter``, the massive
    geometry's K5)."""
    if knob == "massive_k5":
        monkeypatch.setenv(VAR, "HIGH")
        assert bamp.route_of(massive_mimo(), True) == "tiled"
        assert bamp.route_of(massive_mimo(), True, precision="high") \
            == "tiled"
        return
    cfg, op, y, s2, *_ = shared_inputs(GEOMETRIES[0][1], 0, 1.2)
    kw = dict(use_pallas=False) if knob == "use_pallas_false" else {}
    if knob != "use_pallas_false":
        monkeypatch.setenv("AMP_PALLAS_MODE", knob)
    want = bamp.decode(op, y, s2, cfg, **kw)
    for value in ("HIGH", "default"):
        monkeypatch.setenv(VAR, value)
        assert bamp.route(cfg, op, 16, "cpu", **kw) != "whole"
        got = bamp.decode(op, y, s2, cfg, **kw)
        assert torch.equal(got.T, want.T) and torch.equal(got.xmap,
                                                          want.xmap)


@pytest.mark.parametrize("algo", ["scamp", "vamp", "vamp2"])
def test_knob_ignored_by_the_other_decoders(monkeypatch, algo):
    """SCAMP, VAMP and vamp2 never read the variable (JAX's K2, K3 and K4
    have no such knob): a bad value changes nothing."""
    cfg = Config(**dict(SMALL, alphabet="OOK", trunc="tail", iterations=8,
                        mode="sparc" if algo == "scamp" else "segmented"))
    form = "dense" if algo != "scamp" else "banded"
    gen = make_generator(torch.device("cpu"), 3)
    r = montecarlo.with_svd(algo, montecarlo.generate_realization(
        gen, cfg, "sparc", form, 16, 10.0))
    want = montecarlo.decode(algo, r, r.y, cfg)
    monkeypatch.setenv(VAR, "HIGH")
    got = montecarlo.decode(algo, r, r.y, cfg)
    assert torch.equal(got.T, want.T) and torch.equal(got.xmmse, want.xmmse)


def test_split_that_does_not_fit_raises(monkeypatch):
    """Where K1's HIGHEST form holds a trial and the split form asked for
    does not (the SCAMP flagship's dimensions under BAMP at 'highest' with
    the variable at 'high': the HIGH layout's block passes the shared
    memory), the route takes K1's split form as a cluster of two blocks a
    trial (``'whole'``), as JAX's K1 runs the split there, and does not
    raise; not K6, K5 or the plain loop (which ignore the variable).  Where
    no cluster holds the split form either (a plan made to say so), K1's
    split function as its plain version (``'whole_plain'``,
    ``decode_plain_split``).  The flagships fit every pair: the mixed forms
    ``<3, 1>`` and ``<1, 3>`` on each chain's planes, the others on the
    HIGH form's region."""
    big = flagship_scamp()
    assert fused_bamp.fits(big) and not fused_bamp.fits(big, "highest",
                                                         "high")
    assert fused_bamp.cluster_plan(big, "highest", "high").ctas == 2
    monkeypatch.setenv(VAR, "high")
    assert bamp.route_of(big, True) == "whole"
    assert bamp.route_of(big, True, batch=4096) == "whole"
    assert bamp.route_of(big, True, precision="high", batch=4096) == "whole"
    # the dispatch, on a small geometry whose split form is made to
    # decline: the plain split version, counted in plain_decodes
    _, kw, seed, snr_exp = SPLIT_GEOMETRIES[0]
    cfg, op, y, s2, *_ = shared_inputs(kw, seed, snr_exp)
    real = fused_bamp.cluster_plan
    monkeypatch.setattr(
        fused_bamp, "cluster_plan",
        lambda c, p="highest", x=None, ctas=None: real(
            c, p, x, ctas)._replace(ctas=0) if x is not None
        else real(c, p, x, ctas))
    assert bamp.route(cfg, op, y.shape[0], "cpu") == "whole_plain"
    before = bamp.plain_decodes
    _, st = bamp.decode(op, y, s2, cfg, return_state=True)
    assert bamp.plain_decodes == before + 1
    s0 = bamp.initial_state(y, cfg.N, float(np.float32(s2)))
    same_state(st, fused_bamp.decode_plain_split(op, s0, y, s2,
                                                 cfg.N_Layers, cfg,
                                                 "highest", "high"))
    monkeypatch.undo()
    for cfg in (flagship_bamp_ook(), flagship_bamp_qpsk()):
        high = fused_bamp.smem_bytes(cfg, "high")
        for pair in PAIRS:
            assert fused_bamp.fits(cfg, *pair)
            smem = fused_bamp.smem_bytes(cfg, *pair)
            assert smem < high if fused_bamp.mixed(*pair) else smem == high


# ---- the sweep with the variable set ----------------------------------------


def _split_sums(cfg, res, snr, seed, precision, x):
    """One realization's metric sums composed by hand: generated at
    ``precision``, decoded by ``plain_loop_split``."""
    gen = make_generator(torch.device("cpu"), seed, 0, 0)
    r = montecarlo.generate_realization(gen, cfg, "sparc", "banded", res,
                                        snr, precision)
    s0 = bamp.initial_state(r.y, cfg.N, float(np.float32(r.sigma2)))
    s = bamp.plain_loop_split(r.A, s0, r.y, r.sigma2, cfg.N_Layers, cfg,
                              precision, x)
    return metrics.finalize(metrics.evaluate_sums(
        s.xmap, s.xmmse, r.msg, s.T, cfg), cfg)


def test_simulator_and_cli_with_the_knob(tmp_path, monkeypatch):
    """A ``Simulator`` point and a ``cli sweep`` with the variable set give
    the sums of a manual ``plain_loop_split`` loop, and differ from the
    unset run."""
    cfg = Config(**dict(SMALL, alphabet="OOK", trunc="tail", iterations=8))
    ebn0, res, seed = 5.0, 64, 4
    snr = 10 ** ((ebn0 + 10 * np.log10(cfg.code_rate)) / 10)
    kw = dict(algo="bamp", device="cpu", progress=lambda s: None,
              out_root=str(tmp_path), seed=seed)
    unset = montecarlo.Simulator(cfg, **kw).run_point(ebn0, epochs=res,
                                                      res=res)
    monkeypatch.setenv(VAR, "default")
    got = montecarlo.Simulator(cfg, **kw).run_point(ebn0, epochs=res,
                                                    res=res)
    assert got == _split_sums(cfg, res, snr, seed, "highest", "default")
    assert got != unset
    out = tmp_path / "cli"
    rc = cli.main(["sweep", "--algo", "bamp", "--Nt", "16", "--Na", "4",
                   "--Nr", "8", "--Lin", "8", "--Lh", "3", "--iterations",
                   "8", "--epochs", "64", "--res", "64", "--start", "5",
                   "--final", "5", "--seed", str(seed), "--device", "cpu",
                   "--out", str(out)])
    assert rc == 0
    with open(os.path.join(str(out), "BAMP", cfg.name, "5.0.json")) as f:
        point = json.load(f)
    assert point["T"] == got["T"] and point["fer"] == got["fer"]
