"""K1's function wherever JAX's K1 runs, held against the JAX package on the
CPU.

JAX takes its whole-decode kernel K1 at the decode's precision wherever
``FusedBandedDecode.fits(cfg, batch)`` holds (`models/bamp.py:255-268`,
`ops/pallas/fused_bamp.py:966-971` there: a trial tile in 11 MiB of VMEM).
The port takes K1 where that holds or where its own block holds a trial
(``bamp.route_of``): ``'whole'`` wherever ``fused_bamp.cluster_plan``
holds a trial of the port's K1 form (the split form under
``AMP_KERNEL_XMAP_PRECISION``): in one block's shared memory, whatever its
number of column blocks, else spread over a thread-block cluster of 2, 4
or 8 blocks (``tests/test_torch_k1_cluster.py``); ``'whole_plain'``, K1's
function as its plain version on the decode's device, only where no
cluster of 8 holds one.

* ``fused_bamp.jax_fits`` equals ``FusedBandedDecode.fits`` over the three
  flagships' dimensions at Lin 20-96 and 64, 4096 and 65536 trials;
* ``route_of`` takes K1 (``'whole'``, one block or a cluster) on every
  geometry where JAX takes K1, never K6, K5 or the plain loop;
* at Lin 33 on a small geometry (more than the 32 column blocks K1's HIGH
  layout took before), the port's ``bamp.decode`` gives JAX's K1 in
  interpret mode at 'high' (OOK, BPSK, QPSK), at 'default' (under
  ``tests/test_torch_default.py::patched_make_dot``) and for one split
  pair under the variable: per-trial T identical, the state within 1e-4 on
  the trials that stopped before the cap and (without a 'default' side)
  within 1e-3 on every trial, the rule of
  ``tests/test_torch_bamp_high.py::test_plain_high_matches_jax_kernel``.

The kernel at Lin > 32 is held to its plain version on the card by
``chip_smoke.py`` (``kernels_bamp_high``, ``kernels_bamp_default``,
``kernels_bamp_xmap``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu import config as jconfig
from amp_sparc_spatialmodulation_tpu.models import bamp as jbamp
from amp_sparc_spatialmodulation_tpu.ops.pallas import fused_bamp as jfb
from amp_sparc_spatialmodulation_tpu_torch.config import (
    flagship_bamp_ook, flagship_bamp_qpsk, flagship_scamp)
from amp_sparc_spatialmodulation_tpu_torch.models import bamp
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp

from test_torch_default import patched_make_dot
from test_torch_fused_bamp import shared_inputs

VAR = "AMP_KERNEL_XMAP_PRECISION"
HIGH = jax.lax.Precision.HIGH
DEFAULT = jax.lax.Precision.DEFAULT
TRIALS = (64, 4096, 65536)
FLAGSHIPS = {"ook": flagship_bamp_ook, "qpsk": flagship_bamp_qpsk,
             "scamp": flagship_scamp}
# the small geometry at Lin = 33 (five n8 tiles of column blocks), 16 trials
SMALL33 = dict(Nt=16, Na=4, Nr=8, Lin=33, Lh=3, mode="segmented",
               profile="uniform", trunc="tail")


@pytest.fixture(autouse=True)
def one_thread():
    """PyTorch on one thread, as in tests/test_torch_plain_high.py: the
    test workers share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_config(cfg):
    return jconfig.Config(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)})


@pytest.mark.parametrize("batch", TRIALS)
@pytest.mark.parametrize("name", list(FLAGSHIPS))
def test_jax_fits_is_jax_fit(name, batch):
    """``jax_fits`` against ``FusedBandedDecode.fits`` at Lin 20-96: where
    JAX's VMEM tile search finds a tile; both ways occur over the grid."""
    seen = set()
    for lin in (20, 25, 32, 33, 40, 48, 64, 80, 96):
        cfg = dataclasses.replace(FLAGSHIPS[name](), Lin=lin)
        want = jfb.FusedBandedDecode.fits(jax_config(cfg), batch)
        assert fused_bamp.jax_fits(cfg, batch) == want, lin
        seen.add(want)
    assert True in seen


def test_jax_fits_reads_no_tile_experiment(monkeypatch):
    """``PALLAS_TILE`` (JAX's tile experiment on a TPU) changes nothing;
    a batch no tile of 8 divides takes no K1 in JAX."""
    cfg = flagship_bamp_qpsk()
    assert not jfb.FusedBandedDecode.fits(jax_config(cfg), 4099)
    monkeypatch.setenv("PALLAS_TILE", "8")
    assert fused_bamp.jax_fits(cfg, 4096)
    assert not fused_bamp.jax_fits(cfg, 4099)


# The Motivation's geometries: (name, config, K1's blocks a trial at
# highest / high / default): K1 takes each, in one block (1) or as a
# cluster (2).
ROUTES = [
    ("qpsk_lin32", dataclasses.replace(flagship_bamp_qpsk(), Lin=32),
     (1, 2, 1)),
    ("ook_lin40", dataclasses.replace(flagship_bamp_ook(), Lin=40),
     (1, 1, 1)),
    ("scamp_dims", flagship_scamp(), (1, 2, 2)),
    ("ook_lin48", dataclasses.replace(flagship_bamp_ook(), Lin=48),
     (1, 1, 1)),
    ("qpsk_lin48", dataclasses.replace(flagship_bamp_qpsk(), Lin=48),
     (2, 2, 2)),
]


@pytest.mark.parametrize("name,cfg,want", ROUTES, ids=[r[0] for r in ROUTES])
def test_route_takes_k1_where_jax_does(monkeypatch, name, cfg, want):
    """At every batch where JAX's K1 fits, ``route_of`` takes K1
    (``'whole'``) at each precision: in one block exactly where the port's
    form holds a trial in one block, else as the cluster of the plan;
    under ``use_pallas=True`` the same route (JAX takes K1 there too).
    AMP_PALLAS_MODE=periter skips K1 (QPSK's K = 4 then leaves K6 and the
    plain loop takes it)."""
    monkeypatch.delenv(VAR, raising=False)
    for batch in TRIALS:
        assert fused_bamp.jax_fits(cfg, batch)
        for precision, ctas in zip(("highest", "high", "default"), want):
            got = bamp.route_of(cfg, True, precision=precision, batch=batch)
            assert got == "whole", (batch, precision)
            assert fused_bamp.cluster_plan(cfg, precision).ctas == ctas
            assert (ctas == 1) == fused_bamp.fits(cfg, precision)
            assert bamp.route_of(cfg, True, precision=precision,
                                 use_pallas=True, batch=batch) == "whole"
    monkeypatch.setenv("AMP_PALLAS_MODE", "periter")
    assert bamp.route_of(cfg, True, precision="high", batch=4096) in (
        "periter", "plain")


@pytest.mark.parametrize("x", ["highest", "high", "default"])
def test_split_route_at_the_scamp_dims(monkeypatch, x):
    """Under the variable the SCAMP flagship's dimensions take K1's split
    form: in one block where it fits, else as a cluster; the route raises
    for none of them and leaves none to the plain version."""
    cfg = flagship_scamp()
    monkeypatch.setenv(VAR, x)
    for precision in ("highest", "high", "default"):
        xs = bamp.xmap_split(precision)
        got = bamp.route_of(cfg, True, precision=precision, batch=4096)
        plan = fused_bamp.cluster_plan(cfg, precision, xs)
        assert (plan.ctas == 1) == fused_bamp.fits(cfg, precision, xs)
        assert plan.ctas >= 1 and got == "whole", precision


# (name, alphabet, seed, SNR exponent, iterations) at Lin 33.  OOK at
# 'high' parts on T from JAX's K1 at seeds 0 and 1 (2 and 1 of 16 trials,
# each by one iteration; seeds 2-5 none, and BPSK and QPSK none at seeds
# 0-5): where a trial's variance sits at the allclose tolerance, the FP32
# order of the three-pass products' sums (the two packages' differ)
# decides its stop.  It does so at Lin 16 and 32 too, where the port's
# code is the one that ran before, and at 'highest' at Lin 33 (seed 0, one
# trial), about the 2.3% two correct HIGH decodes part on at the OOK
# flagship on the card (chip_smoke.py, BAMP_HIGH_SMALL_RULE's readings).
WIDE = [("ook", "OOK", 2, 1.2, 12), ("bpsk", "BPSK", 2, 1.3, 10),
        ("qpsk", "QPSK", 1, 1.5, 8)]


def _inputs(alphabet, seed, snr_exp, iterations):
    kw = dict(SMALL33, alphabet=alphabet, iterations=iterations)
    return shared_inputs(kw, seed, snr_exp, batch=16)


def _rule(st, ref, every=True):
    np.testing.assert_array_equal(st.T.numpy(), np.asarray(ref.T))
    done = ~st.active.numpy()
    for f in ("xmap", "xmmse", "var"):
        d = np.abs(getattr(st, f).numpy() - np.asarray(getattr(ref, f)))
        row = d.reshape(d.shape[0], -1).max(axis=1)
        assert float(row[done].max(initial=0.0)) < 1e-4, f
        if every:
            assert float(row.max()) < 1e-3, f


def _port(op, y, s2, cfg, precision):
    """The port's decode through its route (K1's form on the CPU: its
    plain version), with its state."""
    assert bamp.route(cfg, op, y.shape[0], "cpu", precision) == "whole"
    before = bamp.plain_decodes
    _, st = bamp.decode(op, y, s2, cfg, precision=precision,
                        return_state=True)
    assert bamp.plain_decodes == before + 1
    return st


@pytest.mark.parametrize("name,alphabet,seed,snr_exp,iterations", WIDE,
                         ids=[w[0] for w in WIDE])
def test_high_decode_matches_jax_k1_at_lin33(name, alphabet, seed, snr_exp,
                                             iterations):
    cfg, op, y, s2, jcfg, jop, jy = _inputs(alphabet, seed, snr_exp,
                                            iterations)
    assert jfb.FusedBandedDecode.fits(jcfg, 16) and cfg.Lin > 32
    ref = jbamp.decode(jop, jy, s2, jcfg, use_pallas=True, precision=HIGH)
    _rule(_port(op, y, s2, cfg, "high"), ref)


def test_default_decode_matches_jax_k1_at_lin33(monkeypatch):
    """At 'default' under the patched ``make_dot`` (XLA on the CPU would
    compute DEFAULT in float32)."""
    monkeypatch.setattr(jfb, "make_dot", patched_make_dot)
    cfg, op, y, s2, jcfg, jop, jy = _inputs("QPSK", 1, 1.5, 8)
    ref = jbamp.decode(jop, jy, s2, jcfg, use_pallas=True, precision=DEFAULT)
    _rule(_port(op, y, s2, cfg, "default"), ref, every=False)


def test_split_decode_matches_jax_k1_at_lin33(monkeypatch):
    """The split pair (high, default): the variable set for both packages;
    JAX's split differs from its form at 'high'."""
    monkeypatch.setattr(jfb, "make_dot", patched_make_dot)
    cfg, op, y, s2, jcfg, jop, jy = _inputs("OOK", 0, 1.2, 12)
    same = jbamp.decode(jop, jy, s2, jcfg, use_pallas=True, precision=HIGH)
    monkeypatch.setenv(VAR, "default")
    ref = jbamp.decode(jop, jy, s2, jcfg, use_pallas=True, precision=HIGH)
    assert not np.array_equal(np.asarray(ref.xmap), np.asarray(same.xmap))
    _rule(_port(op, y, s2, cfg, "high"), ref, every=False)
