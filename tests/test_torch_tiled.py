"""The plain version of the port's frame-tiled iteration kernel K5
(``ops/kernels/fused_bamp_tiled.py::iteration_plain``, the function the CUDA
kernel computes) and the decode chain of ``models/bamp.py::route`` against
the JAX package: its frame-tiled Pallas kernel in interpret mode
(``TiledBandedIteration``) and its XLA decode, on shared inputs drawn by the
JAX package.  One step: values within 1e-5 (the kernels sum their products
in other orders), ``notok`` equal.  A whole decode: the rule of
``tests/test_pallas_tiled.py:55-58`` against the JAX kernel, T identical
against the XLA decode.  The CUDA kernel itself is checked against this
plain version on the card by ``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu.config import Config as JConfig
from amp_sparc_spatialmodulation_tpu.config import massive_mimo as jmassive
from amp_sparc_spatialmodulation_tpu.models import bamp as jbamp
from amp_sparc_spatialmodulation_tpu.ops import channel as jchannel
from amp_sparc_spatialmodulation_tpu.ops import message as jmessage
from amp_sparc_spatialmodulation_tpu.ops import operators as joperators
from amp_sparc_spatialmodulation_tpu.ops.pallas.fused_bamp_tiled import (
    TiledBandedIteration)
from amp_sparc_spatialmodulation_tpu_torch import config as tconfig
from amp_sparc_spatialmodulation_tpu_torch import interop
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
from amp_sparc_spatialmodulation_tpu_torch.ops import operators
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
    fused_bamp, fused_bamp_iteration, fused_bamp_tiled)
from amp_sparc_spatialmodulation_tpu_torch.utils.device import make_generator

from test_torch_fused_bamp import GEOMETRIES, shared_inputs

# (Lin, Lh, F) of tests/test_pallas_tiled.py:30: multi-tile frames, a
# frame-sized tile, a halo spanning the whole tile
TILES = [(8, 3, 4), (8, 3, 8), (12, 5, 4)]


def shared(Lin=8, Lh=3, B=16, snr_exp=0.8, seed=0, **kw):
    """A realization drawn by the JAX package (tests/test_pallas_tiled.py:
    17-27), carried over through NumPy: (port config, port operator, y,
    sigma2, JAX config, JAX operator, JAX y)."""
    base = dict(Nt=16, Na=4, Nr=10, Lin=Lin, Lh=Lh, mode="segmented",
                alphabet="OOK", profile="uniform", trunc="tail",
                iterations=30)
    base.update(kw)
    jcfg, cfg = JConfig(**base), Config(**base)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    _, jop = joperators.banded_sparc(k1, jcfg)
    msg = jmessage.generate_message(k2, jcfg, B)
    snr = 10 ** snr_exp
    jy = jop.apply(msg.x) + jchannel.awgn(k3, jcfg, snr, B)
    op = interop.operator_from_numpy(np.asarray(jop.h), np.asarray(jop.gains),
                                     cfg.Lin, cfg.Lout, cfg.trunc,
                                     device="cpu")
    return (cfg, op, torch.as_tensor(np.array(jy)), jcfg.sigma2(snr), jcfg,
            jop, jy)


def mid_state(cfg, op, y, s2, iters=2, frozen=(1, 6)):
    """The plain decode's state after ``iters`` iterations, with the
    trials ``frozen`` marked converged: a step from it exercises the freeze
    and notok counts that are not all N."""
    _, st = bamp.decode(op, y, s2, cfg, iter_cap=iters, return_state=True)
    active = st.active.clone()
    active[list(frozen)] = False
    return bamp.to_planes(st._replace(active=active))


def jax_planes(ps, cfg):
    x = lambda t: jnp.asarray(interop.plane_to_jax(t, cfg.Lin))
    yv = lambda t: jnp.asarray(interop.plane_to_jax(t, cfg.Lout))
    return (x(ps.xm_re), x(ps.xm_im), x(ps.var), yv(ps.z_re), yv(ps.z_im),
            yv(ps.u))


def assert_step_matches(out, ref, ps, cfg, tol=1e-5):
    """The port's IterOut against a JAX ``plane_call`` result: planes
    within ``tol`` (xmap on the active trials only: the JAX kernels leave a
    frozen trial's xmap to the loop), notok equal on the active trials."""
    (xmap_re, xmap_im, xn_re, xn_im, varn, zr, zi, un, notok) = ref
    act = ps.active.numpy()
    pairs = [("xm_re", xn_re, slice(None)), ("xm_im", xn_im, slice(None)),
             ("var", varn, slice(None)), ("z_re", zr, slice(None)),
             ("z_im", zi, slice(None)), ("u", un, slice(None)),
             ("xmap_re", xmap_re, act), ("xmap_im", xmap_im, act)]
    for name, want, rows in pairs:
        got = getattr(out, name).numpy()[rows]
        np.testing.assert_allclose(
            got, interop.plane_from_jax(want, "cpu").numpy()[rows],
            rtol=tol, atol=tol, err_msg=name)
    np.testing.assert_array_equal(out.notok.numpy()[act],
                                  interop.notok_from_jax(notok)[act])
    assert not out.notok.numpy()[~act].any()


@pytest.mark.parametrize("Lin,Lh,F", TILES)
def test_step_matches_jax_tiled_kernel(Lin, Lh, F):
    cfg, op, y, s2, jcfg, jop, jy = shared(Lin=Lin, Lh=Lh)
    ps = mid_state(cfg, op, y, s2)
    y_re, y_im = y.real.contiguous(), y.imag.contiguous()
    out = fused_bamp_tiled.iteration(op, ps, y_re, y_im, s2, cfg)
    tiled = TiledBandedIteration(jop, y.shape[0], interpret=True,
                                 symbols=jcfg.symbols, M=jcfg.M, F=F, tile=8)
    act = jnp.asarray(ps.active.numpy().astype(np.float32)[:, None])
    yp = lambda t: jnp.asarray(interop.plane_to_jax(t, cfg.Lout))
    ref = tiled.plane_call(jnp.float32(s2), *jax_planes(ps, cfg), yp(y_re),
                           yp(y_im), act=act)
    assert_step_matches(out, ref, ps, cfg)
    assert int(out.notok.numpy()[ps.active.numpy()].min()) > 0


def jax_initial(jy, s2, N):
    B, n = jy.shape
    return jbamp.BAMPState(
        xmap=jnp.zeros((B, N), jy.dtype), xmmse=jnp.zeros((B, N), jy.dtype),
        var=jnp.ones((B, N), jnp.float32), z=jy,
        u=jnp.full((B, n), float(s2), jnp.float32),
        active=jnp.ones((B,), bool), T=jnp.zeros((B,), jnp.int32),
        t=jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("Lin,Lh,F", TILES)
def test_plane_loop_matches_jax_tiled_kernel(Lin, Lh, F):
    """The port's plane-loop decode on K5's plain version against the JAX
    plane loop on the JAX tiled kernel, under tests/test_pallas_tiled.py's
    rule (dT <= 1, >= 90% exact, values within 1e-4)."""
    cfg, op, y, s2, jcfg, jop, jy = shared(Lin=Lin, Lh=Lh)
    s0 = bamp.initial_state(y, cfg.N, float(np.float32(s2)))
    port = fused_bamp_tiled.decode_plain(op, s0, y, s2, cfg.N_Layers, cfg)
    tiled = TiledBandedIteration(jop, y.shape[0], interpret=True,
                                 symbols=jcfg.symbols, M=jcfg.M, F=F, tile=8)
    ref = jbamp._fused_plane_loop(tiled, jax_initial(jy, s2, cfg.N), jy,
                                  jnp.float32(s2), cfg.N_Layers)
    dT = np.abs(port.T.numpy() - np.asarray(ref.T))
    assert dT.max() <= 1 and (dT == 0).mean() >= 0.9, dT
    for f in ("xmmse", "var"):
        d = np.abs(getattr(port, f).numpy() - np.asarray(getattr(ref, f)))
        assert float(d.max()) < 1e-4, f


def force_tiled(monkeypatch):
    """Make the whole-decode and per-iteration kernels decline, as they do
    at the massive geometry (where JAX's K1 finds no tile either), so that
    small geometries take K5."""
    monkeypatch.setattr(fused_bamp, "fits",
                        lambda cfg, precision="highest", x=None: False)
    monkeypatch.setattr(fused_bamp, "jax_fits", lambda cfg, batch: False)
    monkeypatch.setattr(fused_bamp_iteration, "fits", lambda cfg: False)


@pytest.mark.parametrize("geometry", ["ook_tail", "ook_m6"])
def test_tiled_route_decode_matches_jax_xla(monkeypatch, geometry):
    """``bamp.decode`` on the tiled route against the JAX XLA decode, on
    the OOK tail geometries of tests/test_torch_fused_bamp.py (M = 4 and a
    segment of 6): T identical, state within 1e-4 (the port's step is the
    plain loop's)."""
    force_tiled(monkeypatch)
    _, kw, seed, snr_exp = next(g for g in GEOMETRIES if g[0] == geometry)
    cfg, op, y, s2, jcfg, jop, jy = shared_inputs(kw, seed, snr_exp)
    assert bamp.route(cfg, op, y.shape[0], "cuda") == "tiled"
    calls = []
    real = fused_bamp_tiled.iteration
    monkeypatch.setattr(fused_bamp_tiled, "iteration",
                        lambda *a: calls.append(1) or real(*a))
    port = bamp.decode(op, y, s2, cfg)
    ref = jbamp.decode(jop, jy, s2, jcfg)
    assert len(calls) == int(port.T.max())
    np.testing.assert_array_equal(port.T.numpy(), np.asarray(ref.T))
    for f in ("xmap", "xmmse", "var"):
        d = np.abs(getattr(port, f).numpy() - np.asarray(getattr(ref, f)))
        assert float(d.max()) < 1e-4, f


def test_ragged_batch_takes_the_tiled_route(monkeypatch):
    """37 trials (no multiple of the JAX kernel's trial tile of 8) take K5,
    and its plane loop equals the plain loop bit for bit, split at 5 and
    resumed too."""
    force_tiled(monkeypatch)
    cfg, op, y, s2, *_ = shared(B=37, seed=3)
    assert bamp.route(cfg, op, 37, "cuda") == "tiled"
    s0 = bamp.initial_state(y, cfg.N, float(np.float32(s2)))
    want = bamp.plain_loop(op, s0, y, s2, cfg.N_Layers, cfg)
    part = fused_bamp_tiled.decode_plain(op, s0, y, s2, 5, cfg)
    got = fused_bamp_tiled.decode_plain(op, part, y, s2, cfg.N_Layers, cfg)
    assert part.t == 5 and got.t == want.t
    for f in bamp.BAMPState._fields[:-1]:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_two_phase_on_the_tiled_route(monkeypatch, tmp_path):
    """The two-phase simulator on the tiled route against a single-phase
    run on the default route (tests/test_pallas_tiled.py:83-104): the same
    trajectories, so the same sums."""
    cfg = Config(Nt=16, Na=4, Nr=10, Lin=8, Lh=3, mode="segmented",
                 alphabet="OOK", profile="uniform", trunc="tail",
                 iterations=30)
    ref = montecarlo.Simulator(cfg, out_root=str(tmp_path / "a"),
                               device="cpu").run_point(7.0, epochs=128,
                                                       res=32)
    force_tiled(monkeypatch)
    calls = []
    real = fused_bamp_tiled.iteration
    monkeypatch.setattr(fused_bamp_tiled, "iteration",
                        lambda *a: calls.append(a[1].var.shape[0])
                        or real(*a))
    out = montecarlo.Simulator(cfg, out_root=str(tmp_path / "b"),
                               two_phase=6, device="cpu"
                               ).run_point(7.0, epochs=128, res=32)
    assert calls and min(calls) < 32       # phase 2 ran on a gathered batch
    assert out == pytest.approx(ref, rel=1e-6, abs=1e-12)


def massive_op(cfg):
    return operators.banded_sparc(make_generator(torch.device("cpu"), 0),
                                  cfg)[1]


# (case, config changes, trials, AMP_PALLAS_MODE, route)
ROUTES = [
    ("massive", "massive", {}, 2048, None, "tiled"),
    ("massive_qpsk", "massive", dict(alphabet="QPSK"), 2048, None, "plain"),
    ("massive_trunc", "massive", dict(trunc="trunc"), 2048, None, "plain"),
    ("massive_ragged", "massive", {}, 37, None, "tiled"),
    ("massive_xla", "massive", {}, 2048, "xla", "plain"),
    ("flagship", "flagship", {}, 65536, None, "whole"),
    ("flagship_periter", "flagship", {}, 65536, "periter", "periter"),
    ("flagship_xla", "flagship", {}, 65536, "xla", "periter"),
    ("flagship_qpsk_periter", "flagship", dict(alphabet="QPSK"), 4096,
     "periter", "plain"),
    ("flagship_random", "flagship", dict(mode="random"), 4096, None,
     "whole"),
]


@pytest.mark.parametrize("name,base,kw,B,mode,want", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_route(monkeypatch, name, base, kw, B, mode, want):
    """``bamp.route`` on the card, decided without launching: the JAX
    chain of models/bamp.py:256-295, with its ``xla`` quirk (K6 is still
    taken for K=1 alphabets; only K1 and K5 are skipped)."""
    if mode is None:
        monkeypatch.delenv("AMP_PALLAS_MODE", raising=False)
    else:
        monkeypatch.setenv("AMP_PALLAS_MODE", mode)
    preset = (tconfig.massive_mimo if base == "massive"
              else tconfig.flagship_bamp_ook)
    cfg = dataclasses.replace(preset(), **kw)
    if cfg.mode == "random":
        op = operators.banded_toeplitz(make_generator(torch.device("cpu"), 0),
                                       cfg)
    else:
        op = massive_op(cfg)
    assert bamp.route(cfg, op, B, "cuda") == want


def test_route_refuses_dense_and_column_gains():
    """A dense matrix runs the plain loop; so does a tap-form operator whose
    gains vary by column block at the massive geometry."""
    cfg = tconfig.massive_mimo()
    op = massive_op(cfg)
    assert fused_bamp_tiled.covers(cfg, op)
    g = np.ones((cfg.Lh, cfg.Lin), np.float32)
    g[0, 3] = 0.5
    skewed = operators.BandedOperator(h=op.h, gains=g, Lin=cfg.Lin,
                                      Lout=cfg.Lout, trunc=cfg.trunc)
    assert not fused_bamp_tiled.covers(cfg, skewed)
    assert bamp.route(cfg, skewed, 8, "cuda") == "plain"
    small, sop, *_ = shared()
    assert bamp.route(small, sop.densify(), 8, "cuda") == "plain"
    with pytest.raises(ValueError):
        bamp.route(small, sop, 8, "meta")


@pytest.mark.parametrize("alphabet,trunc,mode,is_complex", [
    ("OOK", "tail", "segmented", True), ("BPSK", "tail", "sparc", True),
    ("QPSK", "tail", "segmented", True), ("OOK", "trunc", "segmented", True),
    ("OOK", "cyclic", "segmented", True), ("OOK", "tail", "random", True),
    ("BPSK", "tail", "segmented", False)])
def test_covers_matches_jax(alphabet, trunc, mode, is_complex):
    """K5's coverage is the JAX kernel's without its batch and frame-tile
    rules (TiledBandedIteration.covers, fused_bamp_tiled.py:212-230)."""
    base = dict(Nt=16, Na=4, Nr=10, Lin=8, Lh=3, mode=mode,
                alphabet=alphabet, trunc=trunc, is_complex=is_complex)
    assert fused_bamp_tiled.covers(Config(**base)) \
        == TiledBandedIteration.covers(JConfig(**base))


def test_cpu_tensors_take_the_plain_version():
    cfg, op, y, s2, *_ = shared()
    ps = mid_state(cfg, op, y, s2)
    before = fused_bamp_tiled.launches
    got = fused_bamp_tiled.iteration(op, ps, y.real.contiguous(),
                                     y.imag.contiguous(), s2, cfg)
    want = fused_bamp_tiled.iteration_plain(op, ps, y.real.contiguous(),
                                            y.imag.contiguous(), s2, cfg)
    assert fused_bamp_tiled.launches == before
    for f in bamp.IterOut._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    meta = y.real.contiguous().to("meta")
    with pytest.raises(ValueError):
        fused_bamp_tiled.iteration(op, ps, meta, meta, s2, cfg)


def test_massive_geometry_matches_jax_xla():
    """``config.massive_mimo()`` itself, 4 trials to cap 3 at Eb/N0 = 18 dB:
    the port's decode (the tiled route, on the CPU K5's plain version)
    against the JAX XLA decode on shared inputs."""
    jcfg = dataclasses.replace(jmassive(), iterations=3)
    cfg = dataclasses.replace(tconfig.massive_mimo(), iterations=3)
    B, snr = 4, 10 ** ((18.0 + 10 * np.log10(cfg.code_rate)) / 10)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(4), 3)
    _, jop = joperators.banded_sparc(k1, jcfg)
    msg = jmessage.generate_message(k2, jcfg, B)
    jy = jop.apply(msg.x) + jchannel.awgn(k3, jcfg, snr, B)
    s2 = jcfg.sigma2(snr)
    op = interop.operator_from_numpy(np.asarray(jop.h), np.asarray(jop.gains),
                                     cfg.Lin, cfg.Lout, cfg.trunc,
                                     device="cpu")
    assert bamp.route(cfg, op, B, "cpu") == "tiled"
    port = bamp.decode(op, torch.as_tensor(np.array(jy)), s2, cfg)
    ref = jbamp.decode(jop, jy, s2, jcfg)
    np.testing.assert_array_equal(port.T.numpy(), np.asarray(ref.T))
    for f in ("xmap", "xmmse", "var"):
        d = np.abs(getattr(port, f).numpy() - np.asarray(getattr(ref, f)))
        assert float(d.max()) < 1e-4, f
