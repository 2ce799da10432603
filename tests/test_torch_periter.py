"""The plain versions of the port's per-iteration kernels K6 and K7
(``ops/kernels/fused_bamp_iteration.py``, the functions the CUDA kernels
compute) against the JAX package's Pallas per-iteration kernels in
interpret mode (``FusedBandedIteration``), on shared inputs drawn by the JAX
package (the geometries of ``tests/test_pallas.py``).  One step: values
within 1e-5 (the kernels sum their products in other orders and K6 forms
its softmax argument as ``2 x / cov``), ``notok`` equal.  K6's decode
through the plane loop: T identical to the JAX kernel's plane loop, state
within 1e-4.  The CUDA kernels are checked against these plain versions on
the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu.config import Config as JConfig
from amp_sparc_spatialmodulation_tpu.models import bamp as jbamp
from amp_sparc_spatialmodulation_tpu.ops.pallas.fused_bamp import (
    FusedBandedIteration)
from amp_sparc_spatialmodulation_tpu_torch import config as tconfig
from amp_sparc_spatialmodulation_tpu_torch import interop
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.models import bamp
from amp_sparc_spatialmodulation_tpu_torch.ops import denoise
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
    fused_bamp_iteration as fbi)

from test_torch_fused_bamp import shared_inputs
from test_torch_tiled import assert_step_matches, jax_planes, mid_state

B = 8
TRUNCS = ["tail", "trunc", "cyclic"]


def ook(trunc, batch=B):
    """tests/test_pallas.py:38-50: OOK, 12 iterations, SNR 10^1.2."""
    return shared_inputs(dict(alphabet="OOK", trunc=trunc, iterations=12),
                         0, 1.2, batch=batch)


@pytest.mark.parametrize("trunc", TRUNCS)
def test_fused_step_matches_jax_kernel(trunc):
    cfg, op, y, s2, jcfg, jop, jy = ook(trunc)
    ps = mid_state(cfg, op, y, s2, iters=2, frozen=(3,))
    y_re, y_im = y.real.contiguous(), y.imag.contiguous()
    out = fbi.iteration_fused(op, ps, y_re, y_im, s2, cfg)
    kern = FusedBandedIteration(jop, B, interpret=True, fuse_denoiser=True,
                                symbols=jcfg.symbols, M=jcfg.M)
    act = jnp.asarray(ps.active.numpy().astype(np.float32)[:, None])
    yp = lambda t: jnp.asarray(interop.plane_to_jax(t, cfg.Lout))
    ref = kern.plane_call(jnp.float32(s2), *jax_planes(ps, cfg), yp(y_re),
                          yp(y_im), act=act)
    assert_step_matches(out, ref, ps, cfg)


@pytest.mark.parametrize("trunc", TRUNCS)
def test_fused_decode_matches_jax_plane_loop(monkeypatch, trunc):
    """``bamp.decode`` with ``AMP_PALLAS_MODE=periter`` (the route to K6)
    against the JAX decode on the same route."""
    monkeypatch.setenv("AMP_PALLAS_MODE", "periter")
    cfg, op, y, s2, jcfg, jop, jy = ook(trunc)
    assert bamp.route(cfg, op, B, "cuda") == "periter"
    port = bamp.decode(op, y, s2, cfg)
    ref = jbamp.decode(jop, jy, s2, jcfg, use_pallas=True)
    np.testing.assert_array_equal(port.T.numpy(), np.asarray(ref.T))
    for f in ("xmap", "xmmse", "var"):
        d = np.abs(getattr(port, f).numpy() - np.asarray(getattr(ref, f)))
        assert float(d.max()) < 1e-4, f


@pytest.mark.parametrize("alphabet,snr_exp", [("QPSK", 1.5), ("8PSK", 1.6),
                                              ("OOK", 1.2)])
def test_linear_step_matches_jax_kernel(alphabet, snr_exp):
    """K7: the linear part of one iteration from a mid-decode state, in the
    decoder's layout, against ``FusedBandedIteration(fuse_denoiser=False)``."""
    cfg, op, y, s2, jcfg, jop, jy = shared_inputs(
        dict(alphabet=alphabet, trunc="tail", iterations=8), 0, snr_exp)
    _, st = bamp.decode(op, y, s2, cfg, iter_cap=2, return_state=True)
    got = fbi.iteration_linear(op, st.xmmse, st.var, st.z, st.u, y, s2, cfg)
    kern = FusedBandedIteration(jop, y.shape[0], interpret=True)
    j = lambda t: jnp.asarray(t.numpy())
    want = kern(j(st.xmmse), j(st.var), j(st.z), j(st.u), jy,
                jnp.float32(s2))
    for name, a, b in zip(("xmap", "cov", "z", "u"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_k1_closed_form_variance():
    """K6's denoiser: the K=1 posterior with var = |s0|^2 p (1 - p), equal
    to the decomposed variance up to rounding, and to the JAX kernel's
    ``_k1_denoiser`` formula (t = 2 Re(x conj(s0)) / cov, evaluated here in
    float64: the JAX function runs only inside a Pallas kernel); K > 1
    refuses the form."""
    rng = np.random.default_rng(0)
    r = (rng.normal(size=(3, 32)) + 1j * rng.normal(size=(3, 32))).astype(
        np.complex64)
    cov = rng.uniform(0.1, 0.5, (3, 32)).astype(np.float32)
    cfg = Config(Nt=16, Na=2, Nr=8, Lin=2, Lh=2, alphabet="OOK",
                 mode="segmented")
    den = bamp.make_k1_denoiser(cfg, torch.device("cpu"))
    m, v = den(torch.as_tensor(r), torch.as_tensor(cov))
    dm, dv = bamp.make_denoiser(cfg, torch.device("cpu"))(
        torch.as_tensor(r), torch.as_tensor(cov))
    np.testing.assert_allclose(v.numpy(), dv.numpy(), rtol=1e-5, atol=1e-7)
    assert torch.equal(m, dm)
    t = (2.0 * r.real.astype(np.float64) / cov).reshape(3, -1, cfg.M)
    eta = np.exp(t - t.max(axis=-1, keepdims=True))
    post = (eta / eta.sum(axis=-1, keepdims=True)).reshape(3, -1)
    np.testing.assert_allclose(m.real.numpy(), post, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), post * (1 - post), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError):
        denoise.segmented_posterior(
            torch.as_tensor(r), torch.as_tensor(cov),
            torch.as_tensor(np.array([1, -1], np.complex64)), L=16, M=2,
            halve_tau=True, variance="closed")


def test_xla_mode_still_takes_k6(monkeypatch):
    """The JAX quirk the port mirrors: ``AMP_PALLAS_MODE=xla`` skips only
    the whole-decode and tiled kernels, so a K=1 alphabet still decodes
    through K6 (models/bamp.py:266-288 of the JAX package).  The JAX decode
    under ``xla`` equals its decode under ``periter`` bit for bit, and the
    port routes both to K6."""
    cfg, op, y, s2, jcfg, jop, jy = ook("tail")
    out = {}
    for mode in ("xla", "periter"):
        monkeypatch.setenv("AMP_PALLAS_MODE", mode)
        assert bamp.route(cfg, op, B, "cuda") == "periter"
        out[mode] = jbamp.decode(jop, jy, s2, jcfg, use_pallas=True)
    monkeypatch.delenv("AMP_PALLAS_MODE")
    for f in ("xmap", "xmmse", "var", "T"):
        np.testing.assert_array_equal(np.asarray(getattr(out["xla"], f)),
                                      np.asarray(getattr(out["periter"], f)))


@pytest.mark.parametrize("alphabet", ["OOK", "BPSK", "QPSK", "8PSK"])
def test_covers_matches_jax_fuse_rule(alphabet):
    """K6 covers exactly the alphabets the JAX decoder fuses the denoiser
    for: K=1 with M a power of two (``FusedBandedIteration`` accepts them,
    refuses the others)."""
    base = dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, alphabet=alphabet,
                mode="segmented")
    cfg, jcfg = Config(**base), JConfig(**base)
    try:
        FusedBandedIteration(None, 8, fuse_denoiser=True,
                             symbols=jcfg.symbols, M=jcfg.M)
        jax_ok = True
    except ValueError:
        jax_ok = False
    except AttributeError:   # accepted the alphabet, then needed the operator
        jax_ok = True
    assert fbi.covers(cfg) == jax_ok
    assert not fbi.covers(Config(**{**base, "alphabet": "OOK", "Nt": 24}))


def test_fit_rule():
    flag = tconfig.flagship_bamp_ook()
    assert fbi.fits(flag)
    # 3 scratch planes of (Lin, Lh, 24) floats, 4 x-side, 5 y-side planes
    assert fbi.smem_bytes(flag) == 4 * (3 * 20 * 3 * 24 + 4 * 2560
                                        + 5 * 528)
    assert not fbi.fits(tconfig.massive_mimo())


def test_cpu_tensors_take_the_plain_versions():
    cfg, op, y, s2, *_ = ook("cyclic")
    ps = mid_state(cfg, op, y, s2, frozen=(0,))
    y_re, y_im = y.real.contiguous(), y.imag.contiguous()
    before = (fbi.fused_launches, fbi.linear_launches)
    got = fbi.iteration_fused(op, ps, y_re, y_im, s2, cfg)
    want = fbi.iteration_fused_plain(op, ps, y_re, y_im, s2, cfg)
    for f in bamp.IterOut._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    st = bamp.from_planes(ps)
    lin = fbi.iteration_linear(op, st.xmmse, st.var, st.z, st.u, y, s2, cfg)
    ref = fbi.linear_plain(op, st.xmmse, st.var, st.z, st.u, y, s2, cfg)
    assert all(torch.equal(a, b) for a, b in zip(lin, ref))
    assert (fbi.fused_launches, fbi.linear_launches) == before
    meta = y_re.to("meta")
    with pytest.raises(ValueError):
        fbi.iteration_fused(op, ps, meta, meta, s2, cfg)
    with pytest.raises(ValueError):
        fbi.iteration_linear(op, st.xmmse, st.var, st.z, st.u, y.to("meta"),
                             s2, cfg)
