"""The one-pass bf16 precision (``precision='default'``) against the JAX
package on the CPU, under a patched witness.

The witness: XLA on the CPU computes a product at ``Precision.DEFAULT`` in
float32 (``test_unpatched_jax_default_is_highest`` shows it: JAX's K1 at
DEFAULT gives HIGHEST's T and state bit for bit), so the unpatched JAX
package is no witness of the TPU's one-pass product.  For these tests only,
the TPU's function is put in its place without editing a JAX file:

* ``make_dot`` at DEFAULT in JAX's ``ops/pallas/fused_bamp``,
  ``fused_vamp``, ``fused_vamp2`` and ``fused_bamp_tiled`` (each imports
  the name) rounds both operands to bf16 (round to nearest even,
  ``astype(jnp.bfloat16)``) and multiplies them in float32: the TPU's
  ``_DOT1``.  The kernels' row sums, products with a ones column, follow.
* ``jnp.matmul`` at DEFAULT in JAX's ``ops/operators.py``,
  ``models/{scamp,vamp,vamp2,montecarlo}.py`` and ``parallel/sweep.py``
  goes through the same product, four real ones for a complex product
  (``ops/precision.py::matmul``'s form), as
  ``tests/test_torch_plain_high.py`` patches HIGH.

Rules: per-trial T identical; the state within 1e-4 on the trials that
stopped before the cap.  On trials that run to the cap the two parted by
up to 4.4e-3 (OOK trunc) and 1.9 (8PSK) in K1's decode: a last-bit
difference of FP32 summation order moves a bf16 rounding by a whole bf16
step, and trials that never settle amplify it; so they are held to no
state bound.  Every DEFAULT result differs from HIGHEST's, so the witness
is not vacuous.

The CUDA kernels' DEFAULT instances are held to these plain versions on
the card by ``chip_smoke.py`` (``kernels_bamp_default``,
``kernels_vamp_default``, ``kernels_tiled_default``).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu.models import bamp as jbamp
from amp_sparc_spatialmodulation_tpu.models import montecarlo as jmc
from amp_sparc_spatialmodulation_tpu.models import scamp as jscamp
from amp_sparc_spatialmodulation_tpu.models import vamp as jvamp
from amp_sparc_spatialmodulation_tpu.models import vamp2 as jvamp2
from amp_sparc_spatialmodulation_tpu.ops import operators as joperators
from amp_sparc_spatialmodulation_tpu.ops.pallas import fused_bamp as jfb
from amp_sparc_spatialmodulation_tpu.ops.pallas import (
    fused_bamp_tiled as jfbt)
from amp_sparc_spatialmodulation_tpu.ops.pallas import fused_vamp as jfv
from amp_sparc_spatialmodulation_tpu.ops.pallas import fused_vamp2 as jfv2
from amp_sparc_spatialmodulation_tpu.parallel import sweep as jpsweep
from amp_sparc_spatialmodulation_tpu_torch import cli
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.models import (bamp, montecarlo,
                                                          scamp, vamp, vamp2)
from amp_sparc_spatialmodulation_tpu_torch.ops import operators
from amp_sparc_spatialmodulation_tpu_torch.ops import precision as prec
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
    fused_bamp, fused_bamp_tiled, fused_vamp, fused_vamp2)
from amp_sparc_spatialmodulation_tpu_torch.parallel import sweep as psweep
from amp_sparc_spatialmodulation_tpu_torch.utils import metrics
from amp_sparc_spatialmodulation_tpu_torch.utils.device import make_generator

import test_torch_vamp
from test_torch_fused_bamp import GEOMETRIES, shared_inputs
from test_torch_plain_high import BASE, banded_inputs
from test_torch_tiled import (assert_step_matches, jax_initial, mid_state,
                              shared)
from test_torch_tiled_high import jax_step, y_side_err

DEFAULT = jax.lax.Precision.DEFAULT
HIGHEST = jax.lax.Precision.HIGHEST


@pytest.fixture(autouse=True)
def one_thread():
    """PyTorch on one thread, as in tests/test_torch_plain_high.py: the
    test workers share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _is_default(precision) -> bool:
    return precision in (DEFAULT, "default", "DEFAULT")


def jdot1(x, a):
    """The TPU's one-pass product: both operands rounded to bf16, the
    product in float32."""
    bf = lambda t: t.astype(jnp.bfloat16).astype(jnp.float32)
    return jnp.dot(bf(x), bf(a), precision=HIGHEST,
                   preferred_element_type=jnp.float32)


def patched_make_dot(precision):
    """JAX's ``make_dot`` with DEFAULT mapped to :func:`jdot1`."""
    if isinstance(precision, str):
        precision = jax.lax.Precision(precision)
    if precision == DEFAULT:
        return jdot1
    return ORIGINAL_MAKE_DOT(precision)


ORIGINAL_MAKE_DOT = jfb.make_dot


class DefaultJnp:
    """``jax.numpy`` whose ``matmul`` at DEFAULT is :func:`jdot1`: one for
    real operands, four for a complex product."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def matmul(a, b, precision=None, **kw):
        if not _is_default(precision):
            return jnp.matmul(a, b, precision=precision, **kw)
        if not (jnp.iscomplexobj(a) or jnp.iscomplexobj(b)):
            return jdot1(a, b)
        ar, ai, br, bi = jnp.real(a), jnp.imag(a), jnp.real(b), jnp.imag(b)
        return jax.lax.complex(jdot1(ar, br) - jdot1(ai, bi),
                               jdot1(ar, bi) + jdot1(ai, br))


@pytest.fixture
def witness(monkeypatch):
    for mod in (jfb, jfv, jfv2, jfbt):
        monkeypatch.setattr(mod, "make_dot", patched_make_dot)
    for mod in (joperators, jscamp, jvamp, jvamp2, jmc, jpsweep):
        monkeypatch.setattr(mod, "jnp", DefaultJnp())


def stopped_rule(port_T, ref_T, port, ref, active, fields, tol=1e-4):
    """T identical; the state planes ``fields`` within ``tol`` on the
    trials that stopped before the cap (``active`` False)."""
    np.testing.assert_array_equal(np.asarray(port_T), np.asarray(ref_T))
    done = ~np.asarray(active)
    for f in fields:
        d = np.abs(np.asarray(getattr(port, f)) - np.asarray(getattr(ref, f)))
        d = d.reshape(d.shape[0], -1).max(axis=1)
        assert float(d[done].max(initial=0.0)) < tol, f
    return int(done.sum())


# ---- (a) the witness is needed ------------------------------------------


def test_unpatched_jax_default_is_highest():
    """Without the patch, XLA on the CPU computes DEFAULT in float32: JAX's
    K1 at DEFAULT gives HIGHEST's decode bit for bit, and so does a
    product."""
    cfg, op, y, s2, jcfg, jop, jy = shared_inputs(GEOMETRIES[0][1], 0, 1.2)
    d = jbamp.decode(jop, jy, s2, jcfg, use_pallas=True, precision=DEFAULT)
    h = jbamp.decode(jop, jy, s2, jcfg, use_pallas=True, precision=HIGHEST)
    for f in ("T", "xmap", "var"):
        np.testing.assert_array_equal(np.asarray(getattr(d, f)),
                                      np.asarray(getattr(h, f)))
    x = np.random.default_rng(1).standard_normal((8, 40)).astype(np.float32)
    a = np.random.default_rng(2).standard_normal((40, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jnp.matmul(x, a, precision=DEFAULT)),
        np.asarray(jnp.matmul(x, a, precision=HIGHEST)))


# ---- (b) the product itself -----------------------------------------------


@pytest.mark.parametrize("shape", [(8, 100, 128), (33, 528, 17)])
def test_dot1_rowsum1_and_matmul_match_the_witness(shape):
    """``dot1`` within 1e-6 of the witness relative to the product's
    scale, and far from the float32 product; ``rowsum1`` is the witness's
    product with a ones column; ``matmul(..., 'default')`` of a complex
    product is four witness products."""
    m, k, n = shape
    rng = np.random.default_rng(k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    a = rng.standard_normal((k, n)).astype(np.float32)
    tx, ta = torch.from_numpy(x), torch.from_numpy(a)
    got = prec.dot1(tx, ta).numpy()
    ref = np.asarray(jdot1(jnp.asarray(x), jnp.asarray(a)))
    scale = np.abs(x) @ np.abs(a)
    assert float(np.max(np.abs(got - ref) / scale)) < 1e-6
    assert float(np.max(np.abs(got - x @ a) / scale)) > 1e-4
    assert float(np.max(np.abs(got - prec.dot3(tx, ta).numpy()) / scale)) \
        > 1e-4
    rs = prec.rowsum1(tx).numpy()
    jrs = np.asarray(jdot1(jnp.asarray(x), jnp.ones((k, 1), jnp.float32)))
    np.testing.assert_allclose(rs, jrs, rtol=1e-6,
                               atol=1e-6 * float(np.abs(x).sum(1).max()))
    z = (x + 1j * rng.standard_normal((m, k))).astype(np.complex64)
    u = (a[:, :n] - 1j * a[:, ::-1][:, :n]).astype(np.complex64)
    got = prec.matmul(torch.from_numpy(z), torch.from_numpy(u),
                      "default").numpy()
    ref = np.asarray(DefaultJnp.matmul(jnp.asarray(z), jnp.asarray(u),
                                       precision=DEFAULT))
    cscale = np.abs(z) @ np.abs(u)
    assert float(np.max(np.abs(got - ref) / cscale)) < 1e-6
    assert float(np.max(np.abs(got - z @ u) / cscale)) > 1e-4


# ---- (c) K1 ---------------------------------------------------------------


@pytest.mark.parametrize("name,kw,seed,snr_exp", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_k1_plain_default_matches_jax_kernel(witness, name, kw, seed,
                                             snr_exp):
    """K1's plain DEFAULT version (``fused_bamp.decode_plain_default``)
    against JAX's K1 at DEFAULT in interpret mode under the witness."""
    cfg, op, y, s2, jcfg, jop, jy = shared_inputs(kw, seed, snr_exp)
    ref = jbamp.decode(jop, jy, s2, jcfg, use_pallas=True, precision=DEFAULT)
    s0 = bamp.initial_state(y, cfg.N, float(np.float32(s2)))
    st = fused_bamp.decode_plain_default(op, s0, y, s2, cfg.N_Layers, cfg)
    stopped_rule(st.T, ref.T, st, ref, st.active, ("xmap", "xmmse", "var"))
    assert not torch.equal(st.xmap, fused_bamp.decode_plain(
        op, s0, y, s2, cfg.N_Layers, cfg).xmap)


# ---- (d) K3, K4 and K5 ------------------------------------------------------

VAMP_CASES = [("vamp", "ook", dict(), 1.5),
              ("vamp", "qpsk_cap30", dict(alphabet="QPSK", iterations=30),
               1.2),
              ("vamp2", "ook", dict(iterations=12), 1.5),
              ("vamp2", "qpsk_cap30", dict(alphabet="QPSK", iterations=30),
               1.2)]


@pytest.mark.parametrize("algo,name,kw,snr_exp", VAMP_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in VAMP_CASES])
def test_k3_k4_plain_default_match_jax_kernels(witness, algo, name, kw,
                                               snr_exp):
    """K3's and K4's plain DEFAULT versions against JAX's kernels at
    DEFAULT in interpret mode under the witness, on shared factors and
    y_tilde (formed at DEFAULT by the witness): the stopped rule, except
    where the port's own decode parts on T from itself with its sums in
    float64 (VAMP QPSK at cap 30: T 12 against 10 on one trial, 6 against
    6 on another where JAX stops at 5); there T agrees on >= 75% of the
    trials, |d mean T| within 2% of the cap, and the state within 1e-4 on
    the stopped trials whose T agrees."""
    cfg, dec, y, s2, jcfg, jdec, jy = test_torch_vamp.shared_inputs(
        kw, snr_exp)
    jmod, mod, kern = ((jvamp, vamp, fused_vamp) if algo == "vamp"
                       else (jvamp2, vamp2, fused_vamp2))
    ref = jmod.decode(jdec, jy, s2, jcfg, use_pallas=True, precision=DEFAULT)
    U, s, _ = jdec
    q = DefaultJnp.matmul(jy, jnp.conj(U), precision=DEFAULT)
    yt = torch.from_numpy(np.array(s[None, :] * q if algo == "vamp"
                                   else q / s[None, :].astype(jy.dtype)))
    s0 = mod.initial_state(y, cfg)
    st = kern.decode_plain(dec.Vh, dec.s ** 2, yt, s0, s2, cfg.N_Layers,
                           cfg, "default")
    assert not torch.equal(st.r, kern.decode_plain(
        dec.Vh, dec.s ** 2, yt, s0, s2, cfg.N_Layers, cfg).r)
    # the port's own decode with its one-pass sums taken in float64: where
    # it parts from the float32 one on T, the order of the float32 sums
    # decides some stops (r divides by 1 - alpha, and a last-bit change of
    # an operand moves its bf16 rounding by a whole step), and no sum order
    # is JAX's; there T is held to a share and to the parity rule
    monkeypatch = pytest.MonkeyPatch()
    monkeypatch.setitem(prec.DOTS, "default", (
        lambda x, a: (x.bfloat16().double() @ a.bfloat16().double()).float(),
        lambda x: x.bfloat16().double().sum(1, keepdim=True).float()))
    try:
        exact = kern.decode_plain(dec.Vh, dec.s ** 2, yt, s0, s2,
                                  cfg.N_Layers, cfg, "default")
    finally:
        monkeypatch.undo()
    if torch.equal(exact.T, st.T):
        stopped_rule(st.T, ref.T, st, ref, st.active, ("xmmse", "var"))
        return
    agree = st.T.numpy() == np.asarray(ref.T)
    assert agree.mean() >= 0.75
    assert abs(float(st.T.float().mean()) - float(np.mean(ref.T))) <= \
        0.02 * cfg.N_Layers
    done = agree & ~st.active.numpy()
    for f in ("xmmse", "var"):
        d = np.abs(getattr(st, f).numpy() - np.asarray(getattr(ref, f)))
        assert float(d.reshape(d.shape[0], -1).max(axis=1)[done].max(
            initial=0.0)) < 1e-4, f


@pytest.mark.parametrize("case", [(8, 3, 4, "OOK"), (12, 5, 4, "OOK"),
                                  (8, 3, 4, "BPSK")],
                         ids=["ook_8_3", "ook_12_5", "bpsk_8_3"])
def test_k5_plain_default_matches_jax_kernel(witness, case):
    """One step of K5's plain DEFAULT version from a shared state against
    JAX's frame-tiled kernel at DEFAULT in interpret mode under the witness
    (the y-side planes within 1e-6, the x side within 1e-5, as at HIGH),
    then the plane loops under the stopped rule."""
    lin, lh, F, alphabet = case
    cfg, op, y, s2, jcfg, jop, jy = shared(Lin=lin, Lh=lh, alphabet=alphabet)
    ps = mid_state(cfg, op, y, s2)
    y_re, y_im = y.real.contiguous(), y.imag.contiguous()
    out = fused_bamp_tiled.iteration(op, ps, y_re, y_im, s2, cfg, "default")
    ref = jax_step(jop, jcfg, ps, cfg, y, s2, F, DEFAULT)
    assert y_side_err(out, ref, cfg) <= 1e-6
    assert_step_matches(out, ref, ps, cfg, tol=1e-5)
    high = fused_bamp_tiled.iteration(op, ps, y_re, y_im, s2, cfg, "high")
    assert y_side_err(high, ref, cfg) > 1e-6
    s0 = bamp.initial_state(y, cfg.N, float(np.float32(s2)))
    port = fused_bamp_tiled.decode_plain(op, s0, y, s2, cfg.N_Layers, cfg,
                                         "default")
    tiled = jfbt.TiledBandedIteration(jop, y.shape[0], interpret=True,
                                      symbols=jcfg.symbols, M=jcfg.M, F=F,
                                      tile=8, precision=DEFAULT)
    jref = jbamp._fused_plane_loop(tiled, jax_initial(jy, s2, cfg.N), jy,
                                   jnp.float32(s2), cfg.N_Layers)
    stopped_rule(port.T, jref.T, port, jref, port.active, ("xmmse", "var"))


# ---- (e) the plain loops ---------------------------------------------------


def _jax_banded(jop):
    return joperators.BandedOperator(jop.h, jop.gains, jop.Lin, jop.Lout,
                                     jop.trunc, precision=DEFAULT)


@pytest.mark.parametrize("name,kw,seed,snr_exp,form", [
    ("dense_qpsk", dict(alphabet="QPSK", iterations=8), 0, 1.5, "dense"),
    ("qpsk_lin33", dict(alphabet="QPSK", Lin=33, iterations=8), 1, 1.5,
     "banded")], ids=["dense_qpsk", "qpsk_lin33"])
def test_bamp_plain_default_matches_xla_default(witness, name, kw, seed,
                                                snr_exp, form):
    """BAMP's plain loop at DEFAULT (a dense operator; Lin = 33, which K1's
    bf16 forms now hold, as JAX's K1 does, so the plain loop is asked for
    by use_pallas=False) against JAX's XLA decode at DEFAULT under the
    witness."""
    cfg, op, _, y, s2, jcfg, jop, jy = banded_inputs(kw, seed, snr_exp)
    H, jH = op, _jax_banded(jop)
    if form == "dense":
        H, jH = op.densify(), jop.densify()
    knob = False if name == "qpsk_lin33" else "auto"
    assert bamp.route(cfg, operators.as_operator(H), 8, "cpu",
                      "default") == ("plain" if knob else "whole")
    assert bamp.route(cfg, operators.as_operator(H), 8, "cpu", "default",
                      knob) == "plain"
    before = bamp.plain_decodes
    port, st = bamp.decode(H, y, s2, cfg, precision="default",
                           return_state=True, use_pallas=knob)
    assert bamp.plain_decodes == before + 1
    ref = jbamp.decode(jH, jy, s2, jcfg, precision=DEFAULT)
    stopped_rule(port.T, ref.T, port, ref, st.active,
                 ("xmap", "xmmse", "var"))
    assert not torch.equal(bamp.decode(H, y, s2, cfg).xmap, port.xmap)


def test_scamp_plain_default_matches_xla_default(witness):
    """SCAMP's plain loop at DEFAULT on a dense operator (the base-matrix
    products in one pass, ``scamp.base_product``) against JAX's XLA decode
    at DEFAULT under the witness; K2 keeps HIGHEST at DEFAULT."""
    cfg, op, W, y, s2, jcfg, jop, jy = banded_inputs(
        dict(mode="sparc", alphabet="OOK", iterations=30), 0, 1.5)
    A, jA = op.densify(), jop.densify()
    port, st = scamp.decode(W, A, y, s2, cfg, precision="default",
                            return_state=True)
    ref = jscamp.decode(jnp.asarray(W), jA, jy, s2, jcfg, precision=DEFAULT)
    stopped_rule(port.T, ref.T, port, ref, st.active,
                 ("xmap", "xmmse", "var"))
    assert not torch.equal(scamp.decode(W, A, y, s2, cfg).xmap, port.xmap)
    # the kernel's route at DEFAULT is its HIGHEST decode
    kern = scamp.decode(W, op, y, s2, cfg, precision="default")
    assert torch.equal(kern.xmap, scamp.decode(W, op, y, s2, cfg).xmap)
    a = torch.rand(16, 21, generator=torch.Generator().manual_seed(3))
    m = torch.rand(23, 21, generator=torch.Generator().manual_seed(4))
    assert torch.equal(scamp.base_product(a, m, "default"),
                       scamp.base_product(a.bfloat16().float(),
                                          m.bfloat16().float()))


@pytest.mark.parametrize("algo", ["vamp", "vamp2"])
def test_vamp_random_mode_plain_default_matches_xla_default(witness, algo):
    """VAMP and vamp2 in the random mode (no kernel covers it) at DEFAULT:
    the plain loop with its products at DEFAULT against JAX's XLA decode
    under the witness."""
    cfg, dec, y, s2, jcfg, jdec, jy = test_torch_vamp.shared_inputs(
        dict(alphabet="QPSK", mode="random"), 1.9)
    mod, jmod = (vamp, jvamp) if algo == "vamp" else (vamp2, jvamp2)
    port, st = mod.decode(dec, y, s2, cfg, precision="default",
                          return_state=True)
    ref = jmod.decode(jdec, jy, s2, jcfg, precision=DEFAULT)
    stopped_rule(port.T, ref.T, port, ref, st.active, ("xmmse", "var"))
    assert not torch.equal(mod.decode(dec, y, s2, cfg).xmap, port.xmap)


# ---- (f) and (g): the sweep engine, the CLI, the sharded path ------------

SWEEP = dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, mode="segmented",
             profile="uniform", alphabet="OOK", trunc="tail", iterations=10)


def test_simulator_default_and_auto(tmp_path):
    """'default' generates at DEFAULT and decodes through K1's DEFAULT form
    (its plain version here): the sums of a realization composed by hand;
    'auto' picks HIGH after a cap-pinned point, never DEFAULT."""
    cfg = Config(**SWEEP)
    kw = dict(algo="bamp", device="cpu", progress=lambda s: None,
              out_root=str(tmp_path), seed=4)
    ebn0, res = 5.0, 32
    got = montecarlo.Simulator(cfg, precision="default", **kw).run_point(
        ebn0, epochs=res, res=res)
    snr = 10 ** ((ebn0 + 10 * np.log10(cfg.code_rate)) / 10)
    r = montecarlo.generate_realization(
        make_generator(torch.device("cpu"), 4, 0, 0), cfg, "sparc", "banded",
        res, snr, "default")
    s0 = bamp.initial_state(r.y, cfg.N, r.sigma2)
    st = bamp.plain_loop_default(r.A, s0, r.y, r.sigma2, cfg.N_Layers, cfg)
    want = metrics.finalize(metrics.evaluate_sums(
        st.xmap, st.xmmse, r.msg, st.T, cfg), cfg)
    assert got == want
    assert got != montecarlo.Simulator(cfg, precision="high", **kw).run_point(
        ebn0, epochs=res, res=res)
    auto = montecarlo.Simulator(cfg, precision="auto", **kw)
    seen = {auto._effective_precision()}
    auto._last_meanT = float(cfg.N_Layers)
    seen.add(auto._effective_precision())
    assert seen == {"highest", "high"}


def test_cli_sweep_default_on_cpu(tmp_path):
    """``cli sweep --precision default --device cpu`` writes the per-SNR
    JSON; without ``--device`` the sweep wants the card."""
    args = ["sweep", "--algo", "bamp", "--Nt", "16", "--Na", "4", "--Nr",
            "8", "--Lin", "8", "--Lh", "3", "--iterations", "10", "--epochs",
            "32", "--res", "32", "--start", "7", "--final", "7",
            "--precision", "default", "--out", str(tmp_path)]
    assert cli.main(args + ["--device", "cpu"]) == 0
    with open(os.path.join(str(tmp_path), "BAMP", Config(**SWEEP).name,
                           "7.0.json")) as f:
        point = json.load(f)
    assert point["EbN0dB"] == 7.0 and 1.0 <= point["T"] <= 10.0
    if not torch.cuda.is_available():
        with pytest.raises(Exception):
            cli.main(args)


def test_sharded_simulator_world1_default_equals_simulator(tmp_path):
    """The world-1 ``ShardedSimulator`` at DEFAULT gives the
    ``Simulator``'s sums (each rank through the single-card realization
    functions)."""
    cfg = Config(**SWEEP)
    kw = dict(algo="bamp", device="cpu", progress=lambda s: None,
              out_root=str(tmp_path), seed=2, precision="default")
    want = montecarlo.Simulator(cfg, **kw).run_point(6.0, epochs=64, res=32)
    import gc

    import torch.distributed as dist

    from amp_sparc_spatialmodulation_tpu_torch.parallel import mesh as pmesh
    pmesh.initialize_distributed(device="cpu")
    try:
        sim = psweep.ShardedSimulator(cfg, mesh=pmesh.make_mesh(
            1, 1, device_type="cpu"), **kw)
        got = sim.run_point(6.0, epochs=64, res=32)
        del sim
    finally:
        dist.destroy_process_group()
        gc.collect()
    assert got == want
