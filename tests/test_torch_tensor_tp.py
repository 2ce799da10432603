"""The port's dense column split (``…_torch/parallel/tensor.py``) and
SV-domain VAMP (``…_torch/parallel/vamp_tp.py``) against the JAX
package's (``parallel/tensor.py``, ``parallel/vamp_tp.py`` under
``shard_map`` on the virtual CPU devices) on shared inputs, at k = 2 and 4:
per-trial T equal, the state within the tolerances of
tests/test_parallel.py:156-160 and :266-273.  The port's ranks are gloo
processes of tests/torch_dist_worker.py, spawned once for the module per
world size.  A trial whose T differs between JAX's own split and
single-device decodes sits on the knife edge of the 1e-5 stop; T is held
equal on every other trial (``_check_T``)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_dist_worker as worker
from amp_sparc_spatialmodulation_tpu.config import Config as JConfig
from amp_sparc_spatialmodulation_tpu.models import bamp as jbamp
from amp_sparc_spatialmodulation_tpu.models import vamp as jvamp
from amp_sparc_spatialmodulation_tpu.ops import channel as jchannel
from amp_sparc_spatialmodulation_tpu.parallel import mesh as jmesh
from amp_sparc_spatialmodulation_tpu.parallel import tensor as jtensor
from amp_sparc_spatialmodulation_tpu.parallel import vamp_tp as jvamp_tp

# tests/test_parallel.py:16-21, Lin=4 (:129, :238)
BASE = dict(Nt=16, Na=4, Nr=8, Lin=4, Lh=2, mode="segmented",
            iterations=20, alphabet="OOK", profile="uniform", trunc="tail")

CASES = []
for k in (2, 4):
    CASES += [
        dict(name=f"tensor-k{k}", world=k, task="tensor", cfg=BASE,
             snr=8.0, seed=3, B=3),
        dict(name=f"tensor-cyclic-k{k}", world=k, task="tensor",
             cfg=dict(BASE, trunc="cyclic", Lin=8), snr=10.0, seed=4, B=8),
        dict(name=f"vamp_tp-k{k}", world=k, task="vamp_tp",
             cfg=dict(BASE, iterations=15), snr=10.0, seed=5, B=3),
        dict(name=f"vamp_tp-qpsk-k{k}", world=k, task="vamp_tp",
             cfg=dict(BASE, iterations=15, alphabet="QPSK", Lin=8),
             snr=12.0, seed=6, B=8),
    ]
BY_NAME = {c["name"]: c for c in CASES}


def _inputs(case):
    """A dense SPARC matrix from NumPy taps, the message and the noise
    from NumPy (seed ``case['seed']``); for VAMP also JAX's SVD of A."""
    cfg = JConfig(**case["cfg"])
    rng = np.random.default_rng(case["seed"])
    B = case["B"]
    shape = (cfg.Lh, cfg.Nr, cfg.Nt)
    h = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
         / np.sqrt(2 * cfg.Na * cfg.Lin)).astype(np.complex64)
    W = jchannel.base_matrix(cfg)
    A = np.asarray(jchannel.dense_sparc_from_taps(jnp.asarray(h), W, cfg))
    symbols = np.asarray(cfg.symbols)
    ant = rng.integers(0, cfg.M, (B, cfg.L))
    sym = rng.integers(0, cfg.K, (B, cfg.L))
    x = np.zeros((B, cfg.L, cfg.M), np.complex64)
    np.put_along_axis(x, ant[..., None], symbols[sym][..., None], axis=2)
    x = x.reshape(B, cfg.N)
    snr = 10 ** (case["snr"] / 10)
    sigma2 = cfg.sigma2(snr)
    n = (B, cfg.n)
    noise = (np.sqrt(sigma2 / 2) * (rng.standard_normal(n)
                                    + 1j * rng.standard_normal(n)))
    y = np.asarray(jnp.asarray(x) @ jnp.asarray(A).T
                   + jnp.asarray(noise.astype(np.complex64)))
    out = dict(A=A, y=y, sigma2=np.float32(sigma2))
    if case["task"] == "vamp_tp":
        dec = jvamp.svd(jnp.asarray(A))
        out.update(U=np.asarray(dec.U), s=np.asarray(dec.s),
                   Vh=np.asarray(dec.Vh))
    return out


def _jax_decode(case, a):
    cfg = JConfig(**case["cfg"])
    k = case["world"]
    sigma2 = float(a["sigma2"])
    m = jmesh.make_mesh(trials=1, model=k, devices=jax.devices()[:k])
    if case["task"] == "tensor":
        def run(A_full, y_full):
            xmap, xmmse, _, T = jtensor.decode(
                jtensor.shard_columns(A_full, cfg), y_full, sigma2, cfg)
            return (jtensor.gather_columns(xmap),
                    jtensor.gather_columns(xmmse), T)

        args = (a["A"], a["y"])
        names = ("xmap", "xmmse", "T")
    else:
        def run(U, s, Vh, y_full):
            r, xmmse, _, T = jvamp_tp.decode(
                U, s, jtensor.shard_columns(Vh, cfg), y_full, sigma2, cfg)
            return (jtensor.gather_columns(r),
                    jtensor.gather_columns(xmmse), T)

        args = (a["U"], a["s"], a["Vh"], a["y"])
        names = ("r", "xmmse", "T")
    f = jax.jit(jax.shard_map(run, mesh=m, in_specs=(P(),) * len(args),
                              out_specs=(P(), P(), P()), check_vma=False))
    out = f(*(jnp.asarray(v) for v in args))
    ref = {n: np.asarray(v) for n, v in zip(names, out)}
    # JAX's single-device decode of the same inputs: where its T differs
    # from JAX's own split decode, the trial sits on the knife edge of the
    # 1e-5 stop and its T is not a property of the function
    if case["task"] == "tensor":
        single = jbamp.decode(jnp.asarray(a["A"]), jnp.asarray(a["y"]),
                              sigma2, cfg)
    else:
        dec = jvamp.svd(jnp.asarray(a["A"]))._replace(
            U=jnp.asarray(a["U"]), s=jnp.asarray(a["s"]),
            Vh=jnp.asarray(a["Vh"]))
        single = jvamp.decode(dec, jnp.asarray(a["y"]), sigma2, cfg)
    ref["T_single"] = np.asarray(single.T)
    return ref


def _check_T(ref, got):
    """T equal on every trial where JAX's split and single-device decodes
    agree, and at most one trial of a batch on the knife edge (JAX's own
    two decodes give 9 and 7 on vamp_tp-k2's trial 1, the port 10 to 12
    as the CPU's product library rounds); returns the stable trials."""
    stable = ref["T"] == ref["T_single"]
    assert (~stable).sum() <= 1, (ref["T"], ref["T_single"])
    np.testing.assert_array_equal(got["T"][stable], ref["T"][stable])
    return stable


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the port's ranks (worlds 2 and 4 at once), compute JAX's
    references meanwhile, and return both per case."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    tmp = str(tmp_path_factory.mktemp("tensor_tp"))
    inputs = {}
    for c in CASES:
        inputs[c["name"]] = _inputs(c)
        c["arrays"] = os.path.join(tmp, c["name"] + ".npz")
        np.savez(c["arrays"], **inputs[c["name"]])
    procs = {w: worker.spawn(CASES, w, tmp) for w in (2, 4)}
    try:
        refs = {c["name"]: _jax_decode(c, inputs[c["name"]]) for c in CASES}
    finally:
        for w, ps in procs.items():
            worker.wait(ps, tmp, w, timeout=240)
    return tmp, {c["name"]: (refs[c["name"]], worker.results(tmp, c["name"]))
                 for c in CASES}


@pytest.mark.parametrize("name", [c["name"] for c in CASES
                                  if c["task"] == "tensor"])
def test_tensor_decode_matches_jax(runs, name):
    """tests/test_parallel.py:156-160: T equal, xmmse within 2e-4, xmap
    within 2e-3."""
    ref, got = runs[1][name]
    assert got["T"].min() >= 1
    rows = _check_T(ref, got)
    np.testing.assert_allclose(got["xmmse"][rows], ref["xmmse"][rows],
                               atol=2e-4)
    np.testing.assert_allclose(got["xmap"][rows], ref["xmap"][rows],
                               atol=2e-3)


@pytest.mark.parametrize("name", [c["name"] for c in CASES
                                  if c["task"] == "vamp_tp"])
def test_vamp_tp_decode_matches_jax(runs, name):
    """tests/test_parallel.py:266-273: T equal, xmmse within 2e-4, the
    pseudo-data r within 2e-2 (it divides by 1 - alpha, alpha up to
    1 - 1e-5, so a change of summation order is amplified there)."""
    ref, got = runs[1][name]
    assert got["T"].min() >= 1
    rows = _check_T(ref, got)
    np.testing.assert_allclose(got["xmmse"][rows], ref["xmmse"][rows],
                               atol=2e-4)
    np.testing.assert_allclose(got["r"][rows], ref["r"][rows], atol=2e-2)


@pytest.mark.parametrize("k", [2, 4])
def test_every_rank_holds_the_same_result(runs, k):
    """The gathered columns and T are the same on every rank of the
    axis."""
    tmp = runs[0]
    for name in (f"tensor-k{k}", f"vamp_tp-k{k}"):
        r0 = worker.results(tmp, name, 0)
        for rank in range(1, k):
            rr = worker.results(tmp, name, rank)
            for f in r0:
                np.testing.assert_array_equal(rr[f], r0[f], err_msg=f)
