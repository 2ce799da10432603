"""K1's cluster form, held against the JAX package on the CPU.

Where one Hopper block's shared memory holds no trial and JAX's K1 takes
the batch (``fused_bamp.jax_fits``), the port runs K1 with one trial spread
over a thread-block cluster of 2, 4 or 8 blocks (``fused_bamp.cluster_plan``,
``csrc/fused_bamp_decode.cu``: each block its own column blocks, the fold
across blocks through distributed shared memory).  The card alone runs the
kernel (``chip_smoke.py``: ``kernel_cluster_bamp`` holds it to the
one-block form bit for bit, ``kernel_wide_bamp`` to the plain version at
the cluster geometries, ``main_bamp_wide`` drives it); here:

* ``cluster_plan`` over the three flagships' dimensions at Lin 20-66 in
  every form: the ranges cover the column blocks once, in order; every
  block fits a block's shared memory; one block exactly where ``fits``
  holds; the bytes at the SCAMP QPSK geometry and at QPSK Lin 48;
* the kernel's own index maps (``block_span``, ``owner_of``), mirrored:
  each block's span is the plan's, and the fold of every output row,
  spread over the blocks, reads and writes each slot of the one-block
  fold once, in the same tap order (tail, trunc and cyclic; halos that
  span several blocks);
* ``route`` on a CUDA device string takes K1 (``'whole'``) on every
  geometry where JAX's K1 takes the batch, at every precision and split
  pair; ``'whole_plain'`` is left only where no cluster of 8 holds a
  trial;
* one ``bamp.decode`` at the SCAMP QPSK geometry at 'high' (8 trials, cap
  2) against JAX's K1 in interpret mode: T identical, the state within
  the rule of ``tests/test_torch_bamp_high.py::
  test_plain_high_matches_jax_kernel``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu.models import bamp as jbamp
from amp_sparc_spatialmodulation_tpu_torch import interop
from amp_sparc_spatialmodulation_tpu_torch.config import (
    flagship_bamp_ook, flagship_bamp_qpsk, flagship_scamp)
from amp_sparc_spatialmodulation_tpu_torch.models import bamp
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp

from test_torch_fused_bamp import shared_inputs

VAR = "AMP_KERNEL_XMAP_PRECISION"
HIGH = jax.lax.Precision.HIGH
TRIALS = 65536
FLAGSHIPS = {"ook": flagship_bamp_ook, "qpsk": flagship_bamp_qpsk,
             "scamp": flagship_scamp}
PAIRS = (("highest", "high"), ("highest", "default"), ("high", "default"),
         ("high", "highest"), ("default", "high"), ("default", "highest"))
FORMS = (("highest", None), ("high", None), ("default", None)) + PAIRS
# The geometries where one block holds no trial of some form and JAX's K1
# takes 65536 trials: (flagship, Lin range).
WIDE = (("qpsk", range(27, 51)), ("scamp", range(33, 50)),
        ("ook", range(49, 67)))


@pytest.fixture(autouse=True)
def one_thread():
    """PyTorch on one thread, as in tests/test_torch_k1_wide.py: the test
    workers share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def form_id(form):
    v, x = form
    return v if x is None else f"{v}-{x}"


@pytest.mark.parametrize("form", FORMS, ids=[form_id(f) for f in FORMS])
@pytest.mark.parametrize("name", list(FLAGSHIPS))
def test_cluster_plan_covers_each_trial(name, form):
    v, x = form
    sizes = set()
    for lin in range(20, 67):
        cfg = dataclasses.replace(FLAGSHIPS[name](), Lin=lin)
        plan = fused_bamp.cluster_plan(cfg, v, x)
        assert (plan.ctas == 1) == fused_bamp.fits(cfg, v, x), lin
        sizes.add(plan.ctas)
        if plan.ctas == 0:
            continue
        assert plan.ctas in (1,) + fused_bamp.CLUSTER_SIZES
        # the smallest cluster whose blocks fit
        for c in fused_bamp.CLUSTER_SIZES:
            if c >= plan.ctas:
                break
            assert fused_bamp.cluster_plan(cfg, v, x, ctas=c).ctas == 0
        cols = [c for c0, c1 in plan.cols for c in range(c0, c1)]
        assert cols == list(range(lin))
        assert all(c1 > c0 for c0, c1 in plan.cols)
        assert [r0 for r0, _ in plan.rows] == [c0 for c0, _ in plan.cols]
        rows = [r for r0, r1 in plan.rows for r in range(r0, r1)]
        assert rows == list(range(cfg.Lout))
        sizes_c = [c1 - c0 for c0, c1 in plan.cols]
        assert max(sizes_c) - min(sizes_c) <= 1
        assert sizes_c[-1] == -(-lin // plan.ctas)
        assert all(b <= fused_bamp.SMEM_LIMIT for b in plan.bytes)
        assert plan.smem == max(plan.bytes)
        if plan.ctas == 1:
            assert plan.bytes == (fused_bamp.smem_bytes(cfg, v, x),)
        high = fused_bamp.high_layout(v, x)
        assert plan.threads in ((256, 512) if high else (0,))
    assert 1 in sizes


def test_cluster_plan_bytes():
    """The plans at the slice's geometries, as numbers: the SCAMP QPSK
    geometry (Lin 40) at 'high' and 'default', the QPSK dimensions at Lin
    48 at 'highest'; a block of a cluster adds its stop flags."""
    scamp = flagship_scamp()
    assert fused_bamp.smem_bytes(scamp, "high") == 284160
    assert fused_bamp.smem_bytes(scamp, "default") == 235520
    p = fused_bamp.cluster_plan(scamp, "high")
    assert p.ctas == 2 and p.cols == ((0, 20), (20, 40))
    assert p.rows == ((0, 20), (20, 48))
    assert p.bytes == (140832, 143392) and p.threads == 512
    assert fused_bamp.cluster_plan(scamp, "default").bytes == (116512,
                                                               119072)
    assert fused_bamp.cluster_plan(scamp).ctas == 1
    q48 = dataclasses.replace(flagship_bamp_qpsk(), Lin=48)
    p = fused_bamp.cluster_plan(q48)
    assert p.ctas == 2 and p.cols == ((0, 24), (24, 48))
    assert p.bytes == (132128, 135328) and p.threads == 0
    assert fused_bamp.smem_bytes(q48) == 4 * (3 * 48 * 6 * 32
                                              + 5 * 48 * 128 + 5 * 53 * 32)
    assert p.bytes[-1] == (4 * (3 * 24 * 6 * 32 + 5 * 24 * 128
                                + 5 * 29 * 32)
                           + fused_bamp.CLUSTER_FLAG_BYTES)


def test_forced_cluster_sizes():
    """``ctas`` forces a cluster where one block would do; a size K1 does
    not take raises, one whose blocks do not fit plans 0."""
    ook = flagship_bamp_ook()
    for c in (2, 4, 8):
        p = fused_bamp.cluster_plan(ook, "high", ctas=c)
        assert p.ctas == c and len(p.cols) == c
    assert fused_bamp.cluster_plan(ook, "high", ctas=1).ctas == 1
    with pytest.raises(ValueError):
        fused_bamp.cluster_plan(ook, "high", ctas=3)
    q50 = dataclasses.replace(flagship_bamp_qpsk(), Lin=50)
    assert fused_bamp.cluster_plan(q50, "high", ctas=1).ctas == 0
    assert fused_bamp.cluster_plan(q50, "high").ctas == 2
    # more blocks than column blocks: none
    small = dataclasses.replace(ook, Lin=3)
    assert fused_bamp.cluster_plan(small, ctas=4).ctas == 0


# The kernel's index maps, as written in csrc/fused_bamp_decode.cu.
def block_span(rank, C, Lin, Lout):
    c0, c1 = rank * Lin // C, (rank + 1) * Lin // C
    lc = (Lin + C - 1) // C
    return dict(c0=c0, nc=c1 - c0, r0=c0,
                nr=(Lout if rank == C - 1 else c1) - c0, lc=lc,
                rc=lc + Lout - Lin)


def owner_of(c, C, Lin):
    rank = ((c + 1) * C - 1) // Lin
    return rank, c - rank * Lin // C


def src_block(r, l, trunc, Lin):
    c = r - l
    if trunc == "cyclic":
        return c % Lin
    return c if 0 <= c < Lin else -1


@pytest.mark.parametrize("trunc", ["tail", "trunc", "cyclic"])
@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("Lin,Lh", [(8, 3), (20, 3), (25, 6), (40, 9),
                                    (11, 9)])
def test_cluster_fold_mirror(Lin, Lh, C, trunc):
    """The fold of every output row over the blocks of a cluster: each
    block's span is ``cluster_ranges``'; ``owner_of`` finds the block that
    holds each column block; the blocks' folds read every (c, l) slot the
    one-block fold reads, once, in the same order of l, at the slot's
    index in its own block (halos wider than a block included)."""
    Lout = Lin + Lh - 1 if trunc == "tail" else Lin
    cfg = dataclasses.replace(flagship_bamp_ook(), Lin=Lin, Lh=Lh,
                              trunc=trunc)
    assert cfg.Lout == Lout
    cols, rows = fused_bamp.cluster_ranges(cfg, C)
    spans = [block_span(i, C, Lin, Lout) for i in range(C)]
    assert [(s["c0"], s["c0"] + s["nc"]) for s in spans] == list(cols)
    assert [(s["r0"], s["r0"] + s["nr"]) for s in spans] == list(rows)
    for c in range(Lin):
        rank, q = owner_of(c, C, Lin)
        s = spans[rank]
        assert 0 <= q < s["nc"] <= s["lc"] and s["c0"] + q == c
    # each block's P slots, numbered by (c, l) in its own carve
    rng = np.random.default_rng(Lin * 100 + Lh * 10 + C)
    P = rng.standard_normal((Lin, Lh))
    blocks = [np.full((s["lc"], Lh), np.nan) for s in spans]
    for c in range(Lin):
        rank, q = owner_of(c, C, Lin)
        blocks[rank][q] = P[c]
    one, clustered, touched = [], [], np.zeros((Lin, Lh), int)
    for r in range(Lout):
        acc = 0.0
        for l in range(Lh):
            c = src_block(r, l, trunc, Lin)
            if c >= 0:
                acc = acc + P[c, l]
        one.append(acc)
    for s in spans:
        for rl in range(s["nr"]):
            r = s["r0"] + rl
            acc = 0.0
            for l in range(Lh):
                c = src_block(r, l, trunc, Lin)
                if c < 0:
                    continue
                rank, q = owner_of(c, C, Lin)
                acc = acc + blocks[rank][q, l]
                touched[c, l] += 1
            clustered.append(acc)
    assert clustered == one
    placed = np.array([[0 <= (c + l if trunc != "cyclic" else 0) < Lout
                        for l in range(Lh)] for c in range(Lin)])
    assert (touched == placed).all()


def _operator(cfg):
    rng = np.random.default_rng(0)
    h = (rng.standard_normal((cfg.Lh, cfg.Nr, cfg.Nt))
         + 1j * rng.standard_normal((cfg.Lh, cfg.Nr, cfg.Nt)))
    return interop.operator_from_numpy(
        h.astype(np.complex64), np.ones((cfg.Lh, cfg.Lin), np.float32),
        cfg.Lin, cfg.Lout, cfg.trunc, device="cpu")


@pytest.mark.parametrize("name,lins", WIDE, ids=[w[0] for w in WIDE])
def test_route_takes_the_cluster_form(monkeypatch, name, lins):
    """On a CUDA device, at 65536 trials, every geometry of the Motivation
    table takes K1 (``'whole'``) at every precision and under every split
    pair of the variable, wherever JAX's K1 takes the batch or one block
    holds the trial; none of them is left to the plain version."""
    seen = set()
    for lin in lins:
        cfg = dataclasses.replace(FLAGSHIPS[name](), Lin=lin)
        op = _operator(cfg)
        jax_k1 = fused_bamp.jax_fits(cfg, TRIALS)
        for v, x in FORMS:
            if x is None:
                monkeypatch.delenv(VAR, raising=False)
            else:
                monkeypatch.setenv(VAR, x)
            if not (jax_k1 or fused_bamp.fits(cfg, v)):
                continue
            plan = fused_bamp.cluster_plan(cfg, v, x)
            got = bamp.route(cfg, op, TRIALS, "cuda", v)
            assert got == ("whole" if plan.ctas else "whole_plain"), (lin,
                                                                      v, x)
            assert got == "whole", (lin, v, x)
            seen.add(plan.ctas)
    monkeypatch.delenv(VAR, raising=False)
    assert seen >= {1, 2}


def test_whole_plain_only_where_no_cluster_holds(monkeypatch):
    """``'whole_plain'`` stays, named, where JAX's K1 takes the batch and
    no cluster of 8 blocks holds a trial (here a plan made to say so)."""
    cfg = flagship_scamp()
    op = _operator(cfg)
    assert bamp.route(cfg, op, TRIALS, "cuda", "high") == "whole"
    real = fused_bamp.cluster_plan
    monkeypatch.setattr(
        fused_bamp, "cluster_plan",
        lambda c, p="highest", x=None, ctas=None: real(c, p, x, ctas)
        if fused_bamp.fits(c, p, x) else real(c, p, x, ctas)._replace(
            ctas=0))
    assert bamp.route(cfg, op, TRIALS, "cuda", "high") == "whole_plain"
    assert bamp.route(cfg, op, TRIALS, "cuda", "highest") == "whole"


def test_high_decode_at_the_scamp_geometry_matches_jax_k1():
    """``bamp.decode`` at 'high' on the SCAMP QPSK geometry (K1's cluster
    form on the card; on the CPU its plain version) against JAX's K1 in
    interpret mode on shared inputs: 8 trials, cap 2."""
    kw = {f.name: getattr(flagship_scamp(), f.name)
          for f in dataclasses.fields(flagship_scamp())}
    cfg, op, y, s2, jcfg, jop, jy = shared_inputs(kw, 7, 1.2, batch=8)
    assert fused_bamp.cluster_plan(cfg, "high").ctas == 2
    assert bamp.route(cfg, op, 8, "cpu", "high") == "whole"
    ref = jbamp.decode(jop, jy, s2, jcfg, use_pallas=True, precision=HIGH,
                       iter_cap=2)
    before = bamp.plain_decodes
    _, st = bamp.decode(op, y, s2, cfg, precision="high", iter_cap=2,
                        return_state=True)
    assert bamp.plain_decodes == before + 1
    np.testing.assert_array_equal(st.T.numpy(), np.asarray(ref.T))
    conv = ~st.active.numpy()
    for f in ("xmap", "xmmse", "var"):
        d = np.abs(getattr(st, f).numpy() - np.asarray(getattr(ref, f)))
        row = d.reshape(d.shape[0], -1).max(axis=1)
        assert float(row[conv].max(initial=0.0)) < 1e-4, f
        assert float(row.max()) < 1e-3, f
