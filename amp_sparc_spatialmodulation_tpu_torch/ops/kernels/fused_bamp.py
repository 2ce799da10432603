"""Whole-decode BAMP kernel (CUDA) with its wrapper and plain version.

Port of the JAX package's ``ops/pallas/fused_bamp.py::_decode_kernel``
(through ``FusedBandedDecode.decode_call``): the whole BAMP decode of a
batch on one banded operator — the four banded maps, Onsager, the
segmented softmax or Bernoulli-mixture denoiser, per-trial allclose,
freeze and ``T`` — with the iteration loop inside the kernel.  The CUDA
source is ``csrc/fused_bamp_decode.cu``: one thread block per trial, its
state in shared memory, so each trial stops at its own convergence; the
banded products run as register tiles that reuse each tap for several
column blocks.  Its cluster form (below) is the same source built into a
library of its own (``csrc/fused_bamp_cluster.cu``).

* :func:`whole_decode` is the wrapper.  On a CUDA tensor it launches the
  kernel (or raises); on a CPU tensor it runs :func:`decode_plain`.
* :func:`decode_plain` is the same function in plain PyTorch, built on
  the ported ``BandedOperator``, ``segmented_posterior`` and the
  ``bamp.decode`` loop.
* ``launches`` counts kernel launches of the HIGHEST form,
  ``launches_high`` those of the HIGH form, ``launches_default`` those of
  the DEFAULT form, ``launches_xmap`` those of the split forms, each with
  one block a trial; ``launches_cluster`` those of the cluster form (any
  form, a thread-block cluster a trial).

Both take ``precision``: ``'highest'`` (the default; FP32 products on the
CUDA cores, bit for bit the plain version's) or ``'high'``, the JAX
kernel's ``make_dot(Precision.HIGH)`` (`fused_bamp.py:184-185` there):
per-tap gains folded into the Gauss tap planes where every column block
shares them, each real product in three bf16 passes, on the tensor cores
in the kernel (the ``kHigh`` instance of the same source) and as
``bamp.plain_loop_high`` in the plain version (:func:`decode_plain_high`).
The HIGH kernel reads the eight Gauss tap planes split into bf16 hi and lo
and laid out as mma fragments (:func:`high_taps`, cached per operator),
and splits its x-side operands once, in shared memory, by the passes that
write them.  ``'default'`` is ``make_dot(Precision.DEFAULT)``, the one-pass
bf16 product: the ``kOne`` instance of the HIGH layout, which issues only
the hi·hi ``mma`` of each product, on the hi halves alone (the tap
fragments of :func:`default_taps`, the split operands' hi planes in a
region half the HIGH form's, :func:`split_parts`), with the HIGH form's
threads; ``bamp.plain_loop_default`` is its plain version
(:func:`decode_plain_default`).

The wrapper also takes ``x_precision``, the precision of the xmap chain
that ``AMP_KERNEL_XMAP_PRECISION`` sets in JAX's kernel (`fused_bamp.py:
990-991` there): where it differs from ``precision``, a split form runs
the HIGH form's function with the variance chain's products (``Pv`` and
``cov``, which feed the stop test) at ``precision`` and the xmap chain's
(the Gauss products of the forward pseudo-data and of the adjoint) at
``x_precision``: a chain at ``'high'`` or ``'default'`` on the tensor cores
as in those forms, a chain at ``'highest'`` in FP32 on the CUDA cores on
the FP32 tap planes of :func:`fp32_taps` (staged through the split planes
that chain leaves dead).  Its block is the HIGH form's (a form whose bf16
chain is 'default' reads :func:`default_taps` and splits hi halves only;
the mixed forms, one chain 'high' and the other 'default' (:func:`mixed`),
give each chain its own planes and tap fragments, :func:`chain_parts`);
its plain version is ``bamp.plain_loop_split`` (:func:`decode_plain_split`).

Both take and return a :class:`..models.bamp.BAMPState` in the JAX
layouts and are resumable: ``cap`` is the global iteration cap, and the
result's ``active``, ``T`` and ``t`` follow ``bamp.py:153-165``.

The cluster form.  Where one block's shared memory (227 KB) holds no
trial, the same kernel runs a trial on a thread-block cluster of 2, 4 or
8 blocks (:func:`cluster_plan`): each block holds a contiguous range of
the column blocks and the output rows of the same numbers (the last block
also the rows past Lin), laid out as a one-block trial of the largest
range; the forward products, the adjoint and the denoiser of a column
block are its block's own, and only the fold of the banded maps crosses
blocks, through the blocks' distributed shared memory, with cluster
barriers around it and at the stop test (an OR of the blocks' flags).  No
partition changes the order of a sum, so the cluster form gives the
one-block form's state and ``T`` bit for bit.

Dispatch (``models/bamp.py::route``): the kernel is the first link of the
decode chain, taken whenever :func:`covers` holds and :func:`fits` or
JAX's kernel would take the batch (:func:`jax_fits`), decided before any
launch (any number of column blocks): in one block where :func:`fits`
holds, else as a cluster; where no cluster of 8 blocks holds a trial, the
route runs the kernel's function as its plain version
(``'whole_plain'``: :data:`PLAIN`, :func:`decode_plain_split`); the
per-iteration kernels K6 and K5 and the plain loop take the rest.  A
failed build or launch raises (a cluster that cannot be resident too);
nothing falls back to the plain version after it.
"""
from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple

import numpy as np
import torch

from ...config import Config
from ...models import bamp
from .. import precision as prec
from . import build

# Kernel launches made by whole_decode with one block a trial: the HIGHEST
# form, the HIGH form, the DEFAULT form, the split forms (any of the six);
# and the launches of the cluster form (any form, a cluster a trial).
launches = 0
launches_high = 0
launches_default = 0
launches_xmap = 0
launches_cluster = 0
# The form code each launcher (K1, K3, K4, K5) takes for each precision.
FORM = {prec.HIGHEST: 0, prec.HIGH: 1, prec.DEFAULT: 2}

# Dynamic shared memory one Hopper block may use (227 KB).
SMEM_LIMIT = 232448
# Shared memory of one Hopper SM (228 KB), of which each resident block
# also holds 1 KB.
SM_SMEM = 233472
BLOCK_RESERVED = 1024
# The HIGH form's two blocks (csrc: kHighThreads1, kHighThreads2): 16
# warps where one block fills an SM, 8 warps where two fit.
HIGH_THREADS_ONE_BLOCK = 512
HIGH_THREADS_TWO_BLOCKS = 256

_TRUNC = {"trunc": 0, "tail": 1, "cyclic": 2}


def covers(cfg: Config) -> bool:
    """Can the kernel decode ``cfg`` at all?  Complex segmented/sparc
    alphabets (any K, any M) and the random generator mode — the JAX
    ``FusedBandedDecode.covers`` rule (`fused_bamp.py:954-963`)."""
    seg = (cfg.mode in ("segmented", "sparc") and cfg.is_complex
           and cfg.M > 0)
    mix = cfg.mode == "random" and cfg.is_complex
    return seg or mix


def real_x(cfg: Config) -> bool:
    """Real alphabets (every symbol's imaginary part 0): the posterior mean
    stays real, so the kernel carries no imaginary x-side state."""
    return bool(np.all(np.asarray(cfg.symbols).imag == 0))


def scratch_row(cfg: Config) -> int:
    """Floats per (column block, tap) row of the kernel's scratch planes:
    Nr rounded up to a multiple of 4, so each row starts on 16 bytes."""
    return -(-cfg.Nr // 4) * 4


def padded16(k: int) -> int:
    """A contraction length rounded up to the mma depth of 16."""
    return -(-int(k) // 16) * 16


def split_ld(k: int) -> int:
    """Row stride, in bf16, of a split operand whose rows hold ``k`` values
    of a contraction: ``k`` padded to 16 (the pad holds zeros), plus 8, so
    that the 32-bit words the eight rows of an mma fragment read fall on
    distinct shared-memory banks (the stride in words is 4 mod 8)."""
    return padded16(k) + 8


def high_split_elems(cfg: Config, cols=None) -> int:
    """bf16 of the HIGH form's split operands, in one region: the forward's
    x side (hi and lo of var and xm_re, and for a complex alphabet of xm_re
    + xm_im and xm_im: (Lin, split_ld(Nt)) each), and in the same place,
    once the forward has read it, the adjoint's inputs (hi and lo of the
    four Gauss operands: (Lin, split_ld(Lh*Nr)) each).  ``cols``: the
    column blocks a block holds (Lin where None; a block of a cluster its
    carve's, :func:`cluster_plan`)."""
    cols = cfg.Lin if cols is None else cols
    nx = 2 if real_x(cfg) else 4
    return max(2 * nx * cols * split_ld(cfg.Nt),
               8 * cols * split_ld(cfg.Lh * cfg.Nr))


def chains(precision: str = "highest", x_precision=None):
    """``(precision, x_precision)`` canonical: the variance chain's and the
    xmap chain's precision, the second ``precision``'s where None."""
    precision = prec.canonical(precision)
    return precision, (precision if x_precision is None
                       else prec.canonical(x_precision))


def high_layout(precision: str = "highest", x_precision=None) -> bool:
    """True for the forms on the HIGH layout: every form with a chain on
    the tensor cores (HIGH, DEFAULT and the split forms)."""
    return any(p in prec.BF16 for p in chains(precision, x_precision))


def split_parts(precision: str = "highest", x_precision=None) -> int:
    """Planes per split operand of a form on the HIGH layout: 2 (bf16 hi
    and lo) where a chain runs three passes, 1 (hi alone) where every bf16
    chain is 'default' (the DEFAULT form, the split forms of 'default' with
    'highest'), which also read :func:`default_taps`."""
    return 2 if prec.HIGH in chains(precision, x_precision) else 1


def mixed(precision: str = "highest", x_precision=None) -> bool:
    """The split forms with both chains on the tensor cores, one at 'high'
    (three passes), the other at 'default' (one): ``<3, 1>`` and ``<1,
    3>``.  Each chain's split operands have their own planes (hi and lo,
    or hi alone: :func:`chain_parts`) and each chain reads its own tap
    fragments (:func:`high_taps`, :func:`default_taps`)."""
    return set(chains(precision, x_precision)) == {prec.HIGH, prec.DEFAULT}


def chain_parts(precision: str = "highest", x_precision=None):
    """``(variance, xmap)``: the planes per split operand of each chain on
    the HIGH layout, 2 (hi and lo) for a chain of three passes, 1 (hi
    alone) for a chain of one in a mixed form (:func:`mixed`); every other
    form has :func:`split_parts` planes for every operand."""
    if mixed(precision, x_precision):
        return tuple(2 if c == prec.HIGH else 1
                     for c in chains(precision, x_precision))
    return (split_parts(precision, x_precision),) * 2


def smem_bytes(cfg: Config, precision: str = "highest",
               x_precision=None) -> int:
    """Dynamic shared memory of one block that holds a whole trial, passed
    to the launch: :func:`block_bytes` of all Lin column blocks and Lout
    output row blocks."""
    return block_bytes(cfg, cfg.Lin, cfg.Lout, precision, x_precision)


def block_bytes(cfg: Config, cols: int, rows: int,
                precision: str = "highest", x_precision=None) -> int:
    """Dynamic shared memory of a block that holds ``cols`` column blocks
    and ``rows`` output row blocks of a trial: 3 scratch planes of (cols,
    Lh, scratch_row) floats (the forward products, then the adjoint
    inputs), 4 x-side planes (5 for complex alphabets) of cols*Nt and 5
    y-side planes of rows*Nr float32, carved in that order by the kernel;
    on the HIGH layout (:func:`high_layout`) then the split operands
    (:func:`high_split_elems`; the DEFAULT form's hi planes alone, half of
    it; a mixed form the planes of :func:`chain_parts`, operand 0 the
    variance chain's, operands 1.. the xmap chain's; a split form with an
    FP32 chain keeps the HIGH form's region whole: that chain reads the
    FP32 planes, writes its adjoint inputs into the scratch planes and
    stages its taps through the split planes it leaves dead)."""
    fp32 = 4 * (3 * cols * cfg.Lh * scratch_row(cfg)
                + (4 if real_x(cfg) else 5) * cols * cfg.Nt
                + 5 * rows * cfg.Nr)
    if not high_layout(precision, x_precision):
        return fp32
    if mixed(precision, x_precision):
        pv, px = chain_parts(precision, x_precision)
        nx = 2 if real_x(cfg) else 4
        return fp32 + 2 * max(
            (pv + (nx - 1) * px) * cols * split_ld(cfg.Nt),
            (pv + 3 * px) * cols * split_ld(cfg.Lh * cfg.Nr))
    precision, x_precision = chains(precision, x_precision)
    region = 2 * high_split_elems(cfg, cols)
    if precision == x_precision:
        region = region * split_parts(precision) // 2
    return fp32 + region


def high_threads(cfg: Config, ctas: int = 1) -> int:
    """Threads of the block of every form on the HIGH layout for ``cfg``,
    by the HIGH form's carve-out: 8 warps where two blocks share an SM's
    shared memory (each still runs 128 registers a thread), else 16 warps
    in the one block an SM holds (the same registers, twice the warps to
    hide the latency of the products, the fold and the denoiser).  The
    DEFAULT form's smaller region gives neither flagship another block per
    SM (180,800 B at the QPSK flagship, still one; 82,880 B at the OOK
    one, still two), so it runs the HIGH form's block.  ``ctas``: the
    blocks of a cluster that holds one trial (:func:`cluster_plan`), each
    block judged by its own carve-out."""
    high = (smem_bytes(cfg, "high") if ctas == 1
            else _cluster_smem(cfg, ctas, "high"))
    two = 2 * (high + BLOCK_RESERVED) <= SM_SMEM
    return HIGH_THREADS_TWO_BLOCKS if two else HIGH_THREADS_ONE_BLOCK


def fits(cfg: Config, precision: str = "highest", x_precision=None) -> bool:
    """True when one trial's planes fit a block's shared memory, for the
    form of ``precision`` for the variance chain and ``x_precision`` (None:
    the same) for the xmap chain.  Any number of column blocks: a unit of
    the HIGH layout's products spans at most four n8 tiles of them, and a
    16-row tile takes as many units as it needs."""
    return smem_bytes(cfg, precision, x_precision) <= SMEM_LIMIT


# K1's cluster form: the cluster sizes it takes, smallest first (within
# the portable size of 8), and the bytes each block of a cluster keeps
# past its carve for the cluster's stop flags (one int per block).
CLUSTER_SIZES = (2, 4, 8)
CLUSTER_FLAG_BYTES = 32


class ClusterPlan(NamedTuple):
    """How K1 spreads one trial of a geometry over the blocks of a
    thread-block cluster (:func:`cluster_plan`).  ``ctas``: blocks a
    trial (1: one block, the forms that fit; 0: no cluster of 8 holds a
    trial).  Per block: ``cols`` its column blocks ``(c0, c1)``, ``rows``
    its output row blocks ``(r0, r1)``, ``bytes`` the dynamic shared
    memory of its own ranges.  ``smem``: the launch's dynamic shared
    memory, the carve of the largest ranges, which every block of the
    cluster lays out alike; ``threads``: the block's threads on the HIGH
    layout (0 off it)."""
    ctas: int
    cols: tuple
    rows: tuple
    bytes: tuple
    smem: int
    threads: int


def cluster_ranges(cfg: Config, ctas: int):
    """``(cols, rows)`` of the ``ctas`` blocks of a trial: block i holds
    column blocks ``i Lin // ctas`` up to the next block's first (sizes
    differ by one at most, the last block's is ``ceil(Lin / ctas)``, none
    is empty while ``ctas <= Lin``) and the output row blocks of the same
    numbers, the last block also the ``Lout - Lin`` rows past Lin (tail
    truncation's ``Lh - 1``).  The kernel computes the same ranges
    (``block_span`` in ``csrc/fused_bamp_decode.cu``)."""
    c0 = [i * cfg.Lin // ctas for i in range(ctas)] + [cfg.Lin]
    cols = tuple((c0[i], c0[i + 1]) for i in range(ctas))
    rows = tuple((a, cfg.Lout if i == ctas - 1 else b)
                 for i, (a, b) in enumerate(cols))
    return cols, rows


def _cluster_smem(cfg: Config, ctas: int, precision: str = "highest",
                  x_precision=None) -> int:
    """The launch's dynamic shared memory for clusters of ``ctas`` blocks:
    the carve of ceil(Lin / ctas) column blocks and as many output row
    blocks plus Lout - Lin (the last block's ranges, the largest), then
    the stop flags."""
    cols = -(-cfg.Lin // ctas)
    return (block_bytes(cfg, cols, cols + cfg.Lout - cfg.Lin, precision,
                        x_precision) + CLUSTER_FLAG_BYTES)


def cluster_plan(cfg: Config, precision: str = "highest", x_precision=None,
                 ctas=None) -> ClusterPlan:
    """How many blocks of a cluster hold one trial of ``cfg`` in the form
    of ``(precision, x_precision)``, and each block's ranges and bytes,
    with no launch: 1 where :func:`fits` holds; else the smallest of
    :data:`CLUSTER_SIZES` whose every block fits ``SMEM_LIMIT``; 0 where
    none does.  A cluster holds no more than Lin blocks, and a segmented
    trial only where its segments lie inside a column block (M divides
    Nt: a column block's denoiser is its block's own).  ``ctas`` forces a
    cluster size (for checks of the cluster form where one block would
    do); the plan then says 0 where a block of that size does not fit."""
    high = high_layout(precision, x_precision)

    def holds(c):
        if c == 1:
            return fits(cfg, precision, x_precision)
        return (c <= cfg.Lin
                and (cfg.mode == "random" or cfg.Nt % cfg.M == 0)
                and _cluster_smem(cfg, c, precision, x_precision)
                <= SMEM_LIMIT)

    if ctas is None:
        ctas = next((c for c in (1,) + CLUSTER_SIZES if holds(c)), 0)
    elif ctas not in (1,) + CLUSTER_SIZES:
        raise ValueError(f"clusters of {ctas} blocks: K1 takes 1, "
                         f"{', '.join(map(str, CLUSTER_SIZES))}")
    elif not holds(ctas):
        ctas = 0
    if ctas == 0:
        return ClusterPlan(0, (), (), (), 0, 0)
    cols, rows = cluster_ranges(cfg, ctas)
    flags = CLUSTER_FLAG_BYTES if ctas > 1 else 0
    nbytes = tuple(block_bytes(cfg, c1 - c0, r1 - r0, precision,
                               x_precision) + flags
                   for (c0, c1), (r0, r1) in zip(cols, rows))
    return ClusterPlan(ctas, cols, rows, nbytes, nbytes[-1],
                       high_threads(cfg, ctas) if high else 0)


# The JAX kernel's VMEM budget for a trial tile (`fused_bamp.py:735-772`
# there, ``_pick_tile``) and the trial tiles it tries, largest first.
JAX_VMEM_BUDGET = 11 * 1024 * 1024
JAX_TILES = (512, 256, 128, 64, 32, 16, 8)


def jax_fits(cfg: Config, batch: int) -> bool:
    """Where JAX takes its whole-decode kernel: ``FusedBandedDecode.fits(
    cfg, batch)`` (`fused_bamp.py:966-971` there), a copy of ``_pick_tile``'s
    arithmetic with ``n_x = 10 + 2K`` x-side and ``n_y = 9`` y-side planes:
    a trial tile of 512 down to 8 trials that divides ``batch`` and whose
    planes, lanes padded to 128 and double-buffered where the grid has more
    than one tile, stay under 11 MiB.  It does not read ``PALLAS_TILE``,
    the JAX package's tile experiment on a TPU."""
    lane = lambda d: -(-d // 128) * 128  # noqa: E731
    n_x, n_y = 10 + 2 * cfg.K, 9
    for tile in JAX_TILES:
        if batch % tile:
            continue
        xside = n_x * tile * cfg.Lin * lane(cfg.Nt) * 4
        yside = n_y * tile * cfg.Lout * lane(cfg.Nr) * 4
        mult = 1 if tile == batch else 2
        if mult * (xside + yside) < JAX_VMEM_BUDGET:
            return True
    return False


# The kernel's function in plain PyTorch (any device), with the wrapper's
# signature: the HIGHEST form, the HIGH form, the DEFAULT form.
decode_plain = bamp.plain_loop
decode_plain_high = bamp.plain_loop_high
decode_plain_default = bamp.plain_loop_default
PLAIN = {prec.HIGHEST: decode_plain, prec.HIGH: decode_plain_high,
         prec.DEFAULT: decode_plain_default}
# ... and of the split forms, with ``(precision, x_precision)`` after ``cfg``.
decode_plain_split = bamp.plain_loop_split


def mma_tiles(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The m16n8k16 A fragments of a (rows, K) plane split into ``hi`` and
    ``lo`` (rows and K padded with zeros to multiples of 16): per 16-row
    tile and k16 step, per lane (g = lane / 4, t = lane % 4) the 8 hi then
    the 8 lo bf16 of its fragment registers a0..a3 — rows g and g + 8,
    columns 2t, 2t + 1, then 2t + 8, 2t + 9 — so that a lane loads its
    fragment as two 16-byte words.  Shape (tiles, steps, 32, 2, 8)."""
    R, K = hi.shape
    Mt, Kt = -(-R // 16), -(-K // 16)
    pad = (0, Kt * 16 - K, 0, Mt * 16 - R)
    x = torch.stack([torch.nn.functional.pad(hi, pad),
                     torch.nn.functional.pad(lo, pad)])
    # (part, tile, row half, g, step, k half, t, pair)
    x = x.reshape(2, Mt, 2, 8, Kt, 2, 4, 2)
    # -> (tile, step, g, t, part, k half, row half, pair)
    return x.permute(1, 4, 3, 6, 0, 5, 2, 7).reshape(Mt, Kt, 32, 2, 8)


# Each live operator's HIGH tap fragments: built once, not on every call.
# An operator's entry goes with the operator.
_high_cache = weakref.WeakKeyDictionary()


def high_taps(op):
    """The HIGH kernel's taps of banded operator ``op``: the eight Gauss
    planes of ``bamp.gauss_taps`` as the A operands of the transposed
    products — the forward's ``S_a2, S_re, Im S - Re S, Re S + Im S``
    transposed to (Lh*Nr, Nt), the adjoint's ``S_a2^T, Re S^T, -Im S^T -
    Re S^T, Re S^T - Im S^T`` transposed to (Nt, Lh*Nr), the output along
    the rows — each split into bf16 hi and lo
    (``precision.split_bf16``) and laid out by :func:`mma_tiles`, one
    contiguous bf16 buffer in that order.  Returns ``(taps, folded)``."""
    if op not in _high_cache:
        t = bamp.gauss_taps(op)
        planes = (t.s_a2, t.s_re, t.dmc, t.cpd, t.st_a2, t.st_re, t.amc,
                  t.adm)
        tiles = [mma_tiles(*prec.split_bf16(x.T.contiguous())).reshape(-1)
                 for x in planes]
        _high_cache[op] = (torch.cat(tiles).contiguous(), t.folded)
    return _high_cache[op]


# Each live operator's FP32 tap planes for the split forms.
_fp32_cache = weakref.WeakKeyDictionary()


def fp32_taps(op) -> torch.Tensor:
    """The split forms' FP32 taps of banded operator ``op``: the eight
    Gauss planes of ``bamp.gauss_taps`` as they are, the forward's ``S_a2,
    S_re, Im S - Re S, Re S + Im S`` (Nt, Lh*Nr) then the adjoint's ``S_a2^T,
    Re S^T, -Im S^T - Re S^T, Re S^T - Im S^T`` (Lh*Nr, Nt), row-major, one
    contiguous float32 buffer in that order (cached per operator); a chain
    at 'highest' reads its products' planes from it."""
    if op not in _fp32_cache:
        t = bamp.gauss_taps(op)
        planes = (t.s_a2, t.s_re, t.dmc, t.cpd, t.st_a2, t.st_re, t.amc,
                  t.adm)
        _fp32_cache[op] = torch.cat([x.reshape(-1) for x in planes])
    return _fp32_cache[op]


# Each live operator's hi-only tap fragments for the one-pass forms.
_default_cache = weakref.WeakKeyDictionary()


def default_taps(op):
    """The one-pass forms' taps of banded operator ``op``: the hi halves of
    :func:`high_taps`' fragments alone, the same eight planes in the same
    order, per 16-row tile and k16 step the 8 hi bf16 of each lane's
    fragment (rows g and g + 8, columns 2t, 2t + 1, 2t + 8, 2t + 9), so a
    warp's k16 step is 512 contiguous bytes (shape per plane (tiles, steps,
    32, 8); cached per operator).  Read by the forms of
    :func:`split_parts` 1.  Returns ``(taps, folded)``, as
    :func:`high_taps`."""
    if op not in _default_cache:
        t = bamp.gauss_taps(op)
        planes = (t.s_a2, t.s_re, t.dmc, t.cpd, t.st_a2, t.st_re, t.amc,
                  t.adm)
        tiles = []
        for x in planes:
            hi, _ = prec.split_bf16(x.T.contiguous())
            tiles.append(mma_tiles(hi, torch.zeros_like(hi))[:, :, :, 0]
                         .reshape(-1))
        _default_cache[op] = (torch.cat(tiles).contiguous(), t.folded)
    return _default_cache[op]


def instance_taps(op, precision: str = "highest", x_precision=None):
    """``(taps, folded)``: the tap fragments the form's instance reads
    (:func:`default_taps` where :func:`split_parts` is 1, else
    :func:`high_taps`; a mixed form's one-pass chain reads
    :func:`default_taps` besides), and whether the gains are folded into
    them; None and False off the HIGH layout."""
    if not high_layout(precision, x_precision):
        return None, False
    if split_parts(precision, x_precision) == 1:
        return default_taps(op)
    return high_taps(op)


def _library(cluster: bool = False) -> ctypes.CDLL:
    """The kernel's library: the one-block instances, or the cluster form's
    (the same source built with ``K1_CLUSTER``, csrc/fused_bamp_cluster.cu),
    with the same C entry."""
    lib = build.load("fused_bamp_cluster" if cluster else "fused_bamp_decode")
    if not getattr(lib, "_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_bamp_decode.argtypes = (
            [ptr] * 23 + [i32] * 11 + [f32] * 3
            + [i32, i32, i32, i32, ptr, ptr, ptr, i32, i32, i32, ptr])
        lib.fused_bamp_decode.restype = i32
        lib.fused_bamp_error_string.argtypes = [i32]
        lib.fused_bamp_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if t.is_conj() or t.is_neg():
        raise ValueError(f"{name} is a lazily conjugated or negated view")


def symbol_planes(cfg: Config, device):
    """The symbol table as float32 real and imaginary planes on
    ``device``, as every kernel takes it."""
    syms = np.asarray(cfg.symbols)
    return (torch.as_tensor(syms.real.astype(np.float32), device=device),
            torch.as_tensor(syms.imag.astype(np.float32), device=device))


def whole_decode(op, s0: bamp.BAMPState, y: torch.Tensor, sigma2: float,
                 cap: int, cfg: Config, precision: str = "highest",
                 x_precision=None, ctas=None) -> bamp.BAMPState:
    """The whole decode of ``y`` from state ``s0`` up to global iteration
    ``cap``: the CUDA kernel for a CUDA tensor, :func:`decode_plain` (at
    ``'high'`` :func:`decode_plain_high`, at ``'default'``
    :func:`decode_plain_default`; with an ``x_precision`` other than
    ``precision``, :func:`decode_plain_split`) for a CPU tensor.  The
    caller has checked :func:`covers` for ``cfg`` and that
    :func:`cluster_plan` at ``precision`` and ``x_precision`` holds a trial
    (``bamp.decode`` does); on the card the form asked for is the form that
    runs, or the call raises.  Where one block holds no trial, the kernel
    runs as a cluster of the plan's blocks a trial (counted in
    ``launches_cluster``); ``ctas`` forces a cluster size where one block
    would do (checks of the cluster form), and is ignored on the CPU."""
    precision, x_precision = chains(precision, x_precision)
    split = x_precision != precision
    high = high_layout(precision, x_precision)
    if y.device.type == "cpu":
        if split:
            return decode_plain_split(op, s0, y, sigma2, cap, cfg, precision,
                                      x_precision)
        return PLAIN[precision](op, s0, y, sigma2, cap, cfg)
    if y.device.type != "cuda":
        raise ValueError(f"no kernel for device {y.device}")
    global launches, launches_high, launches_default, launches_xmap
    global launches_cluster
    B = y.shape[0]
    N, n = cfg.N, cfg.n
    dev = y.device
    c64, f32, i32 = torch.complex64, torch.float32, torch.int32
    _check("y", y, (B, n), c64, dev)
    _check("xmap", s0.xmap, (B, N), c64, dev)
    _check("xmmse", s0.xmmse, (B, N), c64, dev)
    _check("var", s0.var, (B, N), f32, dev)
    _check("z", s0.z, (B, n), c64, dev)
    _check("u", s0.u, (B, n), f32, dev)
    _check("h", op.h, (cfg.Lh, cfg.Nr, cfg.Nt), c64, dev)
    _check("gains", op.gains, (cfg.Lh, cfg.Lin), f32, dev)
    if (op.Lin, op.Lout, op.trunc) != (cfg.Lin, cfg.Lout, cfg.trunc):
        raise ValueError("operator geometry differs from the config")
    plan = cluster_plan(cfg, precision, x_precision, ctas)
    if plan.ctas == 0:
        raise ValueError(f"no cluster of {ctas or CLUSTER_SIZES[-1]} "
                         f"blocks holds a trial of this geometry at "
                         f"precision={precision!r}, "
                         f"x_precision={x_precision!r}")
    if B == 0:
        return s0
    act_in = s0.active.to(i32).contiguous()
    T_in = s0.T.to(i32).contiguous()
    out = bamp.BAMPState(
        xmap=torch.empty_like(s0.xmap), xmmse=torch.empty_like(s0.xmmse),
        var=torch.empty_like(s0.var), z=torch.empty_like(s0.z),
        u=torch.empty_like(s0.u), active=torch.empty_like(act_in),
        T=torch.empty_like(T_in), t=s0.t)
    hT = op.h.transpose(1, 2).contiguous()
    a2 = op.abs_h2.contiguous()
    a2T = a2.transpose(1, 2).contiguous()
    gains2 = op.gains2.contiguous()
    sym_re, sym_im = symbol_planes(cfg, dev)
    taps, folded = instance_taps(op, precision, x_precision)
    taps1 = (default_taps(op)[0] if mixed(precision, x_precision)
             else None)
    taps32 = (fp32_taps(op) if split and prec.HIGHEST in (precision,
                                                          x_precision)
              else None)
    cap_rem = max(int(cap) - int(s0.t), 0)
    lib = _library(plan.ctas > 1)
    rc = lib.fused_bamp_decode(
        y.data_ptr(), s0.xmap.data_ptr(), s0.xmmse.data_ptr(),
        s0.var.data_ptr(), s0.z.data_ptr(), s0.u.data_ptr(),
        act_in.data_ptr(), T_in.data_ptr(),
        out.xmap.data_ptr(), out.xmmse.data_ptr(), out.var.data_ptr(),
        out.z.data_ptr(), out.u.data_ptr(), out.active.data_ptr(),
        out.T.data_ptr(),
        op.h.data_ptr(), hT.data_ptr(), a2.data_ptr(), a2T.data_ptr(),
        op.gains.data_ptr(), gains2.data_ptr(),
        sym_re.data_ptr(), sym_im.data_ptr(),
        B, cfg.Nt, cfg.Nr, cfg.Lin, cfg.Lout, cfg.Lh, _TRUNC[cfg.trunc],
        cfg.M, cfg.K, 0 if cfg.mode in ("segmented", "sparc") else 1,
        int(real_x(cfg)), float(cfg.Ps), float(cfg.P0),
        float(np.float32(sigma2)), cap_rem,
        plan.smem, FORM[precision], FORM[x_precision],
        taps.data_ptr() if high else None,
        None if taps32 is None else taps32.data_ptr(),
        None if taps1 is None else taps1.data_ptr(), int(folded),
        plan.threads, plan.ctas, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("fused_bamp_decode launch failed: "
                           + lib.fused_bamp_error_string(rc).decode())
    if plan.ctas > 1:
        launches_cluster += 1
    elif split:
        launches_xmap += 1
    elif precision == prec.DEFAULT:
        launches_default += 1
    elif high:
        launches_high += 1
    else:
        launches += 1
    active = out.active > 0
    # Global counter semantics of the XLA loop (`bamp.py:156-159`): ran to
    # cap if any trial is still active, else stopped when the slowest
    # trial froze.
    t = max(int(s0.t), int(cap) if bool(active.any())
            else int(out.T.max()))
    return out._replace(active=active, t=t)
