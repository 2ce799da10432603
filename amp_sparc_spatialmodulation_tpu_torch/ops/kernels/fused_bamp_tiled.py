"""Frame-tiled BAMP iteration kernel K5 (CUDA) with its wrapper and plain
version.

Port of the JAX package's ``ops/pallas/fused_bamp_tiled.py::
_tiled_iteration_kernel`` (through ``TiledBandedIteration.plane_call``):
one BAMP iteration — the four banded maps, Onsager, the segmented softmax
denoiser, the freeze and the per-trial allclose count — for geometries
whose trial does not fit one block's shared memory (the massive-MIMO
config).  The CUDA source is ``csrc/fused_bamp_tiled.cu``: the state stays
in device memory, and one call is four launches (forward products; band
fold and Onsager; adjoint products; denoiser).  The products run on one
register-tiled engine in two forms: large tiles (64 of the batch's (trial,
column block) rows x 64 columns) where they fill the card, small ones (32
rows x 16 columns) where few trials are left (:func:`tile_forms`).  The
wrapper keeps each operator's tap planes, and a transposed copy for the
forward product, for as long as the operator lives.

* :func:`iteration` is the wrapper, driven by ``models/bamp.py::
  plane_loop``: :class:`..models.bamp.PlaneState` in, an
  :class:`..models.bamp.IterOut` out.  On a CUDA tensor it launches the
  kernel (or raises); on a CPU tensor it runs :func:`iteration_plain`.
* :func:`iteration_plain` is the same function in plain PyTorch: one
  ``bamp.step`` of the plain loop on the planes.  :func:`decode_plain` is
  the plane loop over it, which equals ``bamp.plain_loop``.
* ``launches`` counts wrapper calls that launched the HIGHEST form (one
  per iteration, each of four kernel launches), ``launches_high`` those
  that launched the HIGH form, ``launches_default`` those that launched
  the DEFAULT form.
* :func:`stage_ms` times the four launches of one call apart (the entry
  point's stage mask; at ``'high'`` also the split launch), for
  chip_smoke.py and the probe scripts.

Each takes ``precision``: ``'highest'`` (the default; FP32 products on the
CUDA cores, bit for bit one step of the plain loop) or ``'high'``, the JAX
kernel's ``make_dot(Precision.HIGH)`` (`fused_bamp_tiled.py:72` there):
the gains folded into the seven Gauss tap planes of a real x, each real
product in three bf16 passes, on the tensor cores in the kernel and as one
``bamp.step`` with ``bamp.linear_step_high`` in the plain version.  The
HIGH form takes both operands of its products split into bf16 hi and lo
in one tiled layout (:func:`split_at`, :func:`split_tiles`): the taps from
:func:`high_taps` (cached per operator), x and var from a split launch
(``SPLIT_STAGE``) or, where a call gets the x and var that the previous
call wrote (the plane loop's next iteration), from that call's denoiser,
which splits them as it writes them (:func:`kept_split`).  ``'default'``
is ``make_dot(Precision.DEFAULT)``, one bf16 pass per real product: the
HIGH form's launches and functions on hi halves alone, in a layout of
their own (:func:`split1_at`; ``split_tiles(..., 'default')``, the taps
from :func:`default_taps`), on a product engine of its own (persistent
blocks, one ring from tile to tile, :data:`FORMS_DEFAULT`), with one
``bamp.step`` with ``bamp.linear_step_high`` on ``precision.dot1`` as its
plain version.

Coverage (:func:`covers`): complex segmented/sparc configs with a real
alphabet (the posterior mean stays real, so the x-side imaginary state is
dropped, as on the TPU), tail truncation, and per-tap-constant gains (every
SPARC base matrix with tail truncation).  Unlike the JAX kernel it takes
any batch size and needs no frame tile dividing ``Lin``: the ragged trial
tile is masked.
"""
from __future__ import annotations

import ctypes
import weakref
from functools import partial

import numpy as np
import torch

from ...config import Config
from ...models import bamp
from ...ops import operators
from .. import precision as prec
from . import build
from .fused_bamp import FORM, _check, real_x, symbol_planes

# Wrapper calls that launched the kernel (one per iteration): the HIGHEST
# form, the HIGH form, the DEFAULT form.
launches = 0
launches_high = 0
launches_default = 0

# The kernel's two product forms (fused_bamp_tiled.cu), each taken by both
# products: block rows, block columns, contraction steps per ring slot and
# ring slots; those of the HIGH form (HighLarge, HighSmall): block rows,
# block columns, ring slots of two k16 steps; those of the DEFAULT form
# (DefaultLarge, DefaultLargeAdjoint, DefaultSmall): block rows, block
# columns, and per (form, forward) ring slots and split1_at tiles (two k16
# steps) of each operand a slot; the blocks per SM of each form's large
# one, which the form rule fills; and the SM count of the H100.
FORMS = {"large": (64, 64, 16, 3), "small": (32, 16, 16, 3)}
FORMS_HIGH = {"large": (128, 112, 3), "small": (32, 16, 3)}
FORMS_DEFAULT = {"large": (128, 112), "small": (32, 16)}
DEFAULT_RINGS = {("large", True): (3, 3), ("large", False): (3, 2),
                 ("small", True): (4, 1), ("small", False): (4, 1)}
PER_SM = {prec.HIGHEST: 2, prec.HIGH: 1, prec.DEFAULT: 1}
SMS = 132
# The HIGH form's split layout (split_at): rows of a trial-side tile, output
# columns of a tap tile, contraction steps of a tile, and the multiple of
# steps a plane's contraction is padded to (a ring slot's steps).
HIGH_ROWS, HIGH_COLS, HIGH_STEP, HIGH_SLOT_STEPS = 128, 112, 16, 2
# Stage mask bits of the entry point, the mask of a whole iteration, and the
# HIGH form's split of x and var (its first launch, left out where the
# previous call's denoiser wrote the split planes).
STAGES = {"forward": 1, "fold": 2, "adjoint": 4, "denoise": 8}
ALL_STAGES = sum(STAGES.values())
SPLIT_STAGE = 16


def covers(cfg: Config, op=None) -> bool:
    """Can the kernel decode ``cfg`` (and, when given, operator ``op``)?
    Complex segmented/sparc mode, a real alphabet, tail truncation
    (``TiledBandedIteration.covers``, `fused_bamp_tiled.py:212-230`), and
    for ``op`` a banded operator whose gains are constant per tap
    (`fused_bamp.py:865-883`)."""
    ok = (cfg.mode in ("segmented", "sparc") and cfg.is_complex
          and cfg.M > 0 and cfg.trunc == "tail" and real_x(cfg))
    if ok and op is not None:
        ok = isinstance(op, operators.BandedOperator) and gains_per_tap(op)
    return ok


def gains_per_tap(op) -> bool:
    """True when every column block shares each tap's gain."""
    g = op.gains
    return bool(g.numel() and torch.equal(g, g[:, :1].expand_as(g)))


def iteration_plain(op, ps: bamp.PlaneState, y_re, y_im, sigma2: float,
                    cfg: Config, precision: str = "highest") -> bamp.IterOut:
    """The kernel's function in plain PyTorch (any device): one
    ``bamp.step``, at ``'high'`` (``'default'``) with
    ``bamp.linear_step_high`` on ``bamp.gauss_taps`` for a real x and
    ``precision.dot3`` (``dot1``)."""
    linear = bamp.linear_step
    precision = prec.canonical(precision)
    if precision in prec.BF16:
        linear = partial(bamp.linear_step_high, taps=bamp.gauss_taps(op),
                         real_x=True, dot=prec.DOTS[precision][0])
    return bamp.step_planes(op, ps, y_re, y_im, sigma2,
                            bamp.make_denoiser(cfg, y_re.device), linear)


def decode_plain(op, s0: bamp.BAMPState, y, sigma2: float, cap: int,
                 cfg: Config, precision: str = "highest") -> bamp.BAMPState:
    """The plane-loop decode on the plain version (at ``'highest'`` equal
    to ``bamp.plain_loop``), with the signature of the other kernels'
    decode_plain."""
    return bamp.plane_loop(partial(iteration_plain, precision=precision),
                           op, s0, y, sigma2, cap, cfg)


def scratch_stride(cfg: Config) -> int:
    """Row stride of the six (B*Lin, Lh*Nr) scratch planes: Lh*Nr rounded
    up to a multiple of 4, so every row starts on 16 bytes (440 floats at
    the massive geometry).  The pad columns are never read into a sum."""
    return -(-cfg.Lh * cfg.Nr // 4) * 4


def tile_forms(B: int, Lin: int, W: int, Nt: int,
               precision: str = "highest") -> int:
    """The entry point's ``forms`` for ``B`` trials: bit 1 (forward, W
    output columns) and bit 2 (adjoint, Nt columns) are set where that
    product's large form would launch fewer blocks than it keeps on the
    H100 at once (two per SM; one per SM for the HIGH form at ``'high'``);
    it then runs in the small form (the DEFAULT form's blocks are
    persistent: the large form's tiles are shared out over that many)."""
    precision = prec.canonical(precision)
    table = {prec.HIGH: FORMS_HIGH, prec.DEFAULT: FORMS_DEFAULT}.get(
        precision, FORMS)
    BM, BN = table["large"][:2]
    forms = 0
    for bit, cols in ((1, W), (2, Nt)):
        if -(-B * Lin // BM) * -(-cols // BN) < PER_SM[precision] * SMS:
            forms |= bit
    return forms


def smem_bytes(forward: bool, small: bool, precision: str = "highest") -> int:
    """Dynamic shared memory of one product block: the ring's slots, each
    holding its contraction steps of the A planes (x, var; or the three
    adjoint inputs) as they lie, rows padded by 4 floats, and of the three
    tap planes (transposed for the forward).  At ``'high'`` a slot holds
    two k16 steps of one product's split operand tiles, 64 bytes a row (BM
    trial-side rows, BN tap rows); then two parks, a float per output of
    the block tile; then an 8-byte mbarrier per slot and, for the adjoint,
    one for its last epilogue's copies.  At ``'default'`` a slot holds T
    ``split1_at`` tiles of each operand (two k16 steps each, 64 bytes a
    row; :data:`DEFAULT_RINGS`), then one park (forward) or two, then a
    full and an empty mbarrier per slot."""
    form = "small" if small else "large"
    precision = prec.canonical(precision)
    if precision == prec.DEFAULT:
        BM, BN = FORMS_DEFAULT[form]
        S, T = DEFAULT_RINGS[(form, bool(forward))]
        parks = 1 if forward else 2
        return S * T * 64 * (BM + BN) + parks * 4 * BM * BN + 16 * S
    if precision in prec.BF16:
        BM, BN, S = FORMS_HIGH[form]
        ring = S * HIGH_SLOT_STEPS * 64 * (BM + BN)
        return ring + 2 * 4 * BM * BN + 8 * (S if forward else S + 1)
    BM, BN, D, S = FORMS[form]
    return 4 * S * ((2 if forward else 3) * BM * (D + 4) + 3 * D * BN)


def _library() -> ctypes.CDLL:
    return typed(build.load("fused_bamp_tiled"))


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``fused_bamp_tiled.cu``) with its entry points'
    argument and result types set."""
    if not getattr(lib, "_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_bamp_tiled_iteration.argtypes = (
            [ptr] * 33 + [i32] * 10 + [f32, i32] + [ptr] * 5)
        lib.fused_bamp_tiled_iteration.restype = i32
        lib.fused_bamp_tiled_smem.argtypes = [i32, i32, i32]
        lib.fused_bamp_tiled_smem.restype = i32
        lib.fused_bamp_tiled_error_string.argtypes = [i32]
        lib.fused_bamp_tiled_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def tap_planes(op):
    """The taps as the kernel takes them: Re h, Im h and |h|^2 as
    (Lh*Nr, Nt) float32 planes (row l*Nr + m holds h[l, m, :])."""
    W = op.Lh * op.Nr
    return (op.h.real.reshape(W, op.Nt).contiguous(),
            op.h.imag.reshape(W, op.Nt).contiguous(),
            op.abs_h2.reshape(W, op.Nt).contiguous())


# Each live operator's tap planes and squared gains, its HIGH and DEFAULT
# forms' split taps, and the symbol planes per (alphabet, device): built
# once, not on every call.  An operator's entry goes with the operator.
_operator_cache = weakref.WeakKeyDictionary()
_high_cache = weakref.WeakKeyDictionary()
_default_cache = weakref.WeakKeyDictionary()
_symbol_cache = {}


def split_at(steps: int, tile: int, R: int, k: int, h: int) -> int:
    """Where part ``h`` (0 hi, 1 lo) of element (row ``R``, contraction
    ``k``) of a split plane of ``steps`` k16 steps in tiles of ``tile`` rows
    lies, in bf16 (``fused_bamp_tiled.cu::split_at``): tile (R // tile,
    k // 16), 32 bf16 a row, chunk 2 h + (k % 16) // 8 of row r stored at
    16-byte position chunk ^ ((r // 2) % 4)."""
    r = R % tile
    chunk = (2 * h + (k % 16) // 8) ^ ((r >> 1) & 3)
    return ((R // tile * steps + k // 16) * tile + r) * 32 + chunk * 8 + k % 8


def split1_at(steps: int, tile: int, R: int, k: int) -> int:
    """Where the hi of element (row ``R``, contraction ``k``) of a DEFAULT
    split plane of ``steps`` k16 steps in tiles of ``tile`` rows lies, in
    bf16 (``fused_bamp_tiled.cu::split1_at``): tile (R // tile, k // 32),
    32 bf16 a row, chunk (k % 32) // 8 of row r stored at 16-byte position
    chunk ^ ((r // 2) % 4); :func:`split_at`'s layout with step 2 s + 1's hi
    where step 2 s's lo lies."""
    r = R % tile
    chunk = ((k % 32) // 8) ^ ((r >> 1) & 3)
    return ((R // tile * (steps // 2) + k // 32) * tile + r) * 32 \
        + chunk * 8 + k % 8


def split_steps(K: int) -> int:
    """The k16 steps of a split plane of contraction ``K``: a multiple of
    a ring slot's steps."""
    per = HIGH_STEP * HIGH_SLOT_STEPS
    return -(-int(K) // per) * HIGH_SLOT_STEPS


def split_tiles(m: torch.Tensor, tile: int,
                precision: str = "high") -> torch.Tensor:
    """A float32 matrix ``m`` (rows, K) in the HIGH form's split layout
    (:func:`split_at`): split into bf16 hi and lo
    (``precision.split_bf16``), rows padded to a multiple of ``tile`` and
    the contraction to :func:`split_steps` k16 steps with zeros, flat.  At
    ``'default'`` the hi halves alone in the DEFAULT form's layout
    (:func:`split1_at`), half the size."""
    rows, K = m.shape
    rt, ks = -(-rows // tile), split_steps(K)
    full = torch.zeros((rt * tile, ks * HIGH_STEP), dtype=torch.float32,
                       device=m.device)
    full[:rows, :K] = m
    if prec.canonical(precision) == prec.DEFAULT:
        ks //= 2
        chunks = full.bfloat16().reshape(rt, tile, ks, 4, 8)
    else:
        halves = [h.reshape(rt, tile, ks, 2, 8)
                  for h in prec.split_bf16(full)]
        chunks = torch.stack(halves, dim=3).reshape(rt, tile, ks, 4, 8)
    chunks = chunks.permute(0, 2, 1, 3, 4)            # (rt, ks, tile, 4, 8)
    r = torch.arange(tile, device=m.device)[:, None]
    stored = torch.arange(4, device=m.device)[None, :] ^ ((r >> 1) & 3)
    return chunks[:, :, r, stored, :].reshape(-1).contiguous()


def high_taps(op) -> torch.Tensor:
    """The HIGH form's taps of banded operator ``op`` (gains constant per
    tap): the seven Gauss planes of ``bamp.gauss_taps`` that a real x needs,
    the output columns along the rows and the contraction along the row —
    the forward's ``Re S, Im S - Re S, S_a2`` as (Lh*Nr, Nt), the adjoint's
    ``Re S^T, -Im S^T - Re S^T, Re S^T - Im S^T, S_a2^T`` as (Nt, Lh*Nr),
    each in its products' order —
    each in the split layout (:func:`split_tiles`, tiles of ``HIGH_COLS``
    output columns), one contiguous bf16 buffer."""
    return _split_taps(op, prec.HIGH, _high_cache)


def default_taps(op) -> torch.Tensor:
    """The DEFAULT form's taps of ``op``: the hi halves of
    :func:`high_taps`' seven planes, in the same order, in the DEFAULT
    layout (``split_tiles(..., 'default')``, tiles of ``HIGH_COLS`` output
    columns, zero pads), one contiguous bf16 buffer."""
    return _split_taps(op, prec.DEFAULT, _default_cache)


def _split_taps(op, precision: str, cache) -> torch.Tensor:
    if op not in cache:
        t = bamp.gauss_taps(op)
        if not t.folded:
            raise ValueError(f"the {precision.upper()} form of K5 needs "
                             "gains constant per tap")
        cache[op] = torch.cat([
            split_tiles(plane.T.contiguous(), HIGH_COLS, precision)
            for plane in (t.s_re, t.dmc, t.s_a2, t.st_re, t.amc, t.adm,
                          t.st_a2)])
    return cache[op]


def form_taps(op, precision: str) -> torch.Tensor:
    """The split taps the form of ``precision`` reads."""
    if prec.canonical(precision) == prec.DEFAULT:
        return default_taps(op)
    return high_taps(op)


def split_sizes(B: int, cfg: Config, precision: str = "high"):
    """The bf16 counts of the two split operand buffers of a HIGH call of
    ``B`` trials: the forward's (x, var) and the adjoint's four inputs, in
    tiles of ``HIGH_ROWS`` rows; half of each at ``'default'`` (hi
    alone)."""
    rt = -(-B * cfg.Lin // HIGH_ROWS)
    per_step = rt * HIGH_ROWS * 2 * HIGH_STEP
    if prec.canonical(precision) == prec.DEFAULT:
        per_step //= 2
    return (2 * per_step * split_steps(cfg.Nt),
            4 * per_step * split_steps(cfg.Lh * cfg.Nr))


def engine_bytes(B: int, cfg: Config, precision: str) -> dict:
    """The bytes the product ring of one call of ``B`` trials, all active,
    copies into shared memory at ``precision`` ('high' or 'default'), per
    product launch and operand: every tile copies, for each of its products
    and ring slots, its trial-side rows and tap rows of the slot (at 'high'
    two k16 steps of hi and lo, 128 bytes a row; at 'default' the hi of two
    steps, 64)."""
    precision = prec.canonical(precision)
    W = cfg.Lh * cfg.Nr
    forms = tile_forms(B, cfg.Lin, W, cfg.Nt, precision)
    table = FORMS_DEFAULT if precision == prec.DEFAULT else FORMS_HIGH
    row = 64 if precision == prec.DEFAULT else 128
    out = {}
    for name, bit, cols, K, products in (
            ("forward", 1, -(-W // 4) * 4, cfg.Nt, 3),
            ("adjoint", 2, cfg.Nt, W, 4)):
        BM, BN = table["small" if forms & bit else "large"][:2]
        slots = products * split_steps(K) // HIGH_SLOT_STEPS
        tiles = -(-B * cfg.Lin // BM) * -(-cols // BN)
        out[name] = {"trial_side": tiles * slots * BM * row,
                     "taps": tiles * slots * BN * row}
    return out


def transposed_tap_planes(op):
    """The taps for the forward product: Re h, Im h and |h|^2 as (Nt, Wp)
    float32 planes, column l*Nr + m holding h[l, m, :], the pad columns
    from Lh*Nr on zero."""
    W = op.Lh * op.Nr
    Wp = -(-W // 4) * 4
    out = []
    for t in tap_planes(op):
        tT = torch.zeros((op.Nt, Wp), dtype=t.dtype, device=t.device)
        tT[:, :W] = t.T
        out.append(tT)
    return out


def _operator_planes(op):
    """(h_re, h_im, h_a2, hT_re, hT_im, hT_a2, gains2) of ``op``, built at
    its first call."""
    if op not in _operator_cache:
        _operator_cache[op] = (*tap_planes(op), *transposed_tap_planes(op),
                               op.gains2.contiguous())
    return _operator_cache[op]


def _symbols(cfg: Config, dev):
    key = (tuple(np.asarray(cfg.symbols).tolist()), str(dev))
    if key not in _symbol_cache:
        _symbol_cache[key] = symbol_planes(cfg, dev)
    return _symbol_cache[key]


def _launch(op, ps: bamp.PlaneState, y_re, y_im, sigma2: float,
            cfg: Config, out: bamp.IterOut, scratch, cov,
            stages: int, precision: str = "highest", split=None,
            split_next=None) -> None:
    """Enqueue the stages ``stages`` of one iteration into ``out``, in the
    form of ``precision`` (at ``'high'`` on the split operand buffers
    ``split``; the denoiser also splits the new x and var into
    ``split_next`` where it is given)."""
    B = ps.var.shape[0]
    high = precision in prec.BF16
    act = ps.active.to(torch.int32).contiguous()
    *taps, gains2 = _operator_planes(op)
    taps_high = form_taps(op, precision) if high else None
    sym_re, sym_im = _symbols(cfg, y_re.device)
    W = cfg.Lh * cfg.Nr
    lib = _library()
    rc = lib.fused_bamp_tiled_iteration(
        ps.xm_re.data_ptr(), ps.var.data_ptr(), ps.z_re.data_ptr(),
        ps.z_im.data_ptr(), ps.u.data_ptr(), y_re.data_ptr(),
        y_im.data_ptr(), act.data_ptr(),
        out.xmap_re.data_ptr(), out.xmap_im.data_ptr(),
        out.xm_re.data_ptr(), out.var.data_ptr(), out.z_re.data_ptr(),
        out.z_im.data_ptr(), out.u.data_ptr(), out.notok.data_ptr(),
        *[t.data_ptr() for t in scratch], cov.data_ptr(),
        *[t.data_ptr() for t in taps],
        op.gains.data_ptr(), gains2.data_ptr(), sym_re.data_ptr(),
        sym_im.data_ptr(), B, cfg.Nt, cfg.Nr, cfg.Lin, cfg.Lh, cfg.M, cfg.K,
        scratch_stride(cfg), tile_forms(B, cfg.Lin, W, cfg.Nt, precision),
        stages, float(np.float32(sigma2)), FORM[precision],
        *([t.data_ptr() for t in (taps_high, *split)] if high
          else [None] * 3),
        split_next.data_ptr() if high and split_next is not None else None,
        torch.cuda.current_stream(y_re.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("fused_bamp_tiled_iteration launch failed: "
                           + lib.fused_bamp_tiled_error_string(rc).decode())


def _buffers(ps: bamp.PlaneState, cfg: Config):
    """The outputs, the six scratch planes (B*Lin, scratch_stride) and cov
    of one call (allocated per call, from PyTorch's caching allocator)."""
    B, dev = ps.var.shape[0], ps.var.device
    out = bamp.IterOut(
        xmap_re=torch.empty_like(ps.var), xmap_im=torch.empty_like(ps.var),
        xm_re=torch.empty_like(ps.var), xm_im=ps.xm_im,
        var=torch.empty_like(ps.var), z_re=torch.empty_like(ps.u),
        z_im=torch.empty_like(ps.u), u=torch.empty_like(ps.u),
        notok=torch.empty((B,), dtype=torch.int32, device=dev))
    scratch = [torch.empty((B * cfg.Lin, scratch_stride(cfg)),
                           dtype=torch.float32, device=dev)
               for _ in range(6)]
    return out, scratch, torch.empty_like(ps.var)


def _split_buffers(ps: bamp.PlaneState, cfg: Config, x_var=None,
                   precision: str = "high"):
    """The HIGH (or DEFAULT) form's two split operand buffers of one call
    (:func:`split_sizes`): ``x_var`` (the split planes a denoiser wrote)
    or a new one for the split launch, and the fold's."""
    sizes = split_sizes(ps.var.shape[0], cfg, precision)
    new = lambda n: torch.empty((n,), dtype=torch.bfloat16,
                                device=ps.var.device)
    return [new(sizes[0]) if x_var is None else x_var, new(sizes[1])]


def _check_call(op, ps: bamp.PlaneState, y_re, y_im, cfg: Config) -> None:
    B = ps.var.shape[0]
    N, n = cfg.N, cfg.n
    dev = y_re.device
    f32 = torch.float32
    for name in ("xm_re", "var"):
        _check(name, getattr(ps, name), (B, N), f32, dev)
    for name in ("z_re", "z_im", "u"):
        _check(name, getattr(ps, name), (B, n), f32, dev)
    _check("y_re", y_re, (B, n), f32, dev)
    _check("y_im", y_im, (B, n), f32, dev)
    _check("h", op.h, (cfg.Lh, cfg.Nr, cfg.Nt), torch.complex64, dev)
    _check("gains", op.gains, (cfg.Lh, cfg.Lin), f32, dev)
    if (op.Lin, op.Lout, op.trunc) != (cfg.Lin, cfg.Lout, cfg.trunc):
        raise ValueError("operator geometry differs from the config")
    if not covers(cfg):
        raise ValueError("the tiled kernel covers complex segmented/sparc "
                         "configs with a real alphabet and tail truncation")


def iteration(op, ps: bamp.PlaneState, y_re: torch.Tensor,
              y_im: torch.Tensor, sigma2: float, cfg: Config,
              precision: str = "highest") -> bamp.IterOut:
    """One iteration of the trials of ``ps`` at ``precision``: the CUDA
    kernel for CUDA tensors, :func:`iteration_plain` for CPU tensors.  The
    caller has checked :func:`covers` for ``cfg`` and ``op``
    (``bamp.route`` does); on the card the form asked for is the form that
    runs, or the call raises."""
    precision = prec.canonical(precision)
    if y_re.device.type == "cpu":
        return iteration_plain(op, ps, y_re, y_im, sigma2, cfg, precision)
    if y_re.device.type != "cuda":
        raise ValueError(f"no kernel for device {y_re.device}")
    global launches, launches_high, launches_default
    _check_call(op, ps, y_re, y_im, cfg)
    if ps.var.shape[0] == 0:
        return bamp.IterOut(ps.xmap_re, ps.xmap_im, ps.xm_re, ps.xm_im,
                            ps.var, ps.z_re, ps.z_im, ps.u,
                            torch.zeros((0,), dtype=torch.int32,
                                        device=y_re.device))
    out, scratch, cov = _buffers(ps, cfg)
    stages, split, split_next = ALL_STAGES, None, None
    if precision in prec.BF16:
        # the forward's split operands: those the previous call's denoiser
        # wrote where this call gets its x and var unchanged (the plane
        # loop's next iteration), else the split launch's
        kept = kept_split(ps, precision)
        split = _split_buffers(ps, cfg, kept, precision)
        if kept is None:
            stages |= SPLIT_STAGE
        split_next = torch.empty_like(split[0])
    _launch(op, ps, y_re, y_im, sigma2, cfg, out, scratch, cov, stages,
            precision, split, split_next)
    if precision in prec.BF16:
        out.xm_re._k5_split = (precision, split_next, out.var,
                               out.xm_re._version, out.var._version)
    if precision == prec.DEFAULT:
        launches_default += 1
    elif precision == prec.HIGH:
        launches_high += 1
    else:
        launches += 1
    return out


def kept_split(ps: bamp.PlaneState, precision: str = "high"):
    """The split x and var planes that the call at ``precision`` which
    wrote ``ps.xm_re`` and ``ps.var`` left on ``ps.xm_re``, where both are
    still those tensors, unmodified; else None (a new or gathered state, or
    one a call of the other form wrote, whose layout differs: the call
    splits them itself)."""
    kept = getattr(ps.xm_re, "_k5_split", None)
    if kept is None:
        return None
    form, buf, var, v_x, v_var = kept
    if (form == prec.canonical(precision) and var is ps.var
            and (v_x, v_var) == (ps.xm_re._version, ps.var._version)):
        return buf
    return None


def stage_ms(op, ps: bamp.PlaneState, y_re, y_im, sigma2: float,
             cfg: Config, reps: int = 10,
             precision: str = "highest") -> dict:
    """Milliseconds of each launch of one call on the trials of ``ps`` (CUDA
    tensors) in the form of ``precision`` (at ``'high'`` also the split
    launch), by CUDA events around ``reps`` launches of that stage alone,
    after one whole call that fills the scratch; and ``call``, all of them
    together (with the split).  Not counted in ``launches`` or
    ``launches_high``."""
    precision = prec.canonical(precision)
    _check_call(op, ps, y_re, y_im, cfg)
    out, scratch, cov = _buffers(ps, cfg)
    whole, stages, split = ALL_STAGES, list(STAGES.items()), None
    if precision in prec.BF16:
        split = _split_buffers(ps, cfg, None, precision)
        whole |= SPLIT_STAGE
        stages.insert(0, ("split", SPLIT_STAGE))
    times = {}
    for name, mask in [*stages, ("call", whole)]:
        _launch(op, ps, y_re, y_im, sigma2, cfg, out, scratch, cov, whole,
                precision, split)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            _launch(op, ps, y_re, y_im, sigma2, cfg, out, scratch, cov, mask,
                    precision, split)
        stop.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(stop) / reps
    return times
