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
  that launched the HIGH form.
* :func:`stage_ms` times the four launches of one call apart (the entry
  point's stage mask), for chip_smoke.py and the probe scripts.

Each takes ``precision``: ``'highest'`` (the default; FP32 products on the
CUDA cores, bit for bit one step of the plain loop) or ``'high'``, the JAX
kernel's ``make_dot(Precision.HIGH)`` (`fused_bamp_tiled.py:72` there):
the gains folded into the seven Gauss tap planes of a real x, each real
product in three bf16 passes, on the tensor cores in the kernel (its HIGH
form, on the split tap planes of :func:`high_taps`, cached per operator)
and as one ``bamp.step`` with ``bamp.linear_step_high`` in the plain
version.

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
from .fused_bamp import _check, real_x, symbol_planes

# Wrapper calls that launched the kernel (one per iteration): the HIGHEST
# form, the HIGH form.
launches = 0
launches_high = 0

# The kernel's two product forms (fused_bamp_tiled.cu), each taken by both
# products: block rows, block columns, contraction steps per ring slot and
# ring slots; those of the HIGH form (HighLarge, HighSmall); and the SM
# count of the H100, which the form rule fills.
FORMS = {"large": (64, 64, 16, 3), "small": (32, 16, 16, 3)}
FORMS_HIGH = {"large": (128, 64, 32, 3), "small": (32, 32, 32, 3)}
SMS = 132
# Stage mask bits of the entry point, and the mask of a whole iteration.
STAGES = {"forward": 1, "fold": 2, "adjoint": 4, "denoise": 8}
ALL_STAGES = sum(STAGES.values())


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
    ``bamp.step``, at ``'high'`` with ``bamp.linear_step_high`` on
    ``bamp.gauss_taps`` for a real x."""
    linear = bamp.linear_step
    if prec.canonical(precision) == prec.HIGH:
        linear = partial(bamp.linear_step_high, taps=bamp.gauss_taps(op),
                         real_x=True)
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
    product's large form (of the HIGH form at ``'high'``) would launch
    fewer than two blocks per SM of the H100; it then runs in the small
    form."""
    table = FORMS_HIGH if prec.canonical(precision) == prec.HIGH else FORMS
    BM, BN = table["large"][:2]
    forms = 0
    for bit, cols in ((1, W), (2, Nt)):
        if -(-B * Lin // BM) * -(-cols // BN) < 2 * SMS:
            forms |= bit
    return forms


def smem_bytes(forward: bool, small: bool, precision: str = "highest") -> int:
    """Dynamic shared memory of one product block: the ring's slots, each
    holding its contraction steps of the A planes (x, var; or the three
    adjoint inputs) as they lie, rows padded by 4 floats, and of the three
    tap planes (transposed for the forward).  At ``'high'`` a slot holds
    one product's A plane, rows padded by 8 floats, and its tap plane's hi
    and lo parts, bf16 rows padded by 8, for either product."""
    form = "small" if small else "large"
    if prec.canonical(precision) == prec.HIGH:
        BM, BN, D, S = FORMS_HIGH[form]
        return S * (4 * BM * (D + 8) + 2 * 2 * BN * (D + 8))
    BM, BN, D, S = FORMS[form]
    return 4 * S * ((2 if forward else 3) * BM * (D + 4) + 3 * D * BN)


def _library() -> ctypes.CDLL:
    lib = build.load("fused_bamp_tiled")
    if not getattr(lib, "_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_bamp_tiled_iteration.argtypes = (
            [ptr] * 33 + [i32] * 10 + [f32, i32, ptr, ptr])
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


# Each live operator's tap planes and squared gains, its HIGH form's split
# taps, and the symbol planes per (alphabet, device): built once, not on
# every call.  An operator's entry goes with the operator.
_operator_cache = weakref.WeakKeyDictionary()
_high_cache = weakref.WeakKeyDictionary()
_symbol_cache = {}


def pad8(k: int) -> int:
    """A row length rounded up to 8 bf16 (16 bytes)."""
    return -(-int(k) // 8) * 8


def high_taps(op) -> torch.Tensor:
    """The HIGH form's taps of banded operator ``op`` (gains constant per
    tap): the seven Gauss planes of ``bamp.gauss_taps`` that a real x needs,
    the output columns along the rows and the contraction contiguous — the
    forward's ``S_a2, Re S, Im S - Re S`` as (Lh*Nr, Nt), the adjoint's
    ``S_a2^T, Re S^T, -Im S^T - Re S^T, Re S^T - Im S^T`` as (Nt, Lh*Nr)
    — each split into bf16 hi and lo (``precision.split_bf16``), rows padded
    with zeros to :func:`pad8`, one contiguous bf16 buffer: per plane hi
    then lo, the forward's then the adjoint's."""
    if op not in _high_cache:
        t = bamp.gauss_taps(op)
        if not t.folded:
            raise ValueError("the HIGH form of K5 needs gains constant per "
                             "tap")
        parts = []
        for plane in (t.s_a2.T, t.s_re.T, t.dmc.T, t.st_a2.T, t.st_re.T,
                      t.amc.T, t.adm.T):
            rows, K = plane.shape
            for half in prec.split_bf16(plane.contiguous()):
                buf = torch.zeros((rows, pad8(K)), dtype=torch.bfloat16,
                                  device=plane.device)
                buf[:, :K] = half
                parts.append(buf.reshape(-1))
        _high_cache[op] = torch.cat(parts)
    return _high_cache[op]


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
            stages: int, precision: str = "highest") -> None:
    """Enqueue the stages ``stages`` of one iteration into ``out``, in the
    form of ``precision``."""
    B = ps.var.shape[0]
    high = precision == prec.HIGH
    act = ps.active.to(torch.int32).contiguous()
    *taps, gains2 = _operator_planes(op)
    split = high_taps(op) if high else None
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
        stages, float(np.float32(sigma2)), int(high),
        split.data_ptr() if high else None,
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
    global launches, launches_high
    _check_call(op, ps, y_re, y_im, cfg)
    if ps.var.shape[0] == 0:
        return bamp.IterOut(ps.xmap_re, ps.xmap_im, ps.xm_re, ps.xm_im,
                            ps.var, ps.z_re, ps.z_im, ps.u,
                            torch.zeros((0,), dtype=torch.int32,
                                        device=y_re.device))
    out, scratch, cov = _buffers(ps, cfg)
    _launch(op, ps, y_re, y_im, sigma2, cfg, out, scratch, cov, ALL_STAGES,
            precision)
    if precision == prec.HIGH:
        launches_high += 1
    else:
        launches += 1
    return out


def stage_ms(op, ps: bamp.PlaneState, y_re, y_im, sigma2: float,
             cfg: Config, reps: int = 10,
             precision: str = "highest") -> dict:
    """Milliseconds of each of the four launches of one call on the
    trials of ``ps`` (CUDA tensors) in the form of ``precision``, by CUDA
    events around ``reps`` launches of that stage alone, after one whole
    call that fills the scratch; and ``call``, the four together.  Not
    counted in ``launches`` or ``launches_high``."""
    precision = prec.canonical(precision)
    _check_call(op, ps, y_re, y_im, cfg)
    out, scratch, cov = _buffers(ps, cfg)
    times = {}
    for name, mask in [*STAGES.items(), ("call", ALL_STAGES)]:
        _launch(op, ps, y_re, y_im, sigma2, cfg, out, scratch, cov,
                ALL_STAGES, precision)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            _launch(op, ps, y_re, y_im, sigma2, cfg, out, scratch, cov, mask,
                    precision)
        stop.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(stop) / reps
    return times
