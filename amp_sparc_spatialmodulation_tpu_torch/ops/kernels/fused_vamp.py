"""Whole-decode VAMP kernel (CUDA) with its wrapper and plain version.

Port of the JAX package's ``ops/pallas/fused_vamp.py::_vamp_decode_kernel``
(through ``FusedVampDecode.decode_call``): the whole VAMP decode of a batch
on one channel SVD — the two dense products with ``Vh`` per iteration, the
SV-domain LMMSE stage, the extrinsic subtraction, the segmented softmax
without ``tau/2``, the extrinsic update, per-trial allclose, freeze and
``T`` — with the iteration loop inside the kernel.  The CUDA source is
``csrc/fused_vamp_decode.cu``: one thread block per tile of 64 trials, its
state in device memory, so each tile stops at its own slowest trial.  The
kernel also takes a (C, p, N) stack of factors, C realizations' trials
realization-major, each block reading its own realization's factor
(`fused_vamp.py:101-116`); :func:`..models.vamp.decode_batched` uses it.

* :func:`whole_decode` is the wrapper.  On a CUDA tensor it launches the
  kernel (or raises); on a CPU tensor it runs :func:`decode_plain`.
* :func:`decode_plain` is the same function in plain PyTorch: the
  ``vamp.plain_loop`` of :mod:`..models.vamp`, once per realization.
* ``launches`` counts kernel launches of the HIGHEST form,
  ``launches_high`` those of the HIGH form, ``launches_default`` those of
  the DEFAULT form.

Both take ``precision``: ``'highest'`` (the default; FP32 products on the
CUDA cores) or ``'high'``, the JAX kernel's ``make_dot(Precision.HIGH)``:
the Gauss form's three real products per complex product, each in three
bf16 passes (``ops/precision.py::dot3``), on the tensor cores in the
kernel and as ``vamp.plain_loop_high`` in the plain version.  The HIGH
kernel reads the six Gauss tap planes split into bf16 hi and lo
(:func:`high_taps`), built by each HIGH call, and splits each product's
trial side once into a scratch the wrapper allocates
(:func:`split_scratch`).  ``'default'`` is ``make_dot(Precision.DEFAULT)``,
one bf16 pass per real product and ``sum(hi)`` for the two row sums
(``precision.dot1``, ``rowsum1``): the HIGH form's code with the products
on a one-pass engine of their own, which reads the hi parts alone
(:func:`default_taps`, tiles of ``DEFAULT_TILE_COLS`` columns, and a
scratch of half the HIGH size), and ``vamp.plain_loop_default`` as its
plain version.

Both take and return a :class:`..models.vamp.VAMPState` in the JAX layouts
and are resumable: ``cap`` is the global iteration cap, and the result's
``active``, ``T`` and ``t`` follow ``vamp.py:121-142``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...config import Config
from ...models import vamp
from .. import precision as prec
from . import build
from .fused_bamp import FORM, _check, symbol_planes
from .fused_scamp import _recip, vec4

# Kernel launches made by whole_decode: the HIGHEST form, the HIGH form,
# the DEFAULT form.
launches = 0
launches_high = 0
launches_default = 0
# Trials of one thread block and output columns of one HIGH and of one
# DEFAULT product tile (kBt, kBN3 and kBNX1 of csrc/vamp_common.cuh).
BLOCK_TRIALS = 64
TILE_COLS = 96
DEFAULT_TILE_COLS = 96


def covers(cfg: Config) -> bool:
    """Can the kernel decode ``cfg``?  Complex segmented/sparc alphabets,
    the JAX ``FusedVampDecode.covers`` rule (`fused_vamp.py:245-250`).
    Nothing else limits it: the state lives in device memory."""
    return (cfg.mode in ("segmented", "sparc") and cfg.is_complex
            and cfg.M > 0)


def _factors(Vh: torch.Tensor):
    """(C, p, N) of one factor (C = 0) or of a (C, p, N) stack."""
    if Vh.dim() == 2:
        return (0,) + tuple(Vh.shape)
    return tuple(Vh.shape)


def decode_plain(Vh: torch.Tensor, s2: torch.Tensor, y_tilde: torch.Tensor,
                 s0: vamp.VAMPState, sigma2: float, cap: int,
                 cfg: Config, precision: str = "highest") -> vamp.VAMPState:
    """The kernel's function in plain PyTorch (any device), with the
    wrapper's signature: ``vamp.plain_loop`` (``vamp.plain_loop_high`` at
    ``precision='high'``, ``vamp.plain_loop_default`` at ``'default'``) on
    one factor, or on each realization's rows of a (C, p, N) stack in
    turn."""
    loop = {prec.HIGHEST: vamp.plain_loop, prec.HIGH: vamp.plain_loop_high,
            prec.DEFAULT: vamp.plain_loop_default}[prec.canonical(precision)]
    C, _, _ = _factors(Vh)
    if C == 0:
        return loop(Vh, s2, y_tilde, s0, sigma2, cap, cfg)
    B = y_tilde.shape[0] // C
    parts = []
    for c in range(C):
        rows = slice(c * B, (c + 1) * B)
        sub = s0._replace(**{f: getattr(s0, f)[rows]
                             for f in s0._fields if f != "t"})
        parts.append(loop(Vh[c], s2[c], y_tilde[rows], sub, sigma2, cap,
                          cfg))
    # the fields concatenated; t the largest (the global counter rule holds
    # for the union)
    return parts[0]._replace(t=max(int(p.t) for p in parts), **{
        f: torch.cat([getattr(p, f) for p in parts])
        for f in parts[0]._fields if f != "t"})


def padded_k(k: int) -> int:
    """A contraction length rounded up to the mma depth of 16 (the HIGH
    operands' row length; the pad holds zeros, which add exact zero
    products)."""
    return -(-int(k) // 16) * 16


def chunk_order(rows: int) -> torch.Tensor:
    """(rows, 4): the 16-byte chunk of each HIGH operand row that holds
    chunk 0..3 (hi k 0-7, hi k 8-15, lo k 0-7, lo k 8-15 of a k16 step):
    chunk c of row n lies at ``c ^ ((n // 2) % 4)`` (``vamp_common.cuh::
    x3_chunk``), so that the eight rows an ldmatrix phase reads fall on
    distinct shared-memory banks.  The map is its own inverse."""
    n = torch.arange(rows)[:, None]
    return torch.arange(4)[None, :] ^ ((n >> 1) & 3)


def tap_tiles(hi: torch.Tensor, lo: torch.Tensor, ld: int) -> torch.Tensor:
    """The HIGH engine's tap tiles of one Gauss plane split into ``hi`` and
    ``lo`` (..., rows, K) (rows = the product's output columns, k the
    contraction): per tile of ``TILE_COLS`` rows (the last padded with zero
    rows) and k16 step (K padded with zeros to ``ld``), the tile's rows of
    16 hi then 16 lo bf16, chunks in :func:`chunk_order`, flattened per
    factor: one contiguous 6 KB block per step."""
    rows, K = hi.shape[-2:]
    tiles, lead = -(-rows // TILE_COLS), hi.shape[:-2]
    pad = (0, ld - K, 0, tiles * TILE_COLS - rows)
    x = torch.stack([torch.nn.functional.pad(hi, pad),
                     torch.nn.functional.pad(lo, pad)], dim=-2)
    # (.., tile, row, part, step, half, 8) -> (.., tile, step, row, chunk, 8)
    x = x.reshape(lead + (tiles, TILE_COLS, 2, ld // 16, 2, 8))
    d = len(lead)
    x = x.permute(*range(d), d, d + 3, d + 1, d + 2, d + 4, d + 5)
    x = x.reshape(lead + (tiles, ld // 16, TILE_COLS, 4, 8))
    where = chunk_order(TILE_COLS).to(x.device)
    x = x.gather(-2, where[..., None].expand(x.shape))
    return x.reshape(lead + (-1,))


def split_scratch(blocks: int, ldf: int, ldb: int, device: torch.device,
                  precision: str = "high") -> torch.Tensor:
    """The HIGH kernels' scratch for the split operands of ``blocks``
    blocks of ``BLOCK_TRIALS`` trials (``vamp_common.cuh::split_at``): per
    block the bf16 hi and lo of the three Gauss operands of the first
    product's trial side (k padded to ``ldf``) and of the second's (k padded
    to ``ldb``), written and read inside the launch, so left
    uninitialised.  At ``precision='default'`` the hi parts alone
    (``split1_at``): half the size."""
    parts = 3 if prec.canonical(precision) == prec.DEFAULT else 6
    return torch.empty(blocks * parts * BLOCK_TRIALS * (ldf + ldb),
                       dtype=torch.bfloat16, device=device)


def high_taps(Vh: torch.Tensor):
    """The HIGH kernels' taps of the factor ``Vh`` ((p, N) or a (C, p, N)
    stack): the six Gauss planes of ``vamp.gauss_taps`` with the output
    column along the rows (the forward's three (p, N), the adjoint's three
    (N, p)), each split into bf16 hi and lo (``precision.split_bf16``, round
    to nearest even) and laid out as :func:`tap_tiles` (k padded to
    ``ldf`` = N and ``ldb`` = p rounded up to 16); one contiguous bf16
    buffer per factor, the forward's three planes, then the adjoint's,
    shape (C, size) or (size,).  Returns ``(taps, ldf, ldb)``."""
    _, p, N = _factors(Vh)
    ldf, ldb = padded_k(N), padded_k(p)
    t = vamp.gauss_taps(Vh)
    fwd = [x.mT for x in t[:3]]          # (.., p, N): row n, k contiguous
    bwd = [x.mT for x in t[3:]]          # (.., N, p)
    taps = torch.cat([tap_tiles(*prec.split_bf16(x.contiguous()), ld)
                      for planes, ld in ((fwd, ldf), (bwd, ldb))
                      for x in planes], dim=-1).contiguous()
    return taps, ldf, ldb


def chunk_order1(rows: int) -> torch.Tensor:
    """(rows, 2): the 16-byte chunk of each DEFAULT operand row (16 hi
    bf16: k 0-7, k 8-15 of a k16 step) that holds chunk 0, 1: chunk c of
    row n lies at ``c ^ ((n // 4) % 2)`` (``vamp_common.cuh::x1_chunk``),
    so that the eight 32-byte rows an ldmatrix phase reads fall on distinct
    banks.  Its own inverse."""
    n = torch.arange(rows)[:, None]
    return torch.arange(2)[None, :] ^ ((n >> 2) & 1)


def default_tap_tiles(hi: torch.Tensor, ld: int) -> torch.Tensor:
    """The DEFAULT engine's tap tiles of one Gauss plane's bf16 hi part
    ``hi`` (..., rows, K): per tile of ``DEFAULT_TILE_COLS`` rows (the last
    padded with zero rows) and k16 step (K padded with zeros to ``ld``),
    the tile's rows of 16 bf16, chunks in :func:`chunk_order1`, flattened:
    one contiguous 3 KB block per step."""
    rows, K = hi.shape[-2:]
    cols = DEFAULT_TILE_COLS
    tiles, lead = -(-rows // cols), hi.shape[:-2]
    x = torch.nn.functional.pad(hi, (0, ld - K, 0, tiles * cols - rows))
    # (.., tile, row, step, chunk, 8) -> (.., tile, step, row, chunk, 8)
    x = x.reshape(lead + (tiles, cols, ld // 16, 2, 8))
    d = len(lead)
    x = x.permute(*range(d), d, d + 2, d + 1, d + 3, d + 4)
    where = chunk_order1(cols).to(x.device)
    x = x.gather(-2, where[..., None].expand(x.shape))
    return x.reshape(lead + (-1,))


def default_taps(Vh: torch.Tensor):
    """The DEFAULT kernels' taps of the factor ``Vh`` ((p, N) or a (C, p,
    N) stack): the hi parts (``precision.split_bf16``) of the six Gauss
    planes of ``vamp.gauss_taps``, output column along the rows, laid out
    as :func:`default_tap_tiles` (k padded to ``ldf`` = N and ``ldb`` = p
    rounded up to 16); one contiguous bf16 buffer per factor, the
    forward's three planes, then the adjoint's.  Returns ``(taps, ldf,
    ldb)``."""
    _, p, N = _factors(Vh)
    ldf, ldb = padded_k(N), padded_k(p)
    t = vamp.gauss_taps(Vh)
    fwd = [x.mT for x in t[:3]]          # (.., p, N): row n, k contiguous
    bwd = [x.mT for x in t[3:]]          # (.., N, p)
    taps = torch.cat([default_tap_tiles(prec.split_bf16(x.contiguous())[0],
                                        ld)
                      for planes, ld in ((fwd, ldf), (bwd, ldb))
                      for x in planes], dim=-1).contiguous()
    return taps, ldf, ldb


def form_taps(Vh: torch.Tensor, precision: str):
    """``(taps, ldf, ldb)`` of the form ``precision`` ('high' or
    'default') for ``Vh``."""
    return (default_taps if prec.canonical(precision) == prec.DEFAULT
            else high_taps)(Vh)


def _library() -> ctypes.CDLL:
    lib = build.load("fused_vamp_decode")
    if not getattr(lib, "_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_vamp_decode.argtypes = (
            [ptr] * 13 + [i32] * 8 + [f32] * 5
            + [i32, i32, ptr, ctypes.c_longlong, i32, i32, ptr, ptr])
        lib.fused_vamp_decode.restype = i32
        lib.fused_vamp_error_string.argtypes = [i32]
        lib.fused_vamp_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def whole_decode(Vh: torch.Tensor, s2: torch.Tensor, y_tilde: torch.Tensor,
                 s0: vamp.VAMPState, sigma2: float, cap: int,
                 cfg: Config, precision: str = "highest") -> vamp.VAMPState:
    """The whole decode of the trials of ``y_tilde`` from state ``s0`` up
    to global iteration ``cap``: the CUDA kernel for a CUDA tensor,
    :func:`decode_plain` for a CPU tensor.

    ``Vh`` is the (p, N) factor and ``s2`` the (p,) squared singular
    values, or (C, p, N) and (C, p) stacks whose realization c owns rows
    ``c*B/C .. (c+1)*B/C - 1`` of the state and of ``y_tilde`` (B, p).  The
    caller has checked :func:`covers` (``vamp.decode`` does).
    ``precision`` is ``'highest'``, ``'high'`` or ``'default'`` (module
    docstring); on the card the form asked for is the form that runs, or
    the call raises."""
    precision = prec.canonical(precision)
    if y_tilde.device.type == "cpu":
        return decode_plain(Vh, s2, y_tilde, s0, sigma2, cap, cfg, precision)
    if y_tilde.device.type != "cuda":
        raise ValueError(f"no kernel for device {y_tilde.device}")
    global launches, launches_high, launches_default
    C, p, N = _factors(Vh)
    B = y_tilde.shape[0]
    dev = y_tilde.device
    c64, f32 = torch.complex64, torch.float32
    if C and B % C:
        raise ValueError(f"{B} trials do not split into {C} realizations")
    _check("Vh", Vh, (C, p, N) if C else (p, N), c64, dev)
    _check("s2", s2, (C, p) if C else (p,), f32, dev)
    _check("y_tilde", y_tilde, (B, p), c64, dev)
    _check("r_tilde", s0.r_tilde, (B, N), c64, dev)
    _check("sigma2_tilde", s0.sigma2_tilde, (B, 1), f32, dev)
    _check("r", s0.r, (B, N), c64, dev)
    _check("var", s0.var, (B, N), f32, dev)
    _check("xmmse", s0.xmmse, (B, N), c64, dev)
    if N != cfg.N or N % cfg.M:
        raise ValueError("factor width differs from the config")
    if B == 0:
        return s0
    # The kernel updates the state in place: it gets copies.
    out = vamp.VAMPState(
        r_tilde=s0.r_tilde.clone(), sigma2_tilde=s0.sigma2_tilde.clone(),
        r=s0.r.clone(), var=s0.var.clone(), xmmse=s0.xmmse.clone(),
        active=s0.active.to(torch.int32),
        T=s0.T.to(torch.int32, copy=True), t=s0.t)
    scratch = torch.empty((B, p), dtype=c64, device=dev)
    sym_re, sym_im = symbol_planes(cfg, dev)
    cap_rem = max(int(cap) - int(s0.t), 0)
    high = precision in prec.BF16
    taps, ldf, ldb = form_taps(Vh, precision) if high else (None, 0, 0)
    xs = (split_scratch(max(C, 1) * -(-(B // max(C, 1)) // BLOCK_TRIALS),
                        ldf, ldb, dev, precision) if high else None)
    lib = _library()
    rc = lib.fused_vamp_decode(
        out.r_tilde.data_ptr(), out.sigma2_tilde.data_ptr(),
        out.r.data_ptr(), out.var.data_ptr(), out.xmmse.data_ptr(),
        out.active.data_ptr(), out.T.data_ptr(),
        y_tilde.data_ptr(), s2.data_ptr(), Vh.data_ptr(), scratch.data_ptr(),
        sym_re.data_ptr(), sym_im.data_ptr(),
        max(C, 1), B // max(C, 1), N, p, cfg.M, cfg.K, int(vec4(p)),
        int(vec4(N)), float(np.float32(sigma2)), float(np.float32(p / N)),
        float(np.float32(1.0 - p / N)), _recip(p), _recip(N), cap_rem,
        FORM[precision], taps.data_ptr() if high else None,
        taps.shape[-1] if high else 0, ldf, ldb,
        xs.data_ptr() if high else None,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("fused_vamp_decode launch failed: "
                           + lib.fused_vamp_error_string(rc).decode())
    if precision == prec.DEFAULT:
        launches_default += 1
    elif high:
        launches_high += 1
    else:
        launches += 1
    active = out.active > 0
    # Global counter semantics of the XLA loop (`vamp.py:137-138`): ran to
    # cap if any trial is still active, else stopped when the slowest
    # trial froze.
    t = max(int(s0.t), int(cap) if bool(active.any())
            else int(out.T.max()))
    return out._replace(active=active, t=t)
