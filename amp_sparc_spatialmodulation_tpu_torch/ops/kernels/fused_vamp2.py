"""Whole-decode vamp2 kernel (CUDA) with its wrapper and plain version.

Port of the JAX package's ``ops/pallas/fused_vamp2.py::
_vamp2_decode_kernel`` (through ``FusedVamp2Decode.decode_call``): the whole
damped Rangan VAMP decode of a batch on one channel SVD — the segmented
softmax without ``tau/2`` and with the second-moment variance, damping,
the ``gamma`` bookkeeping, the two dense products with ``Vh`` per
iteration, per-trial allclose, freeze and ``T`` — with the iteration loop
inside the kernel.  The CUDA source is ``csrc/fused_vamp2_decode.cu``,
built like K3's (``csrc/vamp_common.cuh``): one thread block per tile of 64
trials, its state in device memory.  The whitened data ``y_tilde`` is
formed outside, from the direct SVD.

* :func:`whole_decode` is the wrapper.  On a CUDA tensor it launches the
  kernel (or raises); on a CPU tensor it runs :func:`decode_plain`.
* :func:`decode_plain` is the same function in plain PyTorch: the
  ``vamp2.plain_loop`` of :mod:`..models.vamp2`.
* ``launches`` counts kernel launches of the HIGHEST form,
  ``launches_high`` those of the HIGH form, ``launches_default`` those of
  the DEFAULT form.

Both take ``precision``, ``'highest'`` (default), ``'high'`` or
``'default'``, as K3's
wrapper does (:mod:`.fused_vamp`): the HIGH kernel runs the Gauss form's
products in bf16 x 3 on the tensor cores on the split tap planes of
``fused_vamp.high_taps`` and the split operands of
``fused_vamp.split_scratch``, its plain version is
``vamp2.plain_loop_high``; the DEFAULT kernel runs them in one pass on
K3's one-pass engine (``fused_vamp.default_taps``, the half-size
scratch), its plain version ``vamp2.plain_loop_default``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...config import Config
from ...models import vamp2
from .. import precision as prec
from . import build
from .fused_bamp import _check, symbol_planes
from .fused_scamp import _recip, vec4
from .fused_vamp import BLOCK_TRIALS, FORM, form_taps, split_scratch

# Kernel launches made by whole_decode: the HIGHEST form, the HIGH form,
# the DEFAULT form.
launches = 0
launches_high = 0
launches_default = 0


def covers(cfg: Config) -> bool:
    """Complex segmented/sparc alphabets, the JAX
    ``FusedVamp2Decode.covers`` rule (`fused_vamp2.py:140-144`)."""
    return (cfg.mode in ("segmented", "sparc") and cfg.is_complex
            and cfg.M > 0)


def decode_plain(Vh: torch.Tensor, s2: torch.Tensor, y_tilde: torch.Tensor,
                 s0: vamp2.VAMP2State, sigma2: float, cap: int,
                 cfg: Config, precision: str = "highest") -> vamp2.VAMP2State:
    """The kernel's function in plain PyTorch (any device), with the
    wrapper's signature: ``vamp2.plain_loop``, or ``vamp2.plain_loop_high``
    at ``precision='high'``, ``vamp2.plain_loop_default`` at
    ``'default'``."""
    loop = {prec.HIGHEST: vamp2.plain_loop, prec.HIGH: vamp2.plain_loop_high,
            prec.DEFAULT: vamp2.plain_loop_default}[
                prec.canonical(precision)]
    return loop(Vh, s2, y_tilde, s0, sigma2, cap, cfg)


def _library() -> ctypes.CDLL:
    lib = build.load("fused_vamp2_decode")
    if not getattr(lib, "_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_vamp2_decode.argtypes = (
            [ptr] * 12 + [i32] * 7 + [f32] * 6 + [i32, i32, ptr, i32, i32,
                                                   ptr, ptr])
        lib.fused_vamp2_decode.restype = i32
        lib.fused_vamp2_error_string.argtypes = [i32]
        lib.fused_vamp2_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def whole_decode(Vh: torch.Tensor, s2: torch.Tensor, y_tilde: torch.Tensor,
                 s0: vamp2.VAMP2State, sigma2: float, cap: int,
                 cfg: Config, precision: str = "highest") -> vamp2.VAMP2State:
    """The whole decode of the trials of the whitened ``y_tilde`` (B, p)
    from state ``s0`` up to global iteration ``cap`` on the factor ``Vh``
    (p, N) with squared singular values ``s2`` (p,): the CUDA kernel for a
    CUDA tensor, :func:`decode_plain` for a CPU tensor.  The caller has
    checked :func:`covers` (``vamp2.decode`` does).  ``precision`` is
    ``'highest'``, ``'high'`` or ``'default'``; on the card the form asked
    for is the form that runs, or the call raises."""
    precision = prec.canonical(precision)
    if y_tilde.device.type == "cpu":
        return decode_plain(Vh, s2, y_tilde, s0, sigma2, cap, cfg, precision)
    if y_tilde.device.type != "cuda":
        raise ValueError(f"no kernel for device {y_tilde.device}")
    global launches, launches_high, launches_default
    p, N = Vh.shape
    B = y_tilde.shape[0]
    dev = y_tilde.device
    c64, f32 = torch.complex64, torch.float32
    _check("Vh", Vh, (p, N), c64, dev)
    _check("s2", s2, (p,), f32, dev)
    _check("y_tilde", y_tilde, (B, p), c64, dev)
    _check("r", s0.r, (B, N), c64, dev)
    _check("gamma", s0.gamma, (B, 1), f32, dev)
    _check("var", s0.var, (B, N), f32, dev)
    _check("xmmse", s0.xmmse, (B, N), c64, dev)
    if N != cfg.N or N % cfg.M:
        raise ValueError("factor width differs from the config")
    if B == 0:
        return s0
    # The kernel updates the state in place: it gets copies.
    out = vamp2.VAMP2State(
        r=s0.r.clone(), gamma=s0.gamma.clone(), var=s0.var.clone(),
        xmmse=s0.xmmse.clone(), active=s0.active.to(torch.int32),
        T=s0.T.to(torch.int32, copy=True), t=s0.t)
    scratch = torch.empty((B, p), dtype=c64, device=dev)
    sym_re, sym_im = symbol_planes(cfg, dev)
    cap_rem = max(int(cap) - int(s0.t), 0)
    high = precision in prec.BF16
    taps, ldf, ldb = form_taps(Vh, precision) if high else (None, 0, 0)
    xs = (split_scratch(-(-B // BLOCK_TRIALS), ldf, ldb, dev, precision)
          if high else None)
    lib = _library()
    rc = lib.fused_vamp2_decode(
        out.r.data_ptr(), out.gamma.data_ptr(), out.var.data_ptr(),
        out.xmmse.data_ptr(), out.active.data_ptr(), out.T.data_ptr(),
        y_tilde.data_ptr(), s2.data_ptr(), Vh.data_ptr(), scratch.data_ptr(),
        sym_re.data_ptr(), sym_im.data_ptr(),
        B, N, p, cfg.M, cfg.K, int(vec4(p)), int(vec4(N)),
        float(np.float32(sigma2)), float(np.float32(N / p)),
        float(np.float32(vamp2.DAMPING)),
        float(np.float32(1.0 - vamp2.DAMPING)),
        _recip(p), _recip(N), cap_rem, FORM[precision],
        taps.data_ptr() if high else None, ldf, ldb,
        xs.data_ptr() if high else None,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("fused_vamp2_decode launch failed: "
                           + lib.fused_vamp2_error_string(rc).decode())
    if precision == prec.DEFAULT:
        launches_default += 1
    elif high:
        launches_high += 1
    else:
        launches += 1
    active = out.active > 0
    # Global counter semantics of the XLA loop (`vamp2.py:67-68`).
    t = max(int(s0.t), int(cap) if bool(active.any())
            else int(out.T.max()))
    return out._replace(active=active, t=t)
