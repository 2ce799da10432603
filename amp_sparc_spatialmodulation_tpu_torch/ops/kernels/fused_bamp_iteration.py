"""Per-iteration BAMP kernels K6 and K7 (CUDA) with their wrappers and plain
versions.

Ports of the JAX package's ``ops/pallas/fused_bamp.py`` per-iteration
kernels, both reached through ``FusedBandedIteration`` and ``_call``:

* K6, ``_iteration_fused_kernel`` (``fuse_denoiser=True``, ``plane_call``):
  one whole BAMP iteration with the K=1 segmented denoiser and its
  closed-form variance ``|s0|^2 p (1 - p)``, the freeze and the per-trial
  allclose count.  It is the per-iteration link of the decode chain
  (``models/bamp.py::route``, ``AMP_PALLAS_MODE=periter``), driven by
  ``bamp.plane_loop``.
* K7, ``_iteration_kernel`` (``fuse_denoiser=False``, ``__call__``): the
  linear part of one iteration only, returning ``(xmap, cov, z, u)``; any
  alphabet.  No decoder runs it, as in the JAX package.

The CUDA source is ``csrc/fused_bamp_iteration.cu``, one kernel with a
switch at launch between the two (compiled as two template instances,
K7's ran at more than twice K6's time): one thread block per trial, its
frame in shared memory, any truncation and gains that vary by column.  It
runs the iteration body of the whole-decode kernel K1 once, in a copy of
its own: register tiles over the block-Toeplitz taps for the forward and
adjoint products, the fold writing the adjoint inputs into the forward
products' slots, xmap written over x in place, and for K6 a lane-group
form of K1's denoiser with the closed-form variance.  Three blocks share
an SM at the flagship geometry (:func:`smem_bytes`).

* :func:`iteration_fused` (K6, planes in and out like ``plane_call``) and
  :func:`iteration_linear` (K7, the decoder's layout like ``__call__``) are
  the wrappers: on a CUDA tensor they launch the kernel (or raise), on a CPU
  tensor they run :func:`iteration_fused_plain` / :func:`linear_plain`.
* ``fused_launches`` and ``linear_launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes
from functools import partial

import numpy as np
import torch

from ...config import Config
from ...models import bamp
from . import build
from .fused_bamp import _TRUNC, SMEM_LIMIT, _check, scratch_row

# Kernel launches made by iteration_fused (K6) and iteration_linear (K7).
fused_launches = 0
linear_launches = 0


def covers(cfg: Config) -> bool:
    """Can K6 decode ``cfg``?  Complex segmented/sparc mode with a K=1
    alphabet and M a power of two: the JAX decoder's ``fuse_den`` rule
    (`bamp.py:273-274`)."""
    M = cfg.M
    return (cfg.mode in ("segmented", "sparc") and cfg.is_complex and M > 0
            and cfg.K == 1 and (M & (M - 1)) == 0)


def smem_bytes(cfg: Config) -> int:
    """Dynamic shared memory of one block, passed to the launch: 3 scratch
    planes of (Lin, Lh, scratch_row) floats (the forward products, then
    the adjoint inputs), 4 x-side planes (x, then xmap in its place; var;
    cov) and 5 y-side planes of float32, carved in that order by the
    kernel."""
    return 4 * (3 * cfg.Lin * cfg.Lh * scratch_row(cfg) + 4 * cfg.N
                + 5 * cfg.n)


def fits(cfg: Config) -> bool:
    """True when one trial's frame fits a block's shared memory: the
    condition both kernels need.  The massive geometry declines (1 MB)."""
    return smem_bytes(cfg) <= SMEM_LIMIT


def iteration_fused_plain(op, ps: bamp.PlaneState, y_re, y_im,
                          sigma2: float, cfg: Config) -> bamp.IterOut:
    """K6's function in plain PyTorch (any device): one ``bamp.step`` on
    the planes with K6's denoiser."""
    return bamp.step_planes(op, ps, y_re, y_im, sigma2,
                            bamp.make_k1_denoiser(cfg, y_re.device))


# The plane-loop decode on K6's plain version.
decode_plain = partial(bamp.plane_loop, iteration_fused_plain)


def linear_plain(op, xmmse, var, z, u, y, sigma2: float, cfg: Config):
    """K7's function in plain PyTorch (any device): ``bamp.linear_step``."""
    return bamp.linear_step(op, xmmse, var, z, u, y,
                            float(np.float32(sigma2)))


def _library() -> ctypes.CDLL:
    lib = build.load("fused_bamp_iteration")
    if not getattr(lib, "_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_bamp_iteration.argtypes = (
            [i32] + [ptr] * 24 + [f32, f32] + [i32] * 8 + [f32, i32, ptr])
        lib.fused_bamp_iteration.restype = i32
        lib.fused_bamp_iteration_error_string.argtypes = [i32]
        lib.fused_bamp_iteration_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(fused: bool, op, cfg: Config, planes, y_re, y_im, act, outs,
            sigma2: float) -> None:
    """Check the operator and launch the kernel on ``planes`` = (xm_re,
    xm_im, var, z_re, z_im, u) into ``outs`` = (xmap_re, xmap_im, xn_re,
    xn_im, out_var, zn_re, zn_im, un, notok); ``act`` and the K6-only
    outputs may be None for K7."""
    dev = y_re.device
    _check("h", op.h, (cfg.Lh, cfg.Nr, cfg.Nt), torch.complex64, dev)
    _check("gains", op.gains, (cfg.Lh, cfg.Lin), torch.float32, dev)
    if (op.Lin, op.Lout, op.trunc) != (cfg.Lin, cfg.Lout, cfg.trunc):
        raise ValueError("operator geometry differs from the config")
    if not fits(cfg):
        raise ValueError(f"one trial needs {smem_bytes(cfg)} bytes of shared "
                         f"memory, more than a block's {SMEM_LIMIT}")
    s0 = complex(np.asarray(cfg.symbols)[0]) if fused else 0j
    hT = op.h.transpose(1, 2).contiguous()
    a2 = op.abs_h2.contiguous()
    a2T = a2.transpose(1, 2).contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _library()
    rc = lib.fused_bamp_iteration(
        int(fused), *[ptr(t) for t in planes], y_re.data_ptr(),
        y_im.data_ptr(), ptr(act), *[ptr(t) for t in outs],
        op.h.data_ptr(), hT.data_ptr(), a2.data_ptr(), a2T.data_ptr(),
        op.gains.data_ptr(),
        op.gains2.contiguous().data_ptr(), float(np.float32(s0.real)),
        float(np.float32(s0.imag)), y_re.shape[0], cfg.Nt, cfg.Nr, cfg.Lin,
        cfg.Lout, cfg.Lh, _TRUNC[cfg.trunc], cfg.M,
        float(np.float32(sigma2)), smem_bytes(cfg),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("fused_bamp_iteration launch failed: "
                           + lib.fused_bamp_iteration_error_string(rc)
                           .decode())


def iteration_fused(op, ps: bamp.PlaneState, y_re: torch.Tensor,
                    y_im: torch.Tensor, sigma2: float,
                    cfg: Config) -> bamp.IterOut:
    """K6: one iteration of the trials of ``ps``, the CUDA kernel for CUDA
    tensors, :func:`iteration_fused_plain` for CPU tensors.  The caller has
    checked :func:`covers` and :func:`fits` (``bamp.route`` does)."""
    if y_re.device.type == "cpu":
        return iteration_fused_plain(op, ps, y_re, y_im, sigma2, cfg)
    if y_re.device.type != "cuda":
        raise ValueError(f"no kernel for device {y_re.device}")
    global fused_launches
    if not covers(cfg):
        raise ValueError("K6 covers complex segmented/sparc K=1 alphabets "
                         "with M a power of two")
    B = ps.var.shape[0]
    dev = y_re.device
    f32 = torch.float32
    for name in ("xm_re", "xm_im", "var"):
        _check(name, getattr(ps, name), (B, cfg.N), f32, dev)
    for name in ("z_re", "z_im", "u"):
        _check(name, getattr(ps, name), (B, cfg.n), f32, dev)
    _check("y_re", y_re, (B, cfg.n), f32, dev)
    _check("y_im", y_im, (B, cfg.n), f32, dev)
    x = lambda: torch.empty_like(ps.var)
    yv = lambda: torch.empty_like(ps.u)
    out = bamp.IterOut(x(), x(), x(), x(), x(), yv(), yv(), yv(),
                       torch.empty((B,), dtype=torch.int32, device=dev))
    if B == 0:
        return out
    _launch(True, op, cfg,
            (ps.xm_re, ps.xm_im, ps.var, ps.z_re, ps.z_im, ps.u), y_re,
            y_im, ps.active.to(torch.int32).contiguous(), out, sigma2)
    fused_launches += 1
    return out


def iteration_linear(op, xmmse: torch.Tensor, var: torch.Tensor,
                     z: torch.Tensor, u: torch.Tensor, y: torch.Tensor,
                     sigma2: float, cfg: Config):
    """K7: the linear part of one iteration in the decoder's (B, .) layout,
    ``(xmap, cov, z, u)``, like ``FusedBandedIteration.__call__``: the CUDA
    kernel for CUDA tensors, :func:`linear_plain` for CPU tensors.  Any
    alphabet; the trial's frame must fit a block (:func:`fits`)."""
    if y.device.type == "cpu":
        return linear_plain(op, xmmse, var, z, u, y, sigma2, cfg)
    if y.device.type != "cuda":
        raise ValueError(f"no kernel for device {y.device}")
    global linear_launches
    B = y.shape[0]
    dev = y.device
    _check("xmmse", xmmse, (B, cfg.N), torch.complex64, dev)
    _check("var", var, (B, cfg.N), torch.float32, dev)
    _check("z", z, (B, cfg.n), torch.complex64, dev)
    _check("u", u, (B, cfg.n), torch.float32, dev)
    _check("y", y, (B, cfg.n), torch.complex64, dev)
    part = lambda a: a.contiguous()
    xmap_re, xmap_im, cov = (torch.empty_like(var) for _ in range(3))
    zn_re, zn_im, un = (torch.empty_like(u) for _ in range(3))
    if B:
        _launch(False, op, cfg,
                (part(xmmse.real), part(xmmse.imag), var, part(z.real),
                 part(z.imag), u), part(y.real), part(y.imag), None,
                (xmap_re, xmap_im, None, None, cov, zn_re, zn_im, un, None),
                sigma2)
        linear_launches += 1
    return (torch.complex(xmap_re, xmap_im), cov, torch.complex(zn_re, zn_im),
            un)
