"""Frame-tiled BAMP iteration kernel K5 (CUDA) with its wrapper and plain
version.

Port of the JAX package's ``ops/pallas/fused_bamp_tiled.py::
_tiled_iteration_kernel`` (through ``TiledBandedIteration.plane_call``):
one BAMP iteration — the four banded maps, Onsager, the segmented softmax
denoiser, the freeze and the per-trial allclose count — for geometries
whose trial does not fit one block's shared memory (the massive-MIMO
config).  The CUDA source is ``csrc/fused_bamp_tiled.cu``: the state stays
in device memory, and one call is four launches (forward products; band
fold and Onsager; adjoint products; denoiser), with the products in 64 x 64
tiles over the batch's (trial, column block) rows.

* :func:`iteration` is the wrapper, driven by ``models/bamp.py::
  plane_loop``: :class:`..models.bamp.PlaneState` in, an
  :class:`..models.bamp.IterOut` out.  On a CUDA tensor it launches the
  kernel (or raises); on a CPU tensor it runs :func:`iteration_plain`.
* :func:`iteration_plain` is the same function in plain PyTorch: one
  ``bamp.step`` of the plain loop on the planes.  :func:`decode_plain` is
  the plane loop over it, which equals ``bamp.plain_loop``.
* ``launches`` counts wrapper calls that launched the kernel (one per
  iteration, each of four kernel launches).

Coverage (:func:`covers`): complex segmented/sparc configs with a real
alphabet (the posterior mean stays real, so the x-side imaginary state is
dropped, as on the TPU), tail truncation, and per-tap-constant gains (every
SPARC base matrix with tail truncation).  Unlike the JAX kernel it takes
any batch size and needs no frame tile dividing ``Lin``: the ragged trial
tile is masked.
"""
from __future__ import annotations

import ctypes
from functools import partial

import numpy as np
import torch

from ...config import Config
from ...models import bamp
from ...ops import operators
from . import build
from .fused_bamp import _check, real_x, symbol_planes

# Wrapper calls that launched the kernel (one per iteration).
launches = 0


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
                    cfg: Config) -> bamp.IterOut:
    """The kernel's function in plain PyTorch (any device)."""
    return bamp.step_planes(op, ps, y_re, y_im, sigma2,
                            bamp.make_denoiser(cfg, y_re.device))


# The plane-loop decode on the plain version (equal to bamp.plain_loop),
# with the signature of the other kernels' decode_plain.
decode_plain = partial(bamp.plane_loop, iteration_plain)


def _library() -> ctypes.CDLL:
    lib = build.load("fused_bamp_tiled")
    if not getattr(lib, "_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_bamp_tiled_iteration.argtypes = (
            [ptr] * 30 + [i32] * 7 + [f32, ptr])
        lib.fused_bamp_tiled_iteration.restype = i32
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


def iteration(op, ps: bamp.PlaneState, y_re: torch.Tensor,
              y_im: torch.Tensor, sigma2: float,
              cfg: Config) -> bamp.IterOut:
    """One iteration of the trials of ``ps``: the CUDA kernel for CUDA
    tensors, :func:`iteration_plain` for CPU tensors.  The caller has
    checked :func:`covers` for ``cfg`` and ``op`` (``bamp.route`` does)."""
    if y_re.device.type == "cpu":
        return iteration_plain(op, ps, y_re, y_im, sigma2, cfg)
    if y_re.device.type != "cuda":
        raise ValueError(f"no kernel for device {y_re.device}")
    global launches
    B = ps.var.shape[0]
    N, n = cfg.N, cfg.n
    dev = y_re.device
    f32, i32 = torch.float32, torch.int32
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
    if B == 0:
        return bamp.IterOut(ps.xmap_re, ps.xmap_im, ps.xm_re, ps.xm_im,
                            ps.var, ps.z_re, ps.z_im, ps.u,
                            torch.zeros((0,), dtype=i32, device=dev))
    act = ps.active.to(i32).contiguous()
    W = cfg.Lh * cfg.Nr
    out = bamp.IterOut(
        xmap_re=torch.empty_like(ps.var), xmap_im=torch.empty_like(ps.var),
        xm_re=torch.empty_like(ps.var), xm_im=ps.xm_im,
        var=torch.empty_like(ps.var), z_re=torch.empty_like(ps.u),
        z_im=torch.empty_like(ps.u), u=torch.empty_like(ps.u),
        notok=torch.empty((B,), dtype=i32, device=dev))
    scratch = [torch.empty((B * cfg.Lin, W), dtype=f32, device=dev)
               for _ in range(6)]
    cov = torch.empty_like(ps.var)
    h_re, h_im, h_a2 = tap_planes(op)
    gains2 = op.gains2.contiguous()
    sym_re, sym_im = symbol_planes(cfg, dev)
    lib = _library()
    rc = lib.fused_bamp_tiled_iteration(
        ps.xm_re.data_ptr(), ps.var.data_ptr(), ps.z_re.data_ptr(),
        ps.z_im.data_ptr(), ps.u.data_ptr(), y_re.data_ptr(),
        y_im.data_ptr(), act.data_ptr(),
        out.xmap_re.data_ptr(), out.xmap_im.data_ptr(),
        out.xm_re.data_ptr(), out.var.data_ptr(), out.z_re.data_ptr(),
        out.z_im.data_ptr(), out.u.data_ptr(), out.notok.data_ptr(),
        *[t.data_ptr() for t in scratch], cov.data_ptr(),
        h_re.data_ptr(), h_im.data_ptr(), h_a2.data_ptr(),
        op.gains.data_ptr(), gains2.data_ptr(), sym_re.data_ptr(),
        sym_im.data_ptr(), B, cfg.Nt, cfg.Nr, cfg.Lin, cfg.Lh, cfg.M, cfg.K,
        float(np.float32(sigma2)), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("fused_bamp_tiled_iteration launch failed: "
                           + lib.fused_bamp_tiled_error_string(rc).decode())
    launches += 1
    return out
