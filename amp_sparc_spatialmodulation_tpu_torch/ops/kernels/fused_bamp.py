"""Whole-decode BAMP kernel (CUDA) with its wrapper and plain version.

Port of the JAX package's ``ops/pallas/fused_bamp.py::_decode_kernel``
(through ``FusedBandedDecode.decode_call``): the whole BAMP decode of a
batch on one banded operator — the four banded maps, Onsager, the
segmented softmax or Bernoulli-mixture denoiser, per-trial allclose,
freeze and ``T`` — with the iteration loop inside the kernel.  The CUDA
source is ``csrc/fused_bamp_decode.cu``: one thread block per trial, its
state in shared memory, so each trial stops at its own convergence; the
banded products run as register tiles that reuse each tap for several
column blocks.

* :func:`whole_decode` is the wrapper.  On a CUDA tensor it launches the
  kernel (or raises); on a CPU tensor it runs :func:`decode_plain`.
* :func:`decode_plain` is the same function in plain PyTorch, built on
  the ported ``BandedOperator``, ``segmented_posterior`` and the
  ``bamp.decode`` loop.
* ``launches`` counts kernel launches.

Both take and return a :class:`..models.bamp.BAMPState` in the JAX
layouts and are resumable: ``cap`` is the global iteration cap, and the
result's ``active``, ``T`` and ``t`` follow ``bamp.py:153-165``.

Dispatch (``models/bamp.py::route``): the kernel is the first link of the
decode chain, taken whenever :func:`covers` and :func:`fits` hold for the
config, decided before any launch; the per-iteration kernels K6 and K5 and
the plain loop take the configs it declines.  A failed build or launch
raises; nothing falls back to the plain version after it.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...config import Config
from ...models import bamp
from . import build

# Kernel launches made by whole_decode.
launches = 0

# Dynamic shared memory one Hopper block may use (227 KB).
SMEM_LIMIT = 232448

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


def smem_bytes(cfg: Config) -> int:
    """Dynamic shared memory of one block, passed to the launch: 3 scratch
    planes of (Lin, Lh, scratch_row) floats (the forward products, then
    the adjoint inputs), 4 x-side planes (5 for complex alphabets) and 5
    y-side planes of float32, carved in that order by the kernel."""
    return 4 * (3 * cfg.Lin * cfg.Lh * scratch_row(cfg)
                + (4 if real_x(cfg) else 5) * cfg.N + 5 * cfg.n)


def fits(cfg: Config) -> bool:
    """True when one trial's planes fit a block's shared memory."""
    return smem_bytes(cfg) <= SMEM_LIMIT


# The kernel's function in plain PyTorch (any device), with the wrapper's
# signature.
decode_plain = bamp.plain_loop


def _library() -> ctypes.CDLL:
    lib = build.load("fused_bamp_decode")
    if not getattr(lib, "_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_bamp_decode.argtypes = (
            [ptr] * 23 + [i32] * 11 + [f32] * 3 + [i32, i32, ptr])
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
                 cap: int, cfg: Config) -> bamp.BAMPState:
    """The whole decode of ``y`` from state ``s0`` up to global iteration
    ``cap``: the CUDA kernel for a CUDA tensor, :func:`decode_plain` for a
    CPU tensor.  The caller has checked :func:`covers` and :func:`fits`
    for ``cfg`` (``bamp.decode`` does)."""
    if y.device.type == "cpu":
        return decode_plain(op, s0, y, sigma2, cap, cfg)
    if y.device.type != "cuda":
        raise ValueError(f"no kernel for device {y.device}")
    global launches
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
    cap_rem = max(int(cap) - int(s0.t), 0)
    lib = _library()
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
        float(np.float32(sigma2)), cap_rem, smem_bytes(cfg),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("fused_bamp_decode launch failed: "
                           + lib.fused_bamp_error_string(rc).decode())
    launches += 1
    active = out.active > 0
    # Global counter semantics of the XLA loop (`bamp.py:156-159`): ran to
    # cap if any trial is still active, else stopped when the slowest
    # trial froze.
    t = max(int(s0.t), int(cap) if bool(active.any())
            else int(out.T.max()))
    return out._replace(active=active, t=t)
