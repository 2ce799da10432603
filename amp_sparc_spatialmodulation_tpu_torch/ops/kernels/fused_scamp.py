"""Whole-decode SCAMP kernel (CUDA) with its wrapper and plain version.

Port of the JAX package's ``ops/pallas/fused_scamp.py::_scamp_decode_kernel``
(through ``FusedScampDecode.decode_call``): the whole SCAMP decode of a
batch on one banded operator and its base matrix ``W`` — the two banded
maps, the ``psi``/``phi``/``tau`` bookkeeping on the base-matrix grid,
Onsager, the mean-only segmented softmax denoiser, the per-trial allclose
on ``psi``, freeze and ``T`` — with the iteration loop inside the kernel.
The CUDA source is ``csrc/fused_scamp_decode.cu``: one thread block per
trial, its state in shared memory, so each trial stops at its own
convergence; the banded products run as register tiles that reuse each
tap for several column blocks.

* :func:`whole_decode` is the wrapper.  On a CUDA tensor it launches the
  kernel (or raises); on a CPU tensor it runs :func:`decode_plain`.
* :func:`decode_plain` is the same function in plain PyTorch: the
  ``scamp.plain_loop`` of :mod:`..models.scamp`.
* ``launches`` counts kernel launches.

Both take and return a :class:`..models.scamp.SCAMPState` in the JAX
layouts and are resumable: ``cap`` is the global iteration cap, and the
result's ``active``, ``T`` and ``t`` follow ``scamp.py:69-73``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...config import Config
from ...models import scamp
from . import build
from .fused_bamp import SMEM_LIMIT, _TRUNC, _check, real_x, symbol_planes

# Kernel launches made by whole_decode.
launches = 0

# PyTorch's CUDA sum vectorizes its loads by four from this many elements
# of a contiguous reduced dimension on (ATen/native/cuda/Reduce.cuh,
# setReduceConfig); the kernel follows it for the block sums of psi.
VEC4_MIN = 128


def covers(cfg: Config) -> bool:
    """Can the kernel decode ``cfg`` at all?  Complex segmented/sparc
    alphabets, any K and M — the JAX ``FusedScampDecode.covers`` rule
    (`fused_scamp.py:215-219`)."""
    return (cfg.mode in ("segmented", "sparc") and cfg.is_complex
            and cfg.M > 0)


def scratch_plane(cfg: Config) -> int:
    """Floats in each of the kernel's two scratch planes: the forward
    products of every (column block, tap, antenna), then in the same slots
    the adjoint inputs, rounded up to a multiple of 4 so that the planes
    after them start on 16 bytes."""
    return -(-cfg.Lin * cfg.Lh * cfg.Nr // 4) * 4


def smem_bytes(cfg: Config) -> int:
    """Dynamic shared memory of one block, passed to the launch: 2 scratch
    planes of :func:`scratch_plane` floats, 2 x-side planes (3 for complex
    alphabets), 4 y-side planes and the psi, tau, phi and Onsager
    vectors, of float32, carved in that order by the kernel."""
    return 4 * (2 * scratch_plane(cfg) + (2 if real_x(cfg) else 3) * cfg.N
                + 4 * cfg.n + 2 * (cfg.Lin + cfg.Lout))


def fits(cfg: Config) -> bool:
    """True when one trial's planes fit a block's shared memory."""
    return smem_bytes(cfg) <= SMEM_LIMIT


# The kernel's function in plain PyTorch (any device), with the wrapper's
# signature.
decode_plain = scamp.plain_loop


def _library() -> ctypes.CDLL:
    lib = build.load("fused_scamp_decode")
    if not getattr(lib, "_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_scamp_decode.argtypes = (
            [ptr] * 21 + [i32] * 12 + [f32] * 5 + [i32, i32, ptr])
        lib.fused_scamp_decode.restype = i32
        lib.fused_scamp_error_string.argtypes = [i32]
        lib.fused_scamp_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def vec4(n: int) -> bool:
    """Does PyTorch's CUDA sum over a contiguous last dimension of ``n``
    elements vectorize its loads by four?  The kernels' per-trial sums
    follow it (``warp_torch_sum`` in ``csrc/decode_common.cuh``)."""
    return n >= VEC4_MIN and n % 4 == 0


def _recip(v: int) -> float:
    """The float32 reciprocal PyTorch's CUDA division by a Python number
    multiplies with: ``1.0f / v``."""
    return float(np.float32(1.0) / np.float32(v))


def whole_decode(op, W: torch.Tensor, s0: scamp.SCAMPState, y: torch.Tensor,
                 sigma2: float, cap: int, cfg: Config,
                 estimate_phi: bool = False) -> scamp.SCAMPState:
    """The whole decode of ``y`` from state ``s0`` up to global iteration
    ``cap``: the CUDA kernel for a CUDA tensor, :func:`decode_plain` for a
    CPU tensor.  The caller has checked :func:`covers` and :func:`fits`
    for ``cfg`` (``scamp.decode`` does)."""
    if y.device.type == "cpu":
        return decode_plain(op, W, s0, y, sigma2, cap, cfg, estimate_phi)
    if y.device.type != "cuda":
        raise ValueError(f"no kernel for device {y.device}")
    global launches
    B = y.shape[0]
    N, n, Lin, Lout = cfg.N, cfg.n, cfg.Lin, cfg.Lout
    dev = y.device
    c64, f32 = torch.complex64, torch.float32
    _check("y", y, (B, n), c64, dev)
    _check("xmap", s0.xmap, (B, N), c64, dev)
    _check("xmmse", s0.xmmse, (B, N), c64, dev)
    _check("psi", s0.psi, (B, Lin), f32, dev)
    _check("phi", s0.phi, (B, Lout), f32, dev)
    _check("z", s0.z, (B, n), c64, dev)
    _check("h", op.h, (cfg.Lh, cfg.Nr, cfg.Nt), c64, dev)
    _check("gains", op.gains, (cfg.Lh, Lin), f32, dev)
    _check("W", W, (Lout, Lin), f32, dev)
    if (op.Lin, op.Lout, op.trunc) != (Lin, Lout, cfg.trunc):
        raise ValueError("operator geometry differs from the config")
    if B == 0:
        return s0
    act_in = s0.active.to(torch.int32).contiguous()
    T_in = s0.T.to(torch.int32).contiguous()
    out = scamp.SCAMPState(
        xmap=torch.empty_like(s0.xmap), xmmse=torch.empty_like(s0.xmmse),
        psi=torch.empty_like(s0.psi), phi=torch.empty_like(s0.phi),
        z=torch.empty_like(s0.z), active=torch.empty_like(act_in),
        T=torch.empty_like(T_in), t=s0.t)
    hT = op.h.transpose(1, 2).contiguous()
    sym_re, sym_im = symbol_planes(cfg, dev)
    cap_rem = max(int(cap) - int(s0.t), 0)
    lib = _library()
    rc = lib.fused_scamp_decode(
        y.data_ptr(), s0.xmap.data_ptr(), s0.xmmse.data_ptr(),
        s0.psi.data_ptr(), s0.phi.data_ptr(), s0.z.data_ptr(),
        act_in.data_ptr(), T_in.data_ptr(),
        out.xmap.data_ptr(), out.xmmse.data_ptr(), out.psi.data_ptr(),
        out.phi.data_ptr(), out.z.data_ptr(), out.active.data_ptr(),
        out.T.data_ptr(),
        op.h.data_ptr(), hT.data_ptr(), op.gains.data_ptr(), W.data_ptr(),
        sym_re.data_ptr(), sym_im.data_ptr(),
        B, cfg.Nt, cfg.Nr, Lin, Lout, cfg.Lh, _TRUNC[cfg.trunc], cfg.M,
        cfg.K, int(real_x(cfg)), int(bool(estimate_phi)), int(vec4(cfg.Mc)),
        float(np.float32(sigma2)), float(cfg.L), _recip(cfg.Lc),
        _recip(cfg.Mr), _recip(cfg.Na), cap_rem, smem_bytes(cfg),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("fused_scamp_decode launch failed: "
                           + lib.fused_scamp_error_string(rc).decode())
    launches += 1
    active = out.active > 0
    # Global counter semantics of the XLA loop (`scamp.py:72-73`): ran to
    # cap if any trial is still active, else stopped when the slowest
    # trial froze.
    t = max(int(s0.t), int(cap) if bool(active.any())
            else int(out.T.max()))
    return out._replace(active=active, t=t)
