"""Spatially-coupled SPARC AMP (SCAMP) decoder — batched, per-trial early
stopping, resumable.

Port of the JAX package's ``models/scamp.py`` (reference ``scamp.py``): AMP
on the base matrix ``W (Lout, Lin)`` and the measurement operator ``A``,
with section variances ``psi (B, Lin)`` and residual variances
``phi (B, Lout)`` started at infinity (`scamp.py:21-22`), the
Onsager-corrected residual ``z = y - A xmmse + (gma/phi) (x) z``
(`scamp.py:45-48`), the effective noise ``tau = L / (W^T (1/phi)) / Mr``
(`scamp.py:52`), the mean-only segmented denoiser with ``tau/2``
(`scamp.py:61-68`), ``psi = 1 - sum |xmmse|^2 / Na`` per column block
(`scamp.py:59`) and the ``allclose`` early stop on ``psi``
(`scamp.py:101-106`).  ``estimate_phi`` takes ``phi`` as the empirical
per-block mean of ``|z|^2`` (the reference's ``estSCAMP``, `sparc.py:199`).

On a banded operator with a config the CUDA kernel covers, :func:`decode`
runs the whole decode through
:func:`..ops.kernels.fused_scamp.whole_decode` (the kernel on the card, its
plain version on the CPU); everything else, and ``use_pallas=False``, runs
the plain PyTorch loop (:func:`kernel_route`).

``decode(precision='high')`` runs the kernel at HIGHEST, as the JAX
package builds its SCAMP kernel without a precision (`scamp.py:125-130`
there), so there at HIGH only the realization's generation changes; the
plain loop runs JAX's XLA body at HIGH: the operator's products through
``ops/precision.py::matmul`` and the two base-matrix products
(``mm(psi, Wt)`` and ``mm(1/phi, W)`` there) in three bf16 passes
(:func:`base_product`).  ``precision='default'`` is the same with the
one-pass bf16 product in place of the three passes.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..ops import denoise, operators
from ..ops import precision as prec
from .bamp import DecodeResult, _allclose_rows, _freeze, check_use_pallas

# Decodes that ran the plain PyTorch loop (any device).
plain_decodes = 0


class SCAMPState(NamedTuple):
    xmap: torch.Tensor    # (B, N) complex
    xmmse: torch.Tensor   # (B, N) complex
    psi: torch.Tensor     # (B, Lin) f32 section variances
    phi: torch.Tensor     # (B, Lout) f32 residual variances
    z: torch.Tensor       # (B, n) complex
    active: torch.Tensor  # (B,) bool
    T: torch.Tensor       # (B,) int32
    t: int                # global iteration counter


def _expand(v: torch.Tensor, reps: int) -> torch.Tensor:
    """``repeat_interleave`` along the last axis (`scamp.py:48,53-54`)."""
    return v.repeat_interleave(reps, dim=-1)


def initial_state(y: torch.Tensor, cfg: Config) -> SCAMPState:
    """The decode's starting state (`scamp.py:146-156`)."""
    B = y.shape[0]
    dev = y.device
    return SCAMPState(
        xmap=torch.zeros((B, cfg.N), dtype=y.dtype, device=dev),
        xmmse=torch.zeros((B, cfg.N), dtype=y.dtype, device=dev),
        psi=torch.ones((B, cfg.Lc), dtype=torch.float32, device=dev),
        phi=torch.full((B, cfg.Lr), float("inf"), dtype=torch.float32,
                       device=dev),
        z=y.clone(),
        active=torch.ones((B,), dtype=torch.bool, device=dev),
        T=torch.zeros((B,), dtype=torch.int32, device=dev),
        t=0)


def base_product(a: torch.Tensor, m: torch.Tensor,
                 precision: str = "highest") -> torch.Tensor:
    """``a @ m.T`` for the small base-matrix products, ``(B, K) x (R, K)
    -> (B, R)``, as a product and a sum over its contiguous last axis, not
    a matmul: cuBLAS orders a small GEMM's sum by the batch size, and
    psi's stop test sees the last bit.  At ``'high'`` the three bf16
    passes of ``ops/precision.py::dot3``, grouped as it groups them, each
    in that form; at ``'default'`` the one pass of ``dot1`` (hi by hi)."""
    def rowdot(p, q):
        return (p[:, None, :] * q).sum(-1)

    precision = prec.canonical(precision)
    if precision == prec.HIGHEST:
        return rowdot(a, m)
    if precision == prec.DEFAULT:
        return rowdot(a.to(torch.bfloat16).float(),
                      m.to(torch.bfloat16).float())
    a_hi, a_lo = (t.float() for t in prec.split_bf16(a))
    m_hi, m_lo = (t.float() for t in prec.split_bf16(m))
    return rowdot(a_hi, m_hi) + (rowdot(a_hi, m_lo) + rowdot(a_lo, m_hi))


def plain_loop(op, W: torch.Tensor, s: SCAMPState, y: torch.Tensor,
               sigma2: float, cap: int, cfg: Config,
               estimate_phi: bool = False,
               precision: str = "highest") -> SCAMPState:
    """The plain PyTorch iteration loop from state ``s``: run until ``t``
    reaches ``cap`` or every trial converged (`scamp.py:167-200`).  ``W``
    is the float32 base matrix on ``y``'s device; the operator's and the
    base matrix's products at ``precision``."""
    global plain_decodes
    plain_decodes += 1
    sigma2 = float(np.float32(sigma2))
    cap = int(cap)
    B = y.shape[0]
    Lc, Lr, Mc, Mr, L = cfg.Lc, cfg.Lr, cfg.Mc, cfg.Mr, cfg.L
    cdtype = y.dtype
    Wt = W.T.contiguous()
    denoiser = partial(denoise.segmented_posterior,
                       symbols=torch.as_tensor(cfg.symbols, device=y.device),
                       L=L, M=cfg.M, halve_tau=cfg.is_complex, variance=None)
    # (Wt is contiguous so that base_product's last axis is too.)
    while s.t < cap and bool(s.active.any()):
        gma = base_product(s.psi, W, precision) / Lc             # (B, Lr)
        b = gma / s.phi             # 0 on the first iteration (phi = inf)
        z = (y - op.apply(s.xmmse, precision)
             + _expand(b, Mr).to(cdtype) * s.z)
        if estimate_phi:
            # `sparc.py:199`: empirical residual variance per output block
            phi = (z.abs() ** 2).reshape(B, Lr, Mr).sum(-1) / Mr
        else:
            phi = sigma2 + gma                                  # `scamp.py:50`
        tau = L / base_product(1.0 / phi, Wt, precision) / Mr    # (B, Lc)
        tau_use = _expand(tau, Mc)                               # (B, N)
        resid = denoise.div_real(z, _expand(phi, Mr))
        xmap = s.xmmse + tau_use * op.apply_adj(resid, precision)
        xmmse, _ = denoiser(xmap, tau_use)
        psi = 1.0 - (xmmse.abs() ** 2).reshape(B, Lc, Mc).sum(-1) / cfg.Na
        converged = _allclose_rows(psi, s.psi)
        s = SCAMPState(
            xmap=_freeze(s.active, xmap, s.xmap),
            xmmse=_freeze(s.active, xmmse, s.xmmse),
            psi=_freeze(s.active, psi, s.psi),
            phi=_freeze(s.active, phi, s.phi),
            z=_freeze(s.active, z, s.z),
            active=s.active & ~converged,
            T=torch.where(s.active, torch.full_like(s.T, s.t + 1), s.T),
            t=s.t + 1)
    return s


def kernel_route(cfg: Config, banded: bool, use_pallas="auto") -> bool:
    """True when :func:`decode` runs the kernel: a banded operator and a
    config the kernel covers and fits, unless ``use_pallas`` is False.
    ``use_pallas=True`` raises where no kernel covers the config or the
    operator is dense (JAX's honest knob, `scamp.py:117-124` there); a
    geometry that does not fit still takes the plain loop, as in JAX."""
    from ..ops.kernels import fused_scamp

    check_use_pallas(use_pallas)
    if use_pallas is False:
        return False
    covered = banded and fused_scamp.covers(cfg)
    if use_pallas is True and not covered:
        raise ValueError(
            "use_pallas=True: the SCAMP kernel needs a banded operator and "
            f"covers complex segmented/sparc alphabets, not mode="
            f"{cfg.mode!r} is_complex={cfg.is_complex} on a "
            f"{'banded' if banded else 'dense'} operator")
    return covered and fused_scamp.fits(cfg)


def decode(W, A, y: torch.Tensor, sigma2, cfg: Config, *,
           estimate_phi: bool = False, state0: SCAMPState | None = None,
           iter_cap: int | None = None, return_state: bool = False,
           precision: str = "highest", use_pallas="auto"):
    """Run SCAMP on a batch of trials sharing one ``(W, A)`` realization.

    Args:
        W: (Lout, Lin) base matrix (tensor or NumPy).
        A: (n, N) measurement matrix, or an operator from
            :mod:`..ops.operators`.
        y: (B, n) received vectors; the decode runs on ``y``'s device.
        sigma2: scalar noise variance.
        cfg: system config (``mode='sparc'``).
        estimate_phi: empirical residual variance (estSCAMP).
        state0 / iter_cap / return_state: resumable decoding, as in
            :func:`.bamp.decode`.
        precision: 'highest' (default), 'high' or 'default' (module
            docstring): the kernel at HIGHEST always, the plain loop at
            ``precision``.
        use_pallas: 'auto' (default), True or False (:func:`kernel_route`).

    A banded operator with a config the kernel covers (complex
    segmented/sparc alphabets; whole trial in shared memory) goes through
    the whole-decode CUDA kernel on a CUDA device and its plain version on
    the CPU.  Other configs (dense operators, the real-channel mode,
    geometries too large for one block) run the plain PyTorch loop on
    either device, as the JAX package falls back to XLA where no trial
    tile fits VMEM.

    Returns:
        :class:`.bamp.DecodeResult` with ``var = 1 - psi`` (and the final
        :class:`SCAMPState` when ``return_state``).
    """
    from ..ops.kernels import fused_scamp

    precision = prec.canonical(precision)
    op = operators.as_operator(A)
    kernel = kernel_route(cfg, isinstance(op, operators.BandedOperator),
                          use_pallas)
    if not torch.is_tensor(W):
        W = torch.from_numpy(np.array(W, dtype=np.float32))
    W = W.to(device=y.device, dtype=torch.float32).contiguous()
    sigma2 = float(np.float32(sigma2))
    if state0 is None:
        state0 = initial_state(y, cfg)
    cap = cfg.N_Layers if iter_cap is None else int(iter_cap)
    if kernel:
        s = fused_scamp.whole_decode(op, W, state0, y, sigma2, cap, cfg,
                                     estimate_phi)
    else:
        s = plain_loop(op, W, state0, y, sigma2, cap, cfg, estimate_phi,
                       precision)
    result = DecodeResult(xmap=s.xmap, xmmse=s.xmmse, var=1.0 - s.psi, T=s.T)
    if return_state:
        return result, s
    return result
