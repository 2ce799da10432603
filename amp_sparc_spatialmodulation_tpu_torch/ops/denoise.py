"""Shrinkage / denoiser library — pure functions over (B, N) pseudo-data.

Port of the JAX package's ``ops/denoise.py``:

* :func:`segmented_posterior`   — softmax posterior over (antenna, symbol)
  per segment, with BAMP's ``tau/2`` calibration as a flag (`bamp.py:68`)
  and the decomposed (`bamp.py:74-76`) or second-moment (`vamp2.py:87`)
  variance.
* :func:`bernoulli_mixture_posterior` — i.i.d. Bernoulli-symbol-mixture
  posterior for ``random`` mode (`bamp.py:79-97`, `shrink.py:78-96`).
* :func:`shrink_with_derivative` — posterior mean and analytic derivative
  for scalar Onsager terms (`shrink.py:98-119`).
* :func:`lasso`                 — soft threshold (`shrink.py:121-137`).
* :func:`shrink_ook`            — LLR-form OOK posterior (`shrink.py:139-157`).
* :func:`sw_shrink_ook`         — segment-wise OOK softmax (`shrink.py:58-76`).

No decoder calls the last four; they complete the library, as in JAX.

The softmax is stabilized by the per-segment maximum, as in the JAX
package; overflow clamps follow ``regularize_exp`` (`shrink.py:163-166`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

_EXP_MAX = float(np.log(np.finfo(np.float32).max)) - 1.0  # `shrink.py:163-166`
_TOL = 1e-9


def regularize_exp(a: torch.Tensor) -> torch.Tensor:
    """Clamp exponent arguments below float32 overflow (`shrink.py:163-166`)."""
    return torch.clamp(a, max=_EXP_MAX)


def regularize_zero(a: torch.Tensor, tol: float = _TOL) -> torch.Tensor:
    """Replace exact zeros to avoid 0/0 (`shrink.py:159-161`)."""
    return torch.where(a == 0.0, torch.full_like(a, tol), a)


def div_real(z: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``z / d`` for a real ``d``, componentwise when ``z`` is complex.

    PyTorch divides a complex tensor by a real one through complex
    division, which can round the quotient of equal reals to 1 - 2^-24;
    the componentwise form rounds each part once, as XLA does, and keeps
    converged posteriors from fluttering the 1e-5 stop test."""
    if z.is_complex():
        return torch.complex(z.real / d, z.imag / d)
    return z / d


def _as_real(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Posterior mean in the pseudo-data's type: complex64 for complex
    ``like``, the float32 real part otherwise."""
    if like.is_complex():
        return x.to(torch.complex64)
    return (x.real if x.is_complex() else x).to(torch.float32)


def _broadcast(a, r: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32,
                           device=r.device).broadcast_to(r.shape)


def segmented_posterior(r: torch.Tensor, tau, symbols: torch.Tensor,
                        L: int, M: int, *, halve_tau: bool,
                        variance: Optional[str] = "decomposed",
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Posterior mean (and variance) under the one-active-per-segment prior.

    Args:
        r: pseudo-data, shape (B, N) with N = L*M.
        tau: effective noise variance — scalar, (B, 1)-broadcastable, or
            per-element (B, N).
        symbols: (K,) complex64 symbol table on ``r``'s device.
        L, M: segment count / segment size.
        halve_tau: apply the ``tau/2`` calibration of BAMP/SCAMP.
        variance: None (mean only), "decomposed", "second_moment", or
            "closed" for K=1 only: ``|s0|^2 p (1 - p)``, the form of the
            JAX per-iteration kernel's denoiser (`fused_bamp.py:551-564`),
            equal to the decomposed variance up to rounding.

    Returns:
        (xmmse, var): (B, N) posterior mean in ``r``'s type and (B, N)
        float32 posterior variance (None when ``variance`` is None).
    """
    B = r.shape[0]
    K = symbols.shape[0]
    if variance == "closed" and K != 1:
        raise ValueError("the closed-form variance needs a K=1 alphabet")
    if K == 1:
        return _segmented_posterior_k1(r, tau, symbols, L, M,
                                       halve_tau=halve_tau,
                                       variance=variance)
    s = r.reshape(B, L, M, 1)
    tau_e = _broadcast(tau, r).reshape(B, L, M, 1)
    if halve_tau:
        tau_e = tau_e / 2.0
    # t[b,l,m,k] = Re( (r/tau) * conj(s_k) )
    t = (div_real(s, tau_e) * symbols.conj()).real
    t = t - t.amax(dim=(2, 3), keepdim=True)
    eta = torch.exp(regularize_exp(t))                     # (B, L, M, K)
    eta_mk = eta.sum(dim=-1)                               # (B, L, M)
    eta2 = eta_mk.sum(dim=2, keepdim=True)                 # (B, L, 1)
    xmmse = div_real((symbols * eta).sum(dim=-1), eta2)     # (B, L, M)
    out = _as_real(xmmse.reshape(B, L * M), r)
    if variance is None:
        return out, None
    if variance == "decomposed":
        var0 = xmmse.abs() ** 2 * (1.0 - eta_mk / eta2)
        vars_ = ((xmmse[..., None] - symbols).abs() ** 2 * eta
                 ).sum(dim=-1) / eta2
        var = var0 + vars_
    elif variance == "second_moment":
        var = ((symbols.abs() ** 2 * eta).sum(dim=-1) / eta2
               - xmmse.abs() ** 2)
    else:
        raise ValueError(f"unknown variance form {variance!r}")
    return out, var.reshape(B, L * M).to(torch.float32)


def _segmented_posterior_k1(r: torch.Tensor, tau, symbols: torch.Tensor,
                            L: int, M: int, *, halve_tau: bool,
                            variance: Optional[str]):
    """Single-symbol (OOK-style) path of :func:`segmented_posterior`: the
    same arithmetic on the flat ``(B, N)`` layout, with only the segment
    max/sum reductions on the ``(B, L, M)`` view."""
    B = r.shape[0]
    s0 = symbols[0]
    tau_e = _broadcast(tau, r)
    if halve_tau:
        tau_e = tau_e / 2.0
    t = (div_real(r, tau_e) * s0.conj()).real              # (B, N)
    seg_max = t.reshape(B, L, M).amax(dim=-1)              # (B, L)
    t = t - seg_max.repeat_interleave(M, dim=-1)
    eta = torch.exp(regularize_exp(t))
    eta2 = eta.reshape(B, L, M).sum(dim=-1).repeat_interleave(M, dim=-1)
    post = eta / eta2                                      # (B, N) real
    xmmse = s0 * post
    out = _as_real(xmmse, r)
    if variance is None:
        return out, None
    abs_x2 = xmmse.abs() ** 2
    if variance == "decomposed":
        var = abs_x2 * (1.0 - post) + (xmmse - s0).abs() ** 2 * post
    elif variance == "second_moment":
        var = s0.abs() ** 2 * post - abs_x2
    elif variance == "closed":
        var = s0.abs() ** 2 * post * (1.0 - post)
    else:
        raise ValueError(f"unknown variance form {variance!r}")
    return out, var.to(torch.float32)


def bernoulli_mixture_posterior(r: torch.Tensor, cov, symbols: torch.Tensor,
                                Ps: float, P0: float,
                                with_variance: bool = True):
    """i.i.d. Bernoulli-symbol-mixture posterior (`bamp.py:79-97`):
    ``p(x) = P0*delta(x) + Ps*sum_k delta(x - s_k)`` under a Gaussian
    likelihood of variance ``cov``."""
    cov = _broadcast(cov, r)
    d = r[..., None] - symbols                              # (..., K)
    Gs = torch.exp(-regularize_exp(d.abs() ** 2 / cov[..., None]))
    G0 = torch.exp(-regularize_exp(r.abs() ** 2 / cov))
    norm = regularize_zero(P0 * G0 + Ps * Gs.sum(dim=-1))
    mean = _as_real(div_real(Ps * (symbols * Gs).sum(dim=-1), norm), r)
    if not with_variance:
        return mean, None
    second = Ps * (symbols.abs() ** 2 * Gs).sum(dim=-1) / norm
    var = second - mean.abs() ** 2
    return mean, var.to(torch.float32)


def shrink_with_derivative(r: torch.Tensor, cov, symbols: torch.Tensor,
                           Ps: float, P0: float):
    """Posterior mean and analytic derivative for Onsager terms
    (`shrink.py:98-119`), both complex64."""
    cov = _broadcast(cov, r)[..., None]
    d = r[..., None] - symbols                              # (..., K)
    Gs = torch.exp(-regularize_exp(d.abs() ** 2 / cov))
    ds = 2.0 * d.abs() * torch.sign((symbols - r[..., None]).real) / cov
    cov = cov[..., 0]
    G0 = torch.exp(-regularize_exp(r.abs() ** 2 / cov))
    d0 = 2.0 * r.abs() * torch.sign(-r.real) / cov
    dG0, dGs = d0 * G0, ds * Gs
    norm = P0 * G0 + Ps * Gs.sum(dim=-1) + _TOL
    mean = div_real(Ps * (symbols * Gs).sum(dim=-1), norm)
    dnorm = P0 * dG0 + Ps * dGs.sum(dim=-1)
    sdGs = Ps * (symbols * dGs).sum(dim=-1)
    der = div_real(sdGs * norm - mean * dnorm, norm ** 2)
    return mean, der


def lasso(r: torch.Tensor, cov, lmda: float = 1.0):
    """Soft-threshold shrinkage (`shrink.py:121-137`): ``(F, G)``."""
    cov = _broadcast(cov, r)
    F = torch.sign(r.real) * torch.maximum(r.abs(), lmda * cov)
    G = cov * torch.where(r.abs() < cov, 0.0, 1.0)
    return F, G


def shrink_ook(r: torch.Tensor, cov, Ps: float, P0: float):
    """LLR-form OOK posterior mean (complex64) and the mean of its
    derivative (`shrink.py:139-157`)."""
    theta = float(np.log(P0 / Ps))
    cov = torch.as_tensor(cov, dtype=torch.float32, device=r.device)
    eta = torch.exp(regularize_exp(theta + (1.0 - 2.0 * r.real) / cov))
    mean = 1.0 / (1.0 + eta + _TOL)
    der = torch.nan_to_num(2.0 * eta * mean ** 2 / cov, nan=0.0)
    return mean.to(torch.complex64), der.mean()


def sw_shrink_ook(r: torch.Tensor, cov, L: int, M: int):
    """Segment-wise OOK softmax posterior (`shrink.py:58-76`): the mean
    (complex64) and variance (float32), shape (B, L*M)."""
    B = r.shape[0]
    cov = _broadcast(cov, r)
    Lr = ((2.0 * r.real - 1.0) / cov).reshape(B, L, M)
    exp_Lr = torch.exp(regularize_exp(Lr))
    sum_exp = exp_Lr.sum(dim=-1, keepdim=True)
    Le = -torch.log(torch.clamp(sum_exp - exp_Lr, min=_TOL))
    eta = torch.exp(regularize_exp(Lr + Le))
    mean = eta / (1.0 + eta)
    var = mean * (1.0 - mean)
    return (mean.reshape(B, L * M).to(torch.complex64),
            var.reshape(B, L * M).to(torch.float32))
