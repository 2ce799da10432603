"""Rangan-style VAMP decoder with damping (vamp2) — batched, per-trial early
stopping, resumable.

Port of the JAX package's ``models/vamp2.py`` (reference ``vamp2.py``, the
side-by-side alternative to ``vamp.py``): denoiser first, damping
``rho = 0.97`` on ``xmmse`` and ``gamma`` (`vamp2.py:29,63,73`),
precision-style ``gamma`` bookkeeping clipped to ``[1e-11, 1e11]``
(`vamp2.py:48-49`), whitened data ``y_tilde = (y U^*)/s`` (`vamp2.py:22`),
the segmented denoiser without ``tau/2`` and with the second-moment
variance (`vamp2.py:79-88`), and the LMMSE correction
``r = r_tilde + eta V((d/mean(d)) (y_tilde - Vh r_tilde))`` with
``eta = N/p`` (`vamp2.py:26,77`).  As in the reference, ``gamma`` enters
the denoiser as its variance (`tests/test_decoders.py::
test_vamp2_runs_and_decodes`).

The whitening divides by ``s``, so vamp2 needs the direct SVD.  For a
config the CUDA kernel covers, :func:`decode` runs the whole decode
through :func:`..ops.kernels.fused_vamp2.whole_decode`; everything else,
and ``use_pallas=False``, runs the plain PyTorch loop on either device.

``precision='high'`` (``ops/precision.py``) whitens with four real
three-pass bf16 products and decodes through the kernel's HIGH form, whose
plain version is :func:`plain_loop_high`; the plain loop at HIGH is JAX's
XLA body at HIGH (`vamp2.py:166-167` there), its two products through
``ops/precision.py::matmul``, as in :mod:`.vamp`.  ``precision='default'``
is the same with the one-pass product (:func:`plain_loop_default`).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..ops import denoise
from ..ops import precision as prec
from .bamp import DecodeResult, _allclose_rows, _freeze
from .vamp import SVD, gauss_taps, kernel_route

_VAR_MIN = 1e-11        # `vamp2.py:48-49`
_VAR_MAX = 1e11
DAMPING = 0.97          # `vamp2.py:29`

# Decodes that ran the plain PyTorch loop (any device).
plain_decodes = 0


class VAMP2State(NamedTuple):
    r: torch.Tensor        # (B, N) complex — pseudo-data
    gamma: torch.Tensor    # (B, 1) f32
    var: torch.Tensor      # (B, N) f32
    xmmse: torch.Tensor    # (B, N) complex
    active: torch.Tensor   # (B,) bool
    T: torch.Tensor        # (B,) int32
    t: int                 # global iteration counter

    @property
    def xmap(self) -> torch.Tensor:
        """The decision statistic: the pseudo-data ``r``."""
        return self.r


def make_denoiser(cfg: Config, device):
    """The segmented posterior without ``tau/2`` and with the second-moment
    variance; in random mode the Bernoulli mixture (`vamp2.py:46`)."""
    symbols = torch.as_tensor(cfg.symbols, device=device)
    if cfg.mode in ("segmented", "sparc"):
        return partial(denoise.segmented_posterior, symbols=symbols,
                       L=cfg.L, M=cfg.M, halve_tau=False,
                       variance="second_moment")
    return partial(denoise.bernoulli_mixture_posterior, symbols=symbols,
                   Ps=cfg.Ps, P0=cfg.P0)


def whiten(dec: SVD, y: torch.Tensor,
           precision: str = "highest") -> torch.Tensor:
    """``y_tilde = (y U^*) / s`` (`vamp2.py:22`), shape (B, p); the
    product at ``precision``."""
    return denoise.div_real(prec.matmul(y, dec.U.conj(), precision),
                            dec.s[None, :])


def initial_state(y: torch.Tensor, cfg: Config) -> VAMP2State:
    """The decode's starting state (`vamp2.py:30-40`)."""
    B, N = y.shape[0], cfg.N
    dev = y.device
    return VAMP2State(
        r=torch.zeros((B, N), dtype=y.dtype, device=dev),
        gamma=torch.ones((B, 1), dtype=torch.float32, device=dev),
        var=torch.ones((B, N), dtype=torch.float32, device=dev),
        xmmse=torch.zeros((B, N), dtype=y.dtype, device=dev),
        active=torch.ones((B,), dtype=torch.bool, device=dev),
        T=torch.zeros((B,), dtype=torch.int32, device=dev),
        t=0)


def plain_loop(Vh: torch.Tensor, s2: torch.Tensor, y_tilde: torch.Tensor,
               s: VAMP2State, sigma2: float, cap: int, cfg: Config,
               precision: str = "highest") -> VAMP2State:
    """The plain PyTorch iteration loop from state ``s`` on the SVD factor
    ``Vh (p, N)`` with squared singular values ``s2 (p,)`` and whitened data
    ``y_tilde``: run until ``t`` reaches ``cap`` or every trial converged
    (`vamp2.py:147-180`), the two products at ``precision``."""
    global plain_decodes
    plain_decodes += 1
    noise_var = float(np.float32(sigma2))
    rho = DAMPING
    cap = int(cap)
    p, N = Vh.shape
    eta = N / p                                        # `vamp2.py:26` (N/p)
    s2 = s2.reshape(1, p)
    Vh_t, Vh_c = Vh.T, Vh.conj()
    mm = partial(prec.matmul, precision=prec.canonical(precision))
    denoiser = make_denoiser(cfg, y_tilde.device)
    while s.t < cap and bool(s.active.any()):
        # Denoiser and damping (`vamp2.py:62-63`).
        xmmse_new, var = denoiser(s.r, s.gamma)
        xmmse = rho * xmmse_new + (1.0 - rho) * s.xmmse
        alpha = var.mean(dim=1, keepdim=True) * s.gamma           # (B, 1)

        r_tilde = denoise.div_real(xmmse - alpha * s.r, 1.0 - alpha)
        gamma_tilde = torch.clamp(s.gamma * (1.0 - alpha) / alpha,
                                  _VAR_MIN, _VAR_MAX)

        d = s2 / (s2 + noise_var * gamma_tilde)                   # (B, p)
        d_mean = d.mean(dim=1, keepdim=True)
        gamma_new = gamma_tilde * d_mean / (eta - d_mean)      # `vamp2.py:72`
        gamma = rho * gamma_new + (1.0 - rho) * s.gamma

        w = (d / d_mean) * (y_tilde - mm(r_tilde, Vh_t))
        r = r_tilde + eta * mm(w, Vh_c)                        # `vamp2.py:77`

        converged = _allclose_rows(var, s.var)
        s = VAMP2State(
            r=_freeze(s.active, r, s.r),
            gamma=_freeze(s.active, gamma, s.gamma),
            var=_freeze(s.active, var, s.var),
            xmmse=_freeze(s.active, xmmse, s.xmmse),
            active=s.active & ~converged,
            T=torch.where(s.active, torch.full_like(s.T, s.t + 1), s.T),
            t=s.t + 1)
    return s


def plain_loop_high(Vh: torch.Tensor, s2: torch.Tensor, y_tilde: torch.Tensor,
                    s: VAMP2State, sigma2: float, cap: int, cfg: Config,
                    precision: str = "high") -> VAMP2State:
    """The plain loop at ``precision='high'``: the JAX kernel's iteration
    (``fused_vamp2.py:61-124``) step by step, with the Gauss combinations of
    ``vamp.gauss_taps``, ``dot3`` on each real product and ``rowsum3`` for
    ``alpha`` and ``d_mean``, which the kernel writes as products with
    ones; the rest as :func:`plain_loop`.  At ``precision='default'`` the
    same with ``dot1`` and ``rowsum1``."""
    dot, rowsum = prec.DOTS[precision]
    global plain_decodes
    plain_decodes += 1
    noise_var = float(np.float32(sigma2))
    rho = DAMPING
    cap = int(cap)
    p, N = Vh.shape
    eta = N / p
    s2 = s2.reshape(1, p)
    T0, T1, T2, T3, T4, T5 = gauss_taps(Vh)
    y_re, y_im = y_tilde.real, y_tilde.imag
    denoiser = make_denoiser(cfg, y_tilde.device)
    while s.t < cap and bool(s.active.any()):
        xmmse_new, var = denoiser(s.r, s.gamma)
        xmmse = rho * xmmse_new + (1.0 - rho) * s.xmmse
        alpha = rowsum(var) / N * s.gamma                        # (B, 1)

        r_tilde = denoise.div_real(xmmse - alpha * s.r, 1.0 - alpha)
        gamma_tilde = torch.clamp(s.gamma * (1.0 - alpha) / alpha,
                                  _VAR_MIN, _VAR_MAX)

        d = s2 / (s2 + noise_var * gamma_tilde)                   # (B, p)
        d_mean = rowsum(d) / p
        gamma_new = gamma_tilde * d_mean / (eta - d_mean)
        gamma = rho * gamma_new + (1.0 - rho) * s.gamma

        a, b = r_tilde.real, r_tilde.imag
        k1, k2, k3 = dot(a + b, T0), dot(a, T1), dot(b, T2)
        scale = d / d_mean
        w_re = scale * (y_re - (k1 - k3))
        w_im = scale * (y_im - (k1 + k2))
        k1, k2, k3 = dot(w_re + w_im, T3), dot(w_re, T4), dot(w_im, T5)
        r = torch.complex(a + eta * (k1 - k3), b + eta * (k1 + k2))

        converged = _allclose_rows(var, s.var)
        s = VAMP2State(
            r=_freeze(s.active, r, s.r),
            gamma=_freeze(s.active, gamma, s.gamma),
            var=_freeze(s.active, var, s.var),
            xmmse=_freeze(s.active, xmmse, s.xmmse),
            active=s.active & ~converged,
            T=torch.where(s.active, torch.full_like(s.T, s.t + 1), s.T),
            t=s.t + 1)
    return s


def plain_loop_default(Vh, s2, y_tilde, s: VAMP2State, sigma2: float,
                       cap: int, cfg: Config) -> VAMP2State:
    """The plain version of K4's DEFAULT form: :func:`plain_loop_high` at
    ``'default'``."""
    return plain_loop_high(Vh, s2, y_tilde, s, sigma2, cap, cfg, "default")


def decode(dec: SVD, y: torch.Tensor, sigma2, cfg: Config, *,
           state0: VAMP2State | None = None, iter_cap: int | None = None,
           return_state: bool = False, precision: str = "highest",
           use_pallas="auto"):
    """Run damped Rangan VAMP on a batch of trials sharing one (direct)
    SVD.  Arguments and dispatch as :func:`.vamp.decode`: a config the
    kernel covers runs the whole-decode CUDA kernel on the card and its
    plain version on the CPU; other configs, and ``use_pallas=False``, run
    the plain loop."""
    from ..ops.kernels import fused_vamp2

    precision = prec.canonical(precision)
    kernel = kernel_route(cfg, fused_vamp2.covers(cfg), use_pallas)
    if state0 is None:
        state0 = initial_state(y, cfg)
    cap = cfg.N_Layers if iter_cap is None else int(iter_cap)
    y_tilde = whiten(dec, y, precision)
    s2 = dec.s ** 2
    if kernel:
        s = fused_vamp2.whole_decode(dec.Vh, s2, y_tilde, state0, sigma2,
                                     cap, cfg, precision)
    else:
        s = plain_loop(dec.Vh, s2, y_tilde, state0, sigma2, cap, cfg,
                       precision)
    result = DecodeResult(xmap=s.r, xmmse=s.xmmse, var=s.var, T=s.T)
    if return_state:
        return result, s
    return result
