"""Bayesian AMP decoder — batched, per-trial early stopping, resumable.

Port of the JAX package's ``models/bamp.py`` (reference ``bamp.py``):
per-element-variance AMP with full Onsager correction (`bamp.py:48-64`),
the segmented softmax denoiser with its ``tau/2`` calibration
(`bamp.py:66-77`) or the i.i.d. Bernoulli-mixture denoiser in ``random``
mode (`bamp.py:79-97`), iteration cap ``N_Layers`` with ``allclose`` early
stopping on the posterior variance (`bamp.py:136-141`), and the reported
iteration count ``t+1`` (`bamp.py:142`).

Converged trials freeze while the rest of the batch iterates, so each
trial's ``T`` is what a one-trial decode reports.  On a banded operator
with a config the CUDA kernel covers, :func:`decode` runs the whole decode
through :func:`..ops.kernels.fused_bamp.whole_decode` (the kernel on the
card, its plain version on the CPU); everything else runs the plain
PyTorch loop below.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..ops import denoise, operators

# torch.allclose defaults (`bamp.py:140`)
_RTOL = 1e-5
_ATOL = 1e-8

# Decodes that ran the plain PyTorch loop (any device).
plain_decodes = 0


class BAMPState(NamedTuple):
    xmap: torch.Tensor    # (B, N) complex — pseudo-data r
    xmmse: torch.Tensor   # (B, N) complex — posterior mean
    var: torch.Tensor     # (B, N) f32    — posterior variance
    z: torch.Tensor       # (B, n) complex — corrected residual
    u: torch.Tensor       # (B, n) f32    — residual variance + sigma2
    active: torch.Tensor  # (B,)  bool    — not yet converged
    T: torch.Tensor       # (B,)  int32   — iterations run per trial
    t: int                #               — global iteration counter


class DecodeResult(NamedTuple):
    xmap: torch.Tensor
    xmmse: torch.Tensor
    var: torch.Tensor
    T: torch.Tensor       # (B,) int32 per-trial iterations (reference `t+1`)


def _allclose_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-trial ``torch.allclose(a, b)`` (`bamp.py:140`)."""
    return ((a - b).abs() <= _ATOL + _RTOL * b.abs()).all(dim=-1)


def _freeze(mask: torch.Tensor, new: torch.Tensor,
            old: torch.Tensor) -> torch.Tensor:
    """Keep ``old`` for trials that already converged (a selection, so a
    non-finite value in the discarded branch cannot leak)."""
    return torch.where(mask[:, None] if new.ndim == 2 else mask, new, old)


def make_denoiser(cfg: Config, device):
    """Denoiser selected from config (`bamp.py:43-46`).

    The ``tau/2`` halving (`bamp.py:68`) is the complex-Gaussian
    calibration; the real-valued channel mode uses no halving (and a
    doubled covariance in the mixture form).
    """
    symbols = torch.as_tensor(cfg.symbols, device=device)
    if cfg.mode in ("segmented", "sparc"):
        return partial(denoise.segmented_posterior, symbols=symbols,
                       L=cfg.L, M=cfg.M, halve_tau=cfg.is_complex,
                       variance="decomposed")
    if cfg.is_complex:
        return partial(denoise.bernoulli_mixture_posterior, symbols=symbols,
                       Ps=cfg.Ps, P0=cfg.P0)

    def real_denoiser(r, cov):
        return denoise.bernoulli_mixture_posterior(
            r, 2.0 * torch.as_tensor(cov), symbols=symbols, Ps=cfg.Ps,
            P0=cfg.P0)

    return real_denoiser


def initial_state(y: torch.Tensor, N: int, sigma2: float) -> BAMPState:
    """The decode's starting state (`bamp.py:113-121`)."""
    B, n = y.shape
    dev = y.device
    return BAMPState(
        xmap=torch.zeros((B, N), dtype=y.dtype, device=dev),
        xmmse=torch.zeros((B, N), dtype=y.dtype, device=dev),
        var=torch.ones((B, N), dtype=torch.float32, device=dev),
        z=y.clone(),
        u=torch.full((B, n), sigma2, dtype=torch.float32, device=dev),
        active=torch.ones((B,), dtype=torch.bool, device=dev),
        T=torch.zeros((B,), dtype=torch.int32, device=dev),
        t=0)


def plain_loop(op, s: BAMPState, y: torch.Tensor, sigma2: float, cap: int,
               cfg: Config) -> BAMPState:
    """The plain PyTorch iteration loop from state ``s``: run until ``t``
    reaches ``cap`` or every trial converged (`bamp.py:136-141`)."""
    global plain_decodes
    plain_decodes += 1
    sigma2 = float(np.float32(sigma2))
    cap = int(cap)
    denoiser = make_denoiser(cfg, y.device)
    cdtype = y.dtype
    while s.t < cap and bool(s.active.any()):
        # One AMP iteration (`bamp.py:59-64`).
        v = op.apply_abs2(s.var)                                 # (B, n)
        z = op.apply(s.xmmse) - denoise.div_real(v * (y - s.z),
                                                 s.u).to(cdtype)
        u = v + sigma2
        cov = 1.0 / op.apply_abs2T(1.0 / u)                      # (B, N)
        resid = denoise.div_real(y - z, u).to(cdtype)
        xmap = s.xmmse + cov * op.apply_adj(resid)
        xmmse, var = denoiser(xmap, cov)
        converged = _allclose_rows(var, s.var)
        s = BAMPState(
            xmap=_freeze(s.active, xmap, s.xmap),
            xmmse=_freeze(s.active, xmmse, s.xmmse),
            var=_freeze(s.active, var, s.var),
            z=_freeze(s.active, z, s.z),
            u=_freeze(s.active, u, s.u),
            active=s.active & ~converged,
            T=torch.where(s.active, torch.full_like(s.T, s.t + 1), s.T),
            t=s.t + 1)
    return s


def decode(H, y: torch.Tensor, sigma2, cfg: Config, *,
           state0: BAMPState | None = None, iter_cap: int | None = None,
           return_state: bool = False):
    """Run BAMP on a batch of trials sharing one channel operator.

    Args:
        H: (n, N) measurement matrix, or an operator from
            :mod:`..ops.operators`.
        y: (B, n) received vectors; the decode runs on ``y``'s device.
        sigma2: scalar noise variance ``(Na/Nr)/SNR`` (`bamp.py:134`).
        cfg: system config.
        state0 / iter_cap / return_state: resumable decoding — start from a
            previous :class:`BAMPState`, stop at ``iter_cap`` iterations
            (global count), and/or return the final state.  Splitting a
            decode at any cap and continuing yields the same trajectory.

    A banded operator with a config the kernel covers (complex segmented,
    sparc or random mode; whole trial in shared memory) goes through the
    whole-decode CUDA kernel on a CUDA device and its plain version on the
    CPU.  Other configs (dense operators, the real-channel mode, geometries
    too large for one block) run the plain PyTorch loop on either device,
    as the JAX package's ``use_pallas='auto'`` does.

    Returns:
        :class:`DecodeResult` (and the final :class:`BAMPState` when
        ``return_state``).
    """
    from ..ops.kernels import fused_bamp

    op = operators.as_operator(H)
    n, N = op.shape
    sigma2 = float(np.float32(sigma2))
    if state0 is None:
        state0 = initial_state(y, N, sigma2)
    cap = cfg.N_Layers if iter_cap is None else int(iter_cap)
    if isinstance(op, operators.BandedOperator) and fused_bamp.covers(cfg) \
            and fused_bamp.fits(cfg):
        s = fused_bamp.whole_decode(op, state0, y, sigma2, cap, cfg)
    else:
        s = plain_loop(op, state0, y, sigma2, cap, cfg)
    result = DecodeResult(xmap=s.xmap, xmmse=s.xmmse, var=s.var, T=s.T)
    if return_state:
        return result, s
    return result
