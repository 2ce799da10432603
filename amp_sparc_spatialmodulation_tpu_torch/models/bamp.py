"""Bayesian AMP decoder — batched, per-trial early stopping, resumable.

Port of the JAX package's ``models/bamp.py`` (reference ``bamp.py``):
per-element-variance AMP with full Onsager correction (`bamp.py:48-64`),
the segmented softmax denoiser with its ``tau/2`` calibration
(`bamp.py:66-77`) or the i.i.d. Bernoulli-mixture denoiser in ``random``
mode (`bamp.py:79-97`), iteration cap ``N_Layers`` with ``allclose`` early
stopping on the posterior variance (`bamp.py:136-141`), and the reported
iteration count ``t+1`` (`bamp.py:142`).

Converged trials freeze while the rest of the batch iterates, so each
trial's ``T`` is what a one-trial decode reports.  :func:`decode` picks
its route with :func:`route`, the JAX package's chain of
``models/bamp.py:256-295``: the whole-decode kernel K1
(:mod:`..ops.kernels.fused_bamp`), the per-iteration kernel K6
(:mod:`..ops.kernels.fused_bamp_iteration`) or the frame-tiled iteration
kernel K5 (:mod:`..ops.kernels.fused_bamp_tiled`), else the plain PyTorch
loop.  The per-iteration kernels run inside :func:`plane_loop`.  On the CPU
each kernel's wrapper runs its plain version.

``decode(precision='high')`` is the JAX decoder's ``precision=HIGH``
(`bamp.py:195` there) on the routes that have it: K1 runs its HIGH form,
whose plain version is :func:`plain_loop_high` (the JAX kernel's
``_linear_iteration`` at HIGH step by step: per-tap gains folded into the
Gauss tap planes of :func:`gauss_taps`, three-pass bf16 products); K5 runs
its HIGH form inside :func:`plane_loop`, whose plain version is one
:func:`step` with :func:`linear_step_high` for a real x (the JAX kernel
``fused_bamp_tiled.py:47`` with ``make_dot(HIGH)``); K6 runs at HIGHEST,
as in JAX, whose per-iteration kernel has no precision knob
(`fused_bamp.py:409` there); the plain loop runs the JAX decoder's XLA body
at HIGH (`bamp.py:333-352` there, each operator map's products through
``ops/precision.py::matmul``), a different function from
:func:`linear_step_high`.  Where K1's form holds no trial in one block
and JAX's K1 takes the batch, K1 runs as a thread-block cluster of blocks
a trial (:func:`route`); where neither K1 takes it, the route falls
through to the next link, as JAX's does (`bamp.py:241-283`).

``decode(precision='default')`` is the JAX decoder's ``precision=DEFAULT``,
the one-pass bf16 product (``ops/precision.py::dot1``), on the same chain
with DEFAULT in place of HIGH: K1's DEFAULT form (plain version
:func:`plain_loop_default`, :func:`linear_step_high` with ``dot1``), K6 at
HIGHEST, K5's DEFAULT form, the plain loop's products at DEFAULT.

``AMP_KERNEL_XMAP_PRECISION`` is the JAX whole-decode kernel's knob for
the precision of its xmap chain (`fused_bamp.py:990-991` there): where it
names another precision than the decode's, K1 runs a split form, the
variance chain (``Pv``, ``cov``; the stop test reads them) at
``precision`` and the xmap chain at the variable's (plain version
:func:`plain_loop_split`); as in JAX, no other link of the chain reads it.

``decode(use_pallas=...)`` is the JAX decoder's knob: ``'auto'`` (the
default) takes :func:`route`'s chain, ``False`` the plain loop, and
``True`` the chain too but raises where no kernel covers the config or the
operator is dense, as JAX's does (`bamp.py:241-249`).
"""
from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import Config
from ..ops import denoise, operators
from ..ops import precision as prec

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


class PlaneState(NamedTuple):
    """BAMP state in the per-iteration kernels' layout: split-real float32
    planes, trial-major — x-side (B, N) = (B, Lin, Nt), y-side (B, n) =
    (B, Lout, Nr).  The JAX package's planes are the same blocks in
    (Lin, B, Nt) / (Lout, B, Nr) order (:mod:`..interop` converts)."""

    xmap_re: torch.Tensor
    xmap_im: torch.Tensor
    xm_re: torch.Tensor
    xm_im: torch.Tensor
    var: torch.Tensor
    z_re: torch.Tensor
    z_im: torch.Tensor
    u: torch.Tensor
    active: torch.Tensor
    T: torch.Tensor
    t: int


class IterOut(NamedTuple):
    """One iteration of the per-iteration kernels (the JAX ``plane_call``
    outputs): the new planes, frozen for trials whose ``active`` is False
    except ``xmap``, which :func:`plane_loop` freezes (the kernels leave it
    unwritten for them), and ``notok``, each trial's count of posterior
    variance entries outside the allclose tolerance (0 for a frozen trial;
    0 for an active one means it converged)."""

    xmap_re: torch.Tensor
    xmap_im: torch.Tensor
    xm_re: torch.Tensor
    xm_im: torch.Tensor
    var: torch.Tensor
    z_re: torch.Tensor
    z_im: torch.Tensor
    u: torch.Tensor
    notok: torch.Tensor   # (B,) int32


def _allclose_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-trial ``torch.allclose(a, b)`` (`bamp.py:140`)."""
    return ((a - b).abs() <= _ATOL + _RTOL * b.abs()).all(dim=-1)


def _freeze(mask: torch.Tensor, new: torch.Tensor,
            old: torch.Tensor) -> torch.Tensor:
    """Keep ``old`` for trials that already converged (a selection, so a
    non-finite value in the discarded branch cannot leak)."""
    return torch.where(mask[:, None] if new.ndim == 2 else mask, new, old)


def _notok_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-trial count of the entries where :func:`_allclose_rows` fails;
    0 exactly where it holds."""
    close = (a - b).abs() <= _ATOL + _RTOL * b.abs()
    return (~close).sum(dim=-1, dtype=torch.int32)


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


def make_k1_denoiser(cfg: Config, device):
    """The per-iteration kernel K6's denoiser: the K=1 segmented posterior
    with tau/2 and the closed-form variance ``|s0|^2 p (1 - p)``
    (`fused_bamp.py:551-564` of the JAX package)."""
    return partial(denoise.segmented_posterior,
                   symbols=torch.as_tensor(cfg.symbols, device=device),
                   L=cfg.L, M=cfg.M, halve_tau=True, variance="closed")


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


def linear_step(op, xmmse, var, z, u, y, sigma2: float,
                precision: str = "highest"):
    """The linear half of one AMP iteration (`bamp.py:59-63`): returns
    ``(xmap, cov, z, u)``, each operator map's products at ``precision``
    (the JAX decoder's XLA body, `bamp.py:333-352` there).  At
    ``'highest'`` the plain version of kernel K7."""
    v = op.apply_abs2(var, precision)                            # (B, n)
    z = (op.apply(xmmse, precision)
         - denoise.div_real(v * (y - z), u).to(y.dtype))
    u = v + sigma2
    cov = 1.0 / op.apply_abs2T(1.0 / u, precision)               # (B, N)
    resid = denoise.div_real(y - z, u).to(y.dtype)
    xmap = xmmse + cov * op.apply_adj(resid, precision)
    return xmap, cov, z, u


def step(op, s: BAMPState, y: torch.Tensor, sigma2: float, denoiser,
         linear=linear_step) -> Tuple[BAMPState, torch.Tensor]:
    """One AMP iteration from ``s`` (`bamp.py:59-64`, `:136-142`): the
    new state, frozen for converged trials, and each trial's count of
    variance entries outside the allclose tolerance (``notok``; 0 means
    converged).  The plain version of kernel K5 with the config's
    denoiser, of kernel K6 with :func:`make_k1_denoiser`.  ``linear`` runs
    the linear half: :func:`linear_step`, or kernel K7's wrapper, as the
    JAX loop body can take it (`bamp.py:335-336`)."""
    xmap, cov, z, u = linear(op, s.xmmse, s.var, s.z, s.u, y, sigma2)
    xmmse, var = denoiser(xmap, cov)
    notok = _notok_rows(var, s.var)
    return BAMPState(
        xmap=_freeze(s.active, xmap, s.xmap),
        xmmse=_freeze(s.active, xmmse, s.xmmse),
        var=_freeze(s.active, var, s.var),
        z=_freeze(s.active, z, s.z),
        u=_freeze(s.active, u, s.u),
        active=s.active & (notok > 0),
        T=torch.where(s.active, torch.full_like(s.T, s.t + 1), s.T),
        t=s.t + 1), notok


def plain_loop(op, s: BAMPState, y: torch.Tensor, sigma2: float, cap: int,
               cfg: Config, precision: str = "highest") -> BAMPState:
    """The plain PyTorch iteration loop from state ``s``: run until ``t``
    reaches ``cap`` or every trial converged (`bamp.py:136-141`), the
    operator's products at ``precision`` (:func:`linear_step`)."""
    global plain_decodes
    plain_decodes += 1
    sigma2 = float(np.float32(sigma2))
    cap = int(cap)
    denoiser = make_denoiser(cfg, y.device)
    linear = partial(linear_step, precision=prec.canonical(precision))
    while s.t < cap and bool(s.active.any()):
        s, _ = step(op, s, y, sigma2, denoiser, linear)
    return s


class GaussTaps(NamedTuple):
    """The eight float32 tap planes of the JAX whole-decode kernel's Gauss
    complex products (``FusedBandedDecode._fold_taps``, `fused_bamp.py:
    885-933` there), ``W = Lh*Nr`` columns in tap-stack order ``l*Nr + m``.
    With ``folded`` each tap's gain is folded in (``S = h_stack * g``,
    ``S_a2 = |h_stack|^2 * g^2``); without, the gains are 1 here and
    multiply after the products."""

    s_a2: torch.Tensor    # (Nt, W) |S|^2: the variance product
    s_re: torch.Tensor    # (Nt, W) Re S: k1's
    dmc: torch.Tensor     # (Nt, W) Im S - Re S: k2's
    cpd: torch.Tensor     # (Nt, W) Re S + Im S: k3's (complex x)
    st_a2: torch.Tensor   # (W, Nt) |S|^2 transposed: cov's
    st_re: torch.Tensor   # (W, Nt) Re S^T: the adjoint's k1
    amc: torch.Tensor     # (W, Nt) -Im S^T - Re S^T: its k2
    adm: torch.Tensor     # (W, Nt) Re S^T - Im S^T: its k3
    folded: bool


def gains_per_tap(op) -> bool:
    """True when every column block shares each tap's gain
    (``_gains_per_tap``, `fused_bamp.py:865-883` of the JAX package): every
    tail or cyclic SPARC operator and the unit-gain Toeplitz channel."""
    g = op.gains
    return bool(g.numel() and torch.equal(g, g[:, :1].expand_as(g)))


def gauss_taps(op) -> GaussTaps:
    """The :class:`GaussTaps` of banded operator ``op``, the JAX kernel's
    rule: gains folded where :func:`gains_per_tap` holds."""
    folded = gains_per_tap(op)
    if folded:
        lane = op.gains[:, 0].repeat_interleave(op.Nr)[None, :]
        s_re = op.h_stack.real * lane
        s_im = op.h_stack.imag * lane
        s_a2 = op.abs_h2_stack * (lane * lane)
    else:
        s_re, s_im, s_a2 = op.h_stack.real, op.h_stack.imag, op.abs_h2_stack
    st_re, st_im = s_re.T, s_im.T
    planes = (s_a2, s_re, s_im - s_re, s_re + s_im, s_a2.T, st_re,
              -st_im - st_re, st_re - st_im)
    return GaussTaps(*(t.contiguous() for t in planes), folded=folded)


def linear_step_high(op, xmmse, var, z, u, y, sigma2: float, *,
                     taps: GaussTaps, real_x: bool, dot=prec.dot3,
                     dot_x=None):
    """The linear half of one iteration at ``precision='high'``, the JAX
    kernel's ``_linear_iteration`` (`fused_bamp.py:144-352`) with
    ``make_dot(HIGH)`` and ``cmul='gauss'`` step by step: the forward's
    Gauss products ``k1 = dot3(a + b, S_re)``, ``k2 = dot3(a, Im S - Re S)``,
    ``k3 = dot3(b, Re S + Im S)`` of ``x = a + ib`` (a real x skips ``b``:
    ``k1 = dot3(a, S_re)``), the variance product ``dot3(var, S_a2)``, the
    gains after the products unless folded, the taps summed per output row
    in tap order, ``w = v / u``, ``z' = hx - w (y - z)``, ``u' = v +
    sigma2``, the adjoint inputs ``1/u'``, ``(y - z') / u'`` gathered per
    (column block, tap), ``cov = 1 / dot3(Zc, S_a2^T)`` and the adjoint's
    Gauss products on ``A + B``, ``A``, ``B``.  ``dot`` is the real
    product (``precision.dot3``; a study passes another to see how far the
    decode moves with its rounding).  ``dot_x``, where given, is the xmap
    chain's product in place of ``dot`` (JAX's ``dot_x``,
    `fused_bamp.py:185` there): the forward's and the adjoint's Gauss
    products; ``dot`` stays the variance chain's (``Pv`` and ``cov``).
    Returns ``(xmap, cov, z, u)`` like :func:`linear_step`."""
    B = y.shape[0]
    Lin, Lout, Lh, Nt, Nr = op.Lin, op.Lout, op.Lh, op.Nt, op.Nr
    W = Lh * Nr
    d = dot
    dx = dot if dot_x is None else dot_x
    xr = xmmse.real.reshape(B * Lin, Nt)
    Pv = d(var.reshape(B * Lin, Nt), taps.s_a2)
    if real_x:
        k1 = dx(xr, taps.s_re)
        Pr, Pi = k1, k1 + dx(xr, taps.dmc)
    else:
        xi = xmmse.imag.reshape(B * Lin, Nt)
        k1 = dx(xr + xi, taps.s_re)
        k2, k3 = dx(xr, taps.dmc), dx(xi, taps.cpd)
        Pr, Pi = k1 - k3, k1 + k2
    if not taps.folded:
        # (B*Lin, W) gain planes: row block c, column group l holds
        # gains[l, c] (`fused_bamp.py:856-863`)
        Gf = op.gains.T.repeat_interleave(Nr, dim=1).repeat(B, 1)
        G2f = Gf * Gf
        Pv, Pr, Pi = G2f * Pv, Gf * Pr, Gf * Pi

    dev = y.device
    bands = [(l, torch.as_tensor(rows, device=dev),
              torch.as_tensor(cols, device=dev))
             for l, rows, cols in op._taps]

    def fold(P):
        P = P.reshape(B, Lin, Lh, Nr)
        acc = torch.zeros((B, Lout, Nr), dtype=P.dtype, device=P.device)
        for l, rows, cols in bands:
            acc[:, rows] = acc[:, rows] + P[:, cols, l]
        return acc

    v, hx_re, hx_im = fold(Pv), fold(Pr), fold(Pi)
    shape = (B, Lout, Nr)
    u, y_re, y_im = u.reshape(shape), y.real.reshape(shape), y.imag.reshape(
        shape)
    w = v / u
    zn_re = hx_re - w * (y_re - z.real.reshape(shape))
    zn_im = hx_im - w * (y_im - z.imag.reshape(shape))
    un = v + sigma2
    uinv = 1.0 / un
    rr = (y_re - zn_re) * uinv
    ri = (y_im - zn_im) * uinv

    def gather(plane):
        Z = torch.zeros((B, Lin, Lh, Nr), dtype=plane.dtype,
                        device=plane.device)
        for l, rows, cols in bands:
            Z[:, cols, l] = plane[:, rows]
        return Z.reshape(B * Lin, W)

    Zc, A, Bp = gather(uinv), gather(rr), gather(ri)
    if not taps.folded:
        Zc, A, Bp = G2f * Zc, Gf * A, Gf * Bp
    cov = 1.0 / d(Zc, taps.st_a2)
    k1 = dx(A + Bp, taps.st_re)
    k2, k3 = dx(A, taps.amc), dx(Bp, taps.adm)
    adj_re, adj_im = k1 - k3, k1 + k2
    xmap_re = xr + cov * adj_re
    xmap_im = cov * adj_im if real_x else xi + cov * adj_im
    xmap = torch.complex(xmap_re, xmap_im).reshape(B, Lin * Nt)
    z = torch.complex(zn_re, zn_im).reshape(B, Lout * Nr)
    return xmap, cov.reshape(B, Lin * Nt), z, un.reshape(B, Lout * Nr)


def plain_loop_high(op, s: BAMPState, y: torch.Tensor, sigma2: float,
                    cap: int, cfg: Config, dot=prec.dot3,
                    dot_x=None) -> BAMPState:
    """The plain loop at ``precision='high'``, the plain version of K1's
    HIGH form: :func:`linear_step_high` on :func:`gauss_taps`, then the
    denoiser, the allclose test and the freeze of :func:`plain_loop` (JAX
    gives its denoisers and the stop test no precision knob,
    `fused_bamp.py:409-510`); ``dot`` and ``dot_x`` as in
    :func:`linear_step_high`."""
    from ..ops.kernels.fused_bamp import real_x

    global plain_decodes
    plain_decodes += 1
    sigma2 = float(np.float32(sigma2))
    cap = int(cap)
    linear = partial(linear_step_high, taps=gauss_taps(op),
                     real_x=real_x(cfg), dot=dot, dot_x=dot_x)
    denoiser = make_denoiser(cfg, y.device)
    while s.t < cap and bool(s.active.any()):
        s, _ = step(op, s, y, sigma2, denoiser, linear)
    return s


def plain_loop_default(op, s: BAMPState, y: torch.Tensor, sigma2: float,
                       cap: int, cfg: Config) -> BAMPState:
    """The plain version of K1's DEFAULT form: :func:`plain_loop_high` with
    the one-pass product ``precision.dot1`` (JAX's ``make_dot(DEFAULT)``,
    `fused_bamp.py:81-93` there)."""
    return plain_loop_high(op, s, y, sigma2, cap, cfg, dot=prec.dot1)


def plain_loop_split(op, s: BAMPState, y: torch.Tensor, sigma2: float,
                     cap: int, cfg: Config, precision: str,
                     x_precision: str) -> BAMPState:
    """The plain version of K1's split forms (``AMP_KERNEL_XMAP_PRECISION``,
    `fused_bamp.py:990-991` of the JAX package): :func:`plain_loop_high`
    with the variance chain's products at ``precision`` and the xmap
    chain's at ``x_precision``, each product through
    ``precision.matmul`` (``x @ a`` in FP32 at ``'highest'``, ``dot3`` at
    ``'high'``, ``dot1`` at ``'default'``, JAX's ``make_dot``)."""
    return plain_loop_high(
        op, s, y, sigma2, cap, cfg,
        dot=partial(prec.matmul, precision=prec.canonical(precision)),
        dot_x=partial(prec.matmul, precision=prec.canonical(x_precision)))


def to_planes(s: BAMPState) -> PlaneState:
    """``s`` in the per-iteration kernels' layout."""
    part = lambda a: a.contiguous()
    return PlaneState(
        xmap_re=part(s.xmap.real), xmap_im=part(s.xmap.imag),
        xm_re=part(s.xmmse.real), xm_im=part(s.xmmse.imag), var=s.var,
        z_re=part(s.z.real), z_im=part(s.z.imag), u=s.u,
        active=s.active, T=s.T, t=int(s.t))


def from_planes(ps: PlaneState) -> BAMPState:
    """The :class:`BAMPState` of ``ps``."""
    return BAMPState(
        xmap=torch.complex(ps.xmap_re, ps.xmap_im),
        xmmse=torch.complex(ps.xm_re, ps.xm_im), var=ps.var,
        z=torch.complex(ps.z_re, ps.z_im), u=ps.u, active=ps.active,
        T=ps.T, t=ps.t)


def step_planes(op, ps: PlaneState, y_re, y_im, sigma2: float,
                denoiser, linear=linear_step) -> IterOut:
    """:func:`step` on planes, with the per-iteration kernels' outputs:
    the plain version that their wrappers run on the CPU; ``linear`` as in
    :func:`step` (:func:`linear_step_high` for K5's HIGH form)."""
    s, notok = step(op, from_planes(ps), torch.complex(y_re, y_im),
                    float(np.float32(sigma2)), denoiser, linear)
    p = to_planes(s)
    return IterOut(p.xmap_re, p.xmap_im, p.xm_re, p.xm_im, p.var, p.z_re,
                   p.z_im, p.u, torch.where(ps.active, notok, 0))


def plane_loop(iteration, op, s0: BAMPState, y: torch.Tensor, sigma2: float,
               cap: int, cfg: Config) -> BAMPState:
    """The decode from ``s0`` to global iteration ``cap`` through a
    per-iteration kernel (the counterpart of ``_fused_plane_loop``,
    `bamp.py:87-132`): the state goes to the kernels' planes once at entry
    and back once at exit; each iteration calls
    ``iteration(op, planes, y_re, y_im, sigma2, cfg)`` (an :class:`IterOut`),
    freezes xmap, and counts ``active``, ``T = t + 1`` and ``t`` as the
    plain loop does, so split-and-resume gives the same trajectory.  One
    host check of ``active`` per iteration."""
    sigma2 = float(np.float32(sigma2))
    ps = to_planes(s0)
    y_re, y_im = y.real.contiguous(), y.imag.contiguous()
    while ps.t < int(cap) and bool(ps.active.any()):
        ps = advance(ps, iteration(op, ps, y_re, y_im, sigma2, cfg))
    return from_planes(ps)


def advance(ps: PlaneState, out: IterOut) -> PlaneState:
    """:func:`plane_loop`'s next state from ``ps`` and its iteration's
    ``out``: xmap frozen where a trial is not active, the new x, var, z and
    u taken as they are (the same tensors), ``active``, ``T`` and ``t``
    counted."""
    fz = partial(_freeze, ps.active)
    return PlaneState(
        xmap_re=fz(out.xmap_re, ps.xmap_re),
        xmap_im=fz(out.xmap_im, ps.xmap_im),
        xm_re=out.xm_re, xm_im=out.xm_im, var=out.var,
        z_re=out.z_re, z_im=out.z_im, u=out.u,
        active=ps.active & (out.notok > 0),
        T=torch.where(ps.active, torch.full_like(ps.T, ps.t + 1), ps.T),
        t=ps.t + 1)


def check_use_pallas(use_pallas) -> None:
    """Raise unless ``use_pallas`` is ``'auto'``, True or False, the values
    of the decoders' and the sweep engine's knob."""
    if use_pallas not in ("auto", True, False):
        raise ValueError(f"use_pallas must be 'auto', True or False, not "
                         f"{use_pallas!r}")


def route(cfg: Config, op, B: int, device, precision: str = "highest",
          use_pallas="auto") -> str:
    """Which route :func:`decode` takes for ``B`` trials of ``cfg`` on
    ``op`` at ``precision``, decided without launching anything: the JAX
    chain of ``bamp.py:241-283``.

    * ``'whole'``: K1, when ``AMP_PALLAS_MODE`` is ``whole`` (the default),
      K1 covers the config, JAX's K1 would take it or the port's K1 form
      at ``precision`` holds a trial in one block, and
      ``fused_bamp.cluster_plan`` holds a trial of the port's K1 form (the
      split form where ``AMP_KERNEL_XMAP_PRECISION`` asks for one): in one
      block, or where one block's shared memory holds none (the QPSK
      flagship's dimensions at Lin 27-50 at 'high', 33-50 at 'default',
      42-50 at 'highest'; the SCAMP flagship's dimensions under BAMP at
      Lin 33-49 at 'high', 40-49 at 'default', and in the split forms; the
      OOK flagship's at Lin 49-66 at 'high', 57-66 at 'default'), as a
      thread-block cluster of 2, 4 or 8 blocks a trial;
    * ``'whole_plain'``: where JAX's K1 takes ``B`` trials
      (``fused_bamp.jax_fits``) and no cluster of 8 blocks holds a trial
      of the port's K1 form (no geometry of the three flagships'
      dimensions up to Lin 66): K1's function as its plain version on the
      decode's device (``fused_bamp.PLAIN``, ``decode_plain_split`` under
      the variable), counted in ``plain_decodes``; a plain version, not a
      kernel;
    * ``'periter'``: K6, for K=1 segmented alphabets with M a power of two
      whose trial fits one block;
    * ``'tiled'``: K5, for real alphabets with tail truncation and
      per-tap-constant gains, unless the mode is ``xla``;
    * ``'plain'``: the plain PyTorch loop.

    As in JAX, ``AMP_PALLAS_MODE=xla`` skips only K1 and K5 (it still takes
    K6 for K=1 alphabets), and any other value than ``whole`` or ``xla``
    skips K1; a geometry that neither JAX's K1 nor the port's takes falls
    through to K6 (at HIGHEST), K5 and the plain loop.  ``use_pallas`` as
    in :func:`decode`: ``False`` is the plain loop, decided before any
    environment variable is read (JAX reads them only under
    ``use_pallas``).  Unlike JAX, neither the batch size nor a frame tile
    limits K5: ``B`` is any count (the ragged trial tile is masked).  The
    chain is the same on both devices; on the CPU each kernel's wrapper
    runs its plain version."""
    if torch.device(device).type not in ("cpu", "cuda"):
        raise ValueError(f"no decode route for device {device}")
    if B < 0:
        raise ValueError(f"batch of {B} trials")
    return route_of(cfg, isinstance(op, operators.BandedOperator), op,
                    precision, use_pallas, B)


def xmap_split(precision: str = "highest"):
    """The xmap chain's precision of K1's split form that
    ``AMP_KERNEL_XMAP_PRECISION`` asks for (``precision.xmap_precision``,
    which raises where JAX's ``make_dot`` would), or None where the variable
    is unset or empty or names ``precision`` itself: JAX's ``dot_x`` is
    then ``dot`` (`fused_bamp.py:184-185` there), and K1 runs the form at
    ``precision``."""
    x = prec.xmap_precision()
    return None if x is None or x == prec.canonical(precision) else x


def route_of(cfg: Config, banded: bool, op=None, precision: str = "highest",
             use_pallas="auto", batch=None) -> str:
    """:func:`route`'s chain for ``cfg`` on a banded operator (``banded``)
    or a dense one; without ``op``, K5 is judged by the config alone;
    without ``batch``, JAX's K1 fit is not consulted (the port's alone
    decides K1).  Raises for ``use_pallas=True`` where no kernel covers the
    config or the operator is dense; ``'whole_plain'`` is K1's function,
    which JAX's ``use_pallas=True`` takes there too.
    ``AMP_KERNEL_XMAP_PRECISION`` is read only where the chain takes K1, as
    JAX's K1 alone reads it (`fused_bamp.py:990-991` there): a bad value
    raises there (:func:`xmap_split`); the split form it asks for runs in
    one block or as a cluster (``fused_bamp.cluster_plan``), and only
    where no cluster holds it is the route ``'whole_plain'`` (the plain
    split version)."""
    from ..ops.kernels import (fused_bamp, fused_bamp_iteration,
                               fused_bamp_tiled)

    check_use_pallas(use_pallas)
    if use_pallas is False:
        return "plain"

    if not (banded and fused_bamp.covers(cfg)):
        if use_pallas is True:
            # JAX's honest knob (bamp.py:241-249): never the plain loop
            # silently under use_pallas=True
            raise ValueError(
                "use_pallas=True: the BAMP kernels need a banded operator "
                "and cover complex segmented/sparc alphabets and the random "
                f"mode, not mode={cfg.mode!r} is_complex={cfg.is_complex} "
                f"on a {'banded' if banded else 'dense'} operator")
        return "plain"
    mode = os.environ.get("AMP_PALLAS_MODE", "whole")
    if mode == "whole" and (
            fused_bamp.fits(cfg, precision)
            or (batch is not None and fused_bamp.jax_fits(cfg, batch))):
        x = xmap_split(precision)
        if fused_bamp.cluster_plan(cfg, precision, x).ctas >= 1:
            return "whole"
        return "whole_plain"
    if fused_bamp_iteration.covers(cfg) and fused_bamp_iteration.fits(cfg):
        return "periter"
    if mode != "xla" and fused_bamp_tiled.covers(cfg, op):
        return "tiled"
    return "plain"


def decode(H, y: torch.Tensor, sigma2, cfg: Config, *,
           state0: BAMPState | None = None, iter_cap: int | None = None,
           return_state: bool = False, precision: str = "highest",
           use_pallas="auto"):
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
        precision: 'highest' (default), 'high' or 'default' (module
            docstring): K1 and K5 in their HIGH (DEFAULT) forms, K6 at
            HIGHEST, the plain loop's products at HIGH (DEFAULT).
        use_pallas: 'auto' (default), True or False (module docstring).

    The route is :func:`route`'s.  A banded operator with a complex
    segmented, sparc or random-mode config whose trial fits one block's
    shared memory takes the whole-decode kernel K1; where JAX's K1 takes
    the batch and one block holds no trial, K1's cluster form (a trial on
    a thread-block cluster of 2, 4 or 8 blocks, ``fused_bamp.
    cluster_plan``), and only where no cluster of 8 holds one, K1's
    function as its plain version (``'whole_plain'``); the massive geometry
    (``config.massive_mimo()``, OOK) takes the frame-tiled kernel K5.  The
    plain loop runs dense operators, the real-channel mode, and the
    geometries that fit no block with a complex alphabet or a truncation
    other than tail (the massive geometry with QPSK or trunc, the SCAMP
    8PSK sweep's dimensions under BAMP), as in the JAX package, and
    ``use_pallas=False`` runs it everywhere.

    Returns:
        :class:`DecodeResult` (and the final :class:`BAMPState` when
        ``return_state``).
    """
    from ..ops.kernels import (fused_bamp, fused_bamp_iteration,
                               fused_bamp_tiled)

    precision = prec.canonical(precision)
    op = operators.as_operator(H)
    n, N = op.shape
    sigma2 = float(np.float32(sigma2))
    if state0 is None:
        state0 = initial_state(y, N, sigma2)
    cap = cfg.N_Layers if iter_cap is None else int(iter_cap)
    way = route(cfg, op, y.shape[0], y.device, precision, use_pallas)
    if way == "whole":
        s = fused_bamp.whole_decode(op, state0, y, sigma2, cap, cfg,
                                    precision, xmap_split(precision))
    elif way == "whole_plain":
        x = xmap_split(precision)
        if x is None:
            s = fused_bamp.PLAIN[precision](op, state0, y, sigma2, cap, cfg)
        else:
            s = fused_bamp.decode_plain_split(op, state0, y, sigma2, cap,
                                              cfg, precision, x)
    elif way == "periter":
        s = plane_loop(fused_bamp_iteration.iteration_fused, op, state0, y,
                       sigma2, cap, cfg)
    elif way == "tiled":
        iteration = fused_bamp_tiled.iteration
        if precision in prec.BF16:
            iteration = partial(iteration, precision=precision)
        s = plane_loop(iteration, op, state0, y, sigma2, cap, cfg)
    else:
        s = plain_loop(op, state0, y, sigma2, cap, cfg, precision)
    result = DecodeResult(xmap=s.xmap, xmmse=s.xmmse, var=s.var, T=s.T)
    if return_state:
        return result, s
    return result
