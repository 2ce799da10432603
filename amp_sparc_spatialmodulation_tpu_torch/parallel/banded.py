"""Halo-exchange BAMP and SCAMP on the banded (tap-form) operator, the
frame split over the ``model`` axis of the mesh.

Port of the JAX package's ``parallel/banded.py``.  The frame's ``Lin``
channel uses are coupled only by the ``Lh``-tap band of the block-Toeplitz
channel, so splitting the frame over ranks needs only boundary exchange:
``O(B (Lh-1) Nr)`` values between ring neighbours per map, where the dense
column split of :mod:`.tensor` all-reduces ``O(B n)``.  No rank builds the
dense operator: the massive-MIMO config (Nt=1344, Lin=32, a 0.93 GB dense
matrix) decodes with 4.6 MB of replicated taps.

Layout (rank ``d`` of ``k``, ``LinL = Lin/k``, ``R = LinL + Lh - 1``):

* x-side state (``xmap, xmmse, var``): column blocks
  ``[d LinL, (d+1) LinL)``, flat ``(B, LinL Nt)``; no segment straddles
  two ranks.
* y-side state (``z, u, y``): local row-block slots ``[0, R)`` holding
  global row blocks ``[d LinL, d LinL + R)``.  Slots ``[0, LinL)`` are
  owned; the ``Lh-1`` overflow slots are owned only by the last rank under
  ``tail`` truncation (the ISI transient rows).  Slots a rank does not own
  are zero.

Per map one exchange rides the ring (two per BAMP iteration, both
multi-hop where the halo is wider than a rank's blocks, ``hops =
ceil((Lh-1)/LinL)``):

1. forward: the partial sums of ``H @ xmmse`` and ``|H|^2 @ var`` that a
   rank's columns add to its right neighbour's first ``Lh-1`` row blocks
   (wrapping under ``cyclic``);
2. backward: the right neighbour's first ``Lh-1`` owned row blocks of the
   scaled residual and ``1/u``, which the rank's adjoint maps need.

With more than one rank the local products have other shapes than the
single-device operator's (``(B LinL, Nt)`` against ``(B Lin, Nt)``), so the
results equal the single-device plain loop's within float32 rounding, not
bit for bit; with one rank they are its bits.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..models import bamp
from ..models.bamp import _allclose_rows, _freeze
from ..models.scamp import base_product
from ..ops import denoise
from ..ops import precision as prec
from .mesh import MODEL_AXIS, Axis, all_reduce, axis_of, ring_shift
from .tensor import (alive, converged_everywhere, gather_columns,
                     local_config, shard_columns)  # noqa: F401 (JAX's API)


class HaloBandedOperator:
    """This rank's view of a banded operator, with halo exchange.

    Args:
        h: (Lh, Nr, Nt) channel taps, the same on every rank.
        gains: (Lh, Lin) per-(tap, column block) gains, the same on every
            rank.
        cfg: system config (Lin, Lout, truncation).
        axis: the :class:`.mesh.Axis` the frame is split over.
        precision: 'highest', 'high' or 'default', of the tap products.
    """

    def __init__(self, h: torch.Tensor, gains: torch.Tensor, cfg: Config,
                 axis: Axis, precision: str = "highest"):
        self.axis = axis
        self.k = k = axis.size
        self.Lh, self.Nr, self.Nt = h.shape
        self.LinL = local_config(cfg, axis).Lin
        # A contribution travels at most ceil((Lh-1)/LinL) ranks; each hop
        # ships the still-unowned overflow one rank on.
        self.hops = -(-(self.Lh - 1) // self.LinL) if self.Lh > 1 else 0
        self.R = self.LinL + self.Lh - 1
        self.trunc = cfg.trunc
        self.cyclic = cfg.trunc == "cyclic"
        self.mm = partial(prec.matmul, precision=prec.canonical(precision))
        d = axis.index
        self.is_last = d == k - 1
        g = torch.as_tensor(gains, dtype=torch.float32, device=h.device)
        self.g = g[:, d * self.LinL:(d + 1) * self.LinL].contiguous()
        self.g2 = self.g ** 2
        self.h_stack = h.permute(2, 0, 1).reshape(self.Nt, self.Lh * self.Nr)
        self.abs_h2_stack = self.h_stack.abs() ** 2
        # (R,) owned slots: the overflow slots are real rows only for the
        # last rank under 'tail' (under 'cyclic' and 'trunc', Lout == Lin)
        owned = torch.arange(self.R, device=h.device) < self.LinL
        if cfg.trunc == "tail" and self.is_last:
            owned = torch.ones_like(owned)
        self.owned = owned

    # ---- local maps -----------------------------------------------------

    def _fwd_partial(self, x, taps_stack, gains):
        """The local columns' contributions to row slots ``[0, R)``:
        (B, LinL Nt) -> (B, R, Nr).  Column block c through tap l lands in
        slot c + l, so the accumulation is ``Lh`` slice-adds around one
        product."""
        B = x.shape[0]
        P = self.mm(x.reshape(B * self.LinL, self.Nt), taps_stack)
        P = P.reshape(B, self.LinL, self.Lh, self.Nr)
        y = torch.zeros((B, self.R, self.Nr), dtype=P.dtype, device=P.device)
        for l in range(self.Lh):
            y[:, l:l + self.LinL] += gains[l][None, :, None] * P[:, :, l]
        return y

    def _bwd_local(self, w, taps_stack, gains):
        """The adjoint onto the local columns from halo-complete row
        planes: (B, R, Nr) -> (B, LinL Nt); ``taps_stack`` carries the
        conjugation."""
        B = w.shape[0]
        Z = torch.stack([gains[l][None, :, None] * w[:, l:l + self.LinL]
                         for l in range(self.Lh)], dim=2)  # (B, LinL, Lh, Nr)
        r = self.mm(Z.reshape(B * self.LinL, self.Lh * self.Nr), taps_stack)
        return r.reshape(B, self.LinL * self.Nt)

    # ---- halo exchanges -------------------------------------------------

    def _split(self, planes):
        reals = []
        for p in planes:   # complex planes as re/im lanes
            reals.extend([p.real.clone(), p.imag.clone()] if p.is_complex()
                         else [p.clone()])
        return reals

    @staticmethod
    def _join(planes, reals):
        out, i = [], 0
        for p in planes:
            if p.is_complex():
                out.append(torch.complex(reals[i], reals[i + 1]))
                i += 2
            else:
                out.append(reals[i])
                i += 1
        return out

    def _ship_right(self, planes):
        """The multi-hop forward exchange of (B, R, Nr) partial planes: each
        hop ships the still-unowned overflow slots one rank right (zeroing
        them here, so nothing counts twice) and adds what arrives into
        slots ``[0, halo)``.  One exchange of the stacked real planes per
        hop."""
        halo = self.Lh - 1
        if not halo or (self.k == 1 and not self.cyclic):
            return planes
        Nr, LinL = self.Nr, self.LinL
        reals = self._split(planes)
        # Under 'tail' the last rank's overflow slots are its own rows (the
        # ISI transient): it has no right neighbour and keeps them.
        keep_ov = self.trunc == "tail" and not self.cyclic and self.is_last
        for _ in range(self.hops):
            buf = torch.cat([r[:, LinL:] for r in reals], dim=-1)
            if not keep_ov:
                for r in reals:
                    r[:, LinL:] = 0.0
            recv = ring_shift(buf, self.axis, +1, self.cyclic)
            for i, r in enumerate(reals):
                r[:, :halo] += recv[..., i * Nr:(i + 1) * Nr]
        return self._join(planes, reals)

    def _pull_right(self, planes):
        """The multi-hop backward exchange: fill the overflow slots
        ``[LinL, R)`` with the rows the right neighbours own (the window
        grows each hop where the halo spans several ranks).  Planes must be
        zero outside owned slots; under ``tail`` the last rank keeps its own
        overflow rows, under ``trunc`` they do not exist and stay zero,
        under ``cyclic`` the pulls wrap."""
        halo = self.Lh - 1
        if not halo or (self.k == 1 and not self.cyclic):
            return planes
        Nr, LinL = self.Nr, self.LinL
        reals = self._split(planes)
        keep = self.trunc == "tail" and self.is_last
        for _ in range(self.hops):
            buf = torch.cat([r[:, :halo] for r in reals], dim=-1)
            recv = ring_shift(buf, self.axis, -1, self.cyclic)
            if not keep:
                for i, r in enumerate(reals):
                    r[:, LinL:] = recv[..., i * Nr:(i + 1) * Nr]
        return self._join(planes, reals)

    def _owned_only(self, p):
        return torch.where(self.owned[None, :, None], p, 0.0)

    # ---- the maps -------------------------------------------------------

    def apply_halo(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x`` on owned rows: one single-plane forward exchange."""
        hx = self._fwd_partial(x, self.h_stack.to(x.dtype), self.g)
        (hx,) = self._ship_right([hx])
        return self._owned_only(hx)

    def adj_halo(self, rr: torch.Tensor) -> torch.Tensor:
        """``A^H @ rr`` for the local columns; ``rr`` zero outside owned
        slots, the right neighbours' rows pulled in first."""
        (rr,) = self._pull_right([rr])
        return self._bwd_local(rr, self.h_stack.conj().T.to(rr.dtype), self.g)

    def apply_and_abs2(self, x: torch.Tensor, var: torch.Tensor):
        """``(H @ x, |H|^2 @ var)`` on owned rows, one exchange of both:
        two (B, R, Nr) planes, zero outside owned slots."""
        hx = self._fwd_partial(x, self.h_stack.to(x.dtype), self.g)
        v = self._fwd_partial(var, self.abs_h2_stack, self.g2)
        v, hx = self._ship_right([v, hx])
        return self._owned_only(hx), self._owned_only(v)

    def adj_and_cov(self, uinv: torch.Tensor, rr: torch.Tensor):
        """``(H^H @ rr, 1 / (|H|^2^T @ uinv))`` for the local columns, the
        right neighbours' boundary rows pulled in first."""
        uinv, rr = self._pull_right([uinv, rr])
        cov = 1.0 / self._bwd_local(uinv, self.abs_h2_stack.T, self.g2)
        adj = self._bwd_local(rr, self.h_stack.conj().T.to(rr.dtype), self.g)
        return adj, cov


class HaloState(NamedTuple):
    xmap: torch.Tensor    # (B, LinL Nt) complex, local columns
    xmmse: torch.Tensor   # (B, LinL Nt) complex
    var: torch.Tensor     # (B, LinL Nt) f32
    z: torch.Tensor       # (B, R, Nr) complex, owned rows (others zero)
    u: torch.Tensor       # (B, R, Nr) f32, owned rows (others sigma2)
    active: torch.Tensor  # (B,) bool
    T: torch.Tensor       # (B,) int32
    t: int                # global iteration counter


def shard_rows(y_full: torch.Tensor, cfg: Config, axis: Axis
               ) -> torch.Tensor:
    """This rank's (B, R, Nr) row planes of a replicated (B, Lout Nr)
    array; the row blocks are padded to ``Lin + Lh - 1`` first, so that
    under ``trunc`` and ``cyclic`` the overflow rows read as zero."""
    B = y_full.shape[0]
    LinL = cfg.Lin // axis.size
    R = LinL + cfg.Lh - 1
    blocks = y_full.reshape(B, cfg.Lout, cfg.Nr)
    pad = cfg.Lin + cfg.Lh - 1 - cfg.Lout
    if pad:
        blocks = torch.cat([blocks, blocks.new_zeros((B, pad, cfg.Nr))], 1)
    return blocks[:, axis.index * LinL:axis.index * LinL + R].contiguous()


def decode(h: torch.Tensor, gains, y_local: torch.Tensor, sigma2,
           cfg: Config, *, mesh, precision: str = "highest",
           state0: HaloState | None = None,
           iter_cap: int | None = None, return_state: bool = False):
    """Frame-split BAMP (`bamp.py:48-64` semantics).

    Args:
        h: (Lh, Nr, Nt) taps, the same on every rank.
        gains: (Lh, Lin) gains (ones for Toeplitz, ``sqrt(W)`` band for
            SPARC), the same on every rank.
        y_local: (B, R, Nr) this rank's received rows (:func:`shard_rows`).
        sigma2: noise variance.
        mesh: the mesh; the frame is split over its model axis.
        precision: 'highest', 'high' or 'default', of the tap products.
        state0 / iter_cap / return_state: resumable decoding, as in
            :func:`..models.bamp.decode`.

    The loop runs while any trial of any rank of the axis is active
    (:func:`.tensor.alive`, one host read per iteration), so that every
    rank of the ring runs the same exchanges.

    Returns ``(xmap_k, xmmse_k, var_k, T)``, or the final
    :class:`HaloState` when ``return_state``; the column shards gather
    back with :func:`gather_columns`.
    """
    axis = axis_of(mesh, MODEL_AXIS)
    op = HaloBandedOperator(h, gains, cfg, axis, precision)
    B = y_local.shape[0]
    N_local = op.LinL * op.Nt
    cdtype = y_local.dtype
    dev = y_local.device
    denoiser = bamp.make_denoiser(local_config(cfg, axis), dev)
    sigma2 = float(np.float32(sigma2))
    mask_y = op.owned[None, :, None]
    y = op._owned_only(y_local)

    if state0 is None:
        state0 = HaloState(
            xmap=torch.zeros((B, N_local), dtype=cdtype, device=dev),
            xmmse=torch.zeros((B, N_local), dtype=cdtype, device=dev),
            var=torch.ones((B, N_local), dtype=torch.float32, device=dev),
            z=y.clone(),
            u=torch.full((B, op.R, op.Nr), sigma2, dtype=torch.float32,
                         device=dev),
            active=torch.ones((B,), dtype=torch.bool, device=dev),
            T=torch.zeros((B,), dtype=torch.int32, device=dev),
            t=0)
    cap = cfg.N_Layers if iter_cap is None else int(iter_cap)
    s = state0
    while s.t < cap and alive(s.active, axis):
        hx, v = op.apply_and_abs2(s.xmmse, s.var)             # owned rows
        z = hx - torch.where(mask_y, denoise.div_real(v * (y - s.z), s.u),
                             0.0).to(cdtype)
        u = v + sigma2                                        # pads: sigma2
        uinv = torch.where(mask_y, 1.0 / u, 0.0)
        # the single-device decode's (y - z) / u; JAX's halo decode takes
        # (y - z) * (1/u), which moves T of about 1% of the flagship's
        # trials against the single-device decode
        rr = torch.where(mask_y, denoise.div_real(y - z, u), 0.0).to(cdtype)
        adj, cov = op.adj_and_cov(uinv, rr)                   # local columns
        xmap = s.xmmse + cov * adj
        xmmse, var = denoiser(xmap, cov)
        converged = converged_everywhere(_allclose_rows(var, s.var), axis)
        s = HaloState(
            xmap=_freeze(s.active, xmap, s.xmap),
            xmmse=_freeze(s.active, xmmse, s.xmmse),
            var=_freeze(s.active, var, s.var),
            z=torch.where(s.active[:, None, None], z, s.z),
            u=torch.where(s.active[:, None, None], u, s.u),
            active=s.active & ~converged,
            T=torch.where(s.active, torch.full_like(s.T, s.t + 1), s.T),
            t=s.t + 1)
    if return_state:
        return s
    return s.xmap, s.xmmse, s.var, s.T


# --------------------------------------------------------------------------
# Halo SCAMP (`scamp.py:43-59` semantics).  The base-matrix bookkeeping
# (psi, phi, gma, tau: a few scalars per block and trial) is computed on
# every rank from one gather of the (B, LinL) local section variances per
# iteration; only the two operator maps are split, each with one
# single-plane exchange, as in the BAMP halo decode.
# --------------------------------------------------------------------------


class HaloScampState(NamedTuple):
    xmap: torch.Tensor    # (B, LinL Nt) complex, local columns
    xmmse: torch.Tensor   # (B, LinL Nt) complex
    psi: torch.Tensor     # (B, LinL) f32 local section variances
    phi: torch.Tensor     # (B, Lout) f32 residual variances, replicated
    z: torch.Tensor       # (B, R, Nr) complex, owned rows (others zero)
    active: torch.Tensor  # (B,) bool
    T: torch.Tensor       # (B,) int32
    t: int


def _row_blocks_local(v_full: torch.Tensor, cfg: Config, axis: Axis
                      ) -> torch.Tensor:
    """This rank's (B, R) row-block scalars of a replicated (B, Lout)
    array (the block-scalar form of :func:`shard_rows`)."""
    LinL = cfg.Lin // axis.size
    R = LinL + cfg.Lh - 1
    pad = cfg.Lin + cfg.Lh - 1 - cfg.Lout
    if pad:
        v_full = torch.cat([v_full, v_full.new_zeros((v_full.shape[0], pad))],
                           1)
    return v_full[:, axis.index * LinL:axis.index * LinL + R]


def scamp_decode(h: torch.Tensor, gains, W, y_local: torch.Tensor, sigma2,
                 cfg: Config, *, mesh, estimate_phi: bool = False,
                 precision: str = "highest",
                 state0: HaloScampState | None = None,
                 iter_cap: int | None = None, return_state: bool = False):
    """Frame-split SCAMP.  Arguments as :func:`decode`, plus the base
    matrix ``W (Lout, Lin)`` (the same on every rank) and ``estimate_phi``,
    the reference's estSCAMP (`sparc.py:199`): ``phi`` as each output
    block's mean ``|z|^2``, assembled from every rank's owned blocks.  The
    base-matrix products are :func:`..models.scamp.base_product`'s, the
    form the single-device loop takes.  Returns ``(xmap_k, xmmse_k, 1 -
    psi_k, T)`` or the final :class:`HaloScampState`."""
    axis = axis_of(mesh, MODEL_AXIS)
    op = HaloBandedOperator(h, gains, cfg, axis, precision)
    precision = prec.canonical(precision)
    B = y_local.shape[0]
    LinL = op.LinL
    N_local = LinL * op.Nt
    cdtype = y_local.dtype
    dev = y_local.device
    Lc, Mc, Mr, L = cfg.Lc, cfg.Mc, cfg.Mr, cfg.L
    denoiser = partial(denoise.segmented_posterior,
                       symbols=torch.as_tensor(cfg.symbols, device=dev),
                       L=cfg.Na * LinL, M=cfg.M, halve_tau=cfg.is_complex,
                       variance=None)
    W = torch.as_tensor(W, dtype=torch.float32, device=dev).contiguous()
    Wt = W.T.contiguous()
    sigma2 = float(np.float32(sigma2))
    mask_y = op.owned[None, :, None]
    mask_row = op.owned[None, :]
    y = op._owned_only(y_local)
    d = axis.index

    if state0 is None:
        state0 = HaloScampState(
            xmap=torch.zeros((B, N_local), dtype=cdtype, device=dev),
            xmmse=torch.zeros((B, N_local), dtype=cdtype, device=dev),
            psi=torch.ones((B, LinL), dtype=torch.float32, device=dev),
            phi=torch.full((B, cfg.Lout), float("inf"), dtype=torch.float32,
                           device=dev),
            z=y.clone(),
            active=torch.ones((B,), dtype=torch.bool, device=dev),
            T=torch.zeros((B,), dtype=torch.int32, device=dev),
            t=0)
    cap = cfg.N_Layers if iter_cap is None else int(iter_cap)
    s = state0
    while s.t < cap and alive(s.active, axis):
        psi_full = gather_columns(s.psi, axis)                  # (B, Lin)
        gma_full = base_product(psi_full, W, precision) / Lc    # (B, Lout)
        b_loc = _row_blocks_local(gma_full / s.phi, cfg, axis)
        hx = op.apply_halo(s.xmmse)                             # (B, R, Nr)
        z = torch.where(mask_y,
                        y - hx + b_loc[:, :, None].to(cdtype) * s.z, 0.0)
        if estimate_phi:
            m_loc = (z.abs() ** 2).sum(-1) / Mr                 # (B, R)
            m_full = gather_columns(m_loc[:, :LinL].contiguous(), axis)
            if cfg.trunc == "tail":
                tail = (m_loc[:, LinL:] if op.is_last
                        else torch.zeros_like(m_loc[:, LinL:]))
                m_full = torch.cat([m_full, all_reduce(tail, axis)], dim=1)
            phi_full = m_full                                   # (B, Lout)
        else:
            phi_full = sigma2 + gma_full                        # `scamp.py:50`
        tau_full = L / base_product(1.0 / phi_full, Wt, precision) / Mr
        tau_use = tau_full[:, d * LinL:(d + 1) * LinL].repeat_interleave(
            Mc, dim=-1)                                         # (B, N_local)
        phi_safe = torch.where(mask_row,
                               _row_blocks_local(phi_full, cfg, axis), 1.0)
        rr = torch.where(mask_y, denoise.div_real(z, phi_safe[:, :, None]),
                         0.0).to(cdtype)
        xmap = s.xmmse + tau_use * op.adj_halo(rr)
        xmmse, _ = denoiser(xmap, tau_use)
        psi = 1.0 - (xmmse.abs() ** 2).reshape(B, LinL, Mc).sum(-1) / cfg.Na
        converged = converged_everywhere(_allclose_rows(psi, s.psi), axis)
        s = HaloScampState(
            xmap=_freeze(s.active, xmap, s.xmap),
            xmmse=_freeze(s.active, xmmse, s.xmmse),
            psi=_freeze(s.active, psi, s.psi),
            phi=_freeze(s.active, phi_full, s.phi),
            z=torch.where(s.active[:, None, None], z, s.z),
            active=s.active & ~converged,
            T=torch.where(s.active, torch.full_like(s.T, s.t + 1), s.T),
            t=s.t + 1)
    if return_state:
        return s
    return s.xmap, s.xmmse, 1.0 - s.psi, s.T
