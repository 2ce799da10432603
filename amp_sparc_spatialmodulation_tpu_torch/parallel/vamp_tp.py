"""Tensor-parallel VAMP in the singular-value domain, the frame's columns
split over the ``model`` axis of the mesh.

Port of the JAX package's ``parallel/vamp_tp.py``.  Every rank holds the
replicated ``U``, ``s`` and ``y_tilde`` and its ``(p, N/k)`` column slab of
``Vh``; every per-element state (``r_tilde, r, var, xmmse``) stays on the
rank that owns the columns.  Per iteration:

* ``q = Vh @ r_tilde`` sums over the split columns: one all-reduce of the
  (B, p) projection;
* ``V @ (x_sv - q)`` gives column-split output: no exchange;
* the denoiser is segment-local (``Lin % model_size == 0``), and its
  Onsager mean ``mean(var)`` is one all-reduce of a per-trial scalar;
* the stop verdict is per trial: each rank's allclose count all-reduced.

The SVD is not split: every rank of a realization draws the same channel
and computes the same SVD, amortized over the realization's trials as in
the single-device decode.  The model axis buys the O(B N) state memory and
products.  The constants and the SVD are :mod:`..models.vamp`'s.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..models import vamp
from ..models.bamp import _allclose_rows, _freeze
from ..models.vamp import _VAR_MAX, _VAR_MIN, _VR_MAX, _VR_MIN
from ..ops import denoise
from ..ops import precision as prec
from .mesh import MODEL_AXIS, all_reduce, axis_of
from .tensor import alive, converged_everywhere, local_config


class VampTPState(NamedTuple):
    r_tilde: torch.Tensor       # (B, N_local) complex
    sigma2_tilde: torch.Tensor  # (B, 1) f32, replicated
    r: torch.Tensor             # (B, N_local) complex, the decision stat
    var: torch.Tensor           # (B, N_local) f32
    xmmse: torch.Tensor         # (B, N_local) complex
    active: torch.Tensor        # (B,) bool
    T: torch.Tensor             # (B,) int32
    t: int


def decode(U: torch.Tensor, s: torch.Tensor, Vh_k: torch.Tensor,
           y: torch.Tensor, sigma2, cfg: Config, *, mesh,
           precision: str = "highest",
           state0: VampTPState | None = None, iter_cap: int | None = None,
           return_state: bool = False):
    """Tensor-parallel VAMP (`vamp.py:56-94` semantics) on a column shard.

    Args:
        U: (n, p) left singular vectors, the same on every rank.
        s: (p,) singular values, the same on every rank.
        Vh_k: (p, N_local), this rank's columns of ``Vh``.
        y: (B, n) received vectors, the same on every rank.
        mesh, precision, state0 / iter_cap / return_state: as
            :func:`.tensor.decode`.

    Returns ``(r_k, xmmse_k, var_k, T)`` (the column-split pseudo-data,
    VAMP's decision statistic, `vamp.py:187`), or the final
    :class:`VampTPState` when ``return_state``.
    """
    axis = axis_of(mesh, MODEL_AXIS)
    dev = y.device
    denoiser = vamp.make_denoiser(local_config(cfg, axis), dev)
    mm = partial(prec.matmul, precision=prec.canonical(precision))
    B = y.shape[0]
    p, N_local = Vh_k.shape
    N = N_local * axis.size
    cdtype = y.dtype
    s2 = (s ** 2)[None, :]                                  # (1, p)
    eta = p / N                                             # `vamp.py:28`
    noise_var = float(np.float32(sigma2))
    y_tilde = s[None, :] * mm(y, U.conj())                  # (B, p)
    Vh_t, Vh_c = Vh_k.T, Vh_k.conj()

    sp = cfg.sparsity
    if state0 is None:
        state0 = VampTPState(
            r_tilde=torch.full((B, N_local), sp, dtype=cdtype, device=dev),
            sigma2_tilde=torch.full(
                (B, 1), sp ** 2 * (1 - sp) + (1 - sp) ** 2 * sp,
                dtype=torch.float32, device=dev),
            r=torch.zeros((B, N_local), dtype=cdtype, device=dev),
            var=torch.ones((B, N_local), dtype=torch.float32, device=dev),
            xmmse=torch.zeros((B, N_local), dtype=cdtype, device=dev),
            active=torch.ones((B,), dtype=torch.bool, device=dev),
            T=torch.zeros((B,), dtype=torch.int32, device=dev),
            t=0)
    cap = cfg.N_Layers if iter_cap is None else int(iter_cap)
    st = state0
    while st.t < cap and alive(st.active, axis):
        # LMMSE stage in the SV domain (`vamp.py:66-73`): the projection
        # sums over the split columns
        var_ratio = noise_var / st.sigma2_tilde                 # (B, 1)
        q = all_reduce(mm(st.r_tilde, Vh_t), axis)              # (B, p)
        scale = 1.0 / (s2 + var_ratio)                          # (B, p)
        x_sv = scale * (y_tilde + var_ratio * q)
        var_lmmse = scale.mean(dim=1, keepdim=True) * noise_var
        x_tilde = mm(x_sv - q, Vh_c) + st.r_tilde               # local
        x_tilde_var = eta * var_lmmse + (1.0 - eta) * st.sigma2_tilde

        # extrinsic subtraction (`vamp.py:75-82`), per-trial scalars
        alpha = torch.clamp(x_tilde_var / st.sigma2_tilde, _VR_MIN, _VR_MAX)
        r = denoise.div_real(x_tilde - alpha * st.r_tilde, 1.0 - alpha)
        sig2_den = torch.clamp(alpha / (1.0 - alpha) * st.sigma2_tilde,
                               _VAR_MIN, _VAR_MAX)

        # denoiser and extrinsic update (`vamp.py:84-94`); the Onsager mean
        # over N sums over every rank
        xmmse, var = denoiser(r, sig2_den)
        var_mean = all_reduce(var.sum(dim=1, keepdim=True), axis) / N
        dxdr = torch.clamp(var_mean / sig2_den, _VR_MIN, _VR_MAX)
        norm = 1.0 / (1.0 - dxdr)
        r_tilde = (xmmse - dxdr * r) * norm
        sigma2_tilde = torch.clamp(sig2_den * dxdr * norm, _VAR_MIN,
                                   _VAR_MAX)

        converged = converged_everywhere(_allclose_rows(var, st.var), axis)
        st = VampTPState(
            r_tilde=_freeze(st.active, r_tilde, st.r_tilde),
            sigma2_tilde=_freeze(st.active, sigma2_tilde, st.sigma2_tilde),
            r=_freeze(st.active, r, st.r),
            var=_freeze(st.active, var, st.var),
            xmmse=_freeze(st.active, xmmse, st.xmmse),
            active=st.active & ~converged,
            T=torch.where(st.active, torch.full_like(st.T, st.t + 1), st.T),
            t=st.t + 1)
    if return_state:
        return st
    return st.r, st.xmmse, st.var, st.T
