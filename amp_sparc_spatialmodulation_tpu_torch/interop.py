"""NumPy-in constructors for carrying shared inputs into the port.

The parity tests draw their inputs with NumPy (or with the JAX package on
the CPU, converted through NumPy) and hand the same arrays to both
packages.  The random streams themselves differ (threefry against
Philox), so generators are compared only by statistics.  Every
constructor takes the device explicitly; there is no default.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.bamp import BAMPState
from .models.scamp import SCAMPState
from .models.vamp import SVD, VAMPState
from .models.vamp2 import VAMP2State
from .ops.message import Message
from .ops.operators import BandedOperator


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def operator_from_numpy(h, gains, Lin: int, Lout: int, trunc: str,
                        device) -> BandedOperator:
    """A :class:`BandedOperator` from (Lh, Nr, Nt) taps and (Lh, Lin) gains."""
    h = np.asarray(h)
    dtype = torch.complex64 if np.iscomplexobj(h) else torch.float32
    return BandedOperator(h=_t(h, dtype, device),
                          gains=np.asarray(gains, np.float32),
                          Lin=Lin, Lout=Lout, trunc=trunc)


def message_from_numpy(x, ant, sym, gray, flat, device) -> Message:
    """A :class:`Message` from its dense vector and structured truth
    (``x`` may be None)."""
    xt = None
    if x is not None:
        x = np.asarray(x)
        xt = _t(x, torch.complex64 if np.iscomplexobj(x) else torch.float32,
                device)
    i32 = torch.int32
    return Message(x=xt, ant=_t(ant, i32, device), sym=_t(sym, i32, device),
                   gray=_t(gray, i32, device), flat=_t(flat, i32, device))


def state_from_numpy(xmap, xmmse, var, z, u, active, T, t,
                     device) -> BAMPState:
    """A :class:`BAMPState` from arrays in the JAX ``BAMPState`` layout."""
    c64, f32 = torch.complex64, torch.float32
    return BAMPState(xmap=_t(xmap, c64, device), xmmse=_t(xmmse, c64, device),
                     var=_t(var, f32, device), z=_t(z, c64, device),
                     u=_t(u, f32, device), active=_t(active, torch.bool,
                                                     device),
                     T=_t(T, torch.int32, device), t=int(t))


def scamp_state_from_numpy(xmap, xmmse, psi, phi, z, active, T, t,
                           device) -> SCAMPState:
    """A :class:`SCAMPState` from arrays in the JAX ``SCAMPState`` layout."""
    c64, f32 = torch.complex64, torch.float32
    return SCAMPState(xmap=_t(xmap, c64, device),
                      xmmse=_t(xmmse, c64, device), psi=_t(psi, f32, device),
                      phi=_t(phi, f32, device), z=_t(z, c64, device),
                      active=_t(active, torch.bool, device),
                      T=_t(T, torch.int32, device), t=int(t))


def svd_from_numpy(U, s, Vh, device) -> SVD:
    """An :class:`SVD` from the factors of ``A = U diag(s) Vh``: the tests
    hand both packages the same factors, since singular vectors are
    defined only up to a phase each."""
    U, Vh = np.asarray(U), np.asarray(Vh)
    dtype = torch.complex64 if np.iscomplexobj(U) else torch.float32
    return SVD(U=_t(U, dtype, device), s=_t(s, torch.float32, device),
               Vh=_t(Vh, dtype, device))


def vamp_state_from_numpy(r_tilde, sigma2_tilde, r, var, xmmse, active, T,
                          t, device) -> VAMPState:
    """A :class:`VAMPState` from arrays in the JAX ``VAMPState`` layout."""
    c64, f32 = torch.complex64, torch.float32
    return VAMPState(r_tilde=_t(r_tilde, c64, device),
                     sigma2_tilde=_t(sigma2_tilde, f32, device),
                     r=_t(r, c64, device), var=_t(var, f32, device),
                     xmmse=_t(xmmse, c64, device),
                     active=_t(active, torch.bool, device),
                     T=_t(T, torch.int32, device), t=int(t))


def vamp2_state_from_numpy(r, gamma, var, xmmse, active, T, t,
                           device) -> VAMP2State:
    """A :class:`VAMP2State` from arrays in the JAX ``VAMP2State`` layout."""
    c64, f32 = torch.complex64, torch.float32
    return VAMP2State(r=_t(r, c64, device), gamma=_t(gamma, f32, device),
                      var=_t(var, f32, device), xmmse=_t(xmmse, c64, device),
                      active=_t(active, torch.bool, device),
                      T=_t(T, torch.int32, device), t=int(t))


def plane_from_jax(a, device) -> torch.Tensor:
    """A JAX kernel plane, (blocks, B, width) float32 (``_to_x`` /
    ``_to_y`` of the JAX package's ``fused_bamp.py:919-932``), in the port's
    trial-major layout (B, blocks * width)."""
    a = np.asarray(a, np.float32)
    return _t(a.transpose(1, 0, 2).reshape(a.shape[1], -1), torch.float32,
              device)


def plane_to_jax(t: torch.Tensor, blocks: int) -> np.ndarray:
    """A port plane (B, blocks * width) in the JAX kernels' layout
    (blocks, B, width)."""
    a = t.detach().cpu().numpy()
    return a.reshape(a.shape[0], blocks, -1).transpose(1, 0, 2).copy()


def notok_from_jax(notok) -> np.ndarray:
    """The JAX kernels' per-(block, trial) ``notok`` (blocks, B, 1) as the
    port's per-trial count (B,)."""
    return np.asarray(notok).sum(axis=0)[:, 0].astype(np.int32)


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """The fields of a decoder state (:class:`BAMPState`,
    :class:`SCAMPState`, :class:`VAMPState` or :class:`VAMP2State`) as
    NumPy arrays."""
    out = {f: getattr(state, f).detach().cpu().numpy()
           for f in state._fields if f != "t"}
    out["t"] = np.int32(state.t)
    return out


scamp_state_to_numpy = state_to_numpy
