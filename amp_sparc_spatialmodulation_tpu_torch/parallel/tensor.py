"""Tensor-parallel BAMP decode: the measurement operator's columns split
over the ``model`` axis of the mesh.

Port of the JAX package's ``parallel/tensor.py``.  The columns are the
frame's channel uses, so a split at channel-use boundaries
(``Lin % model_size == 0``) keeps every denoiser segment on one rank.  Per
AMP iteration:

* ``H @ xmmse`` and ``|H|^2 @ var`` sum over the split columns: one
  all-reduce each over the model axis;
* ``H^H r`` and ``|H|^2^T u`` give column-split outputs: no exchange;
* the stop verdict is per trial: each rank's allclose count all-reduced.

Each rank holds its own columns ``H_k`` and the replicated ``y``; the
products run at ``precision`` (``ops/precision.py``).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..models import bamp
from ..models.bamp import _allclose_rows, _freeze
from ..ops import denoise
from ..ops import precision as prec
from .mesh import MODEL_AXIS, Axis, all_reduce, axis_of, gather_dim1


class TPState(NamedTuple):
    xmap: torch.Tensor    # (B, N_local) complex
    xmmse: torch.Tensor   # (B, N_local) complex
    var: torch.Tensor     # (B, N_local) f32
    z: torch.Tensor       # (B, n) complex, replicated
    u: torch.Tensor       # (B, n) f32, replicated
    active: torch.Tensor  # (B,) bool
    T: torch.Tensor       # (B,) int32
    t: int                # global iteration counter


def shard_columns(full: torch.Tensor, axis: Axis, dim: int = -1
                  ) -> torch.Tensor:
    """This rank's block of the channel-use (column) dimension ``dim`` of
    ``full``: block ``axis.index`` of ``axis.size`` equal blocks."""
    size = full.shape[dim] // axis.size
    return full.narrow(dim, axis.index * size, size).contiguous()


def gather_columns(x_k: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The column shards of every rank back to the full (B, N) array."""
    return gather_dim1(x_k, axis)


def local_config(cfg: Config, axis: Axis) -> Config:
    """``cfg`` as one rank of ``axis`` sees it, ``Lin / axis.size`` channel
    uses: the decoders' own denoisers then run on the rank's columns (no
    segment straddles two ranks; the priors do not depend on Lin), in place
    of the JAX module's ``make_denoiser_local``."""
    if cfg.Lin % axis.size:
        raise ValueError(f"model axis size k={axis.size} must divide "
                         f"Lin={cfg.Lin}")
    return cfg.replace(Lin=cfg.Lin // axis.size)


def alive(active: torch.Tensor, axis: Axis) -> bool:
    """Whether any trial of any rank of ``axis`` is still active: the loop
    condition of every frame-sharded decode, read on the host once per
    iteration, so that the ranks that share the loop's collectives run it
    the same number of times."""
    return bool(all_reduce(active.any().reshape(1), axis).item())


def converged_everywhere(ok: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Per trial: True where the allclose verdict ``ok`` holds on every
    rank of ``axis``."""
    return all_reduce(ok, axis) == axis.size


def decode(H_k: torch.Tensor, y: torch.Tensor, sigma2, cfg: Config, *,
           mesh, precision: str = "highest",
           state0: TPState | None = None, iter_cap: int | None = None,
           return_state: bool = False):
    """Tensor-parallel BAMP (`bamp.py:48-64` semantics) on a column shard.

    Args:
        H_k: (n, N_local), this rank's columns of the measurement matrix.
        y: (B, n) received vectors, the same on every rank of the axis.
        mesh: the device mesh; the columns are split over its model
            axis.
        precision: 'highest', 'high' or 'default', of every product.
        state0 / iter_cap / return_state: resumable decoding, as in
            :func:`..models.bamp.decode`: splitting at any cap and resuming
            gives the same trajectory (continuation batching).

    The loop runs while any trial of any rank of the axis is active
    (:func:`alive`).  The JAX decode also stops on the trials axis's
    verdict, because ``shard_map`` runs one program on every device; here
    the ranks of different trials rows share no collective inside the
    decode, so each row stops on its own.

    Returns ``(xmap_k, xmmse_k, var_k, T)`` with column-split estimates, or
    the final :class:`TPState` when ``return_state``.
    """
    axis = axis_of(mesh, MODEL_AXIS)
    denoiser = bamp.make_denoiser(local_config(cfg, axis), y.device)
    mm = partial(prec.matmul, precision=prec.canonical(precision))
    B = y.shape[0]
    n, N_local = H_k.shape
    Ht, Hc = H_k.T, H_k.conj()
    abs2 = H_k.abs() ** 2
    abs2_t = abs2.T
    sigma2 = float(np.float32(sigma2))

    if state0 is None:
        dev = y.device
        state0 = TPState(
            xmap=torch.zeros((B, N_local), dtype=y.dtype, device=dev),
            xmmse=torch.zeros((B, N_local), dtype=y.dtype, device=dev),
            var=torch.ones((B, N_local), dtype=torch.float32, device=dev),
            z=y.clone(),
            u=torch.full((B, n), sigma2, dtype=torch.float32, device=dev),
            active=torch.ones((B,), dtype=torch.bool, device=dev),
            T=torch.zeros((B,), dtype=torch.int32, device=dev),
            t=0)
    cap = cfg.N_Layers if iter_cap is None else int(iter_cap)
    s = state0
    while s.t < cap and alive(s.active, axis):
        v = all_reduce(mm(s.var, abs2_t), axis)                # (B, n)
        Hx = all_reduce(mm(s.xmmse, Ht), axis)                 # (B, n)
        z = Hx - denoise.div_real(v * (y - s.z), s.u).to(y.dtype)
        u = v + sigma2
        cov = 1.0 / mm(1.0 / u, abs2)                          # local cols
        resid = denoise.div_real(y - z, u).to(y.dtype)
        xmap = s.xmmse + cov * mm(resid, Hc)                   # local cols
        xmmse, var = denoiser(xmap, cov)
        converged = converged_everywhere(_allclose_rows(var, s.var), axis)
        s = TPState(
            xmap=_freeze(s.active, xmap, s.xmap),
            xmmse=_freeze(s.active, xmmse, s.xmmse),
            var=_freeze(s.active, var, s.var),
            z=_freeze(s.active, z, s.z),
            u=_freeze(s.active, u, s.u),
            active=s.active & ~converged,
            T=torch.where(s.active, torch.full_like(s.T, s.t + 1), s.T),
            t=s.t + 1)
    if return_state:
        return s
    return s.xmap, s.xmmse, s.var, s.T
