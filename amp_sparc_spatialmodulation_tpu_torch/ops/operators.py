"""Measurement-operator abstraction: dense and banded (tap-form) forms.

Port of the JAX package's ``ops/operators.py``.  The decoders need four
linear maps per AMP iteration (`bamp.py:59-63`):

    apply(x)      = H @ x          (B, N) -> (B, n)
    apply_adj(r)  = H^H @ r        (B, n) -> (B, N)
    apply_abs2(v) = |H|^2 @ v      (B, N) -> (B, n)   real
    apply_abs2T(u)= |H|^2^T @ u    (B, n) -> (B, N)   real

``DenseOperator`` wraps the materialized matrix.  ``BandedOperator`` keeps
the channel in tap form: block ``(c+l, c)`` of the operator is
``gains[l, c] * h_l``, so every map is one ``(B*Lin, Nt) @ (Nt, Lh*Nr)``
product plus a shifted accumulation over the ``Lh`` taps.

Unlike the JAX ``_fwd``/``_bwd``, taps that place no block (``trunc`` with
``Lh > Lin``) are skipped rather than indexed.

Each map of either operator takes the precision of its products (JAX
``ops/operators.py:41-63`` and ``:77-84``, there an attribute of the
operator): ``'highest'`` (the default) is exactly ``x @ H^T`` or ``x @
taps``; ``'high'`` (``'default'``) is ``ops/precision.py::matmul``, four
three-pass (one-pass) bf16 products per complex product, the form the port
takes for XLA's products at HIGH (DEFAULT).  ``BandedOperator`` applies its
gains after the products either way.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from . import channel as channel_ops
from . import precision as prec


class DenseOperator:
    """Materialized (n, N) measurement matrix with precomputed constants.
    Each map takes ``precision``, that of its product (module docstring)."""

    def __init__(self, H: torch.Tensor):
        self.H = H
        self.Ht = H.T
        self.Hc = H.conj()
        self.abs2 = H.abs() ** 2
        self.abs2T = self.abs2.T

    @property
    def shape(self):
        return tuple(self.H.shape)

    def apply(self, x, precision="highest"):
        return prec.matmul(x, self.Ht, precision)

    def apply_adj(self, r, precision="highest"):
        return prec.matmul(r, self.Hc, precision)

    def apply_abs2(self, v, precision="highest"):
        return prec.matmul(v, self.abs2T, precision)

    def apply_abs2T(self, u, precision="highest"):
        return prec.matmul(u, self.abs2, precision)


class BandedOperator:
    """Tap-form block-banded operator.

    Args:
        h: (Lh, Nr, Nt) channel taps.
        gains: (Lh, Lin) per-(tap, column-block) gains (NumPy or tensor);
            block (c+l, c) of the dense operator equals ``gains[l, c] * h[l]``.
        Lin, Lout, trunc: block geometry (`channel.py:60-72`).

    Each map takes ``precision``, that of its tap-stack products (module
    docstring).
    """

    def __init__(self, h: torch.Tensor, gains, Lin: int, Lout: int,
                 trunc: str):
        self.h = h
        self.abs_h2 = h.abs() ** 2
        g = (gains if torch.is_tensor(gains)
             else torch.from_numpy(np.asarray(gains, np.float32)))
        self.gains = g.to(device=h.device, dtype=torch.float32).contiguous()
        self.gains2 = self.gains ** 2
        self.Lin, self.Lout, self.trunc = Lin, Lout, trunc
        self.Lh, self.Nr, self.Nt = h.shape
        self.h_stack = h.permute(2, 0, 1).reshape(self.Nt, self.Lh * self.Nr)
        self.abs_h2_stack = self.h_stack.abs() ** 2
        # (l, rows, cols) of every tap that places at least one block.
        self._taps = []
        for l in range(self.Lh):
            rows, cols = channel_ops.band_indices(Lin, Lout, l, trunc)
            if len(rows):
                self._taps.append((l, rows, cols))

    @property
    def shape(self):
        return (self.Nr * self.Lout, self.Nt * self.Lin)

    def _fwd(self, x, taps_stack, gains, precision):
        """``y[r] = sum_l gains[l, r-l] * taps[l] @ x[r-l]``."""
        B = x.shape[0]
        P = prec.matmul(x.reshape(B * self.Lin, self.Nt), taps_stack,
                        precision).reshape(B, self.Lin, self.Lh, self.Nr)
        y = torch.zeros((B, self.Lout, self.Nr), dtype=P.dtype,
                        device=P.device)
        for l, rows, cols in self._taps:
            c0, k = int(cols[0]), len(cols)
            contrib = (gains[l, c0:c0 + k][None, :, None]
                       * P[:, c0:c0 + k, l])
            if self.trunc == "cyclic":
                # wrapped rows: a general index add (rows are distinct)
                y.index_add_(1, torch.as_tensor(rows, device=y.device),
                             contrib)
            else:
                r0 = int(rows[0])
                y[:, r0:r0 + k] += contrib
        return y.reshape(B, self.Lout * self.Nr)

    def _bwd(self, z, taps_stack, gains, precision):
        """Adjoint of :meth:`_fwd` (conjugate taps)."""
        B = z.shape[0]
        zb = z.reshape(B, self.Lout, self.Nr)
        Zl = torch.zeros((B, self.Lin, self.Lh, self.Nr), dtype=z.dtype,
                         device=z.device)
        for l, rows, cols in self._taps:
            c0, k = int(cols[0]), len(cols)
            if self.trunc == "cyclic":
                src = zb[:, torch.as_tensor(rows, device=z.device)]
            else:
                src = zb[:, int(rows[0]):int(rows[0]) + k]
            Zl[:, c0:c0 + k, l] = gains[l, c0:c0 + k][None, :, None] * src
        r = prec.matmul(Zl.reshape(B * self.Lin, self.Lh * self.Nr),
                        taps_stack.conj().T, precision)
        return r.reshape(B, self.Lin * self.Nt)

    def apply(self, x, precision="highest"):
        return self._fwd(x, self.h_stack, self.gains, precision)

    def apply_adj(self, r, precision="highest"):
        return self._bwd(r, self.h_stack, self.gains, precision)

    def apply_abs2(self, v, precision="highest"):
        return self._fwd(v, self.abs_h2_stack, self.gains2, precision).real

    def apply_abs2T(self, u, precision="highest"):
        return self._bwd(u, self.abs_h2_stack, self.gains2, precision).real

    def densify(self) -> torch.Tensor:
        """Materialize the dense matrix (tests / SVD path)."""
        blocks = torch.zeros((self.Lout, self.Lin, self.Nr, self.Nt),
                             dtype=self.h.dtype, device=self.h.device)
        for l, rows, cols in self._taps:
            r = torch.as_tensor(rows, device=self.h.device)
            c = torch.as_tensor(cols, device=self.h.device)
            blocks.index_put_(
                (r, c), self.gains[l, c][:, None, None] * self.h[l][None],
                accumulate=True)
        return blocks.permute(0, 2, 1, 3).reshape(self.Nr * self.Lout,
                                                  self.Nt * self.Lin)


def as_operator(H):
    """Wrap a raw matrix; pass operators through unchanged."""
    if hasattr(H, "apply_abs2T"):
        return H
    return DenseOperator(H)


def banded_toeplitz(gen: torch.Generator, cfg: Config) -> BandedOperator:
    """Tap-form equivalent of ``generate_channel`` (`channel.py:40-73`)."""
    h = channel_ops.sample_taps(gen, cfg)
    gains = np.ones((cfg.Lh, cfg.Lin), np.float32)
    return BandedOperator(h=h, gains=gains, Lin=cfg.Lin, Lout=cfg.Lout,
                          trunc=cfg.trunc)


def sparc_gains(cfg: Config, W: np.ndarray) -> np.ndarray:
    """(Lh, Lin) gains ``sqrt(W[c+l, c])`` of the SPARC operator."""
    cols = np.arange(cfg.Lin)
    gains = np.zeros((cfg.Lh, cfg.Lin), np.float32)
    for l in range(cfg.Lh):
        rows = cols + l
        keep = rows < cfg.Lout
        gains[l, cols[keep]] = np.sqrt(W[rows[keep], cols[keep]])
    return gains


def banded_sparc(gen: torch.Generator, cfg: Config):
    """Tap-form equivalent of ``generate_as_sparc`` (`channel.py:75-95`).

    Returns ``(W, op)`` with the base matrix for SCAMP bookkeeping.
    """
    W = channel_ops.base_matrix(cfg)
    h = channel_ops.sample_sparc_taps(gen, cfg)
    op = BandedOperator(h=h, gains=sparc_gains(cfg, W), Lin=cfg.Lin,
                        Lout=cfg.Lout, trunc=cfg.trunc)
    return torch.as_tensor(W, device=h.device), op
