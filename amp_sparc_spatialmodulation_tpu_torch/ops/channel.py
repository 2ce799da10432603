"""Frequency-selective Rayleigh MIMO channel generation.

Port of the JAX package's ``ops/channel.py``, with the same functions:

* ``generate_channel``  — block-Toeplitz ``H = sum_l kron(eye(Lin,Lin,-l), h_l)``
  with ``trunc`` / ``tail`` / ``cyclic`` truncation (`channel.py:40-73`).
* ``generate_as_sparc`` — SPARC base matrix ``W`` and measurement matrix
  ``A = sum_l kron(eye(Lout,Lin,-l)*sqrt(W), h_l)`` (`channel.py:75-95`).
* ``generate_as_random`` — i.i.d. Gaussian matrix (`channel.py:97-101`).
* ``awgn``              — complex AWGN with ``sigma2 = (Na/Nr)/SNR``
  (`channel.py:103-116`).

Random draws come from an explicit ``torch.Generator`` and land on that
generator's device.  Torch's Philox stream differs from JAX's threefry, so
the two packages agree in distribution, not sample by sample.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import Config


def _crandn(gen: torch.Generator, shape, is_complex: bool) -> torch.Tensor:
    """Standard normal per real dimension: CN(0, 2) complex / N(0, 1) real."""
    re = torch.randn(shape, generator=gen, device=gen.device,
                     dtype=torch.float32)
    if not is_complex:
        return re
    im = torch.randn(shape, generator=gen, device=gen.device,
                     dtype=torch.float32)
    return torch.complex(re, im)


def sample_taps(gen: torch.Generator, cfg: Config) -> torch.Tensor:
    """Channel taps ``h[l] ~ CN(0, pdp[l] * Lout / (Nr * Lin))``, shape
    ``(Lh, Nr, Nt)`` (`channel.py:53-55`)."""
    scale = np.sqrt(cfg.pdp * cfg.Lout / cfg.Nr / cfg.Lin
                    / (2.0 if cfg.is_complex else 1.0)).astype(np.float32)
    h = _crandn(gen, (cfg.Lh, cfg.Nr, cfg.Nt), cfg.is_complex)
    return h * torch.as_tensor(scale, device=h.device)[:, None, None]


def sample_sparc_taps(gen: torch.Generator, cfg: Config) -> torch.Tensor:
    """SPARC-normalized taps ``h ~ CN(0, 1/(Na*Lin))`` (`channel.py:85-87`)."""
    scale = 1.0 / np.sqrt((2.0 if cfg.is_complex else 1.0) * cfg.Na * cfg.Lin)
    h = _crandn(gen, (cfg.Lh, cfg.Nr, cfg.Nt), cfg.is_complex)
    return h * float(np.float32(scale))


def band_indices(Lin: int, Lout: int, Lh_index: int,
                 trunc: str) -> Tuple[np.ndarray, np.ndarray]:
    """(row blocks, column blocks) of tap ``Lh_index`` in the operator.

    trunc:  block (c+l, c) kept only when c+l < Lout  (`channel.py:56-58`)
    tail:   all Lin blocks present, Lout = Lin+Lh-1   (`channel.py:60-66`)
    cyclic: block ((c+l) mod Lin, c)                  (`channel.py:68-72`)
    """
    cols = np.arange(Lin)
    rows = cols + Lh_index
    if trunc == "cyclic":
        rows = rows % Lin
    else:
        keep = rows < Lout
        rows, cols = rows[keep], cols[keep]
    return rows, cols


def _assemble(blocks_fn, cfg: Config, dtype, device) -> torch.Tensor:
    """Dense ``(Nr*Lout, Nt*Lin)`` matrix from per-tap blocks
    ``blocks_fn(l, rows, cols) -> (len(rows), Nr, Nt)``."""
    blocks = torch.zeros((cfg.Lout, cfg.Lin, cfg.Nr, cfg.Nt), dtype=dtype,
                         device=device)
    for l in range(cfg.Lh):
        rows, cols = band_indices(cfg.Lin, cfg.Lout, l, cfg.trunc)
        if len(rows):
            r = torch.as_tensor(rows, device=device)
            c = torch.as_tensor(cols, device=device)
            blocks.index_put_((r, c), blocks_fn(l, rows, cols),
                              accumulate=True)
    return blocks.permute(0, 2, 1, 3).reshape(cfg.Nr * cfg.Lout,
                                              cfg.Nt * cfg.Lin)


def dense_from_taps(h: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Dense block-Toeplitz ``H`` from taps (`channel.py:56-72`)."""
    return _assemble(lambda l, r, c: h[l].expand(len(r), -1, -1), cfg,
                     h.dtype, h.device)


def generate_channel(gen: torch.Generator, cfg: Config) -> torch.Tensor:
    """Dense frequency-selective MIMO matrix ``H`` (`channel.py:40-73`)."""
    return dense_from_taps(sample_taps(gen, cfg), cfg)


def base_matrix(cfg: Config) -> np.ndarray:
    """SPARC base matrix ``W`` (Lout, Lin), normalized so its mean equals
    ``Na/Nr`` (`channel.py:80-83`).  Deterministic, so plain NumPy."""
    W = np.zeros((cfg.Lout, cfg.Lin))
    for l in range(cfg.Lh):
        W += np.eye(cfg.Lout, cfg.Lin, -l) * cfg.pdp[l]
    W = W / W.mean() * cfg.Na / cfg.Nr
    return W.astype(np.float32)


def dense_sparc_from_taps(h: torch.Tensor, W: np.ndarray,
                          cfg: Config) -> torch.Tensor:
    """Dense SPARC measurement matrix ``A`` from taps + base matrix
    (`channel.py:89-92`): block ``(c+l, c)`` equals ``sqrt(W[c+l,c]) h_l``."""
    sqrtW = np.sqrt(W).astype(np.float32)

    def blk(l, rows, cols):
        g = torch.as_tensor(sqrtW[rows, cols], device=h.device)
        return g[:, None, None] * h[l][None]

    return _assemble(blk, cfg, h.dtype, h.device)


def generate_as_sparc(gen: torch.Generator,
                      cfg: Config) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W, A) pair (`channel.py:75-95`)."""
    W = base_matrix(cfg)
    h = sample_sparc_taps(gen, cfg)
    return (torch.as_tensor(W, device=h.device),
            dense_sparc_from_taps(h, W, cfg))


def generate_as_random(gen: torch.Generator, cfg: Config) -> torch.Tensor:
    """i.i.d. ``CN(0, 1/(Lin*Nr))`` matrix (`channel.py:97-101`)."""
    scale = 1.0 / np.sqrt((2.0 if cfg.is_complex else 1.0) * cfg.Lin * cfg.Nr)
    H = _crandn(gen, (cfg.Nr * cfg.Lout, cfg.Nt * cfg.Lin), cfg.is_complex)
    return H * float(np.float32(scale))


def awgn(gen: torch.Generator, cfg: Config, snr,
         batch: int | None = None) -> torch.Tensor:
    """AWGN with total variance ``sigma2 = (Na/Nr)/SNR`` per entry
    (`channel.py:103-116`).  Returns shape ``(batch, Nr*Lout)``."""
    B = cfg.B if batch is None else batch
    scale = float(np.sqrt(np.float32(cfg.Na / cfg.Nr / float(snr)
                                     / (2.0 if cfg.is_complex else 1.0))))
    w = _crandn(gen, (B, cfg.Nr * cfg.Lout), cfg.is_complex)
    return w * scale
