"""Sparse spatial-modulation message generation.

Port of the JAX package's ``ops/message.py`` (reference ``data.py``):

* ``segmented`` (also used for ``sparc`` mode, `data.py:39-43`): ``Nt`` is
  split into ``Na`` segments of ``M = Nt/Na``; each of the ``L = Na*Lin``
  segments activates one uniformly-random antenna carrying one
  uniformly-random symbol (`data.py:74-91`).
* ``random``: each channel use activates ``Na`` of ``Nt`` antennas without
  replacement, all carrying the SAME uniformly-random symbol
  (`data.py:55-72`).

Besides the dense ``x``, the structured truth (antenna and symbol indices,
Gray labels, flat nonzero positions) is returned so the metrics never have
to re-derive it from the dense vector.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import Config


class Message(NamedTuple):
    """Ground truth for one batch of frames.

    Attributes:
        x:    dense transmit vector, shape (B, N) with N = Lin*Nt, flat
              index ``l*Nt + antenna`` (`data.py:69,88`).  ``None`` once a
              caller has dropped it; :func:`dense_x` rebuilds it.
        ant:  active antenna indices.  segmented/sparc: (B, L) in [0, M);
              random: (B, Lin, Na) sorted ascending in [0, Nt).
        sym:  symbol table indices.  segmented/sparc: (B, L); random: (B, Lin).
        gray: Gray labels of the active symbols, same shape as ``flat``.
        flat: flat indices of nonzeros into ``x.ravel()`` (global over the
              batch), sorted ascending per frame (`data.py:70,89`).
    """

    x: Optional[torch.Tensor]
    ant: torch.Tensor
    sym: torch.Tensor
    gray: torch.Tensor
    flat: torch.Tensor


def _tables(cfg: Config, device):
    symbols = torch.as_tensor(cfg.symbols, device=device)       # complex64
    gray_tab = torch.as_tensor(cfg.gray, device=device)         # int32
    return symbols, gray_tab


def _values(cfg: Config, symbols, sym):
    vals = symbols[sym.long()]
    return vals if cfg.is_complex else vals.real


def dense_x(msg: Message, cfg: Config) -> torch.Tensor:
    """The dense ``(B, N)`` transmit vector of ``msg`` from its structured
    truth (exactly the ``x`` the generator built)."""
    symbols, _ = _tables(cfg, msg.ant.device)
    vals = _values(cfg, symbols, msg.sym)
    B = msg.ant.shape[0]
    if cfg.mode in ("segmented", "sparc"):
        x = torch.zeros((B, cfg.L, cfg.M), dtype=vals.dtype,
                        device=vals.device)
        x.scatter_(2, msg.ant.long()[..., None], vals[..., None])
    else:
        x = torch.zeros((B, cfg.Lin, cfg.Nt), dtype=vals.dtype,
                        device=vals.device)
        x.scatter_(2, msg.ant.long(),
                   vals[..., None].expand(-1, -1, cfg.Na).contiguous())
    return x.reshape(B, cfg.N)


def _segmented(gen: torch.Generator, cfg: Config, batch: int) -> Message:
    B, L, M, K = batch, cfg.L, cfg.M, cfg.K
    dev = gen.device
    ant = torch.randint(0, M, (B, L), generator=gen, device=dev).int()
    sym = torch.randint(0, K, (B, L), generator=gen, device=dev).int()
    _, gray_tab = _tables(cfg, dev)
    base = (torch.arange(B, dtype=torch.int32, device=dev)[:, None] * L
            + torch.arange(L, dtype=torch.int32, device=dev)[None, :]) * M
    msg = Message(x=None, ant=ant, sym=sym, gray=gray_tab[sym.long()],
                  flat=base + ant)
    return msg._replace(x=dense_x(msg, cfg))


def _random(gen: torch.Generator, cfg: Config, batch: int) -> Message:
    B, Lin, Nt, Na, K = batch, cfg.Lin, cfg.Nt, cfg.Na, cfg.K
    dev = gen.device
    # Uniform Na-subset of Nt per channel use: indices of the Na largest of
    # Nt i.i.d. uniforms (exchangeability => uniform over subsets).
    scores = torch.rand((B, Lin, Nt), generator=gen, device=dev)
    idx = torch.topk(scores, Na, dim=-1).indices
    ant = torch.sort(idx.int(), dim=-1).values
    sym = torch.randint(0, K, (B, Lin), generator=gen, device=dev).int()
    _, gray_tab = _tables(cfg, dev)
    gray = gray_tab[sym.long()][..., None].expand(-1, -1, Na).contiguous()
    base = (torch.arange(B, dtype=torch.int32, device=dev)[:, None] * Lin
            + torch.arange(Lin, dtype=torch.int32, device=dev)[None, :]) * Nt
    msg = Message(x=None, ant=ant, sym=sym, gray=gray,
                  flat=base[..., None] + ant)
    return msg._replace(x=dense_x(msg, cfg))


def generate_message(gen: torch.Generator, cfg: Config,
                     batch: int | None = None) -> Message:
    """Draw one batch of sparse spatial-modulation frames (`data.py:45-53`)
    on the generator's device."""
    B = cfg.B if batch is None else batch
    if cfg.mode in ("segmented", "sparc"):
        return _segmented(gen, cfg, B)
    return _random(gen, cfg, B)
