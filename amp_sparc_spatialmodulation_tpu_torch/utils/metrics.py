"""Hard decisions and error metrics, vectorized on the decode's device.

Port of the JAX package's ``utils/metrics.py`` (reference ``Loss``): the
three mode-specific hard decisions (`loss.py:223-302`), the global
top-``Ns`` "dumb" decision (`loss.py:198-221`), and the 14-metric report
``['fer','nMSE','nMSEf','nMSEm','nMSEL','ver','verf','verm','verL','ber',
'iber','sber','ier','ser']`` (`loss.py:27`) with the same normalizations.

Per-batch metrics are raw SUMS, additive across trial batches;
:func:`finalize` converts accumulated sums into the reference's per-trial
averages.  Bit metrics keep the reference's published convention
(`loss.py:153-196`), with the index-bit width pinned to the per-frame (B=1)
convention as the JAX package does.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config import Config
from ..ops.message import Message, dense_x

METRIC_KEYS = ("fer", "nMSE", "nMSEf", "nMSEm", "nMSEL", "ver", "verf",
               "verm", "verL", "ber", "iber", "sber", "ier", "ser")

SUM_KEYS = ("trials", "T", "fer", "ver", "verf", "verm", "verL", "nMSE",
            "nMSEf", "nMSEm", "nMSEL", "ier", "ser", "iber_", "sber_")


class Decision(NamedTuple):
    """Hard decision in the same structured form as :class:`Message`;
    ``ant``/``vals`` (per-segment antenna and decided symbol VALUE) are
    None for decision rules that do not factor per segment."""

    xhat: torch.Tensor
    gray: torch.Tensor
    flat: torch.Tensor
    ant: Optional[torch.Tensor] = None
    vals: Optional[torch.Tensor] = None


def _tables(cfg: Config, device):
    return (torch.as_tensor(cfg.symbols, device=device),
            torch.as_tensor(cfg.gray, device=device))


def _nearest_symbol(vals: torch.Tensor, symbols: torch.Tensor):
    """Index of the nearest symbol (first wins on ties, `loss.py:239-246`)."""
    return torch.argmin((vals[..., None] - symbols).abs(), dim=-1)


def _segment_base(B: int, L: int, M: int, device) -> torch.Tensor:
    return (torch.arange(B, dtype=torch.int32, device=device)[:, None] * L
            + torch.arange(L, dtype=torch.int32, device=device)[None, :]) * M


def _one_hot_rows(ant: torch.Tensor, vals: torch.Tensor, M: int):
    x = torch.zeros(ant.shape + (M,), dtype=vals.dtype, device=vals.device)
    return x.scatter_(-1, ant.long()[..., None], vals[..., None])


def segmented_decision(xamp: torch.Tensor, cfg: Config) -> Decision:
    """Per-segment argmax + nearest symbol (`loss.py:223-250`)."""
    B = xamp.shape[0]
    L, M = cfg.L, cfg.M
    symbols, gray_tab = _tables(cfg, xamp.device)
    seg = xamp.reshape(B, L, M)
    ant = seg.abs().argmax(dim=-1).int()                       # (B, L)
    picked = torch.gather(seg, -1, ant.long()[..., None])[..., 0]
    sym = _nearest_symbol(picked, symbols)
    vals = symbols[sym]
    xhat = _one_hot_rows(ant, vals, M).reshape(B, L * M)
    return Decision(xhat=xhat, gray=gray_tab[sym],
                    flat=_segment_base(B, L, M, xamp.device) + ant,
                    ant=ant, vals=vals)


def map_decision(xamp: torch.Tensor, cfg: Config) -> Decision:
    """Joint (antenna, symbol) MAP over ``Re(x_m conj(s_k))``
    (`loss.py:282-302`)."""
    B = xamp.shape[0]
    L, M, K = cfg.L, cfg.M, cfg.K
    symbols, gray_tab = _tables(cfg, xamp.device)
    seg = xamp.reshape(B, L, M)
    corr = (seg[..., None] * symbols.conj()).real
    joint = corr.reshape(B, L, M * K).argmax(dim=-1)
    ant = (joint // K).int()
    sym = joint % K
    vals = symbols[sym]
    xhat = _one_hot_rows(ant, vals, M).reshape(B, L * M)
    return Decision(xhat=xhat, gray=gray_tab[sym],
                    flat=_segment_base(B, L, M, xamp.device) + ant,
                    ant=ant, vals=vals)


def random_decision(xamp: torch.Tensor, cfg: Config) -> Decision:
    """Top-``Na`` magnitudes per channel use, nearest symbol per entry
    (`loss.py:252-280`)."""
    B = xamp.shape[0]
    Lin, Nt, Na = cfg.Lin, cfg.Nt, cfg.Na
    symbols, gray_tab = _tables(cfg, xamp.device)
    rows = xamp.reshape(B, Lin, Nt)
    idx = torch.topk(rows.abs(), Na, dim=-1).indices
    ant = torch.sort(idx.int(), dim=-1).values                 # (B, Lin, Na)
    picked = torch.gather(rows, -1, ant.long())
    sym = _nearest_symbol(picked, symbols)
    vals = symbols[sym]
    xhat = torch.zeros_like(rows, dtype=vals.dtype)
    xhat.scatter_(-1, ant.long(), vals)
    base = _segment_base(B, Lin, Nt, xamp.device)
    return Decision(xhat=xhat.reshape(B, Lin * Nt), gray=gray_tab[sym],
                    flat=base[..., None] + ant)


def dumb_decision(xamp: torch.Tensor, cfg: Config) -> Decision:
    """Global top-``B*Lin*Na`` over the flattened batch (`loss.py:198-221`)."""
    B = xamp.shape[0]
    symbols, gray_tab = _tables(cfg, xamp.device)
    flat_x = xamp.reshape(-1)
    ns = B * cfg.Lin * cfg.Na
    idx = torch.sort(torch.topk(flat_x.abs(), ns).indices.int()).values
    picked = flat_x[idx.long()]
    sym = _nearest_symbol(picked, symbols)
    vals = symbols[sym]
    xhat = torch.zeros_like(flat_x, dtype=vals.dtype)
    xhat[idx.long()] = vals
    return Decision(xhat=xhat.reshape(B, -1), gray=gray_tab[sym], flat=idx)


def decide(xamp: torch.Tensor, cfg: Config) -> Decision:
    if cfg.mode == "random":
        return random_decision(xamp, cfg)
    if cfg.mode == "segmented":
        return segmented_decision(xamp, cfg)
    return map_decision(xamp, cfg)          # sparc (`loss.py:40-41`)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of non-negative integers below 2^31 (SWAR in int64)."""
    x = x.long()
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _popcount_masked(a: torch.Tensor, b: torch.Tensor, bits: int,
                     rsum) -> torch.Tensor:
    """Sum of set bits in ``(a ^ b)`` truncated to the low ``bits`` bits —
    the reference's ``de2bi(bitwise_xor(...), bits)`` count
    (`loss.py:181-196`)."""
    if bits <= 0:
        return torch.zeros((), dtype=torch.float32, device=a.device)
    mask = (1 << min(bits, 31)) - 1
    return rsum(_popcount(torch.bitwise_xor(a, b) & mask)).to(torch.float32)


def evaluate_sums(xmap: torch.Tensor, xmmse: torch.Tensor, msg: Message,
                  T: torch.Tensor, cfg: Config,
                  weight: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """Per-batch raw metric sums (additive across batches).

    Mirrors ``Loss.__call__``/``error_rate`` (`loss.py:43-103`) with hard
    decisions on ``xmap`` and NMSE on ``xmmse``.  ``weight`` (optional,
    (B,) float32) weights each trial's contribution to every sum.  A
    message whose dense ``x`` was dropped is rebuilt from its truth.
    """
    B = xmap.shape[0]
    dec = decide(xmap, cfg)
    x = msg.x if msg.x is not None else dense_x(msg, cfg)
    f32 = torch.float32
    if weight is None:
        def rsum(v):
            return v.sum()
        n_trials = torch.tensor(float(B), dtype=f32, device=xmap.device)
    else:
        w = weight.reshape(B).to(f32)

        def rsum(v):
            per = v.reshape(B, -1).sum(dim=1) if v.ndim > 1 else v
            return (per.to(f32) * w).sum()

        n_trials = w.sum()

    # --- NMSE sums (`loss.py:105-120`)
    d2 = (xmmse - x).abs() ** 2
    d2_use = d2.reshape(B, cfg.Lin, cfg.Nt)
    nmse = rsum(d2)
    nmse_f = rsum(d2_use[:, 0])
    nmse_m = rsum(d2_use[:, cfg.Lin // 2])
    nmse_l = rsum(d2_use[:, -1])

    # --- vector / frame errors (`loss.py:122-151`): exact value mismatch
    if dec.ant is not None and all(complex(s) != 0 for s in cfg.symbols):
        # Factored form on (B, L) planes: identical to the dense
        # ``xhat != x`` compare when no symbol is 0 (value comparison keeps
        # the 16QAM duplicate semantics).
        symbols, _ = _tables(cfg, xmap.device)
        true_vals = symbols[msg.sym.long()]
        seg_err = (dec.ant != msg.ant) | (dec.vals != true_vals)   # (B, L)
        err_use = seg_err.reshape(B, cfg.Lin, cfg.Na).any(dim=-1)  # (B, Lin)
    else:
        neq = (dec.xhat != x).reshape(B, cfg.Lin, cfg.Nt)
        err_use = neq.any(dim=-1)                                   # (B, Lin)
    ver = rsum(err_use)
    verf = rsum(err_use[:, 0])
    verm = rsum(err_use[:, cfg.Lin // 2])
    verl = rsum(err_use[:, -1])
    fer = rsum(err_use.any(dim=-1))

    # --- index / symbol / bit errors (`loss.py:153-179`); flat indices are
    # compared within the frame (mod Lin*Nt), so the count does not depend
    # on the trial's row in the batch.
    n_frame = cfg.Lin * cfg.Nt
    ier = rsum((dec.flat % n_frame) != (msg.flat % n_frame))
    ser = rsum(dec.gray != msg.gray)
    ibits_trunc = int(np.ceil(np.log2(max(cfg.Lin * cfg.Na, 2))))
    iber_ = _popcount_masked(dec.flat % n_frame, msg.flat % n_frame,
                             ibits_trunc, rsum)
    sber_ = _popcount_masked(dec.gray, msg.gray, cfg.symbol_bits, rsum)

    def as_f32(v):
        return torch.as_tensor(v, device=xmap.device).to(f32)

    return {
        "trials": as_f32(n_trials), "T": as_f32(rsum(T.reshape(B))),
        "fer": as_f32(fer), "ver": as_f32(ver), "verf": as_f32(verf),
        "verm": as_f32(verm), "verL": as_f32(verl),
        "nMSE": as_f32(nmse), "nMSEf": as_f32(nmse_f),
        "nMSEm": as_f32(nmse_m), "nMSEL": as_f32(nmse_l),
        "ier": as_f32(ier), "ser": as_f32(ser), "iber_": iber_,
        "sber_": sber_,
    }


def accumulate(total: Optional[Dict[str, torch.Tensor]],
               batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Running sum of :func:`evaluate_sums` outputs (`loss.py:325-336`);
    the sums stay on the device."""
    if total is None:
        return dict(batch)
    return {k: total[k] + batch[k] for k in batch}


def fetch_sums(sums: Dict[str, torch.Tensor | float]) -> Dict[str, float]:
    """Pull a metric-sums dict to the host in one transfer."""
    if not any(torch.is_tensor(v) for v in sums.values()):
        return {k: float(v) for k, v in sums.items()}
    keys = [k for k in SUM_KEYS if k in sums]
    keys += [k for k in sums if k not in SUM_KEYS]
    dev = next(v.device for v in sums.values() if torch.is_tensor(v))
    arr = torch.stack([torch.as_tensor(sums[k], device=dev).to(torch.float32)
                       for k in keys]).cpu().numpy()
    return {k: float(arr[i]) for i, k in enumerate(keys)}


def finalize(sums: Dict[str, torch.Tensor | float],
             cfg: Config) -> Dict[str, float]:
    """Convert accumulated sums to the reference's per-trial averages
    (``Loss.average`` + ``error_rate`` normalizations)."""
    sums = fetch_sums(sums)
    n = sums["trials"]
    lin, na = cfg.Lin, cfg.Na
    sbits, ibits = cfg.symbol_bits, cfg.index_bits
    iber_ = sums["iber_"] / (lin * n)
    sber_ = sums["sber_"] / (lin * n)
    return {
        "T": sums["T"] / n,
        "fer": sums["fer"] / n,
        "nMSE": sums["nMSE"] / (lin * na * n),
        "nMSEf": sums["nMSEf"] / (na * n),
        "nMSEm": sums["nMSEm"] / (na * n),
        "nMSEL": sums["nMSEL"] / (na * n),
        "ver": sums["ver"] / (lin * n),
        "verf": sums["verf"] / n,
        "verm": sums["verm"] / n,
        "verL": sums["verL"] / n,
        "ber": (iber_ + sber_) / (na * sbits + ibits),
        "iber": iber_ / ibits,
        "sber": (sber_ / sbits / na) if sbits else 0.0,
        "ier": sums["ier"] / (lin * na * n),
        "ser": sums["ser"] / (lin * na * n),
    }
