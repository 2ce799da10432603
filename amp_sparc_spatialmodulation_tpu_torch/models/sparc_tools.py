"""SPARC coding tools: nat-rate math, power allocation, power-allocated
base matrices, and single-trial experiments.

Port of the JAX package's ``models/sparc_tools.py`` (the reference's
standalone NumPy twin ``sparc.py``): SPARC rate math in nats
(`sparc.py:15-24`), exponentially-decaying power allocation
(`sparc.py:94-104`), base matrices with per-column power weighting
(`sparc.py:67-84`), and single-trial end-to-end runs comparing SCAMP and
BAMP (`sparc.py:316-331,453-474`).  The empirical-residual ``estSCAMP``
variant (`sparc.py:180-204`) is :func:`..models.scamp.decode`'s
``estimate_phi=True``.

Conventions follow the twin, not ``channel.py``: the base matrix is
normalized so its MEAN IS ~1 (signal power), taps are ``CN(0, 1/Lt)``, and
rates are in nats.

A trial is one frame (B = 1), decoded with the decoders' default
``use_pallas='auto'``: on the card a complex segmented or sparc config
decodes it through the whole-decode kernels (K1 for BAMP, K2 for SCAMP),
each launched with a grid of one block; on the CPU through their plain
versions.  (The JAX package's single trial takes its XLA decode, its
decoders' default there being ``use_pallas=False``.)  The draw (:func:`_build_trial`), the decode
(:func:`_decode`) and the evaluation (:func:`_eval_trial`) are separate,
so that one trial drawn elsewhere can be decoded and scored alone.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import Config
from ..ops import channel as channel_ops
from ..ops import message as message_ops
from ..ops import operators
from ..utils import metrics
from ..utils.device import make_generator, resolve_device
from . import bamp as bamp_mod
from . import scamp as scamp_mod


def sparc_rate_nats(Nt: int, K: int, Lt: int, Lh: int, Nr: int) -> float:
    """Inner SPARC rate in nats (`sparc.py:19`)."""
    n = (Lt + Lh - 1) * Nr
    return Lt * float(np.log(Nt * K)) / n


def segmented_sparc_rate_nats(Nt: int, Na: int, Nr: int, Lt: int,
                              Lh: int, K: int) -> float:
    """Na-active segmented SPARC rate in nats (`sparc.py:351`)."""
    n = (Lt + Lh - 1) * Nr
    return Lt * Na * float(np.log(Nt * K / Na)) / n


def ebn0_min_db(rate: float) -> float:
    """Shannon-limit Eb/N0 for a rate (`sparc.py:21`)."""
    return 10.0 * float(np.log10((2.0 ** rate - 1.0) / rate))


def exp_power_allocation(snr: float, Lt: int, f: Optional[float] = None,
                         a: Optional[float] = None) -> np.ndarray:
    """Exponentially-decaying power allocation (`sparc.py:94-104`).

    With no (f, a): ``P_l ~ 2^(-2C l / Lt)``.  With ``0 < f < 1`` and
    ``a``: decay at slope ``a`` up to section ``f*Lt``, flat afterwards.
    """
    C = float(np.log(1.0 + snr))
    if f is None and a is None:
        return np.array([2.0 ** (-2.0 * C * l / Lt) for l in range(Lt)])
    if f is not None and 0.0 < f < 1.0 and a is not None:
        cut = int(f * Lt)
        pa1 = np.array([2.0 ** (-2.0 * a * C * l / Lt) for l in range(cut)])
        pa2 = np.full(Lt - cut, 2.0 ** (-2.0 * a * C * f))
        return np.concatenate([pa1, pa2])
    raise ValueError("need either no (f, a) or 0<f<1 with a set")


def base_matrix_pa(Lt: int, Lh: int, pdp: np.ndarray,
                   power_allocation: Optional[np.ndarray] = None
                   ) -> np.ndarray:
    """Power-allocated base matrix, mean ~ signal power = 1
    (`sparc.py:67-84`)."""
    Lr = Lt + Lh - 1
    if power_allocation is None:
        power_allocation = np.ones(Lt)
    W = np.zeros((Lr, Lt))
    for l in range(Lh):
        W += np.eye(Lr, Lt, -l) * pdp[l] * Lr / Lh
    return W * power_allocation / power_allocation.mean()


class SingleTrialResult(NamedTuple):
    ser: float            # section error rate
    fer: float
    nmse: float
    C: float              # AWGN capacity bits
    rate: float           # nat rate


class Trial(NamedTuple):
    """One drawn trial: the (Lout, Lin) float32 base matrix ``W``, the
    banded operator built from it, the message of one frame, the received
    ``(1, n)`` vector ``y``, the noise variance, the SNR and the nat
    rate."""

    W: np.ndarray
    op: operators.BandedOperator
    msg: message_ops.Message
    y: torch.Tensor
    sigma2: float
    snr: float
    rate: float


def _section_errors(xhat, x, L, M):
    seg_hat = np.asarray(xhat).reshape(L, M)
    seg = np.asarray(x).reshape(L, M)
    errs = (np.abs(seg_hat - seg) > 1e-6).any(axis=-1)
    return float(errs.mean()), float(errs.any())


def trial_point(cfg: Config, ebn0_db: float):
    """(nat rate, SNR) of a single trial at ``ebn0_db``: the SNR from the
    nat rate, as the twin takes it."""
    rate = segmented_sparc_rate_nats(cfg.Nt, cfg.Na, cfg.Nr, cfg.Lin,
                                     cfg.Lh, cfg.K)
    snr_db = ebn0_db + 10 * np.log10(rate)
    return rate, 10 ** (snr_db / 10)


def _build_trial(cfg: Config, ebn0_db: float,
                 power_allocation: Optional[np.ndarray], seed: int,
                 device) -> Trial:
    """One (message, power-allocated channel, noise) draw shared by the
    single-trial experiments, on ``device``.

    Uses the framework decoders on the twin's normalization: symbols stay
    unit power, the base matrix mean is renormalized to ``Na/Nr`` so the
    decoders' ``sigma2 = (Na/Nr)/SNR`` convention applies unchanged.  The
    taps, the message and the noise come from three generators of
    ``seed``, as the JAX package splits its key in three.
    """
    rate, snr = trial_point(cfg, ebn0_db)
    W = base_matrix_pa(cfg.Lin, cfg.Lh, cfg.pdp, power_allocation)
    # renormalize to the decoder convention (mean = Na/Nr, `channel.py:83`)
    W = (W / W.mean() * cfg.Na / cfg.Nr).astype(np.float32)
    g_taps, g_msg, g_noise = (make_generator(device, seed, i)
                              for i in range(3))
    h = channel_ops.sample_sparc_taps(g_taps, cfg)
    op = operators.BandedOperator(h=h, gains=operators.sparc_gains(cfg, W),
                                  Lin=cfg.Lin, Lout=cfg.Lout,
                                  trunc=cfg.trunc)
    msg = message_ops.generate_message(g_msg, cfg, 1)
    y = op.apply(msg.x) + channel_ops.awgn(g_noise, cfg, snr, 1)
    return Trial(W=W, op=op, msg=msg, y=y, sigma2=cfg.sigma2(snr), snr=snr,
                 rate=rate)


def _decode(algo: str, trial: Trial, cfg: Config,
            estimate_phi: bool = False, use_pallas="auto"):
    """Decode ``trial`` with SCAMP or BAMP (``use_pallas`` as the
    decoders take it)."""
    if algo == "scamp":
        return scamp_mod.decode(trial.W, trial.op, trial.y, trial.sigma2,
                                cfg, estimate_phi=estimate_phi,
                                use_pallas=use_pallas)
    if algo == "bamp":
        return bamp_mod.decode(trial.op, trial.y, trial.sigma2, cfg,
                               use_pallas=use_pallas)
    raise ValueError(f"unknown algo {algo!r}")


def _eval_trial(out, msg: message_ops.Message, cfg: Config, snr: float,
                rate: float) -> SingleTrialResult:
    """Hard-decide ``out`` and score it against ``msg``: section and frame
    errors over the ``Lin`` channel uses and the NMSE of ``xmmse`` against
    the dense x."""
    x = message_ops.dense_x(msg, cfg)
    dec = metrics.decide(out.xmap, cfg)
    ser, fer = _section_errors(dec.xhat[0].cpu().numpy(),
                               x[0].cpu().numpy(), cfg.Lin, cfg.Nt)
    nmse = float(torch.mean((out.xmmse - x).abs() ** 2))
    return SingleTrialResult(ser=ser, fer=fer, nmse=nmse,
                             C=float(np.log2(1 + snr)), rate=rate)


def run_single_trial(cfg: Config, ebn0_db: float, algo: str = "scamp",
                     power_allocation: Optional[np.ndarray] = None,
                     estimate_phi: bool = False, seed: int = 0,
                     device=None) -> SingleTrialResult:
    """Single-trial end-to-end SPARC experiment (`sparc.py:316-331`):
    draw message + power-allocated channel, decode, hard-decide, report
    section/frame error rates and NMSE.  Runs on the card unless
    ``device`` says otherwise.
    """
    trial = _build_trial(cfg, ebn0_db, power_allocation, seed,
                         resolve_device(device))
    return _eval_trial(_decode(algo, trial, cfg, estimate_phi), trial.msg,
                       cfg, trial.snr, trial.rate)


def compare_single_trial(cfg: Config, ebn0_db: float,
                         power_allocation: Optional[np.ndarray] = None,
                         estimate_phi: bool = False, seed: int = 0,
                         device=None) -> dict:
    """Decode the SAME (message, channel, noise) draw with SCAMP and BAMP
    and report both — the reference twin's head-to-head comparison
    (`sparc.py:453-474`, SPARC2.run prints SCAMP and BAMP error rates for
    one shared draw)."""
    trial = _build_trial(cfg, ebn0_db, power_allocation, seed,
                         resolve_device(device))
    return {algo: _eval_trial(_decode(algo, trial, cfg, estimate_phi),
                              trial.msg, cfg, trial.snr, trial.rate)
            for algo in ("scamp", "bamp")}
