"""System configuration with derived parameters.

This is the single source of truth for every dimension and constant in the
framework, mirroring the derived-parameter math of the reference simulator's
``Config`` (reference ``config.py:4-157``): sparsity, output block
length under the three channel truncation modes, per-alphabet activity
priors, information bits / code rate per generator mode, SPARC shape
parameters, and the Shannon-limit operating point.

A NumPy-only copy of the JAX package's ``config.py``: the PyTorch port
keeps its own, so it never imports the JAX package.  The config is a
frozen, hashable dataclass; the decoders and the CUDA kernel wrapper read
their shapes and constants from it.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

from .alphabets import ALPHABET_NAMES, Alphabet, get_alphabet

MODES = ("random", "segmented", "sparc")
PROFILES = ("exponential", "uniform")
TRUNCATIONS = ("trunc", "tail", "cyclic")


@dataclasses.dataclass(frozen=True)
class Config:
    """Simulation configuration.

    Args mirror the reference ``Config.__init__`` (`config.py:5-19`), with
    ``device`` dropped: placement is an argument of the port's entry points.
    """

    Nt: int                       # transmit antennas
    Na: int                       # active antennas per channel use
    Nr: int                       # receive antennas
    Lin: int                      # block length (channel uses per frame)
    Lh: int                       # channel taps
    B: int = 100                  # trials decoded per batched call
    mode: str = "random"          # generator mode
    iterations: int = 20          # AMP iteration cap (N_Layers)
    alphabet: str = "OOK"
    profile: str = "exponential"  # power-delay profile
    trunc: str = "trunc"          # channel truncation: trunc | tail | cyclic
    is_complex: bool = True
    fix_16qam: bool = False       # repair the reference's duplicate 16QAM point

    def __post_init__(self):
        if self.profile not in PROFILES:
            raise ValueError(f"profile must be one of {PROFILES}")
        if self.trunc not in TRUNCATIONS:
            raise ValueError(f"trunc must be one of {TRUNCATIONS}")
        if self.Lh < 1:
            raise ValueError("Lh (channel_length) must be at least 1")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}")
        if self.alphabet not in ALPHABET_NAMES:
            raise ValueError(f"alphabet must be one of {ALPHABET_NAMES}")
        if self.mode in ("segmented", "sparc") and self.Nt % self.Na != 0:
            raise ValueError("Na must divide Nt in segmented/sparc mode")
        alpha = get_alphabet(self.alphabet, self.fix_16qam)
        if alpha.forces_complex and not self.is_complex:
            object.__setattr__(self, "is_complex", True)

    # ----- architecture ---------------------------------------------------

    @property
    def sparsity(self) -> float:
        return self.Na / self.Nt

    @property
    def Lout(self) -> int:
        """Output block length; `config.py:60-63`."""
        return self.Lin + self.Lh - 1 if self.trunc == "tail" else self.Lin

    @property
    def ISI(self) -> bool:
        return self.Lh > 1

    @property
    def N(self) -> int:
        """Columns of the measurement operator: Nt * Lin."""
        return self.Nt * self.Lin

    @property
    def n(self) -> int:
        """Rows of the measurement operator: Nr * Lout (`config.py:140`)."""
        return self.Nr * self.Lout

    # ----- data generator -------------------------------------------------

    @property
    def Ns(self) -> int:
        """Number of transmitted symbols per batch; `config.py:71`."""
        return self.B * self.Lin * self.Na

    @property
    def N0(self) -> int:
        return self.B * self.Lin * (self.Nt - self.Na)

    @cached_property
    def alpha(self) -> Alphabet:
        return get_alphabet(self.alphabet, self.fix_16qam)

    @cached_property
    def symbols(self) -> np.ndarray:
        """Unit-power symbol table (`config.py:117`)."""
        return self.alpha.symbol_array()

    @cached_property
    def gray(self) -> np.ndarray:
        return self.alpha.gray_array()

    @property
    def K(self) -> int:
        return self.alpha.K

    @property
    def symbol_bits(self) -> int:
        return self.alpha.symbol_bits

    @property
    def modulated(self) -> bool:
        return self.alpha.modulated

    @property
    def Ps(self) -> float:
        """Per-symbol activity prior; `config.py:73,86-114`."""
        if self.alphabet == "OOK":
            return self.sparsity
        return self.sparsity / self.K

    @property
    def P0(self) -> float:
        """Inactivity prior — computed from raw sparsity (`config.py:74`)."""
        return 1.0 - self.sparsity

    # ----- segmented structure (used by denoisers & metrics) --------------

    @property
    def M(self) -> int:
        """Segment size Nt // Na (`config.py:134`)."""
        return self.Nt // self.Na

    @property
    def L(self) -> int:
        """Number of segments per frame, Na * Lin (`config.py:137`)."""
        return self.Na * self.Lin

    # ----- information rate -----------------------------------------------

    @property
    def index_bits(self) -> float:
        """`config.py:122,128,141`."""
        if self.mode == "random":
            return float(np.log2(np.prod(
                [1.0 + (self.Nt - self.Na) / j for j in range(1, self.Na + 1)])))
        return self.Na * float(np.log2(self.Nt / self.Na))

    @property
    def info_bits(self) -> float:
        return self.symbol_bits + self.index_bits

    @property
    def inner_code_rate(self) -> float:
        """SPARC inner code rate (`config.py:143`)."""
        return self.Na * float(np.log2(self.M * self.K)) / self.Mr

    @property
    def code_rate(self) -> float:
        """`config.py:124,130,144`."""
        if self.mode == "sparc":
            return self.Lc * self.inner_code_rate / self.Lr
        return self.Lin * self.info_bits / self.Nr / self.Lout

    # ----- SPARC shape params (`config.py:132-140`) -----------------------

    @property
    def Mc(self) -> int:
        return self.Nt

    @property
    def Mr(self) -> int:
        return self.Nr

    @property
    def Lc(self) -> int:
        return self.Lin

    @property
    def Lr(self) -> int:
        return self.Lout

    # ----- AMP / simulation constants (`config.py:146-154`) ---------------

    @property
    def N_Layers(self) -> int:
        return self.iterations

    @property
    def kappa(self) -> float:
        return self.Lout / self.Lin

    @property
    def min_amp_snr(self) -> float:
        return 1.0 / (self.kappa * (1.0 / (np.exp(2 * self.code_rate) - 1.0)
                                    - 1.0 / self.Lh))

    @property
    def min_snr(self) -> float:
        return 2.0 ** self.code_rate - 1.0

    @property
    def min_snr_dB(self) -> float:
        return 10.0 * float(np.log10(self.min_snr))

    @property
    def shannon_limit_dB(self) -> float:
        return self.min_snr_dB - 10.0 * float(np.log10(self.code_rate))

    @property
    def E(self) -> float:
        """Per-receive-antenna signal energy Na/Nr (`bamp.py:111`).

        The AWGN noise variance at SNR is ``sigma2 = E / SNR``
        (`channel.py:115`, `bamp.py:134`).
        """
        return self.Na / self.Nr

    def sigma2(self, snr: float) -> float:
        return self.E / snr

    # ----- artifact naming (`config.py:157`) ------------------------------

    @property
    def name(self) -> str:
        return (f"{self.alphabet},{self.mode}/{self.profile},{self.trunc}/"
                f"Nt={self.Nt},Na={self.Na},Nr={self.Nr},"
                f"Lh={self.Lh},Lin={self.Lin}")

    # ----- convenience ----------------------------------------------------

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def cdtype(self):
        return np.complex64 if self.is_complex else np.float32

    @property
    def pdp(self) -> np.ndarray:
        """Normalized power-delay profile (`channel.py:27-31`)."""
        if self.profile == "exponential":
            p = np.exp(-np.arange(self.Lh))
        else:
            p = np.ones(self.Lh)
        return (p / p.sum()).astype(np.float64)


# Flagship benchmark configs from the reference sweep scripts.

def flagship_bamp_ook() -> Config:
    """BAMPfinal OOK sweep config (`bamp_model.py:69-96`)."""
    return Config(Nt=128, Na=8, Nr=24, Lin=20, Lh=3, B=1, mode="segmented",
                  iterations=100, alphabet="OOK", profile="uniform",
                  trunc="tail")


def flagship_bamp_qpsk() -> Config:
    return Config(Nt=128, Na=16, Nr=32, Lin=25, Lh=6, B=1, mode="segmented",
                  iterations=100, alphabet="QPSK", profile="uniform",
                  trunc="tail")


def massive_mimo() -> Config:
    """Massive-MIMO BAMP config (`scamp_model.py:68-91`)."""
    return Config(Nt=1344, Na=84, Nr=73, Lin=32, Lh=6, B=1, mode="segmented",
                  iterations=100, alphabet="OOK", profile="uniform",
                  trunc="tail")


def flagship_scamp() -> Config:
    return Config(Nt=128, Na=16, Nr=16, Lin=40, Lh=9, B=1, mode="sparc",
                  iterations=100, alphabet="QPSK", profile="uniform",
                  trunc="tail")
