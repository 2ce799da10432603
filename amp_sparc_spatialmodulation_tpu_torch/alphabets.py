"""Modulation alphabets and Gray maps.

Reproduces the symbol tables of the reference simulator
(reference ``config.py:78-117``), including its unit-average-power
normalization ``s / sqrt(mean(|s|^2))`` and the published Gray maps.

Note: the reference 16QAM table (`config.py:112`) contains ``-1+3j`` twice
(15 unique symbols).  We reproduce that behavior by default for statistical
parity; pass ``fix_16qam=True`` to :func:`get_alphabet` for the corrected
16-point table.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

ALPHABET_NAMES = ("OOK", "BPSK", "4ASK", "QPSK", "8PSK", "16PSK", "16QAM")


@dataclasses.dataclass(frozen=True)
class Alphabet:
    """A normalized modulation alphabet.

    Attributes:
        name: alphabet name, one of :data:`ALPHABET_NAMES`.
        symbols: tuple of complex symbols, normalized to unit average power.
        gray: tuple of Gray-code labels, one per symbol.
        modulated: False only for OOK (index modulation only).
        forces_complex: True when the alphabet requires a complex channel.
    """

    name: str
    symbols: Tuple[complex, ...]
    gray: Tuple[int, ...]
    modulated: bool = True
    forces_complex: bool = False

    @property
    def K(self) -> int:
        return len(self.symbols)

    @property
    def symbol_bits(self) -> int:
        return int(np.log2(self.K))

    def symbol_array(self, dtype=np.complex64) -> np.ndarray:
        return np.asarray(self.symbols, dtype=dtype)

    def gray_array(self) -> np.ndarray:
        return np.asarray(self.gray, dtype=np.int32)


def _normalize(symbols) -> Tuple[complex, ...]:
    s = np.asarray(symbols, dtype=np.complex128)
    s = s / np.sqrt(np.mean(np.abs(s) ** 2))
    return tuple(complex(v) for v in s)


def _psk(n: int) -> list:
    return [np.exp((2j * np.pi / n) * k) for k in range(n)]


_RAW_TABLES = {
    "OOK": dict(symbols=[1], gray=[1], modulated=False, forces_complex=False),
    "BPSK": dict(symbols=[-1, 1], gray=[0, 1], forces_complex=False),
    "4ASK": dict(symbols=[-3, -1, 1, 3], gray=[0, 1, 3, 2], forces_complex=False),
    "QPSK": dict(symbols=[1 + 0j, 0 + 1j, -1 + 0j, 0 - 1j], gray=[0, 1, 3, 2],
                 forces_complex=True),
    "8PSK": dict(symbols=_psk(8), gray=[0, 1, 3, 2, 6, 7, 5, 4],
                 forces_complex=True),
    "16PSK": dict(symbols=_psk(16),
                  gray=[0, 1, 3, 2, 6, 7, 5, 4, 12, 13, 15, 14, 10, 11, 9, 8],
                  forces_complex=True),
    # Reference table: `-1+3j` appears twice (positions 13 and 14) and the
    # constellation point `1-3j` is missing; `fix_16qam` restores it.
    "16QAM": dict(symbols=[1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j, 3 + 1j, 3 - 1j,
                           -3 + 1j, -3 - 1j, 3 + 3j, 3 - 3j, -3 + 3j, -3 - 3j,
                           1 + 3j, -1 + 3j, -1 + 3j, -1 - 3j],
                  gray=[0, 1, 13, 7, 8, 9, 2, 15, 12, 11, 5, 10, 14, 3, 6, 4],
                  forces_complex=True),
}

_FIXED_16QAM = [1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j, 3 + 1j, 3 - 1j,
                -3 + 1j, -3 - 1j, 3 + 3j, 3 - 3j, -3 + 3j, -3 - 3j,
                1 + 3j, 1 - 3j, -1 + 3j, -1 - 3j]


def get_alphabet(name: str, fix_16qam: bool = False) -> Alphabet:
    """Build a normalized :class:`Alphabet` by name."""
    if name not in _RAW_TABLES:
        raise ValueError(
            f"alphabet must be one of {ALPHABET_NAMES}, got {name!r}")
    raw = dict(_RAW_TABLES[name])
    if name == "16QAM" and fix_16qam:
        raw["symbols"] = _FIXED_16QAM
    return Alphabet(
        name=name,
        symbols=_normalize(raw["symbols"]),
        gray=tuple(raw["gray"]),
        modulated=raw.get("modulated", True),
        forces_complex=raw.get("forces_complex", False),
    )
