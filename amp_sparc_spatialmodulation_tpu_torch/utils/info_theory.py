"""Information-theory primitives.

Port of the JAX package's ``utils/info_theory.py`` (reference
``info_theory.py``, routines by Volker Kuehn): mutual information of a DMC
(`info_theory.py:21-47`), discrete-input AWGN MI by numerical integration,
real/complex aware (`info_theory.py:51-201`), and the J-function-style LLR
MI <-> variance conversion (`info_theory.py:205-258`).

These are analysis utilities, not decode-path code: as in the JAX package
they run on the host in float64 NumPy, vectorized over the output grid,
so the port keeps its own copy of the same functions.
"""
from __future__ import annotations

import numpy as np


def mi_dmc(pmf_x: np.ndarray, pmf_y_x: np.ndarray) -> float:
    """Mutual information of a discrete memoryless channel
    (`info_theory.py:21-47`).

    Args:
        pmf_x: (X,) input distribution.
        pmf_y_x: (Y, X) likelihoods (columns: inputs).
    """
    pmf_x = np.asarray(pmf_x, float).ravel()
    pmf_y_x = np.asarray(pmf_y_x, float)
    pmf_y = pmf_y_x @ pmf_x
    with np.errstate(divide="ignore", invalid="ignore"):
        log_ratio = np.where(pmf_y_x > 0,
                             np.log2(np.maximum(pmf_y_x, 1e-300))
                             - np.log2(np.maximum(pmf_y[:, None], 1e-300)),
                             0.0)
    return float(np.sum(pmf_y_x * pmf_x[None, :] * log_ratio))


def _integration_grid(x: np.ndarray, sigma: float, N: int) -> np.ndarray:
    """Output-space grid: complex N^2 mesh or real N points
    (`info_theory.py:99-107`)."""
    xmax = np.max(np.abs(x))
    ymax = xmax + 10.0 * sigma
    ygrid = np.linspace(-ymax, ymax, N)
    if np.iscomplexobj(x):
        yr, yi = np.meshgrid(ygrid, ygrid)
        return (yr + 1j * yi).ravel()
    return ygrid


def _mi_single(x: np.ndarray, pmf_x: np.ndarray, sigma2: float,
               N: int, gain: float = 1.0) -> float:
    """MI of one discrete-input AWGN channel by numerical integration
    (`info_theory.py:110-131`)."""
    y = _integration_grid(x, np.sqrt(sigma2), N)
    d2 = np.abs(y[:, None] - np.sqrt(gain) * x[None, :]) ** 2
    tmp = np.exp(-d2 / sigma2)
    pmf_y_x = tmp / np.maximum(tmp.sum(axis=0, keepdims=True), 1e-300)
    pmf_y = pmf_y_x @ pmf_x
    with np.errstate(divide="ignore", invalid="ignore"):
        log_yx = np.where(pmf_y_x > 0, np.log2(np.maximum(pmf_y_x, 1e-300)),
                          0.0)
        log_y = np.where(pmf_y > 0, np.log2(np.maximum(pmf_y, 1e-300)), 0.0)
    return float(np.sum(pmf_y_x * (log_yx - log_y[:, None]) * pmf_x[None, :]))


def mi_awgn(x, pmf_x, snrdB=None, noise_var=None, N: int = 1000) -> np.ndarray:
    """MI of a discrete-input AWGN channel over a grid of SNRs / variances
    (`info_theory.py:51-135`).

    Real alphabets double the variance in the exponent, matching the
    reference convention (`info_theory.py:88-91`).
    """
    x = np.asarray(x)
    pmf_x = np.asarray(pmf_x, float)
    if noise_var is not None:
        sigma2 = np.atleast_1d(np.asarray(noise_var, float))
    elif snrdB is not None:
        Px = np.sum(np.abs(x) ** 2 * pmf_x)
        sigma2 = Px / 10 ** (np.atleast_1d(np.asarray(snrdB, float)) / 10)
    else:
        raise ValueError("either snrdB or noise_var must be given")
    if np.isrealobj(x):
        sigma2 = sigma2 * 2.0
    return np.array([_mi_single(x, pmf_x, s2, N) for s2 in sigma2])


def mi_awgn2(x, pmf_x, noise_var, N: int = 1000) -> np.ndarray:
    """Variance-parameterized twin of :func:`mi_awgn`
    (`info_theory.py:138-201`)."""
    return mi_awgn(x, pmf_x, noise_var=noise_var, N=N)


def calc_mi(inputs, mode: str, N_samples: int = 1000,
            var_max: float = 50.0) -> np.ndarray:
    """LLR-Gaussian MI <-> variance conversion (`info_theory.py:205-258`).

    mode='MI': inputs are LLR variances, returns mutual informations.
    mode='VAR': inputs are MIs, returns variances (by interpolation).
    """
    inputs = np.atleast_1d(np.asarray(inputs, float))

    def _mi_of_var(var):
        if var <= 0:
            return 0.0
        sigma = np.sqrt(var)
        delta = 10.0 * sigma / N_samples
        xs = np.arange(-5.0 * sigma, 5.0 * sigma, delta)
        val = np.sum(np.exp(-(xs - var / 2.0) ** 2 / (2.0 * var))
                     * np.log2(1.0 + np.exp(-xs)))
        return 1.0 - val / np.sqrt(2.0 * np.pi * var) * delta

    if mode == "MI":
        return np.array([_mi_of_var(v) for v in inputs])
    if mode == "VAR":
        sigma2 = np.arange(0.01, var_max)
        Ia = np.array([_mi_of_var(v) for v in sigma2])
        Ia[0] = 0.0
        return np.interp(inputs, Ia, sigma2)
    raise ValueError("mode must be 'MI' or 'VAR'")
