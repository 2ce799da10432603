"""Waterfall and iteration-count plots from per-SNR JSON artifacts.

Port of the JAX package's ``utils/plotting.py`` (the reference
``Plotter``, ``plotter.py``): loads every JSON in a config's artifact
dir (`plotter.py:23-28`), plots semilogy FER/SER/NMSE/BER vs Eb/N0 with
the Shannon-limit vline (`plotter.py:30-50`), and mean AMP iterations vs
Eb/N0 (`plotter.py:52-65`); PNGs are saved next to the JSONs with the
reference's file-name pattern.  matplotlib is imported only when a
plot is drawn, with the Agg backend.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..config import Config
from . import artifacts


class Plotter:
    """Rebuilds plots from whatever artifact JSONs exist."""

    def __init__(self, cfg: Config, algo_dir: str,
                 out_root: str = "Simulations"):
        self.cfg = cfg
        self.dir = os.path.join(out_root, algo_dir, cfg.name)
        self.name = (f"{cfg.alphabet},Nt={cfg.Nt},Na={cfg.Na},Nr={cfg.Nr},"
                     f"Lh={cfg.Lh},{cfg.trunc},{cfg.mode},{cfg.profile}")
        self.points = artifacts.load_points(self.dir)
        if not self.points:
            raise FileNotFoundError(f"no artifact JSONs under {self.dir}")

    def _series(self, key: str):
        ebn0 = np.array(sorted(self.points))
        vals = np.array([self.points[e].get(key, np.nan) for e in ebn0])
        return ebn0, vals

    @property
    def shannon_limit(self) -> float:
        first = next(iter(self.points.values()))
        return first.get("ShannonLimitdB", self.cfg.shannon_limit_dB)

    def plot_metrics(self, save: Optional[str] = None) -> str:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        ebn0, fer = self._series("fer")
        _, ver = self._series("ver")
        _, nmse = self._series("nMSE")
        _, ber = self._series("ber")
        plt.figure(figsize=(8, 6))
        plt.semilogy(ebn0, np.maximum(fer, 1e-12), label="FER", color="blue")
        plt.semilogy(ebn0, np.maximum(ver, 1e-12), label="SER",
                     color="orange")
        plt.semilogy(ebn0, np.maximum(nmse, 1e-12), label="NMSE",
                     color="red")
        plt.semilogy(ebn0, np.maximum(ber, 1e-12), label="BER",
                     color="green")
        plt.axvline(x=self.shannon_limit, color="black",
                    label="Shannon Limit")
        plt.xlabel("$E_b/N_0$ (dB)")
        plt.ylabel("error rate")
        plt.legend()
        plt.grid(True)
        path = save or os.path.join(self.dir, f"{self.name}_plot.png")
        plt.savefig(path)
        plt.close()
        return path

    def plot_iter(self, save: Optional[str] = None) -> str:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        ebn0, iters = self._series("T")
        plt.figure(figsize=(8, 6))
        plt.plot(ebn0, iters, color="blue")
        plt.axvline(x=self.shannon_limit, color="black",
                    label="Shannon Limit")
        plt.xlabel("$E_b/N_0$ (dB)")
        plt.ylabel("Iterations")
        plt.legend()
        plt.grid(True)
        path = save or os.path.join(self.dir, f"{self.name}_iter_plot.png")
        plt.savefig(path)
        plt.close()
        return path

    def get_metrics(self) -> Dict[str, np.ndarray]:
        """All 18 series keyed by metric (`plotter.py:67-118`)."""
        out = {}
        for key in ("EbN0dB", "SNRdB", "C", "T", "fer", "ver", "verf",
                    "verm", "verL", "ber", "ier", "ser", "iber", "sber",
                    "nMSE", "nMSEf", "nMSEm", "nMSEL"):
            out[key] = self._series(key)[1]
        out["ShannonLimit"] = self.shannon_limit
        return out
