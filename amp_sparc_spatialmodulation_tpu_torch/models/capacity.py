"""Monte-Carlo channel capacity and constrained mutual information.

Port of the JAX package's ``models/capacity.py`` (reference
``capacity.py``): per channel realization, the squared singular values of
``H`` feed a water-filling power allocation (`capacity.py:58-99`) and a
constellation-constrained mutual information by 2-D numerical integration
over the complex output grid (`capacity.py:101-137`); results (Cawgn /
Cwf / Cfs / Mi per Eb/N0) are exported as CSV (`capacity.py:54-55`).

On the device, per chunk of epochs: the dense channels, their Gram on
the short side in FP32 (PyTorch keeps TF32 off for matmul by default, and
the port never turns it on), ``torch.linalg.eigvalsh`` clipped at 0
(:func:`gram_eigvalsh`), and the constellation MI as one broadcast
float32 function over (epochs x grid^2 x gains x symbols)
(:func:`mutual_information`).  The JAX package computes these in
XLA, outside any Pallas kernel, so library calls and plain torch are the
port's counterparts.  The water-filling loop, the host MI routine and
the CSV stay float64 NumPy on the host, as in the JAX package.

Epoch ``e`` of point ``j`` draws its channel from ``make_generator(
device, seed, j, e)``, so the results do not depend on the chunk size.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..ops import channel as channel_ops
from ..utils.device import make_generator, resolve_device

# Epochs per chunk: as many as keep the (chunk, N^2, n, K+1) MI tensor
# near this many bytes (`capacity.py:118-122` there).
MI_CHUNK_BYTES = 2e8


def gram_eigvalsh(H: torch.Tensor) -> torch.Tensor:
    """Squared singular values of each ``H`` of a (E, n, N) batch, (E,
    min(n, N)) float32: ``eigvalsh`` of the Hermitian Gram on the short
    side, clipped at 0 (`capacity.py:39-53` there)."""
    Hc = H.conj().transpose(-2, -1)
    G = H @ Hc if H.shape[-2] <= H.shape[-1] else Hc @ H
    return torch.linalg.eigvalsh(G).clamp_min(0.0)


def input_distribution(cfg: Config):
    """The MI's input alphabet ``{symbols} U {0}``, its pmf (per-symbol
    activity ``Ps``, `capacity.py:106-108`), power and peak magnitude."""
    x = np.append(np.asarray(cfg.symbols), 0.0)
    pmf_x = np.full(len(x), cfg.Ps, np.float64)
    pmf_x[-1] = 1.0 - cfg.Ps * (len(x) - 1)
    Px = float(np.sum(np.abs(x) ** 2 * pmf_x))
    return x, pmf_x, Px, float(np.max(np.abs(x)))


def mutual_information(cfg: Config, g: torch.Tensor, snr: float,
                       grid_points: int) -> torch.Tensor:
    """Constellation MI summed over the eigen-channels, ``(E, n)`` gains
    -> ``(E,)`` float32, on ``g``'s device.

    The device form of :meth:`InfoTheory._mutual_information` (the JAX
    package's ``_mi_device_fn``, `capacity.py:57-96` there): the same
    input pmf and output grid (which depends only on the SNR), every
    gain and epoch in one broadcast; ``|y - sqrt(g) x|^2`` is formed from
    real parts, so no complex temporary is made.
    """
    x, pmf_x, Px, xmax = input_distribution(cfg)
    dev, f32 = g.device, torch.float32
    xr = torch.as_tensor(x.real, dtype=f32, device=dev)
    xi = torch.as_tensor(x.imag, dtype=f32, device=dev)
    pmf = torch.as_tensor(pmf_x, dtype=f32, device=dev)
    sigma2 = torch.tensor(Px, dtype=f32) / torch.tensor(snr, dtype=f32)
    ymax = xmax + 10.0 * torch.sqrt(sigma2)
    ygrid = torch.linspace(-float(ymax), float(ymax), grid_points,
                           dtype=f32, device=dev)
    yr = ygrid[None, :].expand(grid_points, -1).reshape(-1)
    yi = ygrid[:, None].expand(-1, grid_points).reshape(-1)
    sg = torch.sqrt(g.to(f32) / g.shape[-1])[:, None, :, None]   # (E,1,n,1)
    d2 = ((yr[None, :, None, None] - sg * xr)
          .square_()
          .add_((yi[None, :, None, None] - sg * xi).square_()))
    tmp = d2.mul_(-1.0 / float(sigma2)).exp_()              # (E, N^2, n, K+1)
    pmf_y_x = tmp.div_(tmp.sum(1, keepdim=True).clamp_min(1e-30))
    pmf_y = pmf_y_x @ pmf                                   # (E, N^2, n)
    log_y = torch.where(pmf_y > 0, torch.log2(pmf_y.clamp_min(1e-30)), 0.0)
    log_yx = torch.where(pmf_y_x > 0, torch.log2(pmf_y_x.clamp_min(1e-30)),
                         0.0)
    terms = log_yx.sub_(log_y[..., None]).mul_(pmf_y_x).mul_(pmf)
    return terms.reshape(g.shape[0], -1).sum(-1)


class InfoTheory:
    """Capacity driver (`capacity.py:13-56`).  Runs on the card unless
    ``device`` says otherwise."""

    def __init__(self, cfg: Config, out_root: str = "Simulations",
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.seed = seed
        self.path = os.path.join(out_root, "Capacity", cfg.name)
        os.makedirs(self.path, exist_ok=True)

    def _gains(self, point: int, e0: int, n_e: int) -> torch.Tensor:
        """(n_e, n) squared singular values of the channels of epochs
        ``e0 .. e0 + n_e - 1`` of point ``point``."""
        H = torch.stack([channel_ops.generate_channel(
            make_generator(self.device, self.seed, point, e), self.cfg)
            for e in range(e0, e0 + n_e)])
        return gram_eigvalsh(H)

    def chunk(self, epochs: int, grid_points: int) -> int:
        """Epochs per device call (`capacity.py:118-122` there)."""
        cfg = self.cfg
        n_sv = min(cfg.Nr * cfg.Lout, cfg.Nt * cfg.Lin)
        per_epoch = grid_points ** 2 * n_sv * (cfg.K + 1) * 4
        return max(1, min(epochs, int(MI_CHUNK_BYTES // max(per_epoch, 1))
                          or 1))

    def simulate(self, epochs: int = 1000, final: Optional[float] = None,
                 start: Optional[float] = None, step: float = 1.0,
                 grid_points: int = 100, progress=print) -> np.ndarray:
        cfg = self.cfg
        if start is None:
            start = int(np.ceil(cfg.shannon_limit_dB))
        if final is None:
            final = start + 10.0
        ebn0_range = np.arange(start, final + step, step)
        snr_range = ebn0_range + 10 * np.log10(cfg.code_rate)
        # An overridden _mutual_information (subclass hook or instance-level
        # test double) takes precedence over the batched device function —
        # that function is an optimization of the method, not a
        # replacement for its contract.
        mi_override = (
            "_mutual_information" in self.__dict__
            or type(self)._mutual_information
            is not InfoTheory._mutual_information)
        chunk = self.chunk(epochs, grid_points)
        rows = []
        for j, (snr_db, ebn0) in enumerate(zip(snr_range, ebn0_range)):
            snr = 10 ** (snr_db / 10)
            sigma2 = 1.0 / snr
            c_awgn = float(np.log2(1 + snr))
            c_wf, c_fs, mi_best = 0.0, 0.0, 0.0
            for e0 in range(0, epochs, chunk):
                n_e = min(chunk, epochs - e0)
                g_batch = self._gains(j, e0, n_e)             # (n_e, n_sv)
                if mi_override:
                    mi_batch = np.asarray(
                        [self._mutual_information(g, snr, N=grid_points)
                         for g in g_batch.cpu().numpy()])
                else:
                    mi_batch = mutual_information(
                        cfg, g_batch, float(np.float32(snr)),
                        grid_points).cpu().numpy()            # (n_e,)
                g_host = np.sort(g_batch.cpu().numpy(), axis=1)[:, ::-1]
                for g in g_host:
                    p_wf = self._water_filling(g, sigma2)
                    c_wf = max(c_wf, float(np.sum(np.log2(
                        1 + g * p_wf / sigma2))))
                mi_best = max(mi_best, float(mi_batch.max()))
            rows.append([ebn0, snr_db, c_awgn, c_fs, c_wf, mi_best])
            progress(f"EbN0dB={ebn0} Cawgn={c_awgn:.3f} Cwf={c_wf:.3f} "
                     f"Mi={mi_best:.3f}")
        out = np.asarray(rows)
        self._export_csv(out)
        return out[:, 2:]

    def csv_path(self) -> str:
        cfg = self.cfg
        name = f"({cfg.Nt}, {cfg.Na}, {cfg.Nr}, {cfg.Lh})"
        return os.path.join(self.path, f"{name}.csv")

    def _export_csv(self, rows: np.ndarray) -> None:
        """CSV with the reference's columns (`capacity.py:54-55`)."""
        header = ",EbN0dB,SNRdB,Cawgn,Cfs,Cwf,Mi"
        with open(self.csv_path(), "w") as f:
            f.write(header + "\n")
            for i, r in enumerate(rows):
                f.write(",".join([str(i)] + [repr(float(v)) for v in
                                             [r[0], r[1], r[2], r[3], r[4],
                                              r[5]]]) + "\n")

    def _water_filling(self, gain: np.ndarray, sigma2: float,
                       power: float = 1.0) -> np.ndarray:
        """Water-filling power allocation (`capacity.py:58-99`).

        ``gain`` must be sorted descending; returns the per-mode powers in
        the original order.
        """
        cfg = self.cfg
        gain = gain * cfg.Nr / cfg.Nt
        n = len(gain)
        removed = 0
        min_mu = sigma2 / gain[n - removed - 1]
        ps = min_mu - sigma2 / gain[:n - removed]
        while np.sum(ps) > power and removed < n - 1:
            removed += 1
            min_mu = sigma2 / gain[n - removed - 1]
            ps = min_mu - sigma2 / gain[:n - removed]
        pdiff = power - np.sum(ps)
        paux = pdiff / (n - removed) + ps
        palloc = np.zeros(n)
        palloc[:n - removed] = paux
        return palloc

    def _mutual_information(self, gain: np.ndarray, snr: float,
                            N: int = 100) -> float:
        """Constellation-constrained MI summed over the eigen-channels
        (`capacity.py:101-137`), vectorized over the output grid, float64
        on the host.

        The input distribution is {0} U symbols with per-symbol activity
        ``Ps`` (`capacity.py:106-108`).
        """
        gain = np.asarray(gain, float) / len(gain)
        x, pmf_x, Px, xmax = input_distribution(self.cfg)
        sigma2 = Px / snr
        ymax = xmax + 10 * np.sqrt(sigma2)
        ygrid = np.linspace(-ymax, ymax, N)
        yr, yi = np.meshgrid(ygrid, ygrid)
        y = (yr + 1j * yi).ravel()
        mi = 0.0
        for g in gain:
            d2 = np.abs(y[:, None] - np.sqrt(g) * x[None, :]) ** 2
            tmp = np.exp(-d2 / sigma2)
            pmf_y_x = tmp / np.maximum(tmp.sum(0, keepdims=True), 1e-300)
            pmf_y = pmf_y_x @ pmf_x
            with np.errstate(divide="ignore", invalid="ignore"):
                log_yx = np.where(pmf_y_x > 0,
                                  np.log2(np.maximum(pmf_y_x, 1e-300)), 0.0)
                log_y = np.where(pmf_y > 0,
                                 np.log2(np.maximum(pmf_y, 1e-300)), 0.0)
            mi += float(np.sum(pmf_y_x * (log_yx - log_y[:, None])
                               * pmf_x[None, :]))
        return mi
