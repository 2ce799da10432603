"""Per-SNR JSON artifact store + sweep manifest.

Parity with the reference's artifact contract: one JSON per (config, Eb/N0)
point at ``<root>/<ALGO>/<alphabet>,<mode>/<profile>,<trunc>/<dims>/<EbN0>.json``
holding the 14 metrics + mean iteration count ``T`` + the operating-point
footer ``EbN0dB, SNRdB, rate, C, ShannonLimitdB`` (``Loss.export``,
reference ``loss.py:304-323``).  Plots are rebuilt from whatever
JSONs exist, so a crashed sweep keeps its completed points — the
reference's implicit checkpointing (`plotter.py:24-28`).

Added beyond the reference: an explicit ``manifest.json`` per config dir
recording completed points and sample counts, enabling sweep resume.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from ..config import Config
from .metrics import METRIC_KEYS


def point_path(config_dir: str, ebn0_db: float) -> str:
    return os.path.join(config_dir, f"{float(ebn0_db)}.json")


def export_point(config_dir: str, ebn0_db: float, snr_db: float,
                 cfg: Config, averages: Dict[str, float],
                 extra: Dict[str, float] | None = None) -> str:
    """Write one per-SNR JSON with the reference schema (`loss.py:304-323`)."""
    os.makedirs(config_dir, exist_ok=True)
    payload = {"T": float(averages["T"])}
    for k in METRIC_KEYS:
        payload[k] = float(averages[k])
    payload["EbN0dB"] = float(ebn0_db)
    payload["SNRdB"] = float(snr_db)
    payload["rate"] = float(cfg.code_rate)
    payload["C"] = float(np.log2(1 + 10 ** (snr_db / 10)))
    payload["ShannonLimitdB"] = float(cfg.shannon_limit_dB)
    if extra:
        payload.update({k: float(v) for k, v in extra.items()})
    path = point_path(config_dir, ebn0_db)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, ensure_ascii=False, indent=6)
    return path


def load_points(config_dir: str) -> Dict[float, Dict[str, float]]:
    """Load every per-SNR JSON in a config dir (`plotter.py:23-28`)."""
    points = {}
    if not os.path.isdir(config_dir):
        return points
    for name in sorted(os.listdir(config_dir)):
        if name.endswith(".json") and name != "manifest.json":
            with open(os.path.join(config_dir, name), "r") as f:
                data = json.load(f)
            if "EbN0dB" in data:
                points[float(data["EbN0dB"])] = data
    return points


def _manifest_path(config_dir: str) -> str:
    return os.path.join(config_dir, "manifest.json")


def load_manifest(config_dir: str) -> Dict:
    path = _manifest_path(config_dir)
    if os.path.exists(path):
        with open(path, "r") as f:
            return json.load(f)
    return {"points": {}}


def update_manifest(config_dir: str, ebn0_db: float, trials: int,
                    seed: int) -> None:
    os.makedirs(config_dir, exist_ok=True)
    m = load_manifest(config_dir)
    m["points"][str(float(ebn0_db))] = {"trials": trials, "seed": seed}
    with open(_manifest_path(config_dir), "w") as f:
        json.dump(m, f, indent=2)
