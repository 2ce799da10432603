"""Mean-T parity of the port against the JAX package at the flagship point.

Per-trial T of a converging BAMP decode depends on the last bits of its
products, so two correct implementations disagree on a few percent of the
trials (a trial may stop an iteration apart, or run to the cap where the
other stops).  This script asks whether those disagreements are biased:
the same realizations (``flagship_bamp_ook()``, Eb/N0 = 8 dB), drawn by
the JAX package and carried over through NumPy, are decoded by

* the JAX package's XLA decode on the CPU,
* the port's plain version on the CPU, and
* the port's CUDA kernel on the card,

and the mean of the per-trial T differences is printed with its standard
error.  Two steps, since the machine with the card has no JAX:

    env JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_parity_flagship.py \\
        dump --out build/parity --trials 512 --seeds 10:26
    env PYTHONPATH=. python tests/torch_parity_flagship.py check \\
        --dir build/parity

``dump`` writes one ``.npz`` per seed (taps, gains, y, sigma2 and both
CPU decodes' T) and prints the JAX-against-port-CPU summary; ``check``
loads them, decodes on ``cuda`` (it imports no JAX) and prints one JSON
line comparing the kernel's T with both CPU decodes.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

EBN0_DB = 8.0


def summary(a: np.ndarray, b: np.ndarray, cap: int) -> dict:
    """Per-trial T of ``b`` against ``a``: agreement, mean difference and
    its standard error, and how many trials each ran to the cap."""
    d = b.astype(np.float64) - a
    return {"trials": int(a.size), "T_agree_fraction": float((a == b).mean()),
            "mean_T_a": float(a.mean()), "mean_T_b": float(b.mean()),
            "dmean_T": float(d.mean()),
            "dmean_T_stderr": float(d.std(ddof=1) / np.sqrt(d.size)),
            "at_cap_a": int((a == cap).sum()), "at_cap_b": int((b == cap).sum())}


def dump(out: Path, trials: int, seeds: range) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch

    from amp_sparc_spatialmodulation_tpu.config import (
        flagship_bamp_ook as jflagship)
    from amp_sparc_spatialmodulation_tpu.models import bamp as jbamp
    from amp_sparc_spatialmodulation_tpu.ops import channel as jchannel
    from amp_sparc_spatialmodulation_tpu.ops import message as jmessage
    from amp_sparc_spatialmodulation_tpu.ops import operators as joperators
    from amp_sparc_spatialmodulation_tpu_torch import interop
    from amp_sparc_spatialmodulation_tpu_torch.config import flagship_bamp_ook
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp

    jcfg, cfg = jflagship(), flagship_bamp_ook()
    snr = 10 ** ((EBN0_DB + 10 * np.log10(cfg.code_rate)) / 10)
    out.mkdir(parents=True, exist_ok=True)
    jT_all, pT_all = [], []
    for seed in seeds:
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
        _, jop = joperators.banded_sparc(k1, jcfg)
        msg = jmessage.generate_message(k2, jcfg, trials)
        jy = jop.apply(msg.x) + jchannel.awgn(k3, jcfg, snr, trials)
        sigma2 = float(np.float32(jcfg.sigma2(snr)))
        jT = np.asarray(jbamp.decode(jop, jy, sigma2, jcfg).T)
        h, gains, y = np.asarray(jop.h), np.asarray(jop.gains), np.array(jy)
        op = interop.operator_from_numpy(h, gains, cfg.Lin, cfg.Lout,
                                         cfg.trunc, device="cpu")
        pT = bamp.decode(op, torch.as_tensor(y), sigma2, cfg).T.numpy()
        np.savez(out / f"seed{seed}.npz", h=h, gains=gains, y=y,
                 sigma2=sigma2, T_jax=jT, T_port_cpu=pT)
        jT_all.append(jT)
        pT_all.append(pT)
    print(json.dumps({"jax_cpu_vs_port_cpu": summary(
        np.concatenate(jT_all), np.concatenate(pT_all), cfg.N_Layers)}))


def check(directory: Path) -> None:
    import torch

    from amp_sparc_spatialmodulation_tpu_torch import interop
    from amp_sparc_spatialmodulation_tpu_torch.config import flagship_bamp_ook
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = flagship_bamp_ook()
    files = sorted(directory.glob("seed*.npz"))
    if not files:
        raise SystemExit(f"no seed*.npz under {directory}")
    jT, cT, kT = [], [], []
    before = fused_bamp.launches
    for f in files:
        d = np.load(f)
        op = interop.operator_from_numpy(d["h"], d["gains"], cfg.Lin,
                                         cfg.Lout, cfg.trunc, device="cuda")
        y = torch.as_tensor(d["y"], device="cuda")
        kT.append(bamp.decode(op, y, float(d["sigma2"]), cfg).T.cpu().numpy())
        jT.append(d["T_jax"])
        cT.append(d["T_port_cpu"])
    if fused_bamp.launches - before != len(files):
        raise AssertionError("the card's decodes did not run the kernel")
    jT, cT, kT = map(np.concatenate, (jT, cT, kT))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "realizations": len(files),
        "jax_cpu_vs_port_cpu": summary(jT, cT, cfg.N_Layers),
        "jax_cpu_vs_port_kernel": summary(jT, kT, cfg.N_Layers),
        "port_cpu_vs_port_kernel": summary(cT, kT, cfg.N_Layers)}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("--out", type=Path, required=True)
    d.add_argument("--trials", type=int, default=512)
    d.add_argument("--seeds", default="10:26", help="first:last+1")
    c = sub.add_parser("check")
    c.add_argument("--dir", type=Path, required=True)
    args = ap.parse_args()
    if args.cmd == "dump":
        lo, hi = (int(v) for v in args.seeds.split(":"))
        dump(args.out, args.trials, range(lo, hi))
    else:
        check(args.dir)


if __name__ == "__main__":
    main()
