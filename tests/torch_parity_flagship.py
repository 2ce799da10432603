"""Mean-T parity of the port against the JAX package at a main point.

Per-trial T of a converging decode depends on the last bits of its
products, so two correct implementations disagree on a few percent of the
trials (a trial may stop an iteration apart, or run to the cap where the
other stops).  This script asks whether those disagreements are biased:
the same realizations, drawn by the JAX package and carried over through
NumPy, are decoded by

* the JAX package's XLA decode on the CPU,
* the port's plain version on the CPU, and
* the port's CUDA kernel on the card,

and the mean of the per-trial T differences is printed with its standard
error.  ``--algo bamp`` (the default) takes the flagship BAMP point
(``flagship_bamp_ook()``, Eb/N0 = 8 dB, kernel K1); ``--algo scamp`` the
SCAMP main point (the OOK sparc config at the same dimensions, Eb/N0 =
8 dB, kernel K2); ``--algo massive`` the massive-MIMO point
(``massive_mimo()`` at cap 300, Eb/N0 = 18 dB, kernel K5), where JAX
decodes in two phases (k1 = 40, as its ``Simulator`` does, so that a trial
that runs to the cap does not hold the whole batch) and the port's CPU
decode is skipped (only the kernel is compared with JAX).  Two steps, since
the machine with the card has no JAX:

    env JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_parity_flagship.py \\
        dump --out build/parity --trials 512 --seeds 10:26
    env PYTHONPATH=. python tests/torch_parity_flagship.py check \\
        --dir build/parity

``dump`` writes one ``.npz`` per seed (taps, gains, the base matrix for
SCAMP, y, sigma2 and both CPU decodes' T) and prints the
JAX-against-port-CPU summary; ``check`` loads them, decodes on ``cuda`` (it
imports no JAX) and prints one JSON line comparing the kernel's T with both
CPU decodes.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

EBN0_DB = {"bamp": 8.0, "scamp": 8.0, "massive": 18.0}
MASSIVE_CAP, MASSIVE_K1 = 300, 40


def summary(a: np.ndarray, b: np.ndarray, cap: int) -> dict:
    """Per-trial T of ``b`` against ``a``: agreement, mean difference and
    its standard error, and how many trials each ran to the cap."""
    d = b.astype(np.float64) - a
    return {"trials": int(a.size), "T_agree_fraction": float((a == b).mean()),
            "mean_T_a": float(a.mean()), "mean_T_b": float(b.mean()),
            "dmean_T": float(d.mean()),
            "dmean_T_stderr": float(d.std(ddof=1) / np.sqrt(d.size)),
            "at_cap_a": int((a == cap).sum()), "at_cap_b": int((b == cap).sum())}


# The SCAMP main point's config (chip_smoke.py's scamp_main_config).
SCAMP_MAIN = dict(Nt=128, Na=8, Nr=24, Lin=20, Lh=3, mode="sparc",
                  alphabet="OOK", profile="uniform", trunc="tail",
                  iterations=100)


def port_config(algo: str):
    import dataclasses

    from amp_sparc_spatialmodulation_tpu_torch.config import (
        Config, flagship_bamp_ook, massive_mimo)
    if algo == "massive":
        return dataclasses.replace(massive_mimo(), iterations=MASSIVE_CAP)
    return flagship_bamp_ook() if algo == "bamp" else Config(**SCAMP_MAIN)


def port_decode(algo: str, d, cfg, device):
    """The port's decode of one dumped realization ``d`` on ``device``."""
    import torch

    from amp_sparc_spatialmodulation_tpu_torch import interop
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, scamp
    op = interop.operator_from_numpy(d["h"], d["gains"], cfg.Lin, cfg.Lout,
                                     cfg.trunc, device=device)
    y = torch.as_tensor(d["y"], device=device)
    sigma2 = float(d["sigma2"])
    if algo == "scamp":
        W = torch.as_tensor(d["W"], device=device)
        return scamp.decode(W, op, y, sigma2, cfg).T.cpu().numpy()
    return bamp.decode(op, y, sigma2, cfg).T.cpu().numpy()


def jax_two_phase(jbamp, jop, jy, sigma2, jcfg):
    """T of the JAX XLA decode in two phases: every trial to k1, then
    the still-active ones, gathered, to the cap (the trajectories of a
    single-phase decode)."""
    import numpy as np
    _, st = jbamp.decode(jop, jy, sigma2, jcfg, iter_cap=MASSIVE_K1,
                         return_state=True)
    T = np.array(st.T)
    idx = np.nonzero(np.asarray(st.active))[0]
    if idx.size:
        sub = jbamp.BAMPState(*[v[idx] if v.ndim else v for v in st])
        _, fin = jbamp.decode(jop, jy[idx], sigma2, jcfg, state0=sub,
                              return_state=True)
        T[idx] = np.asarray(fin.T)
    return T


def dump(out: Path, trials: int, seeds: range, algo: str) -> None:
    import dataclasses

    import jax
    jax.config.update("jax_platforms", "cpu")

    from amp_sparc_spatialmodulation_tpu.config import Config as JConfig
    from amp_sparc_spatialmodulation_tpu.config import (
        flagship_bamp_ook as jflagship)
    from amp_sparc_spatialmodulation_tpu.config import (
        massive_mimo as jmassive)
    from amp_sparc_spatialmodulation_tpu.models import bamp as jbamp
    from amp_sparc_spatialmodulation_tpu.models import scamp as jscamp
    from amp_sparc_spatialmodulation_tpu.ops import channel as jchannel
    from amp_sparc_spatialmodulation_tpu.ops import message as jmessage
    from amp_sparc_spatialmodulation_tpu.ops import operators as joperators

    jcfg = {"bamp": jflagship, "scamp": lambda: JConfig(**SCAMP_MAIN),
            "massive": lambda: dataclasses.replace(
                jmassive(), iterations=MASSIVE_CAP)}[algo]()
    cfg = port_config(algo)
    snr = 10 ** ((EBN0_DB[algo] + 10 * np.log10(cfg.code_rate)) / 10)
    out.mkdir(parents=True, exist_ok=True)
    jT_all, pT_all = [], []
    for seed in seeds:
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
        jW, jop = joperators.banded_sparc(k1, jcfg)
        msg = jmessage.generate_message(k2, jcfg, trials)
        jy = jop.apply(msg.x) + jchannel.awgn(k3, jcfg, snr, trials)
        sigma2 = float(np.float32(jcfg.sigma2(snr)))
        if algo == "scamp":
            jT = np.asarray(jscamp.decode(jW, jop, jy, sigma2, jcfg).T)
        elif algo == "massive":
            jT = jax_two_phase(jbamp, jop, jy, sigma2, jcfg)
        else:
            jT = np.asarray(jbamp.decode(jop, jy, sigma2, jcfg).T)
        d = dict(h=np.asarray(jop.h), gains=np.asarray(jop.gains),
                 W=np.asarray(jW), y=np.array(jy), sigma2=sigma2)
        extra = {}
        if algo != "massive":
            extra["T_port_cpu"] = port_decode(algo, d, cfg, "cpu")
            pT_all.append(extra["T_port_cpu"])
        np.savez(out / f"seed{seed}.npz", **d, T_jax=jT, algo=algo, **extra)
        jT_all.append(jT)
    if pT_all:
        print(json.dumps({"jax_cpu_vs_port_cpu": summary(
            np.concatenate(jT_all), np.concatenate(pT_all), cfg.N_Layers)}))
    else:
        print(json.dumps({"jax_cpu": {
            "trials": int(sum(t.size for t in jT_all)),
            "mean_T": float(np.concatenate(jT_all).mean())}}))


def check(directory: Path) -> None:
    import torch

    from amp_sparc_spatialmodulation_tpu_torch.models import bamp
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_bamp, fused_bamp_tiled, fused_scamp)

    torch.backends.cuda.matmul.allow_tf32 = False
    files = sorted(directory.glob("seed*.npz"))
    if not files:
        raise SystemExit(f"no seed*.npz under {directory}")
    algo = str(np.load(files[0]).get("algo", "bamp"))
    cfg = port_config(algo)
    kernel = {"scamp": fused_scamp, "massive": fused_bamp_tiled}.get(
        algo, fused_bamp)
    jT, cT, kT = [], [], []
    before, plain = kernel.launches, bamp.plain_decodes
    for f in files:
        d = np.load(f)
        kT.append(port_decode(algo, d, cfg, "cuda"))
        jT.append(d["T_jax"])
        if "T_port_cpu" in d:
            cT.append(d["T_port_cpu"])
    ran = kernel.launches - before
    if (ran < len(files) if algo == "massive" else ran != len(files)) \
            or bamp.plain_decodes != plain:
        raise AssertionError("the card's decodes did not run the kernel")
    jT, kT = np.concatenate(jT), np.concatenate(kT)
    out = {"algo": algo, "device": torch.cuda.get_device_name(0),
           "realizations": len(files),
           "jax_cpu_vs_port_kernel": summary(jT, kT, cfg.N_Layers)}
    if cT:
        cT = np.concatenate(cT)
        out["jax_cpu_vs_port_cpu"] = summary(jT, cT, cfg.N_Layers)
        out["port_cpu_vs_port_kernel"] = summary(cT, kT, cfg.N_Layers)
    print(json.dumps(out))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("--out", type=Path, required=True)
    d.add_argument("--trials", type=int, default=512)
    d.add_argument("--seeds", default="10:26", help="first:last+1")
    d.add_argument("--algo", choices=["bamp", "scamp", "massive"],
                   default="bamp")
    c = sub.add_parser("check")
    c.add_argument("--dir", type=Path, required=True)
    args = ap.parse_args()
    if args.cmd == "dump":
        lo, hi = (int(v) for v in args.seeds.split(":"))
        dump(args.out, args.trials, range(lo, hi), args.algo)
    else:
        check(args.dir)


if __name__ == "__main__":
    main()
