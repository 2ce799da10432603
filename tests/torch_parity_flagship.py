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
(``flagship_bamp_ook()``, Eb/N0 = 8 dB, kernel K1), ``--algo bamp_qpsk``
the BAMPfinal QPSK point (``flagship_bamp_qpsk()``, Eb/N0 = 5 dB, cap 100,
kernel K1), each with ``--precision high`` also decoded by JAX's Pallas
kernel at ``Precision.HIGH`` in interpret mode, which ``check`` holds the
port's kernel in its HIGH form to (the port's CPU decode skipped, PR 3's
rule: |d mean T| within 2% of the cap); ``--algo scamp`` the
SCAMP main point (the OOK sparc config at the same dimensions, Eb/N0 =
8 dB, kernel K2); ``--algo massive`` the massive-MIMO point
(``massive_mimo()`` at cap 300, Eb/N0 = 18 dB, kernel K5), where JAX
decodes in two phases (k1 = 40, as its ``Simulator`` does, so that a trial
that runs to the cap does not hold the whole batch) and the port's CPU
decode is skipped (only the kernel is compared with JAX); with
``--precision high`` the massive point moves to Eb/N0 = 10 dB at
``massive_mimo()``'s own cap of 100 (where trials stop by the allclose
test and mean T tracks the accuracy of the products), and JAX's
frame-tiled Pallas kernel K5 at ``Precision.HIGH`` in interpret mode
decodes in one phase, which ``check`` holds the port's K5 in its HIGH
form to.  ``--algo vamp``
and ``--algo vamp2`` take the VAMP main geometry at cap 100
(``chip_smoke.vamp_main_config(iterations=100)``, dense SPARC channel,
Eb/N0 = 8 dB, kernels K3 and K4), where trials stop by the allclose test
and mean T tracks the accuracy of the products: both packages decode on
the same factors (the port's direct SVD, carried to JAX), JAX by its XLA
decode and, with ``--precision high``, also by its Pallas kernel at
``Precision.HIGHEST`` and at ``Precision.HIGH`` in interpret mode; ``check`` then decodes with the
port's kernel in the HIGHEST form and, where the dump has the JAX HIGH
run, the HIGH form, and compares each with its JAX counterpart (the port's
CPU decode is skipped).  Two steps, since the machine with the card has no
JAX:

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

EBN0_DB = {"bamp": 8.0, "bamp_qpsk": 5.0, "scamp": 8.0, "massive": 18.0,
           "vamp": 8.0, "vamp2": 8.0}
BAMP_ALGOS = ("bamp", "bamp_qpsk")
SVD_ALGOS = ("vamp", "vamp2")
MASSIVE_CAP, MASSIVE_K1 = 300, 40
# The massive point at HIGH: massive_mimo()'s own cap, a converging Eb/N0.
MASSIVE_HIGH_CAP, MASSIVE_HIGH_DB = 100, 10.0


def summary(a: np.ndarray, b: np.ndarray, cap: int) -> dict:
    """Per-trial T of ``b`` against ``a``: agreement, mean difference and
    its standard error, and how many trials each ran to the cap."""
    d = b.astype(np.float64) - a
    return {"trials": int(a.size), "T_agree_fraction": float((a == b).mean()),
            "mean_T_a": float(a.mean()), "mean_T_b": float(b.mean()),
            "dmean_T": float(d.mean()),
            "dmean_T_stderr": float(d.std(ddof=1) / np.sqrt(d.size)),
            "at_cap_a": int((a == cap).sum()), "at_cap_b": int((b == cap).sum())}


# The VAMP main geometry at cap 100 (chip_smoke.py's
# vamp_main_config(iterations=100)).
VAMP_MAIN = dict(Nt=128, Na=8, Nr=24, Lin=20, Lh=3, mode="segmented",
                 alphabet="OOK", profile="uniform", trunc="tail",
                 iterations=100)

# The SCAMP main point's config (chip_smoke.py's scamp_main_config).
SCAMP_MAIN = dict(Nt=128, Na=8, Nr=24, Lin=20, Lh=3, mode="sparc",
                  alphabet="OOK", profile="uniform", trunc="tail",
                  iterations=100)


def port_config(algo: str, cap: int | None = None):
    """The port's config of ``algo``'s point (``cap``, where given, the
    massive point's iteration cap)."""
    import dataclasses

    from amp_sparc_spatialmodulation_tpu_torch.config import (
        Config, flagship_bamp_ook, flagship_bamp_qpsk, massive_mimo)
    if algo == "bamp_qpsk":
        return flagship_bamp_qpsk()
    if algo == "massive":
        return dataclasses.replace(massive_mimo(),
                                   iterations=cap or MASSIVE_CAP)
    if algo in SVD_ALGOS:
        return Config(**VAMP_MAIN)
    return flagship_bamp_ook() if algo == "bamp" else Config(**SCAMP_MAIN)


def port_decode(algo: str, d, cfg, device, precision="highest",
                data_precision=None):
    """The port's decode of one dumped realization ``d`` on ``device``
    (VAMP and vamp2 at ``precision``; ``data_precision``, where given,
    forms ``y_tilde`` at that precision instead, as XLA on the CPU forms
    it in float32 whatever the precision asked for)."""
    import torch

    from amp_sparc_spatialmodulation_tpu_torch import interop
    from amp_sparc_spatialmodulation_tpu_torch.models import (bamp, scamp,
                                                              vamp, vamp2)
    if algo in SVD_ALGOS:
        from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
            fused_vamp, fused_vamp2)
        dec = interop.svd_from_numpy(d["U"], d["s"], d["Vh"], device=device)
        y = torch.as_tensor(d["y"], device=device)
        if data_precision is None:
            mod = vamp if algo == "vamp" else vamp2
            return mod.decode(dec, y, float(d["sigma2"]), cfg,
                              precision=precision).T.cpu().numpy()
        mod, kern, data = ((vamp, fused_vamp, vamp.project) if algo == "vamp"
                           else (vamp2, fused_vamp2, vamp2.whiten))
        return kern.whole_decode(
            dec.Vh, dec.s ** 2, data(dec, y, data_precision),
            mod.initial_state(y, cfg), float(d["sigma2"]), cfg.N_Layers,
            cfg, precision).T.cpu().numpy()
    op = interop.operator_from_numpy(d["h"], d["gains"], cfg.Lin, cfg.Lout,
                                     cfg.trunc, device=device)
    y = torch.as_tensor(d["y"], device=device)
    sigma2 = float(d["sigma2"])
    if algo == "scamp":
        W = torch.as_tensor(d["W"], device=device)
        return scamp.decode(W, op, y, sigma2, cfg).T.cpu().numpy()
    return bamp.decode(op, y, sigma2, cfg,
                       precision=precision).T.cpu().numpy()


def npz_cap(d):
    """The iteration cap a dump recorded (None for dumps without one)."""
    return int(d["cap"]) if "cap" in d else None


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


def dump_svd(out: Path, trials: int, seeds: range, algo: str,
             precision: str) -> None:
    """``dump`` for VAMP and vamp2: the dense SPARC realization drawn by
    the JAX package, the port's direct SVD of it (the JAX package's takes
    about ten times as long on the CPU at this width), JAX's XLA decode on
    those factors and, at ``precision='high'``, its Pallas kernel at
    Precision.HIGH in interpret mode."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from amp_sparc_spatialmodulation_tpu.config import Config as JConfig
    from amp_sparc_spatialmodulation_tpu.models import vamp as jvamp
    from amp_sparc_spatialmodulation_tpu.models import vamp2 as jvamp2
    from amp_sparc_spatialmodulation_tpu.ops import channel as jchannel
    from amp_sparc_spatialmodulation_tpu.ops import message as jmessage
    from amp_sparc_spatialmodulation_tpu_torch.models import vamp

    jcfg = JConfig(**VAMP_MAIN)
    jmod = jvamp if algo == "vamp" else jvamp2
    snr = 10 ** ((EBN0_DB[algo] + 10 * np.log10(jcfg.code_rate)) / 10)
    out.mkdir(parents=True, exist_ok=True)
    summary_T = {"T_jax": [], "T_jax_kernel": [], "T_jax_high": []}
    for seed in seeds:
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
        _, A = jchannel.generate_as_sparc(k1, jcfg)
        msg = jmessage.generate_message(k2, jcfg, trials)
        jy = msg.x @ A.T + jchannel.awgn(k3, jcfg, snr, trials)
        sigma2 = float(np.float32(jcfg.sigma2(snr)))
        dec = vamp.svd(torch.as_tensor(np.array(A)), method="direct")
        jdec = jvamp.SVD(*[jnp.asarray(t.numpy()) for t in dec])
        d = dict(U=dec.U.numpy(), s=dec.s.numpy(), Vh=dec.Vh.numpy(),
                 y=np.array(jy), sigma2=sigma2, algo=algo,
                 T_jax=np.asarray(jmod.decode(jdec, jy, sigma2, jcfg).T))
        if precision == "high":
            for key, p in (("T_jax_kernel", jax.lax.Precision.HIGHEST),
                           ("T_jax_high", jax.lax.Precision.HIGH)):
                d[key] = np.asarray(jmod.decode(
                    jdec, jy, sigma2, jcfg, use_pallas=True,
                    precision=p).T)
        np.savez(out / f"seed{seed}.npz", **d)
        for k in summary_T:
            if k in d:
                summary_T[k].append(d[k])
    print(json.dumps({k: {"trials": int(sum(t.size for t in v)),
                          "mean_T": float(np.concatenate(v).mean()),
                          "at_cap": int((np.concatenate(v)
                                         == jcfg.N_Layers).sum())}
                      for k, v in summary_T.items() if v}))


def dump(out: Path, trials: int, seeds: range, algo: str,
         precision: str = "highest") -> None:
    """``dump`` for the banded decoders; for BAMP and the massive point at
    ``precision='high'`` also JAX's Pallas kernel (K1, resp. K5 at
    ``MASSIVE_HIGH_DB`` and ``MASSIVE_HIGH_CAP``) at Precision.HIGH in
    interpret mode (``T_jax_high``), and no port CPU decode."""
    import dataclasses

    import jax
    jax.config.update("jax_platforms", "cpu")

    from amp_sparc_spatialmodulation_tpu.config import Config as JConfig
    from amp_sparc_spatialmodulation_tpu.config import (
        flagship_bamp_ook as jflagship)
    from amp_sparc_spatialmodulation_tpu.config import (
        flagship_bamp_qpsk as jflagship_qpsk)
    from amp_sparc_spatialmodulation_tpu.config import (
        massive_mimo as jmassive)
    from amp_sparc_spatialmodulation_tpu.models import bamp as jbamp
    from amp_sparc_spatialmodulation_tpu.models import scamp as jscamp
    from amp_sparc_spatialmodulation_tpu.ops import channel as jchannel
    from amp_sparc_spatialmodulation_tpu.ops import message as jmessage
    from amp_sparc_spatialmodulation_tpu.ops import operators as joperators

    massive_high = algo == "massive" and precision == "high"
    cap = MASSIVE_HIGH_CAP if massive_high else MASSIVE_CAP
    jcfg = {"bamp": jflagship, "bamp_qpsk": jflagship_qpsk,
            "scamp": lambda: JConfig(**SCAMP_MAIN),
            "massive": lambda: dataclasses.replace(
                jmassive(), iterations=cap)}[algo]()
    cfg = port_config(algo, cap if algo == "massive" else None)
    ebn0 = MASSIVE_HIGH_DB if massive_high else EBN0_DB[algo]
    snr = 10 ** ((ebn0 + 10 * np.log10(cfg.code_rate)) / 10)
    out.mkdir(parents=True, exist_ok=True)
    jT_all, pT_all, hT_all = [], [], []
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
                 W=np.asarray(jW), y=np.array(jy), sigma2=sigma2,
                 cap=cfg.N_Layers, ebn0_db=ebn0)
        extra = {}
        if precision == "high":
            extra["T_jax_high"] = np.asarray(jbamp.decode(
                jop, jy, sigma2, jcfg, use_pallas=True,
                precision=jax.lax.Precision.HIGH).T)
            hT_all.append(extra["T_jax_high"])
        elif algo != "massive":
            extra["T_port_cpu"] = port_decode(algo, d, cfg, "cpu")
            pT_all.append(extra["T_port_cpu"])
        np.savez(out / f"seed{seed}.npz", **d, T_jax=jT, algo=algo, **extra)
        jT_all.append(jT)
    if pT_all:
        print(json.dumps({"jax_cpu_vs_port_cpu": summary(
            np.concatenate(jT_all), np.concatenate(pT_all), cfg.N_Layers)}))
    elif hT_all:
        print(json.dumps({"jax_cpu_vs_jax_kernel_high": summary(
            np.concatenate(jT_all), np.concatenate(hT_all), cfg.N_Layers)}))
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
    cfg = port_config(algo, npz_cap(np.load(files[0])))
    if algo in SVD_ALGOS:
        check_svd(files, algo, cfg)
        return
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
           "realizations": len(files), "cap": cfg.N_Layers,
           "jax_cpu_vs_port_kernel": summary(jT, kT, cfg.N_Layers)}
    if cT:
        cT = np.concatenate(cT)
        out["jax_cpu_vs_port_cpu"] = summary(jT, cT, cfg.N_Layers)
        out["port_cpu_vs_port_kernel"] = summary(cT, kT, cfg.N_Layers)
    if "T_jax_high" in np.load(files[0]):
        # K1's (K5's) HIGH form against JAX's kernel at HIGH: |d mean T|
        # within 2% of the cap
        jH, kH = [], []
        before = (kernel.launches, kernel.launches_high)
        for f in files:
            d = np.load(f)
            kH.append(port_decode(algo, d, cfg, "cuda", "high"))
            jH.append(d["T_jax_high"])
        ran = kernel.launches_high - before[1]
        if ((ran < len(files) if algo == "massive" else ran != len(files))
                or kernel.launches != before[0]
                or bamp.plain_decodes != plain):
            raise AssertionError("the card's decodes did not run the HIGH "
                                 "kernel")
        res = summary(np.concatenate(jH), np.concatenate(kH), cfg.N_Layers)
        res["dmean_T_max"] = 0.02 * cfg.N_Layers
        res["within_rule"] = abs(res["dmean_T"]) <= res["dmean_T_max"]
        out["jax_kernel_high_vs_port_kernel_high"] = res
    print(json.dumps(out))


def check_svd(files, algo: str, cfg) -> None:
    """``check`` for VAMP and vamp2: the kernel's T in the HIGHEST form
    against JAX's XLA decode and, where dumped, in the HIGH form against
    JAX's kernel at HIGH, each judged by chip_smoke's mean_T rule (|d mean
    T| within 2% of the cap, the rule for points where mean T tracks the
    accuracy of the products).  The HIGHEST form is also held against
    JAX's kernel at HIGHEST (``jax_kernel_highest_vs_...``), and the HIGH
    form is also decoded from a ``y_tilde`` formed in float32
    (``..._f32_data``), as XLA on the CPU forms JAX's, so that it differs
    from the JAX run by the kernels alone."""
    import torch

    from amp_sparc_spatialmodulation_tpu_torch.models import vamp, vamp2
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_vamp, fused_vamp2)

    torch.backends.cuda.matmul.allow_tf32 = False
    mod, kern = (vamp, fused_vamp) if algo == "vamp" else (vamp2, fused_vamp2)
    out = {"algo": algo, "device": torch.cuda.get_device_name(0),
           "realizations": len(files), "cap": cfg.N_Layers,
           "dmean_T_max": 0.02 * cfg.N_Layers}
    for precision, key, data, name in (
            ("highest", "T_jax", None,
             "jax_highest_vs_port_kernel_highest"),
            ("highest", "T_jax_kernel", None,
             "jax_kernel_highest_vs_port_kernel_highest"),
            ("high", "T_jax_high", None, "jax_high_vs_port_kernel_high"),
            ("high", "T_jax_high", "highest",
             "jax_high_vs_port_kernel_high_f32_data")):
        jT, kT = [], []
        before = (kern.launches, kern.launches_high, mod.plain_decodes)
        for f in files:
            d = np.load(f)
            if key not in d:
                continue
            kT.append(port_decode(algo, d, cfg, "cuda", precision, data))
            jT.append(d[key])
        if not jT:
            continue
        ran = (kern.launches - before[0], kern.launches_high - before[1])
        if ran[precision == "high"] != len(jT) or ran[precision != "high"] \
                or mod.plain_decodes != before[2]:
            raise AssertionError("the card's decodes did not run the "
                                 f"{precision} kernel")
        res = summary(np.concatenate(jT), np.concatenate(kT), cfg.N_Layers)
        res["within_rule"] = abs(res["dmean_T"]) <= out["dmean_T_max"]
        out[name] = res
    print(json.dumps(out))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("--out", type=Path, required=True)
    d.add_argument("--trials", type=int, default=512)
    d.add_argument("--seeds", default="10:26", help="first:last+1")
    d.add_argument("--algo", choices=["bamp", "bamp_qpsk", "scamp",
                                      "massive", "vamp", "vamp2"],
                   default="bamp")
    d.add_argument("--precision", choices=["highest", "high"],
                   default="highest",
                   help="bamp, bamp_qpsk, massive, vamp, vamp2: also "
                        "decode with JAX's kernel at Precision.HIGH "
                        "(interpret mode) for the HIGH form (massive: at "
                        "10 dB, cap 100)")
    c = sub.add_parser("check")
    c.add_argument("--dir", type=Path, required=True)
    args = ap.parse_args()
    if args.cmd == "dump":
        lo, hi = (int(v) for v in args.seeds.split(":"))
        if args.algo in SVD_ALGOS:
            dump_svd(args.out, args.trials, range(lo, hi), args.algo,
                     args.precision)
        else:
            dump(args.out, args.trials, range(lo, hi), args.algo,
                 args.precision)
    else:
        check(args.dir)


if __name__ == "__main__":
    main()
