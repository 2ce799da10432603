"""Reference figures of the JAX package's analysis tools on the CPU, for
the ``main_sparc_trial`` and ``main_capacity`` phases of ``chip_smoke.py``.

``--part sparc``: ``models/sparc_tools.py::compare_single_trial`` at the
SCAMP main geometry (Nt=128, Na=8, Nr=24, Lin=20, Lh=3, OOK, sparc, tail,
cap 100; no power allocation) over seeds ``0 .. seeds-1`` at each Eb/N0
of ``--ebn0`` (a comma-separated list, to find the point where FER lies
between 0.05 and 0.5): per decoder FER, SER, the standard deviation of one
trial's SER, and the mean NMSE.

``--part capacity``: ``models/capacity.py::InfoTheory.simulate`` at
``config.flagship_bamp_ook()`` with ``--epochs`` epochs a point and
``grid_points=100`` over ``--points`` Eb/N0 points from its default start,
once for each seed of ``--cap-seeds``: every seed's rows (Cawgn, Cfs,
Cwf, Mi) and, per point, the mean and standard deviation over the seeds
of Cwf and Mi.

``--part parity``: the same trials, drawn by the JAX package, decoded by
both packages on the CPU (the port through its kernels' plain versions),
with and without power allocation, at each Eb/N0 of ``--ebn0`` over
``--seeds`` seeds: per decoder the share of trials whose T agrees and
whether ser and fer agree on every trial.

    env JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_analysis_reference.py \\
        --part sparc --ebn0 5,6,7 --seeds 256
    env JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_analysis_reference.py \\
        --part parity --ebn0 6,7,8 --seeds 6
    env JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_analysis_reference.py \\
        --part capacity --epochs 100 --points 3 --cap-seeds 0,1,2,3

Prints one JSON line per part.  Not collected by pytest.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np


def sparc_main_config(Config):
    return Config(Nt=128, Na=8, Nr=24, Lin=20, Lh=3, mode="sparc",
                  alphabet="OOK", profile="uniform", trunc="tail",
                  iterations=100)


def part_sparc(ebn0s, seeds):
    from amp_sparc_spatialmodulation_tpu.config import Config
    from amp_sparc_spatialmodulation_tpu.models import sparc_tools as st

    cfg = sparc_main_config(Config)
    points = []
    for ebn0 in ebn0s:
        t0 = time.perf_counter()
        runs = [st.compare_single_trial(cfg, ebn0, seed=s)
                for s in range(seeds)]
        point = dict(ebn0_db=ebn0, trials=seeds,
                     seconds=time.perf_counter() - t0)
        for algo in ("scamp", "bamp"):
            ser = np.array([r[algo].ser for r in runs])
            fer = np.array([r[algo].fer for r in runs])
            nmse = np.array([r[algo].nmse for r in runs])
            point[algo] = dict(fer=float(fer.mean()), ser=float(ser.mean()),
                               ser_sd=float(ser.std(ddof=1)),
                               nmse=float(nmse.mean()))
        point["rate_nats"] = runs[0]["scamp"].rate
        point["C"] = runs[0]["scamp"].C
        points.append(point)
    return dict(part="sparc", config=dict(Nt=128, Na=8, Nr=24, Lin=20, Lh=3,
                                          alphabet="OOK", mode="sparc",
                                          iterations=100), points=points)


def part_parity(ebn0s, seeds):
    import jax.numpy as jnp
    import torch

    from amp_sparc_spatialmodulation_tpu.config import Config
    from amp_sparc_spatialmodulation_tpu.models import bamp as jbamp
    from amp_sparc_spatialmodulation_tpu.models import scamp as jscamp
    from amp_sparc_spatialmodulation_tpu.models import sparc_tools as jst
    from amp_sparc_spatialmodulation_tpu_torch import interop
    from amp_sparc_spatialmodulation_tpu_torch.config import Config as PConfig
    from amp_sparc_spatialmodulation_tpu_torch.models import sparc_tools

    jcfg = sparc_main_config(Config)
    cfg = sparc_main_config(PConfig)
    rate = jst.segmented_sparc_rate_nats(cfg.Nt, cfg.Na, cfg.Nr, cfg.Lin,
                                         cfg.Lh, cfg.K)
    rows = {}
    t0 = time.perf_counter()
    for ebn0 in ebn0s:
        snr = 10 ** ((ebn0 + 10 * np.log10(rate)) / 10)
        for pa_on in (False, True):
            pa = jst.exp_power_allocation(snr, cfg.Lin) if pa_on else None
            for seed in range(seeds):
                W, jop, msg, y, sigma2, snr_, rate_ = jst._build_trial(
                    jcfg, ebn0, pa, seed)
                trial = sparc_tools.Trial(
                    W=np.array(W), op=interop.operator_from_numpy(
                        np.array(jop.h), np.array(jop.gains), cfg.Lin,
                        cfg.Lout, cfg.trunc, device="cpu"),
                    msg=interop.message_from_numpy(
                        np.array(msg.x), np.array(msg.ant),
                        np.array(msg.sym), np.array(msg.gray),
                        np.array(msg.flat), device="cpu"),
                    y=torch.as_tensor(np.array(y)), sigma2=sigma2,
                    snr=snr_, rate=rate_)
                for algo, phi in (("bamp", False), ("scamp", False),
                                  ("scamp", True)):
                    if algo == "bamp":
                        jout = jbamp.decode(jop, y, sigma2, jcfg)
                    else:
                        jout = jscamp.decode(jnp.asarray(W), jop, y, sigma2,
                                             jcfg, estimate_phi=phi)
                    want = jst._eval_trial(jout, msg, jcfg, snr_, rate_)
                    pout = sparc_tools._decode(algo, trial, cfg, phi)
                    got = sparc_tools._eval_trial(pout, trial.msg, cfg, snr_,
                                                  rate_)
                    key = f"{algo}{'_phi' if phi else ''}_pa{int(pa_on)}"
                    rows.setdefault(key, []).append(
                        (int(np.asarray(jout.T)[0]) == int(pout.T[0]),
                         (got.ser, got.fer) == (want.ser, want.fer)))
    return dict(part="parity", ebn0_db=ebn0s, seeds=seeds,
                seconds=time.perf_counter() - t0,
                cases={k: dict(trials=len(v),
                               T_agree=sum(a for a, _ in v) / len(v),
                               ser_fer_identical_all=all(b for _, b in v))
                       for k, v in rows.items()})


def part_capacity(epochs, n_points, seeds):
    from amp_sparc_spatialmodulation_tpu.config import flagship_bamp_ook
    from amp_sparc_spatialmodulation_tpu.models.capacity import InfoTheory

    cfg = flagship_bamp_ook()
    start = int(np.ceil(cfg.shannon_limit_dB))
    final = start + n_points - 1
    rows = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for s in seeds:
            out = InfoTheory(cfg, out_root=tmp, seed=s).simulate(
                epochs=epochs, start=start, final=final, grid_points=100,
                progress=lambda msg: None)
            rows[s] = out.tolist()
    arr = np.array([rows[s] for s in seeds])        # (seeds, points, 4)
    return dict(part="capacity", config="flagship_bamp_ook", epochs=epochs,
                grid_points=100, start=start, final=final,
                seconds=time.perf_counter() - t0, seeds=list(seeds),
                rows=rows, cawgn=arr[0, :, 0].tolist(),
                cwf_mean=arr[:, :, 2].mean(0).tolist(),
                cwf_sd=arr[:, :, 2].std(0, ddof=1).tolist(),
                mi_mean=arr[:, :, 3].mean(0).tolist(),
                mi_sd=arr[:, :, 3].std(0, ddof=1).tolist())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--part", choices=["sparc", "parity", "capacity"],
                   required=True)
    p.add_argument("--ebn0", default="6")
    p.add_argument("--seeds", type=int, default=256)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--points", type=int, default=3)
    p.add_argument("--cap-seeds", default="0,1,2,3")
    args = p.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    ebn0s = [float(e) for e in args.ebn0.split(",")]
    if args.part == "sparc":
        out = part_sparc(ebn0s, args.seeds)
    elif args.part == "parity":
        out = part_parity(ebn0s, args.seeds)
    else:
        out = part_capacity(args.epochs, args.points,
                            [int(s) for s in args.cap_seeds.split(",")])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
