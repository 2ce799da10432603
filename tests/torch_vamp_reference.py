"""Reference FER and mean T of the JAX package's VAMP and vamp2 decoders at
the port's VAMP main point, on the CPU.

The point is the VAMP OOK family of ``BASELINE.md:50-58`` at its published
iteration cap of 10 (Nt=128, Na=8, Nr=24, Lin=20, Lh=3, segmented, uniform,
tail; N = 2560, p = 528), the SPARC channel in dense form, Eb/N0 = 8 dB,
single phase.  The JAX ``Simulator`` decodes it with its XLA path on the
CPU; ``chip_smoke.py`` holds the port's run on the card against these
numbers (vamp2, which has no published sweep) and against the published
artifact (VAMP).

    env JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_vamp_reference.py \\
        --algo vamp2 --epochs 16384 --res 2048

Prints one JSON line: the trials, FER, BER, mean T, and the FER, BER and
mean T of each realization.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

EBN0_DB = 8.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--algo", choices=["vamp", "vamp2"], required=True)
    p.add_argument("--epochs", type=int, default=16384)
    p.add_argument("--res", type=int, default=2048)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    from amp_sparc_spatialmodulation_tpu.config import Config
    from amp_sparc_spatialmodulation_tpu.models.montecarlo import Simulator

    cfg = Config(Nt=128, Na=8, Nr=24, Lin=20, Lh=3, mode="segmented",
                 alphabet="OOK", profile="uniform", trunc="tail",
                 iterations=10)
    sim = Simulator(cfg, algo=args.algo, seed=args.seed,
                    out_root="build/vamp_reference", progress=lambda s: None)
    n_real = max(1, args.epochs // args.res)
    t0 = time.perf_counter()
    per_real = [sim.run_point(EBN0_DB, epochs=args.res, res=args.res,
                              snr_idx=i) for i in range(n_real)]
    seconds = time.perf_counter() - t0
    fer = float(np.mean([r["fer"] for r in per_real]))
    mean_T = float(np.mean([r["T"] for r in per_real]))
    print(json.dumps({
        "algo": args.algo, "backend": jax.default_backend(),
        "ebn0_db": EBN0_DB, "trials": n_real * args.res, "res": args.res,
        "fer": fer, "ber": float(np.mean([r["ber"] for r in per_real])),
        "mean_T": mean_T,
        "realization_fer": [r["fer"] for r in per_real],
        "realization_ber": [r["ber"] for r in per_real],
        "realization_mean_T": [r["T"] for r in per_real],
        "seconds": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
