"""Reference FER, BER and mean T of the JAX package's BAMP decoder at the
port's massive-MIMO main point, on the CPU.

The point is ``config.massive_mimo()`` (Nt=1344, Na=84, Nr=73, Lin=32,
Lh=6, segmented, uniform, tail, OOK) with the iteration cap raised to 300,
Eb/N0 = 18 dB, two-phase k1=40: the protocol of
``scripts/bench_massive.py:37-42``.  The JAX ``Simulator`` decodes it with
its XLA banded path on the CPU; ``chip_smoke.py`` holds the port's run on
the card (kernel K5) against these numbers.

    env JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_massive_reference.py \\
        --epochs 2048 --res 256

Prints one JSON line: the trials, FER, BER, mean T, the FER, BER and mean T
of each realization, and the seconds the run took.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

EBN0_DB = 18.0
CAP = 300
K1 = 40


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=2048)
    p.add_argument("--res", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import dataclasses

    import jax
    jax.config.update("jax_platforms", "cpu")
    from amp_sparc_spatialmodulation_tpu.config import massive_mimo
    from amp_sparc_spatialmodulation_tpu.models.montecarlo import Simulator

    cfg = dataclasses.replace(massive_mimo(), iterations=CAP)
    sim = Simulator(cfg, algo="bamp", seed=args.seed, two_phase=K1,
                    out_root="build/massive_reference",
                    progress=lambda s: None)
    n_real = max(1, args.epochs // args.res)
    t0 = time.perf_counter()
    per_real = [sim.run_point(EBN0_DB, epochs=args.res, res=args.res,
                              snr_idx=i) for i in range(n_real)]
    seconds = time.perf_counter() - t0
    col = lambda k: [float(r[k]) for r in per_real]
    print(json.dumps({
        "config": "massive_mimo", "cap": CAP, "two_phase_k1": K1,
        "backend": jax.default_backend(), "ebn0_db": EBN0_DB,
        "trials": n_real * args.res, "res": args.res,
        "realizations": n_real, "fer": float(np.mean(col("fer"))),
        "ber": float(np.mean(col("ber"))), "mean_T": float(np.mean(col("T"))),
        "realization_fer": col("fer"), "realization_ber": col("ber"),
        "realization_mean_T": col("T"), "seconds": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
