"""The HIGH forms of K3 and K4 (``precision='high'``) held to their plain
HIGH version after one iteration, for this checkout's kernels and another
checkout's, on one card: the readings behind ``chip_smoke.py``'s
``HIGH_MAIN_CONTROL_TOL``.

For each tree and each of ``vamp`` and ``vamp2``, at the main geometry
(``chip_smoke.vamp_main_config()``, 4096 trials, Eb/N0 = 8 dB, the
realization of chip_smoke's ``kernel_main_*_high`` checks) and at the small
OOK geometry of its small-shape control: the gaps (``chip_smoke.vamp_gap``)
of the HIGH instance and of the HIGHEST instance to the plain HIGH version
(``decode_plain(..., 'high')``, one iteration), through that tree's own
wrapper module and library (``tests/torch_kernel_ab.py``'s loading).

    git archive <commit> amp_sparc_spatialmodulation_tpu_torch | \\
        (mkdir -p build/parent && tar -x -C build/parent)
    env PYTHONPATH=. python3 tests/torch_vamp_high_control.py \\
        --parent build/parent

Prints one JSON line per tree, algorithm and geometry.  Needs the card and
``nvcc``; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as cs  # noqa: E402
import torch_kernel_ab as ab  # noqa: E402
from amp_sparc_spatialmodulation_tpu_torch.config import Config  # noqa: E402
from amp_sparc_spatialmodulation_tpu_torch.models import (  # noqa: E402
    montecarlo, vamp, vamp2)
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (  # noqa: E402
    build)
from amp_sparc_spatialmodulation_tpu_torch.utils.device import (  # noqa: E402
    make_generator)


def cases(dev, algo):
    """(name, cfg, case) of the two geometries, as chip_smoke builds them."""
    mod, data = (vamp, vamp.project) if algo == "vamp" else (vamp2,
                                                              vamp2.whiten)

    def realization(cfg, B, seed, snr):
        r = montecarlo.with_svd(algo, montecarlo.generate_realization(
            make_generator(dev, seed), cfg, "sparc", "dense", B, snr, "high"))
        return (r, data(r.dec, r.y, "high"), (r.dec.s ** 2).contiguous(),
                mod.initial_state(r.y, cfg))

    small = Config(Nt=16, Na=4, Nr=10, Lin=8, Lh=3, mode="segmented",
                   profile="uniform", trunc="tail", alphabet="OOK",
                   iterations=10 if algo == "vamp" else 12)
    yield "small_ook", small, realization(small, cs.SMALL_B, 300, 10 ** 1.5)
    mcfg = cs.vamp_main_config()
    yield "main", mcfg, realization(mcfg, cs.FLAGSHIP_B, 27,
                                    cs.snr_of(mcfg, cs.EBN0_DB))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=Path, required=True,
                   help="root of the other checkout")
    args = p.parse_args(argv)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    roots = {"parent": args.parent.resolve(),
             "change": Path(__file__).resolve().parents[1]}
    trees = {k: root / "amp_sparc_spatialmodulation_tpu_torch" / "ops"
             / "kernels" / "csrc" for k, root in roots.items()}
    for algo in ("vamp", "vamp2"):
        tag = "" if algo == "vamp" else "2"
        name, module = f"fused_vamp{tag}_decode", f"fused_vamp{tag}"
        mods = {k: ab.wrapper_module(root, module, k)
                for k, root in roots.items()}
        libs = ab._libraries(name, mods, trees)
        for geometry, cfg, case in cases(dev, algo):
            for label, mod in mods.items():
                build._loaded[name] = libs[label]

                def kernel(cfg, case, s0, cap, precision, mod=mod):
                    r, yt, s2, _ = case
                    return mod.whole_decode(r.dec.Vh, s2, yt, s0, r.sigma2,
                                            cap, cfg, precision)

                high, highest = cs.vamp_high_control(mod, cfg, case, kernel)
                print(json.dumps({"algo": algo, "geometry": geometry,
                                  "tree": label, "device": smi,
                                  "B": int(case[0].y.shape[0]),
                                  "statistic": cs.HIGH_CONTROL_STAT,
                                  "high": high, "highest": highest}),
                      flush=True)
            del case
        build._loaded.pop(name, None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
