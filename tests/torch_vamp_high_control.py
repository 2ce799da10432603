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

With ``--precision default`` the DEFAULT instance (one bf16 pass) and, as
the wrong precision, the HIGH instance against the plain DEFAULT version,
on a realization drawn at DEFAULT: the readings behind chip_smoke.py's
``VAMP_DEFAULT_CONTROL_TOL``; ``--parent`` is then optional (a tree without
a DEFAULT form is left out).  Then, at the main geometry, whole decodes to
the cap of 10 against the plain DEFAULT version: the DEFAULT instance, the
plain DEFAULT version with its one-pass sums taken in float64 (two
correct DEFAULT decodes), the HIGH and HIGHEST instances: T agreement,
mean T, |d mean T| and the share of the T-agreeing trials whose
posterior lies within 1e-3, the readings behind kernels_vamp_default's
rule.

    env PYTHONPATH=. python3 tests/torch_vamp_high_control.py \
        --precision default

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


def cases(dev, algo, precision="high"):
    """(name, cfg, case) of the two geometries, as chip_smoke builds them,
    drawn and projected at ``precision``."""
    mod, data = (vamp, vamp.project) if algo == "vamp" else (vamp2,
                                                              vamp2.whiten)

    def realization(cfg, B, seed, snr):
        r = montecarlo.with_svd(algo, montecarlo.generate_realization(
            make_generator(dev, seed), cfg, "sparc", "dense", B, snr,
            precision))
        return (r, data(r.dec, r.y, precision), (r.dec.s ** 2).contiguous(),
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
    p.add_argument("--parent", type=Path, default=None,
                   help="root of the other checkout (required at 'high')")
    p.add_argument("--precision", choices=["high", "default"],
                   default="high")
    args = p.parse_args(argv)
    default = args.precision == "default"
    if args.parent is None and not default:
        p.error("--parent is required at --precision high")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    roots = {"change": Path(__file__).resolve().parents[1]}
    if args.parent is not None and not default:
        roots = {"parent": args.parent.resolve(), **roots}
    trees = {k: root / "amp_sparc_spatialmodulation_tpu_torch" / "ops"
             / "kernels" / "csrc" for k, root in roots.items()}
    for algo in ("vamp", "vamp2"):
        tag = "" if algo == "vamp" else "2"
        name, module = f"fused_vamp{tag}_decode", f"fused_vamp{tag}"
        mods = {k: ab.wrapper_module(root, module, k)
                for k, root in roots.items()}
        libs = ab._libraries(name, mods, trees)
        for geometry, cfg, case in cases(dev, algo, args.precision):
            for label, mod in mods.items():
                build._loaded[name] = libs[label]

                def kernel(cfg, case, s0, cap, precision, mod=mod):
                    r, yt, s2, _ = case
                    return mod.whole_decode(r.dec.Vh, s2, yt, s0, r.sigma2,
                                            cap, cfg, precision)

                if default:
                    sound, wrong = cs.vamp_high_control(
                        mod, cfg, case, kernel, "default", "high")
                    forms = {"default": sound, "high": wrong}
                else:
                    high, highest = cs.vamp_high_control(mod, cfg, case,
                                                         kernel)
                    forms = {"high": high, "highest": highest}
                print(json.dumps({"algo": algo, "geometry": geometry,
                                  "tree": label, "device": smi,
                                  "B": int(case[0].y.shape[0]),
                                  "statistic": cs.HIGH_CONTROL_STAT,
                                  "precision": args.precision, **forms}),
                      flush=True)
            del case
        build._loaded.pop(name, None)
    if default:
        decode_readings(dev)
    return 0


def decode_readings(dev) -> None:
    """The whole-decode readings of ``--precision default`` (module
    docstring), this checkout's kernels."""
    from amp_sparc_spatialmodulation_tpu_torch.ops import precision as prec
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_vamp, fused_vamp2)

    exact = (lambda x, a: (x.bfloat16().double()
                           @ a.bfloat16().double()).float(),
             lambda x: x.bfloat16().double().sum(1, keepdim=True).float())
    for algo, kern in (("vamp", fused_vamp), ("vamp2", fused_vamp2)):
        _, cfg, case = list(cases(dev, algo, "default"))[1]
        r, yt, s2, s0 = case
        run = lambda p: kern.whole_decode(r.dec.Vh, s2, yt, s0, r.sigma2,
                                          10, cfg, p)
        plain = lambda: kern.decode_plain(r.dec.Vh, s2, yt, s0, r.sigma2,
                                          10, cfg, "default")
        sp = plain()
        saved = prec.DOTS["default"]
        prec.DOTS["default"] = exact
        try:
            sx = plain()
        finally:
            prec.DOTS["default"] = saved
        for name, sk in (("kernel_default", run("default")),
                         ("plain_exact", sx), ("kernel_high", run("high")),
                         ("kernel_highest", run("highest"))):
            agree = sk.T == sp.T
            n = int(agree.sum())
            d = torch.zeros(sk.T.numel(), device=dev)
            for f in ("xmmse", "var"):
                e = (getattr(sk, f) - getattr(sp, f)).abs()
                d = torch.maximum(d, e.reshape(e.shape[0], -1).max(1).values)
            within = float((d[agree] <= 1e-3).sum()) / max(n, 1)
            print(json.dumps({
                "algo": algo, "geometry": "main", "decode": name, "cap": 10,
                "B": int(sk.T.numel()),
                "T_agree_fraction": n / sk.T.numel(),
                "mean_T": float(sk.T.float().mean()),
                "mean_T_plain_default": float(sp.T.float().mean()),
                "abs_dmean_T": abs(float(sk.T.float().mean())
                                   - float(sp.T.float().mean())),
                "posterior_within_1e3_share": within}), flush=True)
        del case, r, yt, s0, sp, sx
        torch.cuda.empty_cache()


if __name__ == "__main__":
    raise SystemExit(main())
