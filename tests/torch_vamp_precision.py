"""Mean T of the VAMP and vamp2 decodes against the accuracy of their two
dense products, on the card.

Where trials stop by the allclose test on the posterior variance (rtol
1e-5) after tens of iterations, mean T measures how finely the products
round.  This script decodes the same trials four ways:

* ``kernel``: the whole-decode kernel (K3 or K4), whose sums over k are
  blocked (``ops/kernels/csrc/vamp_common.cuh``);
* ``plain``: the plain version at ``B`` trials (cuBLAS's order at that
  batch size);
* ``plain_large_batch``: the plain version on the same trials repeated 16
  times, of which the first ``B`` are read (cuBLAS's order at the larger
  batch: one FMA chain over k);
* ``plain_float64``: the plain version in float64,

at the VAMPfinal geometry (1024 trials, 10 dB) and the VAMP main geometry
at cap 100 (4096 trials, 8 dB), with the same seeds as ``chip_smoke.py``'s
comparisons there.

    env PYTHONPATH=. python tests/torch_vamp_precision.py

Prints one JSON line per shape and decoder: each mean T, and the mean and
standard error of the per-trial T difference of each from ``kernel``.
Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math

import torch

REPEAT = 16


def _f64(t: torch.Tensor) -> torch.Tensor:
    if t.is_complex():
        return t.to(torch.complex128)
    return t.double() if t.is_floating_point() else t


def _repeat(state, k: int):
    return state._replace(**{
        f: getattr(state, f).repeat((k,) + (1,) * (getattr(state, f).dim()
                                                    - 1))
        for f in state._fields if f != "t"})


def shape(tag: str, algo: str, cfg, B: int, seed: int, ebn0_db: float,
          cap: int, dev) -> dict:
    from amp_sparc_spatialmodulation_tpu_torch.models import (
        montecarlo, vamp, vamp2)
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_vamp, fused_vamp2)
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    mod, kern = (vamp, fused_vamp) if algo == "vamp" else (vamp2, fused_vamp2)
    data = vamp.project if algo == "vamp" else vamp2.whiten
    snr = 10 ** ((ebn0_db + 10 * math.log10(cfg.code_rate)) / 10)
    r = montecarlo.with_svd(algo, montecarlo.generate_realization(
        make_generator(dev, seed), cfg, "sparc", "dense", B, snr))
    yt, s2 = data(r.dec, r.y), (r.dec.s ** 2).contiguous()
    s0 = mod.initial_state(r.y, cfg)
    Vh = r.dec.Vh
    T = {
        "kernel": kern.whole_decode(Vh, s2, yt, s0, r.sigma2, cap, cfg).T,
        "plain": kern.decode_plain(Vh, s2, yt, s0, r.sigma2, cap, cfg).T,
        "plain_large_batch": kern.decode_plain(
            Vh, s2, yt.repeat(REPEAT, 1), _repeat(s0, REPEAT), r.sigma2,
            cap, cfg).T[:B],
        "plain_float64": mod.plain_loop(
            _f64(Vh), _f64(s2), _f64(yt),
            s0._replace(**{f: _f64(getattr(s0, f)) for f in s0._fields
                           if f != "t"}), r.sigma2, cap, cfg).T,
    }
    out = {"shape": tag, "algo": algo, "B": B, "cap": cap}
    for name, t in T.items():
        out[f"mean_T_{name}"] = float(t.double().mean())
        if name != "kernel":
            d = (t - T["kernel"]).double()
            out[f"dmean_T_{name}_minus_kernel"] = [
                float(d.mean()), float(d.std()) / math.sqrt(B)]
    return out


def main() -> int:
    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(chip_smoke.nvidia_smi(), flush=True)
    final, main100 = (chip_smoke.vampfinal_config(),
                      chip_smoke.vamp_main_config(iterations=100))
    for algo in ("vamp", "vamp2"):
        print(json.dumps(shape("vampfinal", algo, final, 1024, 28, 10.0, 100,
                               dev)), flush=True)
        print(json.dumps(shape("vamp_main_cap100", algo, main100, 4096, 27,
                               8.0, 100, dev)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
