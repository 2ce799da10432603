"""Where the limits of ``chip_smoke.py``'s HIGH rule for K1 lie, on the card.

Two correct HIGH decodes part on the T of a few percent of the trials
where trials stop by the allclose test: the three-pass product's error sits
near the test's 1e-5 tolerance, so the FP32 order of the sums decides some
stops.  ``chip_smoke.py`` therefore holds K1's HIGH instance to its plain
HIGH version (``bamp.plain_loop_high``) with a T-agreement share, a bound
on |d mean T| and the one-iteration control.  This script reads each of
those statistics for four decodes of the same trials against the plain
HIGH version:

* ``kernel_high``: K1's HIGH instance (the decode under test);
* ``plain_exact``: the plain HIGH version with its three bf16 passes summed
  in float64 and rounded once (two correct HIGH decodes: the lower
  reading, which the limits must let pass);
* ``kernel_highest``: K1's HIGHEST instance (FP32 products: the upper
  reading, a HIGH launch that computed at the wrong precision);
* ``plain_one_pass``: the plain HIGH version with the hi x lo and lo x hi
  pass left out (a HIGH engine that lost a pass),

at the shapes of ``chip_smoke.py``'s ``kernels_bamp_high`` (same seeds):
the OOK flagship at its phase-1 shape (65536 trials, cap 12, 8 dB) and the
QPSK flagship at cap 100 (4096 trials) at 5 dB and at the given converging
points.

    env PYTHONPATH=. python tests/torch_bamp_high_rule.py [--qpsk-db 7 9]

Prints one JSON line per shape and decode: T agreement, mean T of both,
|d mean T|, the trials that converged in both, the largest state error on
those whose T agrees, and the control's median |d xmap| after one
iteration.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json

import torch

import chip_smoke


def dot3_exact(x, a):
    """``precision.dot3`` with its three bf16 passes summed in float64 and
    rounded once."""
    from amp_sparc_spatialmodulation_tpu_torch.ops import precision as prec
    xh, xl = (t.double() for t in prec.split_bf16(x))
    ah, al = (t.double() for t in prec.split_bf16(a))
    return (xh @ ah + (xh @ al + xl @ ah)).float()


def dot_one_pass(x, a):
    """The hi x hi pass of ``precision.dot3`` alone."""
    from amp_sparc_spatialmodulation_tpu_torch.ops import precision as prec
    xh, _ = prec.split_bf16(x)
    ah, _ = prec.split_bf16(a)
    return xh.float() @ ah.float()


def reading(sk, sp) -> dict:
    """``chip_smoke.compare``'s statistics of ``sk`` against ``sp``."""
    agree = sk.T == sp.T
    converged = ~(sk.active | sp.active)
    mean_k, mean_p = float(sk.T.float().mean()), float(sp.T.float().mean())
    return dict(T_agree_fraction=float(agree.float().mean()),
                mean_T=mean_k, mean_T_plain_high=mean_p,
                abs_dmean_T=abs(mean_k - mean_p),
                converged_both=int(converged.sum()),
                max_abs_err_converged=chip_smoke.state_err(
                    sk, sp, agree & converged))


def shape(tag, cfg, B, cap, ebn0_db, seed, dev):
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    r = montecarlo.generate_realization(
        make_generator(dev, seed), cfg, "sparc", "banded", B,
        chip_smoke.snr_of(cfg, ebn0_db), "high")
    op, y, s2 = r.A, r.y, r.sigma2
    s0 = bamp.initial_state(y, cfg.N, s2)
    forms = {
        "kernel_high": lambda c: fused_bamp.whole_decode(
            op, s0, y, s2, c, cfg, "high"),
        "plain_exact": lambda c: bamp.plain_loop_high(
            op, s0, y, s2, c, cfg, dot=dot3_exact),
        "kernel_highest": lambda c: fused_bamp.whole_decode(
            op, s0, y, s2, c, cfg),
        "plain_one_pass": lambda c: bamp.plain_loop_high(
            op, s0, y, s2, c, cfg, dot=dot_one_pass),
    }
    sp = fused_bamp.decode_plain_high(op, s0, y, s2, cap, cfg)
    one = fused_bamp.decode_plain_high(op, s0, y, s2, 1, cfg)
    for name, run in forms.items():
        sk = run(cap)
        control = chip_smoke.vamp_gap(run(1), one)
        print(json.dumps({"shape": tag, "decode": name, "B": B, "cap": cap,
                          "ebn0_db": ebn0_db, **reading(sk, sp),
                          "control_xmap_p50": control["xmap_p50"]}),
              flush=True)
        del sk
    del sp, one, r, op, y, s0
    torch.cuda.empty_cache()


def main() -> None:
    from amp_sparc_spatialmodulation_tpu_torch.config import (
        flagship_bamp_ook, flagship_bamp_qpsk)

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--qpsk-db", type=float, nargs="*", default=[7.0],
                    help="converging QPSK points at cap 100 (dB)")
    args = ap.parse_args()
    dev = torch.device("cuda")
    print(chip_smoke.nvidia_smi(), flush=True)
    shape("ook_phase1", flagship_bamp_ook(), chip_smoke.RES, chip_smoke.K1,
          chip_smoke.EBN0_DB, 41, dev)
    for db in [chip_smoke.BAMP_HIGH_EBN0_DB] + list(args.qpsk_db):
        shape(f"qpsk_cap100_{db:g}db", flagship_bamp_qpsk(),
              chip_smoke.FLAGSHIP_B, 100, db, 42, dev)


if __name__ == "__main__":
    main()
