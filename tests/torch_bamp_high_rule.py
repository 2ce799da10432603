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

With ``--route tiled`` the same four decodes of the frame-tiled iteration
K5 (its HIGH and HIGHEST instances, the plain HIGH step with exact sums or
one pass, each driven through ``bamp.plane_loop``) against K5's plain HIGH
version (``fused_bamp_tiled.decode_plain(..., 'high')``) at the shapes of
``kernels_tiled_high`` (same seeds): the small geometries (cap 30), the
massive geometry at the given converging points (2048 trials, cap 100) and
the phase-2 shape (the trials still active after 40 HIGH iterations at
18 dB, gathered, to cap 300); the control there is ``chip_smoke.
k5_high_control``'s: one iteration from the state after two plain HIGH
iterations, its median |d z_re|, |d xmap_re| and |d u|.

    env PYTHONPATH=. python tests/torch_bamp_high_rule.py [--qpsk-db 7 9]
    env PYTHONPATH=. python tests/torch_bamp_high_rule.py --route tiled \
        [--massive-db 10]
    env PYTHONPATH=. python tests/torch_bamp_high_rule.py --precision default \
        [--route tiled]
    env PYTHONPATH=. python tests/torch_bamp_high_rule.py --lin 40 \
        [--precision default | --split]

With ``--precision default`` the readings of the DEFAULT rule (one bf16
pass, ``chip_smoke.py``'s ``kernels_bamp_default`` and
``kernels_tiled_default``): every decode of the same trials, drawn with
``y`` at DEFAULT, against the plain DEFAULT version, the four decodes being
``kernel_default`` (the DEFAULT instance under test), ``plain_exact`` (the
plain DEFAULT version with its bf16 products summed in float64 and rounded
once: two correct DEFAULT decodes), ``kernel_high`` and ``kernel_highest``
(the instances of the other precisions: wrong products); the control is
one iteration from the state after two plain DEFAULT iterations on both
routes, its median |d z|, |d xmap| and |d u|.

With ``--split`` the readings of the split forms' rule (K1 with
``AMP_KERNEL_XMAP_PRECISION``, ``chip_smoke.py``'s ``kernels_bamp_xmap``):
for each of the six (variance, xmap) precision pairs, drawn with ``y`` at
the variance chain's precision, every decode against the plain split
version (``bamp.plain_loop_split``): ``kernel_split`` (the split instance
under test), ``plain_exact`` (the plain split version with each chain's
products summed in float64 and rounded once: two correct split decodes)
and ``kernel_form`` (the form at the variance chain's precision, the
variable unset: a wrong xmap chain); the control as at DEFAULT.

    env PYTHONPATH=. python tests/torch_bamp_high_rule.py --split \
        [--pairs highest:high,highest:default]

With ``--lin L`` the same readings (at ``--precision``, or with
``--split`` for each pair) at one shape only: the OOK flagship's
dimensions with L column blocks at chip_smoke's ``k1_wide_checks`` shape
(``WIDE_B`` trials, cap 12, 8 dB, seed 301), K1 past 32 column blocks.
With ``--cluster NAME`` the same at one of chip_smoke's
``CLUSTER_SHAPES`` (``scamp_dims``, ``qpsk_lin48``: ``CLUSTER_B``
trials, cap ``CLUSTER_CAP``, K1's cluster form), at its Eb/N0 or at each
of ``--db``; ``--precision highest`` there reads K1's HIGHEST form
(``kernel_highest`` against the plain version, and its mean T).

    env PYTHONPATH=. python tests/torch_bamp_high_rule.py \
        --cluster scamp_dims [--db 14 16] [--precision default | --split]

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


def dot1_exact(x, a):
    """``precision.dot1`` summed in float64 and rounded once."""
    return (x.to(torch.bfloat16).double()
            @ a.to(torch.bfloat16).double()).float()


def dot_one_pass(x, a):
    """The hi x hi pass of ``precision.dot3`` alone."""
    from amp_sparc_spatialmodulation_tpu_torch.ops import precision as prec
    xh, _ = prec.split_bf16(x)
    ah, _ = prec.split_bf16(a)
    return xh.float() @ ah.float()


def dot_exact(precision):
    """The real product of a chain at ``precision`` summed in float64 and
    rounded once."""
    if precision == "high":
        return dot3_exact
    if precision == "default":
        return dot1_exact
    return lambda x, a: (x.double() @ a.double()).float()


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
                    sk, sp, agree & converged),
                stopped_within_1e4=chip_smoke.stopped_share(sk, sp))


def shape(tag, cfg, B, cap, ebn0_db, seed, dev, precision="high"):
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    r = montecarlo.generate_realization(
        make_generator(dev, seed), cfg, "sparc", "banded", B,
        chip_smoke.snr_of(cfg, ebn0_db), precision)
    op, y, s2 = r.A, r.y, r.sigma2
    s0 = bamp.initial_state(y, cfg.N, s2)
    if precision == "default":
        shape_default(tag, cfg, B, cap, ebn0_db, op, y, s2, s0)
        return
    if precision == "highest":
        sk = fused_bamp.whole_decode(op, s0, y, s2, cap, cfg)
        sp = fused_bamp.decode_plain(op, s0, y, s2, cap, cfg)
        print(json.dumps({"shape": tag, "decode": "kernel_highest", "B": B,
                          "cap": cap, "ebn0_db": ebn0_db,
                          **reading(sk, sp)}), flush=True)
        return
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


def shape_default(tag, cfg, B, cap, ebn0_db, op, y, s2, s0):
    """The DEFAULT readings of :func:`shape` (module docstring)."""
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp

    forms = {
        "kernel_default": lambda s, c: fused_bamp.whole_decode(
            op, s, y, s2, c, cfg, "default"),
        "plain_exact": lambda s, c: bamp.plain_loop_high(
            op, s, y, s2, c, cfg, dot=dot1_exact),
        "kernel_high": lambda s, c: fused_bamp.whole_decode(
            op, s, y, s2, c, cfg, "high"),
        "kernel_highest": lambda s, c: fused_bamp.whole_decode(
            op, s, y, s2, c, cfg),
    }
    sp = fused_bamp.decode_plain_default(op, s0, y, s2, cap, cfg)
    ps = fused_bamp.decode_plain_default(op, s0, y, s2, 2, cfg)
    one = fused_bamp.decode_plain_default(op, ps, y, s2, 3, cfg)
    for name, run in forms.items():
        sk = run(s0, cap)
        gap = chip_smoke.vamp_gap(run(ps, 3), one)
        print(json.dumps({"shape": tag, "decode": name, "B": B, "cap": cap,
                          "ebn0_db": ebn0_db, **reading(sk, sp),
                          **{f"control_{k}": gap[k] for k in (
                              "z_p50", "xmap_p50", "u_p50")}}),
              flush=True)
        del sk
    del sp, ps, one
    torch.cuda.empty_cache()


def shape_split(tag, cfg, B, cap, ebn0_db, seed, dev, pairs):
    """The split readings (module docstring) of each (variance, xmap) pair
    of ``pairs`` at one shape."""
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    for v, x in pairs:
        r = montecarlo.generate_realization(
            make_generator(dev, seed), cfg, "sparc", "banded", B,
            chip_smoke.snr_of(cfg, ebn0_db), v)
        op, y, s2 = r.A, r.y, r.sigma2
        s0 = bamp.initial_state(y, cfg.N, s2)
        forms = {
            "kernel_split": lambda s, c: fused_bamp.whole_decode(
                op, s, y, s2, c, cfg, v, x),
            "plain_exact": lambda s, c: bamp.plain_loop_high(
                op, s, y, s2, c, cfg, dot=dot_exact(v), dot_x=dot_exact(x)),
            "kernel_form": lambda s, c: fused_bamp.whole_decode(
                op, s, y, s2, c, cfg, v),
        }
        plain = lambda s, c: fused_bamp.decode_plain_split(
            op, s, y, s2, c, cfg, v, x)
        sp = plain(s0, cap)
        ps = plain(s0, 2)
        one = plain(ps, 3)
        for name, run in forms.items():
            sk = run(s0, cap)
            gap = chip_smoke.vamp_gap(run(ps, 3), one)
            print(json.dumps({"shape": tag, "pair": f"{v}:{x}",
                              "decode": name, "B": B, "cap": cap,
                              "ebn0_db": ebn0_db, **reading(sk, sp),
                              **{f"control_{k}": gap[k] for k in (
                                  "z_p50", "xmap_p50", "u_p50")}}),
                  flush=True)
            del sk
        del sp, ps, one, r, op, y, s0
        torch.cuda.empty_cache()


def tiled_shape(tag, cfg, r, s0, cap, dev, y=None, precision="high"):
    """The four K5 decodes of ``tiled`` (module docstring) from ``s0`` to
    ``cap`` against the plain HIGH version, and each one's control."""
    from functools import partial

    from amp_sparc_spatialmodulation_tpu_torch.models import bamp
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_bamp_tiled as kern)

    op, s2 = r.A, r.sigma2
    y = r.y if y is None else y
    taps = bamp.gauss_taps(op)
    den = bamp.make_denoiser(cfg, dev)

    def plain(dot):
        linear = partial(bamp.linear_step_high, taps=taps, real_x=True,
                         dot=dot)
        return lambda o, ps, yr, yi, sig, c: bamp.step_planes(
            o, ps, yr, yi, sig, den, linear)

    steps = {"kernel_high": partial(kern.iteration, precision="high"),
             "plain_exact": plain(dot3_exact),
             "kernel_highest": kern.iteration,
             "plain_one_pass": plain(dot_one_pass)}
    if precision == "default":
        steps = {"kernel_default": partial(kern.iteration,
                                           precision="default"),
                 "plain_exact": plain(dot1_exact),
                 "kernel_high": steps["kernel_high"],
                 "kernel_highest": kern.iteration}
    sp = kern.decode_plain(op, s0, y, s2, cap, cfg, precision)
    ps = bamp.to_planes(kern.decode_plain(
        op, s0, y, s2, s0.t + chip_smoke.K5_HIGH_PRESTEPS, cfg, precision))
    y_re, y_im = y.real.contiguous(), y.imag.contiguous()
    one = kern.iteration_plain(op, ps, y_re, y_im, s2, cfg, precision)
    for name, step in steps.items():
        sk = bamp.plane_loop(step, op, s0, y, s2, cap, cfg)
        gap = chip_smoke.iter_gap(step(op, ps, y_re, y_im, s2, cfg), one,
                                  ps.active)
        print(json.dumps({"shape": tag, "decode": name,
                          "B": int(y.shape[0]), "cap": cap,
                          **reading(sk, sp),
                          **{f"control_{k}": gap[k] for k in (
                              "z_re_p50", "xmap_re_p50", "u_p50")}}),
              flush=True)
        del sk
    del sp, ps, one
    torch.cuda.empty_cache()


def tiled(dev, massive_db, precision="high") -> None:
    """The readings of ``--route tiled`` (module docstring)."""
    import dataclasses

    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_bamp_tiled as kern)
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    def realization(cfg, B, seed, snr):
        r = montecarlo.generate_realization(make_generator(dev, seed), cfg,
                                            "sparc", "banded", B, snr,
                                            precision)
        return r, bamp.initial_state(r.y, cfg.N, r.sigma2)

    cases = [("ook_8_3", {}, chip_smoke.SMALL_B),
             ("ook_12_5", dict(Lin=12, Lh=5), chip_smoke.SMALL_B),
             ("bpsk_8_3", dict(alphabet="BPSK"), chip_smoke.SMALL_B),
             ("ook_ragged_37", {}, 37)]
    for i, (name, kw, B) in enumerate(cases):
        cfg = chip_smoke.tiled_small_config(**kw)
        r, s0 = realization(cfg, B, 400 + i, 10 ** 0.8)
        tiled_shape(name, cfg, r, s0, cfg.N_Layers, dev,
                    precision=precision)
    mcfg = dataclasses.replace(chip_smoke.massive_main_config(),
                               iterations=chip_smoke.MASSIVE_HIGH_CAP)
    for db in massive_db:
        r, s0 = realization(mcfg, chip_smoke.MASSIVE_RES, 44,
                            chip_smoke.snr_of(mcfg, db))
        tiled_shape(f"massive_{db:g}db", mcfg, r, s0, mcfg.N_Layers, dev,
                    precision=precision)
        del r, s0
    pcfg = chip_smoke.massive_main_config()
    r, s0 = realization(pcfg, chip_smoke.MASSIVE_RES, 43,
                        chip_smoke.snr_of(pcfg, chip_smoke.MASSIVE_EBN0_DB))
    s1 = bamp.plane_loop(lambda *a: kern.iteration(*a, precision=precision),
                         r.A, s0, r.y, r.sigma2, chip_smoke.MASSIVE_K1, pcfg)
    idx = torch.nonzero(s1.active).flatten()
    tiled_shape(f"phase2_{int(idx.numel())}", pcfg, r,
                montecarlo.state_take_trials(s1, idx),
                chip_smoke.MASSIVE_CAP, dev, y=r.y[idx], precision=precision)


def main() -> None:
    from amp_sparc_spatialmodulation_tpu_torch.config import (
        flagship_bamp_ook, flagship_bamp_qpsk)

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--route", choices=["whole", "tiled"], default="whole",
                    help="K1 (whole) or K5 (tiled)")
    ap.add_argument("--qpsk-db", type=float, nargs="*", default=[7.0],
                    help="converging QPSK points at cap 100 (dB)")
    ap.add_argument("--massive-db", type=float, nargs="*",
                    default=[chip_smoke.MASSIVE_CONVERGING_DB],
                    help="--route tiled: massive points at cap 100 (dB)")
    ap.add_argument("--precision", choices=["highest", "high", "default"],
                    default="high", help="the rule of the HIGH or the "
                    "DEFAULT instances (module docstring)")
    ap.add_argument("--split", action="store_true",
                    help="the rule of the split forms (module docstring)")
    ap.add_argument("--lin", type=int, default=None,
                    help="the readings at the OOK flagship's dimensions "
                    "with this many column blocks instead (chip_smoke's "
                    "k1_wide_checks: WIDE_B trials, cap 12, 8 dB, seed "
                    "301), at --precision or, with --split, each pair")
    ap.add_argument("--cluster", choices=sorted(chip_smoke.CLUSTER_SHAPES),
                    default=None, help="the readings at this cluster "
                    "shape of chip_smoke's k1_cluster_checks instead")
    ap.add_argument("--db", type=float, nargs="*", default=None,
                    help="--cluster: Eb/N0 points (dB) instead of the "
                    "shape's own")
    ap.add_argument("--pairs", default=",".join(
        f"{v}:{x}" for v, x in chip_smoke.XMAP_PAIRS),
        help="--split: variance:xmap precision pairs")
    args = ap.parse_args()
    dev = torch.device("cuda")
    print(chip_smoke.nvidia_smi(), flush=True)
    if args.cluster is not None:
        ebn0, seed = chip_smoke.CLUSTER_SHAPES[args.cluster]
        cfg = chip_smoke.cluster_config(args.cluster)
        for db in args.db or [ebn0]:
            at = (f"{args.cluster}_{db:g}db", cfg, chip_smoke.CLUSTER_B,
                  chip_smoke.CLUSTER_CAP, db, seed, dev)
            if args.split:
                shape_split(*at, [tuple(p.split(":"))
                                  for p in args.pairs.split(",")])
            else:
                shape(*at, args.precision)
        return
    if args.lin is not None:
        import dataclasses
        wide = (f"ook_lin{args.lin}",
                dataclasses.replace(flagship_bamp_ook(), Lin=args.lin),
                chip_smoke.WIDE_B, chip_smoke.K1, chip_smoke.EBN0_DB, 301,
                dev)
        if args.split:
            shape_split(*wide, [tuple(p.split(":"))
                                for p in args.pairs.split(",")])
        else:
            shape(*wide, args.precision)
        return
    if args.split:
        pairs = [tuple(p.split(":")) for p in args.pairs.split(",")]
        shape_split("ook_phase1", flagship_bamp_ook(), chip_smoke.RES,
                    chip_smoke.K1, chip_smoke.EBN0_DB, 41, dev, pairs)
        shape_split("qpsk_cap100", flagship_bamp_qpsk(),
                    chip_smoke.FLAGSHIP_B, 100, chip_smoke.BAMP_HIGH_EBN0_DB,
                    42, dev, pairs)
        return
    if args.route == "tiled":
        tiled(dev, args.massive_db, args.precision)
        return
    shape("ook_phase1", flagship_bamp_ook(), chip_smoke.RES, chip_smoke.K1,
          chip_smoke.EBN0_DB, 41, dev, args.precision)
    for db in [chip_smoke.BAMP_HIGH_EBN0_DB] + list(args.qpsk_db):
        shape(f"qpsk_cap100_{db:g}db", flagship_bamp_qpsk(),
              chip_smoke.FLAGSHIP_B, 100, db, 42, dev, args.precision)


if __name__ == "__main__":
    main()
