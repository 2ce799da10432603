"""Command-line sweep front end of the PyTorch port.

    python -m amp_sparc_spatialmodulation_tpu_torch.cli sweep \\
        --algo bamp --alphabet OOK --mode segmented --Nt 128 --Na 8 \\
        --Nr 24 --Lin 20 --Lh 3 --trunc tail --profile uniform \\
        --epochs 262144 --start 6 --final 10 --step 0.5 --res 65536 \\
        --two-phase 12

    python -m amp_sparc_spatialmodulation_tpu_torch.cli sweep \\
        --algo scamp --alphabet OOK --mode sparc --Nt 128 --Na 8 \\
        --Nr 24 --Lin 20 --Lh 3 --trunc tail --profile uniform \\
        --epochs 262144 --start 6 --final 10 --step 0.5 --res 65536 \\
        --two-phase 8

    python -m amp_sparc_spatialmodulation_tpu_torch.cli sweep \\
        --algo vamp --alphabet OOK --mode segmented --Nt 128 --Na 8 \\
        --Nr 24 --Lin 20 --Lh 3 --trunc tail --profile uniform \\
        --iterations 10 --epochs 262144 --start 6 --final 10 --res 65536

VAMP and vamp2 (``--algo vamp2``) decode on the dense channel's SVD;
``--precision high`` runs their products in three-pass bf16 (the tensor
cores' form of kernels K3 and K4), ``--precision auto`` only where the
previous point's mean T pinned at the cap, and ``--chans C`` rounds the
realizations per point up to a multiple of C, as the JAX package does.  On
the H100 the HIGH form decodes in about two thirds of HIGHEST's time, so
points whose trials run to the cap go faster at HIGH (``PERF.md`` §5,
§6).  ``--precision high|auto`` also covers BAMP, whose whole-decode
kernel K1 and frame-tiled kernel K5 (the massive geometry, e.g. ``--Nt
1344 --Na 84 --Nr 73 --Lin 32 --Lh 6``) have HIGH forms, and SCAMP, whose
kernel K2 keeps HIGHEST inside (JAX's has no precision; at HIGH only ``y =
x A^T`` changes); every plain loop (a dense ``--operator``, the
real-channel mode, a geometry no kernel fits, ``--use-pallas false``)
runs its products at HIGH, as the JAX package's XLA decodes do.
``--precision default`` is the one-pass bf16 product (the TPU's
``Precision.DEFAULT``) in the same places: ``y``, the DEFAULT forms of K1,
K3, K4 and K5, K2 and the per-iteration kernel K6 at HIGHEST, every plain
loop at DEFAULT; ``auto`` never picks it.  On an H100 it did not pin T at
the cap at the flagship BAMP OOK 8 dB point (mean T 15.0 against HIGHEST's
11.4, 6.4% of trials at the cap, FER unchanged) and stopped VAMP's trials
near T = 12 at cap 100 (``PERF.md`` §6).
``--use-pallas auto|true|false`` is the JAX package's knob: ``auto`` takes
the kernels where the decoders' routes take them, ``false`` the plain
loops (an A/B against the kernels on the card), ``true`` raises where no
kernel covers the config.  ``--two-phase auto`` probes each point with
``min(2048, res)`` trials for its k1 (``AMP_AUTO_PROBE=0`` takes the
previous point's mean T instead).  Runs on the CUDA card
unless ``--device cpu`` is given.

``--shard`` splits each point's realizations over the ranks that
``torch.distributed.run`` starts, one card each (NCCL), or CPU processes
under gloo with ``--device cpu``; ``--model-axis K`` also splits each
realization's frame over K ranks (``parallel/``).  The ``--`` keeps
``torch.distributed.run``'s parser off the sweep's options (torch 2.11's
takes ``--start`` for an abbreviation of its ``--start-method``)::

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m amp_sparc_spatialmodulation_tpu_torch.cli -- sweep --shard \\
        --algo bamp --alphabet OOK --mode segmented --Nt 128 --Na 8 \\
        --Nr 24 --Lin 20 --Lh 3 --trunc tail --profile uniform \\
        --epochs 262144 --start 6 --final 10 --res 65536 --two-phase 12

``sweep --plot`` rebuilds the waterfall and iteration plots after the
sweep; ``plot`` rebuilds them from the artifacts alone (matplotlib, Agg
backend; no device)::

    python -m amp_sparc_spatialmodulation_tpu_torch.cli plot \\
        --algo-dir BAMP --alphabet OOK --mode segmented --Nt 128 --Na 8 \\
        --Nr 24 --Lin 20 --Lh 3 --trunc tail --profile uniform

``capacity`` writes the AWGN capacity, the water-filling capacity and the
constellation-constrained MI per Eb/N0 as CSV under
``<out>/Capacity/<config>/`` (``models/capacity.py``; channels, Gram
eigenvalues and MI on the device, water-filling on the host)::

    python -m amp_sparc_spatialmodulation_tpu_torch.cli capacity \\
        --alphabet OOK --mode segmented --Nt 128 --Na 8 --Nr 24 --Lin 20 \\
        --Lh 3 --trunc tail --profile uniform --epochs 100

``sparc-trial`` decodes one SPARC frame, optionally with exponentially
decaying power allocation, by SCAMP, BAMP or both on the same draw
(``models/sparc_tools.py``; on the card through kernels K2 and K1 at a
batch of one)::

    python -m amp_sparc_spatialmodulation_tpu_torch.cli sparc-trial \\
        --alphabet OOK --mode sparc --Nt 128 --Na 8 --Nr 24 --Lin 20 \\
        --Lh 3 --trunc tail --profile uniform --ebn0 6 --sparc-algo both

``capacity``, ``sparc-trial`` and ``sweep`` run on the CUDA card unless
``--device cpu`` is given.  ``bench`` waits for the port's benchmark
(ROADMAP.md Queue 1 item 1).
"""
from __future__ import annotations

import argparse
import gc
import sys


def _add_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--Nt", type=int, required=True)
    p.add_argument("--Na", type=int, required=True)
    p.add_argument("--Nr", type=int, required=True)
    p.add_argument("--Lin", type=int, required=True)
    p.add_argument("--Lh", type=int, required=True)
    p.add_argument("--mode", default="segmented",
                   choices=["random", "segmented", "sparc"])
    p.add_argument("--alphabet", default="OOK")
    p.add_argument("--profile", default="uniform",
                   choices=["uniform", "exponential"])
    p.add_argument("--trunc", default="tail",
                   choices=["trunc", "tail", "cyclic"])
    p.add_argument("--iterations", type=int, default=100)


def _build_config(args):
    from .config import Config

    return Config(Nt=args.Nt, Na=args.Na, Nr=args.Nr, Lin=args.Lin,
                  Lh=args.Lh, mode=args.mode, alphabet=args.alphabet,
                  profile=args.profile, trunc=args.trunc,
                  iterations=args.iterations)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m amp_sparc_spatialmodulation_tpu_torch.cli",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    sweep = sub.add_parser("sweep", help="run a Monte-Carlo Eb/N0 sweep")
    _add_config_args(sweep)
    sweep.add_argument("--algo", default="bamp",
                       choices=["bamp", "vamp", "vamp2", "scamp"])
    sweep.add_argument("--channel", default="sparc",
                       choices=["sparc", "toeplitz", "iid"])
    sweep.add_argument("--operator", default="auto",
                       choices=["auto", "dense", "banded"])
    sweep.add_argument("--epochs", type=int, default=100)
    sweep.add_argument("--start", type=float, default=None)
    sweep.add_argument("--final", type=float, default=None)
    sweep.add_argument("--step", type=float, default=1.0)
    sweep.add_argument("--res", type=int, default=1,
                       help="trials per channel realization")
    sweep.add_argument("--seed", type=int, default=0)
    sweep.add_argument("--out", default="Simulations")
    sweep.add_argument("--algo-dir", default=None)
    sweep.add_argument("--resume", action="store_true")
    sweep.add_argument("--two-phase", default=None, metavar="K1",
                       type=lambda s: s if s == "auto" else int(s),
                       help="continuation decoding: cap phase 1 at K1 "
                            "iterations and finish the unconverged trials "
                            "separately; 'auto' picks K1 from a probe of "
                            "the point's mean T (AMP_AUTO_PROBE=0: from the "
                            "previous point's)")
    sweep.add_argument("--estimate-phi", action="store_true",
                       help="SCAMP: empirical residual variance per output "
                            "block (estSCAMP)")
    sweep.add_argument("--chans", type=int, default=1,
                       help="realizations per single-phase point round "
                            "up to a multiple of C, as in the JAX package "
                            "(which decodes C VAMP realizations per launch); "
                            "here they run one after another")
    sweep.add_argument("--precision", default="highest",
                       choices=["highest", "high", "default", "auto"],
                       help="product precision: 'highest' (FP32, the "
                            "reference's trajectories) | 'high' (three-pass "
                            "bf16 on the tensor cores; where trials stop "
                            "early its error sits at the 1e-5 allclose "
                            "tolerance and inflates T) | 'default' "
                            "(one-pass bf16; on an H100 the flagship BAMP "
                            "OOK 8 dB point ran mean T 15.0 against "
                            "HIGHEST's 11.4, 6.4%% of trials at the cap, "
                            "FER unchanged, and VAMP's trials stopped near "
                            "T 12 where HIGH ran them to 100, a different "
                            "decode: PERF.md section 6) | 'auto' (per "
                            "point: 'high' when the previous point's mean T "
                            "pinned at the iteration cap, else 'highest')")
    sweep.add_argument("--use-pallas", default="auto",
                       choices=["auto", "true", "false"],
                       help="the decode kernels: 'auto' where the decoders' "
                            "routes take them | 'true' (raise where no "
                            "kernel covers the config) | 'false' (the plain "
                            "PyTorch loops)")
    sweep.add_argument("--device", default=None,
                       help="torch device (default: the CUDA card)")
    sweep.add_argument("--shard", action="store_true",
                       help="split the realizations over every rank of "
                            "torch.distributed.run (NCCL on the cards, "
                            "gloo with --device cpu)")
    sweep.add_argument("--model-axis", type=int, default=1,
                       help="ranks each realization's frame is split over "
                            "(bamp, scamp, vamp; implies --shard)")

    sweep.add_argument("--plot", action="store_true",
                       help="rebuild the plots from the artifacts after "
                            "the sweep")

    plot = sub.add_parser("plot", help="rebuild plots from artifacts")
    _add_config_args(plot)
    plot.add_argument("--algo-dir", required=True)
    plot.add_argument("--out", default="Simulations")

    cap = sub.add_parser("capacity", help="capacity / mutual information")
    _add_config_args(cap)
    cap.add_argument("--epochs", type=int, default=100)
    cap.add_argument("--start", type=float, default=None)
    cap.add_argument("--final", type=float, default=None)
    cap.add_argument("--step", type=float, default=1.0)
    cap.add_argument("--out", default="Simulations")
    cap.add_argument("--device", default=None,
                     help="torch device (default: the CUDA card)")

    sparc = sub.add_parser("sparc-trial",
                           help="single-trial SPARC experiment with "
                                "optional power allocation (sparc.py twin)")
    _add_config_args(sparc)
    sparc.add_argument("--ebn0", type=float, required=True)
    sparc.add_argument("--sparc-algo", default="scamp",
                       choices=["scamp", "bamp", "both"],
                       help="'both' decodes the same draw with SCAMP and "
                            "BAMP head-to-head (sparc.py:453-474)")
    sparc.add_argument("--power-allocation", action="store_true",
                       help="exponentially-decaying power allocation")
    sparc.add_argument("--estimate-phi", action="store_true")
    sparc.add_argument("--seed", type=int, default=0)
    sparc.add_argument("--device", default=None,
                       help="torch device (default: the CUDA card)")

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--"]:
        # torch.distributed.run passes on the "--" that ends its own options
        argv = argv[1:]
    args = parser.parse_args(argv)
    cfg = _build_config(args)

    if args.cmd == "sparc-trial":
        _sparc_trial(cfg, args)
        return 0
    if args.cmd == "plot":
        _plot(cfg, args.algo_dir, args.out)
        return 0
    if args.cmd == "capacity":
        from .models.capacity import InfoTheory

        InfoTheory(cfg, out_root=args.out, device=args.device).simulate(
            epochs=args.epochs, start=args.start, final=args.final,
            step=args.step)
        return 0

    kw = dict(algo=args.algo, channel_kind=args.channel, out_root=args.out,
              algo_dir=args.algo_dir, seed=args.seed,
              operator_form=args.operator, two_phase=args.two_phase,
              estimate_phi=args.estimate_phi, precision=args.precision,
              chans_per_batch=args.chans,
              use_pallas=(args.use_pallas if args.use_pallas == "auto"
                          else args.use_pallas == "true"))
    if not (args.shard or args.model_axis > 1):
        from .models.montecarlo import Simulator

        sim = Simulator(cfg, device=args.device, **kw)
        sim.simulate(epochs=args.epochs, start=args.start, final=args.final,
                     step=args.step, res=args.res, resume=args.resume)
        if args.plot:
            _plot(cfg, _algo_dir(args), args.out)
        return 0

    import torch.distributed as dist

    from .parallel.mesh import initialize_distributed

    dev = initialize_distributed(device=args.device)
    try:
        _sharded_sweep(cfg, args, dev, kw)
    finally:
        dist.destroy_process_group()
        # the mesh and its groups are gone with the call's frame; collect
        # any cycle now, not in the interpreter's teardown, where gloo can
        # abort
        gc.collect()
    return 0


def _sharded_sweep(cfg, args, dev, kw) -> None:
    from .parallel.mesh import make_mesh
    from .parallel.sweep import ShardedSimulator

    mesh = make_mesh(model=args.model_axis, device_type=dev.type)
    sim = ShardedSimulator(cfg, mesh=mesh, device=dev, **kw)
    sim.simulate(epochs=args.epochs, start=args.start, final=args.final,
                 step=args.step, res=args.res, resume=args.resume)
    if args.plot and sim.writes_artifacts:
        _plot(cfg, _algo_dir(args), args.out)


def _algo_dir(args) -> str:
    from .models.montecarlo import ALGO_DIRS

    return args.algo_dir or ALGO_DIRS[args.algo]


def _plot(cfg, algo_dir, out_root) -> None:
    """Rebuild both plots of ``out_root/algo_dir/<config>`` and print their
    paths."""
    from .utils.plotting import Plotter

    p = Plotter(cfg, algo_dir, out_root=out_root)
    print(p.plot_metrics())
    print(p.plot_iter())


def _sparc_trial(cfg, args) -> None:
    """One single-trial SPARC experiment, printed as the JAX package's CLI
    prints it."""
    from .models import sparc_tools as st

    pa = None
    if args.power_allocation:
        _, snr = st.trial_point(cfg, args.ebn0)
        pa = st.exp_power_allocation(snr, cfg.Lin)

    def show(res, label=""):
        print(({"algo": label} if label else {})
              | {"ser": res.ser, "fer": res.fer,
                 "nmse": round(res.nmse, 6), "C": round(res.C, 3),
                 "rate_nats": round(res.rate, 4)})

    if args.sparc_algo == "both":
        both = st.compare_single_trial(cfg, args.ebn0, power_allocation=pa,
                                       estimate_phi=args.estimate_phi,
                                       seed=args.seed, device=args.device)
        for name, res in both.items():
            show(res, name)
    else:
        show(st.run_single_trial(cfg, args.ebn0, algo=args.sparc_algo,
                                 power_allocation=pa,
                                 estimate_phi=args.estimate_phi,
                                 seed=args.seed, device=args.device))


if __name__ == "__main__":
    sys.exit(main())
