"""The sharded paths on several cards at once, under NCCL.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        tests/torch_parallel_cards.py [--out FILE] [--device cpu --small]

One rank per card.  chip_smoke.py runs the sharded paths on one card, a
world of one rank, where every exchange is the identity; this script is
where NCCL's collectives run between cards:

1. ``ShardedSimulator`` on a (world, 1) mesh at the BAMP flagship point
   (8 dB, k1 = 12, ``--realizations`` x 65536, K1 on every rank), then the
   unsharded ``Simulator`` on rank 0 alone over the same realizations:
   FER, BER and mean T must be identical; both runs' trials/s and their
   ratio are printed (the weak-scaling reading of the trials axis).
2. The frame-split decoders on a (1, world) mesh, each against the
   single-card plain loop on rank 0, on the same realization, under
   chip_smoke.py's ``compare`` rule: halo BAMP at the flagship geometry
   (4096 trials), at the massive-MIMO geometry (512 trials, cap 20, 10
   dB) and on a small multi-hop / cyclic geometry (1024 trials; the halo
   wider than a rank's blocks, the ring wrapping from the last rank to the
   first); halo SCAMP at chip_smoke's SCAMP main geometry; dense BAMP on
   the i.i.d. channel at the flagship dimensions (10 dB); SV-domain VAMP
   at the VAMP main geometry (cap 10).
   Each decode's seconds beside the plain loop's.

Rank 0 prints one JSON line per reading and, with ``--out``, writes them
all to FILE.  ``--device cpu --small`` rehearses the same on CPU ranks
under gloo at small sizes.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from amp_sparc_spatialmodulation_tpu_torch.config import (  # noqa: E402
    Config, flagship_bamp_ook, massive_mimo)
from amp_sparc_spatialmodulation_tpu_torch.models import (  # noqa: E402
    montecarlo)
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (  # noqa
    fused_bamp)
from amp_sparc_spatialmodulation_tpu_torch.parallel import (  # noqa: E402
    banded, mesh as mesh_mod, sweep, tensor, vamp_tp)
from amp_sparc_spatialmodulation_tpu_torch.parallel.mesh import (  # noqa
    MODEL_AXIS, axis_of)
from amp_sparc_spatialmodulation_tpu_torch.utils.device import (  # noqa
    make_generator)

LINES = []


def report(phase, **fields):
    if dist.get_rank() == 0:
        LINES.append({"phase": phase, **fields})
        print(json.dumps(LINES[-1]), flush=True)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def trials_axis(dev, realizations, res):
    """The trials axis on every rank against the Simulator on rank 0."""
    world = dist.get_world_size()
    mesh = mesh_mod.make_mesh(world, 1, device_type=dev.type)
    cfg = flagship_bamp_ook()
    epochs = realizations * res
    kw = dict(algo="bamp", two_phase=cs.K1, progress=lambda s: None)
    sharded = sweep.ShardedSimulator(cfg, mesh=mesh, device=dev, **kw)
    sharded.run_point(cs.EBN0_DB, epochs=world * res, res=res)  # warm-up
    sync(dev)
    dist.barrier()
    fused_bamp.launches = 0
    t0 = time.perf_counter()
    avg = sharded.run_point(cs.EBN0_DB, epochs=epochs, res=res)
    sync(dev)
    sharded_s = time.perf_counter() - t0
    launches = fused_bamp.launches
    dist.barrier()
    ok = True
    if dist.get_rank() == 0:
        single = montecarlo.Simulator(cfg, device=dev, **kw)
        single.run_point(cs.EBN0_DB, epochs=res, res=res)        # warm-up
        sync(dev)
        t0 = time.perf_counter()
        ref = single.run_point(cs.EBN0_DB, epochs=epochs, res=res)
        sync(dev)
        single_s = time.perf_counter() - t0
        same = {k: avg[k] == ref[k] for k in ("fer", "ber", "T")}
        ok = all(same.values())
        report("cards_trials_axis", world=world, realizations=realizations,
               res=res, sharded_s=sharded_s, single_s=single_s,
               sharded_trials_per_s=epochs / sharded_s,
               single_trials_per_s=epochs / single_s,
               speedup=single_s / sharded_s, mean_T=avg["T"],
               fer=avg["fer"], ber=avg["ber"], identical=same,
               k1_launches_rank0=launches)
    dist.barrier()
    return ok


def model_axis(dev, small):
    """Each frame-split decoder against the plain loop on rank 0."""
    world = dist.get_world_size()
    mesh = mesh_mod.make_mesh(1, world, device_type=dev.type)
    ax = axis_of(mesh, MODEL_AXIS)
    B = 256 if small else cs.MODEL_AXIS_B
    tiny = Config(Nt=16, Na=4, Nr=8, Lin=world, Lh=4, mode="segmented",
                  iterations=20, alphabet="OOK", profile="uniform",
                  trunc="tail")
    cases = [
        ("halo_bamp", flagship_bamp_ook(), "sparc", "banded", "bamp", B,
         cs.MODEL_AXIS_TOL),
        ("halo_bamp_massive", massive_mimo().replace(iterations=20),
         "sparc", "banded", "bamp", 64 if small else 512,
         cs.MODEL_AXIS_TOL),
        ("halo_bamp_multihop", tiny, "sparc", "banded", "bamp", 1024, 1e-4),
        ("halo_bamp_cyclic", tiny.replace(trunc="cyclic"), "sparc",
         "banded", "bamp", 1024, 1e-4),
        ("halo_scamp", cs.scamp_main_config(), "sparc", "banded", "scamp", B,
         cs.MODEL_AXIS_TOL),
        ("dense_bamp_iid", flagship_bamp_ook(), "iid", "dense", "bamp", B,
         cs.MODEL_AXIS_TOL),
        ("vamp_tp", cs.vamp_main_config(), "sparc", "dense", "vamp", B,
         cs.MODEL_AXIS_TOL),
    ]
    ok = True
    for name, cfg, channel, form, algo, trials, tol in cases:
        # the massive point of chip_smoke's converging shape; the i.i.d.
        # channel past BAMP's threshold: at 8 dB a trial there converges
        # in one summation order and runs to the cap in the other (CPU
        # rehearsal: one of 256), which moves mean T by cap / B
        ebn0 = 10.0 if name in ("halo_bamp_massive", "dense_bamp_iid") \
            else cs.EBN0_DB
        r = montecarlo.with_svd(algo, montecarlo.generate_realization(
            make_generator(dev, 19, 0, 0), cfg, channel, form, trials,
            cs.snr_of(cfg, ebn0)))
        kw = dict(mesh=mesh, return_state=True)
        if algo == "vamp":
            split = lambda: vamp_tp.decode(  # noqa: E731
                r.dec.U, r.dec.s, tensor.shard_columns(r.dec.Vh, ax), r.y,
                r.sigma2, cfg, **kw)
            fields = cs.VAMP_FIELDS
        elif form == "dense":
            split = lambda: tensor.decode(  # noqa: E731
                tensor.shard_columns(r.A, ax), r.y, r.sigma2, cfg, **kw)
            fields = ("xmap", "xmmse", "var")
        elif algo == "scamp":
            split = lambda: banded.scamp_decode(  # noqa: E731
                r.A.h, r.A.gains, r.W, banded.shard_rows(r.y, cfg, ax),
                r.sigma2, cfg, **kw)
            fields = ("xmap", "xmmse", "psi")
        else:
            split = lambda: banded.decode(  # noqa: E731
                r.A.h, r.A.gains, banded.shard_rows(r.y, cfg, ax),
                r.sigma2, cfg, **kw)
            fields = ("xmap", "xmmse", "var")
        split()                                                  # warm-up
        sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        st = split()
        sync(dev)
        split_s = time.perf_counter() - t0
        # the gathered columns (psi is per column block)
        full = st._replace(**{f: tensor.gather_columns(getattr(st, f), ax)
                              for f in fields})
        if dist.get_rank() == 0:
            plain = lambda: montecarlo.decode(  # noqa: E731
                algo, r, r.y, cfg, use_pallas=False, return_state=True)[1]
            plain()
            sync(dev)
            t0 = time.perf_counter()
            sp = plain()
            sync(dev)
            plain_s = time.perf_counter() - t0
            differ = torch.nonzero(full.T != sp.T).flatten()[:8]
            try:
                cs.compare(f"cards_model_axis_{name}", full, sp, tol,
                           fields=fields, world=world, cap=cfg.N_Layers,
                           ebn0_db=ebn0, split_s=split_s, plain_s=plain_s,
                           split_over_plain=split_s / plain_s,
                           T_differ=[[int(full.T[i]), int(sp.T[i])]
                                     for i in differ])
            except AssertionError as exc:
                report(f"cards_model_axis_{name}", failed=str(exc))
                ok = False
        dist.barrier()
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None)
    p.add_argument("--small", action="store_true")
    p.add_argument("--realizations", type=int, default=32)
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh_mod.initialize_distributed(device=args.device)
    cs.emit = report                  # compare's lines go through rank 0
    try:
        if dev.type == "cuda" and dist.get_rank() == 0:
            report("cards", names=[torch.cuda.get_device_name(i) for i in
                                   range(torch.cuda.device_count())],
                   nvidia_smi=cs.nvidia_smi(), torch=torch.__version__,
                   world=dist.get_world_size(), backend=dist.get_backend())
        res = 512 if args.small else cs.RES
        ok = trials_axis(dev, 2 * dist.get_world_size() if args.small
                         else args.realizations, res)
        ok = model_axis(dev, args.small) and ok
        if dist.get_rank() == 0 and args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(LINES, f, indent=1)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
