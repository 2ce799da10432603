"""One rank of the port's multi-rank CPU tests (gloo).

    python tests/torch_dist_worker.py --rank R --world W --store PATH \\
        --spec SPEC.json --out DIR

Joins a gloo group of ``W`` ranks through ``file://PATH`` (a 90 s timeout
on every collective, so that a missed one raises instead of hanging), runs
every case of ``SPEC.json`` whose ``world`` is ``W`` and writes its results
to ``DIR/<case>.rank<R>.npz``.  A case names a task below, the config, the
arrays it reads (an ``.npz`` written by the test) and its parameters.
Imports torch and the port, never JAX: the tests hold these results
against the JAX package in their own process.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from amp_sparc_spatialmodulation_tpu_torch.config import Config  # noqa: E402
from amp_sparc_spatialmodulation_tpu_torch.parallel import (  # noqa: E402
    banded, mesh as mesh_mod, sweep, tensor, vamp_tp)
from amp_sparc_spatialmodulation_tpu_torch.parallel.mesh import (  # noqa
    MODEL_AXIS, axis_of)
from amp_sparc_spatialmodulation_tpu_torch.utils import metrics  # noqa: E402
from amp_sparc_spatialmodulation_tpu_torch.utils.device import (  # noqa
    make_generator)

_MESHES = {}


def mesh_of(shape):
    shape = tuple(shape)
    if shape not in _MESHES:
        _MESHES[shape] = mesh_mod.make_mesh(*shape, device_type="cpu")
    return _MESHES[shape]


def _arrays(case):
    return np.load(case["arrays"]) if case.get("arrays") else {}


def _c64(a):
    return torch.as_tensor(np.asarray(a))


def task_halo(case, cfg):
    a = _arrays(case)
    m = mesh_of((1, case["world"]))
    ax = axis_of(m, MODEL_AXIS)
    y_local = banded.shard_rows(_c64(a["y"]), cfg, ax)
    kw = dict(mesh=m)
    if case.get("algo") == "scamp":
        xmap, xmmse, var, T = banded.scamp_decode(
            _c64(a["h"]), a["gains"], a["W"], y_local, float(a["sigma2"]),
            cfg, estimate_phi=case.get("estimate_phi", False), **kw)
    else:
        xmap, xmmse, var, T = banded.decode(
            _c64(a["h"]), a["gains"], y_local, float(a["sigma2"]), cfg, **kw)
    return dict(xmap=banded.gather_columns(xmap, ax),
                xmmse=banded.gather_columns(xmmse, ax),
                var=banded.gather_columns(var, ax), T=T)


def task_tensor(case, cfg):
    a = _arrays(case)
    m = mesh_of((1, case["world"]))
    ax = axis_of(m, MODEL_AXIS)
    xmap, xmmse, _, T = tensor.decode(
        tensor.shard_columns(_c64(a["A"]), ax), _c64(a["y"]),
        float(a["sigma2"]), cfg, mesh=m)
    return dict(xmap=tensor.gather_columns(xmap, ax),
                xmmse=tensor.gather_columns(xmmse, ax), T=T)


def task_vamp_tp(case, cfg):
    a = _arrays(case)
    m = mesh_of((1, case["world"]))
    ax = axis_of(m, MODEL_AXIS)
    r, xmmse, _, T = vamp_tp.decode(
        _c64(a["U"]), _c64(a["s"]), tensor.shard_columns(_c64(a["Vh"]), ax),
        _c64(a["y"]), float(a["sigma2"]), cfg, mesh=m)
    return dict(r=tensor.gather_columns(r, ax),
                xmmse=tensor.gather_columns(xmmse, ax), T=T)


def _simulator(case, cfg, out_root):
    m = mesh_of(case["mesh"])
    return sweep.ShardedSimulator(
        cfg, mesh=m, device="cpu", out_root=out_root,
        progress=case.get("progress_to", lambda s: None),
        **case.get("sim", {}))


def task_sim(case, cfg):
    """``ShardedSimulator.run_point``: the finalized metrics, k1 and the
    probe's mean T (NaN where none)."""
    sim = _simulator(case, cfg, os.path.join(case["out"], "sims"))
    avg = sim.run_point(**case["point"])
    out = {f"avg_{k}": v for k, v in avg.items()}
    out["k1"] = -1 if sim.k1 is None else sim.k1
    out["probe_meanT"] = (np.nan if sim.probe_meanT is None
                          else sim.probe_meanT)
    out["trials_per_point"] = sim.trials_per_point(case["point"]["epochs"],
                                                   case["point"]["res"])
    return out


def task_simulate(case, cfg):
    """``ShardedSimulator.simulate`` into a directory of this rank's own:
    what it wrote and how many progress lines it reported."""
    lines = []
    case = dict(case, progress_to=lines.append)
    root = os.path.join(case["out"],
                        f"simulate.rank{torch.distributed.get_rank()}")
    sim = _simulator(case, cfg, root)
    res = sim.simulate(**case["grid"])
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs)
    n_lines = len(lines)
    # resumed: every rank takes rank 0's manifest (the others' directories
    # are empty), so no rank decodes a point alone
    again = sim.simulate(**case["grid"], resume=True)
    return dict(files=json.dumps(files), progress_lines=n_lines,
                fer=[res[k]["fer"] for k in sorted(res)],
                fer_resumed=[again[k]["fer"] for k in sorted(again)],
                resumed_lines=len(lines) - n_lines)


def task_step(case, cfg):
    """``make_sharded_step`` on this rank's generators (realizations
    ``d C + j`` of seed ``case['seed']``, point 0): the reduced sums."""
    m = mesh_of(case["mesh"])
    C = case.get("chans", 1)
    trials = axis_of(m, "trials")
    step = sweep.make_sharded_step(cfg, case["algo"], "sparc", case["res"],
                                   m, chans_per_device=C,
                                   operator_form=case.get("operator_form",
                                                          "auto"))
    gens = [make_generator(torch.device("cpu"), case["seed"], 0,
                           trials.index * C + j) for j in range(C)]
    return {f"sum_{k}": v for k, v in
            metrics.fetch_sums(step(gens, case["snr"])).items()}


def task_refuse(case, cfg):
    """Build what ``case['build']`` names on the mesh and record the
    exception it raises (before any collective)."""
    m = mesh_of(case["mesh"])
    kw = case.get("kw", {})
    try:
        if case["build"] == "step":
            sweep.make_sharded_step(cfg, case["algo"], case["channel"], 8, m,
                                    **kw)
        elif case["build"] == "two_phase":
            sweep.make_sharded_two_phase_fns(cfg, case["algo"],
                                             case["channel"], 8, 3, m, **kw)
        else:
            sweep.ShardedSimulator(cfg, mesh=m, device="cpu",
                                   algo=case["algo"],
                                   channel_kind=case["channel"], **kw)
    except (ValueError, NotImplementedError) as exc:
        return dict(error=type(exc).__name__, message=str(exc))
    return dict(error="", message="")


def spawn(cases, world: int, tmp) -> list:
    """Start the ``world`` ranks of the cases for that world size, each
    logging to ``tmp/rank<R>.w<world>.log``; returns the processes."""
    spec = os.path.join(tmp, f"spec.w{world}.json")
    with open(spec, "w") as f:
        json.dump(cases, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(os.path.join(tmp, f"rank{r}.w{world}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--world", str(world), "--store",
             os.path.join(tmp, f"store.w{world}"), "--spec", spec,
             "--out", str(tmp)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return procs


def wait(procs, tmp, world: int, timeout: float) -> None:
    """Wait for every rank, killing them all past ``timeout`` seconds;
    raises with the ranks' logs unless each exited 0."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        logs = []
        for r in bad:
            with open(os.path.join(tmp, f"rank{r}.w{world}.log")) as f:
                logs.append(f"--- rank {r} (rc {procs[r].returncode}):\n"
                            + f.read()[-3000:])
        raise RuntimeError("\n".join(logs))


def results(tmp, name: str, rank: int = 0) -> dict:
    """What rank ``rank`` wrote for case ``name``."""
    with np.load(os.path.join(tmp, f"{name}.rank{rank}.npz")) as z:
        return {k: z[k] for k in z.files}


TASKS = {"halo": task_halo, "tensor": task_tensor, "vamp_tp": task_vamp_tp,
         "sim": task_sim, "simulate": task_simulate, "step": task_step,
         "refuse": task_refuse}


def _numpy(v):
    if torch.is_tensor(v):
        return v.cpu().numpy()
    return np.asarray(v)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--store", required=True)
    p.add_argument("--spec", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    mesh_mod.initialize_distributed(
        init_method=f"file://{args.store}", world_size=args.world,
        rank=args.rank, device="cpu", timeout=90)
    with open(args.spec) as f:
        cases = [c for c in json.load(f) if c["world"] == args.world]
    try:
        for case in cases:
            case = dict(case, out=args.out)
            out = TASKS[case["task"]](case, Config(**case["cfg"]))
            np.savez(os.path.join(args.out,
                                  f"{case['name']}.rank{args.rank}.npz"),
                     **{k: _numpy(v) for k, v in out.items()})
        # every rank at the end before any tears its connections down
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
        # drop the meshes (and their groups) while the interpreter is whole:
        # left to its teardown, gloo aborted about one exit in 60 under load
        _MESHES.clear()
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
