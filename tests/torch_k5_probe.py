"""Where the time of the frame-tiled BAMP iteration K5
(``ops/kernels/csrc/fused_bamp_tiled.cu``) goes, for this checkout and
another one, at the massive main path's two shapes
(``torch_kernel_ab.tiled_shapes``: ``tiled``, one iteration of 2048 trials,
all active; ``tiled_tail``, one iteration of the trials still active after
a 40-iteration phase 1 of those, gathered).

For each tree and shape, through the tree's own wrapper module: the call's
time by CUDA events (the mean of ``--reps`` calls after a warm-up), and
the device time of each kernel the call launches from a ``torch.profiler``
trace of ``--reps`` calls (K5's four launches under their kernel names, and
the wrapper's own small PyTorch kernels).  Where the wrapper has
``stage_ms`` (the stage mask of the C entry point), the four stages timed
by CUDA events as well.  The shipped source of each tree is compiled for
``nvcc -Xptxas -v``'s register and spill lines.  With ``--tiles`` this
checkout's kernel is also built with other tile constants and timed as it
ships; each result must equal the shipped build's bit for bit (every plane
and ``notok``; xmap on the active trials).  A variant is a ``:``-joined
list of ``name=value`` settings of the source's ``constexpr int``
constants: ``kTM``, ``kTN``, ``kMinBlocks``, ``kDepth``, ``kStages`` (the
large form: rows and columns of a thread's tile, blocks per SM, the ring's
contraction steps per slot and slots), ``kSBM``, ``kSBN``, ``kSTM``,
``kSTN``, ``kSDepth``, ``kSStages`` (the small form's block and thread
tiles and ring) and ``kSegRounds`` (the denoiser's segments per lane
group).

    git archive <commit> amp_sparc_spatialmodulation_tpu_torch | \\
        (mkdir -p build/parent && tar -x -C build/parent)
    env PYTHONPATH=. python3 tests/torch_k5_probe.py --parent build/parent \\
        [--tiles kTM=8:kTN=4,kTM=4:kTN=8,kTM=8:kTN=2,kSTM=4:kSTN=4]

Prints one JSON line per timing and one summary line per tree and shape.
Needs the card and ``nvcc``; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import build

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_k1_passes import (compile_all, ptxas_lines,  # noqa: E402
                             with_constants)
from torch_kernel_ab import Step, _same, tiled_shapes, wrapper_module  # noqa

NAME = "fused_bamp_tiled"


def csrc(root: Path) -> Path:
    return root / "amp_sparc_spatialmodulation_tpu_torch" / "ops" / \
        "kernels" / "csrc"


def profile(launch, reps: int) -> dict:
    """{kernel name: device microseconds per call} over ``reps`` calls, or
    {"error": ...} where the profiler does not trace the card."""
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    try:
        with torch.profiler.profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                launch()
            torch.cuda.synchronize()
    except Exception as exc:  # noqa: BLE001 - reported, not fatal
        return {"error": repr(exc)}
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us > 0:
            out[e.key] = out.get(e.key, 0.0) + us / reps
    return out


def event_ms(launch, reps: int) -> float:
    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def plane_loop_ms(mod, op, ps, y_re, y_im, sigma2, cfg) -> dict:
    """``bamp.plane_loop`` through wrapper module ``mod`` from ``ps`` to
    the cap of ``cfg``: host milliseconds per iteration (synchronized at
    the end) and the iterations run."""
    import time

    from amp_sparc_spatialmodulation_tpu_torch.models import bamp
    s0 = bamp.from_planes(ps)
    y = torch.complex(y_re, y_im)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s1 = bamp.plane_loop(mod.iteration, op, s0, y, sigma2, cfg.N_Layers, cfg)
    torch.cuda.synchronize()
    iters = s1.t - s0.t
    return {"iterations": iters,
            "wall_ms_per_iteration": 1e3 * (time.perf_counter() - t0)
            / max(iters, 1)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=Path, required=True,
                   help="root of the other checkout")
    p.add_argument("--out", type=Path, default=Path("build/k5_probe"))
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--tiles", default="",
                   help="comma-separated variants (name=value:...) to "
                       "build and time")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_k5_probe: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    roots = {"parent": args.parent.resolve(),
             "change": Path(__file__).resolve().parents[1]}
    tiles = list(filter(None, args.tiles.split(",")))
    jobs = {}
    for tree, root in roots.items():
        files = {f.name: f.read_text() for f in csrc(root).glob("*.cuh")}
        src = (csrc(root) / f"{NAME}.cu").read_text()
        variants = {"shipped": src}
        for tile in (tiles if tree == "change" else ()):
            names, values = zip(*(kv.split("=") for kv in tile.split(":")))
            variants[f"tiles_{tile}"] = with_constants(src, names, values)
        for v, text in variants.items():
            d = args.out / tree / v
            if d.exists():
                shutil.rmtree(d)
            d.mkdir(parents=True)
            for fname, t in {**files, f"{NAME}.cu": text}.items():
                (d / fname).write_text(t)
            jobs[(NAME, tree, v)] = d
    built = compile_all(jobs)
    cfg, op, sigma2, shapes = tiled_shapes(dev)

    for tree, root in roots.items():
        mod = wrapper_module(root, NAME, f"probe_{tree}")
        for shape, (ps, y_re, y_im) in shapes.items():
            def launch():
                return Step(mod.iteration(op, ps, y_re, y_im, sigma2, cfg),
                            ps.active)
            times, shipped, loop = {}, None, None
            for (_, t, v), (lib, log) in sorted(
                    built.items(), key=lambda kv: kv[0][2] != "shipped"):
                if t != tree:
                    continue
                build._loaded[NAME] = ctypes.CDLL(str(lib))
                mod._library()
                try:
                    out = launch()
                    ms = event_ms(launch, args.reps)
                    kernels = profile(launch, args.reps)
                    stages = (mod.stage_ms(op, ps, y_re, y_im, sigma2, cfg,
                                           args.reps)
                              if v == "shipped" and hasattr(mod, "stage_ms")
                              else None)
                    if v == "shipped" and shape == "tiled_tail":
                        loop = plane_loop_ms(mod, op, ps, y_re, y_im, sigma2,
                                             cfg)
                    torch.cuda.synchronize()
                finally:
                    build._loaded.pop(NAME, None)
                if v == "shipped":
                    shipped = out
                same = _same(out, shipped)
                times[v] = ms
                print(json.dumps({"tree": tree, "shape": shape, "variant": v,
                                  "B": int(ps.var.shape[0]),
                                  "active": int(ps.active.sum()), "ms": ms,
                                  "kernel_us": kernels, "stage_ms": stages,
                                  "identical_to_shipped": same,
                                  "ptxas": ptxas_lines(log)}), flush=True)
                if not same:
                    raise AssertionError(f"{v} differs from the shipped "
                                         "build")
                del out
            print(json.dumps({"tree": tree, "shape": shape, "device": smi,
                              "shipped_ms": times["shipped"],
                              "plane_loop": loop,
                              "tiles_ms": {v[len("tiles_"):]: ms
                                           for v, ms in times.items()
                                           if v.startswith("tiles_")}}),
                  flush=True)
            del shipped
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
