"""Share of each pass of the BAMP whole-decode kernel K1
(``ops/kernels/csrc/fused_bamp_decode.cu``) in its time, for this checkout
and another one, with the compiler's register and spill report.

No profiler traces the card where this runs, so the shares come from probe
builds: for each source tree, copies of the kernel's source are compiled
into ``--out`` (the shipped source is not changed) in which every trial
runs to the cap (the convergence break is taken out) and, in each copy but
the first, one pass of the iteration loop is cut out: the code after one
``// ---- <pass>`` header inside the loop, up to the pass's closing
``__syncthreads();`` (or ``++T;`` for the denoiser).  The share of a pass
is (full - without it) / full, timed by CUDA events at the main path's
phase-1 shape (``flagship_bamp_ook()``, Eb/N0 = 8 dB, 65536 trials, cap
12); ``rest`` is the copy with every pass cut (loads, stores and
barriers).  Each tree's copies launch through that tree's own wrapper
module (its shared-memory carve-out).  The shipped source of each tree is
compiled too, for ``nvcc -Xptxas -v``'s lines, and timed as it ships, with
the carve-out as given and raised to one that leaves 2 blocks per SM.
With ``--tiles 10x10,7x5,...`` this checkout's kernel is also built with
other tile sizes (source blocks per thread of the forward ``kFR`` x of the
adjoint ``kAR``) and timed as it ships; each result must equal the
shipped build's bit for bit.

    git archive <commit> amp_sparc_spatialmodulation_tpu_torch | \\
        (mkdir -p build/parent && tar -x -C build/parent)
    env PYTHONPATH=. python3 tests/torch_k1_passes.py --parent build/parent

Prints one JSON line per timing and one summary line per tree.  Needs the
card and ``nvcc``; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from amp_sparc_spatialmodulation_tpu_torch.config import flagship_bamp_ook
from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import build
from amp_sparc_spatialmodulation_tpu_torch.utils.device import make_generator

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_kernel_ab import wrapper_module  # noqa: E402

NAME = "fused_bamp_decode"
LOOP = "for (int it = 0; it < p.cap; ++it)"
BREAK = "if (!__syncthreads_or(bad)) {"
PASS_ENDS = ("__syncthreads();", "++T;")
KEEP = ("int bad = 0;",)
TWO_BLOCKS_SMEM = 100000  # 2 x (100,000 + 1 KB) fit an SM, 3 do not


def pass_names(src: str):
    """The passes of the iteration loop, by their ``// ---- `` headers:
    [(name, header line index)]."""
    lines = src.splitlines()
    loop = next(i for i, ln in enumerate(lines) if LOOP in ln)
    out = []
    for i in range(loop, len(lines)):
        s = lines[i].strip()
        if s.startswith("// ---- "):
            words = re.split(r"[:,]", s[len("// ---- "):])[0]
            out.append((re.sub(r"[^a-z0-9]+", "_", words.lower()).strip("_"),
                        i))
    return out


def variant(src: str, cut=()):
    """``src`` with the convergence break taken out and the passes whose
    header lines are in ``cut`` removed."""
    if src.count(BREAK) != 1:
        raise ValueError("convergence break not found")
    lines = src.replace(BREAK, BREAK[:-3] + " && false) {").splitlines()
    drop = set()
    for h in cut:
        end = next(j for j in range(h + 1, len(lines))
                   if lines[j].strip() in PASS_ENDS)
        drop |= {j for j in range(h + 1, end)
                 if not lines[j].strip().startswith(KEEP)}
    return "\n".join(ln for j, ln in enumerate(lines) if j not in drop) + "\n"


def compile_all(jobs):
    """Compile {(tree, variant): directory holding the source} side by
    side; returns {(tree, variant): (library path, ptxas log)}."""
    procs = {}
    for key, d in jobs.items():
        lib = d / f"lib{NAME}.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
               str(d / f"{NAME}.cu")]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib)
    out = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        out[key] = (lib, log)
    return out


def ptxas_lines(log: str):
    return [ln.strip() for ln in log.splitlines()
            if any(w in ln for w in ("Compiling entry", "Function properties",
                                     "registers", "spill"))]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=Path, required=True,
                   help="root of the other checkout")
    p.add_argument("--out", type=Path, default=Path("build/k1_passes"))
    p.add_argument("--res", type=int, default=65536)
    p.add_argument("--cap", type=int, default=12)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--tiles", default="",
                   help="comma-separated kFRxkAR sizes to build and time")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_passes: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    roots = {"parent": args.parent.resolve(),
             "change": Path(__file__).resolve().parents[1]}
    jobs, passes = {}, {}
    for tree, root in roots.items():
        csrc = root / "amp_sparc_spatialmodulation_tpu_torch" / "ops" \
            / "kernels" / "csrc"
        src = (csrc / f"{NAME}.cu").read_text()
        passes[tree] = pass_names(src)
        srcs = {"shipped": src, "full": variant(src),
                "rest": variant(src, [h for _, h in passes[tree]])}
        for name, h in passes[tree]:
            srcs[f"no_{name}"] = variant(src, [h])
        for tile in filter(None, args.tiles.split(",")) \
                if tree == "change" else ():
            fr, ar = tile.split("x")
            srcs[f"tiles_{tile}"] = re.sub(
                r"constexpr int kAR = \d+;", f"constexpr int kAR = {ar};",
                re.sub(r"constexpr int kFR = \d+;",
                       f"constexpr int kFR = {fr};", src))
        for v, text in srcs.items():
            d = args.out / tree / v
            if d.exists():
                shutil.rmtree(d)
            d.mkdir(parents=True)
            for hdr in csrc.glob("*.cuh"):
                shutil.copy(hdr, d / hdr.name)
            (d / f"{NAME}.cu").write_text(text)
            jobs[(tree, v)] = d
    built = compile_all(jobs)

    cfg = flagship_bamp_ook()
    snr = 10 ** ((8.0 + 10 * math.log10(cfg.code_rate)) / 10)
    r = montecarlo.generate_realization(make_generator(dev, 11), cfg,
                                        "sparc", "banded", args.res, snr)
    s0 = bamp.initial_state(r.y, cfg.N, r.sigma2)
    for tree, root in roots.items():
        mod = wrapper_module(root, "fused_bamp", f"passes_{tree}")
        times, outs = {}, {}

        def timed(v, smem=None):
            build._loaded[NAME] = ctypes.CDLL(str(built[(tree, v)][0]))
            mod._library()
            carve_out = mod.smem_bytes
            if smem is not None:
                mod.smem_bytes = lambda c: smem
            try:
                out = mod.whole_decode(r.A, s0, r.y, r.sigma2, args.cap, cfg)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.reps):
                    out = mod.whole_decode(r.A, s0, r.y, r.sigma2, args.cap,
                                           cfg)
                stop.record()
                torch.cuda.synchronize()
            finally:
                build._loaded.pop(NAME, None)
                mod.smem_bytes = carve_out
            ms = start.elapsed_time(stop) / args.reps
            iters = int((out.T.long() - s0.T.long()).sum())
            outs[v] = out
            same = all(torch.equal(getattr(out, f),
                                   getattr(outs["shipped"], f))
                       for f in out._fields if f != "t") \
                if v.startswith("tiles_") else None
            print(json.dumps({"tree": tree, "variant": v, "smem": smem,
                              "ms": ms, "iterations": iters,
                              "identical_to_shipped": same}), flush=True)
            if same is False:
                raise AssertionError(f"{v} differs from the shipped build")
            return ms

        for v in sorted((k[1] for k in built if k[0] == tree),
                        key=lambda v: v != "shipped"):
            times[v] = timed(v)
        two = timed("shipped", TWO_BLOCKS_SMEM)
        full = times["full"]
        print(json.dumps({
            "tree": tree, "device": smi, "B": args.res, "cap": args.cap,
            "shipped_ms": times["shipped"], "shipped_2_blocks_ms": two,
            "full_to_cap_ms": full,
            "share": {name: (full - times[f"no_{name}"]) / full
                      for name, _ in passes[tree]},
            "rest_share": times["rest"] / full,
            "tiles_ms": {v[len("tiles_"):]: ms for v, ms in times.items()
                         if v.startswith("tiles_")},
            "ptxas": ptxas_lines(built[(tree, "shipped")][1]),
            "spills": {v: [ln for ln in ptxas_lines(log) if "spill" in ln]
                       for (t, v), (_, log) in built.items() if t == tree}}),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
