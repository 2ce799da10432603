"""Share of each pass of a whole-decode kernel in its time, for this
checkout and another one, with the compiler's register and spill report:
the BAMP kernel K1 (``ops/kernels/csrc/fused_bamp_decode.cu``, the
default), with ``--kernel scamp`` the SCAMP kernel K2
(``fused_scamp_decode.cu``), with ``--kernel vamp`` the VAMP and vamp2
kernels K3 and K4 (``fused_vamp_decode.cu``, ``fused_vamp2_decode.cu``,
both on the product engine of ``vamp_common.cuh``) or, with ``--kernel
periter``, the per-iteration kernels K6 and K7 (``fused_bamp_iteration.cu``,
one source, its passes run once per launch).

No profiler traces the card where this runs, so the shares come from probe
builds: for each source tree, copies of the kernel's source are compiled
into ``--out`` (the shipped source is not changed) in which every trial
runs to the cap (the convergence break, or K3/K4's freeze of converged
trials, is taken out; K6/K7 run one iteration and stop nowhere) and, in
each copy but the first, one pass of the iteration loop (of the launch,
for K6/K7) is cut out: the code after one ``// ---- <pass>`` header
inside the loop, up to the pass's closing ``__syncthreads();`` (or
``++T;`` for the pass that holds the stop test); a pass whose cut would
leave its braces unbalanced (one inside a condition the main path does
not take, such as K2's ``estimate_phi`` pass) is not cut.  The share of a pass is (full - without it) /
full, timed by CUDA events at the main path's shape: K1 at phase 1
(``flagship_bamp_ook()``, Eb/N0 = 8 dB, 65536 trials, cap 12), K2 at
phase 1 of the SCAMP main point (``chip_smoke.scamp_main_config()``,
Eb/N0 = 8 dB, 65536 trials, cap 8), K3 and K4
at the VAMP OOK point (``chip_smoke.vamp_main_config()``, Eb/N0 = 8 dB,
65536 trials, cap 10), K6 and K7 for one iteration at chip_smoke's
timing shape (``flagship_bamp_ook()``, 65536 trials, the state after 2
plain iterations; K7 runs no denoiser, so that pass's cut does not touch
it); ``rest`` is the copy with every pass cut (loads,
stores and barriers).  Each tree's copies launch through that tree's own
wrapper module.  The shipped source of each tree is compiled too, for
``nvcc -Xptxas -v``'s lines, and timed as it ships; for K1 also with the
carve-out raised to one that leaves 2 blocks per SM.  With ``--tiles``
this checkout's kernel is also built with other tile sizes and timed as it
ships, and each result must equal the shipped build's bit for bit: for K1
``10x10,7x5,...`` (source blocks per thread of the forward ``kFR`` x of
the adjoint ``kAR``); for K2 ``7x5x2x4x3,...`` (source blocks per forward
thread ``kFR`` x column blocks ``kAR`` x x elements ``kAK`` per adjoint
thread x blocks per SM ``kMinBlocks`` x outputs per fold thread ``kFO``;
a shorter spec sets the first constants only); for K6/K7 ``7x5,4x4,...``
(``kFR`` x ``kAR``, as for K1); for K3/K4 ``4x3x4x16x2x2,...``
(``vamp_common.cuh``'s trials per thread ``kNI`` x columns per thread of
product 1 ``kNJ1`` and of product 2 ``kNJ2`` x k per ring slot ``kBK`` x
ring slots ``kStages`` x blocks per SM ``kMinBlocks``).

    git archive <commit> amp_sparc_spatialmodulation_tpu_torch | \\
        (mkdir -p build/parent && tar -x -C build/parent)
    env PYTHONPATH=. python3 tests/torch_k1_passes.py --parent build/parent
    env PYTHONPATH=. python3 tests/torch_k1_passes.py --parent build/parent \\
        --kernel scamp --tiles 7x5x1x4x1,7x5x2x3x3
    env PYTHONPATH=. python3 tests/torch_k1_passes.py --parent build/parent \\
        --kernel vamp --tiles 4x3x4x16x2x2,8x3x4x16x2x1
    env PYTHONPATH=. python3 tests/torch_k1_passes.py --parent build/parent \\
        --kernel periter --tiles 4x4,4x5,7x4

Prints one JSON line per timing and one summary line per tree and kernel.
Needs the card and ``nvcc``; imports no JAX.
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
from amp_sparc_spatialmodulation_tpu_torch.models import (bamp, montecarlo,
                                                          scamp)
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import build
from amp_sparc_spatialmodulation_tpu_torch.utils.device import make_generator

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_kernel_ab import Step, _same, wrapper_module  # noqa: E402

BREAK = "if (!__syncthreads_or(bad)) {"
# Per kernel: its wrapper module, the first line of its iteration loop (for
# K6/K7 the line its passes follow), the edit that runs every trial to the
# cap (None: nothing stops early), the source file whose constants --tiles
# sets, and the kernel's source when its name is not the kernel's.
KERNELS = {
    "fused_bamp_decode": dict(
        module="fused_bamp", loop="for (int it = 0; it < p.cap; ++it)",
        to_cap=(BREAK, BREAK[:-3] + " && false) {"),
        tile_file="fused_bamp_decode.cu", tile_names=("kFR", "kAR")),
    "fused_vamp_decode": dict(
        module="fused_vamp", loop="for (int it = 0; it < P.cap; ++it)",
        to_cap=("s_act[tid] = s_bad[tid];", ";"),
        tile_file="vamp_common.cuh",
        tile_names=("kNI", "kNJ1", "kNJ2", "kBK", "kStages", "kMinBlocks")),
    "fused_scamp_decode": dict(
        module="fused_scamp", loop="for (int it = 0; it < p.cap; ++it)",
        to_cap=(BREAK, BREAK[:-3] + " && false) {"),
        tile_file="fused_scamp_decode.cu",
        tile_names=("kFR", "kAR", "kAK", "kMinBlocks", "kFO")),
}
KERNELS["fused_vamp2_decode"] = dict(KERNELS["fused_vamp_decode"],
                                     module="fused_vamp2")
KERNELS["periter_fused"] = dict(
    module="fused_bamp_iteration", loop="if (tid == 0) s_bad = 0;",
    to_cap=None, tile_file="fused_bamp_iteration.cu",
    tile_names=("kFR", "kAR"), source="fused_bamp_iteration")
KERNELS["periter_linear"] = KERNELS["periter_fused"]
GROUPS = {"bamp": ("fused_bamp_decode",), "scamp": ("fused_scamp_decode",),
          "vamp": ("fused_vamp_decode", "fused_vamp2_decode"),
          "periter": ("periter_fused", "periter_linear")}


def source_of(name: str) -> str:
    return KERNELS[name].get("source", name)
PASS_ENDS = ("__syncthreads();", "++T;")
KEEP = ("int bad = 0;",)
TWO_BLOCKS_SMEM = 100000  # 2 x (100,000 + 1 KB) fit an SM, 3 do not


def pass_end(lines, h: int) -> int:
    """Index of the line that ends the pass whose header is line ``h``."""
    return next(j for j in range(h + 1, len(lines))
                if lines[j].strip() in PASS_ENDS)


def pass_names(src: str, loop_line: str):
    """The passes of the iteration loop that starts at ``loop_line``, by
    their ``// ---- `` headers: [(name, header line index)].  A pass whose
    cut lines do not balance their braces is left out."""
    lines = src.splitlines()
    loop = next(i for i, ln in enumerate(lines) if loop_line in ln)
    out = []
    for i in range(loop, len(lines)):
        s = lines[i].strip()
        if s.startswith("// ---- "):
            body = "".join(lines[i + 1:pass_end(lines, i)])
            if body.count("{") != body.count("}"):
                continue
            words = re.split(r"[:,]", s[len("// ---- "):])[0]
            out.append((re.sub(r"[^a-z0-9]+", "_", words.lower()).strip("_"),
                        i))
    return out


def variant(src: str, to_cap, cut=()):
    """``src`` with every trial run to the cap (``to_cap``: the text to
    replace and its replacement, or None) and the passes whose header lines
    are in ``cut`` removed."""
    if to_cap is not None:
        if src.count(to_cap[0]) != 1:
            raise ValueError(f"{to_cap[0]!r} not found once")
        src = src.replace(*to_cap)
    lines = src.splitlines()
    drop = set()
    for h in cut:
        drop |= {j for j in range(h + 1, pass_end(lines, h))
                 if not lines[j].strip().startswith(KEEP)}
    return "\n".join(ln for j, ln in enumerate(lines) if j not in drop) + "\n"


def with_constants(text: str, names, values) -> str:
    """``text`` with ``constexpr int <name> = <n>;`` set to each value."""
    for name, value in zip(names, values):
        pattern = rf"constexpr int {name} = \d+;"
        if len(re.findall(pattern, text)) != 1:
            raise ValueError(f"{name} not found once")
        text = re.sub(pattern, f"constexpr int {name} = {value};", text)
    return text


def compile_all(jobs):
    """Compile {(kernel, tree, variant): directory holding the source} side
    by side; returns {(kernel, tree, variant): (library path, ptxas
    log)}."""
    procs = {}
    for key, d in jobs.items():
        name = key[0]
        lib = d / f"lib{name}.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
               str(d / f"{name}.cu")]
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


def sources(root: Path, name: str, tiles):
    """{variant: {file name: text}} of kernel ``name``'s source in the
    checkout at ``root``: as shipped, run to the cap (``full``), with every
    pass cut (``rest``), with each pass cut (``no_<pass>``) and with each
    tile size of ``tiles``; and the passes."""
    spec = KERNELS[name]
    name = source_of(name)
    csrc = root / "amp_sparc_spatialmodulation_tpu_torch" / "ops" \
        / "kernels" / "csrc"
    files = {f.name: f.read_text() for f in csrc.glob("*.cuh")}
    src = (csrc / f"{name}.cu").read_text()
    passes = pass_names(src, spec["loop"])
    texts = {"shipped": src, "full": variant(src, spec["to_cap"]),
             "rest": variant(src, spec["to_cap"], [h for _, h in passes])}
    for pname, h in passes:
        texts[f"no_{pname}"] = variant(src, spec["to_cap"], [h])
    out = {v: {**files, f"{name}.cu": t} for v, t in texts.items()}
    for tile in tiles:
        tf = spec["tile_file"]
        base = dict(files, **{f"{name}.cu": src})
        out[f"tiles_{tile}"] = dict(base, **{tf: with_constants(
            base[tf], spec["tile_names"], tile.split("x"))})
    return out, passes


def setup(dev, name, res):
    """(launch(mod, cap), s0) of kernel ``name`` at its main path's shape:
    ``launch`` runs wrapper module ``mod`` once and returns its state (for
    K6/K7 a ``torch_kernel_ab.Step``), ``s0`` is the state it starts from."""
    if name.startswith("periter"):
        return periter_setup(dev, name, res)
    if name == "fused_bamp_decode":
        cfg = flagship_bamp_ook()
        snr = 10 ** ((8.0 + 10 * math.log10(cfg.code_rate)) / 10)
        r = montecarlo.generate_realization(make_generator(dev, 11), cfg,
                                            "sparc", "banded", res, snr)
        s0 = bamp.initial_state(r.y, cfg.N, r.sigma2)
        return (lambda mod, cap: mod.whole_decode(r.A, s0, r.y, r.sigma2,
                                                  cap, cfg)), s0
    import chip_smoke
    if name == "fused_scamp_decode":
        cfg = chip_smoke.scamp_main_config()
        r = montecarlo.generate_realization(
            make_generator(dev, 21), cfg, "sparc", "banded", res,
            chip_smoke.snr_of(cfg, 8.0))
        s0 = scamp.initial_state(r.y, cfg)
        return (lambda mod, cap: mod.whole_decode(
            r.A, r.W, s0, r.y, r.sigma2, cap, cfg)), s0
    from amp_sparc_spatialmodulation_tpu_torch.models import vamp, vamp2
    algo = "vamp" if name == "fused_vamp_decode" else "vamp2"
    mod_, data = ((vamp, vamp.project) if algo == "vamp"
                  else (vamp2, vamp2.whiten))
    cfg = chip_smoke.vamp_main_config()
    r = montecarlo.with_svd(algo, montecarlo.generate_realization(
        make_generator(dev, 29), cfg, "sparc", "dense", res,
        chip_smoke.snr_of(cfg, 8.0)))
    yt, s2 = data(r.dec, r.y), (r.dec.s ** 2).contiguous()
    s0 = mod_.initial_state(r.y, cfg)
    return (lambda mod, cap: mod.whole_decode(r.dec.Vh, s2, yt, s0,
                                              r.sigma2, cap, cfg)), s0


def periter_setup(dev, name, res):
    """K6 (``periter_fused``) or K7 (``periter_linear``) for one iteration
    from the flagship state after 2 plain iterations."""
    cfg = flagship_bamp_ook()
    snr = 10 ** ((8.0 + 10 * math.log10(cfg.code_rate)) / 10)
    r = montecarlo.generate_realization(make_generator(dev, 53), cfg,
                                        "sparc", "banded", res, snr)
    st = bamp.plain_loop(r.A, bamp.initial_state(r.y, cfg.N, r.sigma2),
                         r.y, r.sigma2, 2, cfg)
    if name == "periter_linear":
        return (lambda mod, cap: Step(mod.iteration_linear(
            r.A, st.xmmse, st.var, st.z, st.u, r.y, r.sigma2, cfg),
            None)), st
    ps = bamp.to_planes(st)
    y_re, y_im = r.y.real.contiguous(), r.y.imag.contiguous()
    return (lambda mod, cap: Step(mod.iteration_fused(
        r.A, ps, y_re, y_im, r.sigma2, cfg), ps.active)), st


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=Path, required=True,
                   help="root of the other checkout")
    p.add_argument("--kernel", choices=sorted(GROUPS), default="bamp")
    p.add_argument("--out", type=Path, default=Path("build/k1_passes"))
    p.add_argument("--res", type=int, default=65536)
    p.add_argument("--cap", type=int, default=None,
                   help="iteration cap (default 12 for bamp, 8 for scamp, "
                   "10 for vamp, 1 for periter)")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--tiles", default="",
                   help="comma-separated tile sizes to build and time")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_passes: no CUDA device")
    cap = args.cap or {"bamp": 12, "scamp": 8, "vamp": 10,
                       "periter": 1}[args.kernel]
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    roots = {"parent": args.parent.resolve(),
             "change": Path(__file__).resolve().parents[1]}
    tiles = list(filter(None, args.tiles.split(",")))
    jobs, passes = {}, {}
    for name in GROUPS[args.kernel]:
        for tree, root in roots.items():
            srcs, passes[(name, tree)] = sources(
                root, name, tiles if tree == "change" else ())
            for v, files in srcs.items():
                key = (source_of(name), tree, v)
                if key in jobs:
                    continue
                d = args.out.joinpath(*key)
                if d.exists():
                    shutil.rmtree(d)
                d.mkdir(parents=True)
                for fname, text in files.items():
                    (d / fname).write_text(text)
                jobs[key] = d
    built = compile_all(jobs)

    for name in GROUPS[args.kernel]:
        launch, s0 = setup(dev, name, args.res)
        for tree, root in roots.items():
            mod = wrapper_module(root, KERNELS[name]["module"],
                                 f"passes_{tree}")
            times, outs = {}, {}

            src_name = source_of(name)

            def timed(v, smem=None):
                build._loaded[src_name] = ctypes.CDLL(
                    str(built[(src_name, tree, v)][0]))
                mod._library()
                carve_out = getattr(mod, "smem_bytes", None)
                if smem is not None:
                    mod.smem_bytes = lambda c: smem
                try:
                    out = launch(mod, cap)
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(args.reps):
                        out = launch(mod, cap)
                    stop.record()
                    torch.cuda.synchronize()
                finally:
                    build._loaded.pop(src_name, None)
                    if smem is not None:
                        mod.smem_bytes = carve_out
                ms = start.elapsed_time(stop) / args.reps
                iters = (int(out.out[0].shape[0]) if isinstance(out, Step)
                         else int((out.T.long() - s0.T.long()).sum()))
                if v == "shipped" and smem is None:
                    outs[v] = out
                same = (_same(out, outs["shipped"])
                        if v.startswith("tiles_") else None)
                print(json.dumps({"kernel": name, "tree": tree,
                                  "variant": v, "smem": smem, "ms": ms,
                                  "iterations": iters,
                                  "identical_to_shipped": same}),
                      flush=True)
                if same is False:
                    raise AssertionError(f"{v} differs from the shipped "
                                         "build")
                return ms

            for v in sorted((k[2] for k in built
                             if k[0] == src_name and k[1] == tree),
                            key=lambda v: v != "shipped"):
                times[v] = timed(v)
            two = (timed("shipped", TWO_BLOCKS_SMEM)
                   if name == "fused_bamp_decode" else None)
            full = times["full"]
            print(json.dumps({
                "kernel": name, "tree": tree, "device": smi, "B": args.res,
                "cap": cap, "shipped_ms": times["shipped"],
                "shipped_2_blocks_ms": two, "full_to_cap_ms": full,
                "share": {pn: (full - times[f"no_{pn}"]) / full
                          for pn, _ in passes[(name, tree)]},
                "rest_share": times["rest"] / full,
                "tiles_ms": {v[len("tiles_"):]: ms
                             for v, ms in times.items()
                             if v.startswith("tiles_")},
                "ptxas": ptxas_lines(
                    built[(src_name, tree, "shipped")][1]),
                "spills": {v: [ln for ln in ptxas_lines(log)
                               if "spill" in ln]
                           for (n, t, v), (_, log) in built.items()
                           if n == src_name and t == tree}}),
                flush=True)
            del outs
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
