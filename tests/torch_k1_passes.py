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

With ``--precision high`` or ``default`` (K1 only) the same is done for
K1's HIGH or DEFAULT instances, and with ``--xmap-precision x`` for the
split instance of that (variance chain, xmap chain) pair, at K1-high's two
timed shapes (as chip_smoke's kernels_bamp_high builds them, drawn at the
variance chain's precision: the QPSK flagship, 4096 trials at 5 dB to the
cap of 100, the main path's shape; the OOK flagship's phase 1, 65536
trials at 8 dB to k1=12; ``--shapes`` picks one), ``--parent`` optional.
The probes (``HIGH_PROBES``) are the source run to the cap (``full``) with
one part cut; most time wrong arithmetic (their states are garbage and
only their times are read): the tap fragments held in registers (the
share of their L2 stream), the mma's instruction text emptied (operands
still loaded), without the fold, without the denoiser, the forward or the
adjoint products alone, every ``fp32_pass`` call cut (``no_fp32``, a split
form's FP32 chain), the FP32 chain's tap loads or staging copies cut
(``fp32_taps_in_registers``).  Three keep the results of the forms they
are meant for and are checked to equal ``full`` bit for bit there
(``EXACT_PROBES``): the DEFAULT form's dead lo split writes cut
(``no_split_lo``) and the x-side splits an FP32 chain never reads
(``no_xmap_split``, ``no_var_split``); they find their text only in a
source that still writes those planes, and a probe whose text a tree
lacks is skipped for it.  The
variants (``HIGH_VARIANTS``, this checkout only) change one design choice
of the engine or the denoiser and must equal the shipped build bit for
bit; ``--threads 256,512`` times the shipped build at each block size
where the tree's wrapper picks one (``high_threads``).  Each summary line
carries the timed instance's ptxas lines and every K1 instance's.

    git archive <commit> amp_sparc_spatialmodulation_tpu_torch | \\
        (mkdir -p build/parent && tar -x -C build/parent)
    env PYTHONPATH=. python3 tests/torch_k1_passes.py --parent build/parent
    env PYTHONPATH=. python3 tests/torch_k1_passes.py --parent build/parent \\
        --kernel scamp --tiles 7x5x1x4x1,7x5x2x3x3
    env PYTHONPATH=. python3 tests/torch_k1_passes.py --parent build/parent \\
        --kernel vamp --tiles 4x3x4x16x2x2,8x3x4x16x2x1
    env PYTHONPATH=. python3 tests/torch_k1_passes.py --parent build/parent \\
        --kernel periter --tiles 4x4,4x5,7x4
    env PYTHONPATH=. python3 tests/torch_k1_passes.py --precision high \\
        --parent build/parent --threads 256,512
    env PYTHONPATH=. python3 tests/torch_k1_passes.py --precision default \\
        --xmap-precision highest --parent build/parent --shapes qpsk_cap100 \\
        --probes full,no_fp32,fp32_taps_in_registers

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


def setup(dev, name, res, precision="highest"):
    """(launch(mod, cap), s0) of kernel ``name`` at its main path's shape:
    ``launch`` runs wrapper module ``mod`` once and returns its state (for
    K6/K7 a ``torch_kernel_ab.Step``), ``s0`` is the state it starts from.
    K3 and K4 run in the form ``precision`` names (HIGHEST or HIGH)."""
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
    if precision == "highest":
        yt = data(r.dec, r.y)
        kw = {}
    else:
        yt = data(r.dec, r.y, precision)
        kw = dict(precision=precision)
    s2 = (r.dec.s ** 2).contiguous()
    s0 = mod_.initial_state(r.y, cfg)
    return (lambda mod, cap: mod.whole_decode(r.dec.Vh, s2, yt, s0,
                                              r.sigma2, cap, cfg, **kw)), s0


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


# K1's HIGH instance (``precision='high'``): probe builds, each the shipped
# source run to the cap with the edits named; an edit is a function of the
# source text that raises where its text is not there.
DENOISER = "// ---- denoiser"


def _cut_statement(src: str, found) -> str:
    """``src`` without the call statement that starts at match ``found``
    (up to its closing ``);``)."""
    i, depth = found.end() - 1, 0
    while True:
        depth += {"(": 1, ")": -1}.get(src[i], 0)
        i += 1
        if depth == 0:
            break
    end = src.index(";", i) + 1
    return src[:found.start()] + src[end:].lstrip(" ").lstrip("\n")


def _calls(name: str, src: str):
    return list(re.finditer(rf"^[ \t]*{name}(<[^>(]*>)?\(", src, flags=re.M))


def cut_call(name: str):
    """Remove the statement that calls ``name`` (the one line of the source
    that starts with ``name(`` or ``name<...>(``, up to its closing
    ``);``)."""
    def edit(src: str) -> str:
        found = _calls(name, src)
        if len(found) != 1:
            raise ValueError(f"call of {name} found {len(found)} times")
        return _cut_statement(src, found[0])
    return edit


def cut_calls(name: str):
    """Remove every statement that calls ``name``; raises where there is
    none."""
    def edit(src: str) -> str:
        if not _calls(name, src):
            raise ValueError(f"no call of {name} found")
        while _calls(name, src):
            src = _cut_statement(src, _calls(name, src)[0])
        return src
    return edit


def cut_pass(header: str):
    """Remove the pass of the iteration loop whose header line holds
    ``header`` (as ``variant`` cuts a pass)."""
    def edit(src: str) -> str:
        lines = src.splitlines()
        h = [i for i, ln in enumerate(lines) if header in ln]
        if len(h) != 1:
            raise ValueError(f"{header!r} found {len(h)} times")
        return variant(src, None, h)
    return edit


def replace_first(*alternatives):
    """Replace the first ``(old, new)`` of ``alternatives`` whose ``old``
    occurs once (the sources of two trees may differ)."""
    def edit(src: str) -> str:
        for old, new in alternatives:
            if src.count(old) == 1:
                return src.replace(old, new)
        raise ValueError(f"none of {[a[0][:40] for a in alternatives]} "
                         "found once")
    return edit


def no_mma(src: str) -> str:
    """Every mma.sync's instruction text emptied: its operands are still
    loaded, its accumulators keep what they held."""
    out, n = re.subn(r'"mma\.sync[^"]*"\s*"[^"]*"', '""', src)
    if not n:
        raise ValueError("no mma.sync found")
    return out


def replace_every(*alternatives):
    """Replace each ``(old, new)`` of ``alternatives`` whose ``old`` occurs
    (the sources of two trees, or two instances' loaders, may differ);
    raises where none does."""
    def edit(src: str) -> str:
        hit = [(old, new) for old, new in alternatives if old in src]
        if not hit:
            raise ValueError(f"none of {[a[0][:40] for a in alternatives]} "
                             "found")
        for old, new in hit:
            src = src.replace(old, new)
        return src
    return edit


# The tap fragments of every k16 step replaced by one fragment held in
# registers (the L2 tap stream's share): the hi and lo words of the three-
# pass loader, the hi word of the one-pass loads (the parent's in
# high_pass, the hi-only loader of the redesigned one).
TAPS_IN_REGISTERS = replace_every(
    ("  f[0] = __ldg(p);\n  f[1] = __ldg(p + 1);\n",
     "  f[0] = make_uint4(threadIdx.x, 1u, 2u, 3u);\n  f[1] = f[0];\n"),
    ("f[0] = f[1] = __ldg(ap);",
     "f[0] = f[1] = make_uint4(threadIdx.x, 1u, 2u, 3u);"),
    ("  return __ldg(p);  // hi-only tap fragment\n",
     "  return make_uint4(threadIdx.x, 1u, 2u, 3u);\n"))
# The FP32 chains' taps (fp32_pass) made in registers from the loop indices
# instead of loaded (the share of their tap stream): the parent's __ldg per
# contraction step, or the redesigned pass's staging copies.
FP32_TAPS_IN_REGISTERS = replace_every(
    ("        for (int q = 0; q < kQ; ++q) av[q] = __ldg(t + q * plane);\n",
     "        for (int q = 0; q < kQ; ++q)\n"
     "          av[q] = __int_as_float(0x3c000000 + (j ^ (l * 64 + m)) + q);"
     "\n"),
    ("      cp_async16(buf + 4 * w, src + 4 * w);  // fp32 tap panel\n", ""))
# The DEFAULT form's dead lo halves: no lo written by split_store, no lo
# plane zeroed (the DEFAULT instances read no lo, so their results stay the
# same bit for bit).
NO_SPLIT_LO = replace_every(
    ("  *lo = __float2bfloat16_rn(x - __bfloat162float(h));\n", ""),
    ("    for (int q = 0; q < 2 * nx; ++q) xs.base[q * xs.plane + off] = "
     "zero;",
     "    for (int q = 0; q < 2 * nx; q += 2) xs.base[q * xs.plane + off] = "
     "zero;"),
    ("    for (int q = 0; q < 8; ++q) zs.base[q * zs.plane + c * zs.ld + j] "
     "= zero;",
     "    for (int q = 0; q < 8; q += 2) zs.base[q * zs.plane + c * zs.ld + "
     "j] = zero;"))
# The x side's split operands that a chain in FP32 never reads: the xmap
# chain's three (and their pads) where that chain is FP32, var's where the
# variance chain is (the results of those forms stay the same bit for bit).
XMAP_SPLIT = """    split_store(at(1, 0) + off, at(1, 1) + off, mr);
    if (!real_x) {
      split_store(at(2, 0) + off, at(2, 1) + off, mr + mi);
      split_store(at(3, 0) + off, at(3, 1) + off, mi);
    }
"""
NO_XMAP_SPLIT = replace_every(
    (XMAP_SPLIT, ""),
    ("    for (int q = 0; q < 2 * nx; ++q) xs.base[q * xs.plane + off] = "
     "zero;",
     "    for (int q = 0; q < 2; ++q) xs.base[q * xs.plane + off] = zero;"))
NO_VAR_SPLIT = replace_every(
    ("    split_store(at(0, 0) + off, at(0, 1) + off, vn);\n", ""),
    ("    for (int q = 0; q < 2 * nx; ++q) xs.base[q * xs.plane + off] = "
     "zero;",
     "    for (int q = 2; q < 2 * nx; ++q) xs.base[q * xs.plane + off] = "
     "zero;"))
def cut_named_calls(name: str):
    """Remove every statement that calls exactly ``name`` (a function with
    its template arguments, e.g. ``high_pass<kXP == 1, F::kWords>``);
    raises where there is none."""
    return cut_calls(re.escape(name))


# The mixed bf16 split forms (<3, 1>, <1, 3>): one chain runs three passes,
# the other one.  The one-pass chain's high_pass reads the hi word of each
# tap fragment at the three-pass stride (32 bytes a lane); read instead
# one 16-byte word a lane contiguously (wrong taps, the stream a hi-only
# buffer gives).
ONE_PASS_DENSE_TAPS = replace_every(
    ("taps + (static_cast<size_t>(mt) * ks * 32 + lane) * kWords;",
     "taps + (static_cast<size_t>(mt) * ks * 32 + lane) * (kOne ? 1 : "
     "kWords);"),
    ("ap += 32 * kWords, b += 16) {",
     "ap += 32 * (kOne ? 1 : kWords), b += 16) {"))
# The lo plane of a split write kept only where the chain that reads the
# operand runs three passes: the xmap chain's operands (1..3) for <3, 1>,
# var's (and Zc's, operand 0) for <1, 3> (the one-pass chain reads no lo,
# so those forms' results stay the same bit for bit).
_PUT_LO = ("    if (kParts == 2) hi[plane] = __float2bfloat16_rn(x - "
           "__bfloat162float(h));")


def lo_only_for(var_chain: bool):
    cond = "o == 0" if var_chain else "o != 0"
    return replace_first((_PUT_LO, _PUT_LO.replace(
        "if (kParts == 2)", f"if (kParts == 2 && {cond})")))


# The mma of one kind of pass emptied, as ``no_mma`` empties every mma
# (the operands still loaded, the accumulators kept), the other kind's
# kept: in high_pass each mma goes through mma_kind<kCut>, whose cut form
# is an asm statement without an instruction.
_MMA_KIND = """// A lane's tap fragment of one k16 step"""
_MMA_KIND_DEF = """__device__ __forceinline__ void mma_nop(float (&d)[4],
                                        const unsigned (&a)[4], unsigned b0,
                                        unsigned b1) {
  asm("" : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <bool kCut>
__device__ __forceinline__ void mma_kind(float (&d)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  if (kCut) mma_nop(d, a, b0, b1);
  else mma_bf16(d, a, b0, b1);
}

"""


def mma_cut(cut: str, fused: bool):
    """high_pass's mma through mma_kind<cut> (``cut`` a condition on its
    kOne), and one_pass_products' (the mixed forms' one-pass chain) cut
    too where ``fused``."""
    fused_mma = ("mma_bf16(acc[j][i], a,",
                 f"mma_kind<{'true' if fused else 'false'}>(acc[j][i], a,")
    return replace_every(
        (_MMA_KIND, _MMA_KIND_DEF + _MMA_KIND), fused_mma,
        *((f"mma_bf16({a}[{n}], {b},", f"mma_kind<{cut}>({a}[{n}], {b},")
          for n in ("nt", "i") for a, b in (("hh", "ah"), ("cx", "ah"),
                                            ("cx", "al"))))


NO_MMA_THREE = [mma_cut("!kOne", fused=False)]
NO_MMA_ONE = [mma_cut("kOne", fused=True)]
# Each chain's products alone: the other chain's product calls cut (the
# parent's spelling and this tree's).
VAR_CALLS = ("high_pass<kVP == 1, F::kWords>",
             "high_pass<kVP == 1, F::kVParts>")
XMAP_CALLS = ("high_pass<kXP == 1, F::kWords>",
              "high_pass<kXP == 1, F::kXParts>", "one_pass_products<3>")


def cut_any_calls(names):
    """Remove every statement that calls one of ``names`` (as
    :func:`cut_named_calls`); raises where none is called."""
    def edit(src: str) -> str:
        hit = [n for n in names if _calls(re.escape(n), src)]
        if not hit:
            raise ValueError(f"no call of {names} found")
        for n in hit:
            src = cut_named_calls(n)(src)
        return src
    return edit
HIGH_PROBES = {
    "full": [],
    "taps_in_registers": [TAPS_IN_REGISTERS],
    "no_mma": [no_mma],
    "no_fold": [cut_call("fold_high")],
    "no_denoiser": [cut_pass(DENOISER)],
    "forward_only": [cut_call("fold_high"), cut_call("adjoint_high"),
                     cut_pass(DENOISER)],
    "adjoint_only": [cut_call("forward_high"), cut_call("fold_high"),
                     cut_pass(DENOISER)],
    # the split forms' FP32 chains: every fp32_pass call cut, its taps
    "no_fp32": [cut_calls("fp32_pass")],
    "fp32_taps_in_registers": [FP32_TAPS_IN_REGISTERS],
    # the FP32 register tiles' shared-memory loads in the product loop
    # replaced by values made from the loop indices (what is left: the FMAs,
    # the loop, the staging and the barriers)
    "fp32_no_loads": [replace_every(
        ("            for (int i = 0; i < kR; ++i) xv[i] = lds128(xp[i]);",
         "            for (int i = 0; i < kR; ++i)\n"
         "                xv[i] = make_float4(__uint_as_float(xp[i]), 1.f, "
         "2.f, 3.f);"),
        ("              tap_words<kC>(t, tp + st * tstep);",
         "#pragma unroll\n              for (int c = 0; c < kC; ++c)\n"
         "                t[c] = __uint_as_float(tp + st + c);"))],
    # ... their barrier a panel removed
    "fp32_no_sync": [replace_every(
        ("        cp_async_wait<0>();\n        __syncthreads();\n        if "
         "(ci + 1 < chunks)",
         "        cp_async_wait<0>();\n        if (ci + 1 < chunks)"),
        ("        __syncthreads();\n        if (live) {\n          const int k0"
         " = ci * KC",
         "        if (live) {\n          const int k0 = ci * KC"))],
    # dead split writes (results equal to ``full`` bit for bit where dead)
    "no_split_lo": [NO_SPLIT_LO],
    "no_xmap_split": [NO_XMAP_SPLIT],
    "no_var_split": [NO_VAR_SPLIT],
    # the mixed bf16 split forms' suspects: the one-pass chain's taps read
    # contiguously, the lo planes of its operands not written (exact), the
    # mma of one kind of pass cut, each chain's products alone, the
    # denoiser's split writes cut
    "one_pass_dense_taps": [ONE_PASS_DENSE_TAPS],
    "no_lo_xmap_chain": [lo_only_for(var_chain=True)],
    "no_lo_var_chain": [lo_only_for(var_chain=False)],
    "no_mma_three": NO_MMA_THREE,
    "no_mma_one": NO_MMA_ONE,
    "var_chain_only": [cut_any_calls(XMAP_CALLS)],
    "xmap_chain_only": [cut_any_calls(VAR_CALLS)],
    "no_split_store": [replace_every(("if (kMask) xs.store_x<",
                                      "if (kMask && false) xs.store_x<"))],
}
# Probes that leave the forms they are meant for bit-identical to ``full``
# (they cut only writes those forms never read): {probe: forms}.
EXACT_PROBES = {"no_split_lo": {("default", "default")},
                "no_xmap_split": {("default", "highest"),
                                  ("high", "highest")},
                "no_var_split": {("highest", "default"),
                                 ("highest", "high")},
                "no_lo_xmap_chain": {("high", "default")},
                "no_lo_var_chain": {("default", "high")}}


# Variants of the redesigned HIGH engine (``high_pass``) and denoiser,
# each the shipped source with one design choice changed; each computes the
# same products and posteriors in the same order, so its result must equal
# the shipped build's bit for bit.
K_LOOPS = ("      for (int k = 0; k < ks; ++k, ap += 64, b += 16) {\n",
           "      for (int k = 0; k < ks; ++k, ap += 32 * kWords, b += 16) {\n")
SEGMENTS = ("        for (int s = tid / G; s < N / p.M; s += blockDim.x / G)\n",
            "        for (; s < nseg; s += groups)\n")
HIGH_VARIANTS = {
    # every tile one unit, whatever the warps (the three-pass forms)
    "no_parts": [replace_first(("  return s < 1 ? 1 : (s > NT ? NT : s);",
                                "  return 1;"),
                               ("  return parts < least ? least : parts;",
                                "  return least;"))],
    # two k16 steps per turn of the loop
    "unroll_k2": [replace_first(*((k, "#pragma unroll 2\n" + k)
                                  for k in K_LOOPS))],
    # the denoiser's segments two per turn of the loop (the forms that load
    # no input ahead)
    "segments2": [replace_first(*((k, "#pragma unroll 2\n" + k)
                                  for k in SEGMENTS))],
    # the denoiser taking K as it comes at every alphabet
    "runtime_k": [replace_first((
        "      constexpr bool kStaticK = kHigh;",
        "      constexpr bool kStaticK = false;"))],
    # the FP32 tiles 4 columns wide in a pass of one product too, 2 in a
    # pass of several
    "fp32_c4": [replace_first(("constexpr int kColsOne32 = 2;",
                               "constexpr int kColsOne32 = 4;"))],
    "fp32_c2": [replace_first(("constexpr int kColsMany32 = 4;",
                               "constexpr int kColsMany32 = 2;"))],
    "fp32_c8": [replace_first(("constexpr int kColsOne32 = 2;",
                               "constexpr int kColsOne32 = 8;"))],
    # ... 5 rows a tile wherever the rule picks one
    "fp32_r5": [replace_first((
        "  if (cost(4) < cost(kR)) kR = 4;\n  if (cost(3) < cost(kR)) kR = 3;\n",
        ""))],
    "fp32_c4_r5": [replace_first(("constexpr int kColsOne32 = 2;",
                                  "constexpr int kColsOne32 = 4;")),
                   replace_first((
        "  if (cost(4) < cost(kR)) kR = 4;\n  if (cost(3) < cost(kR)) kR = 3;\n",
        ""))],
    # ... two turns of their step loop unrolled
    "fp32_unroll2": [replace_first((
        "          for (int kk = 0; kk < kc; kk += 4) {  // fp32 tile step",
        "#pragma unroll 2\n          for (int kk = 0; kk < kc; kk += 4) {"
        "  // fp32 tile step"))],
    # where the rule picks 5 rows a tile, 8
    "fp32_r8": [replace_first(("    fp32_tiles<kQ, 5, kC>(",
                               "    fp32_tiles<kQ, 8, kC>("))],
    # the mixed forms' one-pass products one at a time (high_pass<true>)
    "no_fuse": [replace_first(("constexpr bool kFuseOnePass = true;",
                               "constexpr bool kFuseOnePass = false;"))],
    # the denoiser one segment a round in every form
    "no_pair": [replace_first((
        "  constexpr bool kPair = kHigh;",
        "  constexpr bool kPair = false;"))],
}


# The passes of a chain (the kernel's template arguments) and the form code
# the launcher takes (``fused_bamp.FORM``), per precision.
PASSES = {"highest": 0, "high": 3, "default": 1}
FORM_CODE = {"highest": 0, "high": 1, "default": 2}


def only_instance(precision: str, x_precision: str):
    """The launcher with every kernel instance but the timed form's
    replaced by nullptr, so that a probe build compiles one instance (the
    shipped build keeps them all, for ptxas's lines)."""
    v, x = PASSES[precision], PASSES[x_precision]
    vf, xf = FORM_CODE[precision], FORM_CODE[x_precision]

    def direct(m):
        return (m.group(0) if (int(m.group(1)), int(m.group(2))) == (v, x)
                else "nullptr")

    def case(m):
        return (m.group(0) if (int(m.group(2)), int(m.group(3))) == (vf, xf)
                else f"case {m.group(1)}: return nullptr;")

    def edit(src: str) -> str:
        src = re.sub(r"bamp_decode_kernel<(\d), (\d), k\w+, \d>", direct,
                     src)
        return re.sub(r"case (\d): return split_kernel<(\d), (\d)>\(\);",
                      case, src)
    return edit


def high_sources(root: Path, probes, form=None):
    """{variant: {file name: text}} of K1's source in the checkout at
    ``root``: as shipped and each probe or variant of ``probes`` (with
    ``form``, a (precision, x_precision) pair, only that form's instance
    in the probe builds)."""
    csrc = root / "amp_sparc_spatialmodulation_tpu_torch" / "ops" \
        / "kernels" / "csrc"
    files = {f.name: f.read_text() for f in csrc.glob("*.cuh")}
    src = (csrc / "fused_bamp_decode.cu").read_text()
    out = {"shipped": {**files, "fused_bamp_decode.cu": src}}
    to_cap = KERNELS["fused_bamp_decode"]["to_cap"]
    for name in probes:
        try:
            if name in HIGH_VARIANTS:
                text = src
                for edit in HIGH_VARIANTS[name]:
                    text = edit(text)
            else:
                text = variant(src, to_cap)
                for edit in HIGH_PROBES[name]:
                    text = edit(text)
            if form is not None:
                text = only_instance(*form)(text)
        except ValueError as err:
            # a probe whose text this tree lacks is skipped for it
            print(json.dumps({"tree": str(root), "probe": name,
                              "skipped": str(err)}), flush=True)
            continue
        out[name] = {**files, "fused_bamp_decode.cu": text}
    return out


def high_shapes(dev, precision="high"):
    """K1-high's two timed shapes, as chip_smoke's kernels_bamp_high builds
    them, drawn at ``precision``: {name: (cfg, realization, s0, cap)}: the
    QPSK flagship, 4096 trials at 5 dB, cap 100 (the main path's shape),
    and the OOK flagship at its phase-1 shape, 65536 trials at 8 dB, cap
    12."""
    import chip_smoke as cs
    from amp_sparc_spatialmodulation_tpu_torch.config import (
        flagship_bamp_qpsk)
    out = {}
    for name, cfg, B, cap, ebn0, seed in (
            ("qpsk_cap100", flagship_bamp_qpsk(), cs.FLAGSHIP_B, 100,
             cs.BAMP_HIGH_EBN0_DB, 42),
            ("ook_phase1", flagship_bamp_ook(), cs.RES, cs.K1, cs.EBN0_DB,
             41)):
        r = montecarlo.generate_realization(
            make_generator(dev, seed), cfg, "sparc", "banded", B,
            cs.snr_of(cfg, ebn0), precision)
        out[name] = (cfg, r, bamp.initial_state(r.y, cfg.N, r.sigma2), cap)
    return out


def cs_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls after one, by CUDA
    events."""
    import chip_smoke
    return chip_smoke.cuda_ms(fn, 1, reps)


def form_label(precision: str, x_precision) -> str:
    """The kernel label of K1's form: ``fused_bamp_decode_high``,
    ``..._default`` or, for a split form, ``..._xmap_<v>_<x>``."""
    if x_precision in (None, precision):
        return f"fused_bamp_decode_{precision}"
    return f"fused_bamp_decode_xmap_{precision}_{x_precision}"


def instance_lines(log: str, precision: str, x_precision, threads: int):
    """ptxas's lines of the timed instance ``bamp_decode_kernel<kVP, kXP,
    threads, blocks>`` (a split form: the one 512-thread instance)."""
    passes = {"highest": 0, "high": 3, "default": 1}
    v = passes[precision]
    x = passes[x_precision or precision]
    if v != x:
        threads = 512
    tag = f"ILi{v}ELi{x}ELi{threads}E"
    lines = ptxas_lines(log)
    starts = [i for i, ln in enumerate(lines) if "Compiling entry" in ln]
    for a, b in zip(starts, starts[1:] + [len(lines)]):
        if tag in lines[a]:
            return lines[a:b]
    return []


def main_high(args, roots, smi) -> int:
    """The probes of K1's form (``--precision``, ``--xmap-precision``) at
    both timed shapes, for each tree."""
    precision, x_precision = args.precision, args.xmap_precision
    form = (precision, x_precision or precision)
    label = form_label(precision, x_precision)
    probes = [p for p in (args.probes.split(",") if args.probes
                          else list(HIGH_PROBES)[:7]) if p]
    jobs = {}
    for tree, root in roots.items():
        mine = [p for p in probes
                if p not in HIGH_VARIANTS or tree == "change"]
        for v, files in high_sources(root, mine, form).items():
            d = args.out.joinpath(label, tree, v)
            if d.exists():
                shutil.rmtree(d)
            d.mkdir(parents=True)
            for fname, text in files.items():
                (d / fname).write_text(text)
            jobs[("fused_bamp_decode", tree, v)] = d
    built = compile_all(jobs)
    for (_, tree, v), (_, log) in built.items():
        print(json.dumps({"tree": tree, "variant": v,
                          "ptxas": ptxas_lines(log)}), flush=True)
    dev = torch.device("cuda")
    shapes = high_shapes(dev, precision)
    wanted = (set(filter(None, args.shapes.split(","))) if args.shapes
              else set(shapes))
    for shape, (cfg, r, s0, cap) in shapes.items():
        if shape not in wanted:
            continue
        reps = args.reps if shape == "ook_phase1" else max(args.reps - 1, 1)
        for tree, root in roots.items():
            mod = wrapper_module(root, "fused_bamp", f"high_{tree}")
            times, shipped, full = {}, None, None
            run = lambda: mod.whole_decode(r.A, s0, r.y, r.sigma2, cap, cfg,
                                           precision, x_precision)
            for v in ["shipped"] + probes:
                if ("fused_bamp_decode", tree, v) not in built:
                    continue
                build._loaded["fused_bamp_decode"] = ctypes.CDLL(
                    str(built[("fused_bamp_decode", tree, v)][0]))
                mod._library()
                try:
                    out = run()
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(reps):
                        out = run()
                    stop.record()
                    torch.cuda.synchronize()
                finally:
                    build._loaded.pop("fused_bamp_decode", None)
                times[v] = start.elapsed_time(stop) / reps
                iters = int((out.T.long() - s0.T.long()).sum())
                if v == "shipped":
                    shipped = out
                if v == "full":
                    full = out
                same = _same(out, shipped) if v in HIGH_VARIANTS else None
                exact = (_same(out, full) if full is not None
                         and form in EXACT_PROBES.get(v, ()) else None)
                print(json.dumps({
                    "kernel": label, "shape": shape,
                    "tree": tree, "probe": v, "ms": times[v],
                    "iterations": iters, "us_per_trial_iteration_per_sm":
                    1e3 * times[v] * 132 / iters,
                    "identical_to_shipped": same,
                    "identical_to_full": exact}), flush=True)
                if same is False or exact is False:
                    raise AssertionError(f"{v} differs from the "
                                         f"{'shipped' if same is False else 'full'}"
                                         " build")
                del out
            # the shipped build with each block size of --threads, where
            # the tree's wrapper picks one (high_threads)
            rule = getattr(mod, "high_threads", None)
            for threads in filter(None, args.threads.split(",")):
                if rule is None:
                    break
                build._loaded["fused_bamp_decode"] = ctypes.CDLL(
                    str(built[("fused_bamp_decode", tree, "shipped")][0]))
                mod._library()
                mod.high_threads = lambda cfg, n=int(threads): n
                try:
                    ms = cs_ms(run, reps)
                finally:
                    mod.high_threads = rule
                    build._loaded.pop("fused_bamp_decode", None)
                times[f"threads_{threads}"] = ms
                print(json.dumps({
                    "kernel": label, "shape": shape,
                    "tree": tree, "probe": f"threads_{threads}", "ms": ms,
                    "shipped_threads": rule(cfg)}), flush=True)
            del shipped, full
            full_ms = times.get("full")
            log = built[("fused_bamp_decode", tree, "shipped")][1]
            print(json.dumps({
                "kernel": label, "shape": shape,
                "tree": tree, "device": smi, "B": int(s0.T.numel()),
                "cap": cap, "ms": times,
                "share_of_full": {v: t / full_ms for v, t in times.items()}
                if full_ms else None,
                "cut_ms": {v: full_ms - t for v, t in times.items()
                           if v not in ("shipped", "full")
                           and not v.startswith("threads_")}
                if full_ms else None,
                "ptxas_instance": instance_lines(
                    log, precision, x_precision, rule(cfg) if rule else 512),
                "ptxas_instances": {
                    f"{v}:{x}": instance_lines(log, v, x, t)
                    for v, x, t in (("highest", None, 256),
                                    ("high", None, 256), ("high", None, 512),
                                    ("default", None, 256),
                                    ("default", None, 512),
                                    ("highest", "high", 512),
                                    ("highest", "default", 512),
                                    ("high", "highest", 512),
                                    ("high", "default", 512),
                                    ("default", "highest", 512),
                                    ("default", "high", 512))}}),
                flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=Path, default=None,
                   help="root of the other checkout (required but for "
                   "K1's other forms, where it is optional)")
    p.add_argument("--kernel", choices=sorted(GROUPS), default="bamp")
    p.add_argument("--out", type=Path, default=Path("build/k1_passes"))
    p.add_argument("--res", type=int, default=65536)
    p.add_argument("--cap", type=int, default=None,
                   help="iteration cap (default 12 for bamp, 8 for scamp, "
                   "10 for vamp, 1 for periter)")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--tiles", default="",
                   help="comma-separated tile sizes to build and time")
    p.add_argument("--precision", choices=("highest", "high", "default"),
                   default="highest",
                   help="high, default: K1's HIGH or DEFAULT instance and "
                   "its probes (--kernel bamp only)")
    p.add_argument("--xmap-precision", default=None,
                   choices=("highest", "high", "default"),
                   help="K1's split instance with the variance chain at "
                   "--precision and the xmap chain at this one")
    p.add_argument("--probes", default="",
                   help="with --precision high|default or "
                   "--xmap-precision: comma-separated probes (default the "
                   "first seven: "
                   f"{','.join(list(HIGH_PROBES)[:7])}; also "
                   f"{','.join(list(HIGH_PROBES)[7:])}) and variants of "
                   f"this checkout's engine ({','.join(HIGH_VARIANTS)})")
    p.add_argument("--shapes", default="",
                   help="with --precision high|default or "
                   "--xmap-precision: the timed shapes (default both: "
                   "qpsk_cap100,ook_phase1)")
    p.add_argument("--threads", default="",
                   help="with --precision high: block sizes to time the "
                   "shipped build at, e.g. 256,512 (trees whose wrapper "
                   "picks one)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_passes: no CUDA device")
    form = args.precision != "highest" or args.xmap_precision not in (
        None, args.precision)
    if form and args.kernel != "bamp":
        raise SystemExit("torch_k1_passes: --precision high|default and "
                         "--xmap-precision are K1's")
    if args.parent is None and not form:
        raise SystemExit("torch_k1_passes: --parent is required")
    cap = args.cap or {"bamp": 12, "scamp": 8, "vamp": 10,
                       "periter": 1}[args.kernel]
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    roots = {"parent": args.parent.resolve(),
             "change": Path(__file__).resolve().parents[1]} \
        if args.parent else {"change": Path(__file__).resolve().parents[1]}
    if form:
        return main_high(args, roots, smi)
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
