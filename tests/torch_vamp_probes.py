"""Time probe builds of the VAMP kernels K3 and K4 (``fused_vamp_decode.cu``,
``fused_vamp2_decode.cu`` on the engine of ``vamp_common.cuh``) in which one
part of the product engine or one pass outside the products is cut, to see
what the decode waits on: no profiler traces the card where this runs.

Each probe is a copy of a checkout's sources compiled into ``--out`` (the
shipped sources are not changed) with every trial run to the cap, as
``tests/torch_k1_passes.py`` does, only the instance of ``--precision``
compiled (the launch's dispatch names it for every form), and the edits of
its name applied to ``vamp_common.cuh``:

* ``shipped``: no edit;
* ``noload``: no operand copies into the ring (the products read whatever
  the ring holds); ``noload_a`` / ``noload_b``: no copies of A or of B;
* ``halfmath``: the imaginary parts' two FMAs per complex term cut;
* ``nobar``: no barrier per k step (the products race with the copies);
* ``noprefetch``: the denoiser does not ask for its next segment's lines
  (the thread-per-segment map; the lane groups load a round ahead into
  registers);
* ``noproducts``: no products at all (the epilogues get zeros);

for the HIGH and DEFAULT forms' engines (``product_x3``, run with
``--precision high``; ``product_x1``, the DEFAULT form's, with
``--precision default``):

* ``x3_nomma``: no mma passes;
* ``x3_noload_a``: no bulk copies of the split trial side into the ring;
  ``x3_noload_b``: no bulk copies of the tap tiles into the ring (each
  with the bytes the ring's barrier expects cut to match);
* ``x3_nopark``: k1 and k1 + k2 are not parked in shared memory (the
  epilogue gets -k3 and k3; ``product_x1``'s reads what the park holds);
* ``x3_nosplit``: the passes that write the trial side write no split
  operands (the products read whatever those hold);
* ``x3_noproducts``: one k16 step per pass (``product_x1``: per ring slot)
  instead of all of K (loads, mma and parks about 1% of the shipped ones,
  every tile's epilogue kept): the time of everything else;
* ``x3_nohint``: the trial side's bulk copies without their L2
  evict-first hint (a variant: the results stay as they are);
* ``x3_stages2``, ``x3_stages3``, ``x3_stages6``: (``product_x3``) a ring
  of 2, 3 or 6 slots instead of 4 (variants, not cuts);

and for the passes outside the products (every form):

* ``nodenoise``: ``denoise_segments`` runs no segment (K3 step 3, K4 step
  1: no posterior, no allclose);
* ``nostep5``: (HIGH and DEFAULT) the elementwise pass that forms
  r_tilde and splits it (K3 step 5, K4 step 3) does nothing;
* ``norowsum``: each row sum of the HIGH and DEFAULT forms
  (``warp_rowsum``) reads one element instead of the row;
* ``nosplitlo``: (``product_x3`` at DEFAULT) ``store_split`` writes the hi
  words only, not the lo words the one pass never reads (the results stay
  as they are).

and for ``product_x1`` alone (``x1cfg_<cols>_<slots>_<steps>`` is a
variant of its tile width ``kBNX1``, ring slots ``kStagesX1`` and k16
steps a slot ``kSlotSteps``, with the wrapper's taps laid out to match;
the results stay as they are):

* ``x1_nofadd``: each k16 step's mma adds into its accumulator, not from
  zero with an FP32 add (the tensor cores' own sum).

A probe must keep every mbarrier's expected bytes equal to the bytes
copied to it and every thread's waits in step: a bulk copy left out of
the count, or a slot refilled before every warp has read it, leaves a
wait on a phase that never completes and the launch hangs (no barrier
probe is offered for ``product_x1``, whose slots are freed by the
barrier).  Probes join with ``+`` (``x3_noproducts+nodenoise`` cuts
both).
``--stop`` keeps the stop test (trials freeze as they converge, as the
shipped kernel runs); ``--all-instances`` compiles every form's instance,
as the build does.  Only
``noprefetch``, ``nosplitlo`` and the ``x3_nohint`` and ``x3_stages*``
variants leave the results as they are; the others time wrong
arithmetic.  The probes run at the VAMP main point
(``chip_smoke.vamp_main_config()``, Eb/N0 = 8 dB, 65536 trials, cap 10),
in turns: the list given, then reversed; with ``--parent`` each probe of
both checkouts, parent then change, and a probe whose text one tree lacks
is left out for that tree.

    env PYTHONPATH=. python3 tests/torch_vamp_probes.py \\
        --probes shipped,noload,halfmath,nobar,noprefetch
    env PYTHONPATH=. python3 tests/torch_vamp_probes.py --precision default \\
        --parent build/parent --probes shipped,x3_noproducts,nodenoise

Prints one JSON line per timing, with the card's name and power limit,
whether the result equals the tree's first probe bit for bit and the
``ptxas`` lines of the timed instance.  Needs the card and ``nvcc``;
imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import build

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_k1_passes as passes  # noqa: E402
from torch_kernel_ab import wrapper_module  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Per probe, its edits of vamp_common.cuh: each a (pattern, replacement),
# or a list of such forms, each applied where it is found (the engines of
# two checkouts, or of two forms in one, may differ); an edit none of
# whose forms is found leaves the probe out for that tree.
EDITS = {
    "shipped": [],
    "noload": [(r"if \(s < steps\) load\(s, s\);", ";"),
               (r"if \(s \+ kStages - 1 < steps\) load\(s \+ kStages - 1,"
                r" \(s \+ kStages - 1\) %\s*kStages\);", ";")],
    "noload_a": [(r"cp_async8\(&st\.a\[", "if (0) cp_async8(&st.a[")],
    "noload_b": [(r"cp_async8\(&st\.b\[", "if (0) cp_async8(&st.b[")],
    "halfmath": [(r"ci\[i\]\[j\] = fmaf\(ar\[i\], bi\[j\], ci\[i\]\[j\]\);",
                  ""),
                 (r"ci\[i\]\[j\] = fmaf\(ai\[i\], br\[j\], ci\[i\]\[j\]\);",
                  "")],
    "nobar": [(r"__syncthreads\(\);  // everyone's did", "//")],
    "noprefetch": [(r'asm volatile\("prefetch\.global\.L1 \[%0\];\\n" '
                    r'::"l"\(c \+ b\)\);', "(void)c;")],
    "noproducts": [(r"const int steps = \(K \+ kBK - 1\) / kBK;\n"
                    r"(  __syncthreads\(\);  // the previous tile's reads "
                    r"of the ring are done\n#pragma unroll\n  for \(int s = "
                    r"0; s < kStages - 1)", r"const int steps = 0;\n\1")],
    "x3_nomma": [[(r"(?<!void )mma_bf16\((hh|cx|th)", r"if (0) mma_bf16(\1"),
                  (r"mma_bf16_z\(th, ah, [^;]*\);",
                   "th[0] = th[1] = th[2] = th[3] = "
                   "__uint_as_float(ah[0] ^ bh[0]);")]],
    "x3_noload_a": [[(r"bulk_copy_once\(st\.a(\[0\])?,",
                      r"if (0) bulk_copy_once(st.a\1,")],
                    [(r"2 \* \(kSplitStep \+ kTapStep\)", "2 * kTapStep"),
                     (r"kSlotBytesA \+ kSlotBytesB", "kSlotBytesB")]],
    "x3_noload_b": [[(r"bulk_copy\(st\.b(\[0\])?,",
                      r"if (0) bulk_copy(st.b\1,")],
                    [(r"2 \* \(kSplitStep \+ kTapStep\)", "2 * kSplitStep"),
                     (r"kSlotBytesA \+ kSlotBytesB", "kSlotBytesA")]],
    "x3_nopark": [[(r"sm\.park\[0\]\[i\]\[tid\] = (k|acc\[j\]\[e\]);",
                    ";")],
                  [(r"sm\.park\[1\]\[i\]\[tid\] = sm\.park\[0\]\[i\]"
                    r"\[tid\] \+ (k|acc\[j\]\[e\]);", ";")],
                  [(r"= sm\.park\[0\]\[i\]\[tid\] - (k|acc\[j\]\[e\]);",
                    r"= -\1;")],
                  (r"= sm\.park\[1\]\[i\]\[tid\];", "= k;")],
    "x3_nosplit": [[(r"\*reinterpret_cast<(unsigned|uint4)\*>\(xs \+ "
                     r"split_at\(ksteps, o, m, k0?, \d\)\) =[^;]*;", ";"),
                    (r"\*reinterpret_cast<unsigned\*>\(xs \+ split1_at\("
                     r"ksteps, o, m, k\)\) =[^;]*;", ";")]],
    "x3_noproducts": [[(r"const int steps = ksteps;",
                        "const int steps = 1;"),
                       (r"const int slots = \(ksteps \+ kSlotSteps - 1\) / "
                        r"kSlotSteps;", "const int slots = 1;")]],
    "x3_nohint": [(r"bulk_copy_once\(st\.a(\[0\])?,", r"bulk_copy(st.a\1,")],
    "x3_stages2": [(r"constexpr int kStagesX3 = 4;",
                    "constexpr int kStagesX3 = 2;")],
    "x3_stages3": [(r"constexpr int kStagesX3 = 4;",
                    "constexpr int kStagesX3 = 3;")],
    "x3_stages6": [(r"constexpr int kStagesX3 = 4;",
                    "constexpr int kStagesX3 = 6;")],
    "nodenoise": [(r"const int nseg = N / M, items = nrows \* nseg;",
                   "const int nseg = N / M, items = 0;")],
    "nostep5": [[(r"const int pairs = \(N \+ 1\) / 2;",
                  "const int pairs = 0;")]],
    "norowsum": [(r"(__device__ __forceinline__ float warp_rowsum\(int n, "
                  r"bool vec4, Get get\) \{\n)",
                  r"\1  return static_cast<float>(n) * get(0);\n")],
    "nosplitlo": [(r"\*reinterpret_cast<unsigned\*>\(xs \+ split_at\(ksteps,"
                   r" o, m, k, 1\)\) = lo\[o\];", ";")],
    "x1_nofadd": [(r"float th\[4\];\n\s*mma_bf16_z\(th, ah, bh\[2 \* h\], "
                   r"bh\[2 \* h \+ 1\]\);\n#pragma unroll\n\s*for \(int e = 0;"
                   r" e < 4; \+\+e\)\n\s*acc\[2 \* q \+ h\]\[e\] = "
                   r"acc\[2 \* q \+ h\]\[e\] \+ th\[e\];",
                   "mma_bf16(acc[2 * q + h], ah, bh[2 * h], bh[2 * h + 1]);")],
}
# The template arguments of each form's instance in the launch's dispatch.
INSTANCE = {"highest": "<false, false>", "high": "<true, false>",
            "default": "<true, true>"}


def probe_sources(root: Path, name: str, probe: str, precision: str,
                  to_cap: bool = True, one_instance: bool = True):
    """{file name: text} of kernel ``name`` of the checkout at ``root``
    under ``probe`` (probes joined by ``+``), every trial run to the cap
    (``to_cap``) and only the instance of ``precision`` compiled
    (``one_instance``); None where an edit's text is not there."""
    csrc = root / "amp_sparc_spatialmodulation_tpu_torch" / "ops" \
        / "kernels" / "csrc"
    files = {f.name: f.read_text() for f in csrc.glob("*.cuh")}
    src = (csrc / f"{name}.cu").read_text()
    if to_cap:
        src = src.replace(*passes.KERNELS[name]["to_cap"])
    if one_instance:
        src = re.sub(r"(vamp2?_decode_kernel)<(true|false), (true|false)>",
                     rf"\1{INSTANCE[precision]}", src)
    files[f"{name}.cu"] = src
    text = files["vamp_common.cuh"]
    for part in probe.split("+"):
        if part.startswith("x1cfg_"):
            # a variant of product_x1's tile, ring slots and steps a slot
            names = ("kBNX1", "kStagesX1", "kSlotSteps")
            if not all(re.search(rf"constexpr int {n} = \d+;", text)
                       for n in names):
                return None
            text = passes.with_constants(text, names, part.split("_")[1:])
            continue
        for edit in EDITS[part]:
            found = 0
            for pattern, repl in edit if isinstance(edit, list) else [edit]:
                text, n = re.subn(pattern, repl, text)
                found += n
            if not found:
                return None
    files["vamp_common.cuh"] = text
    return files


def tile_cols(probe: str):
    """The DEFAULT tile width an ``x1cfg_<cols>_<slots>_<steps>`` probe
    builds (the wrapper lays the taps out for it), else None."""
    for part in probe.split("+"):
        if part.startswith("x1cfg_"):
            return int(part.split("_")[1])
    return None


def instance_ptxas(log: str, precision: str):
    """The ``ptxas -v`` lines of the one kernel instance compiled."""
    lines = passes.ptxas_lines(log)
    starts = [i for i, ln in enumerate(lines) if "Compiling entry" in ln
              and "decode_kernel" in ln]
    return lines[starts[0]:starts[0] + 4] if starts else lines[-2:]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--probes", default="shipped,noload,noload_a,noload_b,"
                   "halfmath,nobar,noprefetch")
    p.add_argument("--kernels", default="fused_vamp_decode,fused_vamp2_decode")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", type=Path, default=Path("build/vamp_probes"))
    p.add_argument("--precision", choices=sorted(INSTANCE),
                   default="highest",
                   help="the form timed (the x3_* probes cut the HIGH and "
                   "DEFAULT engines)")
    p.add_argument("--parent", type=Path, default=None,
                   help="root of another checkout, whose probes are timed "
                   "in turns with this one's")
    p.add_argument("--stop", action="store_true",
                   help="keep the stop test (trials freeze as shipped)")
    p.add_argument("--all-instances", action="store_true",
                   help="compile every form's instance, as the build does")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_vamp_probes: no CUDA device")
    probes, kernels = args.probes.split(","), args.kernels.split(",")
    roots = {"change": ROOT}
    if args.parent is not None:
        roots = {"parent": args.parent.resolve(), **roots}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    jobs = {}
    for name in kernels:
        for tree, root in roots.items():
            for probe in probes:
                files = probe_sources(root, name, probe, args.precision,
                                      not args.stop, not args.all_instances)
                if files is None:
                    print(json.dumps({"kernel": name, "tree": tree,
                                      "probe": probe, "skipped":
                                      "an edit's text is not there"}),
                          flush=True)
                    continue
                d = args.out / tree / name / probe.replace("+", "_")
                if d.exists():
                    shutil.rmtree(d)
                d.mkdir(parents=True)
                for fname, text in files.items():
                    (d / fname).write_text(text)
                jobs[(name, tree, probe)] = d
    built = passes.compile_all(jobs)
    dev = torch.device("cuda")
    for name in kernels:
        launch, s0 = passes.setup(dev, name, 65536, args.precision)
        mods = {tree: wrapper_module(root, passes.KERNELS[name]["module"],
                                     f"probes_{tree}")
                for tree, root in roots.items()}
        first = {}
        order = [(tree, probe) for probe in probes for tree in roots
                 if (name, tree, probe) in built]
        for tree, probe in order + order[::-1]:
            lib, log = built[(name, tree, probe)]
            build._loaded[name] = ctypes.CDLL(str(lib))
            taps_of = getattr(mods[tree], "form_taps", None)
            shipped_cols = (taps_of.__globals__.get("DEFAULT_TILE_COLS")
                            if taps_of else None)
            if tile_cols(probe):
                taps_of.__globals__["DEFAULT_TILE_COLS"] = tile_cols(probe)
            try:
                mods[tree]._library()
                out = launch(mods[tree], 10)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.reps):
                    out = launch(mods[tree], 10)
                stop.record()
                torch.cuda.synchronize()
            finally:
                build._loaded.pop(name, None)
                if tile_cols(probe):
                    taps_of.__globals__["DEFAULT_TILE_COLS"] = shipped_cols
            ref = first.setdefault(tree, out)
            same = all(torch.equal(getattr(out, f), getattr(ref, f))
                       for f in out._fields if f != "t")
            print(json.dumps({
                "kernel": name, "tree": tree, "probe": probe,
                "precision": args.precision, "device": smi,
                "to_cap": not args.stop,
                "iterations": int((out.T.long() - s0.T.long()).sum()),
                "ms": start.elapsed_time(stop) / args.reps,
                "same_as_first": same,
                "ptxas": instance_ptxas(log, args.precision)}), flush=True)
            del out
        first.clear()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
