"""Time probe builds of the VAMP kernels K3 and K4 (``fused_vamp_decode.cu``,
``fused_vamp2_decode.cu`` on the engine of ``vamp_common.cuh``) in which one
part of the product engine or the denoiser is cut, to see what the decode
waits on: no profiler traces the card where this runs.

Each probe is a copy of this checkout's sources compiled into ``--out``
(the shipped sources are not changed) with every trial run to the cap, as
``tests/torch_k1_passes.py`` does, and the edits of its name applied to
``vamp_common.cuh``:

* ``shipped``: no edit;
* ``noload``: no operand copies into the ring (the products read whatever
  the ring holds); ``noload_a`` / ``noload_b``: no copies of A or of B;
* ``halfmath``: the imaginary parts' two FMAs per complex term cut;
* ``nobar``: no barrier per k step (the products race with the copies);
* ``noprefetch``: the denoiser does not ask for its next segment's lines;
* ``noproducts``: no products at all (the epilogues get zeros);

and, for the HIGH form's engine (``product_x3``; run with
``--precision high``):

* ``x3_nomma``: no mma passes;
* ``x3_noload_a``: no bulk copies of the split trial side into the ring;
  ``x3_noload_b``: no bulk copies of the tap tiles into the ring (each
  with the bytes the ring's barrier expects cut to match);
* ``x3_nopark``: k1 and k1 + k2 are not parked in shared memory (the
  epilogue gets -k3 and k3);
* ``x3_nosplit``: the passes that write the trial side write no split
  operands (the products read whatever those hold);
* ``x3_noproducts``: one k16 step per pass instead of all of K (loads,
  mma passes and parks about 1% of the shipped ones, every tile's
  epilogue kept): the time of everything else;
* ``x3_nohint``: the trial side's bulk copies without their L2
  evict-first hint (a variant: the results stay as they are);
* ``x3_stages2``, ``x3_stages3``, ``x3_stages6``: a ring of 2, 3 or 6
  slots instead of 4 (variants, not cuts: the results stay as they are).

Only ``noprefetch`` and the ``x3_nohint`` and ``x3_stages*`` variants
leave the results as they are; the others time wrong arithmetic.  The probes run at the VAMP main point
(``chip_smoke.vamp_main_config()``, Eb/N0 = 8 dB, 65536 trials, cap 10),
in turns: the list given, then reversed.

    env PYTHONPATH=. python3 tests/torch_vamp_probes.py \\
        --probes shipped,noload,halfmath,nobar,noprefetch

Prints one JSON line per timing, with the card's name and power limit and
whether the result equals the first probe's bit for bit.  Needs the card
and ``nvcc``; imports no JAX.
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
    "x3_nomma": [(r"(?<!void )mma_bf16\((hh|cx)", r"if (0) mma_bf16(\1")],
    "x3_noload_a": [(r"bulk_copy_once\(st\.a,", "if (0) bulk_copy_once(st.a,"),
                    (r"2 \* \(kSplitStep \+ kTapStep\)", "2 * kTapStep")],
    "x3_noload_b": [(r"bulk_copy\(st\.b,", "if (0) bulk_copy(st.b,"),
                    (r"2 \* \(kSplitStep \+ kTapStep\)", "2 * kSplitStep")],
    "x3_nopark": [(r"sm\.park\[0\]\[i\]\[tid\] = k;", ";"),
                  (r"sm\.park\[1\]\[i\]\[tid\] = sm\.park\[0\]\[i\]\[tid\]"
                   r" \+ k;", ";"),
                  (r"= sm\.park\[0\]\[i\]\[tid\] - k;", "= -k;"),
                  (r"= sm\.park\[1\]\[i\]\[tid\];", "= k;")],
    "x3_nosplit": [(r"\*reinterpret_cast<(unsigned|uint4)\*>\(xs \+ split_at\("
                    r"ksteps, o, m, k0?, \d\)\) =[^;]*;", ";")],
    "x3_noproducts": [(r"const int steps = ksteps;", "const int steps = 1;")],
    "x3_nohint": [(r"bulk_copy_once\(st\.a,", "bulk_copy(st.a,")],
    "x3_stages2": [(r"constexpr int kStagesX3 = 4;",
                    "constexpr int kStagesX3 = 2;")],
    "x3_stages3": [(r"constexpr int kStagesX3 = 4;",
                    "constexpr int kStagesX3 = 3;")],
    "x3_stages6": [(r"constexpr int kStagesX3 = 4;",
                    "constexpr int kStagesX3 = 6;")],
}


def probe_sources(name: str, probe: str) -> dict:
    """{file name: text} of kernel ``name`` under ``probe``."""
    files = {f.name: f.read_text() for f in build.CSRC.glob("*.cuh")}
    files[f"{name}.cu"] = (build.CSRC / f"{name}.cu").read_text().replace(
        *passes.KERNELS[name]["to_cap"])
    for pattern, repl in EDITS[probe]:
        files["vamp_common.cuh"], n = re.subn(pattern, repl,
                                              files["vamp_common.cuh"])
        if n == 0:
            raise ValueError(f"{probe}: {pattern!r} not found")
    return files


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--probes", default="shipped,noload,noload_a,noload_b,"
                   "halfmath,nobar,noprefetch")
    p.add_argument("--kernels", default="fused_vamp_decode,fused_vamp2_decode")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", type=Path, default=Path("build/vamp_probes"))
    p.add_argument("--precision", choices=["highest", "high"],
                   default="highest",
                   help="the form timed (the x3_* probes cut the HIGH one)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_vamp_probes: no CUDA device")
    probes, kernels = args.probes.split(","), args.kernels.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    jobs = {}
    for name in kernels:
        for probe in probes:
            d = args.out / name / probe
            if d.exists():
                shutil.rmtree(d)
            d.mkdir(parents=True)
            for fname, text in probe_sources(name, probe).items():
                (d / fname).write_text(text)
            jobs[(name, "change", probe)] = d
    built = passes.compile_all(jobs)
    dev = torch.device("cuda")
    for name in kernels:
        launch, _ = passes.setup(dev, name, 65536, args.precision)
        mod = wrapper_module(ROOT, passes.KERNELS[name]["module"], "probes")
        first = None
        for probe in probes + probes[::-1]:
            build._loaded[name] = ctypes.CDLL(
                str(built[(name, "change", probe)][0]))
            try:
                mod._library()
                out = launch(mod, 10)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.reps):
                    out = launch(mod, 10)
                stop.record()
                torch.cuda.synchronize()
            finally:
                build._loaded.pop(name, None)
            first = out if first is None else first
            same = all(torch.equal(getattr(out, f), getattr(first, f))
                       for f in out._fields if f != "t")
            print(json.dumps({
                "kernel": name, "probe": probe, "device": smi,
                "ms": start.elapsed_time(stop) / args.reps,
                "same_as_first": same,
                "ptxas": passes.ptxas_lines(
                    built[(name, "change", probe)][1])[-2:]}), flush=True)
            del out
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
