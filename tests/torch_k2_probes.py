"""Time probe builds of the SCAMP kernel K2 (``fused_scamp_decode.cu``) in
which one kind of work is cut or replaced, to see what the decode waits
on: no profiler traces the card where this runs.

Each probe is a copy of this checkout's sources compiled into ``--out``
(the shipped source is not changed) with every trial run to the cap, as
``tests/torch_k1_passes.py`` does, and the edits of its name applied to
``fused_scamp_decode.cu``:

* ``shipped``: no edit;
* ``fastexp``: the denoiser's ``expf`` as ``__expf``;
* ``fastdiv``: the denoiser's divisions as ``__fdividef`` (by tau/2) and
  products with ``__frcp_rn`` (by the segment sum);
* ``fastabs2``: psi's ``|x|^2`` as ``x * x`` (real alphabets);
* ``fastmath``: the three above together;
* ``symsmem``: the denoiser reads its symbol table from shared memory
  (the scratch planes) instead of device memory;
* ``notaps``: the forward and adjoint tiles read their taps from shared
  memory (the scratch planes) instead of device memory through L1/L2;
  ``notaps_adj``: the adjoint tiles only.

Every probe but ``shipped`` times wrong arithmetic.  The probes run at
phase 1 of the SCAMP main point (``chip_smoke.scamp_main_config()``, Eb/N0
= 8 dB, 65536 trials, cap 8), in turns: the list given, then reversed.

    env PYTHONPATH=. python3 tests/torch_k2_probes.py \\
        --probes shipped,fastmath,notaps

Prints one JSON line per timing, with the card's name and power limit.
Needs the card and ``nvcc``; imports no JAX.
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
NAME = "fused_scamp_decode"
FASTEXP = [(r"return expf\(fminf\(", "return __expf(fminf(")]
FASTDIV = [(r"a = x_re\[j\] / tau;", "a = __fdividef(x_re[j], tau);"),
           (r"\) / eta2;", ") * __frcp_rn(eta2);")]
FASTABS2 = [(r"return abs2\(xr\[k\], real_x \? 0\.f : xi\[k\]\);",
             "return xr[k] * xr[k];")]
TAPS_ADJ = [(r"hv\[q\]\[a\] = __ldg\(hl \+ m \* p\.Nt \+ kel\[a\]\);",
             "hv[q][a] = make_float2(Zr[m & 63], Zi[m & 63]);")]
EDITS = {
    "shipped": [],
    "fastexp": FASTEXP,
    "fastdiv": FASTDIV,
    "fastabs2": FASTABS2,
    "fastmath": FASTEXP + FASTDIV + FASTABS2,
    "symsmem": [(r"p\.sym_re, p\.sym_im,(\s+)real_x", r"Pr, Pi,\1real_x")],
    "notaps": TAPS_ADJ + [
        (r"hv\[q\] = __ldg\(ht \+ \(k \+ q\) \* p\.Nr\);",
         "hv[q] = make_float2(Pr[(k + q) & 63], Pi[(k + q) & 63]);")],
    "notaps_adj": TAPS_ADJ,
}


def probe_source(probe: str) -> dict:
    """{file name: text} of K2 under ``probe``."""
    files = {f.name: f.read_text() for f in build.CSRC.glob("*.cuh")}
    src = (build.CSRC / f"{NAME}.cu").read_text().replace(
        *passes.KERNELS[NAME]["to_cap"])
    for pattern, repl in EDITS[probe]:
        src, n = re.subn(pattern, repl, src)
        if n == 0:
            raise ValueError(f"{probe}: {pattern!r} not found")
    files[f"{NAME}.cu"] = src
    return files


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--probes", default=",".join(EDITS))
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", type=Path, default=Path("build/k2_probes"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_k2_probes: no CUDA device")
    probes = args.probes.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    jobs = {}
    for probe in probes:
        d = args.out / probe
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        for fname, text in probe_source(probe).items():
            (d / fname).write_text(text)
        jobs[(NAME, "change", probe)] = d
    built = passes.compile_all(jobs)
    dev = torch.device("cuda")
    launch, _ = passes.setup(dev, NAME, 65536)
    mod = wrapper_module(ROOT, passes.KERNELS[NAME]["module"], "probes")
    for probe in probes + probes[::-1]:
        build._loaded[NAME] = ctypes.CDLL(str(built[(NAME, "change",
                                                     probe)][0]))
        try:
            mod._library()
            launch(mod, 8)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                launch(mod, 8)
            stop.record()
            torch.cuda.synchronize()
        finally:
            build._loaded.pop(NAME, None)
        print(json.dumps({
            "kernel": NAME, "probe": probe, "device": smi,
            "ms": start.elapsed_time(stop) / args.reps,
            "ptxas": passes.ptxas_lines(
                built[(NAME, "change", probe)][1])[-2:]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
