"""Variants of the HIGH form of K5 (``fused_bamp_tiled.cu``,
``high_product_kernel``) on the card: the shipped source against copies
with one part changed, at the massive main path's shape.

Each variant is the shipped source with text replaced, built under its
own name beside the shipped one and launched through the shipped wrapper
(``fused_bamp_tiled.iteration(..., 'high')`` with its ``_library``
swapped).  For each: the gap of one iteration to the plain HIGH step
(median and largest |d| of xmap_re, xm_re, var, z_re and u, from the state
after two plain HIGH iterations of 2048 trials at 8 dB, the state of
``chip_smoke.py``'s ``kernel_main_tiled_high_control``), the call's time by
CUDA events at 2048 trials and at 6 of them, the launches timed apart,
and ptxas's register and spill lines; the HIGHEST form's time in the same
call.  Two rounds, in turns.  Variants:

* ``shipped``: the source as it is (per output tile and k16 step, its
  three passes from zero in the tensor cores, joined by one FP32 add;
  ring slots of two k16 steps);
* ``interleaved``: the first pass of every tile of the warp before the
  second, and so on (more independent mma between dependent ones);
* ``k16``: ring slots of one k16 step, 5 of them;
* ``no_store``: the products without their device-memory stores (wrong
  results: a probe of their cost);
* ``nopromote``: the whole contraction accumulated in the tensor cores
  (the sums of positive terms then drift by the accumulator's
  truncation).

    env PYTHONPATH=. python3 tests/torch_k5_high_variants.py \\
        [shipped nopromote ...]

Prints one JSON line per variant and round.  Needs the card and ``nvcc``;
imports no JAX.
"""
from __future__ import annotations

import ctypes
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from amp_sparc_spatialmodulation_tpu_torch.config import (  # noqa: E402
    massive_mimo)
from amp_sparc_spatialmodulation_tpu_torch.models import (  # noqa: E402
    bamp, montecarlo)
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (  # noqa: E402
    build, fused_bamp_tiled as kern)
from amp_sparc_spatialmodulation_tpu_torch.utils.device import (  # noqa: E402
    make_generator)

SRC = (build.CSRC / "fused_bamp_tiled.cu").read_text()
STEP = SRC[SRC.index("#pragma unroll\n      for (int j = 0; j < NT; ++j)\n"
                     "#pragma unroll\n        for (int i = 0; i < MT; ++i) {"):
           SRC.index("    if (f + 1 == total) {")]
VARIANTS = {
    "shipped": [],
    "interleaved": [(STEP, """#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < MT; ++i)
          mma_bf16_zero(th[i][j], ah[i], b[j][0], b[j][1]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < MT; ++i)
          mma_bf16(th[i][j], ah[i], b[j][2], b[j][3]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(th[i][j], al[i], b[j][0], b[j][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j][e] = acc[i][j][e] + th[i][j][e];
        }
    }
"""), ("      unsigned ah[MT][4], al[MT][4], b[NT][4];\n",
       "      unsigned ah[MT][4], al[MT][4], b[NT][4];\n"
       "      float th[MT][NT][4];\n")],
    "k16": [("constexpr int kSlotSteps = 2;", "constexpr int kSlotSteps = 1;"),
            ("using HighLarge = HighForm<4, 2, 2, 7, 3, 1>;",
             "using HighLarge = HighForm<4, 2, 2, 7, 5, 1>;")],
    "no_store": [("          if (kFwd || p.act[(R0 + r) / p.Lin])\n",
                  "          if (false)\n")],
    "nopromote": [("""          float th[4];
          mma_bf16_zero(th, ah[i], b[j][0], b[j][1]);
          mma_bf16(th, ah[i], b[j][2], b[j][3]);
          mma_bf16(th, al[i], b[j][0], b[j][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = acc[i][j][e] + th[e];""",
                   """          mma_bf16(acc[i][j], ah[i], b[j][0], b[j][1]);
          mma_bf16(acc[i][j], ah[i], b[j][2], b[j][3]);
          mma_bf16(acc[i][j], al[i], b[j][0], b[j][1]);""")],
}


def library(name: str, report) -> ctypes.CDLL:
    key = "fused_bamp_tiled" if name == "shipped" else f"k5high_{name}"
    lib = kern.typed(ctypes.CDLL(str(build.library_path(key))))
    lines = [ln.strip() for ln in report[key]["ptxas"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    print(json.dumps({"variant": name, "ptxas": lines}), flush=True)
    return lib


def gap(a, b) -> dict:
    out = {}
    for f in ("xmap_re", "xm_re", "var", "z_re", "u"):
        d = (getattr(a, f) - getattr(b, f)).abs().flatten().float()
        out[f] = [float(d.median()), float(d.max())]
    return out


def main() -> None:
    names = sys.argv[1:] or list(VARIANTS)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    for name in names:
        if name != "shipped":
            text = SRC
            for old, new in VARIANTS[name]:
                if old not in text:
                    raise SystemExit(f"variant {name}: text not found")
                text = text.replace(old, new)
            (build.CSRC / f"k5high_{name}.cu").write_text(text)
    t0 = time.perf_counter()
    try:
        report = build.build(["fused_bamp_tiled"]
                             + [f"k5high_{n}" for n in names
                                if n != "shipped"])
        print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
        libs = {name: library(name, report) for name in names}
    finally:
        for name in names:
            (build.CSRC / f"k5high_{name}.cu").unlink(missing_ok=True)

    m = massive_mimo()
    r = montecarlo.generate_realization(
        make_generator(dev, 45), m, "sparc", "banded", cs.MASSIVE_RES,
        cs.snr_of(m, cs.MASSIVE_HIGH_DB), "high")
    s0 = bamp.initial_state(r.y, m.N, r.sigma2)
    ps = bamp.to_planes(kern.decode_plain(r.A, s0, r.y, r.sigma2, 2, m,
                                          "high"))
    y_re, y_im = r.y.real.contiguous(), r.y.imag.contiguous()
    plain = kern.iteration_plain(r.A, ps, y_re, y_im, r.sigma2, m, "high")
    idx = torch.arange(6, device=dev) * 97
    ps6 = bamp.PlaneState(*[v if f == "t" else v[idx]
                            for f, v in zip(ps._fields, ps)])
    shipped = kern._library
    try:
        for rnd in range(2):
            for name in names:
                kern._library = lambda lib=libs[name]: lib
                call = lambda p=ps, yr=y_re, yi=y_im: kern.iteration(
                    r.A, p, yr, yi, r.sigma2, m, "high")
                line = {"round": rnd, "variant": name,
                        "ms": cs.cuda_ms(call, 2, 10),
                        "ms_6": cs.cuda_ms(lambda: call(
                            ps6, y_re[idx], y_im[idx]), 2, 20)}
                if rnd == 0:
                    line["gap"] = gap(call(), plain)
                    line["stage_ms"] = kern.stage_ms(
                        r.A, ps, y_re, y_im, r.sigma2, m, precision="high")
                print(json.dumps(line), flush=True)
            kern._library = shipped
            print(json.dumps({"round": rnd, "highest_ms": cs.cuda_ms(
                lambda: kern.iteration(r.A, ps, y_re, y_im, r.sigma2, m),
                2, 10)}), flush=True)
    finally:
        kern._library = shipped


if __name__ == "__main__":
    main()
