"""What the DEFAULT form of K5 (``fused_bamp_tiled.cu`` at
``precision='default'``: the frame-tiled BAMP iteration of the massive-MIMO
path, one bf16 pass per product) waits on: probe builds of a checkout's
source with one part cut, timed on the card at the massive point's DEFAULT
shapes.

Each probe is the checkout's ``fused_bamp_tiled.cu`` with text replaced,
compiled beside the headers into ``build/k5d_probes/<tree>/<probe>/``
(the shipped sources are not changed) and launched through that tree's own
wrapper module with its ``_library`` swapped.  A probe may have several
forms of its edit, one per source design; the first whose text the source
holds is applied, and a probe none of whose forms fits is skipped for that
tree.  Probes:

* ``shipped``: no edit;
* ``half_copies``: every bulk copy into the product ring brings half its
  bytes (the mbarrier expects half);
* ``no_tap_copies`` / ``no_trial_copies``: no bulk copies of the tap tiles
  / of the trial-side tiles into the ring (the barrier expects the rest);
  ``no_copies``: (the DEFAULT engine) none at all (the full barrier
  completes on its arrival alone);
* ``no_mma``: no mma (each k16 step adds zeros);
* ``no_last_stores``: the products' last epilogues store nothing to device
  memory (the values are formed: the stores' condition is one the
  compiler cannot decide);
* ``no_denoise_split``: the denoiser writes no split x and var for the
  next call;
* ``no_parks``, ``no_xload``, ``no_rcp``: (the DEFAULT adjoint) its
  parks before the last product not written, its x not read, its cov = 1
  / v taken as v;
* ``no_adds``: (the DEFAULT engine's wgmma form) the FP32 adds of each
  k16 step's product replaced by a copy and a max (other bits: the cost of
  the adds);
* ``no_lo_writes``: the split launch, the fold and the denoiser write the
  hi halves only, not the lo halves that the one pass never reads (only
  for a tree whose DEFAULT form is the HIGH engine's ``kOne`` instance);

and variants of the DEFAULT form's own engine (``default_product_kernel``):

* ``tile_slots6``: the large forms' rings of 6 slots of one tile (two k16
  steps: an 8 KB and a 7 KB copy); ``fwd_tiles2``: the forward's of 3
  slots of two tiles instead of three;
  ``small_slots8``: 8 slots in the small form instead of 4;
* ``mma_sync``: the large forms on mma.sync (8 warps of 32 x 56, ldmatrix
  fragments, 6 slots of one tile) instead of wgmma.

``no_lo_writes`` and the variants must leave the DEFAULT results bit for
bit as shipped (checked and printed as ``identical``); the others time
wrong arithmetic.
Each probe keeps every mbarrier's expected bytes equal to what is copied to
it: a probe that broke that would hang its launch.

For each tree and probe, at the main path's shape (``massive_mimo()`` at 8
dB, 2048 trials, the state after two plain DEFAULT iterations, as
chip_smoke's ``kernel_timing_tiled_default`` takes it): the iteration as
the plane loop runs it (``ms``: on the split x and var that the previous
call's denoiser wrote; ``ms_with_split``: a first iteration, with its
split launch) and each launch timed apart (``stages``: the split launch,
forward, fold, adjoint and the denoiser with its split writes for the next
call), by CUDA events; at the phase-2 shape (``tail``: the trials still
active after 40 DEFAULT iterations of 2048 at 18 dB, gathered) the
iteration's ``tail_ms``.  Per tree: the DEFAULT instances' ptxas lines and
the bytes the product ring copies into shared memory per launch
(``engine_bytes``, from the tree's wrapper: each block copies its operand
tiles once per ring slot).  Rounds in turns: the probes in order, then
reversed.

    git archive <commit> amp_sparc_spatialmodulation_tpu_torch | \\
        (mkdir -p build/parent && tar -x -C build/parent)
    env PYTHONPATH=. python3 tests/torch_k5_default_probes.py \\
        [--parent build/parent] [--probes shipped,no_mma,...] [--rounds 2]

Prints one JSON line per timing and per tree.  Needs the card and
``nvcc``; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from torch_k1_passes import compile_all, ptxas_lines  # noqa: E402
from torch_kernel_ab import wrapper_module  # noqa: E402

from amp_sparc_spatialmodulation_tpu_torch.config import (  # noqa: E402
    massive_mimo)
from amp_sparc_spatialmodulation_tpu_torch.models import (  # noqa: E402
    bamp, montecarlo)
from amp_sparc_spatialmodulation_tpu_torch.utils.device import (  # noqa: E402
    make_generator)

ROOT = Path(__file__).resolve().parents[1]
NAME = "fused_bamp_tiled"
P = "default"
# probe: forms of its edit, each a list of (old, new) text replacements
PROBES = {
    "shipped": [[]],
    "half_copies": [
        [("    mbar_expect(&full[slot], n * (F::kTileA + F::kTileB));",
          "    mbar_expect(&full[slot], n * (F::kTileA + F::kTileB) / 2);"),
         ("              n * F::kTileA, &full[slot]);",
          "              n * F::kTileA / 2, &full[slot]);"),
         ("              n * F::kTileB, &full[slot]);",
          "              n * F::kTileB / 2, &full[slot]);")],
        [("    mbar_expect(&bar[slot], F::kSlot);",
          "    mbar_expect(&bar[slot], F::kSlot / 2);"),
         ("                F::kTileA, &bar[slot]);",
          "                F::kTileA / 2, &bar[slot]);"),
         ("                F::kTileB, &bar[slot]);",
          "                F::kTileB / 2, &bar[slot]);")]],
    "no_tap_copies": [
        [("    mbar_expect(&full[slot], n * (F::kTileA + F::kTileB));",
          "    mbar_expect(&full[slot], n * F::kTileA);"),
         ("    bulk_copy(dst + F::kSlotA,",
          "    if (false) bulk_copy(dst + F::kSlotA,")],
        [("    mbar_expect(&bar[slot], F::kSlot);",
          "    mbar_expect(&bar[slot], F::kSlotA);"),
         ("      bulk_copy(s + F::kSlotA + k * F::kTileB,",
          "      if (false) bulk_copy(s + F::kSlotA + k * F::kTileB,")]],
    "no_trial_copies": [
        [("    mbar_expect(&full[slot], n * (F::kTileA + F::kTileB));",
          "    mbar_expect(&full[slot], n * F::kTileB);"),
         ("    bulk_copy(dst,\n",
          "    if (false) bulk_copy(dst,\n")],
        [("    mbar_expect(&bar[slot], F::kSlot);",
          "    mbar_expect(&bar[slot], F::kSlotB);"),
         ("      bulk_copy(s + k * F::kTileA,",
          "      if (false) bulk_copy(s + k * F::kTileA,")]],
    "no_copies": [
        [("    mbar_expect(&full[slot], n * (F::kTileA + F::kTileB));",
          "    mbar_expect(&full[slot], 0);"),
         ("    bulk_copy(dst,\n",
          "    if (false) bulk_copy(dst,\n"),
         ("    bulk_copy(dst + F::kSlotA,",
          "    if (false) bulk_copy(dst + F::kSlotA,")]],
    "no_mma": [
        [("                mma_bf16_zero(th, a[k][i], b[j][2 * k], "
          "b[j][2 * k + 1]);",
          "                th[0] = th[1] = th[2] = th[3] = 0.f;"),
         ("            wgmma_m64n112_zero(d0, da, db);\n"
          "            wgmma_m64n112_zero(d1, da + 2, db + 2);",
          "            for (int w = 0; w < 56; ++w) d0[w] = d1[w] = 0.f;\n"
          "            if (da == db) wgmma_m64n112_zero(d1, da + 2, db + 2);")],
        [("          mma_bf16_zero(th, ah[i], b[j][0], b[j][1]);",
          "          th[0] = th[1] = th[2] = th[3] = 0.f;")]],
    "no_last_stores": [
        [("    float* o = out + static_cast<size_t>(R) * cols + n;\n",
          "    if (p.B > 0) return;\n"
          "    float* o = out + static_cast<size_t>(R) * cols + n;\n")],
        [("          if (kFwd || p.act[(R0 + r) / p.Lin])\n"
          "            bulk_store(",
          "          if (false)\n            bulk_store(")]],
    "no_denoise_split": [[("    if (p.xs_next == nullptr) return;\n",
                           "    return;\n")]],
    # the parent's DEFAULT instance (the HIGH engine's kOne) alone
    "no_lo_writes": [
        [("if (!kOne) ldmatrix_x4(al[i], sa + a_lo[i]);",
          "if (!kOne) ldmatrix_x4(al[i], sa + a_lo[i]);"),
         ("  for (int c = 0; c < 4; ++c)\n"
          "    dst[split_chunk(c, r)] =",
          "  for (int c = 0; c < 2; ++c)\n"
          "    dst[split_chunk(c, r)] ="),
         ("    z[split_at(p.kas, kHRows, R, w, 1)] = lo;\n", ""),
         ("    p.xs_next[lo_at] = l;\n", ""),
         ("    p.xs_next[xplane + lo_at] = l;\n", "")]],
    # the DEFAULT engine's products accumulated in the tensor cores (no
    # FP32 add a step: other bits, the cost of the adds)
    "no_adds": [[("""              acc[0][j][e] = acc[0][j][e] + d0[4 * j + e];""",
                  """              acc[0][j][e] = d0[4 * j + e];"""),
                 ("""              acc[0][j][e] = acc[0][j][e] + d1[4 * j + e];""",
                  """              acc[0][j][e] = fmaxf(acc[0][j][e], d1[4 * j + e]);""")]],
    # the DEFAULT adjoint's per-tile work: its parks before the last
    # product, its x loads, its reciprocals
    "no_parks": [[("""              if (q == 0) *p0 = v;
              else if (q == 1) *p1 = *p0 + v;
              else *p0 = *p0 - v;""",
                   """              if (p.B < 0) *p0 = v;""")]],
    "no_xload": [[("            if (R < rows && n < cols) {\n"
                   "              const float* xp",
                   "            if (p.B < 0) {\n"
                   "              const float* xp")]],
    "no_rcp": [[("            const float c0 = 1.f / acc[i][j][2 * h];\n"
                 "            const float c1 = 1.f / acc[i][j][2 * h + 1];",
                 "            const float c0 = acc[i][j][2 * h];\n"
                 "            const float c1 = acc[i][j][2 * h + 1];")]],
    # variants of the DEFAULT engine (the results stay as they are)
    "tile_slots6": [[("using DefaultLarge = DefaultForm<8, 1, 1, 14, 3, 1, true, 3>;",
                      "using DefaultLarge = DefaultForm<8, 1, 1, 14, 6, 1, true>;"),
                     ("using DefaultLargeAdjoint = DefaultForm<8, 1, 1, 14, 3, 1, true, 2>;",
                      "using DefaultLargeAdjoint = DefaultForm<8, 1, 1, 14, 6, 1, true>;")]],
    "fwd_tiles2": [[("using DefaultLarge = DefaultForm<8, 1, 1, 14, 3, 1, true, 3>;",
                     "using DefaultLarge = DefaultForm<8, 1, 1, 14, 3, 1, true, 2>;")]],
    "mma_sync": [[("using DefaultLarge = DefaultForm<8, 1, 1, 14, 3, 1, true, 3>;",
                   "using DefaultLarge = DefaultForm<4, 2, 2, 7, 6, 1>;"),
                  ("using DefaultLargeAdjoint = DefaultForm<8, 1, 1, 14, 3, 1, true, 2>;",
                   "using DefaultLargeAdjoint = DefaultForm<4, 2, 2, 7, 6, 1>;")]],
    "small_slots8": [[("using DefaultSmall = DefaultForm<2, 1, 1, 2, 4, 4>;",
                       "using DefaultSmall = DefaultForm<2, 1, 1, 2, 8, 4>;")]],
}


def csrc(root: Path) -> Path:
    return root / "amp_sparc_spatialmodulation_tpu_torch" / "ops" / \
        "kernels" / "csrc"


def probe_text(src: str, probe: str):
    """The source with the first form of ``probe``'s edit that fits, or
    None where none does."""
    for form in PROBES[probe]:
        if all(old in src for old, _ in form):
            for old, new in form:
                src = src.replace(old, new)
            return src
    return None


def default_ptxas(log: str) -> list:
    """The ptxas lines of the DEFAULT form's product instances (the
    high_product_kernel entries with kOne true, or an engine of the
    DEFAULT form's own)."""
    lines = ptxas_lines(log)
    out, keep = [], False
    for ln in lines:
        if "Compiling entry" in ln:
            keep = ("product_kernel" in ln and "Lb1EEEv" in ln) or \
                "default" in ln.lower()
        if keep:
            out.append(ln)
    return out


def shapes(dev, kern):
    """(cfg, op, sigma2, planes) of the main path's 8 dB state at 2048
    trials and of the phase-2 shape, drawn at DEFAULT."""
    m = massive_mimo()
    r = montecarlo.generate_realization(
        make_generator(dev, 45), m, "sparc", "banded", cs.MASSIVE_RES,
        cs.snr_of(m, cs.MASSIVE_HIGH_DB), P)
    s0 = bamp.initial_state(r.y, m.N, r.sigma2)
    main = bamp.to_planes(kern.decode_plain(r.A, s0, r.y, r.sigma2,
                                            cs.K5_HIGH_PRESTEPS, m, P))
    cfg = cs.massive_main_config()
    r2 = montecarlo.generate_realization(
        make_generator(dev, 43), cfg, "sparc", "banded", cs.MASSIVE_RES,
        cs.snr_of(cfg, cs.MASSIVE_EBN0_DB), P)
    s0 = bamp.initial_state(r2.y, cfg.N, r2.sigma2)
    s1 = bamp.plane_loop(lambda *a: kern.iteration(*a, precision=P), r2.A,
                         s0, r2.y, r2.sigma2, cs.MASSIVE_K1, cfg)
    idx = torch.nonzero(s1.active).flatten()
    tail = bamp.to_planes(montecarlo.state_take_trials(s1, idx))
    y = lambda v: (v.real.contiguous(), v.imag.contiguous())
    return {"main": (m, r.A, r.sigma2, main, *y(r.y)),
            "tail": (cfg, r2.A, r2.sigma2, tail, *y(r2.y[idx]))}


def stages(mod, op, ps, y_re, y_im, sigma2, cfg, reps=10) -> dict:
    """Each launch of one DEFAULT call timed apart by CUDA events, the
    denoiser with its split writes for the next call, after one whole
    call that fills the buffers."""
    out, scratch, cov = mod._buffers(ps, cfg)
    split = mod._split_buffers(ps, cfg, None, P) if _takes_form(mod) \
        else mod._split_buffers(ps, cfg)
    nxt = torch.empty_like(split[0])
    whole = mod.ALL_STAGES | mod.SPLIT_STAGE
    times = {}
    for name, mask in [("split", mod.SPLIT_STAGE), *mod.STAGES.items()]:
        launch = lambda m=mask: mod._launch(op, ps, y_re, y_im, sigma2, cfg,
                                            out, scratch, cov, m, P, split,
                                            nxt)
        launch(whole)
        times[name] = cs.cuda_ms(launch, 1, reps)
    return times


def _takes_form(mod) -> bool:
    import inspect
    return "precision" in inspect.signature(mod._split_buffers).parameters


def result(k) -> list:
    return [t.clone() for t in k]


def same(a, b, active) -> bool:
    names = ("xmap_re", "xmap_im", "xm_re", "xm_im", "var", "z_re", "z_im",
             "u", "notok")
    return all(torch.equal(x[active], y[active]) if n.startswith("xmap")
               else torch.equal(x, y) for n, x, y in zip(names, a, b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--probes", default=",".join(PROBES))
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_k5_default_probes: no CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"device": cs.nvidia_smi()}), flush=True)
    roots = {"change": ROOT}
    if args.parent is not None:
        roots = {"parent": args.parent.resolve(), **roots}
    probes = args.probes.split(",")
    jobs, skipped = {}, []
    for tree, root in roots.items():
        src = (csrc(root) / f"{NAME}.cu").read_text()
        for probe in probes:
            text = probe_text(src, probe)
            if text is None:
                skipped.append((tree, probe))
                continue
            d = ROOT / "build" / "k5d_probes" / tree / probe
            shutil.rmtree(d, ignore_errors=True)
            d.mkdir(parents=True)
            for h in csrc(root).glob("*.cuh"):
                shutil.copy(h, d / h.name)
            (d / f"{NAME}.cu").write_text(text)
            jobs[(NAME, tree, probe)] = d
    print(json.dumps({"skipped": skipped}), flush=True)
    built = compile_all(jobs)
    mods = {tree: wrapper_module(root, NAME, tree)
            for tree, root in roots.items()}
    libs = {}
    for (_, tree, probe), (path, log) in built.items():
        libs[(tree, probe)] = mods[tree].typed(ctypes.CDLL(str(path)))
        if probe == "shipped":
            print(json.dumps({"tree": tree, "ptxas_default":
                              default_ptxas(log)}), flush=True)

    here = mods["change"]
    here._library = lambda lib=libs[("change", "shipped")]: lib
    sh = shapes(dev, here)
    for tree, mod in mods.items():
        if hasattr(mod, "engine_bytes"):
            cfg, op, sigma2, ps, *_ = sh["main"]
            # the DEFAULT engine's copies, and the HIGH layout's (those of a
            # tree whose DEFAULT form ran the HIGH engine)
            print(json.dumps({"tree": tree, "engine_bytes": {
                q: mod.engine_bytes(ps.var.shape[0], cfg, q)
                for q in (P, "high")}}), flush=True)

    def run(tree, probe):
        mod = mods[tree]
        mod._library = lambda lib=libs[(tree, probe)]: lib
        line = {"tree": tree, "probe": probe}
        cfg, op, sigma2, ps, y_re, y_im = sh["main"]
        call = lambda s=ps: mod.iteration(op, s, y_re, y_im, sigma2, cfg, P)
        line["ms_with_split"] = cs.cuda_ms(call, 1, 10)
        # the plane loop's next state: its call takes the split planes the
        # previous call's denoiser wrote
        nxt = bamp.advance(ps, call())
        line["ms"] = cs.cuda_ms(lambda: call(nxt), 1, 10)
        line["stages"] = stages(mod, op, ps, y_re, y_im, sigma2, cfg)
        if probe == "shipped":
            line["stage_ms"] = mod.stage_ms(op, ps, y_re, y_im, sigma2, cfg,
                                            precision=P)
        tcfg, top, tsig, tps, ty_re, ty_im = sh["tail"]
        tcall = lambda s=tps: mod.iteration(top, s, ty_re, ty_im, tsig,
                                            tcfg, P)
        tnxt = bamp.advance(tps, tcall())
        line["tail_B"] = int(tps.var.shape[0])
        line["tail_ms"] = cs.cuda_ms(lambda: tcall(tnxt), 2, 20)
        line["tail_ms_with_split"] = cs.cuda_ms(tcall, 2, 20)
        return line, result(call(nxt)), nxt.active

    timings = {}
    firsts = {}
    for rnd in range(args.rounds):
        order = [(t, p) for p in probes for t in mods
                 if (t, p) in libs]
        if rnd % 2:
            order.reverse()
        for tree, probe in order:
            line, res, active = run(tree, probe)
            if rnd == 0:
                firsts[(tree, probe)] = (res, active)
            line["round"] = rnd
            timings.setdefault((tree, probe), []).append(line["ms"])
            print(json.dumps(line), flush=True)
            del res
    for tree in mods:
        base = firsts.get((tree, "shipped"))
        for probe in probes:
            if (tree, probe) not in firsts:
                continue
            summary = {"tree": tree, "probe": probe,
                       "median_ms": statistics.median(
                           timings[(tree, probe)])}
            if base is not None and probe != "shipped":
                summary["identical"] = same(base[0], firsts[(tree, probe)][0],
                                            base[1])
            print(json.dumps(summary), flush=True)
    if "parent" in mods and ("parent", "shipped") in firsts and \
            ("change", "shipped") in firsts:
        a, b = firsts[("parent", "shipped")], firsts[("change", "shipped")]
        print(json.dumps({"shipped_trees_identical": same(a[0], b[0], a[1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
