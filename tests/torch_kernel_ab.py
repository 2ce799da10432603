"""Time the port's CUDA kernels of this checkout against those of another
checkout, in turns on one card.

Two versions are compared only inside one process on one card: each kernel
is built from both source trees and launched through that tree's own
wrapper module (so each gets its own shared-memory carve-out), run once to
warm up, then timed by CUDA events in the order parent, change, change,
parent (and so on for more rounds).  Every timed result must equal its
tree's first bit for bit.  The shapes are the main paths': BAMP
(``flagship_bamp_ook()``, Eb/N0 = 8 dB) phase 1, 65536 trials to k1=12,
and phase 2, the trials still active after that phase 1, gathered, to the
cap of 100; SCAMP (the OOK sparc point at the same dimensions) phase 1,
65536 trials to k1=8, and phase 2, its still-active trials, gathered, to
the cap of 100; VAMP and vamp2 (K3, K4) at the VAMP OOK point
(``chip_smoke.vamp_main_config()``, Eb/N0 = 8 dB, dense SPARC channel),
65536 trials to the cap of 10; K6 and K7 (``periter_fused``,
``periter_linear``) for one iteration at chip_smoke's timing shape
(``flagship_bamp_ook()``, 65536 trials, the state after 2 plain
iterations), and K6 at the periter path's tail shape (``periter_tail``:
the same trials with one in 100 active, the rest frozen); K5 for one
iteration at the massive main path's two shapes
(``chip_smoke.massive_main_config()``, Eb/N0 = 18 dB): ``tiled``, 2048
trials, all active, from the initial state, and ``tiled_tail``, the
trials still active after a 40-iteration phase 1 of those, gathered (as
chip_smoke's ``kernel_phase2_tiled`` builds them); ``vamp_high_cap10`` and
``vamp2_high_cap10``, the HIGH form of K3 and K4 (``precision='high'``,
bf16 x 3 on the tensor cores) at the VAMP shape above, and
``tiled_high`` and ``tiled_high_tail``, the HIGH form of K5 for one
iteration at the massive point's HIGH shapes (``tiled_high``: 2048 trials
of ``massive_mimo()`` at Eb/N0 = 8 dB after two plain HIGH iterations and
one of this checkout's K5 at HIGH, the state of chip_smoke's
``kernel_timing_tiled_high``; ``tiled_high_tail``: the trials still active
after 40 HIGH iterations of 2048 at 18 dB, run by this checkout's K5,
gathered, and one iteration more, chip_smoke's phase-2 shape), and
``bamp_high_qpsk`` and ``bamp_high_ook``, the HIGH form of K1 at
chip_smoke's two timed K1-high shapes (the QPSK flagship, 4096 trials at
5 dB to the cap of 100, seed 42, the main path's shape; the OOK flagship,
65536 trials at 8 dB to k1=12, seed 41), each timed only
for a tree whose wrapper takes ``precision`` (a tree without the HIGH form
is left out of the case); ``vamp_default_cap10``, ``vamp2_default_cap10``,
``tiled_default``, ``tiled_default_tail``, ``bamp_default_qpsk`` and
``bamp_default_ook``, the same cases of the DEFAULT form
(``precision='default'``, one bf16 pass; a tree without it is left out);
``bamp_xmap_<v>_<x>_qpsk`` and ``..._ook`` for the six (variance chain,
xmap chain) pairs of K1's split forms (``AMP_KERNEL_XMAP_PRECISION``),
at the same two shapes drawn at ``v`` (a tree without them is left out).
The two trees' results
must be bit-identical for K1, K2, K5 and K6 (every plane and ``notok``;
xmap on the active trials, the only ones K5 and K6 write it for) and K7;
for K3 and K4, whose product engine may sum in another order from one
tree to the other, they are held to
``chip_smoke.compare_vamp``'s ``trial_share`` rule instead, and the
bit-identical share is printed; K5's HIGH and DEFAULT results are not
held (their bits may change from tree to tree, the rules of chip_smoke
hold them): whether they are identical and the share of bit-identical
elements are printed; so are K1's HIGH, DEFAULT and split results'.
At the K5 HIGH and DEFAULT cases each tree first runs one iteration of
its own from the shared state, so that the timed call takes the split
planes its own denoiser laid out.  A kernel whose source the other checkout
lacks is timed on its own.  ``--cases`` picks cases by name.

    git archive <commit> amp_sparc_spatialmodulation_tpu_torch | \\
        (mkdir -p build/parent && tar -x -C build/parent)
    env PYTHONPATH=. python3 tests/torch_kernel_ab.py --parent build/parent \\
        [--cases scamp_phase1,scamp_phase2]
    env PYTHONPATH=. python3 tests/torch_kernel_ab.py --parent build/parent \\
        --cases periter_fused,periter_linear,periter_tail
    env PYTHONPATH=. python3 tests/torch_kernel_ab.py --parent build/parent \\
        --cases tiled,tiled_tail --rounds 3
    env PYTHONPATH=. python3 tests/torch_kernel_ab.py --parent build/parent \\
        --cases tiled_high,tiled_high_tail --rounds 4
    env PYTHONPATH=. python3 tests/torch_kernel_ab.py --parent build/parent \\
        --cases tiled,tiled_tail,tiled_high,tiled_high_tail,tiled_default,\\
tiled_default_tail
    env PYTHONPATH=. python3 tests/torch_kernel_ab.py --parent build/parent \\
        --cases bamp_high_qpsk,bamp_high_ook,bamp_phase1,bamp_phase2
    env PYTHONPATH=. python3 tests/torch_kernel_ab.py --parent build/parent \\
        --cases bamp_default_qpsk,bamp_xmap_default_highest_qpsk

Prints one JSON line per timing, then one summary line per case.  Needs
the card and ``nvcc``; imports no JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import re
import statistics
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from amp_sparc_spatialmodulation_tpu_torch.config import (Config,
                                                          flagship_bamp_ook)
from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
from amp_sparc_spatialmodulation_tpu_torch.models import scamp
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import build
from amp_sparc_spatialmodulation_tpu_torch.utils.device import make_generator

RES = 65536
REPS = 4
PACKAGE = "amp_sparc_spatialmodulation_tpu_torch.ops.kernels"


class Step(NamedTuple):
    """One iteration of K6 or K7: the wrapper's outputs, and the trials
    whose xmap the kernel writes (K6 leaves a frozen trial's unwritten;
    None for K7)."""
    out: tuple
    rows: Optional[torch.Tensor]


def wrapper_module(root: Path, module: str, label: str):
    """The wrapper module ``module`` of the checkout at ``root``, loaded
    inside this checkout's package, so that its relative imports (config,
    models, build) resolve to this checkout's; the names it imports from
    another wrapper module (``from .fused_vamp import high_taps``) are
    rebound to that checkout's own, which lays out what its kernel
    reads."""
    kernels = root / "amp_sparc_spatialmodulation_tpu_torch" / "ops" / "kernels"
    path = kernels / f"{module}.py"
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}._{label}_{module}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for sibling, names in re.findall(r"^from \.(\w+) import ([\w, ]+)$",
                                     path.read_text(), flags=re.M):
        if sibling.startswith("fused_") and (kernels
                                             / f"{sibling}.py").is_file():
            own = wrapper_module(root, sibling, label)
            for name in names.replace(" ", "").split(","):
                setattr(mod, name, getattr(own, name))
    return mod


def _cases(dev, wanted=frozenset()):
    """(case name, kernel name, wrapper module, launch) per case named in
    ``wanted`` (every case when it is empty), made as they are reached;
    ``launch(mod)`` runs wrapper module ``mod`` once on a fixed input and
    returns its state."""
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp

    def want(*names):
        return not wanted or bool(wanted.intersection(names))

    if want("bamp_phase1", "bamp_phase2"):
        cfg = flagship_bamp_ook()
        snr = 10 ** ((8.0 + 10 * math.log10(cfg.code_rate)) / 10)
        r = montecarlo.generate_realization(make_generator(dev, 11), cfg,
                                            "sparc", "banded", RES, snr)
        s0 = bamp.initial_state(r.y, cfg.N, r.sigma2)
        yield ("bamp_phase1", "fused_bamp_decode", "fused_bamp",
               lambda mod: mod.whole_decode(r.A, s0, r.y, r.sigma2, 12,
                                            cfg))
        s1 = fused_bamp.whole_decode(r.A, s0, r.y, r.sigma2, 12, cfg)
        idx = torch.nonzero(s1.active).flatten()
        y2, s2 = r.y[idx], montecarlo.state_take_trials(s1, idx)
        yield ("bamp_phase2", "fused_bamp_decode", "fused_bamp",
               lambda mod: mod.whole_decode(r.A, s2, y2, r.sigma2,
                                            cfg.N_Layers, cfg))
    if want("scamp_phase1", "scamp_phase2"):
        from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
            fused_scamp)
        scfg = Config(Nt=128, Na=8, Nr=24, Lin=20, Lh=3, mode="sparc",
                      alphabet="OOK", profile="uniform", trunc="tail",
                      iterations=100)
        snr = 10 ** ((8.0 + 10 * math.log10(scfg.code_rate)) / 10)
        rs = montecarlo.generate_realization(make_generator(dev, 21), scfg,
                                             "sparc", "banded", RES, snr)
        ss0 = scamp.initial_state(rs.y, scfg)
        if want("scamp_phase1"):
            yield ("scamp_phase1", "fused_scamp_decode", "fused_scamp",
                   lambda mod: mod.whole_decode(rs.A, rs.W, ss0, rs.y,
                                                rs.sigma2, 8, scfg))
        if want("scamp_phase2"):
            ss1 = fused_scamp.whole_decode(rs.A, rs.W, ss0, rs.y, rs.sigma2,
                                           8, scfg)
            idx = torch.nonzero(ss1.active).flatten()
            ys2, ss2 = rs.y[idx], montecarlo.state_take_trials(ss1, idx)
            yield ("scamp_phase2", "fused_scamp_decode", "fused_scamp",
                   lambda mod: mod.whole_decode(rs.A, rs.W, ss2, ys2,
                                                rs.sigma2, scfg.N_Layers,
                                                scfg))
    for algo in ("vamp", "vamp2"):
        if want(f"{algo}_cap10"):
            yield _vamp_case(dev, algo)
        for precision in ("high", "default"):
            if want(f"{algo}_{precision}_cap10"):
                yield _vamp_case(dev, algo, precision)
    if want("periter_fused", "periter_linear", "periter_tail"):
        yield from _periter_cases(dev, want)
    if want("tiled", "tiled_tail"):
        yield from _tiled_cases(dev, want)
    for p in ("high", "default"):
        if want(f"tiled_{p}", f"tiled_{p}_tail"):
            yield from _tiled_high_cases(dev, want, p)
        if want(f"bamp_{p}_qpsk", f"bamp_{p}_ook"):
            yield from _bamp_high_cases(dev, want, p)
    for v, x in XMAP_PAIRS:
        if want(f"bamp_xmap_{v}_{x}_qpsk", f"bamp_xmap_{v}_{x}_ook"):
            yield from _bamp_high_cases(dev, want, v, x)


def _periter_cases(dev, want):
    """K6 and K7 for one iteration at chip_smoke's timing shape: the
    flagship, 65536 trials, the state after 2 plain iterations; K6 also
    with one trial in 100 of them active."""
    cfg = flagship_bamp_ook()
    snr = 10 ** ((8.0 + 10 * math.log10(cfg.code_rate)) / 10)
    r = montecarlo.generate_realization(make_generator(dev, 53), cfg,
                                        "sparc", "banded", RES, snr)
    st = bamp.plain_loop(r.A, bamp.initial_state(r.y, cfg.N, r.sigma2),
                         r.y, r.sigma2, 2, cfg)
    ps = bamp.to_planes(st)
    y_re, y_im = r.y.real.contiguous(), r.y.imag.contiguous()
    if want("periter_fused"):
        yield ("periter_fused", "fused_bamp_iteration",
               "fused_bamp_iteration",
               lambda mod: Step(mod.iteration_fused(r.A, ps, y_re, y_im,
                                                    r.sigma2, cfg),
                                ps.active))
    if want("periter_tail"):
        act = torch.zeros_like(ps.active)
        act[::100] = True
        tail = ps._replace(active=act & ps.active)
        yield ("periter_tail", "fused_bamp_iteration",
               "fused_bamp_iteration",
               lambda mod: Step(mod.iteration_fused(r.A, tail, y_re, y_im,
                                                    r.sigma2, cfg),
                                tail.active))
    if want("periter_linear"):
        yield ("periter_linear", "fused_bamp_iteration",
               "fused_bamp_iteration",
               lambda mod: Step(mod.iteration_linear(
                   r.A, st.xmmse, st.var, st.z, st.u, r.y, r.sigma2, cfg),
                   None))


def tiled_shapes(dev, tail=True):
    """K5's two main-path shapes at the massive point: (cfg, op, sigma2,
    shapes) with shapes {"tiled": (planes, y_re, y_im)} for 2048 trials,
    all active, in the initial state and, with ``tail``, "tiled_tail" for
    the trials still active after a 40-iteration phase 1 of those (run by
    this checkout's K5), gathered."""
    import chip_smoke
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_bamp_tiled)
    cfg = chip_smoke.massive_main_config()
    r = montecarlo.generate_realization(
        make_generator(dev, 43), cfg, "sparc", "banded",
        chip_smoke.MASSIVE_RES,
        chip_smoke.snr_of(cfg, chip_smoke.MASSIVE_EBN0_DB))
    s0 = bamp.initial_state(r.y, cfg.N, r.sigma2)
    planes = lambda s, y: (bamp.to_planes(s), y.real.contiguous(),
                           y.imag.contiguous())
    shapes = {"tiled": planes(s0, r.y)}
    if tail:
        s1 = bamp.plane_loop(fused_bamp_tiled.iteration, r.A, s0, r.y,
                             r.sigma2, chip_smoke.MASSIVE_K1, cfg)
        idx = torch.nonzero(s1.active).flatten()
        shapes["tiled_tail"] = planes(montecarlo.state_take_trials(s1, idx),
                                      r.y[idx])
    return cfg, r.A, r.sigma2, shapes


def _tiled_cases(dev, want):
    """K5 for one iteration at the massive main path's two shapes."""
    cfg, op, sigma2, shapes = tiled_shapes(dev, want("tiled_tail"))
    for case, (ps, y_re, y_im) in shapes.items():
        if want(case):
            yield (case, "fused_bamp_tiled", "fused_bamp_tiled",
                   lambda mod, ps=ps, y_re=y_re, y_im=y_im: Step(
                       mod.iteration(op, ps, y_re, y_im, sigma2, cfg),
                       ps.active))


def _tiled_high_cases(dev, want, precision="high"):
    """K5's HIGH (or DEFAULT) form for one iteration at the massive
    point's HIGH shapes, drawn and run at ``precision``."""
    import chip_smoke
    from amp_sparc_spatialmodulation_tpu_torch.config import massive_mimo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_bamp_tiled)
    planes = lambda s, y: (bamp.to_planes(s), y.real.contiguous(),
                           y.imag.contiguous())
    shapes = {}
    p = precision
    if want(f"tiled_{p}"):
        m = massive_mimo()
        r = montecarlo.generate_realization(
            make_generator(dev, 45), m, "sparc", "banded",
            chip_smoke.MASSIVE_RES, chip_smoke.snr_of(m, 8.0), p)
        s0 = bamp.initial_state(r.y, m.N, r.sigma2)
        s2 = fused_bamp_tiled.decode_plain(r.A, s0, r.y, r.sigma2,
                                           chip_smoke.K5_HIGH_PRESTEPS, m, p)
        shapes[f"tiled_{p}"] = (m, r.A, r.sigma2, planes(s2, r.y))
    if want(f"tiled_{p}_tail"):
        cfg = chip_smoke.massive_main_config()
        r = montecarlo.generate_realization(
            make_generator(dev, 43), cfg, "sparc", "banded",
            chip_smoke.MASSIVE_RES,
            chip_smoke.snr_of(cfg, chip_smoke.MASSIVE_EBN0_DB), p)
        s0 = bamp.initial_state(r.y, cfg.N, r.sigma2)
        it = lambda *a: fused_bamp_tiled.iteration(*a, precision=p)
        s1 = bamp.plane_loop(it, r.A, s0, r.y, r.sigma2,
                             chip_smoke.MASSIVE_K1, cfg)
        idx = torch.nonzero(s1.active).flatten()
        shapes[f"tiled_{p}_tail"] = (
            cfg, r.A, r.sigma2,
            planes(montecarlo.state_take_trials(s1, idx), r.y[idx]))
    for case, (cfg, op, sigma2, (ps, y_re, y_im)) in shapes.items():
        # one iteration more by each tree's own K5 at this precision, as
        # the plane loop runs it: the next call takes the split x and var
        # planes its denoiser wrote, in that tree's layout (a tree without
        # them splits them itself); the trees' next states are the same
        # where their kernels are
        nxt = {}

        def launch(mod, cfg=cfg, op=op, sigma2=sigma2, ps=ps, y_re=y_re,
                   y_im=y_im, nxt=nxt):
            if mod not in nxt:
                nxt[mod] = bamp.advance(ps, mod.iteration(
                    op, ps, y_re, y_im, sigma2, cfg, p))
            s = nxt[mod]
            return Step(mod.iteration(op, s, y_re, y_im, sigma2, cfg, p),
                        s.active)

        yield case, "fused_bamp_tiled", "fused_bamp_tiled", launch


# K1's split forms: (variance chain, xmap chain) precision pairs.
XMAP_PAIRS = (("highest", "high"), ("highest", "default"),
              ("high", "default"), ("high", "highest"),
              ("default", "high"), ("default", "highest"))


def _bamp_high_cases(dev, want, precision="high", x_precision=None):
    """K1's HIGH (or DEFAULT) form at its two timed shapes, as chip_smoke's
    kernels_bamp_high builds them: the QPSK flagship, 4096 trials at 5 dB,
    cap 100, seed 42 (the main path's shape), and the OOK flagship at its
    phase-1 shape, 65536 trials at 8 dB, cap 12, seed 41; drawn and run at
    ``precision``; with ``x_precision``, K1's split form of that xmap
    chain (``AMP_KERNEL_XMAP_PRECISION=<x_precision>``, passed to the
    wrapper as ``x_precision``), drawn at the variance chain's precision as
    chip_smoke's kernels_bamp_xmap draws it (cases
    ``bamp_xmap_<precision>_<x_precision>_qpsk`` and ``..._ook``)."""
    import chip_smoke
    from amp_sparc_spatialmodulation_tpu_torch.config import (
        flagship_bamp_qpsk)
    tag = (precision if x_precision is None
           else f"xmap_{precision}_{x_precision}")
    for case, cfg, B, cap, ebn0, seed in (
            (f"bamp_{tag}_qpsk", flagship_bamp_qpsk(),
             chip_smoke.FLAGSHIP_B, 100, chip_smoke.BAMP_HIGH_EBN0_DB, 42),
            (f"bamp_{tag}_ook", flagship_bamp_ook(), RES,
             chip_smoke.K1, chip_smoke.EBN0_DB, 41)):
        if not want(case):
            continue
        r = montecarlo.generate_realization(
            make_generator(dev, seed), cfg, "sparc", "banded", B,
            chip_smoke.snr_of(cfg, ebn0), precision)
        s0 = bamp.initial_state(r.y, cfg.N, r.sigma2)
        yield (case, "fused_bamp_decode", "fused_bamp",
               lambda mod, cfg=cfg, r=r, s0=s0, cap=cap: mod.whole_decode(
                   r.A, s0, r.y, r.sigma2, cap, cfg, precision, x_precision))


def _vamp_case(dev, algo, precision=None):
    """K3 or K4 at the VAMP main point: 65536 trials to the cap of 10, in
    the HIGHEST form or, with ``precision='high'``, the HIGH form (whose
    y_tilde is formed at HIGH too)."""
    import chip_smoke
    from amp_sparc_spatialmodulation_tpu_torch.models import vamp, vamp2
    mod_, data = ((vamp, vamp.project) if algo == "vamp"
                  else (vamp2, vamp2.whiten))
    cfg = chip_smoke.vamp_main_config()
    r = montecarlo.with_svd(algo, montecarlo.generate_realization(
        make_generator(dev, 29), cfg, "sparc", "dense", RES,
        chip_smoke.snr_of(cfg, 8.0)))
    yt = data(r.dec, r.y) if precision is None else data(r.dec, r.y,
                                                          precision)
    s2 = (r.dec.s ** 2).contiguous()
    s0 = mod_.initial_state(r.y, cfg)
    tag = "" if algo == "vamp" else "2"
    if precision is None:
        return (f"{algo}_cap10", f"fused_vamp{tag}_decode",
                f"fused_vamp{tag}",
                lambda mod: mod.whole_decode(r.dec.Vh, s2, yt, s0, r.sigma2,
                                             10, cfg))
    return (f"{algo}_{precision}_cap10", f"fused_vamp{tag}_decode",
            f"fused_vamp{tag}",
            lambda mod: mod.whole_decode(r.dec.Vh, s2, yt, s0, r.sigma2, 10,
                                         cfg, precision))


def _takes_precision(mod) -> bool:
    """Whether a tree's wrapper module has the HIGH form."""
    import inspect
    entry = getattr(mod, "whole_decode", None) or mod.iteration
    return "precision" in inspect.signature(entry).parameters


def _libraries(name, mods, trees):
    """The loaded library of kernel ``name`` built from each source tree
    that has it, keyed by the tree's label."""
    libs = {}
    here = build.CSRC
    try:
        for label, csrc in trees.items():
            if not (csrc / f"{name}.cu").is_file():
                continue
            build.CSRC = csrc
            build._loaded.pop(name, None)
            libs[label] = mods[label]._library()
    finally:
        build.CSRC = here
        build._loaded.pop(name, None)
    return libs


def _same(a, b) -> bool:
    if isinstance(a, Step):
        names = getattr(a.out, "_fields", ("",) * len(a.out))
        return all(torch.equal(x[a.rows], y[a.rows]) if n.startswith("xmap")
                   else torch.equal(x, y)
                   for n, x, y in zip(names, a.out, b.out))
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in a._fields if f != "t")


def _same_share(a, b) -> float:
    """The share of the elements of two K5 results (xmap on the active
    trials only), or of two whole-decode states, that are bit-identical."""
    if isinstance(a, Step):
        names, xs, ys = a.out._fields, a.out, b.out
    else:
        names = [f for f in a._fields if f != "t"]
        xs = [getattr(a, f) for f in names]
        ys = [getattr(b, f) for f in names]
    same = total = 0
    for n, x, y in zip(names, xs, ys):
        if isinstance(a, Step) and n.startswith("xmap"):
            x, y = x[a.rows], y[a.rows]
        same += int((x == y).sum())
        total += x.numel()
    return same / total


def _trials(result) -> int:
    return (int(result.out[0].shape[0]) if isinstance(result, Step)
            else int(result.T.numel()))


def _across(case, first) -> dict:
    """The two trees' results against each other: bit identity, or for K3
    and K4 ``compare_vamp``'s ``trial_share`` rule (tolerance 1e-3)."""
    if len(first) < 2:
        return {}
    a, b = first["change"], first["parent"]
    if case.startswith(("tiled_high", "tiled_default", "bamp_high",
                        "bamp_default", "bamp_xmap")):
        return {"identical": _same(a, b),
                "bit_identical_share": _same_share(a, b)}
    identical = _same(a, b)
    if not case.startswith("vamp"):
        if not identical:
            raise AssertionError(f"{case}: the trees differ")
        return {"identical": True}
    import chip_smoke
    failed = []
    err = chip_smoke.compare_vamp(f"ab_{case}", a, b, 1e-3, failed, cap=10)
    if failed:
        raise AssertionError(f"{case}: the trees differ beyond the "
                             f"trial_share rule: {failed}")
    return {"identical": identical, "rule": "trial_share",
            "max_abs_err_T_agree": err}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=Path, required=True,
                   help="root of the other checkout")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--reps", type=int, default=REPS,
                   help="timed launches per turn")
    p.add_argument("--cases", default="",
                   help="comma-separated case names (default: all)")
    args = p.parse_args(argv)
    wanted = set(filter(None, args.cases.split(",")))
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    roots = {"parent": args.parent.resolve(),
             "change": Path(__file__).resolve().parents[1]}
    trees = {k: root / "amp_sparc_spatialmodulation_tpu_torch" / "ops"
             / "kernels" / "csrc" for k, root in roots.items()}
    for case, name, module, launch in _cases(dev, wanted):
        mods = {k: wrapper_module(root, module, k)
                for k, root in roots.items()}
        if "_high" in case:
            mods = {k: m for k, m in mods.items() if _takes_precision(m)}
        if "_default" in case:
            # a tree without the DEFAULT form is left out
            mods = {k: m for k, m in mods.items()
                    if hasattr(m, "launches_default")}
        if "_xmap_" in case:
            # ... and one without the split forms
            mods = {k: m for k, m in mods.items()
                    if hasattr(m, "launches_xmap")}
        libs = _libraries(name, mods, {k: trees[k] for k in mods})
        order = [k for k in ("parent", "change", "change", "parent")
                 if k in libs] * args.rounds
        times = {k: [] for k in libs}
        first = {}
        for label in order:
            build._loaded[name] = libs[label]
            out = launch(mods[label])
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                out = launch(mods[label])
            stop.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(stop) / args.reps
            first.setdefault(label, out)
            if not _same(first[label], out):
                raise AssertionError(f"{case}: {label} differs from its "
                                     "first run")
            times[label].append(ms)
            print(json.dumps({"case": case, "kernel": name, "source": label,
                              "ms": ms}), flush=True)
            del out
        build._loaded.pop(name, None)
        across = _across(case, first)
        med = {k: statistics.median(v) for k, v in times.items()}
        print(json.dumps({"case": case, "kernel": name, "device": smi,
                          "B": _trials(next(iter(first.values()))),
                          **across,
                          **{f"{k}_median_ms": v for k, v in med.items()},
                          **({"change_over_parent": med["change"]
                              / med["parent"]} if len(med) == 2 else {}),
                          **{f"{k}_ms": v for k, v in times.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
