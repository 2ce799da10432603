#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card's name and ``nvidia-smi`` name and power limit;
2. build   — every CUDA kernel built from the sources in this checkout
   (one ``nvcc`` per source, all started together), with the registers
   and spills ``ptxas`` reports;
3. kernels — each kernel against its plain PyTorch version on the card,
   at the shapes its main path gives it and on small geometries.  Every
   comparison holds the same property, which does not depend on how the
   matrix library orders its sums: T identical on >= 99.5% of trials,
   |d mean T| <= 0.02, and state within the stated tolerance (1e-4 on the
   small geometries, 1e-3 at full width) on the trials whose T agrees;
   the share of trials whose state is bit-identical is printed for
   information.  K1 (BAMP): the seven small geometries at 1024 trials (not
   64, where one trial is 1.6% of the batch), the flagship geometry at
   4096 trials.  K2 (SCAMP): the six small sparc geometries (OOK
   tail/trunc/cyclic, QPSK, 8PSK, estimate_phi) at 1024 trials, the SCAMP
   main geometry and ``config.flagship_scamp()`` at 4096 trials.  For
   each kernel its main path's phase 1 (65536 trials, cap k1) and phase 2
   (the still-active trials of that phase 1, gathered, to the cap);
   split-and-resume must give identical T.  CUDA event timings of kernel
   and plain version at both phase shapes;
4. main    — the flagship BAMP OOK point (``config.flagship_bamp_ook()``,
   SPARC channel in tap form, Eb/N0 = 8 dB, two-phase k1=12) through
   ``Simulator.run_point`` over 128 realizations of 65536 trials, with the
   kernel launch counts of that run, the scatter of a single realization's
   mean T and a per-layer breakdown of one realization;
5. main_scamp — the SCAMP OOK sparc point at the same dimensions (Eb/N0 =
   8 dB, two-phase k1=8) over 64 realizations of 65536 trials, reported
   the same way;
6. the ``{"kernels": [...]}`` summary, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the ``ok`` line.  Without a CUDA device,
or without the port's package beside this script, it exits non-zero
before printing any result.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import traceback

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# Main path: the flagship point of BASELINE.md (FER 1.54e-2, T 10.9).  The
# mean T of one channel realization scatters by most of a unit (the main
# phase prints its standard deviation over 8 realizations), so the +-0.5
# band needs tens of realizations, not 4, to hold as a check; 128 put the
# standard error of the mean near 0.05.
EBN0_DB = 8.0
RES = 65536
EPOCHS = 128 * RES
K1 = 12
SMALL_B = 1024
FLAGSHIP_B = 4096
REF_T, T_TOL = 10.9, 0.5
REF_FER, FER_FACTOR = 1.54e-2, 1.4

# SCAMP main path: the OOK sparc point at the flagship dimensions, published
# FER 9.5e-3 and T 6.6 (BASELINE.md:87) from a 10k-trial run, so its FER
# carries about 10% standard error; k1 of the JAX ladder
# (scripts/profile_scamp_ladder.py:36).
SCAMP_EPOCHS = 64 * RES
SCAMP_K1 = 8
SCAMP_REF_T, SCAMP_T_TOL = 6.6, 0.5
SCAMP_REF_FER, SCAMP_FER_FACTOR = 9.5e-3, 1.5

BAMP_FIELDS = ("xmap", "xmmse", "var", "z", "u")
SCAMP_FIELDS = ("xmap", "xmmse", "psi", "phi", "z")


def scamp_main_config():
    from amp_sparc_spatialmodulation_tpu_torch.config import Config
    return Config(Nt=128, Na=8, Nr=24, Lin=20, Lh=3, mode="sparc",
                  alphabet="OOK", profile="uniform", trunc="tail",
                  iterations=100)


def snr_of(cfg, ebn0_db):
    return 10 ** ((ebn0_db + 10 * math.log10(cfg.code_rate)) / 10)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def state_err(a, b, rows, fields=BAMP_FIELDS) -> float:
    """Max |a - b| over the state planes ``fields`` of the trials in
    ``rows``."""
    err = 0.0
    for f in fields:
        d = (getattr(a, f)[rows] - getattr(b, f)[rows]).abs()
        if d.numel():
            err = max(err, float(d.max()))
    return err


def compare(phase: str, sk, sp, tol: float, fields=BAMP_FIELDS,
            **info) -> float:
    """Hold a kernel result ``sk`` against the plain version's ``sp``: T
    identical on >= 99.5% of trials, |d mean T| <= 0.02, state planes
    ``fields`` within ``tol`` where T agrees.  Emits one line; returns the
    state error."""
    agree = sk.T == sp.T
    frac = float(agree.float().mean())
    mean_k, mean_p = float(sk.T.float().mean()), float(sp.T.float().mean())
    err = state_err(sk, sp, agree, fields)
    same = agree.clone()
    for f in fields:
        a, b = getattr(sk, f), getattr(sp, f)
        same &= (a == b).reshape(a.shape[0], -1).all(dim=1)
    exact = float(same.float().mean())
    emit(phase, **info, B=int(sk.T.numel()), T_agree_fraction=frac,
         mean_T_kernel=mean_k, mean_T_plain=mean_p,
         abs_dmean_T=abs(mean_k - mean_p), max_abs_err_T_agree=err,
         tolerance=tol, bit_exact_fraction=exact)
    if frac < 0.995 or abs(mean_k - mean_p) > 0.02 or not err < tol:
        raise AssertionError(f"kernel != plain in {phase} {info}")
    return err


def decode_work(cfg, s0, s1, tensors, products):
    """(flop, bytes, iterations) the decode of ``s0`` -> ``s1`` needs: the
    ``products`` real banded products per iteration of the iterations
    these trials ran (denoiser and base-matrix arithmetic are left out)
    and every input read once, every output written once."""
    from amp_sparc_spatialmodulation_tpu_torch.ops.channel import (
        band_indices)
    iters = int((s1.T.long() - s0.T.long()).sum())
    blocks = sum(len(band_indices(cfg.Lin, cfg.Lout, l, cfg.trunc)[0])
                 for l in range(cfg.Lh))
    flop = iters * products * 2 * blocks * cfg.Nt * cfg.Nr
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return flop, nbytes, iters


def bound(flop, nbytes):
    """The least time the card could take: (ms, 'operations' or
    'bytes')."""
    t_ops, t_bytes = flop / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(torch, dev):
    from amp_sparc_spatialmodulation_tpu_torch.config import (
        Config, flagship_bamp_ook)
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    def realization(cfg, B, seed, snr, kind="sparc"):
        r = montecarlo.generate_realization(make_generator(dev, seed), cfg,
                                            kind, "banded", B, snr)
        return r, bamp.initial_state(r.y, cfg.N, r.sigma2)

    def both(cfg, r, s0, cap):
        sk = fused_bamp.whole_decode(r.A, s0, r.y, r.sigma2, cap, cfg)
        sp = fused_bamp.decode_plain(r.A, s0, r.y, r.sigma2, cap, cfg)
        torch.cuda.synchronize()
        return sk, sp

    small = dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, mode="segmented",
                 profile="uniform")
    cases = [
        ("ook_tail", dict(alphabet="OOK", trunc="tail", iterations=12), 1.2),
        ("ook_trunc", dict(alphabet="OOK", trunc="trunc", iterations=12),
         1.2),
        ("ook_cyclic", dict(alphabet="OOK", trunc="cyclic", iterations=12),
         1.2),
        ("qpsk_tail", dict(alphabet="QPSK", trunc="tail", iterations=8), 1.5),
        ("8psk_tail", dict(alphabet="8PSK", trunc="tail", iterations=10),
         1.6),
        ("ook_m6", dict(alphabet="OOK", trunc="tail", iterations=10, Nt=24),
         1.3),
        ("random_qpsk", dict(alphabet="QPSK", trunc="tail", iterations=10,
                             mode="random"), 1.4),
    ]
    max_err = 0.0
    for i, (name, kw, snr_exp) in enumerate(cases):
        cfg = Config(**{**small, **kw})
        kind = "toeplitz" if cfg.mode == "random" else "sparc"
        r, s0 = realization(cfg, SMALL_B, 100 + i, 10 ** snr_exp, kind)
        sk, sp = both(cfg, r, s0, cfg.N_Layers)
        max_err = max(max_err, compare("kernel_small", sk, sp, 1e-4,
                                       case=name))

    # split at 3 iterations and resume: the same trajectory
    cfg = Config(**{**small, **cases[0][1]})
    r, s0 = realization(cfg, SMALL_B, 100, 10 ** 1.2)
    full = fused_bamp.whole_decode(r.A, s0, r.y, r.sigma2, 12, cfg)
    part = fused_bamp.whole_decode(r.A, s0, r.y, r.sigma2, 3, cfg)
    resumed = fused_bamp.whole_decode(r.A, part, r.y, r.sigma2, 12, cfg)
    split_ok = (bool(torch.equal(full.T, resumed.T))
                and state_err(full, resumed, slice(None)) < 1e-5)

    # flagship geometry, 8 dB
    fcfg = flagship_bamp_ook()
    snr = snr_of(fcfg, EBN0_DB)
    r, s0 = realization(fcfg, FLAGSHIP_B, 7, snr)
    sk, sp = both(fcfg, r, s0, fcfg.N_Layers)
    max_err = max(max_err, compare("kernel_flagship", sk, sp, 1e-3))
    part = fused_bamp.whole_decode(r.A, s0, r.y, r.sigma2, K1, fcfg)
    resumed = fused_bamp.whole_decode(r.A, part, r.y, r.sigma2,
                                      fcfg.N_Layers, fcfg)
    split_ok = split_ok and bool(torch.equal(resumed.T, sk.T))
    emit("kernel_split_resume", identical=split_ok)
    if not split_ok:
        raise AssertionError("split-and-resume changed T")

    # the main path's phase 1 (B=res, cap=k1) and phase 2 (its still-active
    # trials, gathered, to the cap): compared, then timed
    r, s0 = realization(fcfg, RES, 11, snr)
    out = {}

    def run_kernel():
        out["k"] = fused_bamp.whole_decode(r.A, s0, r.y, r.sigma2, K1, fcfg)

    def run_plain():
        out["p"] = fused_bamp.decode_plain(r.A, s0, r.y, r.sigma2, K1, fcfg)

    ms = cuda_ms(run_kernel, 1, 5)
    plain_ms = cuda_ms(run_plain, 1, 2)
    s1 = out["k"]
    max_err = max(max_err, compare("kernel_phase1", s1, out["p"], 1e-3,
                                   cap=K1))
    idx = torch.nonzero(s1.active).flatten()
    y2, s2 = r.y[idx], montecarlo.state_take_trials(s1, idx)

    def run_kernel2():
        out["k2"] = fused_bamp.whole_decode(r.A, s2, y2, r.sigma2,
                                            fcfg.N_Layers, fcfg)

    def run_plain2():
        out["p2"] = fused_bamp.decode_plain(r.A, s2, y2, r.sigma2,
                                            fcfg.N_Layers, fcfg)

    ms2 = cuda_ms(run_kernel2, 1, 3)
    plain_ms2 = cuda_ms(run_plain2, 0, 1)
    max_err = max(max_err, compare("kernel_phase2", out["k2"], out["p2"],
                                   1e-3, cap=fcfg.N_Layers))
    tensors = [r.y, s0.xmap, s0.xmmse, s0.var, s0.z, s0.u, s0.active, s0.T,
               r.A.h, r.A.h, r.A.abs_h2, r.A.abs_h2, r.A.gains, r.A.gains2,
               s1.xmap, s1.xmmse, s1.var, s1.z, s1.u, s1.active, s1.T]
    # real banded products per iteration: |H|^2 var, H xmmse (2 real, 4
    # complex), |H|^2^T (1/u), H^H r (4)
    flop, nbytes, iters = decode_work(
        fcfg, s0, s1, tensors, 8 if fused_bamp.real_x(fcfg) else 10)
    bound_ms, bound_by = bound(flop, nbytes)
    timing = dict(kernel="fused_bamp_decode", B=RES, cap=K1, ms=ms,
                  plain_ms=plain_ms,
                  ns_per_iter_trial=1e6 * ms / iters,
                  plain_ns_per_iter_trial=1e6 * plain_ms / iters,
                  iterations=iters, flop=flop, bytes=nbytes,
                  bound_ms=bound_ms, bound_by=bound_by,
                  achieved_tflops=flop / (ms * 1e-3) / 1e12,
                  phase2_B=int(idx.numel()), phase2_ms=ms2,
                  phase2_plain_ms=plain_ms2)
    emit("kernel_timing", **timing)
    return max_err, timing


def phase_main(torch, dev):
    from amp_sparc_spatialmodulation_tpu_torch.config import flagship_bamp_ook
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    from amp_sparc_spatialmodulation_tpu_torch.utils import metrics
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    cfg = flagship_bamp_ook()
    sim = montecarlo.Simulator(cfg, algo="bamp", two_phase=K1, device=dev,
                               progress=lambda s: None)
    torch.cuda.synchronize()
    fused_bamp.launches = 0
    bamp.plain_decodes = 0
    t0 = time.perf_counter()
    avg = sim.run_point(EBN0_DB, epochs=EPOCHS, res=RES)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, plain = fused_bamp.launches, bamp.plain_decodes
    trials = sim.trials_per_point(EPOCHS, RES)

    # per-layer breakdown of one more realization, synchronized per layer
    snr = snr_of(cfg, EBN0_DB)
    gen = make_generator(dev, 12345)
    layers = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        layers[name] = time.perf_counter() - t
        return res

    # scatter of one realization's mean T: 8 single-realization points
    per_real = [sim.run_point(EBN0_DB, epochs=RES, res=RES, snr_idx=i)["T"]
                for i in range(1, 9)]
    sd_real = statistics.stdev(per_real)

    r = timed("generate_s", lambda: montecarlo.generate_realization(
        gen, cfg, "sparc", "banded", RES, snr))
    _, st = timed("decode_phase1_s", lambda: bamp.decode(
        r.A, r.y, r.sigma2, cfg, iter_cap=K1, return_state=True))
    idx = torch.nonzero(st.active).flatten()
    _, sub = timed("decode_phase2_s", lambda: bamp.decode(
        r.A, r.y[idx], r.sigma2, cfg,
        state0=montecarlo.state_take_trials(st, idx), return_state=True))
    st = montecarlo.state_merge_trials(st, sub, idx)
    timed("metrics_s", lambda: metrics.fetch_sums(metrics.evaluate_sums(
        st.xmap, st.xmmse, r.msg, st.T, cfg)))

    emit("main", config="flagship_bamp_ook", ebn0_db=EBN0_DB, res=RES,
         epochs=EPOCHS, trials=trials, two_phase_k1=K1, seconds=seconds,
         trials_per_s=trials / seconds, mean_T=avg["T"], fer=avg["fer"],
         ber=avg["ber"], k1_launches=launches, plain_decodes=plain,
         phase2_bucket=int(idx.numel()), layers=layers,
         realization_mean_T=per_real, realization_mean_T_sd=sd_real,
         mean_T_stderr=sd_real / math.sqrt(trials // RES),
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if launches <= 0 or plain != 0:
        raise AssertionError("the main path did not run through the kernel")
    if abs(avg["T"] - REF_T) > T_TOL:
        raise AssertionError(f"mean T {avg['T']} outside {REF_T}+-{T_TOL}")
    if not REF_FER / FER_FACTOR <= avg["fer"] <= REF_FER * FER_FACTOR:
        raise AssertionError(f"FER {avg['fer']} outside {REF_FER} x/ "
                             f"{FER_FACTOR}")
    return launches


def phase_kernels_scamp(torch, dev):
    """K2 against its plain version (the ``kernels`` phase for SCAMP),
    then timed at its main path's phase-1 and phase-2 shapes."""
    from amp_sparc_spatialmodulation_tpu_torch.config import (
        Config, flagship_scamp)
    from amp_sparc_spatialmodulation_tpu_torch.models import montecarlo, scamp
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_scamp
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    def realization(cfg, B, seed, snr):
        r = montecarlo.generate_realization(make_generator(dev, seed), cfg,
                                            "sparc", "banded", B, snr)
        return r, scamp.initial_state(r.y, cfg)

    def kernel(cfg, r, s0, cap, est=False, y=None):
        return fused_scamp.whole_decode(r.A, r.W, s0, r.y if y is None
                                        else y, r.sigma2, cap, cfg, est)

    def plain(cfg, r, s0, cap, est=False, y=None):
        return fused_scamp.decode_plain(r.A, r.W, s0, r.y if y is None
                                        else y, r.sigma2, cap, cfg, est)

    def check(phase, cfg, r, s0, cap, tol, est=False, **info):
        sk, sp = kernel(cfg, r, s0, cap, est), plain(cfg, r, s0, cap, est)
        torch.cuda.synchronize()
        return compare(phase, sk, sp, tol, SCAMP_FIELDS, **info), sk

    small = dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, mode="sparc",
                 profile="uniform")
    cases = [  # tests/test_pallas_scamp.py, and 8PSK
        ("ook_tail", dict(alphabet="OOK", trunc="tail"), 1.5, False),
        ("ook_trunc", dict(alphabet="OOK", trunc="trunc"), 1.5, False),
        ("ook_cyclic", dict(alphabet="OOK", trunc="cyclic"), 1.5, False),
        ("qpsk_tail", dict(alphabet="QPSK", trunc="tail"), 1.8, False),
        ("8psk_tail", dict(alphabet="8PSK", trunc="tail"), 1.9, False),
        ("ook_estimate_phi", dict(alphabet="OOK", trunc="tail"), 1.5, True),
    ]
    max_err = 0.0
    for i, (name, kw, snr_exp, est) in enumerate(cases):
        cfg = Config(**{**small, **kw, "iterations": 12})
        r, s0 = realization(cfg, SMALL_B, 200 + i, 10 ** snr_exp)
        err, _ = check("kernel_small_scamp", cfg, r, s0, cfg.N_Layers, 1e-4,
                       est, case=name)
        max_err = max(max_err, err)

    # split at 3 iterations and resume: the same trajectory
    cfg = Config(**{**small, **cases[0][1], "iterations": 12})
    r, s0 = realization(cfg, SMALL_B, 200, 10 ** 1.2)
    full = kernel(cfg, r, s0, 12)
    resumed = kernel(cfg, r, kernel(cfg, r, s0, 3), 12)
    split_ok = (bool(torch.equal(full.T, resumed.T))
                and state_err(full, resumed, slice(None), SCAMP_FIELDS)
                < 1e-5)

    # the main geometry and flagship_scamp(), 4096 trials
    mcfg = scamp_main_config()
    snr = snr_of(mcfg, EBN0_DB)
    r, s0 = realization(mcfg, FLAGSHIP_B, 17, snr)
    err, sk = check("kernel_main_scamp", mcfg, r, s0, mcfg.N_Layers, 1e-3)
    max_err = max(max_err, err)
    resumed = kernel(mcfg, r, kernel(mcfg, r, s0, SCAMP_K1), mcfg.N_Layers)
    split_ok = split_ok and bool(torch.equal(resumed.T, sk.T))
    emit("kernel_split_resume_scamp", identical=split_ok)
    if not split_ok:
        raise AssertionError("split-and-resume changed T (SCAMP)")
    fcfg = flagship_scamp()
    r, s0 = realization(fcfg, FLAGSHIP_B, 18, snr_of(fcfg, 10.0))
    err, _ = check("kernel_flagship_scamp", fcfg, r, s0, 100, 1e-3,
                   ebn0_db=10.0)
    max_err = max(max_err, err)

    # the main path's phase 1 (B=res, cap=k1) and phase 2 (its still-active
    # trials, gathered, to the cap): compared, then timed
    r, s0 = realization(mcfg, RES, 21, snr)
    out = {}
    ms = cuda_ms(lambda: out.update(k=kernel(mcfg, r, s0, SCAMP_K1)), 1, 5)
    plain_ms = cuda_ms(lambda: out.update(p=plain(mcfg, r, s0, SCAMP_K1)),
                       1, 2)
    s1 = out["k"]
    max_err = max(max_err, compare("kernel_phase1_scamp", s1, out["p"], 1e-3,
                                   SCAMP_FIELDS, cap=SCAMP_K1))
    idx = torch.nonzero(s1.active).flatten()
    y2, s2 = r.y[idx], montecarlo.state_take_trials(s1, idx)
    ms2 = cuda_ms(lambda: out.update(
        k2=kernel(mcfg, r, s2, mcfg.N_Layers, y=y2)), 1, 3)
    plain_ms2 = cuda_ms(lambda: out.update(
        p2=plain(mcfg, r, s2, mcfg.N_Layers, y=y2)), 0, 1)
    max_err = max(max_err, compare("kernel_phase2_scamp", out["k2"],
                                   out["p2"], 1e-3, SCAMP_FIELDS,
                                   cap=mcfg.N_Layers))
    tensors = [r.y, s0.xmap, s0.xmmse, s0.psi, s0.phi, s0.z, s0.active,
               s0.T, r.A.h, r.A.h, r.A.gains, r.W, s1.xmap, s1.xmmse, s1.psi,
               s1.phi, s1.z, s1.active, s1.T]
    # real banded products per iteration: A xmmse (2 real, 4 complex) and
    # A^H (z / phi) (4)
    flop, nbytes, iters = decode_work(
        mcfg, s0, s1, tensors, 6 if fused_scamp.real_x(mcfg) else 8)
    bound_ms, bound_by = bound(flop, nbytes)
    timing = dict(kernel="fused_scamp_decode", B=RES, cap=SCAMP_K1, ms=ms,
                  plain_ms=plain_ms, ns_per_iter_trial=1e6 * ms / iters,
                  plain_ns_per_iter_trial=1e6 * plain_ms / iters,
                  iterations=iters, flop=flop, bytes=nbytes,
                  bound_ms=bound_ms, bound_by=bound_by,
                  achieved_tflops=flop / (ms * 1e-3) / 1e12,
                  phase2_B=int(idx.numel()), phase2_ms=ms2,
                  phase2_plain_ms=plain_ms2)
    emit("kernel_timing_scamp", **timing)
    return max_err, timing


def phase_main_scamp(torch, dev):
    """The SCAMP main path: ``Simulator(algo='scamp', two_phase=8)`` at the
    OOK sparc point, 8 dB, over 64 realizations of 65536 trials."""
    from amp_sparc_spatialmodulation_tpu_torch.models import montecarlo, scamp
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_scamp
    from amp_sparc_spatialmodulation_tpu_torch.utils import metrics
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    cfg = scamp_main_config()
    sim = montecarlo.Simulator(cfg, algo="scamp", two_phase=SCAMP_K1,
                               device=dev, progress=lambda s: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_scamp.launches = 0
    scamp.plain_decodes = 0
    t0 = time.perf_counter()
    avg = sim.run_point(EBN0_DB, epochs=SCAMP_EPOCHS, res=RES)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, plain = fused_scamp.launches, scamp.plain_decodes
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trials = sim.trials_per_point(SCAMP_EPOCHS, RES)

    # scatter of one realization's mean T: 8 single-realization points
    per_real = [sim.run_point(EBN0_DB, epochs=RES, res=RES, snr_idx=i)["T"]
                for i in range(1, 9)]
    sd_real = statistics.stdev(per_real)

    # per-layer breakdown of one more realization, synchronized per layer
    gen = make_generator(dev, 12345)
    layers = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        layers[name] = time.perf_counter() - t
        return res

    r = timed("generate_s", lambda: montecarlo.generate_realization(
        gen, cfg, "sparc", "banded", RES, snr_of(cfg, EBN0_DB)))
    _, st = timed("decode_phase1_s", lambda: montecarlo.decode(
        "scamp", r, r.y, cfg, iter_cap=SCAMP_K1, return_state=True))
    idx = torch.nonzero(st.active).flatten()
    _, sub = timed("decode_phase2_s", lambda: montecarlo.decode(
        "scamp", r, r.y[idx], cfg,
        state0=montecarlo.state_take_trials(st, idx), return_state=True))
    st = montecarlo.state_merge_trials(st, sub, idx)
    timed("metrics_s", lambda: metrics.fetch_sums(metrics.evaluate_sums(
        st.xmap, st.xmmse, r.msg, st.T, cfg)))

    emit("main_scamp", config="scamp_ook_sparc_flagship_dims",
         ebn0_db=EBN0_DB, res=RES, epochs=SCAMP_EPOCHS, trials=trials,
         two_phase_k1=SCAMP_K1, seconds=seconds,
         trials_per_s=trials / seconds, mean_T=avg["T"], fer=avg["fer"],
         ber=avg["ber"], k2_launches=launches, plain_decodes=plain,
         phase2_bucket=int(idx.numel()), layers=layers,
         realization_mean_T=per_real, realization_mean_T_sd=sd_real,
         mean_T_stderr=sd_real / math.sqrt(trials // RES),
         peak_mem_gib=peak)
    if launches <= 0 or plain != 0:
        raise AssertionError("the SCAMP main path did not run through the "
                             "kernel")
    if abs(avg["T"] - SCAMP_REF_T) > SCAMP_T_TOL:
        raise AssertionError(f"SCAMP mean T {avg['T']} outside "
                             f"{SCAMP_REF_T}+-{SCAMP_T_TOL}")
    if not (SCAMP_REF_FER / SCAMP_FER_FACTOR <= avg["fer"]
            <= SCAMP_REF_FER * SCAMP_FER_FACTOR):
        raise AssertionError(f"SCAMP FER {avg['fer']} outside "
                             f"{SCAMP_REF_FER} x/ {SCAMP_FER_FACTOR}")
    return launches


def kernel_entry(name, replaces, launches, max_err, timing):
    return {"name": name, "route": "cuda",
            "source": "amp_sparc_spatialmodulation_tpu_torch/ops/kernels/"
                      f"csrc/{name}.cu",
            "replaces": f"amp_sparc_spatialmodulation_tpu/ops/pallas/"
                        f"{replaces}",
            "launches": launches, "max_abs_err": max_err,
            "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
            "library_ms": None}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import build
    except ImportError as exc:
        print(f"chip_smoke: the port's package is missing: {exc}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    report = build.build()
    emit("build", seconds=time.perf_counter() - t0,
         sources={k: {"seconds": v["seconds"], "cached": v["cached"],
                      "ptxas": [ln for ln in v["ptxas"].splitlines()
                                if "registers" in ln or "spill" in ln]}
                  for k, v in report.items()})

    max_err, timing = phase_kernels(torch, dev)
    launches = phase_main(torch, dev)
    max_err2, timing2 = phase_kernels_scamp(torch, dev)
    launches2 = phase_main_scamp(torch, dev)

    print(json.dumps({"kernels": [
        kernel_entry("fused_bamp_decode", "fused_bamp.py:617", launches,
                     max_err, timing),
        kernel_entry("fused_scamp_decode", "fused_scamp.py:112", launches2,
                     max_err2, timing2)]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # report the failing phase and exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
