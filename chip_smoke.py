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
   and plain version at both phase shapes; K1's and K2's lines add their
   share of the bound, their shared memory per block, the registers
   and spills ptxas reported for them and their products as
   torch.matmul calls at the main shape; K1's its phase-2 time per
   iteration and trial; K2's its phase-2 bound;
4. main    — the flagship BAMP OOK point (``config.flagship_bamp_ook()``,
   SPARC channel in tap form, Eb/N0 = 8 dB, two-phase k1=12) through
   ``Simulator.run_point`` over 128 realizations of 65536 trials, with the
   kernel launch counts of that run, the scatter of a single realization's
   mean T and a per-layer breakdown of one realization;
5. main_scamp — the SCAMP OOK sparc point at the same dimensions (Eb/N0 =
   8 dB, two-phase k1=8) over 64 realizations of 65536 trials, reported
   the same way;
6. kernels_vamp, kernels_vamp2 — K3 (VAMP) and K4 (vamp2) against their
   plain versions (``compare_vamp``): the same T rule, the posterior
   planes (xmmse, var) within 1e-3 on every trial whose T agrees and the
   pseudo-data r within 5e-2 on the small geometries of
   tests/test_pallas_vamp.py (OOK, QPSK, 8PSK, a toeplitz channel; 1024
   trials), the posterior within 1e-3 on >= 99.5% of those trials at full
   width, where r is printed without a bound; at cap 100, where trials
   stop by the allclose test after tens of iterations and mean T measures
   the accuracy of the products, |d mean T| <= 2% of the cap instead of
   the T agreement share.  Split-and-resume, K3's realization-batched form
   against separate launches, the VAMP main geometry (N = 2560, p = 528)
   at 4096 trials at cap 10 and cap 100, the VAMPfinal geometry (N = 3200,
   p = 960) at 1024 trials at cap 100, then the main path's shape (65536
   trials, cap 10) compared and timed by CUDA events, with the bound and
   the same products as two torch.matmul calls per iteration;
7. main_vamp, main_vamp2 — ``Simulator(algo='vamp'|'vamp2')`` at the VAMP
   OOK point (``BASELINE.md:50-58``, Eb/N0 = 8 dB, cap 10, SPARC channel in
   dense form, single phase) over 32 and 8 realizations of 65536 trials,
   with the per-realization FER, a per-layer breakdown of one realization
   (generate, SVD, y_tilde, decode, metrics) and the SVD's two methods;
   gates: VAMP FER in [5.9e-3, 1.67e-2] and mean T >= 9.9; vamp2 FER,
   BER and mean T against the JAX package's CPU run at that point;
   then the HIGH form of K3 and K4 (precision='high', bf16 x 3 on the
   tensor cores): kernels_vamp_high / kernels_vamp2_high hold it against
   its plain HIGH version under the same rules and shapes (small
   geometries at 1024 trials, with a control after one iteration: the
   HIGHEST instance held to the plain HIGH version must fail the limit
   the HIGH instance meets; the main geometry at 4096 trials at cap 10
   and cap 100, VAMPfinal at 1024 trials at cap 100, K3's batched form at
   HIGH against separate launches, the main shape timed beside its HIGH
   bound at 989 TFLOP/s, the HIGHEST kernel in the same run and the 18
   Gauss bf16 products of an iteration as torch.matmul calls, with both
   instances' ptxas lines); main_vamp_high (``Simulator(algo='vamp',
   precision='high')`` at the cap-running VAMP OOK point, cap 100, 2
   realizations of 65536, beside precision='highest' on the same seeds:
   the HIGH kernel alone, FER within 3 sigma and mean T within 1.0 of
   HIGHEST's) and main_vamp2_high (the same at the vamp2 main point, cap
   10);
8. kernels_tiled — K5 (the frame-tiled iteration) against its plain
   version, both through ``bamp.plane_loop``, under ``compare``'s rule: the
   small geometries of tests/test_pallas_tiled.py (and BPSK) at 1024
   trials and a ragged batch of 37, the massive geometry at 512 trials (cap
   10) and split at 20 and resumed, the main path's phase 1 (2048 trials,
   cap 40) and phase 2 (its still-active trials to cap 300, where the state
   bound leaves out trials that ran to the cap without converging; the
   same trials in a phase-1-sized batch are printed against the kernel;
   phase 2's wall seconds per iteration beside its device seconds inside
   the kernel's calls); one iteration at 2048 trials timed by CUDA events
   beside its bound, the plain step and the plain step's four products as
   torch.matmul calls, with its four launches timed apart; the same at the
   phase-2 shape (the gathered trials) beside that shape's bound; the
   product blocks' shared memory and the build's ptxas lines;
9. kernels_periter — K6 (one iteration with the K=1 denoiser) and K7 (the
   linear part only) against their plain versions: K6 through the plane
   loop on the OOK small geometries (tail, trunc, cyclic) at 1024 trials
   and the flagship geometry at 4096 (with the share of trials whose T
   equals K1's), then on its path (``AMP_PALLAS_MODE=periter``); K7 for
   one iteration on QPSK, 8PSK and the flagship geometry (within 1e-4) and
   on its path (the 8PSK decode with K7 as the linear half); both timed at
   the flagship main path's shape, with their share of the bound, shared
   memory per block and the registers and spills ptxas reported; K6 also
   at the periter path's tail shape (65536 trials, 1% active, the rest
   frozen), held against its plain version there;
10. main_massive — ``config.massive_mimo()`` at cap 300, Eb/N0 = 18 dB,
   two-phase k1=40, over 8 realizations of 2048 trials, through K5 in both
   phases with no plain decode; gates: mean T and FER against the JAX
   package's CPU run at that point (tests/torch_massive_reference.py);
11. kernels_bamp_high — the HIGH form of K1 (precision='high', bf16 x 3
   on the tensor cores) against its plain HIGH version under
   ``compare`` with each shape's HIGH rule (T agreement and |d mean T|
   between the readings of two correct HIGH decodes and of wrong products,
   tests/torch_bamp_high_rule.py; the state within 1e-4 (small) or 1e-3
   (full width) on the converged trials whose T agrees), each shape with
   the control after one iteration (the median |d xmap| of the HIGH
   instance under 7e-7, that of the HIGHEST instance over it): the small
   geometries of ``kernels`` at 1024 trials, split-and-resume at the first
   of them (identical T), the QPSK flagship at 5 dB, cap 100 (4096 trials,
   the main path's shape) and at 8 dB, cap 100 (where about half the
   trials converge), the OOK flagship at its phase-1 shape (65536 trials,
   cap 12); at the last two the HIGHEST instance must fail the rule; the
   QPSK 5 dB and OOK shapes timed beside the HIGHEST instance, the HIGH
   bound at 989 TFLOP/s and the same bf16 products as torch.matmul calls,
   with both instances' ptxas lines; then main_bamp_high, ``Simulator(
   flagship_bamp_qpsk(), algo='bamp', precision='high')`` at 5 dB, cap 100,
   beside precision='highest' on the same seeds, 2 realizations of 65536
   each (the HIGH instance alone, FER and BER within 3 sigma and mean T
   within 1.0 of HIGHEST's, both runs' trials/s);
12. kernels_tiled_high — the HIGH form of K5 (precision='high', bf16 x 3
   on the tensor cores) against its plain HIGH version through
   ``bamp.plane_loop``, under ``compare`` with each shape's HIGH rule
   (``K5_HIGH_RULES``, limits from tests/torch_bamp_high_rule.py --route
   tiled) and at every shape the control after one iteration (the median
   |d z_re| of the HIGH instance under 3e-7, that of the HIGHEST instance
   over it): the small geometries of ``kernels_tiled`` at 1024 trials and
   a ragged batch of 37, the massive geometry at 512 trials (cap 10, split
   at 5 and resumed), the main path's 8 dB state at 2048 trials, the
   converging 10 dB shape at 2048 trials, cap 100, and the phase-2 shape;
   one iteration at 2048 trials and at the phase-2 shape timed beside the
   HIGHEST instance, the HIGH bound at 989 TFLOP/s and the 21 bf16
   products as torch.matmul calls; then main_massive_high,
   ``Simulator(massive_mimo(), algo='bamp', precision='high')`` at 8 dB,
   cap 100 (every trial at the cap) beside precision='highest' on the same
   seeds, 2 realizations of 2048 each (K5's HIGH instance alone, FER and
   BER within 3 sigma, mean T within 1.0, both runs' trials/s), and
   ``precision='auto'``, HIGHEST on a first point and K5-high after it;
13. the DEFAULT precision (precision='default', one bf16 pass on the
   tensor cores; each instance against its plain DEFAULT version, drawn at
   DEFAULT, with a T rule per shape whose limits come from
   tests/torch_bamp_high_rule.py --precision default, a state bound per
   shape on the trials that stopped before the cap, and a one-iteration
   control from the state after two plain DEFAULT iterations that the
   HIGH instance must fail): kernels_bamp_default (K1 at the OOK phase-1
   shape and the QPSK flagship at 5 dB, cap 100, each timed beside HIGH
   and HIGHEST with its one-pass bound and the one-pass products as
   PyTorch calls on bf16 tensors, its tap bytes per launch and its ptxas
   lines), main_bamp_default (the flagship OOK
   point at full width, 2 x 65536, two-phase k1=12, beside HIGH and
   HIGHEST: trials/s, mean T, FER, the share of trials at the cap; the
   QPSK point at 5 dB, cap 100, 2 x 4096: FER within 3 sigma of HIGH's,
   T at the cap), kernels_vamp_default / kernels_vamp2_default (the main
   geometry at 4096 trials, cap 10, compare_vamp and the control; the
   main shape timed), main_vamp_default / main_vamp2_default (VAMP cap
   100, vamp2 cap 10, 2 x 65536 beside HIGH: FER, for vamp2 BER, within 3
   sigma), kernels_tiled_default (K5 at 8 dB, cap 10 and 10 dB, cap 100,
   2048 trials, the control, one iteration timed) and
   main_massive_default (8 dB, cap 100, 2 x 2048 beside HIGH: FER within 3
   sigma); every DEFAULT run through its DEFAULT instance alone;
14. the sweep engine (no kernel of its own; counts set to 0 just before
   each run and read just after): main_auto_k1, ``Simulator(
   flagship_bamp_ook(), two_phase='auto')`` at 7 and 8 dB, 8 realizations
   of 65536 each, each point's probe mean T (2048 trials through K1), its
   k1 and the k1 of the previous-point rule, then the 8 dB point at a
   fixed k1 equal to the probe's and under ``AMP_AUTO_PROBE=0``, on the
   same seeds (gate: FER, BER and mean T identical in the three, K1 alone
   in each); main_plain, ``use_pallas=False`` beside ``'auto'`` on the
   same seeds at the BAMP main point (k1 = 12, 16 realizations) and the
   SCAMP main point (k1 = 8, 8 realizations) (gates: no K1 or K2 launch
   and two plain decodes a realization in the False runs, |d mean T| <=
   0.02, FER and BER within 3 sigma; whether the sums are identical
   printed); main_plain_high, the plain BAMP loop at HIGH beside K1-high
   at main_bamp_high's point (2 realizations of 4096; FER and BER within
   3 sigma, mean T within 1.0, the plain side no launch) and SCAMP at the
   8PSK sweep geometry (reference_scamp_8psk_golden.json, cap 200) at 7
   dB, one realization of 4096 a form, HIGH beside HIGHEST, both the plain
   loop (FER within 3 sigma; both
   mean Ts printed), ``precision='auto'`` built there; every run's
   trials/s printed;
15. the sharded paths (``parallel/``; no kernel of their own; each phase
   in a world-1 NCCL group, the card's only world, destroyed at its end):
   main_sharded, ``ShardedSimulator`` on a (1, 1) mesh beside
   ``Simulator`` on the same seeds, in turns, at the BAMP main point (16
   x 65536, K1) and the SCAMP main point (8 x 65536, K2) (gates: FER, BER
   and mean T identical, the same launch counts, no plain decode; both
   trials/s and their ratio printed); main_cli_sharded, ``python -m
   torch.distributed.run --standalone --nproc-per-node 1 -m
   amp_sparc_spatialmodulation_tpu_torch.cli -- sweep --shard`` at the
   BAMP point (gate: its artifact's FER and mean T equal main_sharded's);
   main_model_axis, the halo BAMP, halo SCAMP, dense i.i.d. BAMP and
   SV-domain VAMP decoders at full width on 4096 trials against the plain
   loop under ``compare``'s rule at 1e-3, each time beside the plain
   loop's.  Several ranks run on the CPU under gloo (the tests) and on
   several cards in tests/torch_parallel_cards.py;
16. the analysis tools (no kernel of their own): main_sparc_trial,
   ``sparc_tools.compare_single_trial`` over 256 seeds at the SCAMP main
   geometry, 7 dB (K1 and K2 at a batch of one, 256 launches each, no
   plain decode; on the same draws each kernel against its plain loop
   under compare's rule at B = 1; FER and SER within 3 sigma of the JAX
   package's CPU run; ``cli sparc-trial`` twice as a subprocess);
   main_capacity, ``InfoTheory(flagship_bamp_ook()).simulate`` at 100
   epochs over 3 points (Cawgn exact, device MI against the host routine,
   the Gram in FP32, Cwf and Mi against the JAX package's seed spread);
   main_profiling, one flagship BAMP realization inside ``Profiler`` and
   ``torch_trace`` (K1 in the trace as often as it launched, the
   Profiler's items/s against a synchronized host clock);
17. K1's split forms (``AMP_KERNEL_XMAP_PRECISION``: the variance chain at
   the decode's precision, the xmap chain at the variable's):
   kernels_bamp_xmap, each of the six (variance, xmap) instances against
   its plain version (``fused_bamp.decode_plain_split``) at the QPSK
   flagship (5 dB, cap 100, 4096 trials) and the OOK flagship's phase-1
   shape, under ``compare`` with the shape's rule and a one-iteration
   control that the form at the variance chain's precision must fail, each
   timed beside that form with its bound (FP32 products at 67 TFLOP/s plus
   bf16 passes at 989 TFLOP/s, or the bytes) and its products as PyTorch
   calls (FP32 for a 'highest' chain, bf16 for the others), with each
   instance's tap bytes per launch (``k1_tap_stream``) and its ptxas lines;
   main_bamp_xmap,
   the flagship OOK point (8 dB, two-phase k1 = 12, 16 x 65536) at
   precision='highest' with the variable set to 'high' and to 'default'
   beside HIGHEST and DEFAULT on the same seeds (each split run through its
   split instance alone, FER and BER within 3 sigma of HIGHEST's, mean T
   printed), then the other four pairs on 2 x 65536 each (the path alone);
   kernel_timing_bamp_xmap_mixed, the mixed forms' (high, default) and
   (default, high) time, bound, library call and launches in one line;
18. K1 past 32 column blocks: kernel_wide_bamp (inside kernels_bamp_high,
   kernels_bamp_default and kernels_bamp_xmap), each form against its
   plain version on the small OOK geometry and the OOK flagship's
   dimensions at Lin 40 (``k1_wide_checks``), then as a cluster
   (``k1_cluster_checks``) at the SCAMP QPSK geometry (every form on the
   HIGH layout) and the QPSK flagship's dimensions at Lin 48 (HIGHEST,
   HIGH, DEFAULT), 4096 trials, cap 100: compare with the shape's rule,
   one cluster launch a check, the form with wrong products failing the
   rule, the form's control;
19. K1's cluster form (a trial on a thread-block cluster where one block's
   shared memory holds none): kernel_cluster_bamp, every form (HIGHEST,
   HIGH, DEFAULT, the six split pairs) at the OOK flagship (cap 12) and
   the QPSK flagship (5 dB, cap 100), 4096 trials, forced onto clusters of
   2 and 4 blocks (``whole_decode(..., ctas=c)``), must equal the one-block
   launch on every plane of every trial, T and the active flags, both
   times printed; main_bamp_wide, ``Simulator(config.flagship_scamp(),
   algo='bamp', precision='high')`` at 12 dB, cap 100, beside
   ``precision='highest'`` (a one-block K1 there) on the same seeds, 2
   realizations of 65536 each: route ``'whole'``, cluster launches alone
   in the HIGH run, no plain decode, FER and BER within 3 sigma and mean
   T within 1.0 of HIGHEST's, both runs' trials/s and a per-layer split;
   kernel_timing_bamp_cluster, the cluster form at that shape beside its
   bound, the same bf16 products as torch.matmul calls and the plain HIGH
   version;
20. the ``{"kernels": [...]}`` summary, the ``nvidia-smi`` line, and last
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
from functools import partial

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12   # tensor cores, dense
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
# VAMP and vamp2: the posterior planes are gated; the pseudo-data r divides
# by 1 - alpha (alpha up to 1 - 1e-5), which amplifies summation-order
# noise, so it has its own bound on the small geometries
# (tests/test_pallas_vamp.py:32-37) and none at full width.
VAMP_FIELDS = ("xmmse", "var")
VAMP_R_TOL = 5e-2
# The HIGH kernels' control at the small geometries after one iteration:
# the statistic of vamp_gap and its limit against the plain HIGH version,
# above the FP32 summation-order noise of a HIGH launch and below the gap
# between the HIGHEST and HIGH products.
HIGH_CONTROL_STAT = "r_p50"
HIGH_CONTROL_TOL = 7e-7
# The same control at the main geometry (4096 trials of vamp_main_config()),
# where a pass contracts over 160 k16 steps (tests/torch_vamp_high_control.py
# on an NVIDIA H100, PERF.md): r_p50 1.8e-7 (VAMP) and 3.1e-7 (vamp2) for
# the HIGH instance that adds each k16 step's hi x hi in FP32, 3.4e-7 and
# 6.3e-7 where the tensor cores carried the whole sum, 2.9e-6 for HIGHEST.
HIGH_MAIN_CONTROL_TOL = 4.5e-7

# K1's HIGH form against its plain HIGH version.  Two correct HIGH decodes
# part on T where trials stop by the allclose test: the three-pass
# product's error sits near its 1e-5 tolerance, so the FP32 order of the
# sums decides the stop of some trials.  Each shape's limits (T agreement,
# |d mean T|) lie between the readings of tests/torch_bamp_high_rule.py on
# an NVIDIA H100 (PERF.md, section 6): below, the plain HIGH version held
# to itself with exactly summed products (two correct decodes) and the
# kernel; above, K1's HIGHEST instance and the plain HIGH version without
# its hi x lo pass (wrong products).
# - the OOK flagship at its phase-1 shape (65536 trials, cap 12, 8 dB):
#   T agreement 97.8% exact / 97.7% kernel against HIGHEST's 95.0% and
#   one pass's 78.1%; |d mean T| 0.0008 / 0.0009 against 0.032 and 0.23;
# - the QPSK flagship at 8 dB, cap 100 (4096 trials, 47% converge):
#   T agreement 68.8% / 68.1% against 39.1% and 51.5%; |d mean T| 0.23 /
#   0.50 against 22.1 and 16.1;
# - at the small geometries and the QPSK flagship at 5 dB (every trial at
#   the cap) nothing above parts from below on T: the limits there are
#   PR 3's parity rule (2% of the cap) and compare's, and the control
#   separates.
# The control: the median |d xmap| after one iteration, 6e-8 to 1.2e-7 for
# the kernel and the exact sums at the main shapes, 2.9e-6 to 3.7e-6 for
# HIGHEST, 1.6e-3 to 2.0e-3 for one pass; limit HIGH_CONTROL_TOL.
BAMP_HIGH_SMALL_RULE = dict(min_agree=0.95, dmean_T_of_cap=0.02)
BAMP_HIGH_CONTROL_STAT = "xmap_p50"
# main_bamp_high: the BAMPfinal QPSK point whose mean T pins at the cap
# (Simulations/BAMPfinal/QPSK,.../5.0.json: T 99.996, FER 1.0), 2
# realizations of 65536 per form; BER's sigma from the scatter of 32
# groups of one realization's trials.
BAMP_HIGH_EBN0_DB = 5.0
BAMP_HIGH_CONVERGING_DB = 8.0
BAMP_HIGH_REALIZATIONS = 2
BAMP_HIGH_BER_GROUPS = 32

# VAMP main path: the VAMP OOK family of BASELINE.md:50-58 at its published
# cap of 10, single phase, 32 realizations.  Its gate is the published
# artifact (FER 1.13e-2, T 10.0, 10,000 trials) under the rule of
# tests/test_golden_artifacts.py:140-141 (4 sigma_binomial + 8% + 2e-4),
# a band that also holds the reference's current code at 8.5e-3.
VAMP_REALIZATIONS = 32
VAMP_FER_BAND = (5.9e-3, 1.67e-2)
VAMP_MIN_T = 9.9
# vamp2 at the same point, 8 realizations.  No published sweep: the gate is
# the JAX package's XLA decode on the CPU at this point
# (tests/torch_vamp_reference.py --algo vamp2 --epochs 32768 --res 2048):
# FER 1.0 (vamp2 does not decode here within 10 iterations), BER
# 0.23183565 with a realization standard deviation of 0.0012216 over 16
# realizations, mean T 10.0.  FER and BER under the same rule (BER's sigma
# from both runs' realization scatter), mean T within 0.2.
VAMP2_REALIZATIONS = 8
VAMP2_REF = dict(trials=32768, realizations=16, fer=1.0,
                 ber=0.23183565139770507, ber_sd=0.001221572022346604,
                 T=10.0)
VAMP2_T_TOL = 0.2

# Massive-MIMO main path: config.massive_mimo() (Nt=1344, Na=84, Nr=73,
# Lin=32, Lh=6, tail, OOK) at cap 300, Eb/N0 = 18 dB, two-phase k1=40, 2048
# trials per realization (scripts/bench_massive.py:37-42), 8 realizations.
# Its gate is the JAX package's XLA decode on the CPU at this point
# (tests/torch_massive_reference.py --epochs 8192 --res 256): FER 2.075e-3,
# BER 7.58e-4, mean T 33.060 with a realization standard deviation of 0.647
# over 32 realizations of 256 trials.
MASSIVE_EBN0_DB = 18.0
MASSIVE_CAP = 300
MASSIVE_K1 = 40
MASSIVE_RES = 2048
MASSIVE_REALIZATIONS = 8
MASSIVE_REF = dict(trials=8192, realizations=32, fer=0.0020751953125,
                   ber=0.0007584776197160992, T=33.0599365234375,
                   T_sd=0.6470374580012561)


def scamp_main_config():
    from amp_sparc_spatialmodulation_tpu_torch.config import Config
    return Config(Nt=128, Na=8, Nr=24, Lin=20, Lh=3, mode="sparc",
                  alphabet="OOK", profile="uniform", trunc="tail",
                  iterations=100)


def vamp_main_config(iterations=10):
    """The VAMP OOK family of BASELINE.md:50-58 (N = 2560, p = 528)."""
    from amp_sparc_spatialmodulation_tpu_torch.config import Config
    return Config(Nt=128, Na=8, Nr=24, Lin=20, Lh=3, mode="segmented",
                  alphabet="OOK", profile="uniform", trunc="tail",
                  iterations=iterations)


def vampfinal_config():
    """The VAMPfinal family of BASELINE.md:38-48 (N = 3200, p = 960)."""
    from amp_sparc_spatialmodulation_tpu_torch.config import Config
    return Config(Nt=128, Na=16, Nr=32, Lin=25, Lh=6, mode="segmented",
                  alphabet="QPSK", profile="uniform", trunc="tail",
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
            free_unconverged: bool = False, min_agree: float = 0.995,
            max_dmean_T: float = 0.02, **info) -> float:
    """Hold a kernel result ``sk`` against the plain version's ``sp``: T
    identical on >= ``min_agree`` (99.5%) of trials, |d mean T| <=
    ``max_dmean_T`` (0.02), state planes ``fields`` within ``tol`` where T
    agrees.  With ``free_unconverged`` the state bound leaves out the
    trials that ran to the cap without converging in either result (their
    count and largest error are printed): AMP that does not decode has no
    fixed point, and 260 iterations of it amplify any difference of
    summation order.  Emits one line; returns the state error."""
    agree = sk.T == sp.T
    frac = float(agree.float().mean())
    mean_k, mean_p = float(sk.T.float().mean()), float(sp.T.float().mean())
    if free_unconverged:
        loose = sk.active | sp.active
        info = dict(info, trials_unconverged=int(loose.sum()),
                    max_abs_err_unconverged=state_err(sk, sp, agree & loose,
                                                      fields))
        agree_bounded = agree & ~loose
    else:
        agree_bounded = agree
    err = state_err(sk, sp, agree_bounded, fields)
    same = agree.clone()
    for f in fields:
        a, b = getattr(sk, f), getattr(sp, f)
        same &= (a == b).reshape(a.shape[0], -1).all(dim=1)
    exact = float(same.float().mean())
    emit(phase, **info, B=int(sk.T.numel()), T_agree_fraction=frac,
         mean_T_kernel=mean_k, mean_T_plain=mean_p,
         abs_dmean_T=abs(mean_k - mean_p), max_abs_err_T_agree=err,
         tolerance=tol, bit_exact_fraction=exact)
    if (frac < min_agree or abs(mean_k - mean_p) > max_dmean_T
            or not err < tol):
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


def bound(flop, nbytes, peak=PEAK_FP32_FLOPS):
    """The least time the card could take: (ms, 'operations' or
    'bytes'), the operations at ``peak`` FLOP/s."""
    t_ops, t_bytes = flop / peak, nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def fer_sigma(fer: float, trials: int) -> float:
    """Binomial sigma of a FER over ``trials`` trials (at least one error
    and one success counted), as main_bamp_high takes it."""
    k = round(fer * trials)
    pf = min(max(k, 1), trials - 1) / trials
    return math.sqrt(pf * (1 - pf) / trials)


def ber_sigma(torch, cfg, out, msg, res: int, trials: int) -> float:
    """Sigma of the difference of two runs' BER over ``trials`` trials
    each, from the BER scatter of ``BAMP_HIGH_BER_GROUPS`` groups of one
    decoded realization's ``res`` trials (``out`` of message ``msg``), as
    main_bamp_high takes it."""
    from amp_sparc_spatialmodulation_tpu_torch.utils import metrics
    group = torch.arange(res, device=out.T.device) % BAMP_HIGH_BER_GROUPS
    bers = [metrics.finalize(metrics.evaluate_sums(
        out.xmap, out.xmmse, msg, out.T, cfg,
        weight=(group == g).float()), cfg)["ber"]
        for g in range(BAMP_HIGH_BER_GROUPS)]
    return statistics.stdev(bers) * math.sqrt(
        2 * (res // BAMP_HIGH_BER_GROUPS) / trials)


def banded_library(torch, cfg, A, s, dev) -> dict:
    """Milliseconds of K1's eight real banded products of one iteration of
    every trial of ``s`` as torch.matmul calls, by product: |H|^2 var, H
    xmmse (a real x: one product on the stacked Re and Im taps), |H|^2^T
    (1/u) and H^H r (complex) on the stacked taps."""
    rows, cols = s.var.shape[0] * cfg.Lin, cfg.Lh * cfg.Nr
    xs = s.xmmse.real.reshape(rows, cfg.Nt).contiguous()
    vs = s.var.reshape(rows, cfg.Nt)
    hf = torch.view_as_real(A.h_stack).reshape(cfg.Nt, 2 * cols)
    zc = torch.complex(torch.rand(rows, cols, device=dev),
                       torch.rand(rows, cols, device=dev))
    ha, a2t = A.h_stack.conj().T.contiguous(), A.abs_h2_stack.T.contiguous()
    out = {"forward_abs2": cuda_ms(lambda: vs @ A.abs_h2_stack, 1, 5),
           "forward_complex": cuda_ms(lambda: xs @ hf, 1, 5),
           "adjoint_abs2": cuda_ms(lambda: zc.real @ a2t, 1, 5),
           "adjoint_complex": cuda_ms(lambda: zc @ ha, 1, 5)}
    del xs, zc
    return out


def phase_kernels(torch, dev, k1_ptxas):
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
    products = 8 if fused_bamp.real_x(fcfg) else 10
    flop, nbytes, iters = decode_work(fcfg, s0, s1, tensors, products)
    bound_ms, bound_by = bound(flop, nbytes)
    iters2 = decode_work(fcfg, s2, out["k2"], [], products)[2]
    library = banded_library(torch, fcfg, r.A, s1, dev)
    library_iter_ms = sum(library.values())
    timing = dict(kernel="fused_bamp_decode", B=RES, cap=K1, ms=ms,
                  plain_ms=plain_ms,
                  library_ms=library_iter_ms * iters / RES,
                  library_ms_per_iteration=library_iter_ms,
                  library_ms_by_product=library,
                  ns_per_iter_trial=1e6 * ms / iters,
                  plain_ns_per_iter_trial=1e6 * plain_ms / iters,
                  iterations=iters, flop=flop, bytes=nbytes,
                  bound_ms=bound_ms, bound_by=bound_by,
                  pct_of_bound=100 * bound_ms / ms,
                  achieved_tflops=flop / (ms * 1e-3) / 1e12,
                  smem_bytes=fused_bamp.smem_bytes(fcfg),
                  ptxas=list(k1_ptxas),
                  phase2_B=int(idx.numel()), phase2_ms=ms2,
                  phase2_plain_ms=plain_ms2, phase2_iterations=iters2,
                  phase2_ns_per_iter_trial=1e6 * ms2 / max(iters2, 1))
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


def phase_kernels_scamp(torch, dev, ptxas):
    """K2 against its plain version (the ``kernels`` phase for SCAMP),
    then timed at its main path's phase-1 and phase-2 shapes, beside its
    products as ``torch.matmul`` calls; ``ptxas`` is its build's register
    and spill report."""
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
    def planes(s):
        return [getattr(s, f) for f in s._fields if f != "t"]

    # real banded products per iteration: A xmmse (2 real, 4 complex) and
    # A^H (z / phi) (4)
    products = 6 if fused_scamp.real_x(mcfg) else 8
    taps = [r.A.h, r.A.h, r.A.gains, r.W]
    flop, nbytes, iters = decode_work(
        mcfg, s0, s1, [r.y] + planes(s0) + taps + planes(s1), products)
    bound_ms, bound_by = bound(flop, nbytes)
    flop2, nbytes2, iters2 = decode_work(
        mcfg, s2, out["k2"], [y2] + planes(s2) + taps + planes(out["k2"]),
        products)
    bound_ms2 = bound(flop2, nbytes2)[0]
    # the same products as torch.matmul calls at the main shape, one
    # iteration of every trial (the stacked taps of A xmmse, and A^H Z),
    # scaled to the iterations phase 1 ran
    rows, cols = RES * mcfg.Lin, mcfg.Lh * mcfg.Nr
    hs = r.A.h_stack
    if fused_scamp.real_x(mcfg):
        xs = s1.xmmse.real.reshape(rows, mcfg.Nt).contiguous()
        hf = torch.view_as_real(hs).reshape(mcfg.Nt, 2 * cols)
    else:
        xs, hf = s1.xmmse.reshape(rows, mcfg.Nt), hs
    zs = torch.complex(torch.rand(rows, cols, device=dev),
                       torch.rand(rows, cols, device=dev))
    ha = hs.conj().T.contiguous()
    library = {"forward": cuda_ms(lambda: xs @ hf, 1, 5),
               "adjoint": cuda_ms(lambda: zs @ ha, 1, 5)}
    del xs, zs
    library_iter_ms = sum(library.values())
    timing = dict(kernel="fused_scamp_decode", B=RES, cap=SCAMP_K1, ms=ms,
                  plain_ms=plain_ms, ns_per_iter_trial=1e6 * ms / iters,
                  plain_ns_per_iter_trial=1e6 * plain_ms / iters,
                  iterations=iters, flop=flop, bytes=nbytes,
                  bound_ms=bound_ms, bound_by=bound_by,
                  pct_of_bound=100 * bound_ms / ms,
                  achieved_tflops=flop / (ms * 1e-3) / 1e12,
                  library_ms=library_iter_ms * iters / RES,
                  library_ms_per_iteration=library_iter_ms,
                  library_ms_by_product=library,
                  smem_bytes=fused_scamp.smem_bytes(mcfg), ptxas=list(ptxas),
                  phase2_B=int(idx.numel()), phase2_ms=ms2,
                  phase2_plain_ms=plain_ms2, phase2_iterations=iters2,
                  phase2_bound_ms=bound_ms2,
                  phase2_pct_of_bound=100 * bound_ms2 / ms2)
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


def vamp_gap(sk, sp) -> dict:
    """The largest and the median absolute difference of each float plane
    of the VAMP or vamp2 state ``sk`` from ``sp``, over the trials whose T
    agrees."""
    import torch
    agree = sk.T == sp.T
    out = {}
    for f in sk._fields:
        a, b = getattr(sk, f), getattr(sp, f)
        if f == "t" or not torch.is_floating_point(a) and not a.is_complex():
            continue
        d = (a[agree] - b[agree]).abs().flatten().double()
        out[f"{f}_max"] = float(d.max()) if d.numel() else 0.0
        out[f"{f}_p50"] = float(d.median()) if d.numel() else 0.0
    return out


def vamp_high_control(kern, cfg, case, kernel, precision="high",
                      wrong="highest"):
    """The HIGH form's control after one iteration: (the gaps of the HIGH
    instance, the gaps of the HIGHEST instance) to the plain HIGH version
    (:func:`vamp_gap`) on ``case`` = (realization, y_tilde, s^2, state);
    ``kernel(cfg, case, s0, cap, precision)`` runs wrapper ``kern``.  With
    ``precision`` and ``wrong`` the same for another form (the DEFAULT
    instance, and the HIGH one as the wrong precision)."""
    r, yt, s2, s0 = case
    one = kern.decode_plain(r.dec.Vh, s2, yt, s0, r.sigma2, 1, cfg,
                            precision)
    return (vamp_gap(kernel(cfg, case, s0, 1, precision), one),
            vamp_gap(kernel(cfg, case, s0, 1, wrong), one))


def compare_vamp(phase: str, sk, sp, tol: float, failed: list,
                 rule: str = "trial_share", r_tol=None, **info) -> float:
    """Hold a VAMP or vamp2 kernel result ``sk`` against the plain
    version's ``sp``; a comparison that fails is appended to ``failed``.

    * ``every_trial`` (small geometries): :func:`compare`'s rule on the
      posterior planes (T identical on >= 99.5% of trials, |d mean T| <=
      0.02, xmmse and var within ``tol`` on every trial whose T agrees), r
      within ``r_tol`` (tests/test_pallas_vamp.py:32-37).
    * ``trial_share`` (full width, cap 10): the same, except that the
      posterior must lie within ``tol`` on >= 99.5% of the trials whose T
      agrees.  A trial that does not decode has a posterior as sensitive to
      summation order as r is; the worst trial's error and the count of
      trials over ``tol`` are printed.
    * ``mean_T`` (cap 100, where trials stop by the allclose test after
      tens of iterations): the posterior as for ``trial_share`` and |d mean
      T| <= 2% of the cap.  Here T measures the accuracy of the products:
      cuBLAS sums in another order at each batch size, and no other FP32
      order gives its mean T (tests/torch_vamp_precision.py); the paired
      standard error of d mean T is printed.
    * ``mean_T_only`` (the DEFAULT form): |d mean T| <= 2% of the cap
      alone.  At one bf16 pass a last-bit difference of the FP32 sums
      moves a bf16 rounding by a whole step, r amplifies it, and two
      correct DEFAULT decodes part on T and on the posterior of many
      trials (tests/torch_vamp_high_control.py --precision default); the
      one-iteration control holds the products.

    r's largest error and 99.9th percentile are printed in every case.
    Returns the largest posterior error where T agrees."""
    import torch
    agree = sk.T == sp.T
    frac = float(agree.float().mean())
    dT = (sk.T.double() - sp.T.double())
    n = dT.numel()
    mean_d = float(dT.mean())
    se_d = float(dT.std()) / math.sqrt(n) if n > 1 else 0.0
    row_err = torch.zeros(n, device=sk.T.device)
    for f in VAMP_FIELDS:
        d = (getattr(sk, f) - getattr(sp, f)).abs().reshape(n, -1)
        row_err = torch.maximum(row_err, d.max(dim=1).values)
    row_err = row_err[agree]
    err = float(row_err.max()) if row_err.numel() else 0.0
    over = int((row_err >= tol).sum())
    dr = (sk.r[agree] - sp.r[agree]).abs().flatten()
    r_max = float(dr.max()) if dr.numel() else 0.0
    k = max(1, math.ceil(1e-3 * dr.numel())) if dr.numel() else 0
    r_p999 = float(torch.topk(dr, k).values.min()) if k else 0.0
    same = agree.clone()
    for f in VAMP_FIELDS + ("r",):
        a, b = getattr(sk, f), getattr(sp, f)
        same &= (a == b).reshape(n, -1).all(dim=1)
    dT_max = (0.02 * info["cap"] if rule in ("mean_T", "mean_T_only")
              else 0.02)
    emit(phase, **info, B=n, rule=rule, T_agree_fraction=frac,
         mean_T_kernel=float(sk.T.float().mean()),
         mean_T_plain=float(sp.T.float().mean()), dmean_T=mean_d,
         dmean_T_stderr=se_d, dmean_T_max=dT_max,
         max_abs_err_T_agree=err, tolerance=tol,
         trials_over_tolerance=over, r_max_abs_err=r_max,
         r_p999_abs_err=r_p999, r_tolerance=r_tol,
         bit_exact_fraction=float(same.float().mean()))
    ok = abs(mean_d) <= dT_max
    if rule != "mean_T_only":
        ok = ok and (over == 0 if rule == "every_trial"
                     else over <= 0.005 * row_err.numel())
    if rule not in ("mean_T", "mean_T_only"):
        ok = ok and frac >= 0.995
    if r_tol is not None:
        ok = ok and r_max < r_tol
    if not ok:
        failed.append(f"{phase} {info}")
    return err


def phase_kernels_vamp(torch, dev, algo: str):
    """K3 (``algo='vamp'``) or K4 (``'vamp2'``) against its plain version
    on the card: the small geometries of tests/test_pallas_vamp.py:13-23 at
    1024 trials (OOK, QPSK, 8PSK, a toeplitz channel), split-and-resume,
    K3's realization-batched form against separate launches, the main
    geometry at 4096 trials (cap 10; cap 100), the VAMPfinal geometry at
    1024 trials (cap 100), then the main path's own shape (65536 trials,
    cap 10) compared and timed by CUDA events, beside the same complex
    products as two torch.matmul calls per iteration."""
    from amp_sparc_spatialmodulation_tpu_torch.config import Config
    from amp_sparc_spatialmodulation_tpu_torch.models import (
        montecarlo, vamp, vamp2)
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_vamp, fused_vamp2)
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    mod, kern = (vamp, fused_vamp) if algo == "vamp" else (vamp2, fused_vamp2)
    data = vamp.project if algo == "vamp" else vamp2.whiten
    tag = "" if algo == "vamp" else "2"

    def realization(cfg, B, seed, snr, kind="sparc"):
        r = montecarlo.with_svd(algo, montecarlo.generate_realization(
            make_generator(dev, seed), cfg, kind, "dense", B, snr))
        return (r, data(r.dec, r.y), (r.dec.s ** 2).contiguous(),
                mod.initial_state(r.y, cfg))

    def kernel(cfg, case, s0, cap):
        r, yt, s2, _ = case
        return kern.whole_decode(r.dec.Vh, s2, yt, s0, r.sigma2, cap, cfg)

    def both(cfg, case, cap):
        r, yt, s2, s0 = case
        sk = kernel(cfg, case, s0, cap)
        sp = kern.decode_plain(r.dec.Vh, s2, yt, s0, r.sigma2, cap, cfg)
        torch.cuda.synchronize()
        return sk, sp

    small = dict(Nt=16, Na=4, Nr=10, Lin=8, Lh=3, mode="segmented",
                 profile="uniform", trunc="tail",
                 iterations=10 if algo == "vamp" else 12)
    cases = [("ook", dict(alphabet="OOK"), 1.5, "sparc"),
             ("qpsk", dict(alphabet="QPSK"), 1.9, "sparc"),
             ("8psk", dict(alphabet="8PSK"), 2.0, "sparc"),
             ("ook_toeplitz", dict(alphabet="OOK"), 1.5, "toeplitz")]
    max_err, failed = 0.0, []
    for i, (name, kw, snr_exp, kind) in enumerate(cases):
        cfg = Config(**{**small, **kw})
        case = realization(cfg, SMALL_B, 300 + i, 10 ** snr_exp, kind)
        max_err = max(max_err, compare_vamp(
            f"kernel_small_{algo}", *both(cfg, case, cfg.N_Layers), 1e-3,
            failed, "every_trial", VAMP_R_TOL, case=name))

    # split at 3 iterations and resume: the same trajectory
    cfg = Config(**{**small, **cases[0][1]})
    case = realization(cfg, SMALL_B, 300, 10 ** 1.5)
    full = kernel(cfg, case, case[3], cfg.N_Layers)
    part = kernel(cfg, case, case[3], 3)
    resumed = kernel(cfg, case, part, cfg.N_Layers)
    fields = VAMP_FIELDS + ("r",)
    split_ok = (bool(torch.equal(full.T, resumed.T)) and resumed.t == full.t
                and state_err(full, resumed, slice(None), fields) < 1e-5)

    batched = None
    if algo == "vamp":
        # three realizations in one launch against three separate launches:
        # the same kernel body, so T identical and the state within 1e-5
        rs = [realization(cfg, SMALL_B, 310 + c, 10 ** 1.5) for c in range(3)]
        before = fused_vamp.launches
        out = vamp.decode_batched(torch.stack([c[0].A for c in rs]),
                                  torch.stack([c[0].y for c in rs]),
                                  rs[0][0].sigma2, cfg)
        batched = fused_vamp.launches - before == 1
        for c, case in enumerate(rs):
            ref = vamp.decode(case[0].dec, case[0].y, case[0].sigma2, cfg)
            err = max(float((getattr(out, f)[c] - getattr(ref, f)).abs()
                            .max()) for f in ("xmap", "xmmse", "var"))
            batched = (batched and bool(torch.equal(out.T[c], ref.T))
                       and err < 1e-5)

    # the main geometry at 4096 trials, cap 10 (and split there) and cap
    # 100, where trials run many iterations
    mcfg = vamp_main_config()
    snr = snr_of(mcfg, EBN0_DB)
    case = realization(mcfg, FLAGSHIP_B, 27, snr)
    sk, sp = both(mcfg, case, 10)
    max_err = max(max_err, compare_vamp(f"kernel_main_{algo}", sk, sp, 1e-3,
                                        failed, cap=10))
    resumed = kernel(mcfg, case, kernel(mcfg, case, case[3], 3), 10)
    split_ok = split_ok and bool(torch.equal(resumed.T, sk.T))
    emit(f"kernel_split_resume_{algo}", identical=split_ok,
         batched_identical=batched)
    if not split_ok or batched is False:
        failed.append("split-and-resume or batched")
    # cap 100, where trials stop by the allclose test after tens of
    # iterations (VAMP at T 99.9 here; vamp2 near 92; both decoders at the
    # VAMPfinal geometry): the mean_T rule
    cfg100 = vamp_main_config(iterations=100)
    max_err = max(max_err, compare_vamp(
        f"kernel_main_{algo}", *both(cfg100, case, 100), 1e-3, failed,
        "mean_T", cap=100))
    del case, sk, sp, resumed
    fcfg = vampfinal_config()
    case = realization(fcfg, SMALL_B, 28, snr_of(fcfg, 10.0))
    max_err = max(max_err, compare_vamp(
        f"kernel_vampfinal_{algo}", *both(fcfg, case, 100), 1e-3, failed,
        "mean_T", cap=100, ebn0_db=10.0))
    del case
    torch.cuda.empty_cache()

    # the main path's own shape: 65536 trials, cap 10
    case = realization(mcfg, RES, 29, snr)
    r, yt, s2, s0 = case
    out = {}
    ms = cuda_ms(lambda: out.update(k=kernel(mcfg, case, s0, 10)), 1, 3)
    plain_ms = cuda_ms(lambda: out.update(p=kern.decode_plain(
        r.dec.Vh, s2, yt, s0, r.sigma2, 10, mcfg)), 1, 2)
    s1 = out["k"]
    max_err = max(max_err, compare_vamp(f"kernel_phase1_{algo}", s1,
                                        out.pop("p"), 1e-3, failed, cap=10))
    iters = int((s1.T.long() - s0.T.long()).sum())
    p, N = r.dec.Vh.shape
    # the same products with the library: two complex matmuls per iteration
    Vh_t, Vh_c = r.dec.Vh.T, r.dec.Vh.conj()
    rt = s0.r_tilde if algo == "vamp" else s0.r
    matmul_iter_ms = cuda_ms(lambda: (rt @ Vh_t) @ Vh_c, 1, 3)
    matmul_ms = matmul_iter_ms * int(s1.T.max())
    state = [getattr(s0, f) for f in s0._fields if f != "t"]
    state += [getattr(s1, f) for f in s1._fields if f != "t"]
    nbytes = sum(t.numel() * t.element_size()
                 for t in state + [yt, s2, r.dec.Vh])
    # real FP32 products per complex product in the kernel's 4-product form
    flop = iters * 8 * 2 * N * p
    bound_ms, bound_by = bound(flop, nbytes)
    timing = dict(kernel=f"fused_vamp{tag}_decode", B=RES, cap=10, ms=ms,
                  plain_ms=plain_ms, ns_per_iter_trial=1e6 * ms / iters,
                  plain_ns_per_iter_trial=1e6 * plain_ms / iters,
                  iterations=iters, flop=flop, bytes=nbytes,
                  bound_ms=bound_ms, bound_by=bound_by,
                  achieved_tflops=flop / (ms * 1e-3) / 1e12,
                  matmul_products_ms=matmul_ms,
                  matmul_products_ms_per_iteration=matmul_iter_ms,
                  library_ms=matmul_ms)
    emit(f"kernel_timing_{algo}", **timing)
    if failed:
        raise AssertionError(f"kernel != plain ({algo}): {failed}")
    return max_err, timing


def phase_main_vamp(torch, dev, algo: str):
    """The VAMP or vamp2 main path: ``Simulator(algo=...)`` at the VAMP OOK
    point (Eb/N0 = 8 dB, cap 10, single phase), one ``run_point`` of 65536
    trials per realization so that the realization scatter is printed, then
    a per-layer breakdown of one more realization and the SVD's two
    methods timed once each."""
    from amp_sparc_spatialmodulation_tpu_torch.models import (
        montecarlo, vamp, vamp2)
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_vamp, fused_vamp2)
    from amp_sparc_spatialmodulation_tpu_torch.utils import metrics
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    mod, kern = (vamp, fused_vamp) if algo == "vamp" else (vamp2, fused_vamp2)
    n_real = VAMP_REALIZATIONS if algo == "vamp" else VAMP2_REALIZATIONS
    cfg = vamp_main_config()
    sim = montecarlo.Simulator(cfg, algo=algo, device=dev,
                               progress=lambda s: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kern.launches = 0
    mod.plain_decodes = 0
    t0 = time.perf_counter()
    per = [sim.run_point(EBN0_DB, epochs=RES, res=RES, snr_idx=i)
           for i in range(n_real)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, plain = kern.launches, mod.plain_decodes
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trials = n_real * RES
    avg = {k: statistics.fmean(p[k] for p in per) for k in ("fer", "ber",
                                                             "T")}
    fers = [p["fer"] for p in per]
    bers = [p["ber"] for p in per]

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
        gen, cfg, "sparc", "dense", RES, snr_of(cfg, EBN0_DB)))
    r = timed("svd_s", lambda: montecarlo.with_svd(algo, r))
    data = vamp.project if algo == "vamp" else vamp2.whiten
    yt = timed("ytilde_s", lambda: data(r.dec, r.y))
    st = timed("decode_s", lambda: kern.whole_decode(
        r.dec.Vh, r.dec.s ** 2, yt, mod.initial_state(r.y, cfg), r.sigma2,
        cfg.N_Layers, cfg))
    timed("metrics_s", lambda: metrics.fetch_sums(metrics.evaluate_sums(
        st.xmap, st.xmmse, r.msg, st.T, cfg)))
    svd_s = {}
    for method in ("direct", "gram"):
        vamp.svd(r.A, method=method)                    # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        vamp.svd(r.A, method=method)
        torch.cuda.synchronize()
        svd_s[method] = time.perf_counter() - t

    emit(f"main_{algo}", config="vamp_ook_segmented_flagship_dims",
         ebn0_db=EBN0_DB, res=RES, realizations=n_real, trials=trials,
         cap=cfg.N_Layers, seconds=seconds, trials_per_s=trials / seconds,
         mean_T=avg["T"], fer=avg["fer"], ber=avg["ber"],
         kernel_launches=launches, plain_decodes=plain,
         realization_fer=fers, realization_fer_sd=statistics.stdev(fers),
         realization_ber_sd=statistics.stdev(bers),
         realization_mean_T=[p["T"] for p in per], layers=layers,
         svd_s=svd_s, svd_shape=list(r.A.shape), peak_mem_gib=peak)
    if launches <= 0 or plain != 0:
        raise AssertionError(f"the {algo} main path did not run through "
                             f"the kernel")
    if algo == "vamp":
        if not VAMP_FER_BAND[0] <= avg["fer"] <= VAMP_FER_BAND[1]:
            raise AssertionError(f"VAMP FER {avg['fer']} outside "
                                 f"{VAMP_FER_BAND}")
        if avg["T"] < VAMP_MIN_T:
            raise AssertionError(f"VAMP mean T {avg['T']} < {VAMP_MIN_T}")
        return launches
    ref = VAMP2_REF
    pf = min(max(ref["fer"], 1e-9), 1 - 1e-9)
    fer_bound = (4 * math.sqrt(pf * (1 - pf) * (1 / ref["trials"]
                                                + 1 / trials))
                 + 0.08 * ref["fer"] + 2e-4)
    ber_bound = (4 * math.sqrt(ref["ber_sd"] ** 2 / ref["realizations"]
                               + statistics.stdev(bers) ** 2 / n_real)
                 + 0.08 * ref["ber"] + 2e-4)
    emit("main_vamp2_gate", ref=ref, fer_bound=fer_bound,
         ber_bound=ber_bound, T_tolerance=VAMP2_T_TOL)
    if abs(avg["fer"] - ref["fer"]) > fer_bound:
        raise AssertionError(f"vamp2 FER {avg['fer']} vs {ref['fer']}")
    if abs(avg["ber"] - ref["ber"]) > ber_bound:
        raise AssertionError(f"vamp2 BER {avg['ber']} vs {ref['ber']}")
    if abs(avg["T"] - ref["T"]) > VAMP2_T_TOL:
        raise AssertionError(f"vamp2 mean T {avg['T']} vs {ref['T']}")
    return launches


def phase_kernels_vamp_high(torch, dev, algo: str, ptxas_lines):
    """The HIGH form of K3 (``algo='vamp'``) or K4 (``'vamp2'``):
    precision='high', bf16 x 3 on the tensor cores, against its plain HIGH
    version (``decode_plain(precision='high')``) on the card under
    ``compare_vamp``'s rules: the small geometries at 1024 trials
    (every_trial; plus the control, after one iteration: the median r
    error of the HIGH instance under ``HIGH_CONTROL_TOL``, that of the
    HIGHEST instance over it), the main geometry at 4096 trials at cap 10 (trial_share)
    and cap 100 (mean_T), VAMPfinal at 1024 trials at cap 100 (mean_T),
    K3's batched form at HIGH against separate HIGH launches, then the main
    path's shape (65536 trials, cap 10) compared and timed by CUDA events
    beside its HIGH bound, the HIGHEST kernel in the same run and the same
    18 Gauss bf16 products per iteration as torch.matmul calls."""
    from amp_sparc_spatialmodulation_tpu_torch.config import Config
    from amp_sparc_spatialmodulation_tpu_torch.models import (
        montecarlo, vamp, vamp2)
    from amp_sparc_spatialmodulation_tpu_torch.ops import precision as prec
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_vamp, fused_vamp2)
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    mod, kern = (vamp, fused_vamp) if algo == "vamp" else (vamp2, fused_vamp2)
    data = vamp.project if algo == "vamp" else vamp2.whiten
    tag = "" if algo == "vamp" else "2"
    high = "high"

    def realization(cfg, B, seed, snr, kind="sparc"):
        r = montecarlo.with_svd(algo, montecarlo.generate_realization(
            make_generator(dev, seed), cfg, kind, "dense", B, snr, high))
        return (r, data(r.dec, r.y, high), (r.dec.s ** 2).contiguous(),
                mod.initial_state(r.y, cfg))

    def kernel(cfg, case, s0, cap, precision=high):
        r, yt, s2, _ = case
        return kern.whole_decode(r.dec.Vh, s2, yt, s0, r.sigma2, cap, cfg,
                                 precision)

    def both(cfg, case, cap):
        r, yt, s2, s0 = case
        sk = kernel(cfg, case, s0, cap)
        sp = kern.decode_plain(r.dec.Vh, s2, yt, s0, r.sigma2, cap, cfg,
                               high)
        torch.cuda.synchronize()
        return sk, sp

    small = dict(Nt=16, Na=4, Nr=10, Lin=8, Lh=3, mode="segmented",
                 profile="uniform", trunc="tail",
                 iterations=10 if algo == "vamp" else 12)
    cases = [("ook", dict(alphabet="OOK"), 1.5, "sparc"),
             ("qpsk", dict(alphabet="QPSK"), 1.9, "sparc"),
             ("8psk", dict(alphabet="8PSK"), 2.0, "sparc"),
             ("ook_toeplitz", dict(alphabet="OOK"), 1.5, "toeplitz")]
    max_err, failed = 0.0, []
    for i, (name, kw, snr_exp, kind) in enumerate(cases):
        cfg = Config(**{**small, **kw})
        case = realization(cfg, SMALL_B, 300 + i, 10 ** snr_exp, kind)
        sk, sp = both(cfg, case, cfg.N_Layers)
        err = compare_vamp(f"kernel_small_{algo}_high", sk, sp, 1e-3,
                           failed, "every_trial", VAMP_R_TOL, case=name)
        max_err = max(max_err, err)
        # The control: after one iteration (later ones bring the HIGH and
        # the HIGHEST trajectories to the same spread from the plain
        # version), the HIGH instance and, as the control, the HIGHEST
        # instance held to the plain HIGH version.  The limit lies between
        # the two readings, so a HIGH launch that computed in FP32 fails.
        sound, control = vamp_high_control(kern, cfg, case, kernel)
        emit(f"kernel_small_{algo}_high_control", case=name, cap=1,
             statistic=HIGH_CONTROL_STAT, limit=HIGH_CONTROL_TOL,
             high=sound, highest=control)
        if not (sound[HIGH_CONTROL_STAT] < HIGH_CONTROL_TOL
                <= control[HIGH_CONTROL_STAT]):
            failed.append(f"control {name}")

    batched = None
    if algo == "vamp":
        cfg = Config(**{**small, **cases[0][1]})
        rs = [realization(cfg, SMALL_B, 310 + c, 10 ** 1.5) for c in range(3)]
        before = fused_vamp.launches_high
        out = vamp.decode_batched(torch.stack([c[0].A for c in rs]),
                                  torch.stack([c[0].y for c in rs]),
                                  rs[0][0].sigma2, cfg, high)
        batched = fused_vamp.launches_high - before == 1
        for c, case in enumerate(rs):
            ref = vamp.decode(case[0].dec, case[0].y, case[0].sigma2, cfg,
                              precision=high)
            err = max(float((getattr(out, f)[c] - getattr(ref, f)).abs()
                            .max()) for f in ("xmap", "xmmse", "var"))
            batched = (batched and bool(torch.equal(out.T[c], ref.T))
                       and err < 1e-5)
        emit("kernel_batched_vamp_high", identical=batched)
        if not batched:
            failed.append("batched")

    mcfg = vamp_main_config()
    snr = snr_of(mcfg, EBN0_DB)
    case = realization(mcfg, FLAGSHIP_B, 27, snr)
    max_err = max(max_err, compare_vamp(
        f"kernel_main_{algo}_high", *both(mcfg, case, 10), 1e-3, failed,
        cap=10))
    # the control at the main geometry, where a pass contracts over 160
    # k16 steps (N = 2560) against the small geometries' 8
    sound, control = vamp_high_control(kern, mcfg, case, kernel)
    emit(f"kernel_main_{algo}_high_control", B=FLAGSHIP_B, cap=1,
         statistic=HIGH_CONTROL_STAT, limit=HIGH_MAIN_CONTROL_TOL,
         high=sound, highest=control)
    if not (sound[HIGH_CONTROL_STAT] < HIGH_MAIN_CONTROL_TOL
            <= control[HIGH_CONTROL_STAT]):
        failed.append("control main")
    cfg100 = vamp_main_config(iterations=100)
    max_err = max(max_err, compare_vamp(
        f"kernel_main_{algo}_high", *both(cfg100, case, 100), 1e-3, failed,
        "mean_T", cap=100))
    del case
    fcfg = vampfinal_config()
    case = realization(fcfg, SMALL_B, 28, snr_of(fcfg, 10.0))
    max_err = max(max_err, compare_vamp(
        f"kernel_vampfinal_{algo}_high", *both(fcfg, case, 100), 1e-3,
        failed, "mean_T", cap=100, ebn0_db=10.0))
    del case
    torch.cuda.empty_cache()

    # the main path's own shape: 65536 trials, cap 10
    case = realization(mcfg, RES, 29, snr)
    r, yt, s2, s0 = case
    out = {}
    ms = cuda_ms(lambda: out.update(k=kernel(mcfg, case, s0, 10)), 1, 3)
    highest_ms = cuda_ms(lambda: kernel(mcfg, case, s0, 10, "highest"), 1, 3)
    plain_ms = cuda_ms(lambda: out.update(p=kern.decode_plain(
        r.dec.Vh, s2, yt, s0, r.sigma2, 10, mcfg, high)), 1, 2)
    s1 = out["k"]
    max_err = max(max_err, compare_vamp(f"kernel_phase1_{algo}_high", s1,
                                        out.pop("p"), 1e-3, failed, cap=10))
    iters = int((s1.T.long() - s0.T.long()).sum())
    p, N = r.dec.Vh.shape
    # the library's yardstick: the 18 Gauss bf16 products of one iteration
    # (3 real products x 3 passes, two complex products) as torch.matmul
    taps = [prec.split_bf16(t) for t in vamp.gauss_taps(r.dec.Vh)]
    rt = s0.r_tilde if algo == "vamp" else s0.r
    xa = [prec.split_bf16(t.contiguous())
          for t in (rt.real + rt.imag, rt.real, rt.imag)]
    xw = [prec.split_bf16(torch.zeros((RES, p), device=dev))] * 3

    def gauss_bf16():
        for xs, ts in ((xa, taps[:3]), (xw, taps[3:])):
            for (xh, xl), (th, tl) in zip(xs, ts):
                torch.matmul(xh, th)
                torch.matmul(xh, tl)
                torch.matmul(xl, th)

    matmul_iter_ms = cuda_ms(gauss_bf16, 1, 3)
    matmul_ms = matmul_iter_ms * int(s1.T.max())
    del xa, xw, taps
    state = [getattr(s0, f) for f in s0._fields if f != "t"]
    state += [getattr(s1, f) for f in s1._fields if f != "t"]
    tap_buf = fused_vamp.high_taps(r.dec.Vh)[0]
    nbytes = sum(t.numel() * t.element_size()
                 for t in state + [yt, s2, tap_buf])
    # bf16 x 3: 3 real products x 3 passes x 2 N p flop, two products
    flop = iters * 36 * N * p
    bound_ms, bound_by = bound(flop, nbytes, PEAK_BF16_FLOPS)
    timing = dict(kernel=f"fused_vamp{tag}_decode_high", B=RES, cap=10,
                  ms=ms, highest_ms=highest_ms, plain_ms=plain_ms,
                  ns_per_iter_trial=1e6 * ms / iters,
                  iterations=iters, flop=flop, bytes=nbytes,
                  bound_ms=bound_ms, bound_by=bound_by,
                  pct_of_bound=100 * bound_ms / ms,
                  high_over_highest=ms / highest_ms,
                  achieved_tflops=flop / (ms * 1e-3) / 1e12,
                  matmul_products_ms=matmul_ms,
                  matmul_products_ms_per_iteration=matmul_iter_ms,
                  library_ms=matmul_ms, ptxas=ptxas_lines)
    emit(f"kernel_timing_{algo}_high", **timing)
    if failed:
        raise AssertionError(f"HIGH kernel != plain ({algo}): {failed}")
    return max_err, timing


def phase_main_vamp_high(torch, dev, algo: str):
    """``Simulator(algo=..., precision='high')`` beside
    ``precision='highest'`` on the same seeds: VAMP at the cap-running VAMP
    OOK point (``vamp_main_config(iterations=100)``, Eb/N0 = 8 dB, dense
    SPARC channel, single phase), vamp2 at its main point (cap 10); 2
    realizations of 65536 each.  Gates: the HIGH run through the HIGH
    kernel only (no plain decode), FER(high) within 3 sigma of FER(highest)
    (sigma binomial from the highest run's count, at least one error),
    mean T within 1.0.  Prints both runs' trials/s and mean T and a
    per-layer breakdown of one HIGH realization."""
    from amp_sparc_spatialmodulation_tpu_torch.models import (
        montecarlo, vamp, vamp2)
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_vamp, fused_vamp2)
    from amp_sparc_spatialmodulation_tpu_torch.utils import metrics
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    mod, kern = (vamp, fused_vamp) if algo == "vamp" else (vamp2, fused_vamp2)
    cfg = vamp_main_config(iterations=100 if algo == "vamp" else 10)
    n_real, epochs = 2, 2 * RES
    runs = {}
    for precision in ("highest", "high"):
        sim = montecarlo.Simulator(cfg, algo=algo, device=dev,
                                   precision=precision,
                                   progress=lambda s: None)
        torch.cuda.synchronize()
        kern.launches = kern.launches_high = 0
        mod.plain_decodes = 0
        t0 = time.perf_counter()
        avg = sim.run_point(EBN0_DB, epochs=epochs, res=RES)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs[precision] = dict(
            avg=avg, seconds=seconds, trials_per_s=epochs / seconds,
            launches=kern.launches, launches_high=kern.launches_high,
            plain=mod.plain_decodes)
    hi, hs = runs["high"], runs["highest"]

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
        gen, cfg, "sparc", "dense", RES, snr_of(cfg, EBN0_DB), "high"))
    r = timed("svd_s", lambda: montecarlo.with_svd(algo, r))
    data = vamp.project if algo == "vamp" else vamp2.whiten
    yt = timed("ytilde_s", lambda: data(r.dec, r.y, "high"))
    st = timed("decode_s", lambda: kern.whole_decode(
        r.dec.Vh, r.dec.s ** 2, yt, mod.initial_state(r.y, cfg), r.sigma2,
        cfg.N_Layers, cfg, "high"))
    timed("metrics_s", lambda: metrics.fetch_sums(metrics.evaluate_sums(
        st.xmap, st.xmmse, r.msg, st.T, cfg)))
    del r, yt, st

    sigma = fer_sigma(hs["avg"]["fer"], epochs)
    emit(f"main_{algo}_high", config="vamp_ook_segmented_flagship_dims",
         ebn0_db=EBN0_DB, res=RES, realizations=n_real, trials=epochs,
         cap=cfg.N_Layers,
         **{f"{p}_{k}": v for p, run in runs.items()
            for k, v in (("seconds", run["seconds"]),
                         ("trials_per_s", run["trials_per_s"]),
                         ("mean_T", run["avg"]["T"]),
                         ("fer", run["avg"]["fer"]),
                         ("ber", run["avg"]["ber"]),
                         ("launches", run["launches"]),
                         ("launches_high", run["launches_high"]),
                         ("plain_decodes", run["plain"]))},
         high_over_highest_trials_per_s=(hi["trials_per_s"]
                                         / hs["trials_per_s"]),
         fer_sigma=sigma, layers_high=layers,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if hi["launches_high"] <= 0 or hi["launches"] or hi["plain"]:
        raise AssertionError(f"the {algo} HIGH path did not run through the "
                             "HIGH kernel alone")
    if abs(hi["avg"]["fer"] - hs["avg"]["fer"]) > 3 * sigma:
        raise AssertionError(f"{algo} HIGH FER {hi['avg']['fer']} vs "
                             f"HIGHEST {hs['avg']['fer']}")
    if abs(hi["avg"]["T"] - hs["avg"]["T"]) > 1.0:
        raise AssertionError(f"{algo} HIGH mean T {hi['avg']['T']} vs "
                             f"HIGHEST {hs['avg']['T']}")
    return hi["launches_high"]


def rule_passes(sk, sp, min_agree: float, max_dmean_T: float):
    """(T agreement, |d mean T|, whether both are inside the limits) of
    ``sk`` against ``sp``."""
    frac = float((sk.T == sp.T).float().mean())
    dmean = abs(float(sk.T.float().mean() - sp.T.float().mean()))
    return frac, dmean, frac >= min_agree and dmean <= max_dmean_T


def phase_kernels_bamp_high(torch, dev, ptxas_lines):
    """The HIGH form of K1 (precision='high', bf16 x 3 on the tensor cores)
    against its plain HIGH version (``fused_bamp.decode_plain_high``) on
    the card, under :func:`compare` with each shape's HIGH rule (T
    agreement, |d mean T|, the state within the tolerance on the trials
    whose T agrees and that converged; the limits and their readings are
    at ``BAMP_HIGH_SMALL_RULE``), each shape with the control after one
    iteration (the median xmap error of the HIGH instance against the
    plain HIGH version under ``HIGH_CONTROL_TOL``, that of the HIGHEST
    instance over it).  The small geometries of ``phase_kernels`` at 1024
    trials; split-and-resume at the first of them (identical T); the OOK
    flagship at its phase-1 shape (65536 trials, cap 12, 8 dB), the QPSK
    flagship at 5 dB, cap 100 (4096 trials, the main path's shape, where
    every trial runs to the cap) and at 8 dB, cap 100 (where about half of
    them converge).  Where the rule separates (the OOK phase-1 shape and
    QPSK at 8 dB), the HIGHEST instance held to the same rule must fail it.
    The OOK phase-1 and QPSK 5 dB shapes are timed by CUDA events beside
    the HIGHEST instance, the plain HIGH version, the HIGH bound (3 bf16
    passes of the 7 Gauss products per trial-iteration of a real x, 8 of a
    complex one, at 989 TFLOP/s) and the same bf16 products as
    torch.matmul calls.  Returns the largest state error and the timings,
    the main path's shape (QPSK, 5 dB) first."""
    from amp_sparc_spatialmodulation_tpu_torch.config import (
        Config, flagship_bamp_ook, flagship_bamp_qpsk)
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops import precision as prec
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    high = "high"
    failed = []

    def realization(cfg, B, seed, snr, kind="sparc"):
        r = montecarlo.generate_realization(make_generator(dev, seed), cfg,
                                            kind, "banded", B, snr, high)
        return r, bamp.initial_state(r.y, cfg.N, r.sigma2)

    def control(phase, cfg, data, **info):
        """One iteration of the HIGH instance and, as the control, of the
        HIGHEST instance, held to the plain HIGH version; the limit lies
        between the two, so a HIGH launch that computed in FP32 fails."""
        r, s0 = data
        one = fused_bamp.decode_plain_high(r.A, s0, r.y, r.sigma2, 1, cfg)
        sound = vamp_gap(fused_bamp.whole_decode(r.A, s0, r.y, r.sigma2, 1,
                                                 cfg, high), one)
        wrong = vamp_gap(fused_bamp.whole_decode(r.A, s0, r.y, r.sigma2, 1,
                                                 cfg), one)
        emit(phase, **info, cap=1, statistic=BAMP_HIGH_CONTROL_STAT,
             limit=HIGH_CONTROL_TOL, high=sound, highest=wrong)
        if not (sound[BAMP_HIGH_CONTROL_STAT] < HIGH_CONTROL_TOL
                <= wrong[BAMP_HIGH_CONTROL_STAT]):
            failed.append(f"control {info}")

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
        (r, s0) = case = realization(cfg, SMALL_B, 100 + i, 10 ** snr_exp,
                                     kind)
        cap = cfg.N_Layers
        sk = fused_bamp.whole_decode(r.A, s0, r.y, r.sigma2, cap, cfg, high)
        sp = fused_bamp.decode_plain_high(r.A, s0, r.y, r.sigma2, cap, cfg)
        max_err = max(max_err, compare(
            "kernel_small_bamp_high", sk, sp, 1e-4, free_unconverged=True,
            min_agree=BAMP_HIGH_SMALL_RULE["min_agree"],
            max_dmean_T=BAMP_HIGH_SMALL_RULE["dmean_T_of_cap"] * cap,
            cap=cap, case=name))
        control("kernel_small_bamp_high_control", cfg, case, case=name)

    # split at 5 iterations and resumed (the trials frozen by then pass
    # through): the trajectory of the unsplit decode
    cfg = Config(**{**small, **cases[0][1]})
    r, s0 = realization(cfg, SMALL_B, 100, 10 ** cases[0][2])
    full = fused_bamp.whole_decode(r.A, s0, r.y, r.sigma2, 12, cfg, high)
    part = fused_bamp.whole_decode(r.A, s0, r.y, r.sigma2, 5, cfg, high)
    resumed = fused_bamp.whole_decode(r.A, part, r.y, r.sigma2, 12, cfg,
                                      high)
    split_err = state_err(full, resumed, slice(None))
    split_ok = bool(torch.equal(full.T, resumed.T)) and split_err < 1e-5
    emit("kernel_split_resume_bamp_high", identical=split_ok,
         max_abs_err=split_err, frozen_at_split=int((~part.active).sum()))
    if not split_ok:
        failed.append("split-and-resume")

    # the main shapes: (name, config, trials, cap, Eb/N0, seed, T
    # agreement, |d mean T|, timed, the rule separates HIGHEST)
    timings = []
    for (name, cfg, B, cap, ebn0, seed, min_agree, max_dmean, timed,
         separates) in (
            ("qpsk_cap100", flagship_bamp_qpsk(), FLAGSHIP_B, 100,
             BAMP_HIGH_EBN0_DB, 42, 0.995, 0.02, True, False),
            ("qpsk_cap100_converging", flagship_bamp_qpsk(), FLAGSHIP_B,
             100, BAMP_HIGH_CONVERGING_DB, 42, 0.60, 2.0, False, True),
            ("ook_phase1", flagship_bamp_ook(), RES, K1, EBN0_DB, 41, 0.965,
             0.02, True, True)):
        (r, s0) = case = realization(cfg, B, seed, snr_of(cfg, ebn0))
        op = r.A
        s1 = fused_bamp.whole_decode(op, s0, r.y, r.sigma2, cap, cfg, high)
        sp = fused_bamp.decode_plain_high(op, s0, r.y, r.sigma2, cap, cfg)
        converged = int((~(s1.active | sp.active)).sum())
        max_err = max(max_err, compare(
            "kernel_main_bamp_high", s1, sp, 1e-3, free_unconverged=True,
            min_agree=min_agree, max_dmean_T=max_dmean, case=name, cap=cap,
            ebn0_db=ebn0, converged_both=converged))
        if separates and converged < B // 4:
            failed.append(f"{name}: {converged} of {B} trials converged")
        sh = fused_bamp.whole_decode(op, s0, r.y, r.sigma2, cap, cfg)
        frac, dmean, inside = rule_passes(sh, sp, min_agree, max_dmean)
        emit("kernel_main_bamp_high_highest", case=name, T_agree_fraction=frac,
             abs_dmean_T=dmean, inside_rule=inside, must_fail=separates)
        if separates and inside:
            failed.append(f"{name}: the HIGHEST instance passes the rule")
        del sh, sp
        control("kernel_main_bamp_high_control", cfg, case, case=name)
        if not timed:
            del case, r, op, s0, s1
            torch.cuda.empty_cache()
            continue
        ms = cuda_ms(lambda: fused_bamp.whole_decode(
            op, s0, r.y, r.sigma2, cap, cfg, high), 1, 3)
        highest_ms = cuda_ms(lambda: fused_bamp.whole_decode(
            op, s0, r.y, r.sigma2, cap, cfg), 1, 3)
        plain_ms = cuda_ms(lambda: fused_bamp.decode_plain_high(
            op, s0, r.y, r.sigma2, cap, cfg), 0, 1)
        # 3 bf16 passes of the Gauss products (7 for a real x, 8 complex)
        products = 3 * (7 if fused_bamp.real_x(cfg) else 8)
        taps = fused_bamp.high_taps(op)[0]
        state = [getattr(s0, f) for f in s0._fields if f != "t"]
        state += [getattr(s1, f) for f in s1._fields if f != "t"]
        flop, nbytes, iters = decode_work(cfg, s0, s1,
                                          state + [r.y, taps], products)
        bound_ms, bound_by = bound(flop, nbytes, PEAK_BF16_FLOPS)
        # the library's yardstick: the same bf16 products of one iteration
        # of every trial as torch.matmul calls, scaled to the run's
        # trial-iterations
        t = bamp.gauss_taps(op)
        rows, W = B * cfg.Lin, cfg.Lh * cfg.Nr
        fwd = [prec.split_bf16(x) for x in
               (t.s_a2, t.s_re, t.dmc) + (() if fused_bamp.real_x(cfg)
                                          else (t.cpd,))]
        adj = [prec.split_bf16(x) for x in (t.st_a2, t.st_re, t.amc, t.adm)]
        xs = prec.split_bf16(s1.var.reshape(rows, cfg.Nt))
        zs = prec.split_bf16(torch.rand(rows, W, device=dev))

        def gauss_bf16():
            for (xh, xl), planes in ((xs, fwd), (zs, adj)):
                for th, tl in planes:
                    torch.matmul(xh, th)
                    torch.matmul(xh, tl)
                    torch.matmul(xl, th)

        library_iter_ms = cuda_ms(gauss_bf16, 1, 3)
        del xs, zs
        timing = dict(kernel="fused_bamp_decode_high", case=name, B=B,
                      cap=cap, ms=ms, highest_ms=highest_ms,
                      plain_ms=plain_ms, high_over_highest=ms / highest_ms,
                      ns_per_iter_trial=1e6 * ms / iters, iterations=iters,
                      flop=flop, bytes=nbytes, bound_ms=bound_ms,
                      bound_by=bound_by, pct_of_bound=100 * bound_ms / ms,
                      achieved_tflops=flop / (ms * 1e-3) / 1e12,
                      library_ms=library_iter_ms * iters / B,
                      library_ms_per_iteration=library_iter_ms,
                      smem_bytes=fused_bamp.smem_bytes(cfg, high),
                      ptxas=ptxas_lines)
        emit("kernel_timing_bamp_high", **timing)
        timings.append(timing)
        del case, r, op, s0, s1, taps, state
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"K1 HIGH kernel != plain: {failed}")
    max_err = max(max_err, k1_wide_checks(torch, dev, high))
    return max_err, timings


# K1 past 32 column blocks (its HIGH layout's units span at most four n8
# tiles): the small OOK geometry at Lin 40 (1024 trials) and the OOK
# flagship's dimensions at Lin 40 (4096 trials, 8 dB, cap 12), each form
# held to its plain version under compare with the small rule and
# WIDE_RULES, the form with wrong products held to the same rule (it must
# fail it) and the form's one-iteration control; timed at the flagship's
# dimensions.
WIDE_LIN = 40
WIDE_B = 4096
# The flagship-dimension rule at Lin 40 per form (T agreement, |d mean T|,
# the state bound on the trials that stopped in both), between the
# readings of tests/torch_bamp_high_rule.py --lin 40 on an NVIDIA H100
# 80GB HBM3 at 700 W (kernel / float64 sums / the form with wrong
# products): HIGH 95.04% / 95.36% / HIGHEST's 89.50%, |d mean T| 0.0083 /
# 0.0015 / 0.074; DEFAULT 98.34% / 99.02% / HIGH's 77.71%, 0.0022 /
# 0.0007 / 0.176, state 5.4e-4 / 5.4e-4; the six split pairs 94.51-99.61%
# / 94.78-98.97% / the form at the variance chain's precision 67.14-
# 90.01%, |d mean T| at most 0.0034 / 0.0127 / at least 0.081, state at
# most 6.2e-4.  Twice the column blocks of the OOK flagship give about
# twice the trials one rounding at the stop test's tolerance parts (95.0%
# here against 97.7% at Lin 20 for HIGH), so the phase-1 rules' T limits
# (0.965, 0.985) do not hold two correct decodes here; compare's default
# limits (99.5%, 0.02) are printed beside (inside_default_rule).
WIDE_RULES = {"high": (0.93, 0.02, 1e-3), "default": (0.97, 0.02, 3e-3),
              "split": (0.93, 0.02, 3e-3)}


def k1_wide_wrong(failed, op, s0, y, s2, cap, cfg, sp, v, split, label,
                  name, min_agree, max_dmean):
    """The form with the wrong products, held to the rule of the form
    ``label`` against the plain version's ``sp``, must fail it: the form
    at the variance chain's precision, HIGHEST for HIGH, HIGH for
    DEFAULT."""
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    wrong = v if split else "high" if v == "default" else "highest"
    sw = fused_bamp.whole_decode(op, s0, y, s2, cap, cfg, wrong)
    frac, dmean, inside = rule_passes(sw, sp, min_agree, max_dmean)
    emit("kernel_wide_bamp_wrong", case=name, form=label, wrong=wrong,
         T_agree_fraction=frac, abs_dmean_T=dmean, inside_rule=inside)
    if inside:
        failed.append(f"{name}: the {wrong} form passes the rule")


def k1_wide_control(failed, kernel, plain, op, s0, y, s2, cfg, v, split,
                    label, name):
    """The form's one-iteration control, as its phase takes it."""
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    if split or v == "default":
        ps = plain(op, s0, y, s2, 2, cfg)
        one = plain(op, ps, y, s2, 3, cfg)
        gate_control(failed, "kernel_wide_bamp_control",
                     vamp_gap(kernel(op, ps, y, s2, 3, cfg), one),
                     vamp_gap(fused_bamp.whole_decode(
                         op, ps, y, s2, 3, cfg, v if split else "high"),
                         one),
                     XMAP_CONTROL if split else K1_DEFAULT_CONTROL,
                     "xmap_p50", case=name, form=label, presteps=2)
    else:
        one = plain(op, s0, y, s2, 1, cfg)
        gate_control(failed, "kernel_wide_bamp_control",
                     vamp_gap(kernel(op, s0, y, s2, 1, cfg), one),
                     vamp_gap(fused_bamp.whole_decode(
                         op, s0, y, s2, 1, cfg), one),
                     {BAMP_HIGH_CONTROL_STAT: HIGH_CONTROL_TOL},
                     BAMP_HIGH_CONTROL_STAT, case=name, form=label)


def k1_form_fns(v, x):
    """(kernel, plain, launch counter of the one-block form) of K1's form
    ``(v, x)``, each called as ``(op, s, y, sigma2, cap, cfg)``."""
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    split = x != v
    counter = ("launches_xmap" if split else "launches_default"
               if v == "default" else "launches_high" if v == "high"
               else "launches")
    kernel = lambda op, s, y, s2, c, cfg: fused_bamp.whole_decode(
        op, s, y, s2, c, cfg, v, x if split else None)
    plain = lambda op, s, y, s2, c, cfg: fused_bamp.decode_plain_split(
        op, s, y, s2, c, cfg, v, x) if split else fused_bamp.PLAIN[v](
            op, s, y, s2, c, cfg)
    return kernel, plain, counter


def k1_wide_checks(torch, dev, precision, x_precision=None):
    """The checks above for K1's form ``(precision, x_precision)``, then
    :func:`k1_cluster_checks`; the kernel must run (its launch counter
    moves); returns the largest state error of the trials whose T agrees
    and that converged; raises on a failed check."""
    import dataclasses

    from amp_sparc_spatialmodulation_tpu_torch.config import (
        Config, flagship_bamp_ook)
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    v, x = precision, x_precision or precision
    split = x != v
    label = f"{v}:{x}"
    rule = WIDE_RULES["split" if split else v]
    kernel, plain, counter = k1_form_fns(v, x)
    small = Config(Nt=16, Na=4, Nr=8, Lin=WIDE_LIN, Lh=3, mode="segmented",
                   profile="uniform", alphabet="OOK", trunc="tail",
                   iterations=12)
    flag = dataclasses.replace(flagship_bamp_ook(), Lin=WIDE_LIN)
    failed, max_err = [], 0.0
    for name, cfg, B, cap, snr, seed, (min_agree, max_dmean, tol) in (
            ("small_ook_lin40", small, SMALL_B, small.N_Layers, 10 ** 1.2,
             300, (BAMP_HIGH_SMALL_RULE["min_agree"],
                   BAMP_HIGH_SMALL_RULE["dmean_T_of_cap"] * small.N_Layers,
                   1e-4)),
            ("ook_flagship_lin40", flag, WIDE_B, K1, snr_of(flag, EBN0_DB),
             301, rule)):
        assert -(-cfg.Lin // 8) > 4 and fused_bamp.fits(cfg, v, x)
        r = montecarlo.generate_realization(make_generator(dev, seed), cfg,
                                            "sparc", "banded", B, snr, v)
        op, y, s2 = r.A, r.y, r.sigma2
        s0 = bamp.initial_state(y, cfg.N, s2)
        before = getattr(fused_bamp, counter)
        sk = kernel(op, s0, y, s2, cap, cfg)
        torch.cuda.synchronize()
        launched = getattr(fused_bamp, counter) - before
        sp = plain(op, s0, y, s2, cap, cfg)
        frac, dmean, inside = rule_passes(sk, sp, 0.995, 0.02)
        try:
            max_err = max(max_err, compare(
                "kernel_wide_bamp", sk, sp, tol, free_unconverged=True,
                min_agree=min_agree, max_dmean_T=max_dmean, case=name,
                form=label, Lin=cfg.Lin, cap=cap, launches=launched,
                inside_default_rule=inside,
                stopped_within_1e4=stopped_share(sk, sp)))
        except AssertionError as err:
            failed.append(str(err))
        if launched != 1:
            failed.append(f"{name}: {launched} launches of {counter}")
        if name.startswith("ook_flagship"):
            # timed as kernels_bamp_xmap times a form: the kernel beside its
            # plain version, the bound and the same products as PyTorch
            # calls
            ms = cuda_ms(lambda: kernel(op, s0, y, s2, cap, cfg), 1, 2)
            plain_ms = cuda_ms(lambda: plain(op, s0, y, s2, cap, cfg), 0, 1)
            tensors = [getattr(st, f) for st in (s0, sk)
                       for f in st._fields if f != "t"]
            tensors += [y] + k1_form_taps(cfg, op, v, x)
            flop, nbytes, iters, bound_ms, bound_by = split_work(
                cfg, s0, sk, tensors, v, x)
            rows, W = B * cfg.Lin, cfg.Lh * cfg.Nr
            lib, lib_form = split_library(
                torch, cfg, op, sk.var.reshape(rows, cfg.Nt),
                torch.rand(rows, W, device=dev), v, x)
            library_iter_ms = cuda_ms(lib, 1, 3)
            del lib, tensors
            emit("kernel_timing_bamp_wide", case=name, form=label, B=B,
                 cap=cap, Lin=cfg.Lin, ms=ms, plain_ms=plain_ms,
                 iterations=iters, flop=flop, bytes=nbytes,
                 bound_ms=bound_ms, bound_by=bound_by,
                 pct_of_bound=100 * bound_ms / ms,
                 library_ms=library_iter_ms * iters / B,
                 library_form=lib_form,
                 smem_bytes=fused_bamp.smem_bytes(cfg, v, x),
                 threads=fused_bamp.high_threads(cfg))
            k1_wide_wrong(failed, op, s0, y, s2, cap, cfg, sp, v, split,
                          label, name, min_agree, max_dmean)
        del sk, sp
        if name.startswith("ook_flagship"):
            k1_wide_control(failed, kernel, plain, op, s0, y, s2, cfg, v,
                            split, label, name)
        del r, op, y, s0
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"K1 {label} past 32 column blocks: {failed}")
    return max(max_err, k1_cluster_checks(torch, dev, v, x))


# K1's cluster form where one block holds no trial and JAX's K1 takes the
# batch (kernel_wide_bamp, case scamp_dims / qpsk_lin48): the SCAMP QPSK
# geometry (config.flagship_scamp(), Lin 40, published under
# Simulations/SCAMP/QPSK) for the forms on the HIGH layout (its HIGHEST
# form fits one block), and the QPSK flagship's dimensions at Lin 48 for
# HIGHEST, HIGH and DEFAULT (the split forms are held at the SCAMP
# geometry); 4096 trials, cap 100, at the Eb/N0 of CLUSTER_SHAPES.  Each
# form against its plain version under compare with the shape's rule
# (CLUSTER_RULES: T agreement, |d mean T|, and the state either within a
# bound on the trials that stopped in both with the same T, or, where
# two correct decodes part on a decided symbol, as the share of those
# trials within 1e-4), and the form's one-iteration control.  The limits
# lie between the readings of tests/torch_bamp_high_rule.py --cluster
# scamp_dims|qpsk_lin48 on an NVIDIA H100 80GB HBM3 at 700 W (kernel /
# float64 sums / the form with wrong products):
# - qpsk_lin48, 8 dB: HIGHEST identical to its plain version; HIGH T
#   agreement 74.41% / 74.63% / HIGHEST's 41.43%, |d mean T| 0.50 / 0.55
#   / 26.4, state 8.9e-6 / 3.5e-5; DEFAULT 94.07% / 94.41% / HIGH's
#   69.90%, 0.05 / 0.07 / 12.1, state 4.3e-4 / 4.3e-4: the form with
#   wrong products must fail the rule;
# - scamp_dims, 16 dB: BAMP decodes few trials at this geometry (mean T
#   88 of 100; 12 dB, main_bamp_wide's point, 94), and those that stop
#   do so near the allclose tolerance, so T parts as much between two
#   correct decodes as between right and wrong products (HIGH 87.94% /
#   88.18% / HIGHEST's 87.21%; DEFAULT 74.93% / 74.73% / HIGH's 73.54%;
#   the split pairs 74.3-90.2% / 75.3-91.1% / 72.9-86.8%, |d mean T| up
#   to 0.51 in every column), and two correct decodes may converge to
#   different decided symbols (state 0.31 on the trials that stopped with
#   the same T, float64 sums against the plain HIGH version).  There the
#   rule holds what two correct decodes share, and the control alone
#   tells wrong products (HIGH 1.3e-7 against HIGHEST's 4.7e-6; DEFAULT
#   and the split forms with a 'default' chain under XMAP_CONTROL's
#   1.5e-6, their wrong forms at 2.5e-3; every split pair under it, the
#   wrong forms over it).  The share of the stopped trials with the same T
#   within 1e-4 holds two correct decodes (HIGH 100% / 99.83%, DEFAULT
#   99.02% / 100%, the split pairs 99.49-100% / 99.58-100%) and fails the
#   forms with a wrong 'default' chain (0%).
CLUSTER_B = 4096
CLUSTER_CAP = 100
CLUSTER_SHAPES = {"scamp_dims": (16.0, 305), "qpsk_lin48": (8.0, 306)}
# (T agreement, |d mean T|, state bound or None, share of the stopped
# trials within 1e-4 or None, the form with wrong products must fail)
CLUSTER_RULES = {
    ("qpsk_lin48", "highest:highest"): (0.995, 0.02, 1e-3, None, False),
    ("qpsk_lin48", "high:high"): (0.70, 2.0, 1e-3, None, True),
    ("qpsk_lin48", "default:default"): (0.90, 2.0, 3e-3, None, True),
    ("scamp_dims", "high:high"): (0.85, 0.8, None, 0.98, False),
    ("scamp_dims", "default:default"): (0.72, 0.8, None, 0.98, False),
    ("scamp_dims", "highest:high"): (0.84, 0.8, None, 0.98, False),
    ("scamp_dims", "highest:default"): (0.71, 0.8, None, 0.98, False),
    ("scamp_dims", "high:default"): (0.71, 0.8, None, 0.98, False),
    ("scamp_dims", "high:highest"): (0.87, 0.8, None, 0.98, False),
    ("scamp_dims", "default:high"): (0.79, 0.8, None, 0.98, False),
    ("scamp_dims", "default:highest"): (0.81, 0.8, None, 0.98, False),
}
# The state errors of every cluster check with a state bound, for the
# cluster form's entry of the kernels line.
CLUSTER_ERRS = []


def cluster_config(name):
    import dataclasses

    from amp_sparc_spatialmodulation_tpu_torch.config import (
        flagship_bamp_qpsk, flagship_scamp)
    if name == "scamp_dims":
        return flagship_scamp()
    return dataclasses.replace(flagship_bamp_qpsk(), Lin=48)


def k1_cluster_checks(torch, dev, v, x=None):
    """The cluster checks above for K1's form ``(v, x)`` at the shapes that
    hold it: the launch must be a cluster launch (``launches_cluster``
    moves by one, the form's own counter not at all); returns the largest
    state error under a state bound; raises on a failed check."""
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    x = x or v
    split = x != v
    label = f"{v}:{x}"
    kernel, plain, counter = k1_form_fns(v, x)
    failed, max_err = [], 0.0
    for name, (ebn0, seed) in CLUSTER_SHAPES.items():
        if (name, label) not in CLUSTER_RULES:
            continue
        min_agree, max_dmean, tol, min_stopped, separates = CLUSTER_RULES[
            (name, label)]
        cfg = cluster_config(name)
        plan = fused_bamp.cluster_plan(cfg, v, x)
        assert plan.ctas > 1 and fused_bamp.jax_fits(cfg, RES)
        r = montecarlo.generate_realization(
            make_generator(dev, seed), cfg, "sparc", "banded", CLUSTER_B,
            snr_of(cfg, ebn0), v)
        op, y, s2 = r.A, r.y, r.sigma2
        s0 = bamp.initial_state(y, cfg.N, s2)
        before = (fused_bamp.launches_cluster, getattr(fused_bamp, counter))
        sk = kernel(op, s0, y, s2, CLUSTER_CAP, cfg)
        torch.cuda.synchronize()
        launched = (fused_bamp.launches_cluster - before[0],
                    getattr(fused_bamp, counter) - before[1])
        sp = plain(op, s0, y, s2, CLUSTER_CAP, cfg)
        inside = rule_passes(sk, sp, 0.995, 0.02)[2]
        stopped = stopped_share(sk, sp)
        try:
            err = compare(
                "kernel_wide_bamp", sk, sp, math.inf if tol is None else tol,
                free_unconverged=True, min_agree=min_agree,
                max_dmean_T=max_dmean, case=name, form=label, Lin=cfg.Lin,
                cap=CLUSTER_CAP, ebn0_db=ebn0, ctas=plan.ctas,
                smem_bytes=plan.smem, threads=plan.threads,
                cluster_launches=launched[0], inside_default_rule=inside,
                stopped_within_1e4=stopped, min_stopped_within_1e4=min_stopped)
            if tol is not None:
                max_err = max(max_err, err)
                CLUSTER_ERRS.append(err)
        except AssertionError as exc:
            failed.append(str(exc))
        if min_stopped is not None and stopped < min_stopped:
            failed.append(f"{name}: {stopped} of the stopped trials within "
                          "1e-4")
        if launched != (1, 0):
            failed.append(f"{name}: launches (cluster, {counter}) "
                          f"{launched}")
        if v != "highest" or split:
            wrong = []
            k1_wide_wrong(wrong, op, s0, y, s2, CLUSTER_CAP, cfg, sp, v,
                          split, label, name, min_agree, max_dmean)
            if separates:
                failed += wrong
            k1_wide_control(failed, kernel, plain, op, s0, y, s2, cfg, v,
                            split, label, name)
        del sk, sp, r, op, y, s0
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"K1 {label} as a cluster: {failed}")
    return max_err


# K1's forms: HIGHEST, HIGH, DEFAULT, then the six split pairs.
K1_FORMS = (("highest", "highest"), ("high", "high"),
            ("default", "default"))
# The cluster sizes kernel_cluster_bamp forces where one block would do.
CLUSTER_FORCED = (2, 4)


def phase_kernel_cluster_bamp(torch, dev):
    """K1's cluster form against its one-block form: every form (HIGHEST,
    HIGH, DEFAULT and the six split pairs) at the OOK flagship (Lin 20,
    4096 trials, 8 dB, cap 12) and the QPSK flagship (Lin 25, 4096 trials,
    5 dB, cap 100), forced onto clusters of 2 and 4 blocks a trial
    (``whole_decode(..., ctas=c)``).  No partition changes the order of any
    sum, so every plane of every trial, T and the active flags must equal
    the one-block launch's bit for bit; each cluster launch is counted in
    ``launches_cluster``.  Prints both times by CUDA events.  Then the
    HIGHEST cluster checks of :func:`k1_cluster_checks` (the other forms
    run theirs in their phases).  Returns the timings."""
    from amp_sparc_spatialmodulation_tpu_torch.config import (
        flagship_bamp_ook, flagship_bamp_qpsk)
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    fields = BAMP_FIELDS + ("active", "T")
    failed, timings = [], []
    for name, cfg, cap, ebn0, seed in (
            ("ook_flagship", flagship_bamp_ook(), K1, EBN0_DB, 303),
            ("qpsk_flagship", flagship_bamp_qpsk(), 100, BAMP_HIGH_EBN0_DB,
             304)):
        r = montecarlo.generate_realization(
            make_generator(dev, seed), cfg, "sparc", "banded", FLAGSHIP_B,
            snr_of(cfg, ebn0), "highest")
        op, y, s2 = r.A, r.y, r.sigma2
        s0 = bamp.initial_state(y, cfg.N, s2)
        for v, x in K1_FORMS + XMAP_PAIRS:
            run = partial(fused_bamp.whole_decode, op, s0, y, s2, cap, cfg,
                          v, x)
            one = run(ctas=1)
            line = dict(case=name, form=f"{v}:{x}", B=FLAGSHIP_B, cap=cap,
                        one_block_ms=cuda_ms(partial(run, ctas=1), 0, 2),
                        one_block_smem=fused_bamp.smem_bytes(cfg, v, x),
                        mean_T=float(one.T.float().mean()))
            for c in CLUSTER_FORCED:
                plan = fused_bamp.cluster_plan(cfg, v, x, ctas=c)
                if plan.ctas != c:
                    failed.append(f"{name} {v}:{x}: no cluster of {c}")
                    continue
                before = fused_bamp.launches_cluster
                sc = run(ctas=c)
                torch.cuda.synchronize()
                launched = fused_bamp.launches_cluster - before
                same = [f for f in fields
                        if torch.equal(getattr(sc, f), getattr(one, f))]
                line[f"ctas{c}"] = dict(
                    ms=cuda_ms(partial(run, ctas=c), 0, 2),
                    identical=len(same) == len(fields) and sc.t == one.t,
                    differing=[f for f in fields if f not in same],
                    launches=launched, smem=plan.smem, threads=plan.threads,
                    cols=plan.cols)
                if not line[f"ctas{c}"]["identical"] or launched != 1:
                    failed.append(f"{name} {v}:{x} ctas={c}")
                del sc
            emit("kernel_cluster_bamp", **line)
            timings.append(line)
            del one
        del r, op, y, s0
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"K1's cluster form != its one-block form: "
                             f"{failed}")
    k1_cluster_checks(torch, dev, "highest")
    return timings


# main_bamp_wide: BAMP on the SCAMP QPSK geometry (config.flagship_scamp(),
# the uncoupled baseline of that published SCAMP curve) at one of its
# points, HIGH beside HIGHEST on the same seeds, 2 realizations of 65536.
WIDE_MAIN_DB = 12.0
WIDE_MAIN_REALIZATIONS = 2
# The plain HIGH version's trials a call in the timing line (15 GB of the
# card's memory at this geometry; 65536 in one call pass its 80 GB).
WIDE_PLAIN_CHUNK = 16384


def phase_main_bamp_wide(torch, dev):
    """``Simulator(config.flagship_scamp(), algo='bamp', precision='high')``
    beside ``precision='highest'`` on the same seeds at Eb/N0 = 12 dB, cap
    100, single phase, 2 realizations of 65536 each: the user's ``cli sweep
    --Nt 128 --Na 16 --Nr 16 --Lin 40 --Lh 9 --mode sparc --alphabet QPSK
    --algo bamp --precision high``.  One block holds no HIGH trial there
    (284,160 B) and JAX's K1 takes the batch, so the HIGH run goes through
    K1's cluster form; HIGHEST is a one-block K1.  Gates as in
    ``main_bamp_high``: route ``'whole'``, cluster launches > 0 and no
    other K1 launch in the HIGH run, no plain decode, FER and BER within 3
    sigma of HIGHEST's, mean T within 1.0.  Prints both runs' trials/s,
    FER, BER, mean T and a per-layer split of one HIGH realization, then
    the cluster form's timing at this shape (``kernel_timing_bamp_cluster``:
    ms per launch by CUDA events, the bound, the same bf16 products as
    torch.matmul calls, the plain HIGH version).  Returns (cluster
    launches, the timing)."""
    from amp_sparc_spatialmodulation_tpu_torch.config import flagship_scamp
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    from amp_sparc_spatialmodulation_tpu_torch.utils import metrics
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    cfg = flagship_scamp()
    n_real, epochs = WIDE_MAIN_REALIZATIONS, WIDE_MAIN_REALIZATIONS * RES
    plan = fused_bamp.cluster_plan(cfg, "high")
    counters = ("launches", "launches_high", "launches_default",
                "launches_xmap", "launches_cluster")
    runs = {}
    for precision in ("highest", "high"):
        sim = montecarlo.Simulator(cfg, algo="bamp", device=dev,
                                   precision=precision,
                                   progress=lambda s: None)
        torch.cuda.synchronize()
        for c in counters:
            setattr(fused_bamp, c, 0)
        bamp.plain_decodes = 0
        t0 = time.perf_counter()
        avg = sim.run_point(WIDE_MAIN_DB, epochs=epochs, res=RES)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs[precision] = dict(
            avg=avg, seconds=seconds, trials_per_s=epochs / seconds,
            plain=bamp.plain_decodes,
            **{c: getattr(fused_bamp, c) for c in counters})
    hi, hs = runs["high"], runs["highest"]

    gen = make_generator(dev, 12346)
    layers = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        layers[name] = time.perf_counter() - t
        return res

    r = timed("generate_s", lambda: montecarlo.generate_realization(
        gen, cfg, "sparc", "banded", RES, snr_of(cfg, WIDE_MAIN_DB), "high"))
    way = bamp.route(cfg, r.A, RES, dev, "high")
    out = timed("decode_s", lambda: bamp.decode(r.A, r.y, r.sigma2, cfg,
                                                precision="high"))
    timed("metrics_s", lambda: metrics.fetch_sums(metrics.evaluate_sums(
        out.xmap, out.xmmse, r.msg, out.T, cfg)))
    bsig = ber_sigma(torch, cfg, out, r.msg, RES, epochs)
    finite = bool(torch.isfinite(torch.view_as_real(out.xmap)).all())
    del out

    sigma = fer_sigma(hs["avg"]["fer"], epochs)
    emit("main_bamp_wide", config="flagship_scamp", algo="bamp",
         ebn0_db=WIDE_MAIN_DB, res=RES, realizations=n_real, trials=epochs,
         cap=cfg.N_Layers, route=way, ctas=plan.ctas, smem=plan.smem,
         threads=plan.threads, smem_one_block=fused_bamp.smem_bytes(
             cfg, "high"), jax_fits=fused_bamp.jax_fits(cfg, RES),
         **{f"{p}_{k}": v for p, run in runs.items()
            for k, v in (("seconds", run["seconds"]),
                         ("trials_per_s", run["trials_per_s"]),
                         ("mean_T", run["avg"]["T"]),
                         ("fer", run["avg"]["fer"]),
                         ("ber", run["avg"]["ber"]),
                         ("plain_decodes", run["plain"]),
                         *((c, run[c]) for c in counters))},
         high_over_highest_trials_per_s=(hi["trials_per_s"]
                                         / hs["trials_per_s"]),
         fer_sigma=sigma, ber_sigma=bsig, layers_high=layers, finite=finite,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if (way != "whole" or plan.ctas < 2 or hi["launches_cluster"] <= 0
            or any(hi[c] for c in counters[:-1]) or hi["plain"]
            or hs["plain"] or not finite):
        raise AssertionError("the BAMP HIGH path on the SCAMP geometry did "
                             "not run through K1's cluster form alone")
    if abs(hi["avg"]["fer"] - hs["avg"]["fer"]) > 3 * sigma:
        raise AssertionError(f"BAMP wide HIGH FER {hi['avg']['fer']} vs "
                             f"HIGHEST {hs['avg']['fer']}")
    if abs(hi["avg"]["ber"] - hs["avg"]["ber"]) > 3 * bsig:
        raise AssertionError(f"BAMP wide HIGH BER {hi['avg']['ber']} vs "
                             f"HIGHEST {hs['avg']['ber']}")
    if abs(hi["avg"]["T"] - hs["avg"]["T"]) > 1.0:
        raise AssertionError(f"BAMP wide HIGH mean T {hi['avg']['T']} vs "
                             f"HIGHEST {hs['avg']['T']}")

    # the cluster form at this shape: the realization above, decoded once
    # more to cap 100 and timed
    op, y, s2 = r.A, r.y, r.sigma2
    s0 = bamp.initial_state(y, cfg.N, s2)
    kernel, plain, _ = k1_form_fns("high", "high")
    before = fused_bamp.launches_cluster
    s1 = kernel(op, s0, y, s2, cfg.N_Layers, cfg)
    torch.cuda.synchronize()
    if fused_bamp.launches_cluster - before != 1:
        raise AssertionError("the timed decode was not a cluster launch")
    ms = cuda_ms(lambda: kernel(op, s0, y, s2, cfg.N_Layers, cfg), 0, 2)
    tensors = [getattr(st, f) for st in (s0, s1) for f in st._fields
               if f != "t"]
    tensors += [y] + k1_form_taps(cfg, op, "high")
    flop, nbytes, iters, bound_ms, bound_by = split_work(
        cfg, s0, s1, tensors, "high", "high")
    rows, W = RES * cfg.Lin, cfg.Lh * cfg.Nr
    lib, lib_form = split_library(torch, cfg, op,
                                  s1.var.reshape(rows, cfg.Nt),
                                  torch.rand(rows, W, device=dev), "high",
                                  "high")
    library_iter_ms = cuda_ms(lib, 1, 2)
    del lib, tensors
    # the plain version over the same trials in chunks (its planes at
    # 65536 trials pass the card's memory)
    chunks = [(y[i:i + WIDE_PLAIN_CHUNK], bamp.initial_state(
        y[i:i + WIDE_PLAIN_CHUNK], cfg.N, s2))
        for i in range(0, RES, WIDE_PLAIN_CHUNK)]
    plain_ms = cuda_ms(lambda: [plain(op, c0, yc, s2, cfg.N_Layers, cfg)
                                for yc, c0 in chunks], 0, 1)
    del chunks
    timing = dict(kernel="fused_bamp_decode_cluster", case="scamp_dims",
                  form="high:high", B=RES, cap=cfg.N_Layers,
                  ebn0_db=WIDE_MAIN_DB, ctas=plan.ctas, ms=ms,
                  plain_ms=plain_ms, plain_chunk=WIDE_PLAIN_CHUNK,
                  iterations=iters,
                  mean_T=float(s1.T.float().mean()), flop=flop,
                  bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
                  pct_of_bound=100 * bound_ms / ms,
                  library_ms=library_iter_ms * iters / RES,
                  library_ms_per_iteration=library_iter_ms,
                  library_form=lib_form, smem_bytes=plan.smem,
                  threads=plan.threads)
    emit("kernel_timing_bamp_cluster", **timing)
    return hi["launches_cluster"], timing


def phase_main_bamp_high(torch, dev):
    """``Simulator(config.flagship_bamp_qpsk(), algo='bamp',
    precision='high')`` beside ``precision='highest'`` on the same seeds at
    Eb/N0 = 5 dB, cap 100, single phase (the BAMPfinal QPSK point whose
    mean T pins at the cap, where 'auto' picks HIGH), 2 realizations of
    65536 each.  Gates: the HIGH run through K1's HIGH instance alone (no
    plain decode, no HIGHEST launch), FER(high) within 3 sigma of
    FER(highest) (sigma binomial from the highest run's count, at least
    one error), BER(high) within 3 sigma of BER(highest) (sigma of the
    difference of two runs' means, from the BER scatter of
    ``BAMP_HIGH_BER_GROUPS`` groups of one HIGH realization's trials), mean
    T within 1.0.  Prints both runs' trials/s, FER, BER and mean T and a
    per-layer breakdown of one HIGH realization."""
    from amp_sparc_spatialmodulation_tpu_torch.config import (
        flagship_bamp_qpsk)
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    from amp_sparc_spatialmodulation_tpu_torch.utils import metrics
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    cfg = flagship_bamp_qpsk()
    n_real, epochs = BAMP_HIGH_REALIZATIONS, BAMP_HIGH_REALIZATIONS * RES
    runs = {}
    for precision in ("highest", "high"):
        sim = montecarlo.Simulator(cfg, algo="bamp", device=dev,
                                   precision=precision,
                                   progress=lambda s: None)
        torch.cuda.synchronize()
        fused_bamp.launches = fused_bamp.launches_high = 0
        bamp.plain_decodes = 0
        t0 = time.perf_counter()
        avg = sim.run_point(BAMP_HIGH_EBN0_DB, epochs=epochs, res=RES)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs[precision] = dict(
            avg=avg, seconds=seconds, trials_per_s=epochs / seconds,
            launches=fused_bamp.launches,
            launches_high=fused_bamp.launches_high,
            plain=bamp.plain_decodes)
    hi, hs = runs["high"], runs["highest"]

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
        gen, cfg, "sparc", "banded", RES, snr_of(cfg, BAMP_HIGH_EBN0_DB),
        "high"))
    out = timed("decode_s", lambda: bamp.decode(r.A, r.y, r.sigma2, cfg,
                                                precision="high"))
    timed("metrics_s", lambda: metrics.fetch_sums(metrics.evaluate_sums(
        out.xmap, out.xmmse, r.msg, out.T, cfg)))
    bsig = ber_sigma(torch, cfg, out, r.msg, RES, epochs)
    del r, out

    sigma = fer_sigma(hs["avg"]["fer"], epochs)
    emit("main_bamp_high", config="flagship_bamp_qpsk",
         ebn0_db=BAMP_HIGH_EBN0_DB, res=RES, realizations=n_real,
         trials=epochs, cap=cfg.N_Layers,
         **{f"{p}_{k}": v for p, run in runs.items()
            for k, v in (("seconds", run["seconds"]),
                         ("trials_per_s", run["trials_per_s"]),
                         ("mean_T", run["avg"]["T"]),
                         ("fer", run["avg"]["fer"]),
                         ("ber", run["avg"]["ber"]),
                         ("launches", run["launches"]),
                         ("launches_high", run["launches_high"]),
                         ("plain_decodes", run["plain"]))},
         high_over_highest_trials_per_s=(hi["trials_per_s"]
                                         / hs["trials_per_s"]),
         fer_sigma=sigma, ber_sigma=bsig, layers_high=layers,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if hi["launches_high"] <= 0 or hi["launches"] or hi["plain"]:
        raise AssertionError("the BAMP HIGH path did not run through K1's "
                             "HIGH instance alone")
    if abs(hi["avg"]["fer"] - hs["avg"]["fer"]) > 3 * sigma:
        raise AssertionError(f"BAMP HIGH FER {hi['avg']['fer']} vs "
                             f"HIGHEST {hs['avg']['fer']}")
    if abs(hi["avg"]["ber"] - hs["avg"]["ber"]) > 3 * bsig:
        raise AssertionError(f"BAMP HIGH BER {hi['avg']['ber']} vs "
                             f"HIGHEST {hs['avg']['ber']}")
    if abs(hi["avg"]["T"] - hs["avg"]["T"]) > 1.0:
        raise AssertionError(f"BAMP HIGH mean T {hi['avg']['T']} vs "
                             f"HIGHEST {hs['avg']['T']}")
    return hi["launches_high"]


# K5's HIGH form against its plain HIGH version (kernels_tiled_high).  As
# for K1's HIGH form, two correct HIGH decodes part on T where trials stop by
# the allclose test, so each shape has its own T rule, whose limits lie
# between the readings of tests/torch_bamp_high_rule.py --route tiled on an
# NVIDIA H100 (PERF.md, section 6): below, the kernel and the plain HIGH
# version with exactly summed products (two correct decodes); above, the
# plain HIGH version without its hi x lo pass and, where it separates,
# K5's HIGHEST instance.  Per shape (cap, T agreement, |d mean T|, the
# HIGHEST instance must fail): T agreement (kernel / exact sums against
# HIGHEST / one pass)
# - ook_8_3, 1024 trials: 98.3% / 98.1% against 95.2% / 89.8%;
# - ook_12_5: 99.0% / 99.6% against 98.1% / 92.0%;
# - bpsk_8_3: 93.4% / 94.7% against 86.7% / 78.7%;
# - ook_ragged_37: 36, 36 of 37 against 34 and 32;
# - the massive geometry at 10 dB, 2048 trials, cap 100: 95.7% / 96.4%
#   against 95.1% / 46.6%, |d mean T| 0.008 / 0.013 against 0.007 / 0.15:
#   at this width HIGH does not move T (JAX's K5 at HIGH and its XLA decode
#   agree there too, tests/torch_parity_flagship.py), so HIGHEST passes
#   the T rule and the control alone holds it apart;
# - the phase-2 shape (a handful of trials, most at the cap): the parity
#   rule, |d mean T| within 2% of the cap.
K5_HIGH_RULES = {"ook_8_3": (30, 0.965, 0.6, True),
                 "ook_12_5": (30, 0.975, 0.6, False),
                 "bpsk_8_3": (30, 0.90, 0.6, True),
                 "ook_ragged_37": (30, 0.94, 0.6, False),
                 "massive_10db": (100, 0.90, 0.08, False)}
# The control: one iteration from the state after K5_HIGH_PRESTEPS plain
# HIGH iterations (from the initial state z' = 0 exactly in every form),
# the median |d z_re| against the plain HIGH step; the forward's inputs
# are the same in every form, so this reading is the products' own:
# 7.5e-9 to 1.5e-7 for the kernel and the exact sums, 7.4e-7 to 1.2e-6 for
# HIGHEST, 4.5e-4 to 8.2e-4 for one pass.
K5_HIGH_PRESTEPS = 2
K5_HIGH_CONTROL_STAT = "z_re_p50"
K5_HIGH_CONTROL_TOL = 3e-7
# main_massive_high: massive_mimo() at its own cap of 100 and Eb/N0 = 8 dB,
# where every trial runs to the cap (the regime 'auto' picks HIGH for), and
# the converging point of kernels_tiled_high; 2 realizations of 2048 per
# form, single phase.
MASSIVE_HIGH_DB = 8.0
MASSIVE_CONVERGING_DB = 10.0
MASSIVE_HIGH_CAP = 100
MASSIVE_HIGH_REALIZATIONS = 2


def massive_main_config():
    """``config.massive_mimo()`` at the iteration cap of
    scripts/bench_massive.py:37 (300)."""
    import dataclasses

    from amp_sparc_spatialmodulation_tpu_torch.config import massive_mimo
    return dataclasses.replace(massive_mimo(), iterations=MASSIVE_CAP)


def tiled_small_config(**kw):
    """The small geometry of tests/test_pallas_tiled.py:17-20."""
    from amp_sparc_spatialmodulation_tpu_torch.config import Config
    base = dict(Nt=16, Na=4, Nr=10, Lin=8, Lh=3, mode="segmented",
                alphabet="OOK", profile="uniform", trunc="tail",
                iterations=30)
    return Config(**{**base, **kw})


def iteration_work(cfg, B, products, planes):
    """(flop, bytes) of one iteration of ``B`` active trials: ``products``
    real banded products of 2 flop per tap element, and ``planes`` the
    tensors read once or written once."""
    from amp_sparc_spatialmodulation_tpu_torch.ops.channel import (
        band_indices)
    blocks = sum(len(band_indices(cfg.Lin, cfg.Lout, l, cfg.trunc)[0])
                 for l in range(cfg.Lh))
    flop = B * products * 2 * blocks * cfg.Nt * cfg.Nr
    return flop, sum(t.numel() * t.element_size() for t in planes)


def phase_kernels_tiled(torch, dev, ptxas):
    """K5 against its plain version (``compare``), both driven through
    ``bamp.plane_loop``: the small geometries of tests/test_pallas_tiled.py
    (Lin, Lh = 8, 3 and 12, 5; and BPSK) at 1024 trials and a ragged batch
    of 37; the massive geometry at 512 trials, cap 10, and split at 20 and
    resumed to 40; the main path's phase 1 (2048 trials, cap 40) and phase 2
    (its still-active trials, gathered, to cap 300; its wall seconds per
    iteration beside the device time inside the wrapper's calls).  Then one
    iteration at B = 2048 timed by CUDA events beside its bound, the plain
    step and the products of the plain step as torch.matmul calls; the
    four launches of one call timed apart (the stage mask) at B = 2048 and
    at the phase-2 shape, where one iteration is timed beside its own
    bound (``tail_*``); the kernel's shared memory per product block
    against the wrapper's mirror, and ``ptxas``'s register and spill
    lines."""
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_bamp_tiled as kern)
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    def realization(cfg, B, seed, snr):
        r = montecarlo.generate_realization(make_generator(dev, seed), cfg,
                                            "sparc", "banded", B, snr)
        return r, bamp.initial_state(r.y, cfg.N, r.sigma2)

    def run(cfg, r, s0, cap, y=None, plain=False):
        loop = kern.decode_plain if plain else partial(bamp.plane_loop,
                                                       kern.iteration)
        return loop(r.A, s0, r.y if y is None else y, r.sigma2, cap, cfg)

    def check(phase, cfg, r, s0, limit, tol, y=None, **info):
        sk = run(cfg, r, s0, limit, y)
        sp = run(cfg, r, s0, limit, y, plain=True)
        torch.cuda.synchronize()
        return compare(phase, sk, sp, tol, **info), sk, sp

    t0 = time.perf_counter()
    max_err = 0.0
    cases = [("ook_8_3", {}, SMALL_B), ("ook_12_5", dict(Lin=12, Lh=5),
                                        SMALL_B),
             ("bpsk_8_3", dict(alphabet="BPSK"), SMALL_B),
             ("ook_ragged_37", {}, 37)]
    for i, (name, kw, B) in enumerate(cases):
        cfg = tiled_small_config(**kw)
        r, s0 = realization(cfg, B, 400 + i, 10 ** 0.8)
        err, *_ = check("kernel_small_tiled", cfg, r, s0, cfg.N_Layers, 1e-4,
                        case=name)
        max_err = max(max_err, err)

    mcfg = massive_main_config()
    snr = snr_of(mcfg, MASSIVE_EBN0_DB)
    r, s0 = realization(mcfg, 512, 41, snr)
    err, *_ = check("kernel_massive_tiled", mcfg, r, s0, 10, 1e-3, cap=10)
    max_err = max(max_err, err)
    full = run(mcfg, r, s0, 40)
    resumed = run(mcfg, r, run(mcfg, r, s0, 20), 40)
    split_ok = (bool(torch.equal(full.T, resumed.T))
                and state_err(full, resumed, slice(None)) == 0.0)
    emit("kernel_split_resume_tiled", identical=split_ok)
    if not split_ok:
        raise AssertionError("split-and-resume changed T (tiled)")
    del full, resumed

    # the main path's phase 1 and phase 2
    r, s0 = realization(mcfg, MASSIVE_RES, 43, snr)
    err, s1, _ = check("kernel_phase1_tiled", mcfg, r, s0, MASSIVE_K1, 1e-3,
                       cap=MASSIVE_K1)
    max_err = max(max_err, err)
    idx = torch.nonzero(s1.active).flatten()
    if not idx.numel():
        raise AssertionError("no trial left for phase 2 (tiled)")
    s2, y2 = montecarlo.state_take_trials(s1, idx), r.y[idx]
    err, sk2, _ = check("kernel_phase2_tiled", mcfg, r, s2, MASSIVE_CAP,
                        1e-3, y=y2, free_unconverged=True, cap=MASSIVE_CAP,
                        phase2_B=int(idx.numel()))
    max_err = max(max_err, err)
    phase2 = phase2_timing(torch, kern, mcfg, r, s2, y2, sk2)
    # The same phase-2 trials copied to a batch of the phase-1 size: the
    # matrix library then sums as at phase 1, where K5 equals its plain
    # version bit for bit (printed, not gated).
    copies = -(-MASSIVE_RES // int(idx.numel()))
    big = s2._replace(**{f: torch.cat([getattr(s2, f)] * copies)
                         for f in s2._fields if f != "t"})
    sp_big = kern.decode_plain(r.A, big, torch.cat([y2] * copies), r.sigma2,
                               MASSIVE_CAP, mcfg)
    n2 = int(idx.numel())
    first = sp_big._replace(**{f: getattr(sp_big, f)[:n2]
                               for f in sp_big._fields if f != "t"})
    same = torch.equal(first.T, sk2.T) and all(
        torch.equal(getattr(first, f), getattr(sk2, f)) for f in BAMP_FIELDS)
    emit("kernel_phase2_tiled_large_batch", copies=copies, B=copies * n2,
         T_identical=bool(torch.equal(first.T, sk2.T)), bit_exact=same,
         max_abs_err=state_err(first, sk2, slice(None)))
    del big, sp_big, first

    # one iteration at B = 2048, all trials active
    ps = bamp.to_planes(s0)
    y_re, y_im = r.y.real.contiguous(), r.y.imag.contiguous()
    out = {}
    ms = cuda_ms(lambda: out.update(k=kern.iteration(
        r.A, ps, y_re, y_im, r.sigma2, mcfg)), 2, 10)
    plain_ms = cuda_ms(lambda: kern.iteration_plain(
        r.A, ps, y_re, y_im, r.sigma2, mcfg), 1, 5)
    # the plain step's four products as torch.matmul calls
    A = r.A
    B, Lin, W = MASSIVE_RES, mcfg.Lin, mcfg.Lh * mcfg.Nr
    xc = s0.xmmse.reshape(B * Lin, mcfg.Nt)
    vr = s0.var.reshape(B * Lin, mcfg.Nt)
    zc = torch.complex(torch.rand(B * Lin, W, device=dev),
                       torch.rand(B * Lin, W, device=dev))
    zu = torch.rand(B * Lin, W, device=dev)
    hs, a2s = A.h_stack, A.abs_h2_stack
    library = {
        "forward_complex": cuda_ms(lambda: xc @ hs, 2, 10),
        "forward_abs2": cuda_ms(lambda: vr @ a2s, 2, 10),
        "adjoint_complex": cuda_ms(lambda: zc @ hs.conj().T, 2, 10),
        "adjoint_abs2": cuda_ms(lambda: zu @ a2s.T, 2, 10)}
    library_ms = sum(library.values())
    k = out["k"]
    planes = [ps.xm_re, ps.var, ps.z_re, ps.z_im, ps.u, y_re, y_im,
              ps.active, A.h, A.abs_h2, A.gains, k.xmap_re, k.xmap_im,
              k.xm_re, k.var, k.z_re, k.z_im, k.u, k.notok]
    # real products per iteration for a real x: |H|^2 var, H x (2),
    # |H|^2^T (1/u), H^H r (4): 16 flop per tap element
    flop, nbytes = iteration_work(mcfg, B, 8, planes)
    bound_ms, bound_by = bound(flop, nbytes)
    stage_ms = kern.stage_ms(r.A, ps, y_re, y_im, r.sigma2, mcfg)
    # the phase-2 shape: the gathered trials, all active at its start
    ps2 = bamp.to_planes(s2)
    y2_re, y2_im = y2.real.contiguous(), y2.imag.contiguous()
    tail_ms = cuda_ms(lambda: out.update(t=kern.iteration(
        r.A, ps2, y2_re, y2_im, r.sigma2, mcfg)), 2, 20)
    kt = out["t"]
    tail_flop, tail_bytes = iteration_work(
        mcfg, n2, 8, [ps2.xm_re, ps2.var, ps2.z_re, ps2.z_im, ps2.u, y2_re,
                      y2_im, ps2.active, A.h, A.abs_h2, A.gains,
                      *[getattr(kt, f) for f in kt._fields]])
    tail_bound_ms, tail_bound_by = bound(tail_flop, tail_bytes)
    lib = kern._library()
    smem = {f"{name}_{form}": (lib.fused_bamp_tiled_smem(fwd, small, 0),
                               kern.smem_bytes(bool(fwd), bool(small)))
            for name, fwd in (("forward", 1), ("adjoint", 0))
            for form, small in (("large", 0), ("small", 1))}
    timing = dict(kernel="fused_bamp_tiled", B=B, ms=ms, plain_ms=plain_ms,
                  library_ms=library_ms, library_ms_by_product=library,
                  flop=flop, bytes=nbytes, bound_ms=bound_ms,
                  bound_by=bound_by, pct_of_bound=100 * bound_ms / ms,
                  achieved_tflops=flop / (ms * 1e-3) / 1e12,
                  us_per_trial_iteration=1e3 * ms / B,
                  stage_ms=stage_ms,
                  tail_B=n2, tail_ms=tail_ms, tail_bound_ms=tail_bound_ms,
                  tail_bound_by=tail_bound_by,
                  tail_pct_of_bound=100 * tail_bound_ms / tail_ms,
                  tail_stage_ms=kern.stage_ms(r.A, ps2, y2_re, y2_im,
                                              r.sigma2, mcfg),
                  tail_kernel_us=kernel_us(torch, lambda: kern.iteration(
                      r.A, ps2, y2_re, y2_im, r.sigma2, mcfg)),
                  tail_forms=kern.tile_forms(n2, mcfg.Lin,
                                             mcfg.Lh * mcfg.Nr, mcfg.Nt),
                  **phase2, smem_bytes=smem, ptxas=list(ptxas),
                  seconds=time.perf_counter() - t0)
    emit("kernel_timing_tiled", **timing)
    if any(c != p for c, p in smem.values()):
        raise AssertionError(f"K5 shared memory differs from the wrapper's "
                             f"mirror: {smem}")
    return max_err, timing


def kernel_us(torch, fn, reps: int = 10) -> dict:
    """Device microseconds per call of K5's four kernels and of the other
    device work ``fn`` launches (the wrapper's small PyTorch kernels and
    copies), from a ``torch.profiler`` trace of ``reps`` calls after one
    untraced call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us > 0:
            name = next((n for k, n in (("split_kernel", "split"),
                                        ("product_kernel<true", "forward"),
                                        ("fold_kernel", "fold"),
                                        ("product_kernel<false", "adjoint"),
                                        ("denoise_kernel", "denoise"))
                         if k in e.key), "other")
            out[name] = out.get(name, 0.0) + us / reps
    return out


def phase2_timing(torch, kern, cfg, r, s2, y2, sk2):
    """The main path's phase 2 once more through ``bamp.plane_loop`` on
    K5, from the gathered state ``s2``: its wall seconds per iteration
    (host clock, synchronized at the end) beside the device seconds per
    iteration spent inside the wrapper's calls (CUDA events around each
    call); the result must equal ``sk2``, the checked run's, bit for
    bit."""
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp
    events = []

    def timed_iteration(*args):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        res = kern.iteration(*args)
        stop.record()
        events.append((start, stop))
        return res

    torch.cuda.synchronize()
    t = time.perf_counter()
    st = bamp.plane_loop(timed_iteration, r.A, s2, y2, r.sigma2, MASSIVE_CAP,
                         cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    iters = len(events)
    same = torch.equal(st.T, sk2.T) and all(
        torch.equal(getattr(st, f), getattr(sk2, f)) for f in BAMP_FIELDS)
    if not same:
        raise AssertionError("phase 2 on K5 is not repeatable")
    kernel_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
    return dict(phase2_iterations=iters,
                phase2_wall_s_per_iteration=wall / max(iters, 1),
                phase2_kernel_s_per_iteration=kernel_s / max(iters, 1))


def iter_gap(k, p, active) -> dict:
    """The median and the largest |k - p| of each float plane of two
    :class:`IterOut` results (xmap on the trials in ``active`` only)."""
    out = {}
    for f in ("xmap_re", "xmap_im", "xm_re", "var", "z_re", "z_im", "u"):
        a, b = getattr(k, f), getattr(p, f)
        if f.startswith("xmap"):
            a, b = a[active], b[active]
        d = (a - b).abs().flatten().double()
        out[f"{f}_p50"] = float(d.median()) if d.numel() else 0.0
        out[f"{f}_max"] = float(d.max()) if d.numel() else 0.0
    return out


def k5_high_control(kern, op, cfg, s0, y, sigma2):
    """One iteration of K5's HIGH instance and, as the control, of its
    HIGHEST instance, against the plain HIGH step, from the state after
    ``K5_HIGH_PRESTEPS`` plain HIGH iterations from ``s0``.  Returns (the
    planes' gaps of both, the state stepped from)."""
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp
    ps = bamp.to_planes(kern.decode_plain(op, s0, y, sigma2,
                                          s0.t + K5_HIGH_PRESTEPS, cfg,
                                          "high"))
    y_re, y_im = y.real.contiguous(), y.imag.contiguous()
    one = kern.iteration_plain(op, ps, y_re, y_im, sigma2, cfg, "high")
    high = kern.iteration(op, ps, y_re, y_im, sigma2, cfg, "high")
    highest = kern.iteration(op, ps, y_re, y_im, sigma2, cfg)
    return (iter_gap(high, one, ps.active), iter_gap(highest, one, ps.active),
            ps)


def k5_high_split_check(kern, op, ps, y_re, y_im, sigma2, cfg,
                        x_var=None, precision="high") -> dict:
    """The split operand planes of K5's HIGH (or DEFAULT) form against
    their layout in plain PyTorch (``fused_bamp_tiled.split_tiles``), bit
    for bit: the split launch's x and var (or the given ``x_var``, the
    planes a denoiser wrote), and the fold's four adjoint inputs (Z_re +
    Z_im, Z_re, Z_im and Z_c = 1/u', with Z = (y - z') / u', gathered to
    the rows of the column blocks they act on; zero for a frozen trial)
    from the fold's own z' and u'."""
    import torch
    B, Lin, Nr, Lh = ps.var.shape[0], cfg.Lin, cfg.Nr, cfg.Lh
    tile = kern.HIGH_ROWS
    out, scratch, cov = kern._buffers(ps, cfg)
    split = kern._split_buffers(ps, cfg, x_var, precision)
    st = kern.STAGES
    kern._launch(op, ps, y_re, y_im, sigma2, cfg, out, scratch, cov,
                 (0 if x_var is not None else kern.SPLIT_STAGE)
                 | st["forward"] | st["fold"], precision, split)
    torch.cuda.synchronize()
    want_x = torch.cat([kern.split_tiles(t.reshape(B * Lin, cfg.Nt), tile,
                                         precision)
                        for t in (ps.xm_re, ps.var)])
    u = out.u.reshape(B, cfg.Lout, Nr)
    ui = 1.0 / u
    rr = (y_re.reshape(u.shape) - out.z_re.reshape(u.shape)) * ui
    ri = (y_im.reshape(u.shape) - out.z_im.reshape(u.shape)) * ui
    on = ps.active[:, None, None, None]
    planes = []
    for v in (rr + ri, rr, ri, ui):
        z = torch.stack([v[:, l:l + Lin] for l in range(Lh)], dim=2)
        z = torch.where(on, z, torch.zeros_like(z))
        planes.append(kern.split_tiles(z.reshape(B * Lin, Lh * Nr), tile,
                                       precision))
    rows = B * Lin
    rt = -(-rows // tile)

    def real_rows(buf, n):
        # the bits of the rows < B Lin of n planes (the fold leaves the pad
        # rows of the last tile as they are: no output reads them)
        steps = buf.numel() // (n * rt * tile * 32)
        v = buf.view(torch.int16).view(n, rt, steps, tile, 32)
        return v.transpose(2, 3).reshape(n, rt * tile, -1)[:, :rows]

    same = lambda a, b, n: bool(torch.equal(real_rows(a, n), real_rows(b, n)))
    return {"x_var": same(split[0], want_x, 2),
            "adjoint_inputs": same(split[1], torch.cat(planes), 4)}


def phase_kernels_tiled_high(torch, dev, ptxas):
    """The HIGH form of K5 (precision='high', bf16 x 3 on the tensor cores)
    against its plain HIGH version (``fused_bamp_tiled.decode_plain(...,
    'high')``), both through ``bamp.plane_loop``, under :func:`compare` with
    each shape's HIGH rule (``K5_HIGH_RULES``: T agreement, |d mean T|,
    the state within the tolerance on the converged trials whose T agrees),
    each shape with the control (``k5_high_control``: the median |d z_re|
    of the HIGH instance under ``K5_HIGH_CONTROL_TOL``, that of the HIGHEST
    instance over it).  The small geometries of ``kernels_tiled`` at 1024
    trials and a ragged batch of 37 (cap 30); the massive geometry at 512
    trials, 18 dB, cap 10, split at 5 and resumed (identical); the main
    path's 8 dB state at 2048 trials (every trial at the cap; to cap 10);
    the converging shape, 10 dB, 2048 trials, cap 100; the phase-2 shape
    (the trials still active after 40 HIGH iterations at 18 dB, gathered,
    to cap 300, |d mean T| within 2% of the cap).  Where a T rule holds,
    the HIGHEST instance is held to it too and printed; where the rule
    separates it (the fourth element of ``K5_HIGH_RULES``), it must fail.
    The split operand planes against their layout (the split launch's,
    the fold's, the denoiser's for the next call:
    ``k5_high_split_check``).  One iteration at the 8 dB state and at the
    phase-2 shape timed by CUDA events, as the plane loop runs it after
    its first iteration (on the split planes the previous call's denoiser
    wrote) and as a first iteration (with its own split), beside the
    HIGHEST instance, the plain HIGH step, the bound (21 bf16 products at
    989 TFLOP/s) and those products as torch.matmul calls (at both
    shapes); the five
    launches timed apart; shared memory per block against the wrapper's
    mirror; ptxas's lines."""
    import dataclasses

    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops import precision as prec
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_bamp_tiled as kern)
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    high = "high"
    failed = []
    t0 = time.perf_counter()

    def realization(cfg, B, seed, snr):
        r = montecarlo.generate_realization(make_generator(dev, seed), cfg,
                                            "sparc", "banded", B, snr, high)
        return r, bamp.initial_state(r.y, cfg.N, r.sigma2)

    def run(cfg, r, s0, cap, y=None, form="kernel"):
        y = r.y if y is None else y
        if form == "plain":
            return kern.decode_plain(r.A, s0, y, r.sigma2, cap, cfg, high)
        it = (partial(kern.iteration, precision=high) if form == "kernel"
              else kern.iteration)
        return bamp.plane_loop(it, r.A, s0, y, r.sigma2, cap, cfg)

    def control(phase, cfg, r, s0, y=None, **info):
        sound, wrong, ps = k5_high_control(kern, r.A, cfg, s0,
                                           r.y if y is None else y, r.sigma2)
        emit(phase, **info, statistic=K5_HIGH_CONTROL_STAT,
             limit=K5_HIGH_CONTROL_TOL, presteps=K5_HIGH_PRESTEPS,
             high=sound, highest=wrong)
        if not (sound[K5_HIGH_CONTROL_STAT] < K5_HIGH_CONTROL_TOL
                <= wrong[K5_HIGH_CONTROL_STAT]):
            failed.append(f"control {info}")
        return ps

    def check(phase, cfg, r, s0, cap, tol, rule=None, y=None,
              separates=False, free=True, **info):
        sk = run(cfg, r, s0, cap, y)
        sp = run(cfg, r, s0, cap, y, "plain")
        min_agree, max_dmean = rule or (0.995, 0.02)
        err = compare(phase, sk, sp, tol, free_unconverged=free,
                      min_agree=min_agree, max_dmean_T=max_dmean, cap=cap,
                      **info)
        if rule:
            sh = run(cfg, r, s0, cap, y, "highest")
            frac, dmean, inside = rule_passes(sh, sp, min_agree, max_dmean)
            emit(phase + "_highest", **info, T_agree_fraction=frac,
                 abs_dmean_T=dmean, inside_rule=inside, must_fail=separates)
            if separates and inside:
                failed.append(f"{info}: the HIGHEST instance passes the rule")
        return err, sk

    max_err = 0.0
    cases = [("ook_8_3", {}, SMALL_B), ("ook_12_5", dict(Lin=12, Lh=5),
                                        SMALL_B),
             ("bpsk_8_3", dict(alphabet="BPSK"), SMALL_B),
             ("ook_ragged_37", {}, 37)]
    for i, (name, kw, B) in enumerate(cases):
        cfg = tiled_small_config(**kw)
        r, s0 = realization(cfg, B, 400 + i, 10 ** 0.8)
        cap, *rule, separates = K5_HIGH_RULES[name]
        err, _ = check("kernel_small_tiled_high", cfg, r, s0, cap, 1e-4,
                       rule, separates=separates, case=name)
        max_err = max(max_err, err)
        control("kernel_small_tiled_high_control", cfg, r, s0, case=name)

    # the massive geometry at 512 trials, cap 10; split at 5 and resumed
    mcfg = dataclasses.replace(massive_main_config(),
                               iterations=MASSIVE_HIGH_CAP)
    r, s0 = realization(mcfg, 512, 41, snr_of(mcfg, MASSIVE_EBN0_DB))
    err, full = check("kernel_massive_tiled_high", mcfg, r, s0, 10, 1e-3,
                      free=False, ebn0_db=MASSIVE_EBN0_DB)
    max_err = max(max_err, err)
    resumed = run(mcfg, r, run(mcfg, r, s0, 5), 10)
    split_ok = (bool(torch.equal(full.T, resumed.T))
                and state_err(full, resumed, slice(None)) == 0.0)
    emit("kernel_split_resume_tiled_high", identical=split_ok)
    if not split_ok:
        failed.append("split-and-resume")
    control("kernel_massive_tiled_high_control", mcfg, r, s0,
            ebn0_db=MASSIVE_EBN0_DB)
    del r, s0, full, resumed

    # the converging shape: 10 dB, 2048 trials, cap 100
    r, s0 = realization(mcfg, MASSIVE_RES, 44,
                        snr_of(mcfg, MASSIVE_CONVERGING_DB))
    cap, *rule, separates = K5_HIGH_RULES["massive_10db"]
    err, _ = check("kernel_converging_tiled_high", mcfg, r, s0, cap, 1e-3,
                   rule, separates=separates, ebn0_db=MASSIVE_CONVERGING_DB)
    max_err = max(max_err, err)
    control("kernel_converging_tiled_high_control", mcfg, r, s0,
            ebn0_db=MASSIVE_CONVERGING_DB)
    del r, s0
    torch.cuda.empty_cache()

    # the phase-2 shape: the trials still active after 40 HIGH iterations
    # at 18 dB, gathered, to cap 300
    pcfg = massive_main_config()
    r, s0 = realization(pcfg, MASSIVE_RES, 43, snr_of(pcfg, MASSIVE_EBN0_DB))
    s1 = run(pcfg, r, s0, MASSIVE_K1)
    idx = torch.nonzero(s1.active).flatten()
    if not idx.numel():
        raise AssertionError("no trial left for phase 2 (tiled, HIGH)")
    s2, y2 = montecarlo.state_take_trials(s1, idx), r.y[idx]
    n2 = int(idx.numel())
    err, _ = check("kernel_phase2_tiled_high", pcfg, r, s2, MASSIVE_CAP,
                   1e-3, (0.0, 0.02 * MASSIVE_CAP), y=y2, phase2_B=n2)
    max_err = max(max_err, err)
    ps2 = control("kernel_phase2_tiled_high_control", pcfg, r, s2, y=y2,
                  phase2_B=n2)
    del s0, s1

    # the main path's shape: the 8 dB state at 2048 trials
    r, s0 = realization(mcfg, MASSIVE_RES, 45, snr_of(mcfg, MASSIVE_HIGH_DB))
    err, _ = check("kernel_main_tiled_high", mcfg, r, s0, 10, 1e-3,
                   free=False, ebn0_db=MASSIVE_HIGH_DB)
    max_err = max(max_err, err)
    ps = control("kernel_main_tiled_high_control", mcfg, r, s0,
                 ebn0_db=MASSIVE_HIGH_DB)

    # one iteration at B = 2048 (the 8 dB state) and at the phase-2 shape
    A, B, W = r.A, MASSIVE_RES, mcfg.Lh * mcfg.Nr
    y_re, y_im = r.y.real.contiguous(), r.y.imag.contiguous()
    split = k5_high_split_check(kern, A, ps, y_re, y_im, r.sigma2, mcfg)
    # the call that splits x and var itself (a decode's first iteration, or
    # the first after a gather), then the plane loop's next state, whose
    # call takes the split planes its predecessor's denoiser wrote
    out = {}
    one = lambda p: out.update(k=kern.iteration(A, ps, y_re, y_im, r.sigma2,
                                                mcfg, p))
    ms_split = cuda_ms(lambda: one(high), 2, 10)
    ps = bamp.advance(ps, out["k"])
    one(high)
    kept = kern.kept_split(ps)
    split["kept_x_var"] = kept is not None and k5_high_split_check(
        kern, A, ps, y_re, y_im, r.sigma2, mcfg, kept)["x_var"]
    emit("kernel_split_tiled_high", **split)
    if not all(split.values()):
        failed.append(f"split operand planes: {split}")
    ms = cuda_ms(lambda: one(high), 2, 10)
    highest_ms = cuda_ms(lambda: one("highest"), 2, 10)
    ms_again = cuda_ms(lambda: one(high), 2, 10)
    plain_ms = cuda_ms(lambda: kern.iteration_plain(
        A, ps, y_re, y_im, r.sigma2, mcfg, high), 1, 3)
    # the library's yardstick: the 21 bf16 products of one iteration (7
    # Gauss products x 3 passes) as torch.matmul calls
    t = bamp.gauss_taps(A)
    fwd = [prec.split_bf16(x) for x in (t.s_a2, t.s_re, t.dmc)]
    adj = [prec.split_bf16(x) for x in (t.st_a2, t.st_re, t.amc, t.adm)]
    def gauss_bf16(var, trials):
        xs = prec.split_bf16(var.reshape(trials * mcfg.Lin, mcfg.Nt))
        zs = prec.split_bf16(torch.rand(trials * mcfg.Lin, W, device=dev))

        def run():
            for (xh, xl), planes in ((xs, fwd), (zs, adj)):
                for th, tl in planes:
                    torch.matmul(xh, th)
                    torch.matmul(xh, tl)
                    torch.matmul(xl, th)
        return run

    library_ms = cuda_ms(gauss_bf16(ps.var, B), 1, 5)
    k = out["k"]
    taps = kern.high_taps(A)
    planes = [ps.xm_re, ps.var, ps.z_re, ps.z_im, ps.u, y_re, y_im,
              ps.active, taps, k.xmap_re, k.xmap_im, k.xm_re, k.var, k.z_re,
              k.z_im, k.u, k.notok]
    flop, nbytes = iteration_work(mcfg, B, 21, planes)
    bound_ms, bound_by = bound(flop, nbytes, PEAK_BF16_FLOPS)
    stage = kern.stage_ms(A, ps, y_re, y_im, r.sigma2, mcfg, precision=high)
    y2_re, y2_im = y2.real.contiguous(), y2.imag.contiguous()
    tail = lambda p: out.update(t=kern.iteration(A, ps2, y2_re, y2_im,
                                                 r.sigma2, pcfg, p))
    tail_ms_split = cuda_ms(lambda: tail(high), 2, 20)
    ps2 = bamp.advance(ps2, out["t"])
    tail(high)
    tail_ms = cuda_ms(lambda: tail(high), 2, 20)
    tail_highest_ms = cuda_ms(lambda: tail("highest"), 2, 20)
    tail_library_ms = cuda_ms(gauss_bf16(ps2.var, n2), 2, 20)
    kt = out["t"]
    tail_flop, tail_bytes = iteration_work(
        pcfg, n2, 21, [ps2.xm_re, ps2.var, ps2.z_re, ps2.z_im, ps2.u, y2_re,
                       y2_im, ps2.active, taps,
                       *[getattr(kt, f) for f in kt._fields]])
    tail_bound_ms, tail_bound_by = bound(tail_flop, tail_bytes,
                                         PEAK_BF16_FLOPS)
    lib = kern._library()
    smem = {f"{name}_{form}": (lib.fused_bamp_tiled_smem(fwd_, small, 1),
                               kern.smem_bytes(bool(fwd_), bool(small), high))
            for name, fwd_ in (("forward", 1), ("adjoint", 0))
            for form, small in (("large", 0), ("small", 1))}
    timing = dict(kernel="fused_bamp_tiled_high", B=B,
                  ebn0_db=MASSIVE_HIGH_DB, ms=ms, ms_again=ms_again,
                  ms_with_split=ms_split,
                  highest_ms=highest_ms, high_over_highest=ms / highest_ms,
                  plain_ms=plain_ms, library_ms=library_ms, flop=flop,
                  bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
                  pct_of_bound=100 * bound_ms / ms,
                  achieved_tflops=flop / (ms * 1e-3) / 1e12,
                  us_per_trial_iteration=1e3 * ms / B, stage_ms=stage,
                  tail_B=n2, tail_ms=tail_ms,
                  tail_ms_with_split=tail_ms_split,
                  tail_highest_ms=tail_highest_ms,
                  tail_library_ms=tail_library_ms,
                  tail_bound_ms=tail_bound_ms, tail_bound_by=tail_bound_by,
                  tail_pct_of_bound=100 * tail_bound_ms / tail_ms,
                  tail_stage_ms=kern.stage_ms(A, ps2, y2_re, y2_im, r.sigma2,
                                              pcfg, precision=high),
                  tail_forms=kern.tile_forms(n2, pcfg.Lin, W, pcfg.Nt, high),
                  smem_bytes=smem, ptxas=list(ptxas),
                  seconds=time.perf_counter() - t0)
    emit("kernel_timing_tiled_high", **timing)
    if any(c != p for c, p in smem.values()):
        failed.append(f"shared memory differs from the wrapper's: {smem}")
    if failed:
        raise AssertionError(f"K5 HIGH kernel != plain: {failed}")
    return max_err, timing


def phase_main_massive_high(torch, dev):
    """``Simulator(massive_mimo(), algo='bamp', precision='high')`` beside
    ``precision='highest'`` on the same seeds at Eb/N0 = 8 dB, cap 100,
    single phase (every trial runs to the cap: the regime 'auto' picks HIGH
    for), 2 realizations of 2048 each.  Gates: the HIGH run through K5's
    HIGH instance alone (``launches_high`` = the iterations the plane loop
    ran, no HIGHEST launch of K5, no other kernel, no plain decode), FER
    within 3 sigma (binomial, HIGHEST's count, at least one error), BER
    within 3 sigma (sigma of the difference of two runs' means, from the BER
    scatter of ``BAMP_HIGH_BER_GROUPS`` groups of one HIGH realization's
    trials), mean T within 1.0; then ``Simulator(precision='auto')``, whose
    first point runs HIGHEST and, its mean T pinned at the cap, whose next
    point runs K5's HIGH instance alone.  Prints both runs' trials/s and a
    per-layer breakdown of one HIGH realization."""
    import dataclasses

    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_bamp, fused_bamp_iteration as fbi, fused_bamp_tiled)
    from amp_sparc_spatialmodulation_tpu_torch.utils import metrics
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    cfg = dataclasses.replace(massive_main_config(),
                              iterations=MASSIVE_HIGH_CAP)
    n_real, res = MASSIVE_HIGH_REALIZATIONS, MASSIVE_RES
    epochs = n_real * res

    def counts():
        return dict(launches=fused_bamp_tiled.launches,
                    launches_high=fused_bamp_tiled.launches_high,
                    others=(fused_bamp.launches + fused_bamp.launches_high
                            + fbi.fused_launches),
                    plain=bamp.plain_decodes)

    def zero():
        fused_bamp_tiled.launches = fused_bamp_tiled.launches_high = 0
        fused_bamp.launches = fused_bamp.launches_high = 0
        fbi.fused_launches = 0
        bamp.plain_decodes = 0

    runs = {}
    for precision in ("highest", "high"):
        sim = montecarlo.Simulator(cfg, algo="bamp", device=dev,
                                   precision=precision,
                                   progress=lambda s: None)
        torch.cuda.synchronize()
        zero()
        t0 = time.perf_counter()
        avg = sim.run_point(MASSIVE_HIGH_DB, epochs=epochs, res=res)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs[precision] = dict(avg=avg, seconds=seconds,
                               trials_per_s=epochs / seconds, **counts())
    hi, hs = runs["high"], runs["highest"]

    # 'auto': HIGHEST on the first point, HIGH after its pinned mean T
    auto = montecarlo.Simulator(cfg, algo="bamp", device=dev,
                                precision="auto", progress=lambda s: None)
    zero()
    first = auto.run_point(MASSIVE_HIGH_DB, epochs=res, res=res)
    auto_first = counts()
    zero()
    second = auto.run_point(MASSIVE_HIGH_DB, epochs=res, res=res)
    auto_second = counts()

    gen = make_generator(dev, 12345)
    layers = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        layers[name] = time.perf_counter() - t
        return out

    r = timed("generate_s", lambda: montecarlo.generate_realization(
        gen, cfg, "sparc", "banded", res, snr_of(cfg, MASSIVE_HIGH_DB),
        "high"))
    out = timed("decode_s", lambda: bamp.decode(r.A, r.y, r.sigma2, cfg,
                                                precision="high"))
    timed("metrics_s", lambda: metrics.fetch_sums(metrics.evaluate_sums(
        out.xmap, out.xmmse, r.msg, out.T, cfg)))
    bsig = ber_sigma(torch, cfg, out, r.msg, res, epochs)
    del r, out

    sigma = fer_sigma(hs["avg"]["fer"], epochs)
    # the plane loop runs to the slowest trial: the cap when mean T is
    iters = (n_real * cfg.N_Layers if hi["avg"]["T"] == cfg.N_Layers
             else None)
    emit("main_massive_high", config="massive_mimo", ebn0_db=MASSIVE_HIGH_DB,
         res=res, realizations=n_real, trials=epochs, cap=cfg.N_Layers,
         **{f"{p}_{k}": v for p, run in runs.items()
            for k, v in (("seconds", run["seconds"]),
                         ("trials_per_s", run["trials_per_s"]),
                         ("mean_T", run["avg"]["T"]),
                         ("fer", run["avg"]["fer"]),
                         ("ber", run["avg"]["ber"]),
                         ("launches", run["launches"]),
                         ("launches_high", run["launches_high"]),
                         ("other_kernel_launches", run["others"]),
                         ("plain_decodes", run["plain"]))},
         high_over_highest_trials_per_s=(hi["trials_per_s"]
                                         / hs["trials_per_s"]),
         iterations_run=iters, fer_sigma=sigma, ber_sigma=bsig,
         auto_first_mean_T=first["T"], auto_first=auto_first,
         auto_second_mean_T=second["T"], auto_second=auto_second,
         layers_high=layers,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if (hi["launches_high"] <= 0 or hi["launches"] or hi["others"]
            or hi["plain"]
            or (iters is not None and hi["launches_high"] != iters)
            or hi["launches_high"] < n_real * hi["avg"]["T"]):
        raise AssertionError("the massive HIGH path did not run through "
                             "K5's HIGH instance alone")
    if abs(hi["avg"]["fer"] - hs["avg"]["fer"]) > 3 * sigma:
        raise AssertionError(f"massive HIGH FER {hi['avg']['fer']} vs "
                             f"HIGHEST {hs['avg']['fer']}")
    if abs(hi["avg"]["ber"] - hs["avg"]["ber"]) > 3 * bsig:
        raise AssertionError(f"massive HIGH BER {hi['avg']['ber']} vs "
                             f"HIGHEST {hs['avg']['ber']}")
    if abs(hi["avg"]["T"] - hs["avg"]["T"]) > 1.0:
        raise AssertionError(f"massive HIGH mean T {hi['avg']['T']} vs "
                             f"HIGHEST {hs['avg']['T']}")
    if (first["T"] != cfg.N_Layers or auto_first["launches_high"]
            or auto_first["launches"] <= 0 or auto_second["launches"]
            or auto_second["launches_high"] <= 0 or auto_second["plain"]):
        raise AssertionError("'auto' did not take K5's HIGH instance after "
                             "a pinned point")
    return hi["launches_high"]


def linear_decode(op, s, y, sigma2, cap, cfg):
    """The plain loop with its linear half run by K7's wrapper: the JAX
    loop body with a linear-only per-iteration kernel (`bamp.py:333-355` of
    the JAX package), K7's only path."""
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_bamp_iteration as fbi)
    den = bamp.make_denoiser(cfg, y.device)
    linear = partial(fbi.iteration_linear, cfg=cfg)
    while s.t < cap and bool(s.active.any()):
        s, _ = bamp.step(op, s, y, sigma2, den, linear)
    return s


def phase_kernels_periter(torch, dev, ptxas):
    """K6 and K7 against their plain versions.  K6 through the plane loop
    on the OOK small geometries with tail, trunc and cyclic truncation at
    1024 trials and on the flagship geometry at 4096 trials (with the share
    of trials whose T equals K1's), then its path: ``bamp.decode`` with
    ``AMP_PALLAS_MODE=periter``.  K7 for one iteration from a mid-decode
    state on the QPSK and 8PSK small geometries and the flagship geometry
    (outputs within 1e-4), then its path: the 8PSK decode with K7 running
    the linear half, against the plain loop.  Both timed at the flagship
    main path's shape (65536 trials), K6 also at the periter path's tail
    shape (65536 trials, 1% active); ``ptxas`` is the build's register and
    spill report."""
    import os

    from amp_sparc_spatialmodulation_tpu_torch.config import (
        Config, flagship_bamp_ook)
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_bamp, fused_bamp_iteration as fbi)
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    def realization(cfg, B, seed, snr):
        r = montecarlo.generate_realization(make_generator(dev, seed), cfg,
                                            "sparc", "banded", B, snr)
        return r, bamp.initial_state(r.y, cfg.N, r.sigma2)

    def k6(cfg, r, s0, cap):
        return bamp.plane_loop(fbi.iteration_fused, r.A, s0, r.y, r.sigma2,
                               cap, cfg)

    t0 = time.perf_counter()
    small = dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, mode="segmented",
                 profile="uniform")
    max6 = 0.0
    for i, trunc in enumerate(("tail", "trunc", "cyclic")):
        cfg = Config(**small, alphabet="OOK", trunc=trunc, iterations=12)
        r, s0 = realization(cfg, SMALL_B, 500 + i, 10 ** 1.2)
        sk = k6(cfg, r, s0, cfg.N_Layers)
        sp = fbi.decode_plain(r.A, s0, r.y, r.sigma2, cfg.N_Layers, cfg)
        torch.cuda.synchronize()
        max6 = max(max6, compare("kernel_small_periter", sk, sp, 1e-4,
                                 case=f"ook_{trunc}"))
    fcfg = flagship_bamp_ook()
    snr = snr_of(fcfg, EBN0_DB)
    r, s0 = realization(fcfg, FLAGSHIP_B, 51, snr)
    sk = k6(fcfg, r, s0, fcfg.N_Layers)
    sp = fbi.decode_plain(r.A, s0, r.y, r.sigma2, fcfg.N_Layers, fcfg)
    k1 = fused_bamp.whole_decode(r.A, s0, r.y, r.sigma2, fcfg.N_Layers, fcfg)
    max6 = max(max6, compare(
        "kernel_flagship_periter", sk, sp, 1e-3,
        T_same_as_k1_fraction=float((sk.T == k1.T).float().mean()),
        mean_T_k1=float(k1.T.float().mean())))

    # K6's path: the flagship decode routed to K6
    mode = os.environ.get("AMP_PALLAS_MODE")
    os.environ["AMP_PALLAS_MODE"] = "periter"
    try:
        if bamp.route(fcfg, r.A, FLAGSHIP_B, dev) != "periter":
            raise AssertionError("periter mode did not route to K6")
        torch.cuda.synchronize()
        fbi.fused_launches = 0
        path = bamp.decode(r.A, r.y, r.sigma2, fcfg)
        torch.cuda.synchronize()
        launches6 = fbi.fused_launches
    finally:
        if mode is None:
            del os.environ["AMP_PALLAS_MODE"]
        else:
            os.environ["AMP_PALLAS_MODE"] = mode
    if launches6 <= 0 or not torch.equal(path.T, sk.T):
        raise AssertionError("the periter route did not run K6")

    # K7: one iteration from the state after 2 plain iterations
    max7 = 0.0
    geoms = [("qpsk", Config(**small, alphabet="QPSK", trunc="tail",
                             iterations=8), 10 ** 1.5, SMALL_B),
             ("8psk", Config(**small, alphabet="8PSK", trunc="tail",
                             iterations=10), 10 ** 1.6, SMALL_B),
             ("flagship", fcfg, snr, FLAGSHIP_B)]
    for i, (name, cfg, sn, B) in enumerate(geoms):
        r, s0 = realization(cfg, B, 520 + i, sn)
        st = bamp.plain_loop(r.A, s0, r.y, r.sigma2, 2, cfg)
        got = fbi.iteration_linear(r.A, st.xmmse, st.var, st.z, st.u, r.y,
                                   r.sigma2, cfg)
        want = fbi.linear_plain(r.A, st.xmmse, st.var, st.z, st.u, r.y,
                                r.sigma2, cfg)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        emit("kernel_step_linear", case=name, B=B, max_abs_err=err,
             tolerance=1e-4, bit_exact=exact)
        if not err < 1e-4:
            raise AssertionError(f"K7 != plain on {name}: {err}")
        max7 = max(max7, err)
    # K7's path: the 8PSK decode with K7 as the linear half
    cfg = geoms[1][1]
    r, s0 = realization(cfg, SMALL_B, 530, 10 ** 1.6)
    torch.cuda.synchronize()
    fbi.linear_launches = 0
    sk = linear_decode(r.A, s0, r.y, r.sigma2, cfg.N_Layers, cfg)
    torch.cuda.synchronize()
    launches7 = fbi.linear_launches
    sp = bamp.plain_loop(r.A, s0, r.y, r.sigma2, cfg.N_Layers, cfg)
    max7 = max(max7, compare("kernel_path_linear", sk, sp, 1e-4,
                             case="8psk"))

    # times at the flagship main path's shape
    r, s0 = realization(fcfg, RES, 53, snr)
    st = bamp.plain_loop(r.A, s0, r.y, r.sigma2, 2, fcfg)
    ps = bamp.to_planes(st)
    y_re, y_im = r.y.real.contiguous(), r.y.imag.contiguous()
    out = {}
    run6 = lambda: out.update(k=fbi.iteration_fused(
        r.A, ps, y_re, y_im, r.sigma2, fcfg))
    run7 = lambda: out.update(l=fbi.iteration_linear(
        r.A, st.xmmse, st.var, st.z, st.u, r.y, r.sigma2, fcfg))
    torch.cuda.empty_cache()
    ms7 = cuda_ms(run7, 2, 10)
    ms6 = cuda_ms(run6, 2, 10)
    ms7b = cuda_ms(run7, 2, 10)
    ms6b = cuda_ms(run6, 2, 10)
    reserved = torch.cuda.memory_reserved() / 2 ** 30
    plain6 = cuda_ms(lambda: fbi.iteration_fused_plain(
        r.A, ps, y_re, y_im, r.sigma2, fcfg), 1, 5)
    plain7 = cuda_ms(lambda: fbi.linear_plain(
        r.A, st.xmmse, st.var, st.z, st.u, r.y, r.sigma2, fcfg), 1, 5)
    emit("kernel_timing_periter_turns", k7_ms=[ms7, ms7b], k6_ms=[ms6, ms6b],
         reserved_gib=reserved)
    A = r.A
    lib = {"forward_complex": cuda_ms(
               lambda: st.xmmse.reshape(-1, fcfg.Nt) @ A.h_stack, 2, 10),
           "forward_abs2": cuda_ms(
               lambda: st.var.reshape(-1, fcfg.Nt) @ A.abs_h2_stack, 2, 10)}
    zc = torch.complex(torch.rand(RES * fcfg.Lin, fcfg.Lh * fcfg.Nr,
                                  device=dev),
                       torch.rand(RES * fcfg.Lin, fcfg.Lh * fcfg.Nr,
                                  device=dev))
    lib["adjoint_complex"] = cuda_ms(lambda: zc @ A.h_stack.conj().T, 2, 10)
    lib["adjoint_abs2"] = cuda_ms(lambda: zc.real @ A.abs_h2_stack.T, 2, 10)
    library_ms = sum(lib.values())
    k, lo = out["k"], out["l"]
    common = [ps.xm_re, ps.xm_im, ps.var, ps.z_re, ps.z_im, ps.u, y_re,
              y_im, A.h, A.h, A.abs_h2, A.abs_h2, A.gains, A.gains2]
    # real products per iteration for a complex x: |H|^2 var, H x (4),
    # |H|^2^T (1/u), H^H r (4)
    flop, nbytes6 = iteration_work(fcfg, RES, 10, common + [ps.active] + [
        getattr(k, f) for f in k._fields])
    _, nbytes7 = iteration_work(fcfg, RES, 10, common + list(lo))
    b6, by6 = bound(flop, nbytes6)
    b7, by7 = bound(flop, nbytes7)
    timing6 = dict(kernel="fused_bamp_iteration_fused", B=RES, ms=ms6,
                   plain_ms=plain6, library_ms=library_ms,
                   library_ms_by_product=lib, flop=flop, bytes=nbytes6,
                   bound_ms=b6, bound_by=by6, pct_of_bound=100 * b6 / ms6,
                   achieved_tflops=flop / (ms6 * 1e-3) / 1e12,
                   **periter_tail(torch, fcfg, r, ps, y_re, y_im))
    timing7 = dict(kernel="fused_bamp_iteration_linear", B=RES, ms=ms7,
                   plain_ms=plain7, library_ms=library_ms, flop=flop,
                   bytes=nbytes7, bound_ms=b7, bound_by=by7,
                   pct_of_bound=100 * b7 / ms7,
                   achieved_tflops=flop / (ms7 * 1e-3) / 1e12)
    emit("kernel_timing_periter", fused=timing6, linear=timing7,
         smem_bytes=fbi.smem_bytes(fcfg), ptxas=list(ptxas),
         seconds=time.perf_counter() - t0)
    return (max6, timing6, launches6), (max7, timing7, launches7)


def periter_tail(torch, cfg, r, ps, y_re, y_im):
    """K6 at the periter path's tail shape: the trials of ``ps`` with one in
    100 active and the rest frozen, timed by CUDA events beside its bound
    and its plain version's time, and held against that version (every
    plane within 1e-3, xmap on the active trials: K6 writes no frozen
    trial's xmap).  Returns the ``tail_*`` fields of K6's timing line."""
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_bamp_iteration as fbi)
    act = torch.zeros_like(ps.active)
    act[::100] = True
    ps = ps._replace(active=act & ps.active)
    out = {}
    ms = cuda_ms(lambda: out.update(k=fbi.iteration_fused(
        r.A, ps, y_re, y_im, r.sigma2, cfg)), 2, 10)
    plain_ms = cuda_ms(lambda: out.update(p=fbi.iteration_fused_plain(
        r.A, ps, y_re, y_im, r.sigma2, cfg)), 1, 3)
    k, p = out["k"], out["p"]
    rows = ps.active
    err, exact = 0.0, True
    for f in k._fields:
        a, b = getattr(k, f), getattr(p, f)
        if f.startswith("xmap"):
            a, b = a[rows], b[rows]
        err = max(err, float((a - b).abs().max()))
        exact = exact and bool(torch.equal(a, b))
    active = int(rows.sum())
    frozen = ps.active.numel() - active
    # an active trial reads 3 x-side and 5 y-side planes and writes 5 and
    # 3; a frozen one reads and writes 3 of each; act and notok; the taps
    x_b, y_b = 4 * cfg.N, 4 * cfg.n
    taps = [r.A.h, r.A.h, r.A.abs_h2, r.A.abs_h2, r.A.gains, r.A.gains2]
    nbytes = (active * (8 * x_b + 8 * y_b) + frozen * (6 * x_b + 6 * y_b)
              + 8 * ps.active.numel()
              + sum(t.numel() * t.element_size() for t in taps))
    flop = iteration_work(cfg, active, 10, [])[0]
    bound_ms, bound_by = bound(flop, nbytes)
    if not err < 1e-3:
        raise AssertionError(f"K6 != plain at the tail shape: {err}")
    return dict(tail_active=active, tail_ms=ms, tail_plain_ms=plain_ms,
                tail_bound_ms=bound_ms, tail_bound_by=bound_by,
                tail_max_abs_err=err, tail_bit_exact=exact)


def phase_main_massive(torch, dev):
    """The massive-MIMO main path: ``Simulator(algo='bamp', two_phase=40)``
    at ``massive_main_config()``, Eb/N0 = 18 dB, over 8 realizations of 2048
    trials (scripts/bench_massive.py:37-42), one ``run_point`` per
    realization so that the realization scatter is printed; both phases
    must run K5 with no plain decode.  Then a per-layer breakdown of one
    more realization.  Gates against the JAX package's XLA decode on the CPU
    at this point (tests/torch_massive_reference.py): mean T within 3
    standard errors of the two runs' realization scatter, FER under the
    4 sigma + 8% + 2e-4 rule of tests/test_golden_artifacts.py:140-141."""
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_bamp, fused_bamp_iteration as fbi, fused_bamp_tiled)
    from amp_sparc_spatialmodulation_tpu_torch.utils import metrics
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    cfg = massive_main_config()
    sim = montecarlo.Simulator(cfg, algo="bamp", two_phase=MASSIVE_K1,
                               device=dev, progress=lambda s: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_bamp_tiled.launches = 0
    fused_bamp.launches = 0
    fbi.fused_launches = 0
    bamp.plain_decodes = 0
    t0 = time.perf_counter()
    per = [sim.run_point(MASSIVE_EBN0_DB, epochs=MASSIVE_RES,
                         res=MASSIVE_RES, snr_idx=i)
           for i in range(MASSIVE_REALIZATIONS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, plain = fused_bamp_tiled.launches, bamp.plain_decodes
    others = fused_bamp.launches + fbi.fused_launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trials = MASSIVE_REALIZATIONS * MASSIVE_RES
    avg = {k: statistics.fmean(p[k] for p in per) for k in ("fer", "ber",
                                                             "T")}
    Ts = [p["T"] for p in per]

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
        gen, cfg, "sparc", "banded", MASSIVE_RES,
        snr_of(cfg, MASSIVE_EBN0_DB)))
    _, st = timed("decode_phase1_s", lambda: bamp.decode(
        r.A, r.y, r.sigma2, cfg, iter_cap=MASSIVE_K1, return_state=True))
    idx = torch.nonzero(st.active).flatten()
    _, sub = timed("decode_phase2_s", lambda: bamp.decode(
        r.A, r.y[idx], r.sigma2, cfg,
        state0=montecarlo.state_take_trials(st, idx), return_state=True))
    st = montecarlo.state_merge_trials(st, sub, idx)
    timed("metrics_s", lambda: metrics.fetch_sums(metrics.evaluate_sums(
        st.xmap, st.xmmse, r.msg, st.T, cfg)))

    ref = MASSIVE_REF
    sd_T = statistics.stdev(Ts)
    T_bound = 3 * math.sqrt(sd_T ** 2 / MASSIVE_REALIZATIONS
                            + ref["T_sd"] ** 2 / ref["realizations"])
    pf = min(max(ref["fer"], 1e-9), 1 - 1e-9)
    fer_bound = (4 * math.sqrt(pf * (1 - pf) * (1 / ref["trials"]
                                                + 1 / trials))
                 + 0.08 * ref["fer"] + 2e-4)
    emit("main_massive", config="massive_mimo", cap=MASSIVE_CAP,
         ebn0_db=MASSIVE_EBN0_DB, res=MASSIVE_RES,
         realizations=MASSIVE_REALIZATIONS, trials=trials,
         two_phase_k1=MASSIVE_K1, seconds=seconds,
         trials_per_s=trials / seconds, mean_T=avg["T"], fer=avg["fer"],
         ber=avg["ber"], realization_mean_T=Ts, realization_mean_T_sd=sd_T,
         mean_T_stderr=sd_T / math.sqrt(MASSIVE_REALIZATIONS),
         realization_fer=[p["fer"] for p in per], k5_launches=launches,
         other_kernel_launches=others, plain_decodes=plain,
         phase2_bucket=int(idx.numel()), layers=layers, peak_mem_gib=peak,
         ref=ref, T_bound=T_bound, fer_bound=fer_bound)
    if launches <= 0 or plain != 0 or others != 0:
        raise AssertionError("the massive main path did not run through K5")
    if abs(avg["T"] - ref["T"]) > T_bound:
        raise AssertionError(f"massive mean T {avg['T']} vs {ref['T']}")
    if abs(avg["fer"] - ref["fer"]) > fer_bound:
        raise AssertionError(f"massive FER {avg['fer']} vs {ref['fer']}")
    return launches


# main_auto_k1: the flagship BAMP OOK point of a sweep that reaches 8 dB
# from 7 dB under two_phase='auto' (the published 7 dB point has mean T
# 25.3, Simulations/BAMPfinal/OOK,segmented/.../7.0.json), 8 realizations
# of 65536 per point.
AUTO_K1_DB = (7.0, 8.0)
AUTO_K1_REALIZATIONS = 8
# main_plain: use_pallas=False beside 'auto' on the same seeds, at the BAMP
# main point (16 realizations) and the SCAMP main point (8).
PLAIN_BAMP_REALIZATIONS = 16
PLAIN_SCAMP_REALIZATIONS = 8
# main_plain_high: the plain BAMP loop at HIGH beside K1-high at
# main_bamp_high's point, cut from 65536 to 4096 trials a realization (the
# plain HIGH loop takes about 9x K1-high's time); then SCAMP at the 8PSK
# sweep geometry and cap of reference_scamp_8psk_golden.json (Nt=480,
# Na=30, Nr=57, Lin=32, Lh=6, cap 200), which K2 does not fit, at 7 dB
# (published FER 0.756, T 68.6), HIGH beside HIGHEST, both the plain loop,
# cut to one realization of 4096 a form: at HIGH nearly every trial runs
# to the cap (mean T 194.9 against HIGHEST's 80.5), and two realizations
# took 38 s of the sweep-engine phases' 70 (PERF.md, section 4).
PLAIN_HIGH_RES = 4096
PLAIN_HIGH_REALIZATIONS = 2
SCAMP_8PSK_DB = 7.0
SCAMP_8PSK_REALIZATIONS = 1


def scamp_8psk_config():
    from amp_sparc_spatialmodulation_tpu_torch.config import Config
    return Config(Nt=480, Na=30, Nr=57, Lin=32, Lh=6, mode="sparc",
                  alphabet="8PSK", profile="uniform", trunc="tail",
                  iterations=200)


def run_counted(torch, sim, ebn0_db, epochs, res, counters, snr_idx=0):
    """``sim.run_point`` with every counter of ``counters`` (module,
    attribute names) set to 0 just before it and read just after:
    (averages, seconds, {attribute: count})."""
    for mod, names in counters:
        for n in names:
            setattr(mod, n, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avg = sim.run_point(ebn0_db, epochs=epochs, res=res, snr_idx=snr_idx)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return avg, seconds, {n: getattr(mod, n) for mod, names in counters
                          for n in names}


def phase_main_auto_k1(torch, dev):
    """``Simulator(flagship_bamp_ook(), two_phase='auto')`` at 7 and 8 dB,
    ``AUTO_K1_REALIZATIONS`` realizations of 65536 each: each point's probe
    mean T (2048 trials, through K1), the k1 it picked and the k1 the
    previous point's mean T would have picked; then the 8 dB point again at
    a fixed k1 equal to the probe's and under ``AMP_AUTO_PROBE=0`` (k1 from
    the 7 dB point's mean T), both on the same seeds.  Gates: K1 alone in
    every run (no plain decode), and FER, BER and mean T identical in the
    three 8 dB runs (metric sums do not depend on k1: K1's split and resume
    are exact).  Trials/s of every run printed, none gated."""
    import os

    from amp_sparc_spatialmodulation_tpu_torch.config import flagship_bamp_ook
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp

    cfg = flagship_bamp_ook()
    epochs = AUTO_K1_REALIZATIONS * RES
    counters = [(fused_bamp, ("launches",)), (bamp, ("plain_decodes",))]

    def simulator(two_phase):
        return montecarlo.Simulator(cfg, algo="bamp", two_phase=two_phase,
                                    device=dev, progress=lambda s: None)

    sim = simulator("auto")
    points, runs = [], []
    for i, ebn0 in enumerate(AUTO_K1_DB):
        previous_rule = montecarlo.auto_k1(sim._last_meanT, cfg.N_Layers)
        avg, seconds, n = run_counted(torch, sim, ebn0, epochs, RES,
                                      counters, snr_idx=i)
        points.append(dict(
            ebn0_db=ebn0, probe_mean_T=sim.probe_meanT, k1=sim.k1,
            k1_previous_point_rule=previous_rule, seconds=seconds,
            trials_per_s=epochs / seconds, mean_T=avg["T"], fer=avg["fer"],
            ber=avg["ber"], k1_launches=n["launches"],
            plain_decodes=n["plain_decodes"]))
        runs.append(n)
    probe_k1 = sim.k1
    fixed = simulator(probe_k1)
    avg_fixed, sec_fixed, n = run_counted(torch, fixed, AUTO_K1_DB[1], epochs,
                                          RES, counters, snr_idx=1)
    runs.append(n)
    off = simulator("auto")
    off._last_meanT = points[0]["mean_T"]
    old = os.environ.get("AMP_AUTO_PROBE")
    os.environ["AMP_AUTO_PROBE"] = "0"
    try:
        avg_off, sec_off, n = run_counted(torch, off, AUTO_K1_DB[1], epochs,
                                          RES, counters, snr_idx=1)
    finally:
        if old is None:
            del os.environ["AMP_AUTO_PROBE"]
        else:
            os.environ["AMP_AUTO_PROBE"] = old
    runs.append(n)
    last = points[1]
    same = {k: last[k] == avg_fixed[a] == avg_off[a]
            for k, a in (("fer", "fer"), ("ber", "ber"), ("mean_T", "T"))}
    emit("main_auto_k1", config="flagship_bamp_ook", res=RES,
         realizations=AUTO_K1_REALIZATIONS, points=points,
         fixed_k1=probe_k1, fixed_seconds=sec_fixed,
         fixed_trials_per_s=epochs / sec_fixed, fixed_mean_T=avg_fixed["T"],
         fixed_fer=avg_fixed["fer"], fixed_ber=avg_fixed["ber"],
         no_probe_k1=off.k1, no_probe_seconds=sec_off,
         no_probe_trials_per_s=epochs / sec_off, no_probe_mean_T=avg_off["T"],
         no_probe_fer=avg_off["fer"], no_probe_ber=avg_off["ber"],
         identical=same, k1_launches=[r["launches"] for r in runs],
         plain_decodes=[r["plain_decodes"] for r in runs])
    if any(r["launches"] <= 0 or r["plain_decodes"] for r in runs):
        raise AssertionError("an auto-k1 run did not run through K1 alone")
    if off.probe_meanT is not None or fixed.probe_meanT is not None:
        raise AssertionError("a run probed that should not have")
    if not all(same.values()):
        raise AssertionError(f"the 8 dB point's metrics depend on k1: "
                             f"{same}")
    return runs


def phase_main_plain(torch, dev):
    """``use_pallas=False`` beside ``'auto'`` on the same seeds: the BAMP
    main point (flagship OOK, 8 dB, k1 = 12, ``PLAIN_BAMP_REALIZATIONS``
    realizations of 65536) and the SCAMP main point (8 dB, k1 = 8,
    ``PLAIN_SCAMP_REALIZATIONS``).  Gates: no K1 or K2 launch in the
    False runs, whose plain loops run twice a realization (both phases);
    the kernel alone in the 'auto' runs; |d mean T| <= 0.02 and FER and
    BER within 3 sigma (compare's rule; FER binomial, BER from the scatter
    of groups of one realization's trials).  Prints whether the sums are
    identical (K1 and K2 are their plain versions bit for bit) and both
    runs' trials/s."""
    from amp_sparc_spatialmodulation_tpu_torch.config import flagship_bamp_ook
    from amp_sparc_spatialmodulation_tpu_torch.models import (bamp,
                                                              montecarlo,
                                                              scamp)
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_bamp, fused_scamp)
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    points = (("bamp", flagship_bamp_ook(), K1, PLAIN_BAMP_REALIZATIONS,
               fused_bamp, bamp),
              ("scamp", scamp_main_config(), SCAMP_K1,
               PLAIN_SCAMP_REALIZATIONS, fused_scamp, scamp))
    out = {}
    for algo, cfg, k1, n_real, kern, mod in points:
        epochs = n_real * RES
        counters = [(kern, ("launches",)), (mod, ("plain_decodes",))]
        runs = {}
        for use in ("auto", False):
            sim = montecarlo.Simulator(cfg, algo=algo, two_phase=k1,
                                       use_pallas=use, device=dev,
                                       progress=lambda s: None)
            avg, seconds, n = run_counted(torch, sim, EBN0_DB, epochs, RES,
                                          counters)
            runs[str(use)] = dict(avg=avg, seconds=seconds,
                                  trials_per_s=epochs / seconds, **n)
        r = montecarlo.generate_realization(make_generator(dev, 12345), cfg,
                                            "sparc", "banded", RES,
                                            snr_of(cfg, EBN0_DB))
        dec = montecarlo.decode(algo, r, r.y, cfg)
        bsig = ber_sigma(torch, cfg, dec, r.msg, RES, epochs)
        del r, dec
        ka, pa = runs["auto"], runs["False"]
        fsig = fer_sigma(ka["avg"]["fer"], epochs)
        emit("main_plain", algo=algo, ebn0_db=EBN0_DB, two_phase_k1=k1,
             res=RES, realizations=n_real, trials=epochs,
             **{f"{'kernel' if u == 'auto' else 'plain'}_{k}": v
                for u, run in runs.items()
                for k, v in (("seconds", run["seconds"]),
                             ("trials_per_s", run["trials_per_s"]),
                             ("mean_T", run["avg"]["T"]),
                             ("fer", run["avg"]["fer"]),
                             ("ber", run["avg"]["ber"]),
                             ("launches", run["launches"]),
                             ("plain_decodes", run["plain_decodes"]))},
             plain_over_kernel_trials_per_s=(pa["trials_per_s"]
                                             / ka["trials_per_s"]),
             sums_identical=pa["avg"] == ka["avg"], fer_sigma=fsig,
             ber_sigma=bsig)
        if pa["launches"] or pa["plain_decodes"] != 2 * n_real:
            raise AssertionError(f"{algo} use_pallas=False launched a "
                                 "kernel or skipped a plain loop")
        if ka["launches"] <= 0 or ka["plain_decodes"]:
            raise AssertionError(f"{algo} 'auto' did not run through the "
                                 "kernel alone")
        if (abs(pa["avg"]["T"] - ka["avg"]["T"]) > 0.02
                or abs(pa["avg"]["fer"] - ka["avg"]["fer"]) > 3 * fsig
                or abs(pa["avg"]["ber"] - ka["avg"]["ber"]) > 3 * bsig):
            raise AssertionError(f"{algo} plain loop vs kernel: {pa['avg']} "
                                 f"vs {ka['avg']}")
        out[algo] = runs
    return out


def phase_main_plain_high(torch, dev):
    """The plain loops at HIGH.  First ``Simulator(flagship_bamp_qpsk(),
    use_pallas=False, precision='high')`` beside K1-high (``'auto'``,
    ``'high'``) on the same seeds at main_bamp_high's point (5 dB, cap
    100, every trial at the cap), ``PLAIN_HIGH_REALIZATIONS`` realizations
    of ``PLAIN_HIGH_RES``; gates main_bamp_high's rule: FER and BER within 3
    sigma, mean T within 1.0, the plain side no kernel launch.  Then SCAMP
    at the 8PSK sweep geometry, 7 dB, cap 200, ``SCAMP_8PSK_REALIZATIONS``
    of ``PLAIN_HIGH_RES``, at 'high' beside 'highest': both the plain loop
    (K2 does not fit), FER
    within 3 sigma; both mean Ts printed without a gate (HIGH inflates T
    where trials stop early); and ``precision='auto'`` builds there."""
    from amp_sparc_spatialmodulation_tpu_torch.config import (
        flagship_bamp_qpsk)
    from amp_sparc_spatialmodulation_tpu_torch.models import (bamp,
                                                              montecarlo,
                                                              scamp)
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_bamp, fused_scamp)
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    n_real, res = PLAIN_HIGH_REALIZATIONS, PLAIN_HIGH_RES
    epochs = n_real * res

    def summary(runs):
        return {f"{name}_{k}": v for name, run in runs.items()
                for k, v in (("seconds", run["seconds"]),
                             ("trials_per_s", run["trials_per_s"]),
                             ("mean_T", run["avg"]["T"]),
                             ("fer", run["avg"]["fer"]),
                             ("ber", run["avg"]["ber"]),
                             ("launches", run["launches"]),
                             ("launches_high", run["launches_high"]),
                             ("plain_decodes", run["plain_decodes"]))}

    cfg = flagship_bamp_qpsk()
    counters = [(fused_bamp, ("launches", "launches_high")),
                (bamp, ("plain_decodes",))]
    runs = {}
    for name, use in (("kernel_high", "auto"), ("plain_high", False)):
        sim = montecarlo.Simulator(cfg, algo="bamp", precision="high",
                                   use_pallas=use, device=dev,
                                   progress=lambda s: None)
        avg, seconds, n = run_counted(torch, sim, BAMP_HIGH_EBN0_DB, epochs,
                                      res, counters)
        runs[name] = dict(avg=avg, seconds=seconds,
                          trials_per_s=epochs / seconds, **n)
    r = montecarlo.generate_realization(
        make_generator(dev, 12345), cfg, "sparc", "banded", res,
        snr_of(cfg, BAMP_HIGH_EBN0_DB), "high")
    dec = bamp.decode(r.A, r.y, r.sigma2, cfg, precision="high")
    bsig = ber_sigma(torch, cfg, dec, r.msg, res, epochs)
    del r, dec
    ks, ps = runs["kernel_high"], runs["plain_high"]
    fsig = fer_sigma(ks["avg"]["fer"], epochs)
    emit("main_plain_high", algo="bamp", config="flagship_bamp_qpsk",
         ebn0_db=BAMP_HIGH_EBN0_DB, cap=cfg.N_Layers, res=res,
         realizations=n_real, trials=epochs, **summary(runs),
         plain_over_kernel_trials_per_s=(ps["trials_per_s"]
                                         / ks["trials_per_s"]),
         fer_sigma=fsig, ber_sigma=bsig)
    if (ps["launches"] or ps["launches_high"]
            or ps["plain_decodes"] != n_real):
        raise AssertionError("the plain BAMP HIGH run launched a kernel")
    if ks["launches_high"] <= 0 or ks["launches"] or ks["plain_decodes"]:
        raise AssertionError("the BAMP HIGH run did not run through K1's "
                             "HIGH instance alone")
    if (abs(ps["avg"]["fer"] - ks["avg"]["fer"]) > 3 * fsig
            or abs(ps["avg"]["ber"] - ks["avg"]["ber"]) > 3 * bsig
            or abs(ps["avg"]["T"] - ks["avg"]["T"]) > 1.0):
        raise AssertionError(f"plain BAMP HIGH {ps['avg']} vs K1-high "
                             f"{ks['avg']}")

    cfg = scamp_8psk_config()
    n_real, epochs = SCAMP_8PSK_REALIZATIONS, SCAMP_8PSK_REALIZATIONS * res
    counters = [(fused_scamp, ("launches",)), (scamp, ("plain_decodes",))]
    runs = {}
    for precision in ("highest", "high"):
        sim = montecarlo.Simulator(cfg, algo="scamp", precision=precision,
                                   device=dev, progress=lambda s: None)
        avg, seconds, n = run_counted(torch, sim, SCAMP_8PSK_DB, epochs, res,
                                      counters)
        runs[precision] = dict(avg=avg, seconds=seconds,
                               trials_per_s=epochs / seconds,
                               launches_high=0, **n)
    auto = montecarlo.Simulator(cfg, algo="scamp", precision="auto",
                                device=dev, progress=lambda s: None)
    auto._last_meanT = float(cfg.N_Layers)
    hs, hi = runs["highest"], runs["high"]
    fsig = fer_sigma(hs["avg"]["fer"], epochs)
    emit("main_plain_high", algo="scamp", config="scamp_8psk_sweep",
         ebn0_db=SCAMP_8PSK_DB, cap=cfg.N_Layers, res=res,
         realizations=n_real, trials=epochs, **summary(runs),
         high_over_highest_trials_per_s=(hi["trials_per_s"]
                                         / hs["trials_per_s"]),
         fer_sigma=fsig, auto_builds=True,
         auto_after_pinned_point=auto._effective_precision(),
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if any(run["launches"] or run["plain_decodes"] != n_real
           for run in runs.values()):
        raise AssertionError("the SCAMP 8PSK runs did not take the plain "
                             "loop alone")
    if abs(hi["avg"]["fer"] - hs["avg"]["fer"]) > 3 * fsig:
        raise AssertionError(f"SCAMP 8PSK HIGH FER {hi['avg']['fer']} vs "
                             f"HIGHEST {hs['avg']['fer']}")
    if auto._effective_precision() != "high":
        raise AssertionError("'auto' did not pick HIGH after a pinned point")


# The sharded paths (parallel/): the card runs a world of one rank, since
# NCCL puts no two ranks on one device; several ranks are held on the CPU
# under gloo (tests/test_torch_parallel.py, test_torch_banded_tp.py,
# test_torch_tensor_tp.py).  main_sharded: 16 realizations of BAMP, 8 of
# SCAMP (main_plain's counts, cut from the main cells' 128 and 64 to keep
# the three phases near 40 s; widths uncut); main_model_axis: each
# frame-split decoder at full width on 4096 trials (kernels' full-width
# shape).
SHARDED_BAMP_REALIZATIONS = 16
SHARDED_SCAMP_REALIZATIONS = 8
MODEL_AXIS_B = 4096
MODEL_AXIS_TOL = 1e-3
CLI_TIMEOUT_S = 300


class Nccl:
    """A world-1 NCCL group on the card for one phase, destroyed at its end;
    one all-reduce on entry, so that the group's NCCL communicator is
    built (and a failing NCCL init fails the phase)."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev

    def __enter__(self):
        import torch.distributed as dist

        from amp_sparc_spatialmodulation_tpu_torch.parallel import mesh
        self.dev = mesh.initialize_distributed(device=self.dev)
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError(f"expected a world-1 NCCL group, have "
                                 f"{dist.get_backend()} of "
                                 f"{dist.get_world_size()}")
        one = self.torch.ones(1, device=self.dev)
        dist.all_reduce(one)
        if float(one.item()) != 1.0:
            raise AssertionError(f"NCCL all-reduce of one rank gave {one}")
        return mesh.make_mesh(1, 1, device_type="cuda")

    def __exit__(self, *exc):
        import gc

        import torch.distributed as dist
        dist.destroy_process_group()
        gc.collect()
        return False


def phase_main_sharded(torch, dev):
    """``ShardedSimulator`` on a (1, 1) NCCL mesh beside
    ``Simulator.run_point`` on the same seeds, in turns (Simulator,
    sharded, sharded, Simulator): the BAMP flagship (8 dB, k1 = 12,
    ``SHARDED_BAMP_REALIZATIONS`` x 65536, K1) and the SCAMP main point (8
    dB, k1 = 8, ``SHARDED_SCAMP_REALIZATIONS`` x 65536, K2).  Gates: FER,
    BER and mean T identical in every run, the same kernel launch count in
    every run (> 0) and no plain decode.  Prints each run's trials/s and
    the sharded runs' ratio to the Simulator's.  Returns the BAMP sharded
    run's averages, for main_cli_sharded."""
    import torch.distributed as dist

    from amp_sparc_spatialmodulation_tpu_torch.config import flagship_bamp_ook
    from amp_sparc_spatialmodulation_tpu_torch.models import (bamp,
                                                              montecarlo,
                                                              scamp)
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_bamp, fused_scamp)
    from amp_sparc_spatialmodulation_tpu_torch.parallel import sweep

    cells = (("bamp", flagship_bamp_ook(), K1, SHARDED_BAMP_REALIZATIONS,
              [(fused_bamp, ("launches",)), (bamp, ("plain_decodes",))]),
             ("scamp", scamp_main_config(), SCAMP_K1,
              SHARDED_SCAMP_REALIZATIONS,
              [(fused_scamp, ("launches",)), (scamp, ("plain_decodes",))]))
    out = {}
    with Nccl(torch, dev) as mesh:
        for algo, cfg, k1, n_real, counters in cells:
            epochs = n_real * RES
            kw = dict(algo=algo, two_phase=k1, progress=lambda s: None)
            plain_sim = montecarlo.Simulator(cfg, device=dev, **kw)
            sharded = sweep.ShardedSimulator(cfg, mesh=mesh, **kw)
            runs = []
            for name, sim in (("simulator", plain_sim),
                              ("sharded", sharded), ("sharded", sharded),
                              ("simulator", plain_sim)):
                avg, seconds, n = run_counted(torch, sim, EBN0_DB, epochs,
                                              RES, counters)
                runs.append(dict(run=name, seconds=seconds,
                                 trials_per_s=epochs / seconds,
                                 mean_T=avg["T"], fer=avg["fer"],
                                 ber=avg["ber"], launches=n["launches"],
                                 plain_decodes=n["plain_decodes"]))
            secs = {r: sum(x["seconds"] for x in runs if x["run"] == r)
                    for r in ("simulator", "sharded")}
            first = runs[0]
            same = all(r[k] == first[k] for r in runs
                       for k in ("fer", "ber", "mean_T", "launches"))
            emit("main_sharded", algo=algo, ebn0_db=EBN0_DB, res=RES,
                 realizations=n_real, two_phase_k1=k1, mesh=[1, 1],
                 backend=dist.get_backend(), device=str(sharded.device),
                 runs=runs,
                 sharded_over_simulator=secs["simulator"] / secs["sharded"],
                 identical=same)
            if not same:
                raise AssertionError(f"{algo}: the sharded runs differ from "
                                     f"the Simulator's: {runs}")
            if any(r["launches"] <= 0 or r["plain_decodes"] for r in runs):
                raise AssertionError(f"{algo}: a run left its kernel: "
                                     f"{runs}")
            out[algo] = runs[1]
    return out["bamp"]


def phase_main_cli_sharded(torch, dev, sharded_bamp):
    """``python -m torch.distributed.run --standalone --nproc-per-node 1
    -m amp_sparc_spatialmodulation_tpu_torch.cli -- sweep --shard`` at the
    flagship geometry, 8 dB only, main_sharded's BAMP trials and seed,
    into a temporary directory.  Gate: the artifact's FER and mean T equal
    main_sharded's sharded run's."""
    import glob
    import os
    import tempfile

    from amp_sparc_spatialmodulation_tpu_torch.config import flagship_bamp_ook

    cfg = flagship_bamp_ook()
    epochs = SHARDED_BAMP_REALIZATIONS * RES
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "1", "-m",
               "amp_sparc_spatialmodulation_tpu_torch.cli", "--", "sweep",
               "--shard", "--algo", "bamp", "--Nt", str(cfg.Nt), "--Na",
               str(cfg.Na), "--Nr", str(cfg.Nr), "--Lin", str(cfg.Lin),
               "--Lh", str(cfg.Lh), "--mode", cfg.mode, "--alphabet",
               cfg.alphabet, "--profile", cfg.profile, "--trunc", cfg.trunc,
               "--iterations", str(cfg.iterations), "--epochs", str(epochs),
               "--res", str(RES), "--start", str(EBN0_DB), "--final",
               str(EBN0_DB), "--two-phase", str(K1), "--seed", "0",
               "--device", str(dev), "--out", tmp]
        env = dict(os.environ, PYTHONPATH=here + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=here, env=env, capture_output=True,
                              text=True, timeout=CLI_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        found = glob.glob(os.path.join(tmp, "BAMP", "**", f"{EBN0_DB}.json"),
                          recursive=True)
        point = None
        if proc.returncode == 0 and len(found) == 1:
            with open(found[0]) as f:
                point = json.load(f)
    emit("main_cli_sharded", command=" ".join(cmd[1:11]) + " ...",
         returncode=proc.returncode, seconds=seconds,
         fer=None if point is None else point["fer"],
         mean_T=None if point is None else point["T"],
         sharded_fer=sharded_bamp["fer"],
         sharded_mean_T=sharded_bamp["mean_T"],
         stdout_tail=proc.stdout[-600:],
         stderr_tail=proc.stderr[-1500:] if proc.returncode else "")
    if point is None:
        raise AssertionError(f"the sharded CLI run failed (rc "
                             f"{proc.returncode}, {len(found)} artifacts)")
    if (point["fer"] != sharded_bamp["fer"]
            or point["T"] != sharded_bamp["mean_T"]):
        raise AssertionError("the sharded CLI's point differs from "
                             "main_sharded's")


def phase_main_model_axis(torch, dev):
    """The model-axis decoders called directly at full width on a (1, 1)
    NCCL mesh, each against the port's single-device plain loop on the
    same inputs under ``compare``'s rule at 1e-3 (``MODEL_AXIS_B``
    trials): halo BAMP at the flagship geometry, halo SCAMP at the SCAMP
    main geometry, dense BAMP on the i.i.d. channel at the flagship
    dimensions and ``vamp_tp`` at the VAMP main geometry (cap 10), 8 dB.
    Prints each decode's seconds beside its plain loop's.  With one rank
    on the axis every exchange and all-reduce is the identity; what runs is
    the decoders' own arithmetic (the local products, the owned-slot masks,
    the gathers), which the gloo tests hold at k = 2 and 4."""
    from amp_sparc_spatialmodulation_tpu_torch.config import flagship_bamp_ook
    from amp_sparc_spatialmodulation_tpu_torch.models import (bamp,
                                                              montecarlo,
                                                              scamp, vamp)
    from amp_sparc_spatialmodulation_tpu_torch.parallel import (banded,
                                                                tensor,
                                                                vamp_tp)
    from amp_sparc_spatialmodulation_tpu_torch.parallel.mesh import (
        MODEL_AXIS, axis_of)
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def realization(cfg, channel, form, algo="bamp"):
        gen = make_generator(dev, 19, 0, 0)
        return montecarlo.with_svd(algo, montecarlo.generate_realization(
            gen, cfg, channel, form, MODEL_AXIS_B, snr_of(cfg, EBN0_DB)))

    with Nccl(torch, dev) as mesh:
        ax = axis_of(mesh, MODEL_AXIS)
        cases = []
        cfg = flagship_bamp_ook()
        r = realization(cfg, "sparc", "banded")
        cases.append(("halo_bamp", cfg, lambda: banded.decode(
            r.A.h, r.A.gains, banded.shard_rows(r.y, cfg, ax), r.sigma2,
            cfg, mesh=mesh, return_state=True), lambda: bamp.decode(
            r.A, r.y, r.sigma2, cfg, use_pallas=False, return_state=True),
            ("xmap", "xmmse", "var")))
        scfg = scamp_main_config()
        rs = realization(scfg, "sparc", "banded", "scamp")
        cases.append(("halo_scamp", scfg, lambda: banded.scamp_decode(
            rs.A.h, rs.A.gains, rs.W, banded.shard_rows(rs.y, scfg, ax),
            rs.sigma2, scfg, mesh=mesh, return_state=True),
            lambda: scamp.decode(rs.W, rs.A, rs.y, rs.sigma2, scfg,
                                 use_pallas=False, return_state=True),
            ("xmap", "xmmse", "psi")))
        ri = realization(cfg, "iid", "dense")
        cases.append(("dense_bamp_iid", cfg, lambda: tensor.decode(
            tensor.shard_columns(ri.A, ax), ri.y, ri.sigma2, cfg, mesh=mesh,
            return_state=True), lambda: bamp.decode(
            ri.A, ri.y, ri.sigma2, cfg, use_pallas=False,
            return_state=True), ("xmap", "xmmse", "var")))
        vcfg = vamp_main_config()
        rv = realization(vcfg, "sparc", "dense", "vamp")
        cases.append(("vamp_tp", vcfg, lambda: vamp_tp.decode(
            rv.dec.U, rv.dec.s, tensor.shard_columns(rv.dec.Vh, ax), rv.y,
            rv.sigma2, vcfg, mesh=mesh, return_state=True),
            lambda: vamp.decode(rv.dec, rv.y, rv.sigma2, vcfg,
                                use_pallas=False, return_state=True),
            VAMP_FIELDS))
        for name, c, split, plain, fields in cases:
            sk, split_s = timed(split)
            (_, sp), plain_s = timed(plain)
            compare(f"main_model_axis_{name}", sk, sp, MODEL_AXIS_TOL,
                    fields=fields, cap=c.N_Layers, ebn0_db=EBN0_DB,
                    mesh=[1, 1], backend=torch.distributed.get_backend(),
                    split_s=split_s, plain_s=plain_s,
                    split_over_plain=split_s / plain_s)


# main_sparc_trial: single SPARC trials (B = 1) through
# models/sparc_tools.py::compare_single_trial at the SCAMP main geometry
# (no power allocation), 256 seeds at the Eb/N0 where the JAX package's FER
# lies between 0.05 and 0.5 for both decoders.  The JAX package's CPU run
# over the same seeds (tests/torch_analysis_reference.py --part sparc
# --ebn0 7 --seeds 256): FER and SER per decoder and the standard deviation
# of one trial's SER, from which the 3-sigma bound of the difference of two
# 256-trial runs is taken (FER's from its binomial sigma).
SPARC_TRIAL_DB = 7.0
SPARC_TRIAL_SEEDS = 256
SPARC_TRIAL_REF = {
    "scamp": dict(fer=0.33984375, ser=0.021875,
                  ser_sd=0.03500700210070024),
    "bamp": dict(fer=0.375, ser=0.0259765625, ser_sd=0.041052613748557294)}
SPARC_TRIAL_KEYS = ["ser", "fer", "nmse", "C", "rate_nats"]
# Each kernel's result at B = 1 against its plain loop on the same trial,
# for the first SPARC_TRIAL_PLAIN seeds: the plain loop with the trial in a
# batch of SPARC_TRIAL_WIDE copies must give the kernel's T and state bit
# for bit.  At a batch of one the plain loop's products have 20 rows, where
# cuBLAS sums in another order than at 1,280 and more (the order the
# kernels follow at every batch, one block a trial), so there T, the
# results and the state are printed beside the kernel's, not held: in the
# waterfall a trial's T turns on the last bits of its products.
SPARC_TRIAL_PLAIN = 24
SPARC_TRIAL_WIDE = 64

# main_capacity: InfoTheory.simulate at flagship_bamp_ook(), 100 epochs a
# point, grid_points=100, 3 Eb/N0 points from the default start (ceil of
# the Shannon limit: 1, 2, 3 dB).  The JAX package's CPU run at the same
# config and epochs over seeds 0-3 (tests/torch_analysis_reference.py
# --part capacity --epochs 100 --points 3 --cap-seeds 0,1,2,3): the mean
# and standard deviation over the seeds of Cwf and Mi (each the largest of
# 100 epochs).  The port's one run (seed 0; its random stream differs)
# must lie within CAP_SIGMAS * sd * sqrt(1 + 1/4) of JAX's 4-seed mean: 5
# sigma, as an sd from 4 seeds is itself uncertain by about 40%.
CAP_EPOCHS = 100
CAP_POINTS = 3
CAP_GRID = 100
CAP_SIGMAS = 5.0
CAP_REF = dict(seeds=4,
               cwf_mean=[19.65456352397389, 23.891244573088066,
                         29.237100953740526],
               cwf_sd=[0.1786636999164399, 0.13296135095435244,
                       0.17477067318017592],
               mi_mean=[11.072975873947144, 13.882849216461182,
                        17.277530670166016],
               mi_sd=[0.07650165880086934, 0.07725651120985905,
                      0.07831759380160304])
# The Gram in FP32 (no TF32): the eigenvalues of one epoch's Gram within
# this share of the largest of a float64 host eigvalsh of the same H.
CAP_GRAM_TOL = 1e-5


def sparc_trial_cli(dev, cfg, extra):
    """``python -m amp_sparc_spatialmodulation_tpu_torch.cli sparc-trial``
    at ``cfg`` and ``SPARC_TRIAL_DB`` with ``extra`` options, started (not
    waited for) as a subprocess."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "amp_sparc_spatialmodulation_tpu_torch.cli",
           "sparc-trial", "--Nt", str(cfg.Nt), "--Na", str(cfg.Na), "--Nr",
           str(cfg.Nr), "--Lin", str(cfg.Lin), "--Lh", str(cfg.Lh), "--mode",
           cfg.mode, "--alphabet", cfg.alphabet, "--profile", cfg.profile,
           "--trunc", cfg.trunc, "--iterations", str(cfg.iterations),
           "--ebn0", str(SPARC_TRIAL_DB), "--device", str(dev), *extra]
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return cmd, subprocess.Popen(cmd, cwd=here, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)


def phase_main_sparc_trial(torch, dev):
    """Single SPARC trials at a batch of one: ``compare_single_trial`` at
    the SCAMP main geometry over ``SPARC_TRIAL_SEEDS`` seeds at
    ``SPARC_TRIAL_DB`` (counts set to 0 just before, read just after: K1
    and K2 once a trial each, no plain decode); then on the same draws each
    decoder's kernel alone, timed, giving the head-to-head's results, and
    for the first ``SPARC_TRIAL_PLAIN`` draws its plain loop
    (``use_pallas=False``): in a batch of ``SPARC_TRIAL_WIDE`` copies of
    the trial bit for bit the kernel's T and state, at B = 1 printed
    beside it (T agreement, identical results, state where T agrees below
    the cap); FER and SER of each decoder within 3 sigma of the JAX
    package's CPU run; ``cli sparc-trial --power-allocation`` and
    ``--estimate-phi --sparc-algo scamp`` as subprocesses (exit 0, the JAX
    CLI's fields).  Prints the trials/s of the head-to-head and of each
    decoder's kernel and plain loop."""
    import ast

    from amp_sparc_spatialmodulation_tpu_torch.models import (bamp, scamp,
                                                              sparc_tools)
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_bamp, fused_scamp)

    cfg = scamp_main_config()
    n = SPARC_TRIAL_SEEDS
    sparc_tools.compare_single_trial(cfg, SPARC_TRIAL_DB, seed=n,
                                     device=dev)           # warm-up
    counters = [(fused_bamp, ("launches",)), (fused_scamp, ("launches",)),
                (bamp, ("plain_decodes",)), (scamp, ("plain_decodes",))]
    for mod, names in counters:
        for name in names:
            setattr(mod, name, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runs = [sparc_tools.compare_single_trial(cfg, SPARC_TRIAL_DB, seed=s,
                                             device=dev) for s in range(n)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {"k1_launches": fused_bamp.launches,
              "k2_launches": fused_scamp.launches,
              "plain_decodes": bamp.plain_decodes + scamp.plain_decodes}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    kern = {a: dict(seconds=0.0) for a in ("bamp", "scamp")}
    held = []
    for s in range(n):
        trial = sparc_tools._build_trial(cfg, SPARC_TRIAL_DB, None, s, dev)
        outs = {}
        for algo, st in kern.items():
            outs[algo], t = timed(lambda: sparc_tools._decode(algo, trial,
                                                               cfg))
            st["seconds"] += t
            got = sparc_tools._eval_trial(outs[algo], trial.msg, cfg,
                                          trial.snr, trial.rate)
            if got != runs[s][algo]:
                raise AssertionError(f"{algo} seed {s}: the same draw gave "
                                     f"{got} and {runs[s][algo]}")
        if s < SPARC_TRIAL_PLAIN:
            held.append((trial, outs))
    # both CLI runs beside the plain loops (whose trials/s they may slow):
    # each builds nothing (the kernels are built) and decodes one trial
    clis = [sparc_trial_cli(dev, cfg, extra) for extra in
            (["--power-allocation"],
             ["--estimate-phi", "--sparc-algo", "scamp"])]
    plain = {a: dict(wide_exact=0, seconds=0.0, T_agree=0, same_result=0,
                     max_state_err=0.0) for a in ("bamp", "scamp")}
    fields = ("xmap", "xmmse", "var")
    for trial, outs in held:
        wide = trial._replace(y=trial.y.expand(SPARC_TRIAL_WIDE, -1)
                              .contiguous())
        for algo, st in plain.items():
            ok = outs[algo]
            ow = sparc_tools._decode(algo, wide, cfg, use_pallas=False)
            st["wide_exact"] += int(
                torch.equal(ow.T[:1], ok.T)
                and all(torch.equal(getattr(ow, f)[:1], getattr(ok, f))
                        for f in fields))
            op, t = timed(lambda: sparc_tools._decode(algo, trial, cfg,
                                                      use_pallas=False))
            st["seconds"] += t
            if int(op.T[0]) != int(ok.T[0]):
                continue
            st["T_agree"] += 1
            st["same_result"] += int(
                sparc_tools._eval_trial(op, trial.msg, cfg, trial.snr,
                                        trial.rate)
                == sparc_tools._eval_trial(ok, trial.msg, cfg, trial.snr,
                                           trial.rate))
            if int(ok.T[0]) < cfg.N_Layers:
                st["max_state_err"] = max(st["max_state_err"], max(
                    float((getattr(op, f) - getattr(ok, f)).abs().max())
                    for f in fields))
    outs = []
    for cmd, proc in clis:
        out, err = proc.communicate(timeout=CLI_TIMEOUT_S)
        lines = [ast.literal_eval(ln) for ln in out.strip().splitlines()
                 if ln.startswith("{")] if proc.returncode == 0 else []
        outs.append(dict(args=cmd[-3:], returncode=proc.returncode,
                         printed=lines,
                         stderr_tail=err[-1500:] if proc.returncode else ""))
    m = len(held)
    stats = {}
    for algo in ("scamp", "bamp"):
        fer = statistics.fmean(r[algo].fer for r in runs)
        ser = statistics.fmean(r[algo].ser for r in runs)
        ref, pl = SPARC_TRIAL_REF[algo], plain[algo]
        stats[algo] = dict(
            fer=fer, ser=ser, ref_fer=ref["fer"], ref_ser=ref["ser"],
            fer_3sigma=3 * math.sqrt(2 * ref["fer"] * (1 - ref["fer"]) / n),
            ser_3sigma=3 * ref["ser_sd"] * math.sqrt(2 / n),
            kernel_trials_per_s=n / kern[algo]["seconds"],
            kernel_ms_per_trial=1e3 * kern[algo]["seconds"] / n,
            plain_trials=m,
            plain_wide_exact_fraction=pl["wide_exact"] / m,
            plain_b1_T_agree_fraction=pl["T_agree"] / m,
            plain_b1_same_result_fraction=pl["same_result"] / m,
            plain_b1_max_state_err_T_agree_converged=pl["max_state_err"],
            plain_b1_trials_per_s=m / pl["seconds"])
    emit("main_sparc_trial", config="scamp_ook_sparc_flagship_dims",
         ebn0_db=SPARC_TRIAL_DB, trials=n, seconds=seconds,
         trials_per_s=n / seconds, **counts, plain_wide_batch=SPARC_TRIAL_WIDE,
         decoders=stats, cli=outs)
    if (counts["k1_launches"] != n or counts["k2_launches"] != n
            or counts["plain_decodes"]):
        raise AssertionError(f"single trials did not run through K1 and K2 "
                             f"once each: {counts}")
    for algo, st in stats.items():
        if st["plain_wide_exact_fraction"] != 1.0:
            raise AssertionError(f"{algo} at B=1: kernel != plain {st}")
        if (abs(st["fer"] - st["ref_fer"]) > st["fer_3sigma"]
                or abs(st["ser"] - st["ref_ser"]) > st["ser_3sigma"]):
            raise AssertionError(f"{algo} FER/SER outside 3 sigma of the "
                                 f"JAX package's: {st}")
    for o in outs:
        if o["returncode"] != 0 or not o["printed"] or any(
                list(d) != SPARC_TRIAL_KEYS for d in o["printed"]):
            raise AssertionError(f"cli sparc-trial failed: {o}")


def phase_main_capacity(torch, dev):
    """``InfoTheory(flagship_bamp_ook()).simulate`` on the card:
    ``CAP_EPOCHS`` epochs at each of ``CAP_POINTS`` Eb/N0 points from the
    default start, ``grid_points=CAP_GRID``.  Gates: Cawgn = log2(1 + snr)
    to 1e-12; for the first chunk of each point the device MI within rtol
    2e-4 of the host routine on the same gains; one epoch's eigenvalues
    within ``CAP_GRAM_TOL`` of a float64 host eigvalsh of its H (the Gram
    in FP32); Cwf and Mi within the bound of ``CAP_REF``; the CSV's header.
    Prints seconds per point, epochs/s, the chunk, the peak memory and one
    chunk's channels, eigvalsh and MI timed by CUDA events."""
    import os
    import tempfile

    import numpy as np

    from amp_sparc_spatialmodulation_tpu_torch.config import flagship_bamp_ook
    from amp_sparc_spatialmodulation_tpu_torch.models import capacity
    from amp_sparc_spatialmodulation_tpu_torch.ops import channel
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    cfg = flagship_bamp_ook()
    start = int(np.ceil(cfg.shannon_limit_dB))
    final = start + CAP_POINTS - 1
    with tempfile.TemporaryDirectory() as tmp:
        it = capacity.InfoTheory(cfg, out_root=tmp, device=dev)
        chunk = it.chunk(CAP_EPOCHS, CAP_GRID)
        stamps = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = it.simulate(epochs=CAP_EPOCHS, start=start, final=final,
                          grid_points=CAP_GRID,
                          progress=lambda m: stamps.append(
                              time.perf_counter()))
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(it.csv_path()) as f:
            header = f.readline().strip()
        ebn0 = np.arange(start, final + 1.0, 1.0)
        snr = 10 ** ((ebn0 + 10 * np.log10(cfg.code_rate)) / 10)
        cawgn_err = float(np.abs(out[:, 0] - np.log2(1 + snr)).max())
        mi_rel = []
        for j, s in enumerate(snr):
            g = it._gains(j, 0, chunk)
            dev_mi = capacity.mutual_information(
                cfg, g, float(np.float32(s)), CAP_GRID).cpu().numpy()
            host = np.array([it._mutual_information(gi, s, N=CAP_GRID)
                             for gi in g.cpu().numpy()])
            mi_rel.append(float(np.abs(dev_mi / host - 1).max()))
        H = channel.generate_channel(make_generator(dev, 0, 0, 0), cfg)
        H64 = H.cpu().numpy().astype(np.complex128)
        exact = np.linalg.eigvalsh(H64 @ H64.conj().T)
        g0 = it._gains(0, 0, 1)[0].cpu().numpy()
        gram_err = float(np.abs(np.sort(g0) - np.sort(exact)).max()
                         / exact.max())
        def channels():
            return torch.stack([channel.generate_channel(
                make_generator(dev, 0, 0, e), cfg) for e in range(chunk)])

        Hs = channels()
        G = Hs @ Hs.conj().transpose(-2, -1)
        g = capacity.gram_eigvalsh(Hs)
        timing = dict(
            channels_ms=cuda_ms(channels, 1, 3),
            gram_ms=cuda_ms(lambda: Hs @ Hs.conj().transpose(-2, -1), 1, 3),
            eigvalsh_ms=cuda_ms(lambda: torch.linalg.eigvalsh(G), 1, 3),
            mi_ms=cuda_ms(lambda: capacity.mutual_information(
                cfg, g, float(np.float32(snr[0])), CAP_GRID), 1, 3))
        del Hs, G, g
    scale = CAP_SIGMAS * math.sqrt(1 + 1 / CAP_REF["seeds"])
    bound = ([scale * sd for sd in CAP_REF["cwf_sd"]],
             [scale * sd for sd in CAP_REF["mi_sd"]])
    d_cwf = [float(out[j, 2] - CAP_REF["cwf_mean"][j])
             for j in range(CAP_POINTS)]
    d_mi = [float(out[j, 3] - CAP_REF["mi_mean"][j])
            for j in range(CAP_POINTS)]
    points_s = np.diff([t0] + stamps).tolist()
    emit("main_capacity", config="flagship_bamp_ook", epochs=CAP_EPOCHS,
         grid_points=CAP_GRID, ebn0_db=ebn0.tolist(), chunk=chunk,
         seconds=seconds, seconds_per_point=points_s,
         epochs_per_s=CAP_POINTS * CAP_EPOCHS / seconds,
         peak_mem_gib=peak, cawgn=out[:, 0].tolist(),
         cwf=out[:, 2].tolist(), mi=out[:, 3].tolist(),
         cawgn_max_err=cawgn_err, mi_device_vs_host_rel=mi_rel,
         gram_eig_err_of_max=gram_err, d_cwf=d_cwf, cwf_bound=bound[0],
         d_mi=d_mi, mi_bound=bound[1], csv_header=header, chunk_ms=timing)
    if not cawgn_err <= 1e-12:
        raise AssertionError(f"Cawgn off log2(1 + snr) by {cawgn_err}")
    if not max(mi_rel) <= 2e-4:
        raise AssertionError(f"device MI off the host routine: {mi_rel}")
    if not gram_err <= CAP_GRAM_TOL:
        raise AssertionError(f"the Gram is not FP32: {gram_err}")
    if any(abs(d) > b for d, b in zip(d_cwf + d_mi, bound[0] + bound[1])):
        raise AssertionError(f"Cwf / Mi outside the JAX package's bound: "
                             f"{d_cwf} {d_mi}")
    if header != ",EbN0dB,SNRdB,Cawgn,Cfs,Cwf,Mi":
        raise AssertionError(f"CSV header {header!r}")


def phase_main_profiling(torch, dev):
    """One flagship BAMP realization (65536 trials, k1 = 12, through
    ``Simulator.run_point``) inside ``Profiler.phase(..., items=65536)``
    and ``torch_trace``.  Gates: the exported trace names K1's kernel
    (``bamp_decode_kernel``) as often as K1's launch counter moved in the
    run (> 0), and the Profiler's items/s within 5% of the trials/s of a
    synchronized host clock around the same block.  Prints the trace's
    size and K1's device time in it."""
    import os
    import tempfile

    from amp_sparc_spatialmodulation_tpu_torch.config import flagship_bamp_ook
    from amp_sparc_spatialmodulation_tpu_torch.models import montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    from amp_sparc_spatialmodulation_tpu_torch.utils import profiling

    cfg = flagship_bamp_ook()
    sim = montecarlo.Simulator(cfg, algo="bamp", two_phase=K1, device=dev,
                               progress=lambda s: None)
    prof = profiling.Profiler()
    with tempfile.TemporaryDirectory() as tmp:
        fused_bamp.launches = 0
        with profiling.torch_trace(tmp, device=dev):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with prof.phase("realization", items=RES):
                avg = sim.run_point(EBN0_DB, epochs=RES, res=RES)
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
        launches = fused_bamp.launches
        path = os.path.join(tmp, profiling.TRACE_FILE)
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    k1 = [e for e in events if e.get("cat") == "kernel"
          and "bamp_decode_kernel" in e.get("name", "")]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    rep = prof.report()["realization"]
    host_rate = RES / host_s
    emit("main_profiling", config="flagship_bamp_ook", ebn0_db=EBN0_DB,
         res=RES, two_phase_k1=K1, k1_launches=launches,
         k1_in_trace=len(k1), k1_name=k1[0]["name"] if k1 else None,
         k1_device_ms=[e.get("dur", 0) / 1e3 for e in k1],
         kernels_in_trace=kernels, trace_events=len(events),
         trace_bytes=size, profiler=rep, host_trials_per_s=host_rate,
         items_per_s_over_host=rep["items_per_s"] / host_rate,
         mean_T=avg["T"], fer=avg["fer"])
    if launches <= 0 or len(k1) != launches:
        raise AssertionError(f"K1 launched {launches} times, the trace "
                             f"names it {len(k1)} times")
    if abs(rep["items_per_s"] / host_rate - 1) > 0.05:
        raise AssertionError(f"Profiler items/s {rep['items_per_s']} vs "
                             f"host {host_rate}")


# ---- The DEFAULT precision (precision='default', one bf16 pass) ----------
# The DEFAULT instances of K1, K3, K4 and K5 against their plain DEFAULT
# versions.  As at HIGH, two correct DEFAULT decodes part on the T of the
# trials that stop by the allclose test (a last-bit difference of the FP32
# sums moves a bf16 rounding by a whole step), and here also on the state
# of a few trials that stopped: so each shape has a T rule and a state
# bound on the trials that stopped before the cap in both, whose limits lie
# between the readings of tests/torch_bamp_high_rule.py --precision
# default on an NVIDIA H100 at 700 W (PERF.md, section 6): below, the
# kernel and the plain DEFAULT version with its sums in float64 (two
# correct decodes); above, the HIGH and HIGHEST instances (wrong products).
# Per shape (T agreement, |d mean T|, state bound, the HIGH instance must
# fail the rule); readings kernel / float64 sums against HIGH / HIGHEST:
# - K1 at the OOK phase-1 shape (65536 trials, cap 12, 8 dB): T agreement
#   99.17% / 99.48% against 78.06% / 76.94%, |d mean T| 0.00047 / 0.00044
#   against 0.232 / 0.267, state 9.93e-4 / 9.82e-4 against 7.82e-3 (so the
#   1e-4 of the small CPU geometries does not hold at this width for two
#   correct decodes: 60,234 trials stopped, a few of them apart by ~1e-3);
# - K1 at the QPSK flagship, 5 dB, cap 100: every decode at the cap,
#   nothing parts on T (the control separates);
# - K5 at the massive geometry, 10 dB, 2048 trials, cap 100: 51.3% /
#   51.4% against 45.8% / 46.1%, 0.017 / 0.074 against 0.144 / 0.119,
#   state 7.0e-7 / 1.5e-4 against 1.3e-2; at 8 dB, cap 10, every trial at
#   the cap.
K1_DEFAULT_RULES = {"ook_phase1": (0.985, 0.02, 3e-3, True),
                    "qpsk_cap100": (0.995, 0.02, 1e-4, False)}
K5_DEFAULT_RULES = {"massive_8db": (10, 0.995, 0.02, 1e-3, False),
                    "massive_10db": (100, 0.48, 0.10, 1e-3, True)}
# The state error reported beside each bound: the share of the stopped
# trials whose T agrees that lie within this (the CPU tests' bound).
DEFAULT_STATE_TOL = 1e-4
# The controls: one iteration from the state after two plain DEFAULT
# iterations against the plain DEFAULT step, each median under its limit
# for the DEFAULT instance, the HIGH instance's first statistic over it.
# K1 (vamp_gap): kernel xmap 3.3e-8 / 1.2e-7, z 1.1e-7 / 8.4e-8, u 4.5e-8 /
# 6.0e-8 (OOK / QPSK) against HIGH's 1.45e-3 / 1.97e-3, 9.6e-4 / 9.7e-4,
# 3.0e-5 / 3.9e-5.  K5 (iter_gap, 10 dB): z_re 1.5e-7, xmap_re 1.8e-7, u
# 1.2e-7 against 5.9e-4, 1.6e-3, 3.3e-5.
K1_DEFAULT_CONTROL = {"xmap_p50": 1e-5, "z_p50": 1e-5, "u_p50": 1e-5}
K5_DEFAULT_CONTROL = {"z_re_p50": 1e-5, "xmap_re_p50": 1e-5, "u_p50": 1e-5}
# K3 and K4: the control's median |d r| after one iteration at the main
# geometry (tests/torch_vamp_high_control.py --precision default): 1.19e-7
# (VAMP) and 1.23e-7 (vamp2) against HIGH's 1.54e-3 and 1.55e-3.
VAMP_DEFAULT_CONTROL_TOL = 1e-5
# main_bamp_default: the flagship OOK point (two-phase k1 = 12) and the
# BAMP QPSK point at 5 dB, cap 100, 2 realizations each.
DEFAULT_REALIZATIONS = 2


def stopped_share(sk, sp, tol=DEFAULT_STATE_TOL) -> float:
    """The share of the trials that stopped before the cap in both and
    whose T agrees with every state plane within ``tol``."""
    rows = (sk.T == sp.T) & ~(sk.active | sp.active)
    if not bool(rows.any()):
        return 1.0
    ok = rows.clone()
    for f in BAMP_FIELDS:
        d = (getattr(sk, f) - getattr(sp, f)).abs()
        ok &= (d.reshape(d.shape[0], -1) <= tol).all(dim=1)
    return float(ok.sum()) / float(rows.sum())


def bf16_library(torch, pairs):
    """(function, form) of the one-pass products ``pairs`` ((x, a) float32
    tensors) as PyTorch calls on bf16 tensors: ``torch.mm(..., out_dtype=
    torch.float32)`` where this PyTorch has it ('bf16_in_fp32_out'), else
    ``torch.matmul`` of the bf16 tensors ('bf16_in_bf16_out', the FP32 sums
    rounded to bf16 at the end)."""
    bf = [(x.bfloat16(), a.bfloat16()) for x, a in pairs]
    x0, a0 = bf[0]
    try:
        torch.mm(x0, a0, out_dtype=torch.float32)
        return (lambda: [torch.mm(x, a, out_dtype=torch.float32)
                         for x, a in bf]), "bf16_in_fp32_out"
    except (TypeError, RuntimeError):
        return (lambda: [torch.matmul(x, a) for x, a in bf]), \
            "bf16_in_bf16_out"


def gate_control(failed, phase, sound, wrong, limits, wrong_stat, **info):
    """Emit a control's readings; fail unless every statistic of the sound
    instance lies under its limit and the wrong instance's ``wrong_stat``
    over its limit."""
    emit(phase, **info, limits=limits, default=sound, wrong=wrong)
    if not (all(sound[k] < v for k, v in limits.items())
            and wrong[wrong_stat] >= limits[wrong_stat]):
        failed.append(f"control {phase} {info}")


def phase_kernels_bamp_default(torch, dev, ptxas_lines):
    """K1's DEFAULT instance (precision='default', one bf16 pass on the
    tensor cores) against its plain DEFAULT version
    (``fused_bamp.decode_plain_default``) at the shapes of
    ``kernels_bamp_high``'s timed checks, drawn at DEFAULT: the OOK
    flagship at its phase-1 shape (65536 trials, cap 12, 8 dB) and the QPSK
    flagship at 5 dB, cap 100 (4096 trials).  Each under :func:`compare`
    with its rule (``K1_DEFAULT_RULES``: T agreement, |d mean T| and the
    state bound on the trials that stopped before the cap in both, with the
    share of those within 1e-4 printed), the HIGH instance held to
    the same rule (it must fail where the rule separates), the control
    (``K1_DEFAULT_CONTROL``, the HIGH instance's reading beside it), then
    timed by CUDA events beside the HIGH and HIGHEST instances and the
    plain DEFAULT version, with the bound (one bf16 pass of the Gauss
    products at 989 TFLOP/s, or the bytes) and the same one-pass products
    as PyTorch calls on bf16 tensors.  Returns the largest state error and
    the timings, the QPSK shape first."""
    from amp_sparc_spatialmodulation_tpu_torch.config import (
        flagship_bamp_ook, flagship_bamp_qpsk)
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    p = "default"
    failed, timings, max_err = [], [], 0.0
    for name, cfg, B, cap, ebn0, seed in (
            ("qpsk_cap100", flagship_bamp_qpsk(), FLAGSHIP_B, 100,
             BAMP_HIGH_EBN0_DB, 42),
            ("ook_phase1", flagship_bamp_ook(), RES, K1, EBN0_DB, 41)):
        r = montecarlo.generate_realization(make_generator(dev, seed), cfg,
                                            "sparc", "banded", B,
                                            snr_of(cfg, ebn0), p)
        op, y, s2 = r.A, r.y, r.sigma2
        s0 = bamp.initial_state(y, cfg.N, s2)
        min_agree, max_dmean, tol, separates = K1_DEFAULT_RULES[name]
        s1 = fused_bamp.whole_decode(op, s0, y, s2, cap, cfg, p)
        sp = fused_bamp.decode_plain_default(op, s0, y, s2, cap, cfg)
        max_err = max(max_err, compare(
            "kernel_main_bamp_default", s1, sp, tol, free_unconverged=True,
            min_agree=min_agree, max_dmean_T=max_dmean, case=name, cap=cap,
            ebn0_db=ebn0, stopped_within_1e4=stopped_share(s1, sp)))
        sh = fused_bamp.whole_decode(op, s0, y, s2, cap, cfg, "high")
        frac, dmean, inside = rule_passes(sh, sp, min_agree, max_dmean)
        emit("kernel_main_bamp_default_high", case=name,
             T_agree_fraction=frac, abs_dmean_T=dmean, inside_rule=inside,
             must_fail=separates)
        if separates and inside:
            failed.append(f"{name}: the HIGH instance passes the rule")
        del sh, sp
        ps = fused_bamp.decode_plain_default(op, s0, y, s2, 2, cfg)
        one = fused_bamp.decode_plain_default(op, ps, y, s2, ps.t + 1, cfg)
        gate_control(failed, "kernel_main_bamp_default_control",
                     vamp_gap(fused_bamp.whole_decode(
                         op, ps, y, s2, ps.t + 1, cfg, p), one),
                     vamp_gap(fused_bamp.whole_decode(
                         op, ps, y, s2, ps.t + 1, cfg, "high"), one),
                     K1_DEFAULT_CONTROL, "xmap_p50", case=name, presteps=2)
        del ps, one
        ms = cuda_ms(lambda: fused_bamp.whole_decode(
            op, s0, y, s2, cap, cfg, p), 1, 3)
        high_ms = cuda_ms(lambda: fused_bamp.whole_decode(
            op, s0, y, s2, cap, cfg, "high"), 1, 3)
        highest_ms = cuda_ms(lambda: fused_bamp.whole_decode(
            op, s0, y, s2, cap, cfg), 1, 3)
        plain_ms = cuda_ms(lambda: fused_bamp.decode_plain_default(
            op, s0, y, s2, cap, cfg), 0, 1)
        real = fused_bamp.real_x(cfg)
        taps = fused_bamp.instance_taps(op, p)[0]
        state = [getattr(s0, f) for f in s0._fields if f != "t"]
        state += [getattr(s1, f) for f in s1._fields if f != "t"]
        # one pass of the Gauss products (7 for a real x, 8 complex); the
        # tap buffer the DEFAULT instance reads (the hi halves alone)
        flop, nbytes, iters = decode_work(cfg, s0, s1, state + [y, taps],
                                          7 if real else 8)
        bound_ms, bound_by = bound(flop, nbytes, PEAK_BF16_FLOPS)
        t = bamp.gauss_taps(op)
        rows, W = B * cfg.Lin, cfg.Lh * cfg.Nr
        xv = s1.var.reshape(rows, cfg.Nt)
        zr = torch.rand(rows, W, device=dev)
        pairs = [(xv, a) for a in (t.s_a2, t.s_re, t.dmc)
                 + (() if real else (t.cpd,))]
        pairs += [(zr, a) for a in (t.st_a2, t.st_re, t.amc, t.adm)]
        lib, form = bf16_library(torch, pairs)
        library_iter_ms = cuda_ms(lib, 1, 3)
        del lib, zr
        timing = dict(kernel="fused_bamp_decode_default", case=name, B=B,
                      cap=cap, ms=ms, high_ms=high_ms,
                      highest_ms=highest_ms, plain_ms=plain_ms,
                      default_over_high=ms / high_ms,
                      ns_per_iter_trial=1e6 * ms / iters, iterations=iters,
                      flop=flop, bytes=nbytes, bound_ms=bound_ms,
                      bound_by=bound_by, pct_of_bound=100 * bound_ms / ms,
                      library_ms=library_iter_ms * iters / B,
                      library_ms_per_iteration=library_iter_ms,
                      library_form=form,
                      smem_bytes=fused_bamp.smem_bytes(cfg, p),
                      threads=fused_bamp.high_threads(cfg),
                      tap_bytes=k1_tap_stream(cfg, iters, p),
                      ptxas_instance=instance_ptxas(
                          ptxas_lines, k1_instance(cfg, p)),
                      ptxas=ptxas_lines)
        emit("kernel_timing_bamp_default", **timing)
        timings.append(timing)
        del r, op, y, s0, s1, taps, state
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"K1 DEFAULT kernel != plain: {failed}")
    max_err = max(max_err, k1_wide_checks(torch, dev, p))
    return max_err, timings


def run_precisions(torch, sim_of, ebn0, epochs, res, counts, zero,
                   precisions):
    """``run_point`` of ``sim_of(precision)`` at each precision on the same
    seeds: {precision: dict(avg, seconds, trials_per_s, **counts())}, the
    counts set to 0 just before each run and read just after."""
    runs = {}
    for precision in precisions:
        sim = sim_of(precision)
        torch.cuda.synchronize()
        zero()
        t0 = time.perf_counter()
        avg = sim.run_point(ebn0, epochs=epochs, res=res)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs[precision] = dict(avg=avg, seconds=seconds,
                               trials_per_s=epochs / seconds, **counts())
    return runs


def flat_runs(runs, keys):
    return {f"{p}_{k}": (run["avg"][k[5:]] if k.startswith("mean_")
                         else run[k])
            for p, run in runs.items() for k in keys}


def phase_main_bamp_default(torch, dev):
    """``Simulator(algo='bamp', precision='default')`` on its main path
    through K1's DEFAULT instance.  The flagship OOK point at full width
    (``flagship_bamp_ook()``, 8 dB, two-phase k1 = 12, 2 realizations of
    65536) beside 'high' and 'highest' on the same seeds: trials/s, mean T,
    FER, BER, the share of trials at the cap of 100 (one DEFAULT
    realization decoded single-phase), the DEFAULT run through
    ``launches_default`` alone with no plain decode; printed, not gated
    against HIGH (whether one pass pins T at the cap here is what the run
    measures).  Then the BAMP QPSK point at 5 dB, cap 100, 2 realizations
    of 4096 beside 'high' and 'highest': the DEFAULT run through K1's
    DEFAULT instance alone, FER within 3 sigma of HIGH's (binomial, HIGH's
    count, at least one error), mean T at the cap (>= 99% of it) in all
    three.  Returns the flagship run's ``launches_default``."""
    from amp_sparc_spatialmodulation_tpu_torch.config import (
        flagship_bamp_ook, flagship_bamp_qpsk)
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_bamp, fused_bamp_iteration as fbi, fused_bamp_tiled)
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    def counts():
        return dict(launches=fused_bamp.launches,
                    launches_high=fused_bamp.launches_high,
                    launches_default=fused_bamp.launches_default,
                    others=(fbi.fused_launches + fused_bamp_tiled.launches
                            + fused_bamp_tiled.launches_high
                            + fused_bamp_tiled.launches_default),
                    plain=bamp.plain_decodes)

    def zero():
        fused_bamp.launches = fused_bamp.launches_high = 0
        fused_bamp.launches_default = fbi.fused_launches = 0
        fused_bamp_tiled.launches = fused_bamp_tiled.launches_high = 0
        fused_bamp_tiled.launches_default = bamp.plain_decodes = 0

    keys = ("seconds", "trials_per_s", "mean_T", "mean_fer", "mean_ber",
            "launches", "launches_high", "launches_default", "others",
            "plain")
    ok_path = lambda run: (run["launches_default"] > 0 and not (
        run["launches"] or run["launches_high"] or run["others"]
        or run["plain"]))
    n = DEFAULT_REALIZATIONS
    cfg = flagship_bamp_ook()
    runs = run_precisions(torch, lambda p: montecarlo.Simulator(
        cfg, algo="bamp", device=dev, precision=p, two_phase=K1,
        progress=lambda s: None), EBN0_DB, n * RES, RES, counts, zero,
        ("highest", "high", "default"))
    r = montecarlo.generate_realization(make_generator(dev, 12345), cfg,
                                        "sparc", "banded", RES,
                                        snr_of(cfg, EBN0_DB), "default")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = bamp.decode(r.A, r.y, r.sigma2, cfg, precision="default")
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    at_cap = float((out.T == cfg.N_Layers).float().mean())
    del r, out
    d = runs["default"]
    emit("main_bamp_default", config="flagship_bamp_ook", ebn0_db=EBN0_DB,
         res=RES, realizations=n, trials=n * RES, k1=K1, cap=cfg.N_Layers,
         **flat_runs(runs, keys), share_at_cap_default=at_cap,
         single_phase_decode_s=one_s,
         default_over_highest_trials_per_s=(
             d["trials_per_s"] / runs["highest"]["trials_per_s"]),
         fer_sigma_high=fer_sigma(runs["high"]["avg"]["fer"], n * RES))
    if not ok_path(d):
        raise AssertionError("the flagship DEFAULT run did not run through "
                             "K1's DEFAULT instance alone")
    flagship_launches = d["launches_default"]

    qcfg, qres = flagship_bamp_qpsk(), FLAGSHIP_B
    runs = run_precisions(torch, lambda p: montecarlo.Simulator(
        qcfg, algo="bamp", device=dev, precision=p,
        progress=lambda s: None), BAMP_HIGH_EBN0_DB, n * qres, qres, counts,
        zero, ("highest", "high", "default"))
    d, h = runs["default"], runs["high"]
    sigma = fer_sigma(h["avg"]["fer"], n * qres)
    emit("main_bamp_default_qpsk", config="flagship_bamp_qpsk",
         ebn0_db=BAMP_HIGH_EBN0_DB, res=qres, realizations=n,
         trials=n * qres, cap=qcfg.N_Layers, **flat_runs(runs, keys),
         fer_sigma=sigma)
    if not ok_path(d):
        raise AssertionError("the QPSK DEFAULT run did not run through K1's "
                             "DEFAULT instance alone")
    if abs(d["avg"]["fer"] - h["avg"]["fer"]) > 3 * sigma:
        raise AssertionError(f"BAMP QPSK DEFAULT FER {d['avg']['fer']} vs "
                             f"HIGH {h['avg']['fer']}")
    if any(run["avg"]["T"] < 0.99 * qcfg.N_Layers for run in runs.values()):
        raise AssertionError("BAMP QPSK at 5 dB: T not at the cap")
    return flagship_launches


def vamp_engine_bytes(torch, fused_vamp, p, N, s0, s1) -> dict:
    """The bytes the DEFAULT product engine's ring copies in one K3 or K4
    launch from state s0 to s1: each block runs its slowest trial's
    iterations, and each iteration copies, for every (tile, pass, k16 step)
    of both products, the block's trial-side step (64 trials x 16 bf16)
    and the tap step (DEFAULT_TILE_COLS columns x 16 bf16)."""
    bt, cols = fused_vamp.BLOCK_TRIALS, fused_vamp.DEFAULT_TILE_COLS
    kf, kb = fused_vamp.padded_k(N) // 16, fused_vamp.padded_k(p) // 16
    steps = 3 * (-(-p // cols) * kf + -(-N // cols) * kb)
    d = s1.T.long() - s0.T.long()
    d = torch.nn.functional.pad(d, (0, -d.numel() % bt)).view(-1, bt)
    block_iters = int(d.amax(1).sum())
    return {"block_iterations": block_iters, "steps_per_iteration": steps,
            "trial_side": block_iters * steps * 2 * bt * 16,
            "taps": block_iters * steps * 2 * cols * 16}


def ptxas_entries(lines, name: str) -> list:
    """The ptxas lines of every kernel instance whose mangled name holds
    ``name``, each from its 'Compiling entry' line to the next one."""
    starts = [i for i, ln in enumerate(lines) if "Compiling entry" in ln]
    return [lines[a:b] for a, b in zip(starts, starts[1:] + [len(lines)])
            if name in lines[a]]


def instance_ptxas(lines, mangled: str) -> list:
    """The ptxas lines of the kernel instance whose mangled name holds
    ``mangled`` (from its 'Compiling entry' line to the next one)."""
    found = ptxas_entries(lines, mangled)
    return found[0] if found else []


K1_PASSES = {"highest": 0, "high": 3, "default": 1}


def k1_instance(cfg, precision, x_precision=None):
    """The mangled tag of K1's instance ``bamp_decode_kernel<kVP, kXP,
    threads, blocks>`` that runs the form (a split form: the 512-thread
    one)."""
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    x_precision = x_precision or precision
    v, x = K1_PASSES[precision], K1_PASSES[x_precision]
    threads = 512 if v != x else fused_bamp.high_threads(cfg)
    return f"ILi{v}ELi{x}ELi{threads}E"


def k1_tap_stream(cfg, iters, precision, x_precision=None):
    """Tap bytes one launch of K1's form streams from L2, each tap once per
    trial-iteration: the mma fragments of the planes its bf16 chains
    multiply (``fused_bamp.instance_taps``: 16 bytes a lane and k16 step
    of a one-pass form, 32 of a three-pass one; in a mixed form each
    chain's own, ``fused_bamp.chain_parts``) and the FP32 planes of a
    chain at 'highest' (``fused_bamp.fp32_taps``)."""
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    x_precision = x_precision or precision
    words = dict(zip(("var", "xmap"),
                     fused_bamp.chain_parts(precision, x_precision)))
    real = fused_bamp.real_x(cfg)
    W = cfg.Lh * cfg.Nr
    frag = fused_bamp.padded16(W) * fused_bamp.padded16(cfg.Nt) * 2
    fp32 = 4 * cfg.Nt * W
    planes = {"var": 2, "xmap": (2 if real else 3) + 3}
    total = 0
    for chain, p in (("var", precision), ("xmap", x_precision)):
        total += planes[chain] * (fp32 if p == "highest"
                                  else frag * words[chain])
    return iters * total


def k1_form_taps(cfg, op, precision, x_precision=None) -> list:
    """The tap tensors K1's form reads, for its bound's bytes: the buffer
    of ``fused_bamp.instance_taps``, or in a mixed form the planes each
    chain multiplies of its own buffer (the variance chain's 2 of the
    eight, the xmap chain's 5 or 6)."""
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    taps = fused_bamp.instance_taps(op, precision, x_precision)[0]
    if not fused_bamp.mixed(precision, x_precision):
        return [taps]
    bufs = {2: fused_bamp.high_taps(op)[0].view(8, -1),
            1: fused_bamp.default_taps(op)[0].view(8, -1)}
    pv, px = fused_bamp.chain_parts(precision, x_precision)
    xq = [1, 2, 5, 6, 7] if fused_bamp.real_x(cfg) else [1, 2, 3, 5, 6, 7]
    return [bufs[pv][[0, 4]], bufs[px][xq]]


def phase_kernels_vamp_default(torch, dev, algo: str, ptxas_lines):
    """K3's (``algo='vamp'``) or K4's (``'vamp2'``) DEFAULT instance
    against its plain DEFAULT version (``decode_plain(..., 'default')``) at
    the main geometry, drawn and projected at DEFAULT: 4096 trials at cap
    10 under ``compare_vamp``'s mean_T_only rule (the HIGH instance must
    fail it for VAMP), the control after one iteration (the median |d r|
    under ``VAMP_DEFAULT_CONTROL_TOL``, the HIGH instance's over it), then
    the main path's shape (65536 trials, cap 10) compared and timed by
    CUDA events beside the HIGH and HIGHEST instances, the bound (9 real products of one bf16 pass at 989
    TFLOP/s, or the bytes) and the same one-pass products as PyTorch calls
    on bf16 tensors."""
    from amp_sparc_spatialmodulation_tpu_torch.models import (
        montecarlo, vamp, vamp2)
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_vamp, fused_vamp2)
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    mod, kern = (vamp, fused_vamp) if algo == "vamp" else (vamp2, fused_vamp2)
    data = vamp.project if algo == "vamp" else vamp2.whiten
    tag = "" if algo == "vamp" else "2"
    p = "default"

    def realization(cfg, B, seed, snr):
        r = montecarlo.with_svd(algo, montecarlo.generate_realization(
            make_generator(dev, seed), cfg, "sparc", "dense", B, snr, p))
        return (r, data(r.dec, r.y, p), (r.dec.s ** 2).contiguous(),
                mod.initial_state(r.y, cfg))

    def kernel(cfg, case, s0, cap, precision=p):
        r, yt, s2, _ = case
        return kern.whole_decode(r.dec.Vh, s2, yt, s0, r.sigma2, cap, cfg,
                                 precision)

    failed = []
    mcfg = vamp_main_config()
    snr = snr_of(mcfg, EBN0_DB)
    case = realization(mcfg, FLAGSHIP_B, 27, snr)
    r, yt, s2, s0 = case
    sp = kern.decode_plain(r.dec.Vh, s2, yt, s0, r.sigma2, 10, mcfg, p)
    max_err = compare_vamp(
        f"kernel_main_{algo}_default", kernel(mcfg, case, s0, 10), sp,
        1e-3, failed, "mean_T_only", cap=10)
    # the HIGH instance under the same rule: VAMP's trials stop earlier at
    # one pass, so it must fail there; vamp2 runs every trial to the cap
    # of 10 at every precision
    sh = kernel(mcfg, case, s0, 10, "high")
    dmean = abs(float(sh.T.float().mean() - sp.T.float().mean()))
    emit(f"kernel_main_{algo}_default_high", abs_dmean_T=dmean,
         dmean_T_max=0.2, must_fail=algo == "vamp")
    if algo == "vamp" and dmean <= 0.2:
        failed.append("the HIGH instance passes the mean-T rule")
    del sh, sp
    sound, wrong = vamp_high_control(kern, mcfg, case, kernel, p, "high")
    emit(f"kernel_main_{algo}_default_control", B=FLAGSHIP_B, cap=1,
         statistic=HIGH_CONTROL_STAT, limit=VAMP_DEFAULT_CONTROL_TOL,
         default=sound, high=wrong)
    if not (sound[HIGH_CONTROL_STAT] < VAMP_DEFAULT_CONTROL_TOL
            <= wrong[HIGH_CONTROL_STAT]):
        failed.append("control main")
    del case, r, yt, s0
    torch.cuda.empty_cache()

    case = realization(mcfg, RES, 29, snr)
    r, yt, s2, s0 = case
    out = {}
    ms = cuda_ms(lambda: out.update(k=kernel(mcfg, case, s0, 10)), 1, 3)
    high_ms = cuda_ms(lambda: kernel(mcfg, case, s0, 10, "high"), 1, 3)
    highest_ms = cuda_ms(lambda: kernel(mcfg, case, s0, 10, "highest"), 1, 3)
    plain_ms = cuda_ms(lambda: out.update(p=kern.decode_plain(
        r.dec.Vh, s2, yt, s0, r.sigma2, 10, mcfg, p)), 1, 2)
    s1 = out["k"]
    max_err = max(max_err, compare_vamp(
        f"kernel_phase1_{algo}_default", s1, out.pop("p"), 1e-3, failed,
        "mean_T_only", cap=10))
    iters = int((s1.T.long() - s0.T.long()).sum())
    pp, N = r.dec.Vh.shape
    taps = vamp.gauss_taps(r.dec.Vh)
    rt = s0.r_tilde if algo == "vamp" else s0.r
    xw = torch.zeros((RES, pp), device=dev)
    pairs = [(x.contiguous(), t) for x, t in zip(
        (rt.real + rt.imag, rt.real, rt.imag), taps[:3])]
    pairs += [(xw, t) for t in taps[3:]]
    lib, form = bf16_library(torch, pairs)
    library_iter_ms = cuda_ms(lib, 1, 3)
    library_ms = library_iter_ms * int(s1.T.max())
    del lib, xw, pairs
    state = [getattr(s0, f) for f in s0._fields if f != "t"]
    state += [getattr(s1, f) for f in s1._fields if f != "t"]
    tap_buf = fused_vamp.default_taps(r.dec.Vh)[0]
    # the taps' hi halves, the only ones the DEFAULT instance reads
    nbytes = (sum(t.numel() * t.element_size() for t in state + [yt, s2])
              + tap_buf.numel() * tap_buf.element_size())
    engine = vamp_engine_bytes(torch, fused_vamp, pp, N, s0, s1)
    # one bf16 pass: 3 real products x 2 N p flop, two products
    flop = iters * 12 * N * pp
    bound_ms, bound_by = bound(flop, nbytes, PEAK_BF16_FLOPS)
    timing = dict(kernel=f"fused_vamp{tag}_decode_default", B=RES, cap=10,
                  ms=ms, high_ms=high_ms, highest_ms=highest_ms,
                  plain_ms=plain_ms, default_over_high=ms / high_ms,
                  ns_per_iter_trial=1e6 * ms / iters, iterations=iters,
                  flop=flop, bytes=nbytes, bound_ms=bound_ms,
                  bound_by=bound_by, pct_of_bound=100 * bound_ms / ms,
                  library_ms=library_ms,
                  library_ms_per_iteration=library_iter_ms,
                  library_form=form, ptxas=ptxas_lines,
                  engine_bytes=engine,
                  ptxas_default=instance_ptxas(ptxas_lines, "ILb1ELb1E"))
    emit(f"kernel_timing_{algo}_default", **timing)
    if failed:
        raise AssertionError(f"DEFAULT kernel != plain ({algo}): {failed}")
    return max_err, timing


def phase_main_vamp_default(torch, dev, algo: str):
    """``Simulator(algo=..., precision='default')`` beside 'high' on the
    same seeds: VAMP at the cap-running VAMP OOK point (cap 100), vamp2 at
    its main point (cap 10); 2 realizations of 65536 each; and the same
    DEFAULT run with the kernel's plain DEFAULT version in the wrapper's
    place (``decode_plain(..., 'default')``, the function the CPU tests
    hold to the patched JAX package).  Gates: the DEFAULT run through the
    DEFAULT instance alone (no plain decode); FER (vamp2: BER, whose FER is
    1 in every form) within 3 sigma of the plain DEFAULT run's and mean T
    within 2% of the cap; for vamp2 also BER within 3 sigma of HIGH's
    (BER's sigma from the scatter of ``BAMP_HIGH_BER_GROUPS`` groups of one
    DEFAULT realization's trials).  VAMP's FER beside HIGH's is printed
    with its distance in sigma, not gated: one bf16 pass stops VAMP's
    trials near T = 12 where HIGH runs them to the cap, a different
    decode (PERF.md, section 6).  Returns ``launches_default``."""
    from amp_sparc_spatialmodulation_tpu_torch.models import (
        montecarlo, vamp, vamp2)
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_vamp, fused_vamp2)
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    mod, kern = (vamp, fused_vamp) if algo == "vamp" else (vamp2, fused_vamp2)
    cfg = vamp_main_config(iterations=100 if algo == "vamp" else 10)
    n = DEFAULT_REALIZATIONS

    def counts():
        return dict(launches=kern.launches, launches_high=kern.launches_high,
                    launches_default=kern.launches_default,
                    plain=mod.plain_decodes)

    def zero():
        kern.launches = kern.launches_high = kern.launches_default = 0
        mod.plain_decodes = 0

    sim_of = lambda p: montecarlo.Simulator(
        cfg, algo=algo, device=dev, precision=p, progress=lambda s: None)
    runs = run_precisions(torch, sim_of, EBN0_DB, n * RES, RES, counts,
                          zero, ("high", "default"))
    kernel = kern.whole_decode
    kern.whole_decode = kern.decode_plain
    try:
        runs.update(plain=run_precisions(
            torch, sim_of, EBN0_DB, n * RES, RES, counts, zero,
            ("default",))["default"])
    finally:
        kern.whole_decode = kernel
    d, h, pl = runs["default"], runs["high"], runs["plain"]
    r = montecarlo.with_svd(algo, montecarlo.generate_realization(
        make_generator(dev, 12345), cfg, "sparc", "dense", RES,
        snr_of(cfg, EBN0_DB), "default"))
    out = mod.decode(r.dec, r.y, r.sigma2, cfg, precision="default")
    bsig = ber_sigma(torch, cfg, out, r.msg, RES, n * RES)
    del r, out
    sigma = fer_sigma(pl["avg"]["fer"], n * RES)
    sigma_high = fer_sigma(h["avg"]["fer"], n * RES)
    emit(f"main_{algo}_default", config="vamp_ook_segmented_flagship_dims",
         ebn0_db=EBN0_DB, res=RES, realizations=n, trials=n * RES,
         cap=cfg.N_Layers,
         **flat_runs(runs, ("seconds", "trials_per_s", "mean_T", "mean_fer",
                            "mean_ber", "launches", "launches_high",
                            "launches_default", "plain")),
         default_over_high_trials_per_s=d["trials_per_s"]
         / h["trials_per_s"], fer_sigma_plain=sigma,
         fer_sigma_high=sigma_high,
         fer_sigmas_from_high=abs(d["avg"]["fer"] - h["avg"]["fer"])
         / sigma_high, ber_sigma=bsig)
    if d["launches_default"] <= 0 or d["launches"] or d["launches_high"] \
            or d["plain"]:
        raise AssertionError(f"the {algo} DEFAULT path did not run through "
                             "the DEFAULT kernel alone")
    if abs(d["avg"]["T"] - pl["avg"]["T"]) > 0.02 * cfg.N_Layers:
        raise AssertionError(f"{algo} DEFAULT mean T {d['avg']['T']} vs the "
                             f"plain DEFAULT version's {pl['avg']['T']}")
    if algo == "vamp" and abs(d["avg"]["fer"] - pl["avg"]["fer"]) > 3 * sigma:
        raise AssertionError(f"VAMP DEFAULT FER {d['avg']['fer']} vs the "
                             f"plain DEFAULT version's {pl['avg']['fer']}")
    if algo == "vamp2" and max(abs(d["avg"]["ber"] - pl["avg"]["ber"]),
                               abs(d["avg"]["ber"] - h["avg"]["ber"])) \
            > 3 * bsig:
        raise AssertionError(f"vamp2 DEFAULT BER {d['avg']['ber']} vs HIGH "
                             f"{h['avg']['ber']} and the plain DEFAULT "
                             f"version's {pl['avg']['ber']}")
    return d["launches_default"]


def k5_default_library(torch, op, var, trials, cfg):
    """(ms, form) of K5-default's seven one-pass products of one iteration
    of ``trials`` trials as PyTorch calls on bf16 tensors
    (``bf16_library``): var with S_a2, Re S, Im S - Re S; the adjoint
    inputs (random, of their shape) with S_a2^T, Re S^T, -Im S^T - Re S^T,
    Re S^T - Im S^T."""
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp
    t = bamp.gauss_taps(op)
    rows = trials * cfg.Lin
    xv = var.reshape(rows, cfg.Nt)
    zr = torch.rand(rows, cfg.Lh * cfg.Nr, device=var.device)
    pairs = [(xv, a) for a in (t.s_a2, t.s_re, t.dmc)]
    pairs += [(zr, a) for a in (t.st_a2, t.st_re, t.amc, t.adm)]
    lib, form = bf16_library(torch, pairs)
    return cuda_ms(lib, 2, 10), form


def k5_default_smem(kern) -> dict:
    """Shared memory of each DEFAULT product block, the kernel's against
    the wrapper's mirror."""
    lib = kern._library()
    return {f"{name}_{form}": (lib.fused_bamp_tiled_smem(fwd, small, 2),
                               kern.smem_bytes(bool(fwd), bool(small),
                                               "default"))
            for name, fwd in (("forward", 1), ("adjoint", 0))
            for form, small in (("large", 0), ("small", 1))}


def k5_default_tail(torch, dev, kern, p) -> dict:
    """K5-default at the phase-2 shape: the trials still active after a
    40-iteration DEFAULT phase 1 of 2048 at 18 dB (``tiled_default_tail``
    of tests/torch_kernel_ab.py), gathered; one iteration as the plane loop
    runs it after its first (on the split planes the previous call's
    denoiser wrote) and as a first iteration, by CUDA events, beside the
    HIGH instance (on its own next state), the plain DEFAULT step, its
    bound and its seven one-pass products as PyTorch calls."""
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)
    cfg = massive_main_config()
    r = montecarlo.generate_realization(make_generator(dev, 43), cfg,
                                        "sparc", "banded", MASSIVE_RES,
                                        snr_of(cfg, MASSIVE_EBN0_DB), p)
    s0 = bamp.initial_state(r.y, cfg.N, r.sigma2)
    s1 = bamp.plane_loop(partial(kern.iteration, precision=p), r.A, s0,
                         r.y, r.sigma2, MASSIVE_K1, cfg)
    idx = torch.nonzero(s1.active).flatten()
    if not idx.numel():
        raise AssertionError("no trial left for phase 2 (tiled, DEFAULT)")
    n2 = int(idx.numel())
    ps = bamp.to_planes(montecarlo.state_take_trials(s1, idx))
    y_re, y_im = r.y[idx].real.contiguous(), r.y[idx].imag.contiguous()
    out = {}
    step = lambda q, s=ps: out.update(k=kern.iteration(
        r.A, s, y_re, y_im, r.sigma2, cfg, q))
    ms_split = cuda_ms(lambda: step(p), 2, 20)
    nxt = {}
    for q in (p, "high"):
        step(q)
        nxt[q] = bamp.advance(ps, out["k"])
    ms = cuda_ms(lambda: step(p, nxt[p]), 2, 20)
    high_ms = cuda_ms(lambda: step("high", nxt["high"]), 2, 20)
    plain_ms = cuda_ms(lambda: kern.iteration_plain(
        r.A, nxt[p], y_re, y_im, r.sigma2, cfg, p), 2, 20)
    library_ms, _ = k5_default_library(torch, r.A, nxt[p].var, n2, cfg)
    step(p, nxt[p])
    k = out["k"]
    q = nxt[p]
    flop, nbytes = iteration_work(
        cfg, n2, 7, [q.xm_re, q.var, q.z_re, q.z_im, q.u, y_re, y_im,
                     q.active, kern.default_taps(r.A),
                     *[getattr(k, f) for f in k._fields]])
    bound_ms, bound_by = bound(flop, nbytes, PEAK_BF16_FLOPS)
    W = cfg.Lh * cfg.Nr
    return dict(tail_B=n2, tail_ms=ms, tail_ms_with_split=ms_split,
                tail_high_ms=high_ms, tail_plain_ms=plain_ms,
                tail_library_ms=library_ms, tail_bound_ms=bound_ms,
                tail_bound_by=bound_by,
                tail_pct_of_bound=100 * bound_ms / ms,
                tail_forms=kern.tile_forms(n2, cfg.Lin, W, cfg.Nt, p))


def phase_kernels_tiled_default(torch, dev, ptxas):
    """K5's DEFAULT instance (one bf16 pass) against its plain DEFAULT
    version through ``bamp.plane_loop``, drawn at DEFAULT: the main path's
    8 dB state at 2048 trials (cap 10) and the converging 10 dB shape
    (2048 trials, cap 100) under :func:`compare` with ``K5_DEFAULT_RULES``
    (the state bound on the trials that stopped before the cap in both; the
    HIGH instance must fail the rule where it separates), each with the
    control (``K5_DEFAULT_CONTROL``: one iteration
    from the state after two plain DEFAULT iterations; the HIGH instance's
    reading beside it); the hi-only split planes (the split launch's, the
    fold's, the denoiser's for the next call) bit for bit against their
    layout (``kernel_split_tiled_default``); one iteration at the 8 dB
    state timed by CUDA events as the plane loop runs it (on the split
    planes the previous call's denoiser wrote), beside the HIGH instance
    (on its own next state) and the HIGHEST one, the plain DEFAULT step,
    the bound (7 one-pass products at 989 TFLOP/s, or the bytes; also with
    the hi-only split x and var read and written), those products as
    PyTorch calls on bf16 tensors, the launches timed apart, the bytes the
    product ring copies into shared memory (``engine_bytes``), each
    product block's shared memory against the wrapper's mirror and the
    DEFAULT instances' ptxas lines; the same at the phase-2 shape
    (``k5_default_tail``)."""
    import dataclasses

    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_bamp_tiled as kern)
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    p = "default"
    failed, max_err = [], 0.0
    mcfg = dataclasses.replace(massive_main_config(),
                               iterations=MASSIVE_HIGH_CAP)

    def realization(seed, db):
        r = montecarlo.generate_realization(make_generator(dev, seed), mcfg,
                                            "sparc", "banded", MASSIVE_RES,
                                            snr_of(mcfg, db), p)
        return r, bamp.initial_state(r.y, mcfg.N, r.sigma2)

    def run(r, s0, cap, precision=p):
        return bamp.plane_loop(partial(kern.iteration, precision=precision),
                               r.A, s0, r.y, r.sigma2, cap, mcfg)

    for name, seed, db in (("massive_8db", 45, MASSIVE_HIGH_DB),
                           ("massive_10db", 44, MASSIVE_CONVERGING_DB)):
        r, s0 = realization(seed, db)
        cap, min_agree, max_dmean, tol, separates = K5_DEFAULT_RULES[name]
        sk = run(r, s0, cap)
        sp = kern.decode_plain(r.A, s0, r.y, r.sigma2, cap, mcfg, p)
        max_err = max(max_err, compare(
            "kernel_main_tiled_default", sk, sp, tol, free_unconverged=True,
            min_agree=min_agree, max_dmean_T=max_dmean, case=name, cap=cap,
            ebn0_db=db, stopped_within_1e4=stopped_share(sk, sp)))
        sh = run(r, s0, cap, "high")
        frac, dmean, inside = rule_passes(sh, sp, min_agree, max_dmean)
        emit("kernel_main_tiled_default_high", case=name,
             T_agree_fraction=frac, abs_dmean_T=dmean, inside_rule=inside,
             must_fail=separates)
        if separates and inside:
            failed.append(f"{name}: the HIGH instance passes the rule")
        del sk, sp, sh
        ps = bamp.to_planes(kern.decode_plain(
            r.A, s0, r.y, r.sigma2, s0.t + K5_HIGH_PRESTEPS, mcfg, p))
        y_re, y_im = r.y.real.contiguous(), r.y.imag.contiguous()
        one = kern.iteration_plain(r.A, ps, y_re, y_im, r.sigma2, mcfg, p)
        gate_control(failed, "kernel_main_tiled_default_control",
                     iter_gap(kern.iteration(r.A, ps, y_re, y_im, r.sigma2,
                                             mcfg, p), one, ps.active),
                     iter_gap(kern.iteration(r.A, ps, y_re, y_im, r.sigma2,
                                             mcfg, "high"), one, ps.active),
                     K5_DEFAULT_CONTROL, "z_re_p50", case=name,
                     presteps=K5_HIGH_PRESTEPS)
        if name != "massive_8db":
            del r, s0, ps, one
            continue
        A, B, W = r.A, MASSIVE_RES, mcfg.Lh * mcfg.Nr
        # the split planes against their layout: the split launch's, the
        # fold's, and those the denoiser writes for the next call
        split = k5_high_split_check(kern, A, ps, y_re, y_im, r.sigma2, mcfg,
                                    precision=p)
        out = {}
        step = lambda q, s=ps: out.update(k=kern.iteration(
            A, s, y_re, y_im, r.sigma2, mcfg, q))
        ms_split = cuda_ms(lambda: step(p), 2, 10)
        # the plane loop's next state of each form: its call takes the split
        # planes its predecessor's denoiser wrote (each form its own layout)
        nxt = {}
        for q in (p, "high"):
            step(q)
            nxt[q] = bamp.advance(ps, out["k"])
        step(p, nxt[p])
        kept = kern.kept_split(nxt[p], p)
        split["kept_x_var"] = kept is not None and k5_high_split_check(
            kern, A, nxt[p], y_re, y_im, r.sigma2, mcfg, kept, p)["x_var"]
        emit("kernel_split_tiled_default", **split)
        if not all(split.values()):
            failed.append(f"split operand planes: {split}")
        ms = cuda_ms(lambda: step(p, nxt[p]), 2, 10)
        high_ms = cuda_ms(lambda: step("high", nxt["high"]), 2, 10)
        highest_ms = cuda_ms(lambda: step("highest", nxt[p]), 2, 10)
        ms_again = cuda_ms(lambda: step(p, nxt[p]), 2, 10)
        ps = nxt[p]
        plain_ms = cuda_ms(lambda: kern.iteration_plain(
            A, ps, y_re, y_im, r.sigma2, mcfg, p), 1, 3)
        library_ms, form = k5_default_library(torch, A, ps.var, B, mcfg)
        step(p, ps)
        k = out["k"]
        taps = kern.default_taps(A)
        planes = [ps.xm_re, ps.var, ps.z_re, ps.z_im, ps.u, y_re, y_im,
                  ps.active, taps, k.xmap_re, k.xmap_im, k.xm_re, k.var,
                  k.z_re, k.z_im, k.u, k.notok]
        flop, nbytes = iteration_work(mcfg, B, 7, planes)
        bound_ms, bound_by = bound(flop, nbytes, PEAK_BF16_FLOPS)
        # with the hi-only split x and var the call reads (its
        # predecessor's) and writes (for its successor)
        split_bytes = 2 * 2 * kern.split_sizes(B, mcfg, p)[0]
        bound_split_ms, _ = bound(flop, nbytes + split_bytes,
                                  PEAK_BF16_FLOPS)
        tail = k5_default_tail(torch, dev, kern, p)
        timing = dict(kernel="fused_bamp_tiled_default", B=B, ebn0_db=db,
                      ms=ms, ms_again=ms_again, ms_with_split=ms_split,
                      high_ms=high_ms, highest_ms=highest_ms,
                      default_over_high=ms / high_ms,
                      plain_ms=plain_ms, library_ms=library_ms,
                      library_form=form, flop=flop, bytes=nbytes,
                      bound_ms=bound_ms, bound_by=bound_by,
                      pct_of_bound=100 * bound_ms / ms,
                      split_bytes=split_bytes,
                      bound_with_split_ms=bound_split_ms,
                      stage_ms=kern.stage_ms(A, ps, y_re, y_im, r.sigma2,
                                             mcfg, precision=p),
                      forms=kern.tile_forms(B, mcfg.Lin, W, mcfg.Nt, p),
                      engine_bytes=kern.engine_bytes(B, mcfg, p),
                      smem_bytes=k5_default_smem(kern),
                      **tail,
                      ptxas_default=[ln for e in ptxas_entries(
                          ptxas, "default_product_kernel") for ln in e],
                      ptxas=list(ptxas))
        emit("kernel_timing_tiled_default", **timing)
        if any(c != w for c, w in timing["smem_bytes"].values()):
            failed.append(f"shared memory differs from the wrapper's: "
                          f"{timing['smem_bytes']}")
        del r, s0, ps, one, out, k, nxt
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"K5 DEFAULT kernel != plain: {failed}")
    return max_err, timing


def phase_main_massive_default(torch, dev):
    """``Simulator(massive_mimo(), algo='bamp', precision='default')``
    beside 'high' on the same seeds at 8 dB, cap 100, single phase (every
    trial at the cap), 2 realizations of 2048.  Gates: the DEFAULT run
    through K5's DEFAULT instance alone (no other kernel, no plain
    decode), FER within 3 sigma of HIGH's (binomial, HIGH's count, at
    least one error).  Returns ``launches_default``."""
    import dataclasses

    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_bamp, fused_bamp_iteration as fbi, fused_bamp_tiled as kern)

    cfg = dataclasses.replace(massive_main_config(),
                              iterations=MASSIVE_HIGH_CAP)
    n, res = DEFAULT_REALIZATIONS, MASSIVE_RES

    def counts():
        return dict(launches=kern.launches, launches_high=kern.launches_high,
                    launches_default=kern.launches_default,
                    others=(fused_bamp.launches + fused_bamp.launches_high
                            + fused_bamp.launches_default
                            + fbi.fused_launches),
                    plain=bamp.plain_decodes)

    def zero():
        kern.launches = kern.launches_high = kern.launches_default = 0
        fused_bamp.launches = fused_bamp.launches_high = 0
        fused_bamp.launches_default = fbi.fused_launches = 0
        bamp.plain_decodes = 0

    runs = run_precisions(torch, lambda p: montecarlo.Simulator(
        cfg, algo="bamp", device=dev, precision=p, progress=lambda s: None),
        MASSIVE_HIGH_DB, n * res, res, counts, zero, ("high", "default"))
    d, h = runs["default"], runs["high"]
    sigma = fer_sigma(h["avg"]["fer"], n * res)
    emit("main_massive_default", config="massive_mimo",
         ebn0_db=MASSIVE_HIGH_DB, res=res, realizations=n, trials=n * res,
         cap=cfg.N_Layers,
         **flat_runs(runs, ("seconds", "trials_per_s", "mean_T", "mean_fer",
                            "mean_ber", "launches", "launches_high",
                            "launches_default", "others", "plain")),
         default_over_high_trials_per_s=d["trials_per_s"]
         / h["trials_per_s"], fer_sigma=sigma)
    if (d["launches_default"] < n * d["avg"]["T"] or d["launches"]
            or d["launches_high"] or d["others"] or d["plain"]):
        raise AssertionError("the massive DEFAULT path did not run through "
                             "K5's DEFAULT instance alone")
    if abs(d["avg"]["fer"] - h["avg"]["fer"]) > 3 * sigma:
        raise AssertionError(f"massive DEFAULT FER {d['avg']['fer']} vs "
                             f"HIGH {h['avg']['fer']}")
    return d["launches_default"]


# K1's split forms (AMP_KERNEL_XMAP_PRECISION): the six (variance chain,
# xmap chain) precision pairs off the diagonal, the two that users set the
# variable for first.
XMAP_PAIRS = (("highest", "high"), ("highest", "default"),
              ("high", "default"), ("high", "highest"),
              ("default", "high"), ("default", "highest"))
XMAP_VAR = "AMP_KERNEL_XMAP_PRECISION"
# kernels_bamp_xmap's rule per shape (T agreement, |d mean T|, the state
# bound on the trials that stopped before the cap in both; at the OOK
# phase-1 shape the form at the variance chain's precision, a wrong xmap
# chain, must fail it) and the control's limits (one iteration from the
# state after two plain split iterations, the medians |d xmap|, |d z|,
# |d u| of the split instance against the plain split version; that form
# must exceed the xmap limit).  The readings behind them
# (tests/torch_bamp_high_rule.py --split, NVIDIA H100 80GB HBM3, 700 W;
# split instance / plain split with float64 sums / the form), OOK phase 1:
# - T agreement 97.73 / 97.64 / 95.25% (highest:high), 99.21 / 98.97 /
#   81.30% (highest:default), 99.05 / 99.24 / 82.50% (high:default), 99.44
#   / 99.01 / 95.18% (high:highest), 97.54 / 97.59 / 81.17% (default:high),
#   99.30 / 98.81 / 79.54% (default:highest);
# - |d mean T| at most 0.0013 / 0.0028 against at least 0.0328 for a form;
# - the state of two correct decodes at most 1.10e-3 (a 'default' xmap
#   chain; 99.42% of the stopped trials within 1e-4), 1.4e-4 otherwise;
# QPSK 5 dB, cap 100: every trial at the cap in every decode (99.85% for
# the float64 sums of high:highest), so the control holds it.  Control:
# xmap 3.0e-8 to 6.7e-7, z 6.0e-8 to 1.2e-7, u at most 6.0e-8 for the
# split instance and the float64 sums; the form's xmap 2.72e-6 (OOK) and
# 3.69e-6 (QPSK) where the chains part by HIGH against HIGHEST, 1.45e-3 /
# 1.97e-3 where one of them is DEFAULT.
XMAP_RULES = {"ook_phase1": (0.965, 0.02, 3e-3, True),
              "qpsk_cap100": (0.995, 0.02, 1e-4, False)}
XMAP_CONTROL = {"xmap_p50": 1.5e-6, "z_p50": 5e-7, "u_p50": 1e-6}
# main_bamp_xmap: realizations of 65536 per run at the flagship OOK point
# for the two user pairs and the forms beside them; the other four pairs
# on XMAP_OTHER_REALIZATIONS each.
XMAP_REALIZATIONS = 16
XMAP_OTHER_REALIZATIONS = 2


def xmap_env(value):
    """Set ``AMP_KERNEL_XMAP_PRECISION`` to ``value`` (None: unset); returns
    a function that puts back what was there."""
    import os
    old = os.environ.get(XMAP_VAR)

    def put(v):
        if v is None:
            os.environ.pop(XMAP_VAR, None)
        else:
            os.environ[XMAP_VAR] = v

    put(value)
    return lambda: put(old)


def split_work(cfg, s0, s1, tensors, precision, x_precision):
    """(flop, bytes, iterations, bound ms, bound_by) of a split decode:
    the variance chain's 2 real products and the xmap chain's 5 (a real x)
    or 6 per iteration, an FP32 chain's at the FP32 peak, a bf16 chain's 3
    or 1 passes at the bf16 peak; every input read once, every output
    written once."""
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    nx = 5 if fused_bamp.real_x(cfg) else 6
    t_ops, flop = 0.0, 0
    for p, n in ((precision, 2), (x_precision, nx)):
        f, nbytes, iters = decode_work(cfg, s0, s1, tensors, n)
        passes, peak = {"highest": (1, PEAK_FP32_FLOPS),
                        "high": (3, PEAK_BF16_FLOPS),
                        "default": (1, PEAK_BF16_FLOPS)}[p]
        flop += passes * f
        t_ops += passes * f / peak
    t_bytes = nbytes / PEAK_HBM_BYTES
    return (flop, nbytes, iters, 1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def split_library(torch, cfg, op, xv, zr, precision, x_precision):
    """(function, bf16 form) of a split decode's products of one iteration
    of every trial as PyTorch calls: an FP32 chain's as torch.matmul in
    FP32, a bf16 chain's on bf16 tensors (``bf16_library``), three per
    product at 'high' (hi x hi, hi x lo, lo x hi), one at 'default'."""
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp
    from amp_sparc_spatialmodulation_tpu_torch.ops import precision as prec
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    t = bamp.gauss_taps(op)
    xplanes = (t.s_re, t.dmc) + (() if fused_bamp.real_x(cfg) else (t.cpd,))
    chains = ((precision, [(xv, t.s_a2), (zr, t.st_a2)]),
              (x_precision, [(xv, a) for a in xplanes]
               + [(zr, a) for a in (t.st_re, t.amc, t.adm)]))
    fp32, bf16 = [], []
    for p, pairs in chains:
        for x, a in pairs:
            if p == "highest":
                fp32.append((x, a))
            elif p == "default":
                bf16.append((x, a))
            else:
                (xh, xl), (ah, al) = prec.split_bf16(x), prec.split_bf16(a)
                bf16 += [(xh.float(), ah.float()), (xh.float(), al.float()),
                         (xl.float(), ah.float())]
    lib, form = bf16_library(torch, bf16)

    def run():
        for x, a in fp32:
            torch.matmul(x, a)
        lib()

    return run, form


def phase_kernels_bamp_xmap(torch, dev, ptxas_lines):
    """K1's six split instances (``AMP_KERNEL_XMAP_PRECISION``: the variance
    chain at ``precision``, the xmap chain at the variable's) against their
    plain version (``fused_bamp.decode_plain_split``): on four small
    geometries of ``kernels_bamp_high`` at 1024 trials (trunc with
    column-dependent gains, cyclic, 8PSK, the random mode's mixture
    denoiser) under its small rule, then at the QPSK flagship, 5 dB, cap
    100 (4096 trials, main_bamp_high's point) and the OOK flagship's
    phase-1 shape (65536 trials, cap 12, 8 dB), drawn at the variance
    chain's precision.  Each under :func:`compare` with the shape's rule
    (``XMAP_RULES``; at the OOK shape the form at the variance chain's
    precision must fail it) and the one-iteration control
    (``XMAP_CONTROL``; that form must fail it too), then timed by CUDA
    events beside that form, with the plain split version's time, the
    bound (:func:`split_work`) and the same products as PyTorch calls
    (:func:`split_library`).  Returns {pair:
    (largest state error, [timings, the QPSK shape first])}."""
    from amp_sparc_spatialmodulation_tpu_torch.config import (
        Config, flagship_bamp_ook, flagship_bamp_qpsk)
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import fused_bamp
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    failed = []
    errs = dict.fromkeys(XMAP_PAIRS, 0.0)
    times = {pair: [] for pair in XMAP_PAIRS}
    # the small geometries of kernels_bamp_high that reach the other
    # branches (column-dependent gains, cyclic, 8PSK's general K, the
    # mixture denoiser), 1024 trials, under its small rule
    small = dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, mode="segmented",
                 profile="uniform")
    for i, (name, kw, snr_exp) in enumerate((
            ("ook_trunc", dict(alphabet="OOK", trunc="trunc",
                               iterations=12), 1.2),
            ("ook_cyclic", dict(alphabet="OOK", trunc="cyclic",
                                iterations=12), 1.2),
            ("8psk_tail", dict(alphabet="8PSK", trunc="tail",
                               iterations=10), 1.6),
            ("random_qpsk", dict(alphabet="QPSK", trunc="tail",
                                 iterations=10, mode="random"), 1.4))):
        cfg = Config(**{**small, **kw})
        r = montecarlo.generate_realization(
            make_generator(dev, 200 + i), cfg,
            "toeplitz" if cfg.mode == "random" else "sparc", "banded",
            SMALL_B, 10 ** snr_exp)
        s0 = bamp.initial_state(r.y, cfg.N, r.sigma2)
        cap = cfg.N_Layers
        for v, x in XMAP_PAIRS:
            sk = fused_bamp.whole_decode(r.A, s0, r.y, r.sigma2, cap, cfg,
                                         v, x)
            sp = fused_bamp.decode_plain_split(r.A, s0, r.y, r.sigma2, cap,
                                               cfg, v, x)
            err = compare(
                "kernel_small_bamp_xmap", sk, sp, 1e-4,
                free_unconverged=True,
                min_agree=BAMP_HIGH_SMALL_RULE["min_agree"],
                max_dmean_T=BAMP_HIGH_SMALL_RULE["dmean_T_of_cap"] * cap,
                cap=cap, case=name, pair=f"{v}:{x}")
            errs[(v, x)] = max(errs[(v, x)], err)
    for name, cfg, B, cap, ebn0, seed in (
            ("qpsk_cap100", flagship_bamp_qpsk(), FLAGSHIP_B, 100,
             BAMP_HIGH_EBN0_DB, 42),
            ("ook_phase1", flagship_bamp_ook(), RES, K1, EBN0_DB, 41)):
        min_agree, max_dmean, tol, separates = XMAP_RULES[name]
        for v in ("highest", "high", "default"):
            r = montecarlo.generate_realization(
                make_generator(dev, seed), cfg, "sparc", "banded", B,
                snr_of(cfg, ebn0), v)
            op, y, s2 = r.A, r.y, r.sigma2
            s0 = bamp.initial_state(y, cfg.N, s2)
            form_ms = None
            for x in [x for vv, x in XMAP_PAIRS if vv == v]:
                pair = (v, x)
                split = lambda s, c: fused_bamp.whole_decode(
                    op, s, y, s2, c, cfg, v, x)
                form = lambda s, c: fused_bamp.whole_decode(
                    op, s, y, s2, c, cfg, v)
                plain = lambda s, c: fused_bamp.decode_plain_split(
                    op, s, y, s2, c, cfg, v, x)
                s1, sp = split(s0, cap), plain(s0, cap)
                err = compare(
                    "kernel_main_bamp_xmap", s1, sp, tol,
                    free_unconverged=True, min_agree=min_agree,
                    max_dmean_T=max_dmean, case=name, pair=f"{v}:{x}",
                    cap=cap, ebn0_db=ebn0,
                    stopped_within_1e4=stopped_share(s1, sp))
                if separates:
                    frac, dmean, inside = rule_passes(form(s0, cap), sp,
                                                      min_agree, max_dmean)
                    emit("kernel_main_bamp_xmap_form", case=name,
                         pair=f"{v}:{x}", T_agree_fraction=frac,
                         abs_dmean_T=dmean, inside_rule=inside)
                    if inside:
                        failed.append(f"{name} {v}:{x}: the form at {v} "
                                      "passes the rule")
                del sp
                ps = plain(s0, 2)
                one = plain(ps, 3)
                gate_control(failed, "kernel_main_bamp_xmap_control",
                             vamp_gap(split(ps, 3), one),
                             vamp_gap(form(ps, 3), one), XMAP_CONTROL,
                             "xmap_p50", case=name, pair=f"{v}:{x}",
                             presteps=2)
                del ps, one
                ms = cuda_ms(lambda: split(s0, cap), 0, 2)
                if form_ms is None:
                    form_ms = cuda_ms(lambda: form(s0, cap), 0, 2)
                plain_ms = cuda_ms(lambda: plain(s0, cap), 0, 1)
                tensors = [getattr(s0, f) for f in s0._fields if f != "t"]
                tensors += [getattr(s1, f) for f in s1._fields if f != "t"]
                tensors += [y] + k1_form_taps(cfg, op, v, x)
                if "highest" in pair:
                    tensors.append(fused_bamp.fp32_taps(op))
                flop, nbytes, iters, bound_ms, bound_by = split_work(
                    cfg, s0, s1, tensors, v, x)
                rows, W = B * cfg.Lin, cfg.Lh * cfg.Nr
                lib, lib_form = split_library(
                    torch, cfg, op, s1.var.reshape(rows, cfg.Nt),
                    torch.rand(rows, W, device=dev), v, x)
                library_iter_ms = cuda_ms(lib, 1, 3)
                del lib
                timing = dict(kernel=f"fused_bamp_decode_xmap_{v}_{x}",
                              case=name, pair=f"{v}:{x}", B=B, cap=cap,
                              ms=ms, form_ms=form_ms, plain_ms=plain_ms,
                              split_over_form=ms / form_ms,
                              ns_per_iter_trial=1e6 * ms / iters,
                              iterations=iters, flop=flop, bytes=nbytes,
                              bound_ms=bound_ms, bound_by=bound_by,
                              pct_of_bound=100 * bound_ms / ms,
                              library_ms=library_iter_ms * iters / B,
                              library_ms_per_iteration=library_iter_ms,
                              library_form=lib_form,
                              smem_bytes=fused_bamp.smem_bytes(cfg, v, x),
                              threads=fused_bamp.high_threads(cfg),
                              tap_bytes=k1_tap_stream(cfg, iters, v, x),
                              ptxas_instance=instance_ptxas(
                                  ptxas_lines, k1_instance(cfg, v, x)),
                              ptxas=ptxas_lines)
                emit("kernel_timing_bamp_xmap", **timing)
                errs[pair] = max(errs[pair], err)
                times[pair].append(timing)
                del s1, tensors
            del r, op, y, s0
            torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"K1 split kernel != plain: {failed}")
    for pair in XMAP_PAIRS:
        errs[pair] = max(errs[pair], k1_wide_checks(torch, dev, *pair))
    return {pair: (errs[pair], times[pair]) for pair in XMAP_PAIRS}


def phase_main_bamp_xmap(torch, dev):
    """``Simulator(flagship_bamp_ook(), algo='bamp', precision='highest')``
    at 8 dB, two-phase k1 = 12, with ``AMP_KERNEL_XMAP_PRECISION`` set to
    'high' and to 'default', beside 'highest' and 'default' with it unset,
    on the same seeds (``XMAP_REALIZATIONS`` of 65536 each): trials/s,
    FER, BER and mean T of each; each split run through ``launches_xmap``
    alone (no other K1 form, no other kernel, no plain decode), FER and BER
    within 3 sigma of HIGHEST's (sigma as main_bamp_high takes them);
    mean T printed, not gated.  Then each of the other four pairs
    (precision 'high' or 'default' with the variable set to another
    precision) over ``XMAP_OTHER_REALIZATIONS``, through ``launches_xmap``
    alone.  Returns {pair: launches_xmap of its run}."""
    from amp_sparc_spatialmodulation_tpu_torch.config import (
        flagship_bamp_ook)
    from amp_sparc_spatialmodulation_tpu_torch.models import bamp, montecarlo
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
        fused_bamp, fused_bamp_iteration as fbi, fused_bamp_tiled)
    from amp_sparc_spatialmodulation_tpu_torch.utils.device import (
        make_generator)

    def counts():
        return dict(launches=fused_bamp.launches,
                    launches_high=fused_bamp.launches_high,
                    launches_default=fused_bamp.launches_default,
                    launches_xmap=fused_bamp.launches_xmap,
                    others=(fbi.fused_launches + fused_bamp_tiled.launches
                            + fused_bamp_tiled.launches_high
                            + fused_bamp_tiled.launches_default),
                    plain=bamp.plain_decodes)

    def zero():
        fused_bamp.launches = fused_bamp.launches_high = 0
        fused_bamp.launches_default = fused_bamp.launches_xmap = 0
        fbi.fused_launches = fused_bamp_tiled.launches = 0
        fused_bamp_tiled.launches_high = 0
        fused_bamp_tiled.launches_default = bamp.plain_decodes = 0

    def run(precision, x, n):
        restore = xmap_env(x)
        try:
            return run_precisions(torch, lambda p: montecarlo.Simulator(
                cfg, algo="bamp", device=dev, precision=p, two_phase=K1,
                progress=lambda s: None), EBN0_DB, n * RES, RES, counts,
                zero, (precision,))[precision]
        finally:
            restore()

    split_path = lambda r: r["launches_xmap"] > 0 and not (
        r["launches"] or r["launches_high"] or r["launches_default"]
        or r["others"] or r["plain"])
    cfg, n = flagship_bamp_ook(), XMAP_REALIZATIONS
    runs = {"highest": run("highest", None, n),
            "highest_x_high": run("highest", "high", n),
            "highest_x_default": run("highest", "default", n),
            "default": run("default", None, n)}
    restore = xmap_env(None)
    try:
        r = montecarlo.generate_realization(
            make_generator(dev, 12345), cfg, "sparc", "banded", RES,
            snr_of(cfg, EBN0_DB), "highest")
        out = bamp.decode(r.A, r.y, r.sigma2, cfg)
        bsig = ber_sigma(torch, cfg, out, r.msg, RES, n * RES)
        del r, out
    finally:
        restore()
    hs = runs["highest"]
    sigma = fer_sigma(hs["avg"]["fer"], n * RES)
    keys = ("seconds", "trials_per_s", "mean_T", "mean_fer", "mean_ber",
            "launches", "launches_high", "launches_default",
            "launches_xmap", "others", "plain")
    emit("main_bamp_xmap", config="flagship_bamp_ook", ebn0_db=EBN0_DB,
         res=RES, realizations=n, trials=n * RES, k1=K1, cap=cfg.N_Layers,
         **flat_runs(runs, keys), fer_sigma=sigma, ber_sigma=bsig,
         **{f"{k}_over_highest_trials_per_s":
            runs[k]["trials_per_s"] / hs["trials_per_s"] for k in runs})
    launches = {}
    for k, pair in (("highest_x_high", ("highest", "high")),
                    ("highest_x_default", ("highest", "default"))):
        d = runs[k]
        if not split_path(d):
            raise AssertionError(f"main_bamp_xmap {k} did not run through "
                                 "K1's split instance alone")
        if abs(d["avg"]["fer"] - hs["avg"]["fer"]) > 3 * sigma:
            raise AssertionError(f"main_bamp_xmap {k} FER {d['avg']['fer']}"
                                 f" vs HIGHEST {hs['avg']['fer']}")
        if abs(d["avg"]["ber"] - hs["avg"]["ber"]) > 3 * bsig:
            raise AssertionError(f"main_bamp_xmap {k} BER {d['avg']['ber']}"
                                 f" vs HIGHEST {hs['avg']['ber']}")
        launches[pair] = d["launches_xmap"]
    others = {}
    for v, x in XMAP_PAIRS[2:]:
        d = run(v, x, XMAP_OTHER_REALIZATIONS)
        others[f"{v}_x_{x}"] = d
        if not split_path(d):
            raise AssertionError(f"main_bamp_xmap {v}:{x} did not run "
                                 "through K1's split instance alone")
        launches[(v, x)] = d["launches_xmap"]
    emit("main_bamp_xmap_other_pairs", config="flagship_bamp_ook",
         ebn0_db=EBN0_DB, res=RES, realizations=XMAP_OTHER_REALIZATIONS,
         k1=K1, **flat_runs(others, keys))
    return launches


def kernel_entry(name, replaces, launches, max_err, timing, source=None):
    return {"name": name, "route": "cuda",
            "source": "amp_sparc_spatialmodulation_tpu_torch/ops/kernels/"
                      f"csrc/{source or name}.cu",
            "replaces": f"amp_sparc_spatialmodulation_tpu/ops/pallas/"
                        f"{replaces}",
            "launches": launches, "max_abs_err": max_err,
            "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
            "library_ms": timing.get("library_ms")}


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

    def ptxas(name, entries=False):
        words = ("registers", "spill") + (("Compiling entry",) if entries
                                          else ())
        return [ln.strip() for ln in report[name]["ptxas"].splitlines()
                if any(w in ln for w in words)]

    max_err, timing = phase_kernels(torch, dev, ptxas("fused_bamp_decode"))
    launches = phase_main(torch, dev)
    max_err2, timing2 = phase_kernels_scamp(torch, dev,
                                            ptxas("fused_scamp_decode"))
    launches2 = phase_main_scamp(torch, dev)
    torch.cuda.empty_cache()
    max_err3, timing3 = phase_kernels_vamp(torch, dev, "vamp")
    torch.cuda.empty_cache()
    max_err4, timing4 = phase_kernels_vamp(torch, dev, "vamp2")
    torch.cuda.empty_cache()
    launches3 = phase_main_vamp(torch, dev, "vamp")
    launches4 = phase_main_vamp(torch, dev, "vamp2")
    torch.cuda.empty_cache()
    t_high = time.perf_counter()
    max_err3h, timing3h = phase_kernels_vamp_high(
        torch, dev, "vamp", ptxas("fused_vamp_decode", entries=True))
    torch.cuda.empty_cache()
    max_err4h, timing4h = phase_kernels_vamp_high(
        torch, dev, "vamp2", ptxas("fused_vamp2_decode", entries=True))
    torch.cuda.empty_cache()
    launches3h = phase_main_vamp_high(torch, dev, "vamp")
    torch.cuda.empty_cache()
    launches4h = phase_main_vamp_high(torch, dev, "vamp2")
    torch.cuda.empty_cache()
    emit("high_phases", seconds=time.perf_counter() - t_high)
    t_high = time.perf_counter()
    max_err1h, (timing1h, _) = phase_kernels_bamp_high(
        torch, dev, ptxas("fused_bamp_decode", entries=True))
    torch.cuda.empty_cache()
    launches1h = phase_main_bamp_high(torch, dev)
    torch.cuda.empty_cache()
    emit("bamp_high_phases", seconds=time.perf_counter() - t_high)
    t0 = time.perf_counter()
    max_err5, timing5 = phase_kernels_tiled(
        torch, dev, ptxas("fused_bamp_tiled", entries=True))
    torch.cuda.empty_cache()
    k6, k7 = phase_kernels_periter(torch, dev,
                                   ptxas("fused_bamp_iteration"))
    torch.cuda.empty_cache()
    launches5 = phase_main_massive(torch, dev)
    emit("new_phases", seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    max_err5h, timing5h = phase_kernels_tiled_high(
        torch, dev, ptxas("fused_bamp_tiled", entries=True))
    torch.cuda.empty_cache()
    launches5h = phase_main_massive_high(torch, dev)
    emit("tiled_high_phases", seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    max_err1d, (timing1d, _) = phase_kernels_bamp_default(
        torch, dev, ptxas("fused_bamp_decode", entries=True))
    torch.cuda.empty_cache()
    launches1d = phase_main_bamp_default(torch, dev)
    torch.cuda.empty_cache()
    max_err3d, timing3d = phase_kernels_vamp_default(
        torch, dev, "vamp", ptxas("fused_vamp_decode", entries=True))
    torch.cuda.empty_cache()
    max_err4d, timing4d = phase_kernels_vamp_default(
        torch, dev, "vamp2", ptxas("fused_vamp2_decode", entries=True))
    torch.cuda.empty_cache()
    launches3d = phase_main_vamp_default(torch, dev, "vamp")
    torch.cuda.empty_cache()
    launches4d = phase_main_vamp_default(torch, dev, "vamp2")
    torch.cuda.empty_cache()
    max_err5d, timing5d = phase_kernels_tiled_default(
        torch, dev, ptxas("fused_bamp_tiled", entries=True))
    torch.cuda.empty_cache()
    launches5d = phase_main_massive_default(torch, dev)
    emit("default_phases", seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    xmap_checks = phase_kernels_bamp_xmap(
        torch, dev, ptxas("fused_bamp_decode", entries=True))
    torch.cuda.empty_cache()
    xmap_launches = phase_main_bamp_xmap(torch, dev)
    torch.cuda.empty_cache()
    emit("xmap_phases", seconds=time.perf_counter() - t0)
    for pair in (("high", "default"), ("default", "high")):
        emit("kernel_timing_bamp_xmap_mixed", pair=":".join(pair),
             launches=xmap_launches[pair], **{
                 f"{t['case']}_{k}": t[k] for t in xmap_checks[pair][1]
                 for k in ("ms", "bound_ms", "bound_by", "library_ms",
                           "plain_ms", "form_ms")})
    t0 = time.perf_counter()
    cluster_timings = phase_kernel_cluster_bamp(torch, dev)
    torch.cuda.empty_cache()
    cluster_launches, cluster_timing = phase_main_bamp_wide(torch, dev)
    torch.cuda.empty_cache()
    emit("wide_phases", seconds=time.perf_counter() - t0,
         forced_clusters=len(cluster_timings))
    t0 = time.perf_counter()
    phase_main_auto_k1(torch, dev)
    phase_main_plain(torch, dev)
    torch.cuda.empty_cache()
    phase_main_plain_high(torch, dev)
    torch.cuda.empty_cache()
    emit("sweep_engine_phases", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    sharded_bamp = phase_main_sharded(torch, dev)
    torch.cuda.empty_cache()
    phase_main_cli_sharded(torch, dev, sharded_bamp)
    phase_main_model_axis(torch, dev)
    torch.cuda.empty_cache()
    emit("sharded_phases", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_main_sparc_trial(torch, dev)
    phase_main_capacity(torch, dev)
    torch.cuda.empty_cache()
    phase_main_profiling(torch, dev)
    emit("analysis_phases", seconds=time.perf_counter() - t0)

    print(json.dumps({"kernels": [
        kernel_entry("fused_bamp_decode", "fused_bamp.py:617", launches,
                     max_err, timing),
        kernel_entry("fused_bamp_decode_high", "fused_bamp.py:617",
                     launches1h, max_err1h, timing1h,
                     source="fused_bamp_decode"),
        kernel_entry("fused_scamp_decode", "fused_scamp.py:112", launches2,
                     max_err2, timing2),
        kernel_entry("fused_vamp_decode", "fused_vamp.py:73", launches3,
                     max_err3, timing3),
        kernel_entry("fused_vamp2_decode", "fused_vamp2.py:39", launches4,
                     max_err4, timing4),
        kernel_entry("fused_vamp_decode_high", "fused_vamp.py:73", launches3h,
                     max_err3h, timing3h, source="fused_vamp_decode"),
        kernel_entry("fused_vamp2_decode_high", "fused_vamp2.py:39",
                     launches4h, max_err4h, timing4h,
                     source="fused_vamp2_decode"),
        kernel_entry("fused_bamp_tiled", "fused_bamp_tiled.py:47",
                     launches5, max_err5, timing5),
        kernel_entry("fused_bamp_tiled_high", "fused_bamp_tiled.py:47",
                     launches5h, max_err5h, timing5h,
                     source="fused_bamp_tiled"),
        kernel_entry("fused_bamp_decode_default", "fused_bamp.py:617",
                     launches1d, max_err1d, timing1d,
                     source="fused_bamp_decode"),
        kernel_entry("fused_vamp_decode_default", "fused_vamp.py:73",
                     launches3d, max_err3d, timing3d,
                     source="fused_vamp_decode"),
        kernel_entry("fused_vamp2_decode_default", "fused_vamp2.py:39",
                     launches4d, max_err4d, timing4d,
                     source="fused_vamp2_decode"),
        kernel_entry("fused_bamp_tiled_default", "fused_bamp_tiled.py:47",
                     launches5d, max_err5d, timing5d,
                     source="fused_bamp_tiled"),
        kernel_entry("fused_bamp_iteration_fused", "fused_bamp.py:567",
                     k6[2], k6[0], k6[1], source="fused_bamp_iteration"),
        kernel_entry("fused_bamp_iteration_linear", "fused_bamp.py:359",
                     k7[2], k7[0], k7[1], source="fused_bamp_iteration")]
        + [kernel_entry(f"fused_bamp_decode_xmap_{v}_{x}",
                        "fused_bamp.py:617", xmap_launches[(v, x)],
                        xmap_checks[(v, x)][0], xmap_checks[(v, x)][1][-1],
                        source="fused_bamp_decode")
           for v, x in XMAP_PAIRS]
        + [kernel_entry("fused_bamp_decode_cluster", "fused_bamp.py:617",
                        cluster_launches, max(CLUSTER_ERRS), cluster_timing,
                        source="fused_bamp_cluster")]}), flush=True)
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
