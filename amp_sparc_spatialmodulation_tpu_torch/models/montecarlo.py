"""Monte-Carlo sweep engine.

Port of the JAX package's ``models/montecarlo.py`` for its four decoders,
``algo='bamp'``, ``'scamp'``, ``'vamp'`` and ``'vamp2'`` (reference
``bamp_model.py``, ``scamp_model.py``, ``vamp_model.py``): an
Eb/N0 grid mapped to SNR via ``+10*log10(rate)`` (`bamp_model.py:49-50`),
channel regeneration every ``res`` trials (`bamp_model.py:55-56`), per-SNR
metric accumulation and JSON export, and the sweep's stop at
``fer < 1e-3`` (`bamp_model.py:66-67`).
The default channel is ``generate_as_sparc`` in tap form, as in the
reference's final sweeps.

Two-phase (continuation) decoding runs eagerly: phase 1 decodes every
trial up to ``k1`` iterations, the still-active trials are gathered
exactly, phase 2 finishes them to the cap, and the merged state is
evaluated.  Decodes are resumable and per-trial, so the metric sums equal
a single-phase run's.  The JAX package's static bucket, rolling hint and
overflow redo exist only for ``jit``'s static shapes and have no
counterpart here.  ``two_phase='auto'`` sets k1 just above the point's
own mean T, measured by a probe decode of ``min(2048, res)`` trials at the
point's precision (JAX ``montecarlo.py:962-1003``), or, with
``AMP_AUTO_PROBE=0``, from the previous point's mean T.

Each realization keeps its message as the small structured truth
``(ant, sym, gray, flat)`` and drops the dense ``x`` once ``y`` is formed;
the evaluation rebuilds ``x`` from it.  At the flagship ``res=65536`` the
truth is 4 x 65536 x 160 int32 = 168 MB against 1.34 GB for the complex64
``x``.

All four decoders are ported.  VAMP and vamp2 decode on the dense channel
matrix's SVD, computed once per realization and shared by both phases
(vamp2 takes the direct SVD: it divides by the singular values).

``Simulator(precision=...)`` is the JAX package's matrix-product precision
(``montecarlo.py:877-931`` there): ``'highest'`` (default), ``'high'``
(``ops/precision.py``: ``y = x A^T`` in either operator form, the
projection and the VAMP and vamp2 decodes in three-pass bf16 products, on
the card through the HIGH form of kernels K3 and K4; the BAMP decode
through K1's HIGH form, or K5's on the massive geometry; SCAMP through
K2, which keeps HIGHEST inside, as JAX's has no precision; every plain
loop with its products at HIGH), ``'default'`` (the one-pass bf16 product
of ``ops/precision.py``, in the same places as HIGH: ``y``, the
projection, the DEFAULT forms of K1, K3, K4 and K5, K2 and K6 at HIGHEST
as in JAX, every plain loop's products at DEFAULT; the SVD stays at
HIGHEST) or ``'auto'`` (HIGH for a point exactly when the previous point's
mean T pinned at the iteration cap; never DEFAULT).  Every route takes
every precision, as in JAX.

``use_pallas='auto'|True|False`` is the JAX package's knob
(``resolve_use_pallas``): ``'auto'`` takes the kernels exactly where the
decoders' routes take them, ``False`` the plain loops, ``True`` raises
where no kernel covers the config.  ``chans_per_batch=C`` rounds the
realizations of a single-phase point up to a multiple of C, as the JAX
package does; every realization then runs through the one sequential
path (the JAX package decodes C of them per launch, which on the card
gained nothing at ``res=65536``, ``PERF.md`` §6).
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config import Config
from ..ops import channel as channel_ops
from ..ops import message as message_ops
from ..ops import operators
from ..ops import precision as prec
from ..utils import artifacts, metrics
from ..utils.device import make_generator, resolve_device
from . import bamp, scamp, vamp, vamp2

ALGO_DIRS = {"bamp": "BAMP", "vamp": "VAMP", "vamp2": "VAMP2",
             "scamp": "SCAMP", "random": "RANDOM"}

SVD_ALGOS = ("vamp", "vamp2")

# The probe of two_phase='auto': at most this many trials, drawn from a
# generator whose fourth entropy word no realization has (a realization's
# generator takes three: seed, point, realization).
PROBE_TRIALS = 2048
PROBE_ENTROPY = 0x9A0BE


def kernel_module(algo: str):
    """The wrapper module of ``algo``'s whole-decode kernel (None for an
    algorithm without one), whose ``covers`` and ``fits`` decide
    :func:`resolve_use_pallas` (JAX ``pallas_kernel_class``,
    ``montecarlo.py:264-281``)."""
    from ..ops.kernels import fused_bamp, fused_scamp, fused_vamp, fused_vamp2
    return {"bamp": fused_bamp, "scamp": fused_scamp, "vamp": fused_vamp,
            "vamp2": fused_vamp2}.get(algo)


def resolve_use_pallas(use_pallas, cfg: Config, algo: str,
                       operator_form: str, batch: Optional[int] = None
                       ) -> bool:
    """``use_pallas`` (``'auto'``, True or False) resolved to whether the
    decode takes its kernels: JAX ``montecarlo.py:210-261`` as it resolves
    on a TPU, decided from the wrappers' own ``covers`` and ``fits``.

    * ``'auto'``: BAMP and SCAMP on a banded operator (``operator_form``
      resolved), VAMP and vamp2 on either, where the kernel covers the
      config and, with ``batch`` given as in JAX, fits it; for BAMP a
      geometry K1 does not fit is taken when K5 covers it
      (``fused_bamp_tiled.covers``).  This is exactly where the decoders'
      routes take a kernel, on either device: on the CPU each wrapper runs
      its plain version, where JAX's ``'auto'`` means XLA
      (``montecarlo.py:227-228``).  The port's ``fits`` do not depend on
      the batch (a block holds one trial; K3, K4 and K5 keep their state
      in device memory), where JAX's count VMEM tiles.
    * ``True``: raises where no kernel covers the config, or the operator
      of BAMP or SCAMP is dense (JAX's honest knob, ``:100-109`` and
      ``:242-259``); a geometry that does not fit still takes the plain
      loop inside the decoder, as in JAX.
    * ``False``: the plain loops.
    """
    bamp.check_use_pallas(use_pallas)
    kern = kernel_module(algo)
    banded_only = algo in ("bamp", "scamp")
    if use_pallas == "auto":
        if kern is None or (banded_only and operator_form != "banded"):
            return False
        ok = kern.covers(cfg)
        if ok and batch is not None and hasattr(kern, "fits"):
            ok = kern.fits(cfg)
            if not ok and algo == "bamp":
                from ..ops.kernels import fused_bamp_tiled
                ok = fused_bamp_tiled.covers(cfg)
        return ok
    if use_pallas:
        if kern is None:
            raise ValueError(f"use_pallas=True, but no decode kernel exists "
                             f"for algo={algo!r}")
        if not kern.covers(cfg):
            raise ValueError(
                f"use_pallas=True, but the {algo} kernel does not cover "
                f"mode={cfg.mode!r} alphabet={cfg.alphabet!r} "
                f"(is_complex={cfg.is_complex})")
        if banded_only and operator_form != "banded":
            raise ValueError("use_pallas=True requires the banded operator "
                             "form for bamp and scamp")
    return bool(use_pallas)


def check_algo(algo: str, channel_kind: str) -> None:
    """Raise unless ``algo`` is known and can run on ``channel_kind``
    (SCAMP needs the SPARC base matrix)."""
    if algo not in ("bamp", "scamp") + SVD_ALGOS:
        raise ValueError(f"unknown algo {algo!r}")
    if algo == "scamp" and channel_kind != "sparc":
        raise ValueError("scamp requires the sparc channel")


def resolve_operator_form(channel_kind: str, operator_form: str,
                          algo: str = "bamp") -> str:
    """'auto' keeps the channel in tap form wherever it has one, except for
    VAMP and vamp2, which need the dense matrix for its SVD
    (`montecarlo.py:93-100` of the JAX package)."""
    if channel_kind not in ("sparc", "toeplitz", "iid"):
        raise ValueError(f"unknown channel kind {channel_kind!r}")
    if operator_form == "auto":
        return ("dense" if channel_kind == "iid" or algo in SVD_ALGOS
                else "banded")
    if operator_form == "banded" and algo in SVD_ALGOS:
        raise ValueError("VAMP requires the dense operator (SVD)")
    if operator_form == "banded" and channel_kind == "iid":
        raise ValueError("iid channels have no banded form")
    if operator_form not in ("banded", "dense"):
        raise ValueError(f"unknown operator form {operator_form!r}")
    return operator_form


class Realization(NamedTuple):
    """One channel realization with ``res`` trials: the SPARC base matrix
    (None for other channels), the operator, the received vectors, the
    transmitted truth (dense ``x`` dropped) and, for VAMP and vamp2, the
    operator's SVD (:func:`with_svd`)."""

    W: Optional[torch.Tensor]
    A: object
    y: torch.Tensor
    msg: message_ops.Message
    sigma2: float
    dec: Optional[vamp.SVD] = None


def generate_realization(gen: torch.Generator, cfg: Config,
                         channel_kind: str, operator_form: str, res: int,
                         snr: float,
                         precision: str = "highest") -> Realization:
    """Channel, message and noise drawn in that order from ``gen``
    (`bamp_model.py:54-58`), on the generator's device; ``x A^T`` is formed
    at ``precision`` (JAX `montecarlo.py:117-125`)."""
    W = None
    if operator_form == "banded":
        if channel_kind == "sparc":
            W, A = operators.banded_sparc(gen, cfg)
        else:
            A = operators.banded_toeplitz(gen, cfg)
    elif channel_kind == "sparc":
        W, A = channel_ops.generate_as_sparc(gen, cfg)
    elif channel_kind == "toeplitz":
        A = channel_ops.generate_channel(gen, cfg)
    else:
        A = channel_ops.generate_as_random(gen, cfg)
    msg = message_ops.generate_message(gen, cfg, res)
    if operator_form == "banded":
        Ax = A.apply(msg.x, precision)
    else:
        Ax = prec.matmul(msg.x, A.T, precision)
    y = Ax + channel_ops.awgn(gen, cfg, snr, res)
    return Realization(W=W, A=A, y=y, msg=msg._replace(x=None),
                       sigma2=cfg.E / snr)


def with_svd(algo: str, r: Realization) -> Realization:
    """``r`` with the SVD of its dense operator for VAMP and vamp2 (once
    per realization, shared by both phases; vamp2 needs the direct SVD,
    since it divides by ``s``, `montecarlo.py:386-390`), else ``r``."""
    if algo not in SVD_ALGOS:
        return r
    return r._replace(dec=vamp.svd(
        r.A, method="direct" if algo == "vamp2" else "auto"))


def decode(algo: str, r: Realization, y: torch.Tensor, cfg: Config,
           estimate_phi: bool = False, precision: str = "highest",
           use_pallas="auto", **kw):
    """Decode ``y`` (all of ``r.y`` or a gathered subset) on realization
    ``r`` (for VAMP and vamp2, one that went through :func:`with_svd`) with
    ``algo`` at ``precision`` (``'highest'``, ``'high'`` or ``'default'``) and
    ``use_pallas`` (``'auto'``, True or False, the decoders' knob); ``kw``
    are the decoders' resume arguments (``state0``, ``iter_cap``,
    ``return_state``)."""
    kw = dict(kw, precision=precision, use_pallas=use_pallas)
    if algo == "vamp":
        return vamp.decode(r.dec, y, r.sigma2, cfg, **kw)
    if algo == "vamp2":
        return vamp2.decode(r.dec, y, r.sigma2, cfg, **kw)
    if algo == "scamp":
        return scamp.decode(r.W, r.A, y, r.sigma2, cfg,
                            estimate_phi=estimate_phi, **kw)
    return bamp.decode(r.A, y, r.sigma2, cfg, **kw)


def make_realization_fn(cfg: Config, algo: str, channel_kind: str, res: int,
                        operator_form: str = "auto",
                        estimate_phi: bool = False,
                        precision: str = "highest", use_pallas="auto"):
    """One single-phase realization: ``fn(gen, snr) -> metric sums``
    (`bamp_model.py:54-59`), its products at ``precision``, its kernels as
    :func:`resolve_use_pallas` resolves ``use_pallas``."""
    check_algo(algo, channel_kind)
    form = resolve_operator_form(channel_kind, operator_form, algo)
    precision = prec.canonical(precision, allow_auto=True)
    use = resolve_use_pallas(use_pallas, cfg, algo, form, batch=res)

    def one_realization(gen, snr):
        r = with_svd(algo, generate_realization(gen, cfg, channel_kind, form,
                                                res, snr, precision))
        out = decode(algo, r, r.y, cfg, estimate_phi, precision, use)
        return metrics.evaluate_sums(out.xmap, out.xmmse, r.msg, out.T, cfg)

    return one_realization


def state_take_trials(state, idx: torch.Tensor):
    """Rows ``idx`` of a decoder state (the loop counter ``t`` is kept)."""
    return state._replace(**{f: getattr(state, f)[idx]
                             for f in state._fields if f != "t"})


def state_merge_trials(state, sub, idx: torch.Tensor):
    """Scatter a sub-batch state back into ``state`` at rows ``idx`` (the
    full state's ``t`` is kept)."""
    merged = {}
    for f in state._fields:
        if f == "t":
            continue
        v = getattr(state, f).clone()
        v[idx] = getattr(sub, f)
        merged[f] = v
    return state._replace(**merged)


def make_two_phase_fn(cfg: Config, algo: str, channel_kind: str, res: int,
                      k1: int, operator_form: str = "auto",
                      estimate_phi: bool = False,
                      precision: str = "highest", use_pallas="auto"):
    """One continuation-batched realization: ``fn(gen, snr) -> sums``.

    Phase 1 runs every trial up to ``k1`` iterations; the still-active
    trials are gathered exactly and phase 2 finishes them to the cap; the
    merged state is evaluated.  The trajectory of every trial is the
    single-phase one, so are the sums.  Products at ``precision``, kernels
    as :func:`resolve_use_pallas` resolves ``use_pallas``."""
    check_algo(algo, channel_kind)
    form = resolve_operator_form(channel_kind, operator_form, algo)
    precision = prec.canonical(precision, allow_auto=True)
    use = resolve_use_pallas(use_pallas, cfg, algo, form, batch=res)

    def two_phase(gen, snr):
        r = with_svd(algo, generate_realization(gen, cfg, channel_kind, form,
                                                res, snr, precision))
        _, state = decode(algo, r, r.y, cfg, estimate_phi, precision, use,
                          iter_cap=k1, return_state=True)
        idx = torch.nonzero(state.active).flatten()
        if idx.numel():
            _, sub = decode(algo, r, r.y[idx], cfg, estimate_phi, precision,
                            use, state0=state_take_trials(state, idx),
                            return_state=True)
            state = state_merge_trials(state, sub, idx)
        return metrics.evaluate_sums(state.xmap, state.xmmse, r.msg,
                                     state.T, cfg)

    return two_phase


# Quantized k1 grid for two_phase='auto'.
_AUTO_K1_GRID = (4, 6, 8, 10, 12, 14, 16, 20, 24, 32, 48, 64, 96, 128)


def auto_k1(mean_t: Optional[float], cap: int) -> int:
    """Phase-1 budget just above the expected mean T (the probe's or the
    previous sweep point's; 16 without either), on a quantized grid,
    clamped to ``cap``."""
    target = 16 if mean_t is None else int(np.ceil(mean_t)) + 1
    for k in _AUTO_K1_GRID:
        if k >= target:
            return min(k, cap)
    return min(_AUTO_K1_GRID[-1], cap)


class Simulator:
    """Sweep runner for one (config, algorithm) pair.

    Args:
        cfg: system config.
        algo: 'bamp', 'scamp', 'vamp' or 'vamp2'.
        channel_kind: 'sparc' (default), 'toeplitz' or 'iid'; SCAMP needs
            'sparc'.
        out_root: artifact root directory ('Simulations').
        algo_dir: artifact subdirectory; defaults by algo.
        seed: base seed; every (SNR point, realization) draws from its own
            generator seeded from ``(seed, snr_idx, realization)``.
        operator_form: 'auto' (tap form wherever the channel has one;
            dense for VAMP and vamp2), 'banded' or 'dense'.
        two_phase: None (single phase), an int ``k1``, or 'auto' (k1 just
            above the point's mean T, measured by :meth:`_probe_meanT`,
            or with ``AMP_AUTO_PROBE=0`` (or ``false``) the previous
            point's).
        estimate_phi: SCAMP's empirical residual variance (estSCAMP).
        device: where the sweep runs; None means the CUDA card, and raises
            when there is none.  Pass 'cpu' to run on the CPU.
        precision: 'highest' (default), 'high', 'default' or 'auto'
            (module docstring).
        use_pallas: 'auto' (default), True or False
            (:func:`resolve_use_pallas`); True raises here where no kernel
            covers the config.
        chans_per_batch: realizations per single-phase point round up to
            a multiple of it (the JAX package's C realizations per
            launch); they run one after another.
    """

    # False where another process writes this sweep's artifacts (the
    # sharded sweep's ranks other than 0)
    writes_artifacts = True

    def __init__(self, cfg: Config, algo: str = "bamp",
                 channel_kind: str = "sparc", out_root: str = "Simulations",
                 algo_dir: Optional[str] = None, seed: int = 0,
                 operator_form: str = "auto", two_phase=None, device=None,
                 estimate_phi: bool = False, precision: str = "highest",
                 chans_per_batch: int = 1, use_pallas="auto",
                 progress: Callable[[str], None] = print):
        check_algo(algo, channel_kind)
        form = resolve_operator_form(channel_kind, operator_form, algo)
        if isinstance(two_phase, str) and two_phase != "auto":
            raise ValueError("two_phase must be an int, 'auto', or None")
        precision = prec.canonical(precision, allow_auto=True)
        resolve_use_pallas(use_pallas, cfg, algo, form)
        if int(chans_per_batch) < 1:
            raise ValueError("chans_per_batch must be >= 1")
        # 'auto' (montecarlo.py:885-897 of the JAX package): the three-pass
        # bf16 product's only hazard, its ~2^-16 error fluttering the 1e-5
        # allclose stop so that trials do not freeze, is void when every
        # trial runs to the cap anyway; so HIGH for a point exactly when the
        # previous point's mean T pinned at the cap, HIGHEST otherwise.
        self._precision_auto = precision == prec.AUTO
        self.precision = prec.HIGHEST if self._precision_auto else precision
        self.chans_per_batch = int(chans_per_batch)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.algo = algo
        self.channel_kind = channel_kind
        self.seed = seed
        self.operator_form = operator_form
        self.two_phase = two_phase
        self.estimate_phi = estimate_phi
        self.use_pallas = use_pallas
        self.progress = progress
        self.path = os.path.join(out_root, algo_dir or ALGO_DIRS[algo],
                                 cfg.name)
        self._last_meanT = None   # previous point's mean T (auto k1, auto
                                  # precision)
        # two_phase='auto': the last point's probe mean T (None when it
        # did not probe) and its k1
        self.probe_meanT = None
        self.k1 = None

    def _effective_precision(self) -> str:
        """The product precision of the NEXT point (see the 'auto' note
        in ``__init__``; `montecarlo.py:923-930` of the JAX package)."""
        if not self._precision_auto:
            return self.precision
        if (self._last_meanT is not None
                and self._last_meanT >= self.cfg.N_Layers):
            return prec.HIGH
        return prec.HIGHEST

    def _single_phase_fn(self, res: int):
        return make_realization_fn(self.cfg, self.algo, self.channel_kind,
                                   res, self.operator_form,
                                   self.estimate_phi,
                                   self._effective_precision(),
                                   self.use_pallas)

    def _probe_meanT(self, snr: float, snr_idx: int, res: int) -> float:
        """Mean T of this point from one single-phase probe realization of
        ``min(PROBE_TRIALS, res)`` trials at the point's precision and
        ``use_pallas`` (JAX ``montecarlo.py:962-977``), drawn from a
        generator no realization of the point uses.  Sized to ``res`` and
        built per point, it avoids two faults of JAX's probe: a fixed 2048
        trials, and a probe compiled once at the first point's
        precision."""
        fn = self._single_phase_fn(min(PROBE_TRIALS, res))
        gen = make_generator(self.device, self.seed, snr_idx, PROBE_ENTROPY,
                             0)
        return metrics.finalize(fn(gen, snr), self.cfg)["T"]

    def _choose_k1(self, res: int, snr: float, snr_idx: int) -> None:
        """Set ``self.k1`` for this point: ``two_phase`` itself, or under
        ``'auto'`` from the probe's mean T (``self.probe_meanT``) or, with
        ``AMP_AUTO_PROBE=0``, the previous point's."""
        self.probe_meanT = None
        if self.two_phase != "auto":
            self.k1 = int(self.two_phase)
            return
        mean_t = self._last_meanT
        if os.environ.get("AMP_AUTO_PROBE", "1") not in ("0", "false"):
            mean_t = self.probe_meanT = self._probe_meanT(snr, snr_idx, res)
        self.k1 = auto_k1(mean_t, self.cfg.N_Layers)

    def _realization_fn(self, res: int, snr: float, snr_idx: int):
        if self.two_phase is None:
            return self._single_phase_fn(res)
        self._choose_k1(res, snr, snr_idx)
        return make_two_phase_fn(self.cfg, self.algo, self.channel_kind,
                                 res, self.k1, self.operator_form,
                                 self.estimate_phi,
                                 self._effective_precision(), self.use_pallas)

    def _realizations(self, epochs: int, res: int) -> int:
        """Realizations per point: whole realizations of ``res``, rounded
        up to a multiple of ``chans_per_batch`` when single phase (under
        two-phase the JAX package ignores it, `montecarlo.py:1016-1024`)."""
        n_real = max(1, int(np.ceil(epochs / res)))
        if self.two_phase is not None:
            return n_real
        C = self.chans_per_batch
        return int(np.ceil(n_real / C)) * C

    def trials_per_point(self, epochs: int, res: int = 1) -> int:
        """Trials :meth:`run_point` decodes: whole realizations of
        ``res``, their count rounded as :meth:`_realizations` says, so that
        the manifest records the true sample count."""
        return self._realizations(epochs, res) * res

    def run_point(self, ebn0_db: float, epochs: int, res: int = 1,
                  snr_idx: int = 0) -> Dict[str, float]:
        """Simulate one Eb/N0 point with ``epochs`` trials, reusing each
        channel realization for ``res`` trials (`bamp_model.py:54-58`).
        Sums stay on the device; one transfer per point."""
        cfg = self.cfg
        snr_db = ebn0_db + 10 * np.log10(cfg.code_rate)
        snr = float(10 ** (snr_db / 10))
        n_real = self._realizations(epochs, res)
        fn = self._realization_fn(res, snr, snr_idx)
        total = None
        for c in range(n_real):
            gen = make_generator(self.device, self.seed, snr_idx, c)
            total = metrics.accumulate(total, fn(gen, snr))
        out = metrics.finalize(total, cfg)
        self._last_meanT = out["T"]
        return out

    def _resumed(self) -> Dict[float, Dict[str, float]]:
        """The points the manifest lists as done, with their exported
        results (empty where a point's JSON is missing)."""
        pts = artifacts.load_points(self.path)
        return {float(k): pts.get(float(k), {})
                for k in artifacts.load_manifest(self.path)["points"]}

    def simulate(self, epochs: int, final: Optional[float] = None,
                 start: Optional[float] = None, step: float = 1.0,
                 res: int = 1, fer_stop: float = 1e-3,
                 resume: bool = False) -> Dict[float, Dict[str, float]]:
        """Sweep the Eb/N0 grid, exporting one JSON per point and stopping
        once ``fer < fer_stop`` (`bamp_model.py:44-67`)."""
        cfg = self.cfg
        if start is None:
            start = int(np.ceil(cfg.shannon_limit_dB))
        if final is None:
            final = start + 20.0
        grid = np.arange(start, final + step, step)
        done = self._resumed() if resume else {}
        results = {}
        for i, ebn0 in enumerate(grid):
            snr_db = ebn0 + 10 * np.log10(cfg.code_rate)
            if float(ebn0) in done:
                results[float(ebn0)] = done[float(ebn0)]
                fer = results[float(ebn0)].get("fer", 1.0)
                self.progress(f"EbN0dB={ebn0} (resumed) FER={fer}")
                if fer < fer_stop:
                    break
                continue
            t0 = time.perf_counter()
            avg = self.run_point(ebn0, epochs, res, snr_idx=i)
            dt = time.perf_counter() - t0
            n_trials = self.trials_per_point(epochs, res)
            if self.writes_artifacts:
                artifacts.export_point(self.path, ebn0, snr_db, cfg, avg)
                artifacts.update_manifest(self.path, ebn0, n_trials,
                                          self.seed)
            results[float(ebn0)] = avg
            self.progress(
                f"EbN0dB={ebn0} FER={avg['fer']:.3e} T={avg['T']:.1f} "
                f"({n_trials} trials, {n_trials / dt:.1f} trials/s)")
            if avg["fer"] < fer_stop:
                break
        return results
