"""Sharded Monte-Carlo sweeps: realizations split over the ``trials`` axis
of the mesh, the frame optionally split over its ``model`` axis, the metric
sums all-reduced.

Port of the JAX package's ``parallel/sweep.py``.  Each rank decodes its own
realizations through the port's own realization functions
(:func:`..models.montecarlo.make_realization_fn`,
:func:`..models.montecarlo.make_two_phase_fn`), so every kernel route of
the single-device sweep runs unchanged on every rank; the sums, additive
across realizations, are all-reduced over the trials axis once per call.
Call ``c`` of ``D`` ranks of ``C`` realizations each gives rank ``d``
realizations ``c D C + d C + j``, each drawn from the generator the
unsharded :class:`..models.montecarlo.Simulator` gives that realization,
so the sharded sums equal the Simulator's over the same realizations:
integer counts exactly, float sums up to their order of summation.

On a mesh whose model axis has more than one rank every rank of a trials
row draws the same realization and decodes its own columns: the halo BAMP
and SCAMP decodes of :mod:`.banded` on the tap form, the dense column split
of :mod:`.tensor` (the i.i.d. channel, or ``operator_form='dense'``), and
the SV-domain VAMP of :mod:`.vamp_tp`.  Those decoders are plain PyTorch,
as JAX's are XLA; the sums, the same on every rank of a row, are
all-reduced over the trials axis only.  Two-phase decoding composes with
both axes: the still-active trials are the same rows on every rank of a
row, and phase 2 resumes each rank's own column slab of them.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..models import montecarlo
from ..models.bamp import check_use_pallas
from ..utils import metrics
from ..utils.device import make_generator
from . import banded, tensor, vamp_tp
from .mesh import (MODEL_AXIS, TRIALS_AXIS, all_reduce, axis_of,
                   broadcast_float, initialize_distributed, make_mesh)

MODEL_AXIS_ALGOS = ("bamp", "scamp", "vamp")


def reduce_over_trials(sums, mesh):
    """Metric sums all-reduced over the mesh's trials axis: one collective
    of the stacked sums (none on an axis of one rank)."""
    axis = axis_of(mesh, TRIALS_AXIS)
    if axis.size == 1:
        return sums
    keys = list(sums)
    total = all_reduce(torch.stack([sums[k].to(torch.float32)
                                    for k in keys]), axis)
    return dict(zip(keys, total.unbind(0)))


def check_model_axis(cfg: Config, algo: str, channel_kind: str,
                     operator_form: str, use_pallas, tp: int) -> str:
    """The JAX package's refusals for a model axis of ``tp`` ranks
    (`sweep.py:54-66`, `:93-102`); returns the resolved operator form."""
    check_use_pallas(use_pallas)
    montecarlo.check_algo(algo, channel_kind)
    form = montecarlo.resolve_operator_form(channel_kind, operator_form, algo)
    if tp == 1:
        return form
    if algo not in MODEL_AXIS_ALGOS:
        raise NotImplementedError(
            "model-axis sharding covers bamp (banded/dense), scamp "
            "(banded) and vamp (SV-domain columns); vamp2 divides by the "
            "small singular values and is not distributed")
    if use_pallas is True:
        raise ValueError("the fused decode kernels decode whole frames; they "
                         "do not compose with the model axis (use model=1 "
                         "meshes for the kernels)")
    if algo == "scamp" and form != "banded":
        raise ValueError("model-parallel scamp needs the banded operator")
    if cfg.Lin % tp:
        raise ValueError(f"model axis size {tp} must divide Lin={cfg.Lin}")
    return form


def _tp_realization(cfg: Config, algo: str, channel_kind: str, form: str,
                    res: int, mesh, precision: str, estimate_phi: bool):
    """``(prepare, evaluate)`` of one model-axis realization.

    ``prepare(gen, snr) -> (msg, y, run)``: the realization drawn as the
    single-device sweep draws it (every rank of the row from the same
    generator), this rank's received rows ``y`` (row planes for the halo
    decodes, the whole ``y`` otherwise) and ``run(y, **resume)``, the
    rank's decode returning its state.  ``evaluate(msg, state)``: the
    metric sums of the gathered columns, the same on every rank of the
    row."""
    ax = axis_of(mesh, MODEL_AXIS)
    kw = dict(mesh=mesh, precision=precision, return_state=True)

    def prepare(gen, snr):
        r = montecarlo.with_svd(algo, montecarlo.generate_realization(
            gen, cfg, channel_kind, form, res, snr, precision))
        if algo == "vamp":
            Vh_k = tensor.shard_columns(r.dec.Vh, ax)

            def run(y, **resume):
                return vamp_tp.decode(r.dec.U, r.dec.s, Vh_k, y, r.sigma2,
                                      cfg, **kw, **resume)
            return r.msg, r.y, run
        if form == "dense":
            H_k = tensor.shard_columns(r.A, ax)

            def run(y, **resume):
                return tensor.decode(H_k, y, r.sigma2, cfg, **kw, **resume)
            return r.msg, r.y, run
        if algo == "scamp":
            def run(y, **resume):
                return banded.scamp_decode(r.A.h, r.A.gains, r.W, y,
                                           r.sigma2, cfg,
                                           estimate_phi=estimate_phi, **kw,
                                           **resume)
        else:
            def run(y, **resume):
                return banded.decode(r.A.h, r.A.gains, y, r.sigma2, cfg,
                                     **kw, **resume)
        return r.msg, banded.shard_rows(r.y, cfg, ax), run

    def evaluate(msg, st):
        # `vamp.py:187`: VAMP's decision layer sees the pseudo-data r
        stat = st.r if algo == "vamp" else st.xmap
        return metrics.evaluate_sums(tensor.gather_columns(stat, ax),
                                     tensor.gather_columns(st.xmmse, ax),
                                     msg, st.T, cfg)

    return prepare, evaluate


def make_sharded_step(cfg: Config, algo: str, channel_kind: str, res: int,
                      mesh, chans_per_device: int = 1,
                      precision: str = "highest",
                      estimate_phi: bool = False,
                      operator_form: str = "auto", use_pallas="auto"):
    """``step(gens, snr) -> metric sums`` over ``mesh``.

    ``gens`` are this rank's ``chans_per_device`` realization generators;
    each realization decodes ``res`` trials.  With one rank on the model
    axis each realization runs through
    :func:`..models.montecarlo.make_realization_fn`, kernels and all, as
    ``use_pallas`` resolves; with more, its frame is split over the model
    axis (module docstring), and ``use_pallas=True`` raises.  The sums
    come back all-reduced over the trials axis, the same on every rank.
    """
    tp = axis_of(mesh, MODEL_AXIS).size
    form = check_model_axis(cfg, algo, channel_kind, operator_form,
                            use_pallas, tp)
    if tp == 1:
        one = montecarlo.make_realization_fn(
            cfg, algo, channel_kind, res, operator_form, estimate_phi,
            precision, use_pallas)
    else:
        prepare, evaluate = _tp_realization(cfg, algo, channel_kind, form,
                                            res, mesh, precision,
                                            estimate_phi)

        def one(gen, snr):
            msg, y, run = prepare(gen, snr)
            return evaluate(msg, run(y))

    def step(gens, snr):
        if len(gens) != chans_per_device:
            raise ValueError(f"{len(gens)} realizations for this rank, the "
                             f"step was built with chans_per_device="
                             f"{chans_per_device}")
        total = None
        for gen in gens:
            total = metrics.accumulate(total, one(gen, snr))
        return reduce_over_trials(total, mesh)

    return step


class ShardedTwoPhaseFns(NamedTuple):
    """The two-phase decode of one realization on this rank
    (``realization(gen, snr) -> sums``, not yet reduced) and the mesh."""

    realization: Callable
    mesh: object


def make_sharded_two_phase_fns(cfg: Config, algo: str, channel_kind: str,
                               res: int, k1: int, mesh,
                               chans_per_device: int = 1,
                               precision: str = "highest",
                               operator_form: str = "auto",
                               estimate_phi: bool = False,
                               use_pallas="auto") -> ShardedTwoPhaseFns:
    """Continuation decoding over the trials axis: each rank decodes its
    realizations to ``k1`` iterations, gathers its still-active trials
    exactly and finishes them to the cap
    (:func:`..models.montecarlo.make_two_phase_fn`, kernels and all), so
    each realization's trajectories are the single-device sweep's.  The
    JAX package pads each tail to a bucket because ``jit`` needs static
    shapes, and can run the three phases as one program on a rolling
    bucket hint (``hint``, ``phase123_for``, ``AMP_PHASE123``); the eager
    gather keeps no bucket, so none of that has a counterpart here.  A
    model axis of more than one rank takes :func:`_make_tp_two_phase_fns`.
    """
    tp = axis_of(mesh, MODEL_AXIS).size
    if tp > 1:
        return _make_tp_two_phase_fns(
            cfg, algo, channel_kind, res, k1, mesh,
            chans_per_device=chans_per_device, precision=precision,
            operator_form=operator_form, estimate_phi=estimate_phi,
            use_pallas=use_pallas)
    check_model_axis(cfg, algo, channel_kind, operator_form, use_pallas, tp)
    one = montecarlo.make_two_phase_fn(cfg, algo, channel_kind, res, k1,
                                       operator_form, estimate_phi,
                                       precision, use_pallas)
    return ShardedTwoPhaseFns(one, mesh)


def _make_tp_two_phase_fns(cfg: Config, algo: str, channel_kind: str,
                           res: int, k1: int, mesh,
                           chans_per_device: int = 1,
                           precision: str = "highest",
                           operator_form: str = "auto",
                           estimate_phi: bool = False,
                           use_pallas="auto") -> ShardedTwoPhaseFns:
    """Continuation decoding on a model axis of more than one rank: phase 1
    stops the frame-split decode at ``k1``; the still-active trials, the
    same rows on every rank of the row (their verdict is all-reduced over
    the model axis), are gathered, and phase 2 resumes each rank's own
    column slab of them, so no state crosses the model axis."""
    tp = axis_of(mesh, MODEL_AXIS).size
    form = check_model_axis(cfg, algo, channel_kind, operator_form,
                            use_pallas, tp)
    if chans_per_device != 1:
        raise NotImplementedError(
            "model-axis two-phase runs one realization per device call "
            "(chans_per_device=1)")
    prepare, evaluate = _tp_realization(cfg, algo, channel_kind, form, res,
                                        mesh, precision, estimate_phi)

    def two_phase(gen, snr):
        msg, y, run = prepare(gen, snr)
        st = run(y, iter_cap=k1)
        idx = torch.nonzero(st.active).flatten()
        if idx.numel():
            sub = run(y[idx], state0=montecarlo.state_take_trials(st, idx))
            st = montecarlo.state_merge_trials(st, sub, idx)
        return evaluate(msg, st)

    return ShardedTwoPhaseFns(two_phase, mesh)


def run_sharded_two_phase(fns: ShardedTwoPhaseFns, gens, snr):
    """One sharded continuation-decoded call: this rank's realizations
    ``gens`` through ``fns.realization``, the sums all-reduced over the
    trials axis."""
    total = None
    for gen in gens:
        total = metrics.accumulate(total, fns.realization(gen, snr))
    return reduce_over_trials(total, fns.mesh)


class ShardedSimulator(montecarlo.Simulator):
    """:class:`..models.montecarlo.Simulator` with its realizations split
    over the trials axis of a mesh (and, with a model axis of more than one
    rank, each realization's frame split over it).

    Per point each of the ``D`` ranks of the trials axis decodes
    ``chans_per_batch`` realizations per call, so ``trials_per_point``
    rounds the realizations up to a multiple of ``D C``.  ``two_phase``
    composes with both axes; ``two_phase='auto'`` probes on global rank 0,
    which broadcasts the probe's mean T, so that ranks on different cards
    cannot pick different k1.  ``precision='auto'`` follows the previous
    point's all-reduced mean T, the same on every rank.  ``use_pallas``
    composes with the trials axis only.  Only global rank 0 writes the
    artifacts and the manifest and reports progress; a resumed sweep takes
    rank 0's manifest.

    Args:
        cfg: system config.
        mesh: the ``(trials, model)`` mesh (:func:`.mesh.make_mesh`);
            None builds one over every rank, starting the process group
            first if none is running.
        kw: as :class:`..models.montecarlo.Simulator`; ``device`` defaults
            to the rank's device (``cuda:{current}`` on an NCCL mesh).
    """

    def __init__(self, cfg: Config, mesh=None, **kw):
        if mesh is None:
            dev = initialize_distributed(device=kw.get("device"))
            mesh = make_mesh(device_type=dev.type)
        if kw.get("device") is None:
            kw["device"] = (torch.device("cuda", torch.cuda.current_device())
                            if mesh.device_type == "cuda"
                            else torch.device("cpu"))
        self.mesh = mesh
        super().__init__(cfg, **kw)
        check_model_axis(cfg, self.algo, self.channel_kind,
                         self.operator_form, self.use_pallas,
                         axis_of(mesh, MODEL_AXIS).size)
        if dist.get_rank() != 0:
            self.progress = lambda s: None
            self.writes_artifacts = False

    def trials_per_point(self, epochs: int, res: int = 1) -> int:
        n_real = max(1, -(-epochs // res))
        DC = axis_of(self.mesh, TRIALS_AXIS).size * self.chans_per_batch
        return -(-n_real // DC) * DC * res

    def _probe_meanT(self, snr: float, snr_idx: int, res: int) -> float:
        """Global rank 0's probe (the unsharded one of the base class,
        whole frames on one device), broadcast to every rank."""
        mean_t = (super()._probe_meanT(snr, snr_idx, res)
                  if dist.get_rank() == 0 else None)
        return broadcast_float(mean_t, self.device)

    def _resumed(self):
        obj = [super()._resumed() if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(obj, src=0)
        return obj[0]

    def _realization_fn(self, res: int, snr: float, snr_idx: int):
        kw = dict(chans_per_device=self.chans_per_batch,
                  precision=self._effective_precision(),
                  operator_form=self.operator_form,
                  estimate_phi=self.estimate_phi, use_pallas=self.use_pallas)
        args = (self.cfg, self.algo, self.channel_kind, res)
        if self.two_phase is None:
            return make_sharded_step(*args, self.mesh, **kw)
        self._choose_k1(res, snr, snr_idx)
        fns = make_sharded_two_phase_fns(*args, self.k1, self.mesh, **kw)
        return partial(run_sharded_two_phase, fns)

    def run_point(self, ebn0_db: float, epochs: int, res: int = 1,
                  snr_idx: int = 0):
        trials = axis_of(self.mesh, TRIALS_AXIS)
        D, d, C = trials.size, trials.index, self.chans_per_batch
        snr = float(10 ** ((ebn0_db + 10 * np.log10(self.cfg.code_rate))
                           / 10))
        fn = self._realization_fn(res, snr, snr_idx)
        n_calls = self.trials_per_point(epochs, res) // (res * D * C)
        total = None
        for c in range(n_calls):
            gens = [make_generator(self.device, self.seed, snr_idx,
                                   c * D * C + d * C + j) for j in range(C)]
            total = metrics.accumulate(total, fn(gens, snr))
        out = metrics.finalize(total, self.cfg)
        self._last_meanT = out["T"]
        return out
