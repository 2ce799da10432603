"""The port's sharded sweep (``…_torch/parallel/sweep.py``) over gloo
ranks on the CPU, at world sizes 2 and 4:

* ``ShardedSimulator`` on a trials-only mesh against the port's unsharded
  ``Simulator`` on the same seed: integer sums (FER, BER, every error
  count, mean T) equal, float sums (NMSE) within rel 1e-6, single phase,
  two-phase, ``two_phase='auto'`` (the same k1 on every rank) and
  ``chans_per_batch``; artifacts from rank 0 only;
* ``make_sharded_step`` against the same realizations summed in one
  process;
* the model axis: a (2, 2) mesh's halo BAMP, halo SCAMP, SV-domain VAMP
  and dense i.i.d. BAMP against the trials-only (4, 1) mesh under
  tests/test_parallel.py:297-305's tolerances, and their two-phase runs
  against their single-phase ones under :334-338's;
* the JAX package's refusals (vamp2 and ``use_pallas=True`` on a model
  axis, SCAMP off the SPARC channel or off the banded form, the i.i.d.
  channel in banded form, ``chans_per_device != 1`` in model-axis
  two-phase, a model axis that does not divide Lin);
* ``cli sweep --shard --device cpu`` over two ranks started with
  ``torch.distributed.run``'s environment;
* every rank sees the same sums (tests/test_multihost.py's check).

The ranks are tests/torch_dist_worker.py's, spawned once for the module
per world size; the cases compare what they stored."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.models import montecarlo as mc
from amp_sparc_spatialmodulation_tpu_torch.utils import metrics
from amp_sparc_spatialmodulation_tpu_torch.utils.device import make_generator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_parallel.py:16-21 and the geometry of :182 (two-phase) and
# :316-319 (model axis)
BASE = dict(Nt=16, Na=4, Nr=8, Lin=4, Lh=2, mode="segmented",
            iterations=20, alphabet="OOK", profile="uniform", trunc="tail")
DP = dict(BASE, Lin=8, Lh=3, iterations=30)
TP = dict(BASE, iterations=25)
TP_SCAMP = dict(TP, mode="sparc")

# exact: every sum behind these is an integer count
INTEGER_KEYS = ("T", "fer", "ver", "verf", "verm", "verL", "ber", "iber",
                "sber", "ier", "ser")
POINT = dict(ebn0_db=7.0, epochs=64, res=16, snr_idx=0)
TP_POINT = dict(ebn0_db=6.0, epochs=32, res=8, snr_idx=0)


def _sim_case(name, world, mesh, cfg, point=POINT, **sim):
    return dict(name=name, world=world, task="sim", mesh=mesh, cfg=cfg,
                point=point, sim=sim)


# (case, the unsharded Simulator's kwargs it is held against)
DP_CASES = [
    (_sim_case("dp2-single", 2, (2, 1), DP), {}),
    (_sim_case("dp2-two-phase", 2, (2, 1), DP, two_phase=6),
     dict(two_phase=6)),
    (_sim_case("dp2-auto", 2, (2, 1), DP, point=dict(POINT, snr_idx=1),
               two_phase="auto"), dict(two_phase="auto")),
    (_sim_case("dp2-chans", 2, (2, 1), DP, chans_per_batch=2),
     dict(chans_per_batch=2)),
    (_sim_case("dp2-scamp-two-phase", 2, (2, 1), dict(DP, mode="sparc"),
               point=dict(POINT, ebn0_db=8.0), algo="scamp", two_phase=6),
     dict(algo="scamp", two_phase=6)),
    (_sim_case("dp2-vamp", 2, (2, 1), dict(DP, iterations=15),
               algo="vamp"), dict(algo="vamp")),
    (_sim_case("dp4-single", 4, (4, 1), DP), {}),
    (_sim_case("dp4-two-phase", 4, (4, 1), DP, two_phase=6),
     dict(two_phase=6)),
]

# model axis: (2, 2) against (4, 1), single phase and two-phase (k1 = 3)
TP_ALGOS = {"bamp": (TP, {}), "scamp": (TP_SCAMP, dict(algo="scamp")),
            "vamp": (TP, dict(algo="vamp")),
            "iid": (TP, dict(channel_kind="iid"))}
TP_CASES = []
for tag, (cfg, kw) in TP_ALGOS.items():
    TP_CASES += [
        _sim_case(f"tp-{tag}", 4, (2, 2), cfg, point=TP_POINT, **kw),
        _sim_case(f"tp-{tag}-two-phase", 4, (2, 2), cfg, point=TP_POINT,
                  two_phase=3, **kw),
        _sim_case(f"dp-{tag}", 4, (4, 1), cfg, point=TP_POINT, **kw)]

# the model axis at precision='high': every product of the frame-split
# decode through ops/precision.py's three bf16 passes
TP_CASES += [
    _sim_case("tp-bamp-high", 4, (2, 2), TP, point=TP_POINT,
              precision="high"),
    _sim_case("tp-bamp-high-two-phase", 4, (2, 2), TP, point=TP_POINT,
              precision="high", two_phase=3)]

STEP_CASE = dict(name="step2", world=2, task="step", mesh=(2, 1), cfg=DP,
                 algo="bamp", res=16, seed=11, snr=7.0)
SIMULATE_CASE = dict(name="simulate2", world=2, task="simulate",
                     mesh=(2, 1), cfg=DP,
                     grid=dict(epochs=32, start=6.0, final=7.0, step=1.0,
                               res=16))


def _refuse(name, build, algo, channel="sparc", cfg=BASE, **kw):
    return dict(name=f"refuse-{name}", world=2, task="refuse", mesh=(1, 2),
                cfg=cfg, build=build, algo=algo, channel=channel, kw=kw)


REFUSALS = {
    "refuse-vamp2": ("NotImplementedError", "vamp2",
                     _refuse("vamp2", "step", "vamp2")),
    "refuse-vamp2-simulator": ("NotImplementedError", "vamp2",
                               _refuse("vamp2-simulator", "sim", "vamp2")),
    "refuse-use-pallas": ("ValueError", "do not compose",
                          _refuse("use-pallas", "step", "bamp",
                                  use_pallas=True)),
    "refuse-use-pallas-two-phase": (
        "ValueError", "do not compose",
        _refuse("use-pallas-two-phase", "two_phase", "bamp",
                use_pallas=True)),
    "refuse-scamp-toeplitz": ("ValueError", "sparc channel",
                              _refuse("scamp-toeplitz", "step", "scamp",
                                      channel="toeplitz",
                                      cfg=dict(BASE, mode="sparc"))),
    "refuse-scamp-dense": ("ValueError", "banded operator",
                           _refuse("scamp-dense", "step", "scamp",
                                   cfg=dict(BASE, mode="sparc"),
                                   operator_form="dense")),
    "refuse-iid-banded": ("ValueError", "no banded form",
                          _refuse("iid-banded", "step", "bamp",
                                  channel="iid", operator_form="banded")),
    "refuse-two-phase-chans": ("NotImplementedError", "chans_per_device=1",
                               _refuse("two-phase-chans", "two_phase",
                                       "bamp", chans_per_device=2)),
    "refuse-lin": ("ValueError", "must divide Lin",
                   _refuse("lin", "step", "bamp", cfg=dict(BASE, Lin=5))),
}

CASES = ([c for c, _ in DP_CASES] + TP_CASES + [STEP_CASE, SIMULATE_CASE]
         + [c for _, _, c in REFUSALS.values()])


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


CLI_ARGS = ["sweep", "--Nt", "16", "--Na", "4", "--Nr", "8", "--Lin", "8",
            "--Lh", "3", "--iterations", "30", "--mode", "segmented",
            "--epochs", "64", "--res", "16", "--start", "7", "--final", "7",
            "--two-phase", "6", "--seed", "5", "--device", "cpu", "--shard"]


def _spawn_cli(tmp):
    """``cli -- sweep --shard`` as two ranks with torchrun's environment
    (the ``--`` that torchrun passes on where it ends its options)."""
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        log = open(os.path.join(tmp, f"cli.rank{r}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "amp_sparc_spatialmodulation_tpu_torch.cli",
             "--", *CLI_ARGS, "--out", os.path.join(tmp, "cli")],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return procs


def _simulator(cfg, tmp, **kw):
    return mc.Simulator(Config(**cfg), device="cpu", out_root=str(tmp),
                        progress=lambda s: None, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the ranks (worlds 2 and 4, and the two CLI ranks, at once),
    run the unsharded references meanwhile, and return the temp dir and
    the references."""
    tmp = str(tmp_path_factory.mktemp("parallel"))
    procs = {w: worker.spawn(CASES, w, tmp) for w in (2, 4)}
    cli = _spawn_cli(tmp)
    # one thread, as the ranks run: the CPU's product library sums in
    # another order with more threads, and VAMP amplifies the difference
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        refs = {}
        for case, kw in DP_CASES:
            sim = _simulator(case["cfg"], tmp, **kw)
            refs[case["name"]] = dict(sim.run_point(**case["point"]),
                                      k1=sim.k1)
        cfg = Config(**STEP_CASE["cfg"])
        fn = mc.make_realization_fn(cfg, "bamp", "sparc", STEP_CASE["res"])
        total = None
        for i in range(2):
            gen = make_generator(torch.device("cpu"), STEP_CASE["seed"], 0, i)
            total = metrics.accumulate(total, fn(gen, STEP_CASE["snr"]))
        refs["step2"] = metrics.fetch_sums(total)
        sim = _simulator(DP, tmp, two_phase=6, seed=5)
        refs["cli"] = sim.run_point(7.0, epochs=64, res=16)
        refs["cli_path"] = os.path.relpath(sim.path, tmp)
    finally:
        torch.set_num_threads(threads)
        for w, ps in procs.items():
            worker.wait(ps, tmp, w, timeout=240)
        for p in cli:
            try:
                p.wait(timeout=240)
            except subprocess.TimeoutExpired:
                for q in cli:
                    q.kill()
                pytest.fail("the sharded CLI run timed out")
    for r, p in enumerate(cli):
        with open(os.path.join(tmp, f"cli.rank{r}.log")) as f:
            assert p.returncode == 0, f.read()[-3000:]
    return tmp, refs


def _avg(res):
    return {k[4:]: float(v) for k, v in res.items() if k.startswith("avg_")}


def _same_point(got, ref):
    for k, v in ref.items():
        if k in INTEGER_KEYS:
            assert got[k] == v, k
        else:
            assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k


@pytest.mark.parametrize("name", [c["name"] for c, _ in DP_CASES])
def test_sharded_simulator_matches_simulator(runs, name):
    tmp, refs = runs
    ref = dict(refs[name])
    k1 = ref.pop("k1")
    got = worker.results(tmp, name)
    assert ref["T"] > 1.0            # the point iterates
    _same_point(_avg(got), ref)
    assert int(got["k1"]) == (-1 if k1 is None else k1)


@pytest.mark.parametrize("name", [c["name"] for c, _ in DP_CASES])
def test_every_rank_sees_the_same_sums(runs, name):
    """tests/test_multihost.py:54-57: the all-reduced sums, and the k1 that
    ``two_phase='auto'`` picked, are the same on every rank."""
    tmp, _ = runs
    world = next(c["world"] for c, _ in DP_CASES if c["name"] == name)
    r0 = worker.results(tmp, name, 0)
    for rank in range(1, world):
        rr = worker.results(tmp, name, rank)
        for k in r0:
            np.testing.assert_array_equal(rr[k], r0[k], err_msg=k)


def test_auto_probes_once_and_shares_k1(runs):
    tmp, refs = runs
    got = [worker.results(tmp, "dp2-auto", r) for r in range(2)]
    assert not np.isnan(got[0]["probe_meanT"])
    assert got[0]["probe_meanT"] == got[1]["probe_meanT"]
    assert int(got[0]["k1"]) == int(got[1]["k1"]) == refs["dp2-auto"]["k1"]


def test_trials_per_point_rounds_to_ranks_and_chans(runs):
    tmp, _ = runs
    # 64 / 16 = 4 realizations: a multiple of D = 2, of D = 4 and of D C
    for name in ("dp2-single", "dp4-single", "dp2-chans"):
        assert int(worker.results(tmp, name)["trials_per_point"]) == 64


def test_sharded_step_matches_one_process_sums(runs):
    tmp, refs = runs
    got = {k[4:]: float(v) for k, v in worker.results(tmp, "step2").items()}
    ref = refs["step2"]
    assert got["trials"] == ref["trials"] == 2 * 16
    for k, v in ref.items():
        assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k


@pytest.mark.parametrize("tag", list(TP_ALGOS))
def test_model_axis_matches_trials_axis(runs, tag):
    """tests/test_parallel.py:297-305: the frame-split decodes of a (2, 2)
    mesh against the trials-only (4, 1) mesh on the same realizations:
    FER and SER within rel 1e-4, mean T within 5%."""
    tmp, _ = runs
    tp = _avg(worker.results(tmp, f"tp-{tag}"))
    dp = _avg(worker.results(tmp, f"dp-{tag}"))
    assert dp["T"] > 1.0
    for k in ("fer", "ser"):
        np.testing.assert_allclose(tp[k], dp[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(tp["T"], dp["T"], rtol=5e-2, err_msg="T")


@pytest.mark.parametrize("tag", list(TP_ALGOS))
def test_model_axis_two_phase_matches_single_phase(runs, tag):
    """tests/test_parallel.py:334-338: phase 2 resumes each rank's column
    slab of the same trial rows, so the two-phase sums equal the
    single-phase ones (rel 1e-5)."""
    tmp, _ = runs
    one = _avg(worker.results(tmp, f"tp-{tag}"))
    two = _avg(worker.results(tmp, f"tp-{tag}-two-phase"))
    assert one["T"] > 3.0            # trials survive k1 = 3
    for k in ("fer", "ser", "T", "nMSE"):
        np.testing.assert_allclose(two[k], one[k], rtol=1e-5, err_msg=k)


def test_model_axis_at_high(runs):
    """precision='high' reaches the frame-split decode: its sums differ
    from HIGHEST's in the float sums, and its two-phase run equals its
    single-phase one (rel 1e-5, as :334-338)."""
    tmp, _ = runs
    high = _avg(worker.results(tmp, "tp-bamp-high"))
    two = _avg(worker.results(tmp, "tp-bamp-high-two-phase"))
    highest = _avg(worker.results(tmp, "tp-bamp"))
    assert high["nMSE"] != highest["nMSE"]
    for k in ("fer", "ser", "T", "nMSE"):
        np.testing.assert_allclose(two[k], high[k], rtol=1e-5, err_msg=k)


def test_model_axis_ranks_see_the_same_sums(runs):
    tmp, _ = runs
    for tag in TP_ALGOS:
        r0 = worker.results(tmp, f"tp-{tag}", 0)
        for rank in range(1, 4):
            rr = worker.results(tmp, f"tp-{tag}", rank)
            for k in r0:
                np.testing.assert_array_equal(rr[k], r0[k], err_msg=k)


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals(runs, name):
    tmp, _ = runs
    kind, words, _ = REFUSALS[name]
    got = worker.results(tmp, name)
    assert str(got["error"]) == kind, got
    assert words in str(got["message"]), got


def test_only_rank_zero_writes_artifacts(runs):
    tmp, _ = runs
    r0 = worker.results(tmp, "simulate2", 0)
    r1 = worker.results(tmp, "simulate2", 1)
    files = json.loads(str(r0["files"]))
    assert any(f.endswith("manifest.json") for f in files), files
    assert any(f.endswith("6.0.json") for f in files), files
    assert json.loads(str(r1["files"])) == []
    assert int(r0["progress_lines"]) >= 1 and int(r1["progress_lines"]) == 0
    np.testing.assert_array_equal(r0["fer"], r1["fer"])


def test_resume_follows_rank_zero(runs):
    """A resumed sharded sweep skips the points rank 0's manifest lists on
    every rank (rank 1's own directory is empty), with rank 0's results."""
    tmp, _ = runs
    r0 = worker.results(tmp, "simulate2", 0)
    r1 = worker.results(tmp, "simulate2", 1)
    for r in (r0, r1):
        np.testing.assert_array_equal(r["fer_resumed"], r0["fer"])
    assert int(r0["resumed_lines"]) == len(r0["fer"])
    assert int(r1["resumed_lines"]) == 0


def test_cli_shard_matches_simulator(runs):
    """``cli sweep --shard --device cpu`` over two ranks writes the
    unsharded Simulator's point."""
    tmp, refs = runs
    path = os.path.join(tmp, "cli", refs["cli_path"], "7.0.json")
    with open(path) as f:
        got = json.load(f)
    _same_point({k: got[k] for k in refs["cli"]}, refs["cli"])
