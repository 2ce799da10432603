"""The port's plotting, profiling and CLI front end on the CPU.

* ``Plotter.get_metrics`` equals the JAX package's ``Plotter`` on the same
  artifact directory, and both write PNGs of the same names;
* the three cases of ``tests/test_profiling.py`` on the port's
  ``Profiler``, and ``torch_trace`` (the counterpart of ``xla_trace``)
  writes a Chrome trace;
* the CLI: ``sweep --plot`` writes the JSON and the PNGs (the twin of
  ``test_analysis.py::test_cli_sweep_and_plot``), ``plot`` rebuilds them,
  ``capacity`` writes the CSV, ``sparc-trial`` prints the JAX CLI's
  fields, all with ``--device cpu``.
"""
import ast
import json
import os
import time

import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu.config import Config as JConfig
from amp_sparc_spatialmodulation_tpu.utils import artifacts as jartifacts
from amp_sparc_spatialmodulation_tpu.utils.metrics import METRIC_KEYS
from amp_sparc_spatialmodulation_tpu.utils.plotting import Plotter as JPlotter
from amp_sparc_spatialmodulation_tpu_torch import cli
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.utils import profiling
from amp_sparc_spatialmodulation_tpu_torch.utils.plotting import Plotter

CFG = dict(Nt=8, Na=2, Nr=4, Lin=4, Lh=2, mode="segmented",
           alphabet="QPSK", trunc="tail", profile="uniform", iterations=10)
SPARC_TRIAL_KEYS = ["ser", "fer", "nmse", "C", "rate_nats"]


def _write_points(root, algo_dir="BAMP"):
    cfg = JConfig(**CFG)
    d = os.path.join(str(root), algo_dir, cfg.name)
    rng = np.random.default_rng(1)
    for e, fer in [(6.0, 0.5), (7.0, 0.1), (8.0, 0.01), (9.5, 0.0)]:
        avg = {k: float(rng.random()) * fer for k in METRIC_KEYS}
        avg["fer"], avg["T"] = fer, 20.0 - e
        jartifacts.export_point(d, e, e + 0.8, cfg, avg)
    return d


@pytest.mark.parametrize("algo_dir", ["BAMP", "SCAMP"])
def test_plotter_matches_jax(tmp_path, algo_dir):
    d = _write_points(tmp_path, algo_dir)
    jp = JPlotter(JConfig(**CFG), algo_dir, out_root=str(tmp_path))
    pp = Plotter(Config(**CFG), algo_dir, out_root=str(tmp_path))
    want, got = jp.get_metrics(), pp.get_metrics()
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert pp.shannon_limit == jp.shannon_limit
    assert pp.dir == jp.dir == d and pp.name == jp.name
    jpng = [jp.plot_metrics(), jp.plot_iter()]
    names = {os.path.basename(p) for p in jpng}
    for p in jpng:
        os.remove(p)
    ppng = [pp.plot_metrics(), pp.plot_iter()]
    assert {os.path.basename(p) for p in ppng} == names
    assert all(os.path.getsize(p) > 0 for p in ppng)
    custom = pp.plot_iter(save=str(tmp_path / "iter.png"))
    assert custom == str(tmp_path / "iter.png") and os.path.exists(custom)


def test_plotter_without_artifacts_raises(tmp_path):
    for P, C in ((Plotter, Config), (JPlotter, JConfig)):
        with pytest.raises(FileNotFoundError):
            P(C(**CFG), "BAMP", out_root=str(tmp_path))


def test_phase_accumulation(tmp_path):
    prof = profiling.Profiler()
    with prof.phase("decode", items=100):
        time.sleep(0.01)
    with prof.phase("decode", items=100):
        time.sleep(0.01)
    with prof.phase("export"):
        pass
    rep = prof.report()
    assert rep["decode"]["calls"] == 2
    assert rep["decode"]["items"] == 200
    assert rep["decode"]["seconds"] >= 0.02
    assert rep["decode"]["items_per_s"] > 0
    assert rep["export"]["items_per_s"] == 0
    path = tmp_path / "prof.json"
    prof.dump(str(path))
    assert json.load(open(path))["decode"]["calls"] == 2
    prof.add_items("export", 5)
    assert prof.phases["export"].items == 5


def test_phase_records_on_exception():
    prof = profiling.Profiler()
    try:
        with prof.phase("boom", items=1):
            raise RuntimeError("x")
    except RuntimeError:
        pass
    assert prof.phases["boom"].calls == 1


def test_trace_noop():
    with profiling.torch_trace(None) as prof:
        pass  # no-op without a log dir
    assert prof is None


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    log = tmp_path / "trace"
    with profiling.torch_trace(str(log), device="cpu") as prof:
        a = torch.ones(64, 64)
        (a @ a).sum()
    assert prof is not None
    path = log / profiling.TRACE_FILE
    events = json.load(open(path))["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def _sweep(tmp_path, *extra):
    return cli.main(["sweep", "--Nt", "8", "--Na", "2", "--Nr", "6",
                     "--Lin", "4", "--Lh", "2", "--alphabet", "OOK",
                     "--iterations", "20", "--epochs", "16", "--res", "8",
                     "--start", "8", "--final", "10", "--out",
                     str(tmp_path), "--device", "cpu", *extra])


def test_cli_sweep_and_plot(tmp_path, capsys):
    """The port's twin of ``test_analysis.py::test_cli_sweep_and_plot``."""
    assert _sweep(tmp_path, "--plot") == 0
    cfg = Config(Nt=8, Na=2, Nr=6, Lin=4, Lh=2, mode="segmented",
                 alphabet="OOK", trunc="tail", profile="uniform",
                 iterations=20)
    d = os.path.join(str(tmp_path), "BAMP", cfg.name)
    files = os.listdir(d)
    assert any(f.endswith(".json") and f != "manifest.json" for f in files)
    pngs = sorted(f for f in files if f.endswith(".png"))
    assert len(pngs) == 2
    printed = capsys.readouterr().out.split()
    assert sorted(os.path.basename(p) for p in printed
                  if p.endswith(".png")) == pngs
    for f in pngs:
        os.remove(os.path.join(d, f))
    assert cli.main(["plot", "--Nt", "8", "--Na", "2", "--Nr", "6", "--Lin",
                     "4", "--Lh", "2", "--alphabet", "OOK", "--iterations",
                     "20", "--algo-dir", "BAMP", "--out",
                     str(tmp_path)]) == 0
    assert sorted(f for f in os.listdir(d) if f.endswith(".png")) == pngs


def test_cli_sweep_without_plot_draws_nothing(tmp_path):
    assert _sweep(tmp_path, "--algo-dir", "X") == 0
    for _, _, files in os.walk(tmp_path):
        assert not any(f.endswith(".png") for f in files)


def test_cli_capacity_writes_the_csv(tmp_path):
    assert cli.main(["capacity", "--Nt", "8", "--Na", "2", "--Nr", "4",
                     "--Lin", "4", "--Lh", "2", "--alphabet", "QPSK",
                     "--epochs", "2", "--start", "2", "--final", "3",
                     "--out", str(tmp_path), "--device", "cpu"]) == 0
    d = os.path.join(str(tmp_path), "Capacity", Config(**CFG).name)
    (csv,) = os.listdir(d)
    with open(os.path.join(d, csv)) as f:
        lines = f.read().splitlines()
    assert lines[0] == ",EbN0dB,SNRdB,Cawgn,Cfs,Cwf,Mi" and len(lines) == 3


def _trial_lines(capsys, *args):
    assert cli.main(["sparc-trial", "--Nt", "16", "--Na", "2", "--Nr", "12",
                     "--Lin", "6", "--Lh", "2", "--mode", "sparc",
                     "--alphabet", "QPSK", "--iterations", "40", "--ebn0",
                     "12", "--device", "cpu", *args]) == 0
    return [ast.literal_eval(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]


def test_cli_sparc_trial_both_prints_both_dicts(capsys):
    lines = _trial_lines(capsys, "--sparc-algo", "both")
    assert [ln["algo"] for ln in lines] == ["scamp", "bamp"]
    for ln in lines:
        assert list(ln) == ["algo"] + SPARC_TRIAL_KEYS


@pytest.mark.parametrize("args", [("--power-allocation",),
                                  ("--estimate-phi", "--sparc-algo",
                                   "scamp"),
                                  ("--sparc-algo", "bamp", "--seed", "3")])
def test_cli_sparc_trial_one_decoder(capsys, args):
    (line,) = _trial_lines(capsys, *args)
    assert list(line) == SPARC_TRIAL_KEYS
    assert 0.0 <= line["ser"] <= 1.0 and line["fer"] in (0.0, 1.0)


def test_cli_sparc_trial_fields_are_the_jax_clis(capsys):
    """The JAX CLI's printed dict has the same keys in the same order."""
    from amp_sparc_spatialmodulation_tpu.cli import main as jmain
    port = _trial_lines(capsys, "--sparc-algo", "both")
    assert jmain(["sparc-trial", "--Nt", "16", "--Na", "2", "--Nr", "12",
                  "--Lin", "6", "--Lh", "2", "--mode", "sparc",
                  "--alphabet", "QPSK", "--iterations", "40", "--ebn0",
                  "12", "--sparc-algo", "both"]) == 0
    jax_lines = [ast.literal_eval(ln) for ln in
                 capsys.readouterr().out.strip().splitlines()]
    assert [list(d) for d in port] == [list(d) for d in jax_lines]
    assert [(d["C"], d["rate_nats"]) for d in port] == \
        [(d["C"], d["rate_nats"]) for d in jax_lines]
