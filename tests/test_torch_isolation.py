"""The port stands alone: no JAX, nothing of the JAX package, and entry
points that refuse to fall back to the CPU silently."""
import ast
import pathlib
import shutil
import subprocess
import sys
from functools import partial

import pytest
import torch

from amp_sparc_spatialmodulation_tpu_torch.config import flagship_bamp_ook
from amp_sparc_spatialmodulation_tpu_torch.models.montecarlo import Simulator
from amp_sparc_spatialmodulation_tpu_torch.utils.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "amp_sparc_spatialmodulation_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "amp_sparc_spatialmodulation_tpu")


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), path


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_import_in_source():
    files = [p for _, p in _modules()] + [ROOT / "chip_smoke.py"]
    bad = [(str(p), name) for p in files for name in _imports(p)
           if _forbidden(name)]
    assert not bad, bad


def test_importing_every_module_loads_no_jax():
    names = [m for m, _ in _modules()]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in names)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            + repr({"jax", "jaxlib", "amp_sparc_spatialmodulation_tpu"})
            + ")\nprint(len(sys.modules) > 0 and bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_need_the_card_or_an_explicit_cpu():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    for algo in ("bamp", "vamp", "vamp2"):
        with pytest.raises(RuntimeError):
            Simulator(flagship_bamp_ook(), algo=algo)
        Simulator(flagship_bamp_ook(), algo=algo, device="cpu")


def test_analysis_entry_points_need_the_card_or_an_explicit_cpu(tmp_path):
    """``InfoTheory``, the single-trial experiments and the CLI subcommands
    that run on a device raise without a card unless asked for the CPU."""
    from amp_sparc_spatialmodulation_tpu_torch import cli
    from amp_sparc_spatialmodulation_tpu_torch.config import Config
    from amp_sparc_spatialmodulation_tpu_torch.models import capacity
    from amp_sparc_spatialmodulation_tpu_torch.models import sparc_tools
    if torch.cuda.is_available():
        return
    dims = dict(Nt=16, Na=2, Nr=12, Lin=6, Lh=2)
    cfg = Config(mode="sparc", alphabet="QPSK", **dims)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        capacity.InfoTheory(cfg, out_root=str(tmp_path))
    assert not (tmp_path / "Capacity").exists()
    capacity.InfoTheory(cfg, out_root=str(tmp_path), device="cpu")
    for fn in (partial(sparc_tools.run_single_trial, algo="bamp"),
               sparc_tools.compare_single_trial):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(cfg, 10.0)
    args = [w for k, v in dims.items() for w in (f"--{k}", str(v))]
    for cmd in (["capacity", "--epochs", "1", "--out", str(tmp_path)],
                ["sparc-trial", "--mode", "sparc", "--ebn0", "10"],
                ["sparc-trial", "--mode", "sparc", "--ebn0", "10",
                 "--sparc-algo", "both"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(cmd + args)


KERNEL_MODULES = ("fused_bamp", "fused_scamp", "fused_vamp", "fused_vamp2",
                  "fused_bamp_tiled", "fused_bamp_iteration")


def test_every_kernel_source_is_built_and_walked():
    """Every CUDA source under csrc/ is in the build list, and every kernel
    module (those of the massive-MIMO path included) is among the modules
    the import checks above walk."""
    from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import build
    sources = {p.stem for p in build.CSRC.glob("*.cu")}
    assert sources == set(build.SOURCES)
    names = {m for m, _ in _modules()}
    for mod in KERNEL_MODULES:
        assert f"amp_sparc_spatialmodulation_tpu_torch.ops.kernels.{mod}" \
            in names


@pytest.mark.parametrize("mod", KERNEL_MODULES)
def test_kernel_modules_build_nothing_at_import(mod, tmp_path):
    """Importing a kernel module (in a fresh process, with no CUDA toolkit
    to be found) loads no library and runs no compiler."""
    code = (f"from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import "
            f"build, {mod}\n"
            "assert not build._loaded\n"
            "print(sorted(build.BUILD_DIR.glob('*.tmp')))\n")
    env = {"PATH": "/usr/bin:/bin", "CUDA_HOME": str(tmp_path / "none"),
           "HOME": str(tmp_path), "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("name", ["operator_from_numpy", "message_from_numpy",
                                  "state_from_numpy",
                                  "scamp_state_from_numpy",
                                  "svd_from_numpy", "vamp_state_from_numpy",
                                  "vamp2_state_from_numpy",
                                  "plane_from_jax"])
def test_interop_constructors_take_no_default_device(name):
    """The NumPy-in constructors place nothing on a device by default."""
    import inspect

    from amp_sparc_spatialmodulation_tpu_torch import interop
    param = inspect.signature(getattr(interop, name)).parameters["device"]
    assert param.default is inspect.Parameter.empty


def test_chip_smoke_fails_without_card_or_package(tmp_path):
    """Without a card, and alone in a directory, chip_smoke.py exits
    non-zero and prints no result."""
    runs = []
    if not torch.cuda.is_available():
        runs.append(ROOT)
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone / "chip_smoke.py")
    runs.append(alone)
    for cwd in runs:
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0, cwd
        assert '"ok"' not in out.stdout, cwd
