"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` compiles on its own into a shared library with
a plain C interface, for ``sm_90a`` (Hopper); the sources of one build run
their ``nvcc`` side by side.  The library's file name carries a hash of its
source, of every header under ``csrc/`` it includes and of the flags, so a
changed source or header rebuilds and an unchanged one is loaded as it
is.  Builds go to ``build/kernels/`` at the repository root (listed in
``.gitignore``) at first use; nothing is built when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("fused_bamp_decode", "fused_bamp_cluster", "fused_scamp_decode",
           "fused_vamp_decode", "fused_vamp2_decode", "fused_bamp_tiled",
           "fused_bamp_iteration")
# -fmad=false: elementwise expressions round after every operation, as
# PyTorch's separate elementwise kernels do; explicit fmaf() stays fused.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, the usual install, or PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit")
    return found


def _local_includes(path: Path) -> List[Path]:
    """``path`` and every file under ``csrc/`` it includes with
    ``#include "..."``, directly or through another such file."""
    seen, todo = [], [path]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.append(f)
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                               f.read_text(), flags=re.M):
            inc = CSRC / name
            if inc.is_file():
                todo.append(inc)
    return seen


def library_path(name: str) -> Path:
    """Where the library of source ``name`` lives, keyed on its content
    and that of the headers it includes."""
    digest = hashlib.sha256()
    for f in _local_includes(CSRC / f"{name}.cu"):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every library of ``names`` that is missing, one ``nvcc``
    per source, all started together.  Returns ``{name: {"seconds",
    "cached", "ptxas"}}``; raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report, running = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.is_file():
            report[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {name}:\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                        "ptxas": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if missing."""
    if name not in _loaded:
        path = library_path(name)
        if not path.is_file():
            build([name])
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
