"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` compiles on its own into a shared library with
a plain C interface, for ``sm_90a`` (Hopper).  The library's file name
carries a hash of its source and flags, so a changed source rebuilds and
an unchanged one is loaded as it is.  Builds go to ``build/kernels/`` at
the repository root (listed in ``.gitignore``) at first use; nothing is
built when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("fused_bamp_decode",)
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


def library_path(name: str) -> Path:
    """Where the library of source ``name`` lives, keyed on its content."""
    digest = hashlib.sha256()
    digest.update((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every library of ``names`` that is missing, one ``nvcc``
    per source.  Returns ``{name: {"seconds", "cached", "ptxas"}}``;
    raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            report[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
            continue
        t0 = time.perf_counter()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                        "ptxas": proc.stdout}
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if missing."""
    if name not in _loaded:
        path = library_path(name)
        if not path.is_file():
            build([name])
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
