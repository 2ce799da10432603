"""Tracing / profiling utilities.

Port of the JAX package's ``utils/profiling.py``: lightweight wall-clock
phase timers with derived throughput counters (trials/s, AMP-iterations/s),
copied as they are, and :func:`torch_trace`, the counterpart of the JAX
package's ``xla_trace``: a ``torch.profiler`` trace of a block, written as
a Chrome trace.

A phase's clock stops when its block returns, so a block that ends in a
host read of a device result (``Simulator.run_point`` does) times the
device work too; otherwise synchronize inside the block.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

TRACE_FILE = "trace.json"


@dataclass
class PhaseStats:
    calls: int = 0
    seconds: float = 0.0
    items: float = 0.0

    @property
    def items_per_s(self) -> float:
        return self.items / self.seconds if self.seconds else 0.0


@dataclass
class Profiler:
    """Accumulates per-phase wall time and item counts.

    Usage::

        prof = Profiler()
        with prof.phase("decode", items=batch_size):
            out = step(...)
        print(prof.report())
    """

    phases: Dict[str, PhaseStats] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, items: float = 0.0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            st = self.phases.setdefault(name, PhaseStats())
            st.calls += 1
            st.seconds += dt
            st.items += items

    def add_items(self, name: str, items: float) -> None:
        self.phases.setdefault(name, PhaseStats()).items += items

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {"calls": v.calls, "seconds": round(v.seconds, 4),
                    "items": v.items,
                    "items_per_s": round(v.items_per_s, 2)}
                for k, v in self.phases.items()}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str], device=None):
    """``torch.profiler`` trace of the block, the counterpart of the JAX
    package's ``xla_trace`` (a ``jax.profiler`` trace); no-op when
    ``log_dir`` is None.

    Records CPU activity, and CUDA activity (every kernel the block
    launches, those loaded through ctypes included) when ``device`` is a
    CUDA device, or when it is None and a card is present.  Yields the
    profiler (None without ``log_dir``); on leaving the block, writes the
    Chrome trace ``log_dir/trace.json``.
    """
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
