"""The BPSK watch item of ROADMAP.md Queue 3, read through the third
witness: JAX's XLA banded BAMP decode at HIGH with its products in JAX's
``dot3`` (``tests/test_torch_plain_high.py::HighJnp``), on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/torch_bpsk_witness.py

Prints, for the realization of
``tests/test_torch_tiled_high.py::test_plane_loop_high_bpsk_within_the_parity_rule``
(16 trials) and for two BPSK batches of 1024 trials (seeds 0 and 1, the
same geometry), each decode's per-trial T or mean T against the witness:
the port's plane loop on K5's plain HIGH version
(``bamp.linear_step_high``), the port's plain loop at HIGH (the XLA body,
the witness's own function), and JAX's XLA decode at HIGHEST; the mean T
difference with its standard error from the per-trial differences, and
the count of trials that part.  About a minute.
"""
import numpy as np
import pytest

import test_torch_plain_high as ph
import test_torch_tiled_high as th
from test_torch_tiled import shared
from amp_sparc_spatialmodulation_tpu.models import bamp as jbamp
from amp_sparc_spatialmodulation_tpu.ops import operators as joperators
from amp_sparc_spatialmodulation_tpu_torch.models import bamp
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (
    fused_bamp_tiled)


def decodes(B, seed):
    """(witness, {name: T}) of one BPSK realization of ``B`` trials."""
    cfg, op, y, s2, jcfg, jop, jy = shared(Lin=8, Lh=3, alphabet="BPSK",
                                           B=B, seed=seed)
    jop_h = joperators.BandedOperator(jop.h, jop.gains, jcfg.Lin, jcfg.Lout,
                                      jcfg.trunc, precision=ph.HIGH)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (ph.joperators, ph.jscamp, ph.jvamp, ph.jvamp2):
            mp.setattr(mod, "jnp", ph.HighJnp())
        wit = jbamp.decode(jop_h, jy, s2, jcfg, precision=ph.HIGH).T
    s0 = bamp.initial_state(y, cfg.N, float(np.float32(s2)))
    t = lambda a: np.asarray(a).astype(float)
    return t(wit), {
        "K5 plain HIGH (linear_step_high)": t(fused_bamp_tiled.decode_plain(
            op, s0, y, s2, cfg.N_Layers, cfg, "high").T),
        "port plain loop at HIGH": t(bamp.decode(
            op, y, s2, cfg, precision="high", use_pallas=False).T),
        "JAX XLA at HIGHEST": t(jbamp.decode(jop, jy, s2, jcfg).T)}


def main():
    wit, runs = decodes(16, 0)
    _, port, ref = th.plane_loops_high(th.CASES[-1])
    print("16 trials, witness T:", wit.astype(int).tolist())
    print("  JAX K5 at HIGH      :", np.asarray(ref.T).tolist())
    for name, T in runs.items():
        print(f"  {name:33s}:", T.astype(int).tolist())
    for seed in (0, 1):
        wit, runs = decodes(1024, seed)
        for name, T in runs.items():
            d = T - wit
            print(f"seed {seed}, 1024 trials, {name}: mean T {T.mean():.4f}"
                  f" against the witness's {wit.mean():.4f}: "
                  f"{d.mean():+.4f} +- {d.std(ddof=1) / np.sqrt(d.size):.4f},"
                  f" {int((d != 0).sum())} trials part")


if __name__ == "__main__":
    main()
