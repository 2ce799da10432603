"""Device placement and seeding for the port's entry points."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks.

    ``None`` means ``cuda``; without a card that raises instead of carrying
    on silently on the CPU.  Pass ``device="cpu"`` to run on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def make_generator(device: torch.device, *entropy: int) -> torch.Generator:
    """A Philox/CPU generator on ``device`` seeded from integer entropy
    (base seed, SNR index, realization index, ...) through NumPy's
    ``SeedSequence``, so every realization draws an independent stream."""
    seed = int(np.random.SeedSequence([int(e) for e in entropy])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen
