"""Inputs drawn from ``--seed``.

Every draw is a ``torch.Generator`` on the device seeded from a stream
``(seed, index)``, so a seed gives the same inputs on every run, and any
whole seed, negative or past 64 bits, is taken mod 2**64.
"""

from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, index: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for the stream ``(seed,
    index)``."""
    state = np.random.SeedSequence([seed % 2 ** 64, index]).generate_state(
        1, dtype=np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def normal(seed: int, index: int, shape, device, dtype=torch.float32):
    """A normal block of ``shape`` on ``device``, drawn from ``(seed,
    index)``."""
    return torch.randn(shape, generator=generator(seed, index, device),
                       dtype=dtype, device=device)


def signs(seed: int, index: int, shape, device, dtype=torch.float64):
    """Values of +1 or -1 of ``shape``, drawn from ``(seed, index)``."""
    return torch.randint(0, 2, shape, generator=generator(seed, index,
                                                          device),
                         device=device).to(dtype) * 2 - 1
