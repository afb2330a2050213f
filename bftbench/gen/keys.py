"""Seeds for the generators."""

from __future__ import annotations

import numpy as np


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use of the run's seed."""
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])
