"""End-to-end multi-process test harness (reference test/e2e/).

A copy of the JAX package's ``e2e/``: manifests, the seeded manifest
generator, the load generator and latency report, and the runner,
whose children are ``python -m cometbft_tpu_torch --device <device>``
processes."""

from .manifest import Manifest, NodeSpec, Perturbation
from .runner import Runner

__all__ = ["Manifest", "NodeSpec", "Perturbation", "Runner"]
