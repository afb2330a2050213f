"""The runtime half of the JAX package's analysis plane: the
concurrency sanitizer (``runtime``) and the committee-scaling probe
(``scaling``). The static linter the JAX ``analysis/__init__`` exports
(bftlint) waits for ROADMAP A10d."""

from . import runtime, scaling

__all__ = ["runtime", "scaling"]
