"""bftlint: stdlib-ast static analysis for cometbft_tpu_torch, and the
runtime half of the analysis plane.

The static linter's two rule families guard the two failure classes
that silently kill BFT throughput: async-safety (a blocked or starved
event loop stalls every reactor at once) and torch hot-path hygiene
(a host sync on the loop, a per-element loop over a tensor or a
kernel build per call collapses batch throughput). The rules are the
JAX package's, their plane prefixes keyed on the path inside the
scanned package (so the same planes apply to either tree), with the
torch rules (TCH201-204) in place of the JAX ones (JAX201-204).

    python -m cometbft_tpu_torch.analysis [paths...]

The runtime half is the concurrency sanitizer (``runtime``) and the
committee-scaling probe (``scaling``).

Public API:
    analyze_source(src, path) -> [Finding]   (unit-test entry point)
    run(paths)               -> [Finding]    (filesystem walk)
    main(argv)               -> exit code    (CLI)
"""

from . import runtime, scaling
from .cli import main
from .engine import analyze_source, run
from .findings import Finding
from .registry import all_rules

__all__ = ["Finding", "all_rules", "analyze_source", "main", "run", "runtime", "scaling"]
