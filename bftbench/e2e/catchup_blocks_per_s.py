"""catchup_blocks_per_s (blocks/s, higher is better, host clock):
blocks the joiners verified, applied and stored in the window, over
the window's seconds."""

from bftbench.core import rate


def read(ctx):
    if "passes" not in ctx:
        return None
    return rate(ctx["done"], ctx["t0"], ctx["end"])
