"""light_headers_per_s (headers/s, higher is better, host clock):
light-client requests answered with a verified header in the window,
over the window's seconds."""

from bftbench.core import rate


def read(ctx):
    if "light" not in ctx:
        return None
    return rate(ctx["done"], ctx["t0"], ctx["end"])
