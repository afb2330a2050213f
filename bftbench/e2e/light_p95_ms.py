"""light_p95_ms (ms, lower is better, host clock): the 95th percentile
(nearest rank) of every request issued in the window, from its issue
to its answer (a verified header, or the refusal of a forged one); an
answer that comes after the window's end counts with its whole wait,
and a request that failed or never came counts as infinitely late."""

from bftbench.core import percentile


def read(ctx):
    if "light" not in ctx or not ctx["latencies_ms"]:
        return None
    return percentile(ctx["latencies_ms"], 0.95)
