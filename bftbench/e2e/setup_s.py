"""setup_s (s, lower is better, host clock): process start to the
window's first timed request: imports, the card's context, the cell's
chain minted from the seed, the kernels loaded or built, one untimed
round or pass."""


def read(ctx):
    return ctx.get("setup_s")
