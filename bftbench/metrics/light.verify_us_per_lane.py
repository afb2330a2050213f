"""light.verify_us_per_lane (us, lower is better; source program_span; layer: commit checks (types/validation.py); moves light_headers_per_s; workloads: lightstorm.hub180).

light.verify.coalesced span time (every span, through a tracer observer:
none dropped) over the light class's ed25519 lanes
"""


def read(ctx):
    c = ctx.get("light")
    return c["verify_ns"] / 1e3 / c["lanes"] if c and c["lanes"] and c["verify_ns"] else None
