"""device.idle_share.light (%, lower is better; source device_trace; layer: card; moves light_headers_per_s; workloads: lightstorm.hub180).

share of the traced window in which no kernel, copy or set ran on the
card
"""


def read(ctx):
    t = ctx.get("trace")
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t and t["window_s"] else None
