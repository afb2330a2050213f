"""pack.us_per_lane.catchup (us, lower is better; source program_counter; layer: host packing and copy (ops/ed25519.py); moves catchup_blocks_per_s; workloads: catchup.osmosis150).

host packing ms of every dispatch (AsyncVerdicts.dispatch pack_ms) over
its lanes
"""


def _dispatch(ctx):
    from bftbench.drivers.common import dispatch_metrics

    if not ctx.get("dispatch_rows") or "trace" not in ctx:
        return {}
    return dispatch_metrics(ctx["dispatch_rows"], ctx["trace"]["kernel_s"], ctx["device"])


def read(ctx):
    return _dispatch(ctx).get("pack_us_per_lane")
