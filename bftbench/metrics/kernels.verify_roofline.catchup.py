"""kernels.verify_roofline.catchup (%, higher is better; source device_trace; layer: kernels K1-K3 (csrc/*.cu); moves catchup_blocks_per_s; workloads: catchup.osmosis150).

the least time K1-K3 need on the traced dispatches' lanes and message
lengths (bftbench/roofline.py) over their device time in the profiler's
trace
"""


def _dispatch(ctx):
    from bftbench.drivers.common import dispatch_metrics

    if not ctx.get("dispatch_rows") or "trace" not in ctx:
        return {}
    return dispatch_metrics(ctx["dispatch_rows"], ctx["trace"]["kernel_s"], ctx["device"])


def read(ctx):
    return _dispatch(ctx).get("verify_roofline_pct")
