"""sched.lanes_per_dispatch.light (lanes, higher is better; source program_counter; layer: scheduler (crypto/scheduler.py); moves light_headers_per_s; workloads: lightstorm.hub180).

ed25519 lanes over device dispatches in the window:
VerifyScheduler.stats()
"""


def read(ctx):
    s = ctx.get("sched")
    return s["lanes"] / s["device_dispatches"] if s and s["device_dispatches"] else None
