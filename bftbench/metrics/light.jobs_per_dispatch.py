"""light.jobs_per_dispatch (jobs, higher is better; source program_counter; layer: light serving plane (light/serving.py); moves light_headers_per_s; workloads: lightstorm.hub180).

commit-check jobs a coalesced dispatch carries:
CoalescedCommitVerifier.stats() jobs batched over dispatches, summed
over the window's planes
"""


def read(ctx):
    c = ctx.get("light")
    return c["jobs_batched"] / c["dispatches"] if c and c["dispatches"] else None
