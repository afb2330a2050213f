"""light.cache_hit_share (%, higher is better; source program_counter; layer: light serving plane (light/serving.py); moves light_headers_per_s; workloads: lightstorm.hub180).

requests the verified-header cache answered: VerifiedHeaderCache.stats()
(hits + flight waits) over (hits + misses), summed over the window's
planes
"""


def read(ctx):
    c = ctx.get("light")
    n = c["hits"] + c["misses"] if c else 0
    return 100.0 * (c["hits"] + c["flight_waits"]) / n if n else None
