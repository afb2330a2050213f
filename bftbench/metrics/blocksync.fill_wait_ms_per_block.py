"""blocksync.fill_wait_ms_per_block (ms, lower is better; source program_span; layer: replay loop (blocksync/reactor.py); moves catchup_blocks_per_s; workloads: catchup.osmosis150).

blocksync.window.fill_wait span time (the replay loop waiting on its
peers for a second block, blocksync/pool.py) over the blocks the
traced passes applied
"""


def _per_block(ctx, span):
    ns = ctx.get("blocksync_ns", {}).get(span)
    return ns / 1e6 / ctx["attempted"] if ns and ctx.get("attempted") else None


def read(ctx):
    return _per_block(ctx, "blocksync.window.fill_wait")
