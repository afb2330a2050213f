"""blocksync.lookahead_ms_per_block (ms, lower is better; source program_span; layer: replay loop (blocksync/reactor.py); moves catchup_blocks_per_s; workloads: catchup.osmosis150).

blocksync.window.lookahead span time (the next window's peek, jobs,
sign bytes and dispatch) over the blocks the traced passes applied
"""


def _per_block(ctx, span):
    ns = ctx.get("blocksync_ns", {}).get(span)
    return ns / 1e6 / ctx["attempted"] if ns and ctx.get("attempted") else None


def read(ctx):
    return _per_block(ctx, "blocksync.window.lookahead")
