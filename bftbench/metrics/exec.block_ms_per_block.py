"""exec.block_ms_per_block (ms, lower is better; source program_span; layer: execution (state/execution.py, models/kvstore.py); moves catchup_blocks_per_s; workloads: catchup.osmosis150).

blocksync.window.exec span time (the executor alone: FinalizeBlock,
the state save, Commit and the events) over the blocks the traced
passes applied
"""


def _per_block(ctx, span):
    ns = ctx.get("blocksync_ns", {}).get(span)
    return ns / 1e6 / ctx["attempted"] if ns and ctx.get("attempted") else None


def read(ctx):
    return _per_block(ctx, "blocksync.window.exec")
