"""The PostgreSQL event sink's gate (reference state/indexer/sink/psql).

The JAX package's ``state/psql_sink.py`` streams tx results and block
events into relational tables through ``psycopg2``. The port has its
gate: ``tx_index.indexer = "psql"`` fails at node construction as the
JAX sink fails without ``psycopg2`` (a ``RuntimeError``) or without a
connection string (a ``ValueError``). The writer itself is not ported
(neither the development machine nor the card's has ``psycopg2``);
with ``psycopg2`` installed the sink raises ``NotImplementedError``
naming ROADMAP C17.
"""

from __future__ import annotations


def available() -> bool:
    try:
        import psycopg2  # noqa: F401

        return True
    except ImportError:
        return False


class PsqlSink:
    """Write-only event sink (reference psql.go); the gate only."""

    def __init__(self, conn_str: str, chain_id: str):
        if not available():
            raise RuntimeError("indexer = 'psql' requires psycopg2 (not installed)")
        if not conn_str:
            raise ValueError("psql indexer requires a connection string")
        raise NotImplementedError(
            "the psql sink's writer is not ported to cometbft_tpu_torch (ROADMAP C17)"
        )
