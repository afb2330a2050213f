"""The finalize pass: what a block's results hash and stored response
are made of.

The portable twin of the JAX package's ``state/native_finalize.py``,
byte-identical to its native lane by that module's contract: one
pass per block hashes every tx, encodes every ``ExecTxResult`` once
for both LastResultsHash and the stored FinalizeBlock response, and
encodes the events. The native ``finalize.cpp`` is not loaded.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

from ..abci import types as abci
from ..crypto import merkle
from ..utils import proto

# FlatEvent = (type, [(key, value, index), ...]): each event flattened once
FlatEvent = Tuple[str, List[Tuple[str, str, bool]]]


def flatten_events(events) -> List[FlatEvent]:
    return [(e.type_, [abci.attr_kvi(a) for a in e.attributes]) for e in (events or [])]


def encode_event_flat(fe: FlatEvent) -> bytes:
    """The ABCI Event encoding, from the flattened form."""
    type_, kvis = fe
    out = proto.field_string(1, type_)
    for k, v, idx in kvis:
        out += proto.field_bytes(
            2,
            proto.field_string(1, k) + proto.field_string(2, v) + proto.field_varint(3, 1 if idx else 0),
        )
    return out


class FinalizeArtifacts:
    """What the finalize pass derives from (txs, tx_results), once a
    block: ``tx_hashes``, ``results_enc`` (each result's encoding),
    ``results_hash`` (the RFC 6962 root over them), each tx's events
    flattened (``tx_events_flat``) and encoded (``tx_events_enc``), and
    the block events' (``block_events_flat``, ``block_events_enc``);
    the event bus hands the flat and encoded forms to the indexer and
    the RPC fan-out."""

    __slots__ = (
        "tx_hashes", "results_enc", "results_hash", "tx_events_flat", "tx_events_enc",
        "block_events_flat", "block_events_enc",
    )

    def __init__(
        self, tx_hashes, results_enc, results_hash, tx_events_flat, tx_events_enc,
        block_events_flat, block_events_enc,
    ):
        self.tx_hashes = tx_hashes
        self.results_enc = results_enc
        self.results_hash = results_hash
        self.tx_events_flat = tx_events_flat
        self.tx_events_enc = tx_events_enc
        self.block_events_flat = block_events_flat
        self.block_events_enc = block_events_enc


def finalize_pass(txs: Sequence[bytes], resp) -> FinalizeArtifacts:
    """The one pass a block; ``resp`` is the app's FinalizeBlock
    response."""
    sha = hashlib.sha256
    results_enc = [r.encode() for r in resp.tx_results]
    tx_flat = [flatten_events(r.events) for r in resp.tx_results]
    block_flat = flatten_events(resp.events)
    return FinalizeArtifacts(
        tx_hashes=[sha(tx).digest() for tx in txs],
        results_enc=results_enc,
        results_hash=merkle.hash_from_byte_slices(results_enc),
        tx_events_flat=tx_flat,
        tx_events_enc=[[encode_event_flat(fe) for fe in flat] for flat in tx_flat],
        block_events_flat=block_flat,
        block_events_enc=[encode_event_flat(fe) for fe in block_flat],
    )
