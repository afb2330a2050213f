"""The finalize pass: what a block's results hash and stored response
are made of, natively (``native/finalize.cpp``) or by its portable twin.

The port's counterpart of the JAX package's ``state/native_finalize.py``.
One pass a block hashes every tx, encodes every ``ExecTxResult`` once
for both LastResultsHash and the stored FinalizeBlock response, folds
the RFC 6962 root and encodes the ABCI events, which are flattened once
here and handed as ``FinalizeArtifacts`` to the stored response, the
event bus, the indexer and the RPC fan-out. The native pass does all of
it in one call with the GIL released; ``utils/native.py`` builds it into
``build/native/_finalize.so``. ``module()`` never makes a caller wait for
a build in flight (``build_node`` calls ``prewarm()``), and the portable
pass below is byte-identical: the semantic source of truth and the
fallback. ``GRAFT_NATIVE_FINALIZE=0`` disables the lane.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Tuple

from ..abci import types as abci
from ..crypto import merkle
from ..utils import native, proto

LANE = native.Lane("finalize", gate="GRAFT_NATIVE_FINALIZE")


def module():
    """The extension module, or None (``LANE.reason`` says why)."""
    return LANE.module()


def prewarm():
    """Start the one-time build on a daemon thread; None once tried."""
    return LANE.prewarm()


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


def _native_events(flat: Sequence[FlatEvent]) -> list:
    return [(t.encode(), [(k.encode(), v.encode(), 1 if i else 0) for k, v, i in kvis])
            for t, kvis in flat]


def encode_events_flat(flat: Sequence[FlatEvent]) -> List[bytes]:
    """Each flattened event's encoding; native when the lane is built."""
    nat = module()
    if nat is not None and flat:
        try:
            return nat.encode_events(_native_events(flat))
        except Exception:  # pragma: no cover - defensive parity net
            pass
    return [encode_event_flat(fe) for fe in flat]


class FinalizeArtifacts:
    """What the finalize pass derives from (txs, tx_results), once a
    block: ``tx_hashes``, ``results_enc`` (each result's encoding),
    ``results_hash`` (the RFC 6962 root over them), each tx's events
    flattened (``tx_events_flat``) and encoded (``tx_events_enc``), the
    block events' (``block_events_flat``, ``block_events_enc``), and
    ``native``: whether the native pass made them. The event bus hands
    the flat and encoded forms to the indexer and the RPC fan-out."""

    __slots__ = (
        "tx_hashes", "results_enc", "results_hash", "tx_events_flat", "tx_events_enc",
        "block_events_flat", "block_events_enc", "native",
    )

    def __init__(
        self, tx_hashes, results_enc, results_hash, tx_events_flat, tx_events_enc,
        block_events_flat, block_events_enc, native: bool = False,
    ):
        self.tx_hashes = tx_hashes
        self.results_enc = results_enc
        self.results_hash = results_hash
        self.tx_events_flat = tx_events_flat
        self.tx_events_enc = tx_events_enc
        self.block_events_flat = block_events_flat
        self.block_events_enc = block_events_enc
        self.native = native


def _portable_pass(txs, flat_results):
    """The native pass's byte-for-byte twin: SHA-256 a tx, the
    ExecTxResult encoding a result, the binary-carry RFC 6962 fold, the
    event encodings."""
    sha = hashlib.sha256
    tx_hashes = [sha(tx).digest() for tx in txs]
    results_enc = []
    tx_events_enc = []
    for code, data, gw, gu, codespace, flat in flat_results:
        results_enc.append(
            proto.field_varint(1, code)
            + proto.field_bytes(2, data)
            + proto.field_varint(5, gw)
            + proto.field_varint(6, gu)
            + proto.field_string(8, codespace)
        )
        tx_events_enc.append([encode_event_flat(fe) for fe in flat])
    return tx_hashes, results_enc, merkle.hash_from_byte_slices(results_enc), tx_events_enc


def finalize_pass(txs: Sequence[bytes], resp, portable: Optional[bool] = None) -> FinalizeArtifacts:
    """The one pass a block; ``resp`` is the app's FinalizeBlock
    response. ``portable=True`` forces the Python twin. The events are
    flattened once, here, whichever pass runs."""
    tx_events_flat = [flatten_events(r.events) for r in resp.tx_results]
    block_events_flat = flatten_events(resp.events)
    flat_results = [
        (r.code, r.data, r.gas_wanted, r.gas_used, r.codespace, flat)
        for r, flat in zip(resp.tx_results, tx_events_flat)
    ]
    nat = None if portable else module()
    native_ = False
    if nat is not None:
        try:
            tx_hashes, results_enc, res_hash, tx_events_enc = nat.finalize_pass(
                list(txs),
                [(code, data, gw, gu, codespace.encode(), _native_events(flat))
                 for code, data, gw, gu, codespace, flat in flat_results],
            )
            native_ = True
        except Exception:  # pragma: no cover - defensive parity net
            nat = None
    if nat is None:
        tx_hashes, results_enc, res_hash, tx_events_enc = _portable_pass(txs, flat_results)
    return FinalizeArtifacts(
        tx_hashes=tx_hashes,
        results_enc=results_enc,
        results_hash=res_hash,
        tx_events_flat=tx_events_flat,
        tx_events_enc=tx_events_enc,
        block_events_flat=block_events_flat,
        block_events_enc=([encode_event_flat(fe) for fe in block_events_flat] if portable
                          else encode_events_flat(block_events_flat)),
        native=native_,
    )


def part_leaf_hashes(chunks: Sequence[bytes]) -> Optional[List[bytes]]:
    """The RFC 6962 leaf hashes of a proposal's block parts
    (SHA-256(0x00 || part), GIL released), or None when the lane is not
    built: ``PartSet.from_data`` then hashes the leaves in Python."""
    nat = module()
    if nat is None:
        return None
    try:
        return nat.leaf_hashes(list(chunks))
    except Exception:  # pragma: no cover - defensive parity net
        return None
