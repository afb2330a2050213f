"""JSON encoding of core types for the RPC layer.

Human-readable JSON (hex hashes/addresses, base64 txs — the reference's
conventions) PLUS lossless framework-native bytes: responses that feed
verification (light client, statesync) carry `*_b64` fields holding
the canonical codec encoding, so hashes recompute exactly on the
client side without a second JSON-canonicalisation scheme.

A copy of the JAX package's ``rpc/encoding.py``: the port's nodes and
the JAX package's answer with the same JSON."""

from __future__ import annotations

import base64
from typing import Any, Dict, Optional

from ..abci.types import attr_kvi
from ..types.block import Block, BlockID, Commit, Header
from ..types.validator_set import Validator, ValidatorSet


def b64(b: bytes) -> str:
    return base64.b64encode(bytes(b)).decode()


def unb64(s: str) -> bytes:
    return base64.b64decode(s)


def hexb(b) -> str:
    return bytes(b).hex().upper()


def header_json(h: Header) -> Dict[str, Any]:
    return {
        "chain_id": h.chain_id,
        "height": str(h.height),
        "time_ns": str(h.time_ns),
        "last_block_id": block_id_json(h.last_block_id),
        "last_commit_hash": hexb(h.last_commit_hash),
        "data_hash": hexb(h.data_hash),
        "validators_hash": hexb(h.validators_hash),
        "next_validators_hash": hexb(h.next_validators_hash),
        "consensus_hash": hexb(h.consensus_hash),
        "app_hash": hexb(h.app_hash),
        "last_results_hash": hexb(h.last_results_hash),
        "evidence_hash": hexb(h.evidence_hash),
        "proposer_address": hexb(h.proposer_address),
    }


def block_id_json(bid: Optional[BlockID]) -> Dict[str, Any]:
    if bid is None:
        return {"hash": "", "parts": {"total": 0, "hash": ""}}
    return {
        "hash": hexb(bid.hash) if bid.hash else "",
        "parts": {
            "total": bid.part_set_header.total if bid.part_set_header else 0,
            "hash": hexb(bid.part_set_header.hash)
            if bid.part_set_header and bid.part_set_header.hash
            else "",
        },
    }


def commit_json(c: Optional[Commit]) -> Optional[Dict[str, Any]]:
    if c is None:
        return None
    return {
        "height": str(c.height),
        "round": c.round,
        "block_id": block_id_json(c.block_id),
        "signatures": [
            {
                "block_id_flag": cs.block_id_flag,
                "validator_address": hexb(cs.validator_address)
                if cs.validator_address
                else "",
                "timestamp_ns": str(cs.timestamp_ns),
                "signature": b64(cs.signature) if cs.signature else None,
            }
            for cs in c.signatures
        ],
    }


def block_json(b: Block) -> Dict[str, Any]:
    return {
        "header": header_json(b.header),
        "data": {"txs": [b64(tx) for tx in b.data.txs]},
        "evidence": {
            "evidence": [
                {
                    "type": type(e).__name__,
                    "height": str(e.height()),
                    "bytes": b64(e.encode()),
                }
                for e in (b.evidence or [])
            ]
        },
        "last_commit": commit_json(b.last_commit),
    }


def validator_json(v: Validator) -> Dict[str, Any]:
    return {
        "address": hexb(v.address),
        "pub_key": {"type": v.pub_key.type_, "value": b64(bytes(v.pub_key))},
        "voting_power": str(v.voting_power),
        "proposer_priority": str(v.proposer_priority),
    }


def validator_set_json(vs: ValidatorSet) -> Dict[str, Any]:
    return {
        "validators": [validator_json(v) for v in vs.validators],
        "proposer": validator_json(vs.get_proposer())
        if vs.validators
        else None,
    }


def abci_event_json(e) -> Dict[str, Any]:
    return {
        "type": e.type_,
        "attributes": [
            dict(zip(("key", "value", "index"), attr_kvi(a)))
            for a in e.attributes
        ],
    }


def tx_result_json(r) -> Dict[str, Any]:
    return {
        "code": r.code,
        "data": b64(r.data) if getattr(r, "data", b"") else "",
        "log": getattr(r, "log", ""),
        "gas_wanted": str(getattr(r, "gas_wanted", 0)),
        "gas_used": str(getattr(r, "gas_used", 0)),
        # codespace is part of the DETERMINISTIC result subset that
        # feeds LastResultsHash — the light proxy recomputes the hash
        # from this JSON (light/proxy.py _verified_block_results)
        "codespace": getattr(r, "codespace", ""),
        "events": [
            abci_event_json(e) for e in getattr(r, "events", [])
        ],
    }
