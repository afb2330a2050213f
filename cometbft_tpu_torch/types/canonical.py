"""Canonical sign bytes (reference types/canonical.go).

The encoding every vote and proposal signature covers, and so the
bytes the GPU hashes per lane (and the vote-extension encoding beside
it): protobuf CanonicalVote / CanonicalProposal, varint-length-delimited
(libs/protoio), sfixed64 height/round, the chain id last. Byte
identical to the JAX package's ``types/canonical.py``.
"""

from __future__ import annotations

from ..utils import proto
from .block import BlockID

PREVOTE_TYPE = 1
PRECOMMIT_TYPE = 2
PROPOSAL_TYPE = 32


def canonical_block_id(bid: BlockID):
    if bid is None or bid.is_nil():
        return None
    psh = proto.field_varint(1, bid.part_set_header.total) + proto.field_bytes(
        2, bid.part_set_header.hash
    )
    return proto.field_bytes(1, bid.hash) + proto.field_message(2, psh)


def vote_sign_bytes_parts(
    chain_id: str, type_: int, height: int, round_: int, block_id: BlockID
):
    """(prefix, suffix) of the CanonicalVote body around the timestamp:
    all but the timestamp is shared by the signatures of one commit."""
    prefix = proto.field_varint(1, type_)
    prefix += proto.field_sfixed64(2, height)
    prefix += proto.field_sfixed64(3, round_)
    cbid = canonical_block_id(block_id)
    if cbid is not None:
        prefix += proto.field_message(4, cbid)
    return prefix, proto.field_string(6, chain_id)


def finish_vote_sign_bytes(prefix: bytes, suffix: bytes, timestamp_ns: int) -> bytes:
    return proto.delimited(
        prefix + proto.field_message(5, proto.timestamp(timestamp_ns)) + suffix
    )


def vote_sign_bytes(
    chain_id: str,
    type_: int,
    height: int,
    round_: int,
    block_id: BlockID,
    timestamp_ns: int,
) -> bytes:
    """CanonicalVote encoding, length-delimited (types/vote.go:152)."""
    prefix, suffix = vote_sign_bytes_parts(chain_id, type_, height, round_, block_id)
    return finish_vote_sign_bytes(prefix, suffix, timestamp_ns)


def proposal_sign_bytes(
    chain_id: str,
    height: int,
    round_: int,
    pol_round: int,
    block_id: BlockID,
    timestamp_ns: int,
) -> bytes:
    """CanonicalProposal encoding, length-delimited (types/proposal.go)."""
    body = proto.field_varint(1, PROPOSAL_TYPE)
    body += proto.field_sfixed64(2, height)
    body += proto.field_sfixed64(3, round_)
    body += proto.field_sfixed64(4, pol_round)
    cbid = canonical_block_id(block_id)
    if cbid is not None:
        body += proto.field_message(5, cbid)
    body += proto.field_message(6, proto.timestamp(timestamp_ns))
    body += proto.field_string(7, chain_id)
    return proto.delimited(body)


def vote_extension_sign_bytes(
    chain_id: str, height: int, round_: int, extension: bytes
) -> bytes:
    """CanonicalVoteExtension, length-delimited (ABCI 2.0 vote
    extensions)."""
    body = proto.field_bytes(1, extension)
    body += proto.field_sfixed64(2, height)
    body += proto.field_sfixed64(3, round_)
    body += proto.field_string(4, chain_id)
    return proto.delimited(body)
