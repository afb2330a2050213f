"""Encode and decode of consensus artifacts (storage and wire).

A copy of the portable paths of the JAX package's ``utils/codec.py``:
block ID, header, commit sig, commit, extended commit, block, vote,
validator and validator set, and proposal, in the same proto wire
format and field numbers, so bytes written by one package decode in
the other. Commit encode and decode take the native wire codec
(``utils/wirecodec.py``) when it is built; the Python paths stay the
semantic source of truth and the fallback, and the native decoder
defers to them on any ``ValueError``. A block's evidence (field 4) is
each piece's own encoding (``evidence/types.py``).
"""

from __future__ import annotations

from ..crypto.keys import (
    ED25519_KEY_TYPE,
    SECP256K1_KEY_TYPE,
    Ed25519PubKey,
    PubKey,
    Secp256k1PubKey,
    pubkey_from_type_bytes,
)
from ..types.block import (
    Block,
    BlockID,
    Commit,
    CommitSig,
    Data,
    ExtendedCommit,
    ExtendedCommitSig,
    Header,
    PartSetHeader,
)
from ..types.validator_set import Validator, ValidatorSet
from ..types.vote import Proposal, Vote
from . import proto, wirecodec

# --- pubkeys ------------------------------------------------------------


def encode_pubkey(pk: PubKey) -> bytes:
    if isinstance(pk, Ed25519PubKey):
        return proto.field_bytes(1, pk.key_bytes)
    if isinstance(pk, Secp256k1PubKey):
        return proto.field_bytes(2, pk.key_bytes)
    raise ValueError("unknown pubkey type")


def decode_pubkey(b: bytes) -> PubKey:
    m = proto.parse(b)
    if 1 in m:
        return pubkey_from_type_bytes(ED25519_KEY_TYPE, m[1][0])
    if 2 in m:
        return pubkey_from_type_bytes(SECP256K1_KEY_TYPE, m[2][0])
    raise ValueError("empty pubkey")


# --- block id -----------------------------------------------------------


def encode_block_id(bid: BlockID) -> bytes:
    return bid.encode()


def decode_block_id(b: bytes) -> BlockID:
    m = proto.parse(b)
    pshb = proto.get1(m, 2, b"")
    psh = PartSetHeader()
    if pshb:
        pm = proto.parse(pshb)
        psh = PartSetHeader(proto.get1(pm, 1, 0), proto.get1(pm, 2, b""))
    return BlockID(proto.get1(m, 1, b""), psh)


# --- header -------------------------------------------------------------


def encode_header(h: Header) -> bytes:
    ver = proto.field_varint(1, h.version_block) + proto.field_varint(
        2, h.version_app
    )
    return b"".join(
        [
            proto.field_message(1, ver),
            proto.field_string(2, h.chain_id),
            proto.field_varint(3, h.height),
            proto.field_message(4, proto.timestamp(h.time_ns)),
            proto.field_message(5, h.last_block_id.encode()),
            proto.field_bytes(6, h.last_commit_hash),
            proto.field_bytes(7, h.data_hash),
            proto.field_bytes(8, h.validators_hash),
            proto.field_bytes(9, h.next_validators_hash),
            proto.field_bytes(10, h.consensus_hash),
            proto.field_bytes(11, h.app_hash),
            proto.field_bytes(12, h.last_results_hash),
            proto.field_bytes(13, h.evidence_hash),
            proto.field_bytes(14, h.proposer_address),
        ]
    )


def decode_header(b: bytes) -> Header:
    m = proto.parse(b)
    vb = va = 0
    if 1 in m:
        vm = proto.parse(m[1][0])
        vb, va = proto.get1(vm, 1, 0), proto.get1(vm, 2, 0)
    return Header(
        version_block=vb,
        version_app=va,
        chain_id=proto.get1(m, 2, b"").decode(),
        height=proto.get1(m, 3, 0),
        time_ns=proto.parse_timestamp(proto.get1(m, 4, b"")),
        last_block_id=decode_block_id(proto.get1(m, 5, b"")),
        last_commit_hash=proto.get1(m, 6, b""),
        data_hash=proto.get1(m, 7, b""),
        validators_hash=proto.get1(m, 8, b""),
        next_validators_hash=proto.get1(m, 9, b""),
        consensus_hash=proto.get1(m, 10, b""),
        app_hash=proto.get1(m, 11, b""),
        last_results_hash=proto.get1(m, 12, b""),
        evidence_hash=proto.get1(m, 13, b""),
        proposer_address=proto.get1(m, 14, b""),
    )


# --- commit -------------------------------------------------------------


def encode_commit_sig(cs: CommitSig) -> bytes:
    return (
        proto.field_varint(1, cs.block_id_flag)
        + proto.field_bytes(2, cs.validator_address)
        + proto.field_message(3, proto.timestamp(cs.timestamp_ns))
        + proto.field_bytes(4, cs.signature)
    )


def decode_commit_sig(b: bytes) -> CommitSig:
    m = proto.parse(b)
    return CommitSig(
        block_id_flag=proto.get1(m, 1, 0),
        validator_address=proto.get1(m, 2, b""),
        timestamp_ns=proto.parse_timestamp(proto.get1(m, 3, b"")),
        signature=proto.get1(m, 4, b""),
    )


def encode_commit(c: Commit) -> bytes:
    nat = wirecodec.module()
    if nat is not None:
        try:
            return nat.encode_commit(c.height, c.round, c.block_id.encode(), c.signatures)
        except Exception:  # pragma: no cover - odd sig shapes
            pass
    out = proto.field_varint(1, c.height) + proto.field_varint(2, c.round)
    out += proto.field_message(3, c.block_id.encode())
    for cs in c.signatures:  # bftlint: disable=ASY117 — serializing an O(V) commit payload is O(V) by construction: work is proportional to bytes written, once per commit shipped
        out += proto.field_message(4, encode_commit_sig(cs))
    return out


def _decode_timestamp_ns(sub: bytes) -> int:
    secs = nanos = 0
    pos, n = 0, len(sub)
    rv = proto.read_varint
    while pos < n:
        key, pos = rv(sub, pos)
        f, w = key >> 3, key & 7
        if w != 0:
            return proto.parse_timestamp(sub)  # unusual shape: generic
        v, pos = rv(sub, pos)
        if f == 1:
            secs = v
        elif f == 2:
            nanos = v
    return secs * 1_000_000_000 + nanos


def _decode_commit_sig_fast(sub: bytes) -> CommitSig:
    """Inline scan of the 4 CommitSig fields — the replay pipeline
    decodes 150 of these per height (x2: block + seen commit); the
    generic parse()'s dict-of-lists costs ~2x this scanner."""
    flag = 0
    addr = b""
    ts = 0
    sig = b""
    pos, n = 0, len(sub)
    rv = proto.read_varint
    while pos < n:
        key, pos = rv(sub, pos)
        f, w = key >> 3, key & 7
        if w == 0:
            v, pos = rv(sub, pos)
            if f == 1:
                flag = v
            elif f in (2, 3, 4):
                raise ValueError(f"commit sig field {f}: expected bytes")
        elif w == 2:
            ln, pos = rv(sub, pos)
            if ln < 0 or pos + ln > n:
                raise ValueError("truncated bytes field")
            v = sub[pos : pos + ln]
            pos += ln
            if f == 1:
                raise ValueError("commit sig field 1: expected varint")
            if f == 2:
                addr = v
            elif f == 3:
                ts = _decode_timestamp_ns(v)
            elif f == 4:
                sig = v
        elif w == 1:
            if pos + 8 > n:
                raise ValueError("truncated fixed64 field")
            pos += 8
        elif w == 5:
            if pos + 4 > n:
                raise ValueError("truncated fixed32 field")
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {w}")
    return CommitSig(
        block_id_flag=flag,
        validator_address=addr,
        timestamp_ns=ts,
        signature=sig,
    )


def decode_commit(b: bytes) -> Commit:
    if not isinstance(b, (bytes, bytearray, memoryview)):
        raise ValueError(f"expected message bytes, got {type(b).__name__}")
    nat = wirecodec.module()
    if nat is not None:
        try:
            height, round_, bid_b, sig_ts = nat.decode_commit(bytes(b))
        except ValueError:
            # the native reader is at most stricter than the Python one:
            # input it refuses re-parses below, so behavior is the same
            # with or without the extension
            pass
        else:
            c = Commit(
                height=height,
                round=round_,
                block_id=decode_block_id(bid_b if bid_b is not None else b""),
                signatures=[
                    CommitSig(block_id_flag=f, validator_address=a, timestamp_ns=t, signature=s)
                    for f, a, t, s in sig_ts
                ],
            )
            c._raw_bytes = bytes(b)
            return c
    height = round_ = 0
    bid = None
    sigs = []
    pos, n = 0, len(b)
    rv = proto.read_varint
    while pos < n:
        key, pos = rv(b, pos)
        f, w = key >> 3, key & 7
        if w == 0:
            v, pos = rv(b, pos)
            if f == 1:
                height = v
            elif f == 2:
                round_ = v
            elif f in (3, 4):
                raise ValueError(f"commit field {f}: expected bytes")
        elif w == 2:
            ln, pos = rv(b, pos)
            if ln < 0 or pos + ln > n:
                raise ValueError("truncated bytes field")
            sub = b[pos : pos + ln]
            pos += ln
            if f in (1, 2):
                raise ValueError(f"commit field {f}: expected varint")
            if f == 3:
                bid = decode_block_id(sub)
            elif f == 4:
                sigs.append(_decode_commit_sig_fast(sub))
        elif w == 1:
            if pos + 8 > n:
                raise ValueError("truncated fixed64 field")
            pos += 8
        elif w == 5:
            if pos + 4 > n:
                raise ValueError("truncated fixed32 field")
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {w}")
    c = Commit(
        height=height,
        round=round_,
        block_id=bid if bid is not None else decode_block_id(b""),
        signatures=sigs,
    )
    c._raw_bytes = bytes(b)  # immutable-decode convention (see decode_block)
    return c


def encode_extended_commit(ec) -> bytes:
    """ExtendedCommit wire form (reference proto ExtendedCommitInfo
    storage shape): commit fields + per-sig extension data."""
    out = proto.field_varint(1, ec.height) + proto.field_varint(2, ec.round)
    out += proto.field_message(3, ec.block_id.encode())
    for s in ec.extended_signatures:  # bftlint: disable=ASY117 — serializing an O(V) extended-commit payload is O(V) by construction, once per finalized height
        body = (
            encode_commit_sig(s)
            + proto.field_bytes(5, s.extension)
            + proto.field_bytes(6, s.extension_signature)
        )
        out += proto.field_message(4, body)
    return out


def decode_extended_commit(b: bytes):
    m = proto.parse(b)
    sigs = []
    for x in m.get(4, []):
        sm = proto.parse(x)
        sigs.append(
            ExtendedCommitSig(
                block_id_flag=proto.get1(sm, 1, 0),
                validator_address=proto.get1(sm, 2, b""),
                timestamp_ns=proto.parse_timestamp(proto.get1(sm, 3, b"")),
                signature=proto.get1(sm, 4, b""),
                extension=proto.get1(sm, 5, b""),
                extension_signature=proto.get1(sm, 6, b""),
            )
        )
    return ExtendedCommit(
        height=proto.get1(m, 1, 0),
        round=proto.get1(m, 2, 0),
        block_id=decode_block_id(proto.get1(m, 3, b"")),
        extended_signatures=sigs,
    )


# --- block --------------------------------------------------------------


def encode_block(blk: Block) -> bytes:
    out = proto.field_message(1, encode_header(blk.header))
    data = b"".join(proto.field_bytes(1, tx) for tx in blk.data.txs)
    out += proto.field_message(2, data)
    if blk.last_commit is not None:
        out += proto.field_message(3, encode_commit(blk.last_commit))
    for ev in blk.evidence:
        out += proto.field_message(4, ev.encode())
    return out


def decode_block(b: bytes) -> Block:
    # evidence/types.py encodes with this module: imported here, not at
    # the top, to break the cycle
    from ..evidence.types import decode_evidence

    m = proto.parse(b)
    datab = proto.get1(m, 2, b"")
    txs = proto.parse(datab).get(1, []) if datab else []
    lc = proto.get1(m, 3)
    blk = Block(
        header=decode_header(proto.get1(m, 1, b"")),
        data=Data(txs=txs),
        last_commit=decode_commit(lc) if lc is not None else None,
        evidence=[decode_evidence(e) for e in m.get(4, [])],
    )
    # Memoized wire form (replay hot path): the block store and the
    # blocksync apply loop re-serialize every synced block (PartSet
    # build, SC:/C: records) — carrying the already-canonical bytes
    # saves two full commit encodes + one block encode per height.
    # CONVENTION: decoded objects are immutable; any caller that
    # mutates one must `del obj._raw_bytes` first.
    blk._raw_bytes = b
    if blk.last_commit is not None:
        blk.last_commit._raw_bytes = lc
    return blk


# --- vote ---------------------------------------------------------------


def encode_vote(v: Vote) -> bytes:
    return b"".join(
        [
            proto.field_varint(1, v.type_),
            proto.field_varint(2, v.height),
            proto.field_varint(3, v.round),
            proto.field_message(4, v.block_id.encode()),
            proto.field_message(5, proto.timestamp(v.timestamp_ns)),
            proto.field_bytes(6, v.validator_address),
            proto.field_varint(7, v.validator_index + 1),  # +1: 0 realizable
            proto.field_bytes(8, v.signature),
            proto.field_bytes(9, v.extension),
            proto.field_bytes(10, v.extension_signature),
        ]
    )


def decode_vote(b: bytes) -> Vote:
    m = proto.parse(b)
    return Vote(
        type_=proto.get1(m, 1, 0),
        height=proto.get1(m, 2, 0),
        round=proto.get1(m, 3, 0),
        block_id=decode_block_id(proto.get1(m, 4, b"")),
        timestamp_ns=proto.parse_timestamp(proto.get1(m, 5, b"")),
        validator_address=proto.get1(m, 6, b""),
        validator_index=proto.get1(m, 7, 0) - 1,
        signature=proto.get1(m, 8, b""),
        extension=proto.get1(m, 9, b""),
        extension_signature=proto.get1(m, 10, b""),
    )


def encode_proposal(p: Proposal) -> bytes:
    return b"".join(
        [
            proto.field_varint(1, p.height),
            proto.field_varint(2, p.round),
            proto.field_varint(3, p.pol_round + 2),  # offset: -1 realizable
            proto.field_message(4, p.block_id.encode()),
            proto.field_message(5, proto.timestamp(p.timestamp_ns)),
            proto.field_bytes(6, p.signature),
        ]
    )


def decode_proposal(b: bytes) -> Proposal:
    m = proto.parse(b)
    return Proposal(
        height=proto.get1(m, 1, 0),
        round=proto.get1(m, 2, 0),
        pol_round=proto.get1(m, 3, 2) - 2,
        block_id=decode_block_id(proto.get1(m, 4, b"")),
        timestamp_ns=proto.parse_timestamp(proto.get1(m, 5, b"")),
        signature=proto.get1(m, 6, b""),
    )


# --- validators ---------------------------------------------------------


def encode_validator(v: Validator) -> bytes:
    return (
        proto.field_bytes(1, v.address)
        + proto.field_message(2, encode_pubkey(v.pub_key))
        + proto.field_varint(3, v.voting_power)
        + proto.field_sfixed64(4, v.proposer_priority)
    )


def decode_validator(b: bytes) -> Validator:
    m = proto.parse(b)
    return Validator(
        pub_key=decode_pubkey(proto.get1(m, 2, b"")),
        voting_power=proto.get1(m, 3, 0),
        address=proto.get1(m, 1, b""),
        proposer_priority=proto.get1(m, 4, 0),
    )


def encode_validator_set(vs: ValidatorSet) -> bytes:
    out = b"".join(
        proto.field_message(1, encode_validator(v)) for v in vs.validators
    )
    if vs.proposer is not None:
        out += proto.field_bytes(2, vs.proposer.address)
    return out


def decode_validator_set(b: bytes) -> ValidatorSet:
    m = proto.parse(b)
    vals = [decode_validator(x) for x in m.get(1, [])]
    vs = ValidatorSet.__new__(ValidatorSet)
    vs.validators = vals
    vs._by_address = {v.address: i for i, v in enumerate(vals)}
    vs._hash = None
    vs._total_power = None
    prop_addr = proto.get1(m, 2, b"")
    vs.proposer = None
    if prop_addr and prop_addr in vs._by_address:
        vs.proposer = vals[vs._by_address[prop_addr]]
    return vs
