"""The chain's encodings and hashes in plain Python, the reference's
own: it imports nothing of the program.

What the program derives from a block's inputs, worked out again:
protobuf fields (proto3: a zero scalar or an empty string is left out,
an embedded message is written whenever present), RFC 6962 merkle
roots, the header hash (a merkle root over its fourteen encoded
fields), the canonical vote sign bytes a precommit signature covers,
the validator set hash, a commit's hash, a block's data hash, the
results hash of a block's deliver-tx results, and the kvstore
application's state hash. Every encoding is the repository's chain
format as the JAX package defines it.
"""

from __future__ import annotations

import hashlib
import struct

PRECOMMIT = 2
BLOCK_ID_FLAG_COMMIT = 2


def sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def address(pk: bytes) -> bytes:
    """A validator's address: the first 20 bytes of SHA-256(pubkey)."""
    return sha256(pk)[:20]


# --- protobuf -------------------------------------------------------------


def varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def f_varint(field: int, v: int) -> bytes:
    return varint(field << 3) + varint(v) if v else b""


def f_sfixed64(field: int, v: int) -> bytes:
    return varint(field << 3 | 1) + struct.pack("<q", v) if v else b""


def f_bytes(field: int, v: bytes) -> bytes:
    return varint(field << 3 | 2) + varint(len(v)) + v if v else b""


def f_message(field: int, v) -> bytes:
    return b"" if v is None else varint(field << 3 | 2) + varint(len(v)) + v


def timestamp(ns: int) -> bytes:
    secs, nanos = divmod(ns, 1_000_000_000)
    return f_varint(1, secs) + f_varint(2, nanos)


# --- merkle ---------------------------------------------------------------


def merkle_root(items) -> bytes:
    """RFC 6962: leaf SHA-256(0x00 || leaf), inner SHA-256(0x01 || l || r),
    split at the largest power of two below n, SHA-256("") when empty."""
    n = len(items)
    if n == 0:
        return sha256(b"")
    if n == 1:
        return sha256(b"\x00" + items[0])
    k = 1
    while k * 2 < n:
        k *= 2
    return sha256(b"\x01" + merkle_root(items[:k]) + merkle_root(items[k:]))


# --- block parts ----------------------------------------------------------


def block_id(hash_: bytes, total: int, parts_hash: bytes) -> bytes:
    """BlockID{hash, PartSetHeader{total, hash}}."""
    return f_bytes(1, hash_) + f_message(2, f_varint(1, total) + f_bytes(2, parts_hash))


def header_hash(h: dict) -> bytes:
    """Merkle root of the header's fields, in the header's order. ``h``
    holds them by name; ``last_block_id`` is (hash, total, parts hash)."""
    version = f_varint(1, h["version_block"]) + f_varint(2, h["version_app"])
    return merkle_root([
        version,
        h["chain_id"].encode(),
        varint(h["height"]),
        timestamp(h["time_ns"]),
        block_id(*h["last_block_id"]),
        h["last_commit_hash"],
        h["data_hash"],
        h["validators_hash"],
        h["next_validators_hash"],
        h["consensus_hash"],
        h["app_hash"],
        h["last_results_hash"],
        h["evidence_hash"],
        h["proposer_address"],
    ])


def precommit_sign_bytes(chain_id: str, height: int, round_: int, bid, timestamp_ns: int) -> bytes:
    """The length-delimited CanonicalVote a precommit for block ``bid``
    = (hash, total, parts hash) signs: type, height and round (sfixed64),
    the canonical block ID, the timestamp, the chain id."""
    hash_, total, parts_hash = bid
    cbid = f_bytes(1, hash_) + f_message(2, f_varint(1, total) + f_bytes(2, parts_hash))
    body = (f_varint(1, PRECOMMIT) + f_sfixed64(2, height) + f_sfixed64(3, round_)
            + f_message(4, cbid) + f_message(5, timestamp(timestamp_ns)) + f_bytes(6, chain_id.encode()))
    return varint(len(body)) + body


def validator_set_hash(validators) -> bytes:
    """Merkle root over (pubkey, power), ordered by power descending and
    then by address. ``validators``: (pubkey bytes, power) pairs."""
    ordered = sorted(validators, key=lambda v: (-v[1], address(v[0])))
    return merkle_root([f_message(1, f_bytes(1, pk)) + f_varint(2, power) for pk, power in ordered])


def commit_sig_bytes(flag: int, addr: bytes, timestamp_ns: int, sig: bytes) -> bytes:
    return f_varint(1, flag) + f_bytes(2, addr) + f_message(3, timestamp(timestamp_ns)) + f_bytes(4, sig)


def commit_hash(sigs) -> bytes:
    """A commit's hash: the merkle root of its signatures' encodings;
    ``sigs`` are (flag, address, timestamp ns, signature)."""
    return merkle_root([commit_sig_bytes(*s) for s in sigs])


def data_hash(txs) -> bytes:
    return merkle_root([sha256(tx) for tx in txs])


def results_hash(results) -> bytes:
    """Merkle root of the results' deterministic fields; ``results`` are
    (code, data, gas_wanted, gas_used, codespace)."""
    return merkle_root([f_varint(1, c) + f_bytes(2, d) + f_varint(5, gw) + f_varint(6, gu)
                        + f_bytes(8, cs.encode()) for c, d, gw, gu, cs in results])


# --- the kvstore application ---------------------------------------------


class KVStore:
    """The kvstore application's semantics: a ``key=value`` tx sets the
    key; the state hash after height h is SHA-256 of h (8 bytes, big
    endian) and every (key, value) pair in key order, each length-prefixed
    (4 bytes, big endian). Every ``key=value`` tx succeeds with code 0
    and nothing else in its result."""

    def __init__(self) -> None:
        self.state: dict = {}

    def finalize(self, height: int, txs) -> tuple:
        """(app hash, results hash) after applying ``txs`` at ``height``."""
        results = []
        for tx in txs:
            if b"=" not in tx:
                raise ValueError(f"not a key=value tx: {tx[:32]!r}")
            k, v = tx.split(b"=", 1)
            self.state[k] = v
            results.append((0, b"", 0, 0, ""))
        h = hashlib.sha256(height.to_bytes(8, "big"))
        for k in sorted(self.state):
            v = self.state[k]
            h.update(len(k).to_bytes(4, "big") + k + len(v).to_bytes(4, "big") + v)
        return h.digest(), results_hash(results)
