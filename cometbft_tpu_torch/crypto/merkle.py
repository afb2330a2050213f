"""RFC 6962 merkle trees and inclusion proofs (reference crypto/merkle).

A copy of the JAX package's ``crypto/merkle.py``: a root of four or
more leaves comes from the native wire codec (``utils/wirecodec.py``)
when it is built, byte-identical to the Python fold. Leaf hash =
SHA-256(0x00 || leaf), inner = SHA-256(0x01 || left || right), split
point = the largest power of two below n, the empty tree hashes to
SHA-256(""). Proofs back ``PartSet`` and the block store's parts; the
proof operators and ``ProofRuntime`` back the provable kvstore's
``Query(prove=True)`` and the light proxy's verified ``abci_query``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"


def _sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def leaf_hash(leaf: bytes) -> bytes:
    return _sha256(LEAF_PREFIX + leaf)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _sha256(INNER_PREFIX + left + right)


def _split_point(n: int) -> int:
    """Largest power of two strictly less than n."""
    k = 1
    while k * 2 < n:
        k *= 2
    return k


def hash_from_byte_slices(items: Sequence[bytes]) -> bytes:
    """Root hash. The RFC 6962 left-heavy split is the binary
    decomposition of n, so pushing leaf hashes, merging equal-sized
    subtrees and folding the rest right to left gives the same tree
    without the recursion's list slicing; four leaves or more take the
    native tree when it is built."""
    n = len(items)
    if n == 0:
        return _sha256(b"")
    if n >= 4:
        from ..utils import wirecodec

        nat = wirecodec.module()
        if nat is not None:
            try:
                return nat.merkle_root(items)
            except Exception:  # pragma: no cover - non-bytes leaves
                pass
    sha = hashlib.sha256
    stack: List = []  # (subtree hash, subtree size)
    for it in items:
        h = sha(LEAF_PREFIX + it).digest()
        s = 1
        while stack and stack[-1][1] == s:
            ph, _ = stack.pop()
            h = sha(INNER_PREFIX + ph + h).digest()
            s *= 2
        stack.append((h, s))
    h, _ = stack.pop()
    while stack:
        ph, _ = stack.pop()
        h = sha(INNER_PREFIX + ph + h).digest()
    return h


@dataclass
class Proof:
    total: int
    index: int
    leaf_hash: bytes
    aunts: List[bytes] = field(default_factory=list)

    def verify(self, root: bytes, leaf: bytes) -> bool:
        if self.total < 0 or self.index < 0 or self.index >= self.total:
            return False
        if leaf_hash(leaf) != self.leaf_hash:
            return False
        return _compute_root(self.total, self.index, self.leaf_hash, self.aunts) == root


def _compute_root(total: int, index: int, lh: bytes, aunts: List[bytes]) -> Optional[bytes]:
    if total == 0:
        return None
    if total == 1:
        return None if aunts else lh
    if not aunts:
        return None
    k = _split_point(total)
    if index < k:
        left = _compute_root(k, index, lh, aunts[:-1])
        return None if left is None else inner_hash(left, aunts[-1])
    right = _compute_root(total - k, index - k, lh, aunts[:-1])
    return None if right is None else inner_hash(aunts[-1], right)


def proofs_from_byte_slices(items: Sequence[bytes]):
    """Returns (root, [Proof per item])."""
    return proofs_from_leaf_hashes([leaf_hash(it) for it in items])


def proofs_from_leaf_hashes(leaf_hashes: Sequence[bytes]):
    """Returns (root, [Proof per leaf]) from precomputed leaf hashes
    (SHA-256(0x00 || item) each); the same output as
    ``proofs_from_byte_slices`` on the same items."""
    leaf_hashes = list(leaf_hashes)
    trails, root_node = _trails_from_leaf_hashes(leaf_hashes)
    root = root_node.hash if root_node else _sha256(b"")
    proofs = [
        Proof(total=len(leaf_hashes), index=i, leaf_hash=t.hash, aunts=t.flatten_aunts())
        for i, t in enumerate(trails)
    ]
    return root, proofs


class _Node:
    __slots__ = ("hash", "parent", "left", "right")

    def __init__(self, h: bytes):
        self.hash = h
        self.parent = None
        self.left = None  # sibling pointers while building the trail
        self.right = None

    def flatten_aunts(self) -> List[bytes]:
        out = []
        node = self
        while node is not None:
            if node.left is not None:
                out.append(node.left.hash)
            elif node.right is not None:
                out.append(node.right.hash)
            node = node.parent
        return out


def _trails_from_leaf_hashes(leaf_hashes: List[bytes]):
    n = len(leaf_hashes)
    if n == 0:
        return [], None
    if n == 1:
        node = _Node(leaf_hashes[0])
        return [node], node
    k = _split_point(n)
    lefts, left_root = _trails_from_leaf_hashes(leaf_hashes[:k])
    rights, right_root = _trails_from_leaf_hashes(leaf_hashes[k:])
    root = _Node(inner_hash(left_root.hash, right_root.hash))
    left_root.parent = root
    left_root.right = right_root
    right_root.parent = root
    right_root.left = left_root
    return lefts + rights, root


# --- proof operators ----------------------------------------------------
#
# Chainable proof steps for light-client verification of ABCI query
# responses (the role of the reference's crypto/merkle ProofRuntime +
# ProofOperators, light/rpc/client.go:126-187): each op maps the value
# produced by the previous op to the next root, and the final output
# must equal the light-verified AppHash. Three op types cover the
# provable kvstore (models/kvstore.py prove mode):
#
#   kv:v  — value inclusion: a Proof for the sorted-KV leaf
#           len-prefix(key) || len-prefix(value); recomputing the leaf
#           from the QUERIED key and RETURNED value binds both.
#   kv:a  — absence: the would-be neighbors in sorted-key order (their
#           own inclusion proofs + adjacency/ordering checks) show no
#           leaf for the key can exist.
#   kv:h  — app-hash binding: app_hash = SHA-256(height_8B || kv_root).
#
# The design is an original sorted-array range proof (simpler than
# iavl's tree-path absence proofs but with the same guarantees for a
# flat store); op payloads use the repo's deterministic proto writer.


class ProofError(Exception):
    """A proof op failed to verify / decode."""


OP_KV_VALUE = "kv:v"
OP_KV_ABSENCE = "kv:a"
OP_APP_HASH = "kv:h"


@dataclass
class ProofOp:
    type: str
    key: bytes
    data: bytes

    def encode(self) -> bytes:
        from ..utils import proto

        return (
            proto.field_string(1, self.type)
            + proto.field_bytes(2, self.key)
            + proto.field_bytes(3, self.data)
        )

    @classmethod
    def decode(cls, b: bytes) -> "ProofOp":
        from ..utils import proto

        m = proto.parse(b)
        return cls(
            type=proto.get1(m, 1, b"").decode(),
            key=proto.get1(m, 2, b""),
            data=proto.get1(m, 3, b""),
        )


def encode_proof_ops(ops: List[ProofOp]) -> bytes:
    from ..utils import proto

    return b"".join(proto.field_message(1, op.encode()) for op in ops)


def decode_proof_ops(b: bytes) -> List[ProofOp]:
    from ..utils import proto

    m = proto.parse(b)
    return [ProofOp.decode(x) for x in m.get(1, [])]


def encode_proof(p: Proof) -> bytes:
    from ..utils import proto

    return (
        proto.field_varint(1, p.total)
        + proto.field_varint(2, p.index)
        + proto.field_bytes(3, p.leaf_hash)
        + b"".join(proto.field_bytes(4, a) for a in p.aunts)
    )


def decode_proof(b: bytes) -> Proof:
    from ..utils import proto

    m = proto.parse(b)
    return Proof(
        total=proto.get1(m, 1, 0),
        index=proto.get1(m, 2, 0),
        leaf_hash=proto.get1(m, 3, b""),
        aunts=list(m.get(4, [])),
    )


def kv_leaf(key: bytes, value: bytes) -> bytes:
    """Canonical sorted-KV leaf encoding (length-prefixed k then v)."""
    from ..utils import proto

    return proto.field_bytes(1, key) + proto.field_bytes(2, value)


def _leaf_root(proof: Proof, leaf: bytes):
    # Bounds must be enforced here, not just in Proof.verify: the
    # absence-op adjacency/ordering checks (index+1, index==0/total-1)
    # assume index integrity that _compute_root alone does not give —
    # the extreme leaves' proofs also verify under inflated/negative
    # indices.
    if proof.total <= 0:
        raise ProofError("inclusion proof with non-positive tree size")
    if not (0 <= proof.index < proof.total):
        raise ProofError("inclusion proof index out of bounds")
    lh = leaf_hash(leaf)
    root = _compute_root(proof.total, proof.index, lh, proof.aunts)
    if root is None:
        raise ProofError("malformed inclusion proof")
    return root


def _run_value_op(op: ProofOp, key: bytes, value: bytes) -> bytes:
    if op.key != key:
        raise ProofError("value op bound to a different key")
    proof = decode_proof(op.data)
    return _leaf_root(proof, kv_leaf(key, value))


def _run_absence_op(op: ProofOp, key: bytes) -> bytes:
    from ..utils import proto

    if op.key != key:
        raise ProofError("absence op bound to a different key")
    m = proto.parse(op.data)
    neighbors = []
    for nb in m.get(1, []):
        nm = proto.parse(nb)
        neighbors.append(
            (
                decode_proof(proto.get1(nm, 1, b"")),
                proto.get1(nm, 2, b""),   # neighbor key
                proto.get1(nm, 3, b""),   # neighbor value
            )
        )
    if not neighbors:
        # empty store: its root is the empty-tree hash
        return _sha256(b"")
    roots = [
        _leaf_root(p, kv_leaf(nk, nv)) for p, nk, nv in neighbors
    ]
    if any(r != roots[0] for r in roots[1:]):
        raise ProofError("absence neighbors prove different roots")
    total = neighbors[0][0].total
    if any(p.total != total for p, _, _ in neighbors):
        raise ProofError("absence neighbors disagree on tree size")
    if len(neighbors) == 2:
        (p1, k1, _), (p2, k2, _) = neighbors
        if p2.index != p1.index + 1:
            raise ProofError("absence neighbors are not adjacent")
        if not (k1 < key < k2):
            raise ProofError("key does not fall between the neighbors")
    elif len(neighbors) == 1:
        p1, k1, _ = neighbors[0]
        if p1.index == 0 and key < k1:
            pass  # before the first key
        elif p1.index == total - 1 and key > k1:
            pass  # after the last key
        else:
            raise ProofError(
                "single absence neighbor neither first-above nor "
                "last-below the key"
            )
    else:
        raise ProofError("absence proof needs 1 or 2 neighbors")
    return roots[0]


def _run_app_hash_op(op: ProofOp, root: bytes) -> bytes:
    from ..utils import proto

    m = proto.parse(op.data)
    height = proto.get1(m, 1, 0)
    if height < 0:
        raise ProofError("negative height in app-hash op")
    return _sha256(height.to_bytes(8, "big") + root)


class ProofRuntime:
    """Verify a proof-op chain against a light-verified AppHash
    (reference merkle.ProofRuntime as used by light/rpc/client.go)."""

    def verify_value(
        self, ops: List[ProofOp], app_hash: bytes, key: bytes,
        value: bytes,
    ) -> None:
        """value may be EMPTY — a committed empty value is a real
        entry (kv_leaf is injective either way); presence vs absence
        is the caller's routing decision (response code), never
        inferred from value truthiness."""
        self._verify(ops, app_hash, key, value)

    def verify_absence(
        self, ops: List[ProofOp], app_hash: bytes, key: bytes
    ) -> None:
        self._verify(ops, app_hash, key, None)

    def _verify(self, ops, app_hash, key, value) -> None:
        if len(ops) != 2:
            raise ProofError(f"expected 2 proof ops, got {len(ops)}")
        first, second = ops
        if value is not None:
            if first.type != OP_KV_VALUE:
                raise ProofError(f"unexpected first op {first.type!r}")
            root = _run_value_op(first, key, value)
        else:
            if first.type != OP_KV_ABSENCE:
                raise ProofError(f"unexpected first op {first.type!r}")
            root = _run_absence_op(first, key)
        if second.type != OP_APP_HASH:
            raise ProofError(f"unexpected final op {second.type!r}")
        computed = _run_app_hash_op(second, root)
        if computed != app_hash:
            raise ProofError(
                "proof chain does not land on the verified app hash"
            )
