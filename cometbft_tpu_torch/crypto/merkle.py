"""RFC 6962 merkle trees and inclusion proofs (reference crypto/merkle).

The part of the JAX package's ``crypto/merkle.py`` that block, header,
commit, validator-set and part-set hashing use: leaf hash =
SHA-256(0x00 || leaf), inner = SHA-256(0x01 || left || right), split
point = the largest power of two below n, the empty tree hashes to
SHA-256(""). Proofs back ``PartSet`` and the block store's parts. The
proof operators of the provable kvstore are not ported.
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
    without the recursion's list slicing."""
    if not items:
        return _sha256(b"")
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
    leaf_hashes = [leaf_hash(it) for it in items]
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
