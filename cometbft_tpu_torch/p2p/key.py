"""Node identity (reference p2p/key.go).

A copy of the JAX package's ``p2p/key.py``. A node's ID is the hex of
the first 20 bytes of SHA-256 over its ed25519 public key — the same
derivation the reference uses for crypto addresses
(tmhash.SumTruncated), so IDs are verifiable from the pubkey learned
during the secret-connection handshake.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass

from ..crypto.keys import Ed25519PrivKey, PubKey

ID_BYTE_LENGTH = 20


def node_id_from_pubkey(pub: PubKey) -> str:
    return hashlib.sha256(pub.key_bytes).digest()[:ID_BYTE_LENGTH].hex()


@dataclass
class NodeKey:
    priv_key: Ed25519PrivKey

    @property
    def node_id(self) -> str:
        return node_id_from_pubkey(self.priv_key.pub_key())

    @classmethod
    def generate(cls) -> "NodeKey":
        return cls(Ed25519PrivKey.from_seed(os.urandom(32)))

    # --- persistence (node_key.json, reference p2p/key.go:60) ---------

    @classmethod
    def load_or_gen(cls, path: str) -> "NodeKey":
        if os.path.exists(path):
            return cls.load(path)
        nk = cls.generate()
        nk.save(path)
        return nk

    @classmethod
    def load(cls, path: str) -> "NodeKey":
        with open(path) as f:
            d = json.load(f)
        seed = bytes.fromhex(d["priv_key"])[:32]
        return cls(Ed25519PrivKey.from_seed(seed))

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # the 64-byte expanded form (seed || pubkey), the reference's
        # on-disk ed25519 private key layout
        raw = self.priv_key.seed + self.priv_key.pub_key().key_bytes
        with open(path, "w") as f:
            json.dump({"id": self.node_id, "priv_key": raw.hex()}, f, indent=2)
