"""Trusted light block stores (reference light/store/db).

A copy of the JAX package's ``light/store.py``. ``LightStore`` is the
in-memory form; ``DBLightStore`` persists the trust roots to a KV
backend, so a light client reopened over the same database resumes
from its last verified header. The record layout is the JAX package's
byte for byte (key ``L:<hex chain_id>:<height BE64>``; value the
header, commit and validator set as fields 1-3), so either package
reads a store the other wrote.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..utils import codec, kv, proto
from .types import LightBlock


class LightStore:
    def __init__(self):
        self._by_height: Dict[int, LightBlock] = {}

    def save(self, lb: LightBlock) -> None:
        self._by_height[lb.height] = lb

    def get(self, height: int) -> Optional[LightBlock]:
        return self._by_height.get(height)

    def latest(self) -> Optional[LightBlock]:
        if not self._by_height:
            return None
        return self._by_height[max(self._by_height)]

    def latest_before(self, height: int) -> Optional[LightBlock]:
        hs = [h for h in self._by_height if h < height]
        return self._by_height[max(hs)] if hs else None

    def lowest(self) -> Optional[LightBlock]:
        if not self._by_height:
            return None
        return self._by_height[min(self._by_height)]

    def prune(self, keep: int) -> list:
        """Drop all but the ``keep`` highest roots; returns the removed
        heights (subclasses delete their durable copies of exactly
        these)."""
        if len(self._by_height) <= keep:
            return []
        doomed = sorted(self._by_height)[:-keep]
        for h in doomed:
            del self._by_height[h]
        return doomed

    def __len__(self) -> int:
        return len(self._by_height)


def _encode_light_block(lb: LightBlock) -> bytes:
    return (
        proto.field_message(1, codec.encode_header(lb.header))
        + proto.field_message(2, codec.encode_commit(lb.commit))
        + proto.field_message(3, codec.encode_validator_set(lb.validator_set))
    )


def _decode_light_block(b: bytes) -> LightBlock:
    m = proto.parse(b)
    return LightBlock(
        header=codec.decode_header(proto.get1(m, 1, b"")),
        commit=codec.decode_commit(proto.get1(m, 2, b"")),
        validator_set=codec.decode_validator_set(proto.get1(m, 3, b"")),
    )


class DBLightStore(LightStore):
    """LightStore persisted to a KV backend: the in-memory index serves
    reads, the KV holds the durable copy, loaded once at open. Keys
    hex-encode the chain id, so a chain id containing ':' cannot
    collide. Saves prune to ``pruning_size`` (reference light/store/db
    SaveLightBlock, default 1000)."""

    def __init__(self, db: kv.KV, chain_id: str, pruning_size: int = 1000):
        super().__init__()
        self.db = db
        self.pruning_size = pruning_size
        self._prefix = b"L:" + chain_id.encode().hex().encode() + b":"
        for _, v in self.db.iter_prefix(self._prefix):
            lb = _decode_light_block(v)
            if lb.header.chain_id != chain_id:
                continue  # a foreign record under our prefix
            self._by_height[lb.height] = lb

    def _key(self, height: int) -> bytes:
        return self._prefix + height.to_bytes(8, "big")

    def save(self, lb: LightBlock) -> None:
        super().save(lb)
        self.db.set(self._key(lb.height), _encode_light_block(lb))
        if self.pruning_size and len(self._by_height) > self.pruning_size:
            self.prune(self.pruning_size)

    def prune(self, keep: int) -> list:
        doomed = super().prune(keep)
        for h in doomed:
            self.db.delete(self._key(h))
        return doomed
