"""File-backed private validator with double-sign protection.

Parity with reference privval/file.go: key file (persistent identity)
plus a state file persisted BEFORE every signature recording
(height/round/step + signature + sign bytes), the CheckHRS regression
rule (privval/file.go:100), and same-HRS re-signing only for identical
or timestamp-only-differing sign bytes (privval/file.go:307-410).

A copy of the JAX package's ``privval/file_pv.py``; key and state files
are the same JSON, so either package loads the other's. The remote
signer waits for the network slice.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass
from typing import Tuple

from ..crypto.keys import Ed25519PrivKey, Ed25519PubKey
from ..types.vote import PRECOMMIT, PREVOTE, Proposal, Vote
from ..utils import proto

STEP_PROPOSE = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3

_VOTE_STEP = {PREVOTE: STEP_PREVOTE, PRECOMMIT: STEP_PRECOMMIT}


class DoubleSignError(Exception):
    pass


def _atomic_write(path: str, data: bytes) -> None:
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        os.write(fd, data)
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)


@dataclass
class _LastSign:
    height: int = 0
    round: int = 0
    step: int = 0
    signature: str = ""
    sign_bytes: str = ""


class FilePV:
    def __init__(self, priv_key: Ed25519PrivKey, key_path: str, state_path: str):
        self.priv_key = priv_key
        self.key_path = key_path
        self.state_path = state_path
        self.last = _LastSign()

    # --- construction -------------------------------------------------

    @classmethod
    def generate(cls, key_path: str, state_path: str) -> "FilePV":
        pv = cls(Ed25519PrivKey.from_seed(os.urandom(32)), key_path, state_path)
        pv.save_key()
        pv.save_state()
        return pv

    @classmethod
    def load(cls, key_path: str, state_path: str) -> "FilePV":
        with open(key_path) as f:
            kd = json.load(f)
        pv = cls(
            Ed25519PrivKey.from_seed(bytes.fromhex(kd["priv_key"])),
            key_path,
            state_path,
        )
        if os.path.exists(state_path):
            with open(state_path) as f:
                sd = json.load(f)
            pv.last = _LastSign(**sd)
        return pv

    @classmethod
    def load_or_generate(cls, key_path: str, state_path: str) -> "FilePV":
        if os.path.exists(key_path):
            return cls.load(key_path, state_path)
        return cls.generate(key_path, state_path)

    def save_key(self) -> None:
        pub = self.priv_key.pub_key()
        _atomic_write(
            self.key_path,
            json.dumps(
                {
                    "address": pub.address().hex(),
                    "pub_key": pub.key_bytes.hex(),
                    "priv_key": self.priv_key.seed.hex(),
                }
            ).encode(),
        )

    def save_state(self) -> None:
        _atomic_write(
            self.state_path, json.dumps(self.last.__dict__).encode()
        )

    # --- PrivValidator interface --------------------------------------

    def pub_key(self) -> Ed25519PubKey:
        return self.priv_key.pub_key()

    def _check_hrs(
        self, height: int, round_: int, step: int
    ) -> bool:
        """Returns True if HRS was seen before (same-HRS re-sign path);
        raises on regression (reference privval/file.go:100-131)."""
        last = self.last
        if last.height > height:
            raise DoubleSignError("height regression")
        if last.height == height:
            if last.round > round_:
                raise DoubleSignError("round regression")
            if last.round == round_:
                if last.step > step:
                    raise DoubleSignError("step regression")
                if last.step == step:
                    if not last.sign_bytes:
                        raise DoubleSignError("no sign bytes for same HRS")
                    return True
        return False

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        step = _VOTE_STEP[vote.type_]
        sign_bytes = vote.sign_bytes(chain_id)
        same = self._check_hrs(vote.height, vote.round, step)
        if same:
            prev = bytes.fromhex(self.last.sign_bytes)
            if prev == sign_bytes:
                vote.signature = bytes.fromhex(self.last.signature)
                return
            if _votes_differ_only_by_timestamp(prev, sign_bytes):
                # re-sign with the ORIGINAL timestamp (reference behavior)
                vote.timestamp_ns = _vote_timestamp(prev)
                vote.signature = bytes.fromhex(self.last.signature)
                return
            raise DoubleSignError(
                f"conflicting vote at {vote.height}/{vote.round}/{step}"
            )
        sig = self.priv_key.sign(sign_bytes)
        self.last = _LastSign(
            height=vote.height,
            round=vote.round,
            step=step,
            signature=sig.hex(),
            sign_bytes=sign_bytes.hex(),
        )
        self.save_state()  # persist BEFORE returning the signature
        vote.signature = sig

    def sign_vote_extension(self, chain_id: str, vote: Vote) -> None:
        if vote.type_ == PRECOMMIT and not vote.block_id.is_nil():
            ext_sb = vote.extension_sign_bytes(chain_id)
            vote.extension_signature = self.priv_key.sign(ext_sb)

    def sign_proposal(self, chain_id: str, prop: Proposal) -> None:
        sign_bytes = prop.sign_bytes(chain_id)
        same = self._check_hrs(prop.height, prop.round, STEP_PROPOSE)
        if same:
            prev = bytes.fromhex(self.last.sign_bytes)
            if prev == sign_bytes:
                prop.signature = bytes.fromhex(self.last.signature)
                return
            if _proposals_differ_only_by_timestamp(prev, sign_bytes):
                prop.timestamp_ns = _proposal_timestamp(prev)
                prop.signature = bytes.fromhex(self.last.signature)
                return
            raise DoubleSignError(
                f"conflicting proposal at {prop.height}/{prop.round}"
            )
        sig = self.priv_key.sign(sign_bytes)
        self.last = _LastSign(
            height=prop.height,
            round=prop.round,
            step=STEP_PROPOSE,
            signature=sig.hex(),
            sign_bytes=sign_bytes.hex(),
        )
        self.save_state()
        prop.signature = sig


# --- timestamp-only comparison helpers ---------------------------------


def _strip_ts(delimited: bytes, ts_field: int) -> Tuple[bytes, int]:
    """Remove the timestamp field from canonical sign bytes; return
    (stripped, timestamp_ns)."""
    payload, _ = proto.read_delimited(delimited)
    m = proto.parse(payload)
    ts = proto.parse_timestamp(proto.get1(m, ts_field, b""))
    # re-encode without the ts field, preserving field order
    out = b""
    for f in sorted(m):
        if f == ts_field:
            continue
        for v in m[f]:
            if isinstance(v, bytes):
                out += proto.field_bytes(f, v)
            else:
                out += proto.field_sfixed64(f, v) if f in (2, 3, 4) else (
                    proto.field_varint(f, v)
                )
    return out, ts


def _votes_differ_only_by_timestamp(a: bytes, b: bytes) -> bool:
    sa, _ = _strip_ts(a, 5)
    sb, _ = _strip_ts(b, 5)
    return sa == sb


def _vote_timestamp(sign_bytes: bytes) -> int:
    _, ts = _strip_ts(sign_bytes, 5)
    return ts


def _proposals_differ_only_by_timestamp(a: bytes, b: bytes) -> bool:
    sa, _ = _strip_ts(a, 6)
    sb, _ = _strip_ts(b, 6)
    return sa == sb


def _proposal_timestamp(sign_bytes: bytes) -> int:
    _, ts = _strip_ts(sign_bytes, 6)
    return ts
