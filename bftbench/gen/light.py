"""Light blocks over rotating validator sets: a frozen copy of
``utils/chaingen.py::RotatingLightProvider`` with
``chip_smoke.py::MemoProvider`` folded in (every height minted once,
thread-safe), the votes signed by ``sign.py``, and at the heights named (the
copy's ``forge_at``) one lane forged: the last one the light check
reads, where the original forges the first."""

from __future__ import annotations

import threading
import time

from .sign import Signer


class RotatingLightProvider:
    """The set signing height h is the ``n_vals`` keys ``keys[e * shift :
    e * shift + n_vals]`` of epoch ``e = h // epoch``, each of power
    ``power``; header h's time is ``t0_ns + h`` s. ``forge_at`` heights
    carry their first signature with a byte flipped. ``mint(heights)``
    signs ahead; ``light_block`` serves a minted height, and mints one it
    lacks (counted in ``minted_late``, with the seconds it took in
    ``late_s``)."""

    def __init__(self, chain_id, seeds, keys, n_vals, epoch, shift, power, t0_ns, forge_at=()):
        self.chain_id = chain_id
        self.keys = list(keys)
        self.n_vals, self.epoch, self.shift, self.power = n_vals, epoch, shift, power
        self.t0_ns = t0_ns
        self.forge_at = set(forge_at)
        self._sets: dict = {}
        self._by_addr = {k.pub_key().address(): s for k, s in zip(self.keys, seeds)}
        self._memo: dict = {}
        self._lock = threading.Lock()
        self._signer = Signer()
        self.minted_late = 0
        self.late_s = 0.0
        # the lane that takes the commit past 2/3 of the power: the light
        # check reads it last
        self.forged_lane = (2 * n_vals) // 3

    def keys_at(self, height: int):
        e = height // self.epoch
        return self.keys[e * self.shift: e * self.shift + self.n_vals]

    def vals_at(self, height: int):
        from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet

        e = height // self.epoch
        with self._lock:
            vs = self._sets.get(e)
        if vs is None:
            vs = ValidatorSet([Validator(k.pub_key(), self.power) for k in self.keys_at(height)])
            with self._lock:
                vs = self._sets.setdefault(e, vs)
        return vs

    def _mint(self, height: int):
        from cometbft_tpu_torch.light.types import LightBlock
        from cometbft_tpu_torch.types.block import (
            BLOCK_ID_FLAG_COMMIT, BlockID, Commit, CommitSig, Header, PartSetHeader)
        from cometbft_tpu_torch.types.vote import PRECOMMIT, Vote

        vals = self.vals_at(height)
        header = Header(
            chain_id=self.chain_id,
            height=height,
            time_ns=self.t0_ns + height * 1_000_000_000,
            validators_hash=vals.hash(),
            next_validators_hash=self.vals_at(height + 1).hash(),
        )
        bid = BlockID(header.hash(), PartSetHeader(1, header.hash()))
        # a precommit's sign bytes hold neither its validator nor its
        # index: every vote of the commit signs the same bytes
        msg = Vote(type_=PRECOMMIT, height=height, round=0, block_id=bid, timestamp_ns=header.time_ns,
                   validator_address=b"", validator_index=0).sign_bytes(self.chain_id)
        rows = [(self._by_addr[v.address], msg) for v in vals.validators]
        sigs = self._signer.sign(rows)
        if height in self.forge_at:
            i = self.forged_lane
            sigs[i] = bytes([sigs[i][0] ^ 1]) + sigs[i][1:]
        commit = Commit(height=height, round=0, block_id=bid, signatures=[
            CommitSig(block_id_flag=BLOCK_ID_FLAG_COMMIT, validator_address=val.address,
                      timestamp_ns=header.time_ns, signature=sig)
            for val, sig in zip(vals.validators, sigs)])
        return LightBlock(header, commit, vals)

    def mint(self, heights) -> None:
        for h in sorted(set(heights)):
            if h not in self._memo:
                self._memo[h] = self._mint(h)

    def minted(self) -> list:
        return sorted(self._memo)

    def light_block(self, height: int):
        with self._lock:
            lb = self._memo.get(height)
        if lb is None:
            t = time.perf_counter()
            lb = self._mint(height)
            with self._lock:
                if height not in self._memo:
                    self.minted_late += 1
                    self.late_s += time.perf_counter() - t
                lb = self._memo.setdefault(height, lb)
        return lb

    def report_evidence(self, ev) -> None:
        pass
