"""vecbank: the finalize lane's throughput app, a vectorised transfer bank.

The port's copy of the JAX package's ``models/vecbank.py``. A
replicated bank of fixed-width accounts: a tx is a 16-byte transfer
record ``(src u32, dst u32, amt u64)``, big-endian (``>IIQ``), the state
one uint64 balance vector. ``finalize_block`` decodes the whole block
with ONE ``np.frombuffer`` over the joined tx bytes and applies it as
two scatter-adds (``np.subtract.at`` / ``np.add.at``). Balances wrap
mod 2^64, so the adds commute and the batch is order-independent and
digest-identical to the per-tx loop of ``scalar=True``, the semantic
reference and the no-numpy fallback.

It is the apply-side partner of ``state/native_finalize.py``: with the
app's apply sub-millisecond, the finalize span shows the hash and
encode work the native pass takes over (the JAX package's ``bench.py
finalize`` net, which ``chip_smoke.py`` phase 17b runs on the port).

app_hash = SHA-256(height, 8 bytes big-endian || the balances as
big-endian u64s), the same bytes from either mode.
"""

from __future__ import annotations

import hashlib
import struct
from typing import List

from ..abci import types as abci

TX_SIZE = 16  # >IIQ : src u32, dst u32, amt u64
_U64 = 1 << 64
# structured view of a transfer record — the vector path decodes the
# WHOLE block with one np.frombuffer over the joined tx bytes instead
# of a struct.unpack per tx
_REC_DTYPE = [("src", ">u4"), ("dst", ">u4"), ("amt", ">u8")]


def make_transfer(src: int, dst: int, amt: int) -> bytes:
    return struct.pack(">IIQ", src, dst, amt)


class VecBankApplication(abci.Application):
    """Account-bank app with a batch (vectorized) or per-tx (scalar)
    finalize apply — byte-identical app hashes either way."""

    def __init__(
        self,
        n_accounts: int = 1 << 14,
        initial_balance: int = 1_000_000,
        scalar: bool = False,
    ):
        self.n_accounts = n_accounts
        self.height = 0
        self.scalar = scalar
        self._np = None
        if not scalar:
            try:
                import numpy as np

                self._np = np
            except Exception:  # pragma: no cover - numpy is baked in
                self._np = None
        if self._np is not None:
            self.balances = self._np.full(
                n_accounts, initial_balance, dtype=self._np.uint64
            )
        else:
            self.balances = [initial_balance] * n_accounts
        self.app_hash = self._compute_hash(self.height, self.balances)
        self._pending = None
        self.applied_txs = 0

    # --- hashing ------------------------------------------------------

    def _compute_hash(self, height: int, balances) -> bytes:
        if self._np is not None:
            body = balances.astype(">u8").tobytes()
        else:
            body = b"".join(b.to_bytes(8, "big") for b in balances)
        return hashlib.sha256(
            struct.pack(">Q", height) + body
        ).digest()

    # --- tx decode/validate -------------------------------------------

    def _decode(self, tx: bytes):
        if len(tx) != TX_SIZE:
            return None
        src, dst, amt = struct.unpack(">IIQ", tx)
        if src >= self.n_accounts or dst >= self.n_accounts:
            return None
        return src, dst, amt

    # --- ABCI ---------------------------------------------------------

    def info(self, req):
        return abci.ResponseInfo(
            last_block_height=self.height,
            last_block_app_hash=self.app_hash if self.height else b"",
        )

    def init_chain(self, req):
        return abci.ResponseInitChain(app_hash=self.app_hash)

    def check_tx(self, req):
        return abci.ResponseCheckTx(
            code=0 if self._decode(req.tx) is not None else 1
        )

    def finalize_block(self, req):
        if self._np is not None and not self.scalar:
            return self._finalize_vector(req)
        return self._finalize_scalar(req)

    def _finalize_scalar(self, req):
        """The semantic reference (and no-numpy fallback): per-tx
        decode, per-tx result, sequential wraparound apply."""
        results: List[abci.ExecTxResult] = []
        decoded = []
        for tx in req.txs:
            rec = self._decode(tx)
            if rec is None:
                results.append(
                    abci.ExecTxResult(code=1, log="invalid transfer")
                )
            else:
                decoded.append(rec)
                results.append(abci.ExecTxResult())
        if self._np is not None:
            pending = self.balances.copy()
            np = self._np
            if decoded:
                recs = np.asarray(decoded, dtype=np.uint64)
                with np.errstate(over="ignore", under="ignore"):
                    np.subtract.at(
                        pending, recs[:, 0].astype(np.intp), recs[:, 2]
                    )
                    np.add.at(
                        pending, recs[:, 1].astype(np.intp), recs[:, 2]
                    )
        else:
            pending = list(self.balances)
            for src, dst, amt in decoded:
                pending[src] = (pending[src] - amt) % _U64
                pending[dst] = (pending[dst] + amt) % _U64
        app_hash = self._compute_hash(req.height, pending)
        self._pending = (req.height, pending, app_hash, len(decoded))
        return abci.ResponseFinalizeBlock(
            tx_results=results, app_hash=app_hash
        )

    def _finalize_vector(self, req):
        """The batch path: ONE np.frombuffer decode over the joined
        block, vectorized range validation, two scatter-adds.
        Wraparound add/sub mod 2^64 is commutative, so the batch is
        order-independent and digest-identical to the scalar loop."""
        np = self._np
        txs = req.txs
        n = len(txs)
        if n and all(len(t) == TX_SIZE for t in txs):
            recs = np.frombuffer(b"".join(txs), dtype=_REC_DTYPE)
            src = recs["src"].astype(np.intp)
            dst = recs["dst"].astype(np.intp)
            amt = recs["amt"].astype(np.uint64)
            valid = (src < self.n_accounts) & (dst < self.n_accounts)
            if not valid.all():
                src, dst, amt = src[valid], dst[valid], amt[valid]
        else:
            # odd-sized tx in the block: per-tx decode (the rare
            # path), batch apply below unchanged
            rows = [self._decode(tx) for tx in txs]
            valid = np.fromiter(
                (r is not None for r in rows), dtype=bool, count=n
            )
            kept = [r for r in rows if r is not None]
            arr = np.asarray(kept, dtype=np.uint64).reshape(-1, 3)
            src = arr[:, 0].astype(np.intp)
            dst = arr[:, 1].astype(np.intp)
            amt = arr[:, 2]
        n_valid = int(src.shape[0])
        pending = self.balances.copy()
        if n_valid:
            with np.errstate(over="ignore", under="ignore"):
                np.subtract.at(pending, src, amt)
                np.add.at(pending, dst, amt)
        app_hash = self._compute_hash(req.height, pending)
        self._pending = (req.height, pending, app_hash, n_valid)
        # result objects are value-only (read, encoded, never
        # mutated downstream): the all-valid block shares ONE ok
        # result instead of constructing n of them
        ok = abci.ExecTxResult()
        if n_valid == n:
            results = [ok] * n
        else:
            bad = abci.ExecTxResult(code=1, log="invalid transfer")
            results = [ok if v else bad for v in valid]
        return abci.ResponseFinalizeBlock(
            tx_results=results, app_hash=app_hash
        )

    def commit(self):
        if self._pending is not None:
            height, pending, app_hash, n = self._pending
            self.height = height
            self.balances = pending
            self.app_hash = app_hash
            self.applied_txs += n
            self._pending = None
        return abci.ResponseCommit()

    def query(self, req):
        """key = 4-byte big-endian account index -> 8-byte balance."""
        try:
            (idx,) = struct.unpack(">I", req.data)
        except struct.error:
            return abci.ResponseQuery(code=1, log="bad account key")
        if idx >= self.n_accounts:
            return abci.ResponseQuery(code=1, log="no such account")
        bal = int(self.balances[idx])
        return abci.ResponseQuery(
            code=0,
            key=req.data,
            value=bal.to_bytes(8, "big"),
            height=self.height,
        )


def make_block_txs(
    rng, n_txs: int, n_accounts: int, max_amt: int = 1000
) -> List[bytes]:
    """A deterministic batch of transfers (rng: a random.Random)."""
    return [
        make_transfer(
            rng.randrange(n_accounts),
            rng.randrange(n_accounts),
            rng.randrange(max_amt),
        )
        for _ in range(n_txs)
    ]
