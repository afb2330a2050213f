"""ABCI requests, responses and the Application interface (subset).

The part of the JAX package's ``abci/types.py`` that block execution
and the handshake send (reference abci/types/application.go): Info,
InitChain, CheckTx, PrepareProposal, FinalizeBlock (with
``ExecTxResult``, ``Event``, ``CommitInfo`` and validator updates) and
Commit. ProcessProposal, vote extensions, queries, snapshots and the
app-side mempool wait for the slices that need them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..utils import proto

CODE_TYPE_OK = 0


@dataclass
class ValidatorUpdate:
    pub_key_type: str
    pub_key_bytes: bytes
    power: int


@dataclass
class EventAttribute:
    key: str
    value: str
    index: bool = True


@dataclass
class Event:
    type_: str
    # EventAttribute or bare (key, value, index) tuples: use attr_kvi
    attributes: List = field(default_factory=list)


def attr_kvi(a) -> tuple:
    """(key, value, index) from an EventAttribute or a tuple."""
    if isinstance(a, EventAttribute):
        return a.key, a.value, a.index
    k, v = a[0], a[1]
    idx = a[2] if len(a) > 2 else True
    if isinstance(k, bytes):
        k = k.decode()
    if isinstance(v, bytes):
        v = v.decode()
    return k, v, bool(idx)


@dataclass
class ExecTxResult:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: List[Event] = field(default_factory=list)
    codespace: str = ""

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK

    def encode(self) -> bytes:
        """The fields LastResultsHash covers."""
        return (
            proto.field_varint(1, self.code)
            + proto.field_bytes(2, self.data)
            + proto.field_varint(5, self.gas_wanted)
            + proto.field_varint(6, self.gas_used)
            + proto.field_string(8, self.codespace)
        )


BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3


@dataclass
class VoteInfo:
    """One validator's part in the decided commit."""

    validator_address: bytes = b""
    power: int = 0
    block_id_flag: int = BLOCK_ID_FLAG_ABSENT


@dataclass
class CommitInfo:
    round: int = 0
    votes: List[VoteInfo] = field(default_factory=list)


@dataclass
class RequestInfo:
    version: str = ""
    block_version: int = 0
    p2p_version: int = 0
    abci_version: str = ""


@dataclass
class ResponseInfo:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass
class RequestInitChain:
    time_ns: int = 0
    chain_id: str = ""
    consensus_params: Optional[object] = None
    validators: List[ValidatorUpdate] = field(default_factory=list)
    app_state_bytes: bytes = b""
    initial_height: int = 1


@dataclass
class ResponseInitChain:
    consensus_params: Optional[object] = None
    validators: List[ValidatorUpdate] = field(default_factory=list)
    app_hash: bytes = b""


CHECK_TX_TYPE_NEW = 0
CHECK_TX_TYPE_RECHECK = 1


@dataclass
class RequestCheckTx:
    tx: bytes = b""
    type_: int = CHECK_TX_TYPE_NEW


@dataclass
class ResponseCheckTx:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    gas_wanted: int = 0
    codespace: str = ""

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class RequestPrepareProposal:
    max_tx_bytes: int = 0
    txs: List[bytes] = field(default_factory=list)
    local_last_commit: Optional[object] = None
    misbehavior: list = field(default_factory=list)
    height: int = 0
    time_ns: int = 0
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass
class ResponsePrepareProposal:
    txs: List[bytes] = field(default_factory=list)


@dataclass
class RequestFinalizeBlock:
    txs: List[bytes] = field(default_factory=list)
    decided_last_commit: Optional[object] = None
    misbehavior: list = field(default_factory=list)
    hash: bytes = b""
    height: int = 0
    time_ns: int = 0
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass
class ResponseFinalizeBlock:
    events: List[Event] = field(default_factory=list)
    tx_results: List[ExecTxResult] = field(default_factory=list)
    validator_updates: List[ValidatorUpdate] = field(default_factory=list)
    consensus_param_updates: Optional[object] = None
    app_hash: bytes = b""


@dataclass
class ResponseCommit:
    retain_height: int = 0


class Application:
    """The calls this package makes, with accept-everything defaults
    (reference BaseApplication), so an app overrides what it needs."""

    def info(self, req: RequestInfo) -> ResponseInfo:
        return ResponseInfo()

    def check_tx(self, req: RequestCheckTx) -> ResponseCheckTx:
        return ResponseCheckTx()

    def init_chain(self, req: RequestInitChain) -> ResponseInitChain:
        return ResponseInitChain()

    def prepare_proposal(self, req: RequestPrepareProposal) -> ResponsePrepareProposal:
        # default: the txs as they come, within the byte budget
        out, total = [], 0
        for tx in req.txs:
            if total + len(tx) > req.max_tx_bytes:
                break
            out.append(tx)
            total += len(tx)
        return ResponsePrepareProposal(txs=out)

    def finalize_block(self, req: RequestFinalizeBlock) -> ResponseFinalizeBlock:
        return ResponseFinalizeBlock(tx_results=[ExecTxResult() for _ in req.txs])

    def commit(self) -> ResponseCommit:
        return ResponseCommit()
