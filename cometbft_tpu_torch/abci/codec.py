"""ABCI process-boundary wire codec (reference abci/types/messages.go,
abci/client/socket_client.go:118-160).

A copy of the JAX package's ``abci/codec.py``: a Request or Response
envelope whose field number selects the method, each payload a nested
message in standard proto wire format (``utils/proto``), framed by a
varint length on the socket. Every kind is here, the fork's app-side
mempool calls ``INSERT_TX`` (21) and ``REAP_TXS`` (22) included, and
each encodes to the JAX codec's bytes, so a port client talks to a JAX
server and the reverse.
"""

from __future__ import annotations

from typing import Tuple

from ..utils import proto
from . import types as abci

# envelope field numbers (match reference Request/Response oneof tags
# where they exist: abci/types.proto Request)
ECHO = 1
FLUSH = 2
INFO = 3
INIT_CHAIN = 5
QUERY = 6
CHECK_TX = 8
COMMIT = 11
LIST_SNAPSHOTS = 12
OFFER_SNAPSHOT = 13
LOAD_SNAPSHOT_CHUNK = 14
APPLY_SNAPSHOT_CHUNK = 15
PREPARE_PROPOSAL = 16
PROCESS_PROPOSAL = 17
EXTEND_VOTE = 18
VERIFY_VOTE_EXTENSION = 19
FINALIZE_BLOCK = 20
# fork extensions (abci/types/application.go:16-17 InsertTx, ReapTxs)
INSERT_TX = 21
REAP_TXS = 22
EXCEPTION = 63


# --- shared sub-messages ------------------------------------------------


def enc_event(e: abci.Event) -> bytes:
    out = proto.field_string(1, e.type_)
    for a in e.attributes:
        k, v, idx = abci.attr_kvi(a)
        out += proto.field_message(
            2,
            proto.field_string(1, k)
            + proto.field_string(2, v)
            + proto.field_varint(3, 1 if idx else 0),
        )
    return out


def dec_event(raw: bytes) -> abci.Event:
    m = proto.parse(raw)
    attrs = []
    for am in m.get(2, []):
        a = proto.parse(am)
        attrs.append(
            abci.EventAttribute(
                key=proto.get1(a, 1, b"").decode(),
                value=proto.get1(a, 2, b"").decode(),
                index=bool(proto.get1(a, 3, 0)),
            )
        )
    return abci.Event(
        type_=proto.get1(m, 1, b"").decode(), attributes=attrs
    )


def enc_tx_result(r: abci.ExecTxResult) -> bytes:
    return (
        proto.field_varint(1, r.code)
        + proto.field_bytes(2, r.data)
        + proto.field_string(3, r.log)
        + proto.field_string(4, r.info)
        + proto.field_varint(5, r.gas_wanted)
        + proto.field_varint(6, r.gas_used)
        + b"".join(proto.field_message(7, enc_event(e)) for e in r.events)
        + proto.field_string(8, r.codespace)
    )


def dec_tx_result(raw: bytes) -> abci.ExecTxResult:
    m = proto.parse(raw)
    return abci.ExecTxResult(
        code=proto.get1(m, 1, 0),
        data=proto.get1(m, 2, b""),
        log=proto.get1(m, 3, b"").decode(),
        info=proto.get1(m, 4, b"").decode(),
        gas_wanted=proto.get1(m, 5, 0),
        gas_used=proto.get1(m, 6, 0),
        events=[dec_event(e) for e in m.get(7, [])],
        codespace=proto.get1(m, 8, b"").decode(),
    )


def enc_validator_update(v: abci.ValidatorUpdate) -> bytes:
    return (
        proto.field_string(1, v.pub_key_type)
        + proto.field_bytes(2, v.pub_key_bytes)
        + proto.field_varint(3, v.power)
    )


def dec_validator_update(raw: bytes) -> abci.ValidatorUpdate:
    m = proto.parse(raw)
    return abci.ValidatorUpdate(
        pub_key_type=proto.get1(m, 1, b"").decode(),
        pub_key_bytes=proto.get1(m, 2, b""),
        power=proto.get1(m, 3, 0),
    )


def enc_commit_info(ci) -> bytes:
    if ci is None:
        return None
    out = proto.field_varint(1, ci.round)
    for v in ci.votes:
        out += proto.field_message(
            2,
            proto.field_bytes(1, v.validator_address)
            + proto.field_varint(2, v.power)
            + proto.field_varint(3, v.block_id_flag),
        )
    return out  # may be b"": field_message still emits it when not None


def dec_commit_info(raw) -> abci.CommitInfo:
    if raw is None:
        return None
    m = proto.parse(raw)
    votes = []
    for vm in m.get(2, []):
        v = proto.parse(vm)
        votes.append(
            abci.VoteInfo(
                validator_address=proto.get1(v, 1, b""),
                power=proto.get1(v, 2, 0),
                block_id_flag=proto.get1(v, 3, abci.BLOCK_ID_FLAG_ABSENT),
            )
        )
    return abci.CommitInfo(round=proto.get1(m, 1, 0), votes=votes)


def enc_misbehavior(mb: abci.Misbehavior) -> bytes:
    return (
        proto.field_varint(1, mb.type_)
        + proto.field_bytes(2, mb.validator_address)
        + proto.field_varint(3, mb.validator_power)
        + proto.field_varint(4, mb.height)
        + proto.field_varint(5, mb.time_ns)
        + proto.field_varint(6, mb.total_voting_power)
    )


def dec_misbehavior(raw: bytes) -> abci.Misbehavior:
    m = proto.parse(raw)
    return abci.Misbehavior(
        type_=proto.get1(m, 1, 0),
        validator_address=proto.get1(m, 2, b""),
        validator_power=proto.get1(m, 3, 0),
        height=proto.get1(m, 4, 0),
        time_ns=proto.get1(m, 5, 0),
        total_voting_power=proto.get1(m, 6, 0),
    )


def _enc_params(p) -> bytes:
    return None if p is None else p.encode()


def _dec_params(raw):
    if raw is None:
        return None
    from ..state.state_types import ConsensusParams

    return ConsensusParams.decode(raw)


def enc_snapshot(s: abci.Snapshot) -> bytes:
    return (
        proto.field_varint(1, s.height)
        + proto.field_varint(2, s.format)
        + proto.field_varint(3, s.chunks)
        + proto.field_bytes(4, s.hash)
        + proto.field_bytes(5, s.metadata)
    )


def dec_snapshot(raw: bytes) -> abci.Snapshot:
    m = proto.parse(raw)
    return abci.Snapshot(
        height=proto.get1(m, 1, 0),
        format=proto.get1(m, 2, 0),
        chunks=proto.get1(m, 3, 0),
        hash=proto.get1(m, 4, b""),
        metadata=proto.get1(m, 5, b""),
    )


# --- requests -----------------------------------------------------------


def encode_request(kind: int, req) -> bytes:
    """Envelope a request; ``req`` is the dataclass for ``kind`` (or a
    tuple for the primitive-arg methods)."""
    if kind == ECHO:
        body = proto.field_string(1, req)
    elif kind in (FLUSH, COMMIT, LIST_SNAPSHOTS):
        body = b""
    elif kind == INFO:
        body = (
            proto.field_string(1, req.version)
            + proto.field_varint(2, req.block_version)
            + proto.field_varint(3, req.p2p_version)
            + proto.field_string(4, req.abci_version)
        )
    elif kind == INIT_CHAIN:
        body = (
            proto.field_varint(1, req.time_ns)
            + proto.field_string(2, req.chain_id)
            + proto.field_message(3, _enc_params(req.consensus_params))
            + b"".join(
                proto.field_message(4, enc_validator_update(v))
                for v in req.validators
            )
            + proto.field_bytes(5, req.app_state_bytes)
            + proto.field_varint(6, req.initial_height)
        )
    elif kind == QUERY:
        body = (
            proto.field_bytes(1, req.data)
            + proto.field_string(2, req.path)
            + proto.field_varint(3, req.height)
            + proto.field_varint(4, 1 if req.prove else 0)
        )
    elif kind == CHECK_TX:
        body = proto.field_bytes(1, req.tx) + proto.field_varint(
            3, req.type_
        )
    elif kind == OFFER_SNAPSHOT:
        snap, app_hash = req
        body = proto.field_message(1, enc_snapshot(snap)) + proto.field_bytes(
            2, app_hash
        )
    elif kind == LOAD_SNAPSHOT_CHUNK:
        h, f, c = req
        body = (
            proto.field_varint(1, h)
            + proto.field_varint(2, f)
            + proto.field_varint(3, c)
        )
    elif kind == APPLY_SNAPSHOT_CHUNK:
        idx, chunk, sender = req
        body = (
            proto.field_varint(1, idx)
            + proto.field_bytes(2, chunk)
            + proto.field_string(3, sender)
        )
    elif kind == PREPARE_PROPOSAL:
        body = (
            proto.field_varint(1, req.max_tx_bytes)
            + b"".join(proto.field_bytes(2, t) or proto.field_message(2, b"") for t in req.txs)
            + proto.field_message(3, enc_commit_info(req.local_last_commit))
            + b"".join(
                proto.field_message(4, enc_misbehavior(mb))
                for mb in req.misbehavior
            )
            + proto.field_varint(5, req.height)
            + proto.field_varint(6, req.time_ns)
            + proto.field_bytes(7, req.next_validators_hash)
            + proto.field_bytes(8, req.proposer_address)
        )
    elif kind == PROCESS_PROPOSAL:
        body = (
            b"".join(proto.field_bytes(1, t) or proto.field_message(1, b"") for t in req.txs)
            + proto.field_message(2, enc_commit_info(req.proposed_last_commit))
            + b"".join(
                proto.field_message(3, enc_misbehavior(mb))
                for mb in req.misbehavior
            )
            + proto.field_bytes(4, req.hash)
            + proto.field_varint(5, req.height)
            + proto.field_varint(6, req.time_ns)
            + proto.field_bytes(7, req.next_validators_hash)
            + proto.field_bytes(8, req.proposer_address)
        )
    elif kind == EXTEND_VOTE:
        body = (
            proto.field_bytes(1, req.hash)
            + proto.field_varint(2, req.height)
            + proto.field_varint(3, req.round)
            + proto.field_varint(4, req.time_ns)
        )
    elif kind == VERIFY_VOTE_EXTENSION:
        body = (
            proto.field_bytes(1, req.hash)
            + proto.field_bytes(2, req.validator_address)
            + proto.field_varint(3, req.height)
            + proto.field_bytes(4, req.vote_extension)
        )
    elif kind == FINALIZE_BLOCK:
        body = (
            b"".join(proto.field_bytes(1, t) or proto.field_message(1, b"") for t in req.txs)
            + proto.field_message(2, enc_commit_info(req.decided_last_commit))
            + b"".join(
                proto.field_message(3, enc_misbehavior(mb))
                for mb in req.misbehavior
            )
            + proto.field_bytes(4, req.hash)
            + proto.field_varint(5, req.height)
            + proto.field_varint(6, req.time_ns)
            + proto.field_bytes(7, req.next_validators_hash)
            + proto.field_bytes(8, req.proposer_address)
        )
    elif kind == INSERT_TX:
        body = proto.field_bytes(1, req)
    elif kind == REAP_TXS:
        mb, mg = req
        body = proto.field_sfixed64(1, mb) + proto.field_sfixed64(2, mg)
    else:
        raise ValueError(f"unknown request kind {kind}")
    return proto.field_message(kind, body)


def decode_request(raw: bytes) -> Tuple[int, object]:
    env = proto.parse(raw)
    if len(env) != 1:
        raise ValueError("request envelope must have exactly one field")
    kind = next(iter(env))
    m = proto.parse(env[kind][0])
    g = lambda f, d=0: proto.get1(m, f, d)  # noqa: E731
    if kind == ECHO:
        return kind, proto.get1(m, 1, b"").decode()
    if kind in (FLUSH, COMMIT, LIST_SNAPSHOTS):
        return kind, None
    if kind == INFO:
        return kind, abci.RequestInfo(
            version=proto.get1(m, 1, b"").decode(),
            block_version=g(2),
            p2p_version=g(3),
            abci_version=proto.get1(m, 4, b"").decode(),
        )
    if kind == INIT_CHAIN:
        return kind, abci.RequestInitChain(
            time_ns=g(1),
            chain_id=proto.get1(m, 2, b"").decode(),
            consensus_params=_dec_params(proto.get1(m, 3)),
            validators=[dec_validator_update(v) for v in m.get(4, [])],
            app_state_bytes=g(5, b""),
            initial_height=g(6, 1),
        )
    if kind == QUERY:
        return kind, abci.RequestQuery(
            data=g(1, b""),
            path=proto.get1(m, 2, b"").decode(),
            height=g(3),
            prove=bool(g(4)),
        )
    if kind == CHECK_TX:
        return kind, abci.RequestCheckTx(tx=g(1, b""), type_=g(3))
    if kind == OFFER_SNAPSHOT:
        return kind, (dec_snapshot(proto.get1(m, 1, b"")), g(2, b""))
    if kind == LOAD_SNAPSHOT_CHUNK:
        return kind, (g(1), g(2), g(3))
    if kind == APPLY_SNAPSHOT_CHUNK:
        return kind, (g(1), g(2, b""), proto.get1(m, 3, b"").decode())
    if kind == PREPARE_PROPOSAL:
        return kind, abci.RequestPrepareProposal(
            max_tx_bytes=g(1),
            txs=list(m.get(2, [])),
            local_last_commit=dec_commit_info(proto.get1(m, 3)),
            misbehavior=[dec_misbehavior(x) for x in m.get(4, [])],
            height=g(5),
            time_ns=g(6),
            next_validators_hash=g(7, b""),
            proposer_address=g(8, b""),
        )
    if kind == PROCESS_PROPOSAL:
        return kind, abci.RequestProcessProposal(
            txs=list(m.get(1, [])),
            proposed_last_commit=dec_commit_info(proto.get1(m, 2)),
            misbehavior=[dec_misbehavior(x) for x in m.get(3, [])],
            hash=g(4, b""),
            height=g(5),
            time_ns=g(6),
            next_validators_hash=g(7, b""),
            proposer_address=g(8, b""),
        )
    if kind == EXTEND_VOTE:
        return kind, abci.RequestExtendVote(
            hash=g(1, b""), height=g(2), round=g(3), time_ns=g(4)
        )
    if kind == VERIFY_VOTE_EXTENSION:
        return kind, abci.RequestVerifyVoteExtension(
            hash=g(1, b""),
            validator_address=g(2, b""),
            height=g(3),
            vote_extension=g(4, b""),
        )
    if kind == FINALIZE_BLOCK:
        return kind, abci.RequestFinalizeBlock(
            txs=list(m.get(1, [])),
            decided_last_commit=dec_commit_info(proto.get1(m, 2)),
            misbehavior=[dec_misbehavior(x) for x in m.get(3, [])],
            hash=g(4, b""),
            height=g(5),
            time_ns=g(6),
            next_validators_hash=g(7, b""),
            proposer_address=g(8, b""),
        )
    if kind == INSERT_TX:
        return kind, g(1, b"")
    if kind == REAP_TXS:
        return kind, (g(1), g(2))
    raise ValueError(f"unknown request kind {kind}")


# --- responses ----------------------------------------------------------


def encode_response(kind: int, resp) -> bytes:
    if kind == EXCEPTION:
        body = proto.field_string(1, str(resp))
    elif kind == ECHO:
        body = proto.field_string(1, resp)
    elif kind == FLUSH:
        body = b""
    elif kind == INFO:
        body = (
            proto.field_string(1, resp.data)
            + proto.field_string(2, resp.version)
            + proto.field_varint(3, resp.app_version)
            + proto.field_varint(4, resp.last_block_height)
            + proto.field_bytes(5, resp.last_block_app_hash)
        )
    elif kind == INIT_CHAIN:
        body = (
            proto.field_message(1, _enc_params(resp.consensus_params))
            + b"".join(
                proto.field_message(2, enc_validator_update(v))
                for v in resp.validators
            )
            + proto.field_bytes(3, resp.app_hash)
        )
    elif kind == QUERY:
        body = (
            proto.field_varint(1, resp.code)
            + proto.field_string(2, resp.log)
            + proto.field_bytes(3, resp.key)
            + proto.field_bytes(4, resp.value)
            + proto.field_varint(5, resp.height)
            + proto.field_bytes(6, resp.proof_ops)
        )
    elif kind == CHECK_TX:
        body = (
            proto.field_varint(1, resp.code)
            + proto.field_bytes(2, resp.data)
            + proto.field_string(3, resp.log)
            + proto.field_varint(5, resp.gas_wanted)
            + proto.field_string(8, resp.codespace)
        )
    elif kind == COMMIT:
        body = proto.field_varint(3, resp.retain_height)
    elif kind == LIST_SNAPSHOTS:
        body = b"".join(
            proto.field_message(1, enc_snapshot(s)) for s in resp
        )
    elif kind == OFFER_SNAPSHOT:
        body = proto.field_varint(1, resp.result)
    elif kind == LOAD_SNAPSHOT_CHUNK:
        body = proto.field_bytes(1, resp)
    elif kind == APPLY_SNAPSHOT_CHUNK:
        body = (
            proto.field_varint(1, resp.result)
            + b"".join(proto.field_varint(2, c) or proto.tag(2, 0) + b"\x00" for c in resp.refetch_chunks)
            + b"".join(proto.field_string(3, s) for s in resp.reject_senders)
        )
    elif kind == PREPARE_PROPOSAL:
        body = b"".join(proto.field_bytes(1, t) or proto.field_message(1, b"") for t in resp.txs)
    elif kind == PROCESS_PROPOSAL:
        body = proto.field_varint(1, resp.status)
    elif kind == EXTEND_VOTE:
        body = proto.field_bytes(1, resp.vote_extension)
    elif kind == VERIFY_VOTE_EXTENSION:
        body = proto.field_varint(1, resp.status)
    elif kind == FINALIZE_BLOCK:
        body = (
            b"".join(proto.field_message(1, enc_event(e)) for e in resp.events)
            + b"".join(
                proto.field_message(2, enc_tx_result(r))
                for r in resp.tx_results
            )
            + b"".join(
                proto.field_message(3, enc_validator_update(v))
                for v in resp.validator_updates
            )
            + proto.field_message(
                4, _enc_params(resp.consensus_param_updates)
            )
            + proto.field_bytes(5, resp.app_hash)
        )
    elif kind == INSERT_TX:
        body = proto.field_varint(1, 1 if resp else 0)
    elif kind == REAP_TXS:
        body = b"".join(proto.field_bytes(1, t) or proto.field_message(1, b"") for t in resp)
    else:
        raise ValueError(f"unknown response kind {kind}")
    return proto.field_message(kind, body)


def decode_response(raw: bytes) -> Tuple[int, object]:
    env = proto.parse(raw)
    if len(env) != 1:
        raise ValueError("response envelope must have exactly one field")
    kind = next(iter(env))
    m = proto.parse(env[kind][0])
    g = lambda f, d=0: proto.get1(m, f, d)  # noqa: E731
    if kind == EXCEPTION:
        raise RuntimeError(
            "abci exception: " + proto.get1(m, 1, b"").decode()
        )
    if kind == ECHO:
        return kind, proto.get1(m, 1, b"").decode()
    if kind == FLUSH:
        return kind, None
    if kind == INFO:
        return kind, abci.ResponseInfo(
            data=proto.get1(m, 1, b"").decode(),
            version=proto.get1(m, 2, b"").decode(),
            app_version=g(3),
            last_block_height=g(4),
            last_block_app_hash=g(5, b""),
        )
    if kind == INIT_CHAIN:
        return kind, abci.ResponseInitChain(
            consensus_params=_dec_params(proto.get1(m, 1)),
            validators=[dec_validator_update(v) for v in m.get(2, [])],
            app_hash=g(3, b""),
        )
    if kind == QUERY:
        return kind, abci.ResponseQuery(
            code=g(1),
            log=proto.get1(m, 2, b"").decode(),
            key=g(3, b""),
            value=g(4, b""),
            height=g(5),
            proof_ops=g(6, b""),
        )
    if kind == CHECK_TX:
        return kind, abci.ResponseCheckTx(
            code=g(1),
            data=g(2, b""),
            log=proto.get1(m, 3, b"").decode(),
            gas_wanted=g(5),
            codespace=proto.get1(m, 8, b"").decode(),
        )
    if kind == COMMIT:
        return kind, abci.ResponseCommit(retain_height=g(3))
    if kind == LIST_SNAPSHOTS:
        return kind, [dec_snapshot(s) for s in m.get(1, [])]
    if kind == OFFER_SNAPSHOT:
        return kind, abci.ResponseOfferSnapshot(
            result=g(1, abci.OFFER_SNAPSHOT_REJECT)
        )
    if kind == LOAD_SNAPSHOT_CHUNK:
        return kind, g(1, b"")
    if kind == APPLY_SNAPSHOT_CHUNK:
        return kind, abci.ResponseApplySnapshotChunk(
            result=g(1, abci.APPLY_CHUNK_ABORT),
            refetch_chunks=list(m.get(2, [])),
            reject_senders=[s.decode() for s in m.get(3, [])],
        )
    if kind == PREPARE_PROPOSAL:
        return kind, abci.ResponsePrepareProposal(txs=list(m.get(1, [])))
    if kind == PROCESS_PROPOSAL:
        return kind, abci.ResponseProcessProposal(
            status=g(1, abci.PROCESS_PROPOSAL_REJECT)
        )
    if kind == EXTEND_VOTE:
        return kind, abci.ResponseExtendVote(vote_extension=g(1, b""))
    if kind == VERIFY_VOTE_EXTENSION:
        return kind, abci.ResponseVerifyVoteExtension(
            status=g(1, abci.VERIFY_VOTE_EXT_REJECT)
        )
    if kind == FINALIZE_BLOCK:
        return kind, abci.ResponseFinalizeBlock(
            events=[dec_event(e) for e in m.get(1, [])],
            tx_results=[dec_tx_result(r) for r in m.get(2, [])],
            validator_updates=[
                dec_validator_update(v) for v in m.get(3, [])
            ],
            consensus_param_updates=_dec_params(proto.get1(m, 4)),
            app_hash=g(5, b""),
        )
    if kind == INSERT_TX:
        return kind, bool(g(1))
    if kind == REAP_TXS:
        return kind, list(m.get(1, []))
    raise ValueError(f"unknown response kind {kind}")
