"""Out-of-process ABCI in the port against the JAX package's, on the CPU.

- The ports of ``tests/test_abci_remote.py``'s six cases: the codec's
  round trip of every kind, the EXCEPTION envelope, the socket and gRPC
  clients against a kvstore server, ``build_node`` dialing the app named
  by ``base.proxy_app``, and an app's exception answered without losing
  the connection.
- Bytes: every request and response kind, the fork's INSERT_TX and
  REAP_TXS included, encodes to the JAX codec's bytes, and each codec
  decodes the other's.
- Interop: a port ``SocketClient`` against a JAX ``ABCIServer`` and a
  JAX client against a port server, and the same over gRPC.
- The config fault: ``BaseConfig`` takes no unknown field, and a port
  ``Node`` with ``proxy_app`` set runs no app of its own.
"""

import asyncio
import threading

import pytest

from cometbft_tpu.abci import codec as jcodec
from cometbft_tpu.abci import server as jserver
from cometbft_tpu.abci import socket_client as jclient
from cometbft_tpu.abci import types as jabci
from cometbft_tpu.models.kvstore import KVStoreApplication as JKVStore
from cometbft_tpu.state.state_types import ConsensusParams as JParams
from cometbft_tpu_torch.abci import codec
from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.server import ABCIServer, GRPCServer
from cometbft_tpu_torch.abci.socket_client import GRPCClient, SocketClient, connect_app_conns
from cometbft_tpu_torch.models.kvstore import KVStoreApplication
from cometbft_tpu_torch.state.state_types import ConsensusParams
from torch_hard_limit import hard_limit  # noqa: F401


def requests(T, params):
    """(kind, request) for every request kind, built from the abci
    types module ``T`` (either package's)."""
    commit = T.CommitInfo(round=2, votes=[T.VoteInfo(b"\x02" * 20, 5, T.BLOCK_ID_FLAG_COMMIT),
                                          T.VoteInfo(b"\x04" * 20, 7, T.BLOCK_ID_FLAG_ABSENT)])
    mb = [T.Misbehavior(type_=T.MISBEHAVIOR_DUPLICATE_VOTE, validator_address=b"\x03" * 20,
                        validator_power=9, height=44, time_ns=1, total_voting_power=100)]
    prep = dict(misbehavior=mb, height=44, time_ns=99, next_validators_hash=b"\x05" * 32,
                proposer_address=b"\x06" * 20)
    block = dict(prep, hash=b"\xaa" * 32)
    return [
        (codec.ECHO, "hello"),
        (codec.FLUSH, None),
        (codec.INFO, T.RequestInfo(version="1.0", block_version=11, p2p_version=8, abci_version="2.0")),
        (codec.INIT_CHAIN, T.RequestInitChain(
            time_ns=123, chain_id="test-chain", consensus_params=params,
            validators=[T.ValidatorUpdate("ed25519", b"\x01" * 32, 10)], app_state_bytes=b"{}",
            initial_height=7)),
        (codec.QUERY, T.RequestQuery(data=b"k", path="/store", height=5, prove=True)),
        (codec.CHECK_TX, T.RequestCheckTx(tx=b"a=1", type_=1)),
        (codec.COMMIT, None),
        (codec.LIST_SNAPSHOTS, None),
        (codec.OFFER_SNAPSHOT, (T.Snapshot(height=10, format=1, chunks=3, hash=b"h" * 32, metadata=b"m"),
                                b"apphash")),
        (codec.LOAD_SNAPSHOT_CHUNK, (10, 0, 2)),
        (codec.APPLY_SNAPSHOT_CHUNK, (1, b"chunk", "peer1")),
        (codec.PREPARE_PROPOSAL, T.RequestPrepareProposal(
            max_tx_bytes=1 << 20, txs=[b"a=1", b"", b"b=2"], local_last_commit=commit, **prep)),
        (codec.PROCESS_PROPOSAL, T.RequestProcessProposal(
            txs=[b"a=1", b""], proposed_last_commit=commit, **block)),
        (codec.EXTEND_VOTE, T.RequestExtendVote(hash=b"\xaa" * 32, height=44, round=1, time_ns=5)),
        (codec.VERIFY_VOTE_EXTENSION, T.RequestVerifyVoteExtension(
            hash=b"\xaa" * 32, validator_address=b"\x02" * 20, height=44, vote_extension=b"ext")),
        (codec.FINALIZE_BLOCK, T.RequestFinalizeBlock(
            txs=[b"a=1", b"", b"b=2"], decided_last_commit=commit, **block)),
        (codec.INSERT_TX, b"tx-bytes"),
        (codec.REAP_TXS, (1000, -1)),
    ]


def responses(T, params):
    """(kind, response) for every response kind."""
    return [
        (codec.ECHO, "hello"),
        (codec.FLUSH, None),
        (codec.INFO, T.ResponseInfo(data="kv", version="1", app_version=2, last_block_height=3,
                                    last_block_app_hash=b"\x01" * 8)),
        (codec.INIT_CHAIN, T.ResponseInitChain(
            consensus_params=params, validators=[T.ValidatorUpdate("ed25519", b"\x01" * 32, 3)],
            app_hash=b"\x09" * 32)),
        (codec.QUERY, T.ResponseQuery(code=1, log="l", key=b"k", value=b"v", height=4, proof_ops=b"p")),
        (codec.CHECK_TX, T.ResponseCheckTx(code=1, data=b"d", log="bad", gas_wanted=3, codespace="mem")),
        (codec.COMMIT, T.ResponseCommit(retain_height=12)),
        (codec.LIST_SNAPSHOTS, [T.Snapshot(height=10, format=1, chunks=3, hash=b"h", metadata=b"m")]),
        (codec.OFFER_SNAPSHOT, T.ResponseOfferSnapshot(result=T.OFFER_SNAPSHOT_ACCEPT)),
        (codec.LOAD_SNAPSHOT_CHUNK, b"chunk-bytes"),
        (codec.APPLY_SNAPSHOT_CHUNK, T.ResponseApplySnapshotChunk(
            result=T.APPLY_CHUNK_RETRY, refetch_chunks=[0, 3], reject_senders=["p1"])),
        (codec.PREPARE_PROPOSAL, T.ResponsePrepareProposal(txs=[b"a", b"", b"c"])),
        (codec.PROCESS_PROPOSAL, T.ResponseProcessProposal(status=T.PROCESS_PROPOSAL_ACCEPT)),
        (codec.EXTEND_VOTE, T.ResponseExtendVote(vote_extension=b"ext")),
        (codec.VERIFY_VOTE_EXTENSION, T.ResponseVerifyVoteExtension(status=T.VERIFY_VOTE_EXT_ACCEPT)),
        (codec.FINALIZE_BLOCK, T.ResponseFinalizeBlock(
            events=[T.Event("commit", [T.EventAttribute("k", "v", True)])],
            tx_results=[T.ExecTxResult(code=0, data=b"ok", log="l", gas_used=2,
                                       events=[T.Event("tx", [T.EventAttribute("a", "b")])])],
            validator_updates=[T.ValidatorUpdate("ed25519", b"\x01" * 32, 0)],
            consensus_param_updates=params, app_hash=b"\x07" * 32)),
        (codec.INSERT_TX, True),
        (codec.REAP_TXS, [b"a", b"", b"c"]),
    ]


def test_codec_roundtrip_all_kinds():
    for kind, req in requests(abci, ConsensusParams()):
        k2, r2 = codec.decode_request(codec.encode_request(kind, req))
        assert (k2, r2) == (kind, req)
    for kind, resp in responses(abci, ConsensusParams()):
        k2, r2 = codec.decode_response(codec.encode_response(kind, resp))
        assert (k2, r2) == (kind, resp)


def test_exception_response_raises():
    raw = codec.encode_response(codec.EXCEPTION, ValueError("boom"))
    with pytest.raises(RuntimeError, match="boom"):
        codec.decode_response(raw)
    assert raw == jcodec.encode_response(jcodec.EXCEPTION, ValueError("boom"))


def _as_dict(x):
    """A dataclass tree as plain values, to compare across packages."""
    import dataclasses

    if dataclasses.is_dataclass(x):
        return {f.name: _as_dict(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_as_dict(v) for v in x]
    return x


@pytest.mark.parametrize("side", ["request", "response"])
def test_codec_bytes_equal_jax_and_decode_each_other(side):
    """Every kind (INSERT_TX and REAP_TXS included) encodes to the JAX
    codec's bytes, and each codec decodes the other's bytes to equal
    values."""
    make = requests if side == "request" else responses
    port_cases, jax_cases = make(abci, ConsensusParams()), make(jabci, JParams())
    enc = codec.encode_request if side == "request" else codec.encode_response
    jenc = jcodec.encode_request if side == "request" else jcodec.encode_response
    dec = codec.decode_request if side == "request" else codec.decode_response
    jdec = jcodec.decode_request if side == "request" else jcodec.decode_response
    kinds = set()
    for (kind, ours), (_, theirs) in zip(port_cases, jax_cases):
        raw = enc(kind, ours)
        assert raw == jenc(kind, theirs), kind
        assert _as_dict(dec(raw)) == _as_dict(jdec(raw)), kind
        kinds.add(kind)
    assert {codec.INSERT_TX, codec.REAP_TXS, codec.FINALIZE_BLOCK} <= kinds
    assert len(kinds) == (18 if side == "request" else 18)


def _run_socket_server(app, server_cls=ABCIServer):
    """Start a socket server on an ephemeral port in a background loop."""
    loop = asyncio.new_event_loop()
    server = server_cls(app, "tcp://127.0.0.1:0")
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)

        async def go():
            await server.start()
            started.set()

        loop.run_until_complete(go())
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    assert started.wait(5)
    return server, loop


def _drive(conns, R):
    """The JAX test's drive through ``conns`` (request types from ``R``);
    returns what the app answered."""
    assert conns.query.echo("ping") == "ping"
    conns.consensus.init_chain(R.RequestInitChain(chain_id="t", initial_height=1))
    assert conns.mempool.check_tx(R.RequestCheckTx(tx=b"k=v")).is_ok()
    futs = [conns.mempool.check_tx_async(R.RequestCheckTx(tx=f"k{i}=v".encode())) for i in range(16)]
    assert all(f.result(5).is_ok() for f in futs)
    assert all(r.is_ok() for r in conns.mempool.check_tx_batch(
        [R.RequestCheckTx(tx=f"b{i}=v".encode()) for i in range(8)]))
    fr = conns.consensus.finalize_block(R.RequestFinalizeBlock(txs=[b"k=v", b"x=1"], height=1))
    assert len(fr.tx_results) == 2 and all(r.is_ok() for r in fr.tx_results)
    conns.consensus.commit()
    q = conns.query.query(R.RequestQuery(data=b"k", path="/store"))
    return q.value, fr.app_hash, conns.query.info(R.RequestInfo()).last_block_app_hash


def _close(conns):
    for c in {id(c): c for c in (conns.consensus, conns.mempool, conns.query, conns.snapshot)}.values():
        c.close()


def test_socket_client_against_kvstore():
    app = KVStoreApplication()
    server, loop = _run_socket_server(app)
    try:
        conns = connect_app_conns(server.listen_addr)
        value, app_hash, info_hash = _drive(conns, abci)
        assert value == b"v" and app_hash == info_hash == app.app_hash
        _close(conns)
    finally:
        loop.call_soon_threadsafe(loop.stop)


def test_grpc_client_against_kvstore():
    app = KVStoreApplication()
    server = GRPCServer(app, "tcp://127.0.0.1:0")
    server.start()
    try:
        client = GRPCClient(f"tcp://127.0.0.1:{server.port}")
        assert client.echo("ping") == "ping"
        client.init_chain(abci.RequestInitChain(chain_id="t"))
        assert client.check_tx(abci.RequestCheckTx(tx=b"x=1")).is_ok()
        fr = client.finalize_block(abci.RequestFinalizeBlock(txs=[b"x=1"], height=1))
        assert fr.tx_results[0].is_ok()
        client.commit()
        assert client.query(abci.RequestQuery(data=b"x", path="/store")).value == b"1"
        client.close()
    finally:
        server.stop()


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_socket_interop_with_jax(client_pkg):
    """A port client against a JAX server, and a JAX client against a
    port server: the same drive answers alike."""
    if client_pkg == "port":
        app = JKVStore()
        server, loop = _run_socket_server(app, jserver.ABCIServer)
        dial, R = connect_app_conns, abci
    else:
        app = KVStoreApplication()
        server, loop = _run_socket_server(app, ABCIServer)
        dial, R = jclient.connect_app_conns, jabci
    try:
        conns = dial(server.listen_addr)
        value, app_hash, info_hash = _drive(conns, R)
        _close(conns)
    finally:
        loop.call_soon_threadsafe(loop.stop)
    assert value == b"v" and app_hash == info_hash == app.app_hash
    # the same drive on a local port kvstore gives the same app hash
    ref = KVStoreApplication()
    ref.init_chain(abci.RequestInitChain(chain_id="t", initial_height=1))
    ref.finalize_block(abci.RequestFinalizeBlock(txs=[b"k=v", b"x=1"], height=1))
    ref.commit()
    assert ref.app_hash == app_hash


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_grpc_interop_with_jax(client_pkg):
    if client_pkg == "port":
        server, client_cls, R = jserver.GRPCServer(JKVStore(), "tcp://127.0.0.1:0"), GRPCClient, abci
    else:
        server, client_cls, R = GRPCServer(KVStoreApplication(), "tcp://127.0.0.1:0"), jclient.GRPCClient, jabci
    server.start()
    try:
        client = client_cls(f"tcp://127.0.0.1:{server.port}")
        assert client.echo("ping") == "ping"
        client.init_chain(R.RequestInitChain(chain_id="t"))
        assert client.check_tx_async(R.RequestCheckTx(tx=b"x=1")).result(5).is_ok()
        fr = client.finalize_block(R.RequestFinalizeBlock(txs=[b"x=1"], height=1))
        client.commit()
        assert client.query(R.RequestQuery(data=b"x", path="/store")).value == b"1"
        assert client.info(R.RequestInfo()).last_block_app_hash == fr.app_hash
        client.close()
    finally:
        server.stop()


def test_build_node_dials_remote_app(tmp_path):
    """``config.base.proxy_app`` routes the node's connections over the
    socket protocol (reference node/setup.go:119
    createAndStartProxyAppConns)."""
    from cometbft_tpu_torch.config.config import test_config as make_test_cfg
    from cometbft_tpu_torch.node.inprocess import build_node
    from cometbft_tpu_torch.privval import FilePV
    from cometbft_tpu_torch.types.genesis import GenesisDoc
    from cometbft_tpu_torch.types.validator_set import Validator

    app = KVStoreApplication()
    server, loop = _run_socket_server(app)
    try:
        pv = FilePV.generate(str(tmp_path / "key.json"), str(tmp_path / "state.json"))
        gen = GenesisDoc(chain_id="remote-app-chain", validators=[Validator(pv.pub_key(), 10)])
        cfg = make_test_cfg(str(tmp_path))
        cfg.base.proxy_app = server.listen_addr
        cfg.base.abci = "socket"
        parts = build_node(gen, config=cfg, home=str(tmp_path), privval=pv, device="cpu")
        assert parts.app is None
        assert isinstance(parts.proxy.consensus, SocketClient)
        info = parts.proxy.query.info(abci.RequestInfo())
        assert info.last_block_height == app.height
        parts.close_stores()
    finally:
        loop.call_soon_threadsafe(loop.stop)


def test_socket_server_reports_app_exception():
    class Boom(KVStoreApplication):
        def info(self, req):
            raise RuntimeError("app exploded")

    server, loop = _run_socket_server(Boom())
    try:
        c = SocketClient(server.listen_addr)
        with pytest.raises(RuntimeError, match="app exploded"):
            c.info(abci.RequestInfo())
        # the connection survives an app's exception
        assert c.echo("still-alive") == "still-alive"
        c.close()
    finally:
        loop.call_soon_threadsafe(loop.stop)


def test_base_config_takes_no_unknown_field():
    """Every section of the port's config refuses a field it lacks:
    ``base`` took any attribute silently until it had slots."""
    from cometbft_tpu_torch.config.config import default_config

    cfg = default_config(".")
    with pytest.raises(AttributeError):
        cfg.base.proxy_app_addr = "tcp://127.0.0.1:26658"
    with pytest.raises(AttributeError):
        cfg.base.unknown = 1
    cfg.base.proxy_app = "tcp://127.0.0.1:26658"
    cfg.base.priv_validator_laddr = "tcp://127.0.0.1:26659"


def test_node_with_proxy_app_runs_no_app_of_its_own():
    """A port Node whose config names an out-of-process app dials it:
    its blocks finalize in the remote app, not in a kvstore it built."""
    from cometbft_tpu_torch.config.config import test_config as make_test_cfg
    from cometbft_tpu_torch.node.inprocess import make_genesis, make_privvals
    from cometbft_tpu_torch.node.node import Node

    app = KVStoreApplication()
    server, loop = _run_socket_server(app)
    try:
        gen, privs = make_genesis(1, chain_id="remote-node")
        cfg = make_test_cfg(".")
        cfg.base.proxy_app = server.listen_addr
        node = Node(cfg, gen, privval=make_privvals(privs)[0], device="cpu")

        async def main():
            await node.start()
            assert node.parts.mempool.check_tx(b"remote=yes").is_ok()
            while node.height < 3 or app.height < 3:
                await asyncio.sleep(0.02)
            await node.stop()

        asyncio.run(asyncio.wait_for(main(), 60))
        assert node.parts.app is None
        assert app.state.get(b"remote") == b"yes"
        assert app.app_hash == node.parts.state_store.load().app_hash
    finally:
        loop.call_soon_threadsafe(loop.stop)
