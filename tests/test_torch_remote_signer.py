"""The remote signer in the port (reference privval/signer_client.go,
retry_signer_client.go, signer_server.go), on the CPU.

- The ports of ``tests/test_remote_signer.py`` (3) and
  ``tests/test_remote_signer_extensions.py`` (1): a vote signed over
  the wire and the double-sign guard firing at the key; a retrying
  client riding out a dropped connection, never retrying a refusal and
  giving up after its bounded retries; a node whose key sits with a
  remote signer producing blocks; the vote extension's signature in
  the same round trip, and an empty extension signed on its own.
- Interop: a port ``SignerClient`` served by a JAX ``SignerServer``,
  and a JAX client served by a port server, sign the same bytes.
"""

import asyncio
import os
import tempfile
import threading
import time

import pytest

from cometbft_tpu import types as JT
from cometbft_tpu.privval import signer as jsigner
from cometbft_tpu.privval.file_pv import FilePV as JFilePV
from cometbft_tpu_torch.config.config import test_config as make_test_cfg
from cometbft_tpu_torch.node.inprocess import make_genesis, make_privvals
from cometbft_tpu_torch.node.node import Node
from cometbft_tpu_torch.privval.file_pv import FilePV
from cometbft_tpu_torch.privval.signer import (
    RemoteSignerError,
    RetrySignerClient,
    SignerClient,
    SignerServer,
)
from cometbft_tpu_torch.types.block import BlockID, PartSetHeader
from cometbft_tpu_torch.types.vote import PRECOMMIT, Vote
from torch_hard_limit import hard_limit  # noqa: F401


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


BID = BlockID(b"\x11" * 32, PartSetHeader(1, b"\x22" * 32))
OTHER = BlockID(b"\x99" * 32, PartSetHeader(1, b"\x22" * 32))


def _vote(pub, height, ts, bid=BID, **kw):
    return Vote(type_=PRECOMMIT, height=height, round=0, block_id=bid, timestamp_ns=ts,
                validator_address=pub.address(), validator_index=0, **kw)


def test_remote_signing_roundtrip_and_double_sign_guard():
    async def main():
        _, privs = make_genesis(1, chain_id="rs-chain")
        signer_pv = make_privvals(privs)[0]
        client = SignerClient("127.0.0.1:0")
        server = SignerServer(signer_pv, client.listen_addr)
        task = asyncio.create_task(server.serve())
        await asyncio.sleep(0.2)
        pub = await asyncio.to_thread(client.pub_key)
        assert bytes(pub) == bytes(signer_pv.pub_key())
        vote = _vote(pub, 5, 123)
        await asyncio.to_thread(client.sign_vote, "rs-chain", vote)
        assert pub.verify(vote.sign_bytes("rs-chain"), vote.signature)
        # the double-sign guard fires at the key, remotely
        with pytest.raises(RemoteSignerError):
            await asyncio.to_thread(client.sign_vote, "rs-chain", _vote(pub, 5, 124, OTHER))
        server.stop()
        task.cancel()
        client.close()

    run(main())


def test_retry_signer_survives_connection_drop():
    """The signer's connection drops mid-session; the redialing server
    reconnects and the retrying client lands the vote. A refusal is not
    retried; with the signer gone the retries are bounded."""

    async def main():
        _, privs = make_genesis(1, chain_id="retry-chain")
        pv = make_privvals(privs)[0]
        raw = SignerClient("127.0.0.1:0", timeout_s=1.0)
        client = RetrySignerClient(raw, retries=10, interval_s=0.1)
        server = SignerServer(pv, raw.listen_addr)
        task = asyncio.create_task(server.serve_forever(0.1))
        await asyncio.sleep(0.2)
        pub = await asyncio.to_thread(client.pub_key)
        assert bytes(pub) == bytes(pv.pub_key())

        raw._sconn.close()
        vote = _vote(pub, 7, 321)
        await asyncio.to_thread(client.sign_vote, "retry-chain", vote)
        assert pub.verify(vote.sign_bytes("retry-chain"), vote.signature)

        t0 = time.monotonic()
        with pytest.raises(RemoteSignerError):
            await asyncio.to_thread(client.sign_vote, "retry-chain", _vote(pub, 7, 322, OTHER))
        assert time.monotonic() - t0 < 0.5  # no retry sleeps spent

        server.stop()
        task.cancel()
        raw._sconn.close()
        client.retries = 2
        raw.timeout_s = 0.3
        with pytest.raises(RemoteSignerError, match="retries"):
            await asyncio.to_thread(client.sign_vote, "retry-chain", _vote(pub, 8, 400))
        client.close()

    run(main())


def test_node_with_remote_signer_produces_blocks():
    """The signer runs on its own thread and loop, as a separate signer
    process would: consensus signs from a worker thread."""

    async def main():
        gen, privs = make_genesis(1, chain_id="rsn-chain")
        pv = make_privvals(privs)[0]
        client = SignerClient("127.0.0.1:0")
        server = SignerServer(pv, client.listen_addr)
        threading.Thread(target=lambda: asyncio.run(server.serve()), daemon=True).start()
        await asyncio.sleep(0.3)
        node = Node(make_test_cfg("."), gen, privval=client, device="cpu")
        await node.start()
        while node.height < 3:
            await asyncio.sleep(0.05)
        await node.stop()
        server.stop()
        client.close()
        # the key's own state moved with the signing
        assert pv.last.height >= 3

    run(main())


def test_extension_signed_over_the_wire():
    async def main():
        _, privs = make_genesis(1, chain_id="rsx-chain")
        client = SignerClient("127.0.0.1:0")
        server = SignerServer(make_privvals(privs)[0], client.listen_addr)
        task = asyncio.create_task(server.serve())
        await asyncio.sleep(0.2)
        try:
            pub = await asyncio.to_thread(client.pub_key)
            vote = _vote(pub, 7, 123, extension=b"ext|7|payload")
            await asyncio.to_thread(client.sign_vote, "rsx-chain", vote)
            # both signatures in one round trip
            assert pub.verify(vote.sign_bytes("rsx-chain"), vote.signature)
            assert vote.extension_signature
            assert pub.verify(vote.extension_sign_bytes("rsx-chain"), vote.extension_signature)
            before = vote.extension_signature
            await asyncio.to_thread(client.sign_vote_extension, "rsx-chain", vote)
            assert vote.extension_signature == before
            # an empty extension is signed too, in its own round trip
            vote2 = _vote(pub, 8, 124)
            await asyncio.to_thread(client.sign_vote, "rsx-chain", vote2)
            assert not vote2.extension_signature
            await asyncio.to_thread(client.sign_vote_extension, "rsx-chain", vote2)
            assert pub.verify(vote2.extension_sign_bytes("rsx-chain"), vote2.extension_signature)
        finally:
            server.stop()
            task.cancel()

    run(main())


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_signer_interop_with_jax(client_pkg):
    """One key, two packages: the client of one and the server of the
    other complete the handshake and sign; the signatures equal the
    other pairing's on the same votes, and the guard refuses at the key
    either way."""
    _, privs = make_genesis(1, chain_id="rsi-chain")
    d = tempfile.mkdtemp(prefix="rsi_")
    if client_pkg == "port":
        pv = JFilePV(privs[0], os.path.join(d, "k.json"), os.path.join(d, "s.json"))
        client, server_cls = SignerClient("127.0.0.1:0"), jsigner.SignerServer
        vote_of = lambda pub, h, ts, bid=BID: _vote(pub, h, ts, bid, extension=b"x")  # noqa: E731
        refused = RemoteSignerError
    else:
        pv = FilePV(privs[0], os.path.join(d, "k.json"), os.path.join(d, "s.json"))
        client, server_cls = jsigner.SignerClient("127.0.0.1:0"), SignerServer

        def vote_of(pub, h, ts, bid=BID):
            jbid = JT.BlockID(bid.hash, JT.PartSetHeader(bid.part_set_header.total, bid.part_set_header.hash))
            return JT.Vote(type_=JT.PRECOMMIT, height=h, round=0, block_id=jbid, timestamp_ns=ts,
                           validator_address=pub.address(), validator_index=0, extension=b"x")

        refused = jsigner.RemoteSignerError
    pv.save_key()
    pv.save_state()
    server = server_cls(pv, client.listen_addr)

    async def main():
        task = asyncio.create_task(server.serve())
        await asyncio.sleep(0.2)
        pub = await asyncio.to_thread(client.pub_key)
        vote = vote_of(pub, 3, 1000)
        await asyncio.to_thread(client.sign_vote, "rsi-chain", vote)
        with pytest.raises(refused):
            await asyncio.to_thread(client.sign_vote, "rsi-chain", vote_of(pub, 3, 1001, OTHER))
        server.stop()
        task.cancel()
        client.close()
        return pub, vote

    pub, vote = run(main())
    assert bytes(pub) == bytes(privs[0].pub_key())
    assert pub.verify(vote.sign_bytes("rsi-chain"), vote.signature)
    assert pub.verify(vote.extension_sign_bytes("rsi-chain"), vote.extension_signature)
    # ed25519 is deterministic: the key signs these bytes to this signature
    assert vote.signature == privs[0].sign(vote.sign_bytes("rsi-chain"))
