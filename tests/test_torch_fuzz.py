"""Property tests and connection fuzzing of the port, held to the JAX
package: every case of ``tests/test_fuzz.py`` (10), of
``tests/test_fuzz_conn.py`` (7) and the four ``FuzzedConnection`` cases
of ``tests/test_aux_tools.py``.

- The property cases feed the same generated bytes to both packages'
  parsers and decoders (the mempool's CheckTx, the proto reader, the
  ABCI codec, the block/vote/header/commit/validator-set decoders, the
  merkle proof ops, the native and pure commit decoders, the pubsub
  query language, the commit round trip) and require the same outcome:
  the same refusal class, or equal decoded values. A secret-connection
  handshake against garbage fails cleanly in both, inside its limit.
- ``p2p/fuzz.py``: a seed gives the same drop, delay and kill decisions
  in the port as in the JAX package (``dropped_writes`` /
  ``dropped_reads`` equal), an injected stream overrides the config's
  seed, a disabled config is a passthrough, and ``Node``'s TCP
  transport wraps its connections by the config's ``[fuzz]`` section.
"""

import asyncio
import random
import socket
import struct

import pytest

pytest.importorskip("hypothesis")

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from cometbft_tpu import types as JT  # noqa: E402
from cometbft_tpu.abci import codec as jabci_codec  # noqa: E402
from cometbft_tpu.abci.client import AppConns as JAppConns  # noqa: E402
from cometbft_tpu.crypto import merkle as jmerkle  # noqa: E402
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv  # noqa: E402
from cometbft_tpu.mempool.mempool import CListMempool as JCListMempool  # noqa: E402
from cometbft_tpu.models.kvstore import KVStoreApplication as JKV  # noqa: E402
from cometbft_tpu.p2p import fuzz as jfuzz  # noqa: E402
from cometbft_tpu.p2p.conn.secret_connection import SecretConnection as JSecretConnection  # noqa: E402
from cometbft_tpu.utils import codec as jcodec  # noqa: E402
from cometbft_tpu.utils import proto as jproto  # noqa: E402
from cometbft_tpu.utils import pubsub_query as jquery  # noqa: E402
from cometbft_tpu_torch.abci import codec as abci_codec  # noqa: E402
from cometbft_tpu_torch.abci.client import AppConns  # noqa: E402
from cometbft_tpu_torch.crypto import merkle  # noqa: E402
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey  # noqa: E402
from cometbft_tpu_torch.mempool.mempool import CListMempool  # noqa: E402
from cometbft_tpu_torch.models.kvstore import KVStoreApplication  # noqa: E402
from cometbft_tpu_torch.p2p import fuzz  # noqa: E402
from cometbft_tpu_torch.p2p.conn.secret_connection import SecretConnection  # noqa: E402
from cometbft_tpu_torch.types import block as B  # noqa: E402
from cometbft_tpu_torch.utils import codec, proto, pubsub_query, wirecodec  # noqa: E402
from torch_hard_limit import hard_limit  # noqa: F401,E402

FAST = settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
DECODE_ERRORS = (ValueError, KeyError, IndexError, OverflowError, UnicodeDecodeError, struct.error)


def outcome(fn, *args, errors=DECODE_ERRORS):
    """("ok", repr of the value) or ("refused",): dataclass reprs name
    the class and fields, not the package, so the two compare."""
    try:
        return ("ok", repr(fn(*args)))
    except errors:
        return ("refused",)


# --- mempool CheckTx on arbitrary bytes (test/fuzz/tests mempool) -------


@settings(parent=FAST)
@given(tx=st.binary(min_size=0, max_size=512))
def test_fuzz_mempool_checktx(tx):
    mp = CListMempool(AppConns.local(KVStoreApplication()).mempool)
    jmp = JCListMempool(JAppConns.local(JKV()).mempool)
    # must never raise, whatever the bytes, and reap the same
    mp.check_tx(tx)
    jmp.check_tx(tx)
    reaped = mp.reap_max_bytes_max_gas(1 << 20, -1)
    assert all(t == tx for t in reaped)
    assert reaped == jmp.reap_max_bytes_max_gas(1 << 20, -1)


# --- proto parser on arbitrary bytes ------------------------------------


@settings(parent=FAST)
@given(raw=st.binary(min_size=0, max_size=256))
def test_fuzz_proto_parse_never_crashes_unexpectedly(raw):
    # malformed input must raise ValueError, nothing else
    got = outcome(proto.parse, raw, errors=ValueError)
    assert got == outcome(jproto.parse, raw, errors=ValueError)


@settings(parent=FAST)
@given(raw=st.binary(min_size=0, max_size=512))
def test_fuzz_abci_codec_decode(raw):
    errors = (ValueError, RuntimeError, UnicodeDecodeError)
    for ours, theirs in ((abci_codec.decode_request, jabci_codec.decode_request),
                         (abci_codec.decode_response, jabci_codec.decode_response)):
        assert outcome(ours, raw, errors=errors)[0] == outcome(theirs, raw, errors=errors)[0]


# --- block/vote codec round-trips --------------------------------------


@settings(parent=FAST)
@given(raw=st.binary(min_size=0, max_size=512))
def test_fuzz_block_decode(raw):
    for name in ("decode_block", "decode_vote", "decode_header", "decode_commit", "decode_validator_set"):
        got = outcome(getattr(codec, name), raw)
        want = outcome(getattr(jcodec, name), raw)
        assert got[0] == want[0], (name, raw)


# --- merkle proof ops (peer-supplied light-client proofs) ---------------


@settings(parent=FAST)
@given(raw=st.binary(min_size=0, max_size=512))
def test_fuzz_proof_ops_decode_and_verify(raw):
    """Adversarial proof-op bytes reach the light proxy from the
    primary: decode and both verify paths must raise ProofError /
    ValueError, never crash with anything else, in both packages."""
    results = []
    for m in (merkle, jmerkle):
        rt = m.ProofRuntime()
        try:
            ops = m.decode_proof_ops(raw)
        except (ValueError, KeyError, UnicodeDecodeError):
            results.append("undecodable")
            continue
        verdicts = []
        for fn in (lambda: rt.verify_value(ops, b"\x00" * 32, b"key", b"val"),
                   lambda: rt.verify_absence(ops, b"\x00" * 32, b"key")):
            try:
                fn()
                verdicts.append("ok")
            except (m.ProofError, ValueError, OverflowError):
                verdicts.append("refused")
        results.append(tuple(verdicts))
    assert results[0] == results[1]


def _commit_values(c):
    """A decoded commit as plain values (the JAX BlockID's repr is its
    own short form)."""
    bid = c.block_id
    return (c.height, c.round, bid.hash, bid.part_set_header.total, bid.part_set_header.hash,
            [(s.block_id_flag, s.validator_address, s.timestamp_ns, s.signature) for s in c.signatures])


def _decode_commit(decode, raw):
    try:
        return ("ok", _commit_values(decode(raw)))
    except (ValueError, OverflowError, struct.error):
        return ("refused",)


def _native_and_pure(raw):
    """(native-first outcome, pure outcome) of the port's decode_commit."""
    got = _decode_commit(codec.decode_commit, raw)
    wirecodec.LANE.force_portable()
    try:
        want = _decode_commit(codec.decode_commit, raw)
    finally:
        wirecodec.LANE.restore()
    return got, want


@settings(parent=FAST)
@given(raw=st.binary(min_size=0, max_size=512))
def test_fuzz_native_commit_decode_agrees_with_python(raw):
    """The native decoder and the pure-Python reader agree on every
    input (same decoded values or both refuse), and so does the JAX
    package's decoder."""
    if wirecodec.LANE.wait() is None:
        pytest.skip(f"native wire codec unavailable: {wirecodec.LANE.reason}")
    got, want = _native_and_pure(raw)
    assert got == want == _decode_commit(jcodec.decode_commit, raw), raw


@settings(parent=FAST)
@given(
    n_sigs=st.integers(0, 8),
    flips=st.lists(st.tuples(st.integers(0, 4095), st.integers(0, 255)), max_size=3),
    seed=st.integers(0, 2**32 - 1),
)
def test_fuzz_mutated_commit_native_python_agree(n_sigs, flips, seed):
    """Near-valid inputs (a real commit encoding with a few byte flips)
    probe the decoders' agreement far deeper than raw noise."""
    if wirecodec.LANE.wait() is None:
        pytest.skip(f"native wire codec unavailable: {wirecodec.LANE.reason}")
    rng = random.Random(seed)
    sigs = [
        B.CommitSig(block_id_flag=rng.choice([1, 2, 3]), validator_address=bytes(rng.randbytes(20)),
                    timestamp_ns=rng.randrange(0, 2**62), signature=bytes(rng.randbytes(64)))
        for _ in range(n_sigs)
    ]
    c = B.Commit(height=rng.randrange(1, 2**40), round=rng.randrange(0, 4),
                 block_id=B.BlockID(bytes(rng.randbytes(32)), B.PartSetHeader(1, bytes(rng.randbytes(32)))),
                 signatures=sigs)
    raw = bytearray(codec.encode_commit(c))
    for pos, val in flips:
        if raw:
            raw[pos % len(raw)] ^= val
    raw = bytes(raw)
    got, want = _native_and_pure(raw)
    assert got == want == _decode_commit(jcodec.decode_commit, raw), raw


# --- SecretConnection vs garbage frames ---------------------------------


def test_fuzz_secret_connection_garbage():
    """A handshake against a peer that speaks garbage fails cleanly in
    both packages, never hangs or crashes the process (reference
    test/fuzz p2p/secretconn)."""

    async def go(handshake, priv, payload: bytes):
        a, b = socket.socketpair()
        a.setblocking(False)
        b.setblocking(False)
        reader, writer = await asyncio.open_connection(sock=a)

        async def attacker():
            _, wb = await asyncio.open_connection(sock=b)
            wb.write(payload)
            try:
                await wb.drain()
                await asyncio.sleep(0.05)
            finally:
                wb.close()

        atk = asyncio.create_task(attacker())
        try:
            await asyncio.wait_for(handshake(reader, writer, priv), timeout=2.0)
            return "handshake completed"
        except asyncio.TimeoutError:
            return "hung"
        except Exception:
            return "refused"  # any clean exception is fine
        finally:
            await atk
            writer.close()

    rng = random.Random(1234)
    for _ in range(10):
        payload = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 200)))
        ours = asyncio.run(go(SecretConnection.handshake, Ed25519PrivKey.generate(), payload))
        theirs = asyncio.run(go(JSecretConnection.handshake, JPriv.generate(), payload))
        assert ours == theirs == "refused", payload


# --- pubsub query language ----------------------------------------------


@settings(parent=FAST)
@given(s=st.text(max_size=80))
def test_fuzz_pubsub_query_parse(s):
    got = outcome(pubsub_query.parse, s, errors=(ValueError, KeyError))
    want = outcome(jquery.parse, s, errors=(ValueError, KeyError))
    assert got[0] == want[0], s


# --- commit codec round-trip property (fast-path decoder) ---------------


@settings(parent=FAST)
@given(data=st.data())
def test_fuzz_commit_roundtrip(data):
    """decode(encode(c)) == c for generated commits, and the encoding is
    the JAX package's byte for byte."""
    sigs = []
    for _ in range(data.draw(st.integers(min_value=0, max_value=8))):
        sigs.append((data.draw(st.sampled_from([1, 2, 3])), data.draw(st.binary(min_size=0, max_size=20)),
                     data.draw(st.integers(min_value=0, max_value=2**62)),
                     data.draw(st.binary(min_size=0, max_size=64))))
    bid = (data.draw(st.binary(min_size=0, max_size=32)), data.draw(st.integers(min_value=0, max_value=1 << 20)),
           data.draw(st.binary(min_size=0, max_size=32)))
    height = data.draw(st.integers(min_value=0, max_value=2**62))
    round_ = data.draw(st.integers(min_value=0, max_value=1 << 20))

    def commit(M):
        return M.Commit(height=height, round=round_,
                        block_id=M.BlockID(bid[0], M.PartSetHeader(bid[1], bid[2])),
                        signatures=[M.CommitSig(block_id_flag=f, validator_address=a, timestamp_ns=t,
                                                signature=s) for f, a, t, s in sigs])

    c = commit(B)
    enc = codec.encode_commit(c)
    assert codec.decode_commit(enc) == c
    assert enc == jcodec.encode_commit(commit(JT))


# --- FuzzedConnection determinism + teardown (test_fuzz_conn.py) -------

PKGS = {"port": fuzz, "jax": jfuzz}


class FakeSconn:
    def __init__(self, chunks=()):
        self.writes = []
        self.chunks = list(chunks)
        self.closed = False

    async def write_msg(self, data):
        self.writes.append(bytes(data))
        return len(data)

    async def read_chunk(self):
        if not self.chunks:
            raise ConnectionError("out of chunks")
        return self.chunks.pop(0)

    def close(self):
        self.closed = True


def run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _drive_writes(F, cfg, n=200, rng=None):
    async def main():
        inner = FakeSconn()
        fc = F.FuzzedConnection(inner, cfg, rng=rng)
        delivered = []
        for i in range(n):
            await fc.write_msg(bytes([i & 0xFF]))
            delivered.append(len(inner.writes))
        return delivered, fc.dropped_writes

    return run(main())


def both(case):
    got = {name: case(F) for name, F in PKGS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def test_same_seed_identical_drop_decisions():
    def case(F):
        runs = [_drive_writes(F, F.FuzzConnConfig(enable=True, prob_drop_rw=0.4, seed=9)) for _ in range(2)]
        assert runs[0] == runs[1]
        delivered, dropped = runs[0]
        assert dropped > 0 and delivered[-1] + dropped == 200
        # a different seed must (overwhelmingly) diverge
        assert _drive_writes(F, F.FuzzConnConfig(enable=True, prob_drop_rw=0.4, seed=10)) != runs[0]
        return runs[0]

    both(case)


def test_same_seed_identical_read_decisions():
    def case(F):
        async def drive():
            inner = FakeSconn(chunks=[bytes([i]) for i in range(100)])
            fc = F.FuzzedConnection(inner, F.FuzzConnConfig(enable=True, prob_drop_rw=0.3, seed=4))
            got = []
            try:
                while True:
                    got.append(await fc.read_chunk())
            except ConnectionError:
                pass  # out of chunks
            return got, fc.dropped_reads

        a, b = run(drive()), run(drive())
        assert a == b
        got, dropped = a
        assert dropped > 0 and len(got) + dropped == 100
        return a

    both(case)


def test_delay_mode_draws_deterministic():
    def case(F):
        async def drive():
            cfg = F.FuzzConnConfig(enable=True, mode=F.MODE_DELAY, prob_sleep=0.5, max_delay_ms=100, seed=21)
            inner = FakeSconn()
            fc = F.FuzzedConnection(inner, cfg)
            sleeps = []
            real_sleep = asyncio.sleep

            async def spy(d):
                sleeps.append(round(d, 9))
                await real_sleep(0)

            asyncio.sleep = spy
            try:
                for _ in range(100):
                    await fc.write_msg(b"x")
            finally:
                asyncio.sleep = real_sleep
            assert len(inner.writes) == 100  # delay mode never drops
            return sleeps

        a, b = run(drive()), run(drive())
        assert a == b and a
        assert all(0 <= d <= 0.1 for d in a)
        return a

    both(case)


def test_prob_drop_conn_tears_connection_down():
    def case(F):
        async def main():
            inner = FakeSconn(chunks=[b"x"])
            fc = F.FuzzedConnection(inner, F.FuzzConnConfig(enable=True, prob_drop_conn=1.0, seed=1))
            with pytest.raises(ConnectionError):
                await fc.write_msg(b"dead")
            # the underlying connection was CLOSED, not just refused
            assert inner.closed
            assert not inner.writes
            # and the connection stays dead for every later op
            with pytest.raises(ConnectionError):
                await fc.read_chunk()
            with pytest.raises(ConnectionError):
                await fc.write_msg(b"still dead")
            return inner.closed, inner.writes

        return run(main())

    both(case)


def test_drop_conn_probability_is_seed_deterministic():
    def case(F):
        async def drive():
            cfg = F.FuzzConnConfig(enable=True, prob_drop_conn=0.02, prob_drop_rw=0.1, seed=77)
            fc = F.FuzzedConnection(FakeSconn(), cfg)
            for i in range(1000):
                try:
                    await fc.write_msg(b"y")
                except ConnectionError:
                    return i  # the op index the connection died at
            return None

        first = run(drive())
        assert first == run(drive()) is not None
        return first

    both(case)


def test_injected_rng_overrides_config_seed():
    """An injected stream (the JAX chaos link plane's composition hook)
    makes the config seed irrelevant."""

    def case(F):
        a = _drive_writes(F, F.FuzzConnConfig(enable=True, prob_drop_rw=0.4, seed=1), rng=random.Random(123))
        b = _drive_writes(F, F.FuzzConnConfig(enable=True, prob_drop_rw=0.4, seed=2), rng=random.Random(123))
        assert a == b
        return a

    both(case)


def test_maybe_fuzz_passthrough():
    def case(F):
        inner = FakeSconn()
        assert F.maybe_fuzz(inner, None) is inner
        assert F.maybe_fuzz(inner, F.FuzzConnConfig(enable=False)) is inner
        assert isinstance(F.maybe_fuzz(inner, F.FuzzConnConfig(enable=True)), F.FuzzedConnection)
        return True

    both(case)


# --- FuzzedConnection cases of test_aux_tools.py ------------------------


class _FakeSconn(FakeSconn):
    @property
    def written(self):
        return self.writes


def test_fuzz_passthrough_when_disabled():
    def case(F):
        sconn = _FakeSconn()
        assert F.maybe_fuzz(sconn, None) is sconn
        assert F.maybe_fuzz(sconn, F.FuzzConnConfig(enable=False)) is sconn
        return True

    both(case)


def test_fuzz_drop_mode_drops_writes():
    def case(F):
        sconn = _FakeSconn()
        fz = F.FuzzedConnection(sconn, F.FuzzConnConfig(enable=True, mode="drop", prob_drop_rw=0.5, seed=7))

        async def go():
            for _ in range(200):
                await fz.write_msg(b"x")

        asyncio.run(go())
        # with p=0.5 over 200 writes, both dropped and delivered are certain
        assert fz.dropped_writes > 20
        assert len(sconn.written) > 20
        assert fz.dropped_writes + len(sconn.written) == 200
        return fz.dropped_writes

    both(case)


def test_fuzz_drop_conn_kills():
    def case(F):
        sconn = _FakeSconn()
        fz = F.FuzzedConnection(sconn, F.FuzzConnConfig(enable=True, mode="drop", prob_drop_rw=0.0,
                                                        prob_drop_conn=1.0))
        with pytest.raises(ConnectionError):
            asyncio.run(fz.write_msg(b"x"))
        assert sconn.closed
        return sconn.closed

    both(case)


def test_fuzz_delay_mode_preserves_traffic():
    def case(F):
        sconn = _FakeSconn(chunks=[b"a", b"b"])
        fz = F.FuzzedConnection(sconn, F.FuzzConnConfig(enable=True, mode="delay", prob_sleep=1.0, max_delay_ms=1))

        async def go():
            await fz.write_msg(b"msg")
            return await fz.read_chunk(), await fz.read_chunk()

        a, b = asyncio.run(go())
        assert (a, b) == (b"a", b"b")
        assert sconn.written == [b"msg"]
        return a, b, sconn.written

    both(case)


# --- the node's transport takes [fuzz] ----------------------------------


def test_node_transport_fuzzes_by_config():
    """``Node`` hands its TCP transport the config's ``[fuzz]`` section,
    as the JAX node does: two nodes whose links are fuzzed in delay
    mode connect and both ends' connections are ``FuzzedConnection``s
    (a disabled section leaves them plain)."""
    from cometbft_tpu_torch.config.config import test_config as make_test_cfg
    from cometbft_tpu_torch.node.inprocess import make_genesis
    from cometbft_tpu_torch.node.node import Node

    gen, _ = make_genesis(2, chain_id="fuzz-net")

    def cfg(enable):
        c = make_test_cfg(".")
        c.blocksync.enable = False
        c.fuzz.enable = enable
        c.fuzz.mode = fuzz.MODE_DELAY
        c.fuzz.prob_sleep = 0.2
        c.fuzz.max_delay_ms = 5
        c.fuzz.seed = 3
        return c

    async def main():
        a, b = Node(cfg(True), gen, device="cpu"), Node(cfg(False), gen, device="cpu")
        assert a.transport.fuzz_config is a.config.fuzz
        await a.start()
        await b.start()
        try:
            await b.dial(a.listen_addr)
            deadline = asyncio.get_running_loop().time() + 20
            while not (a.switch.peers and b.switch.peers):
                assert asyncio.get_running_loop().time() < deadline, "no connection"
                await asyncio.sleep(0.05)
            kinds = {n: [type(p.mconn.sconn).__name__
                         for p in node.switch.peers.values()] for n, node in (("a", a), ("b", b))}
            return kinds
        finally:
            await b.stop()
            await a.stop()

    kinds = asyncio.run(asyncio.wait_for(main(), 120))
    assert kinds == {"a": ["FuzzedConnection"], "b": ["SecretConnection"]}, kinds
