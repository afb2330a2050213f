"""Remote signer protocol (reference privval/signer_client.go:18,
privval/signer_listener_endpoint.go, privval/signer_server.go,
privval/msgs.go).

A copy of the JAX package's ``privval/signer.py``. The validator node
listens on ``priv_validator_laddr``; the signer, which holds the key,
dials in and serves signing requests over the secret connection p2p
uses (``p2p/conn/secret_connection.py``, on the same X25519 and AEAD
tiers). ``SignerClient`` is the node's PrivValidator: each call is one
request and response with a deadline, run on the client's own event
loop in its own thread, so consensus, which signs from a worker thread
(``REMOTE_BLOCKING``), never blocks its loop on the socket.
``RetrySignerClient`` retries a transient failure and never a refusal;
``SignerServer`` serves a ``FilePV``, whose state guards against a
double sign, as in the reference. The client's sign lock is the
runtime sanitizer's ``privval.sign`` (``analysis.runtime.sanitized_lock``:
the raw lock when the sanitizer is off).
"""

from __future__ import annotations

import asyncio
import struct
import threading
import traceback
from typing import Optional

from ..analysis.runtime import sanitized_lock
from ..crypto.keys import Ed25519PrivKey, Ed25519PubKey
from ..p2p.conn.secret_connection import SecretConnection
from ..types.vote import Proposal, Vote
from ..utils import codec

MSG_PUBKEY_REQUEST = 0x01
MSG_PUBKEY_RESPONSE = 0x02
MSG_SIGN_VOTE_REQUEST = 0x03
MSG_SIGNED_VOTE_RESPONSE = 0x04
MSG_SIGN_PROPOSAL_REQUEST = 0x05
MSG_SIGNED_PROPOSAL_RESPONSE = 0x06
MSG_PING_REQUEST = 0x07
MSG_PING_RESPONSE = 0x08
MSG_SIGN_VOTE_EXT_REQUEST = 0x09
MSG_SIGNED_VOTE_EXT_RESPONSE = 0x0A
MSG_ERROR_RESPONSE = 0x7F


class RemoteSignerError(Exception):
    """Definitive signer-side refusal (e.g. the double-sign guard) or
    exhausted retries — never retried."""


class SignerUnavailableError(ConnectionError):
    """No signer currently connected — transient: the signer redials
    (serve_forever) and RetrySignerClient retries through it."""


async def _send(sconn: SecretConnection, mtype: int, payload: bytes = b""):
    await sconn.write_msg(
        struct.pack(">BI", mtype, len(payload)) + payload
    )


async def _recv(sconn: SecretConnection):
    buf = await sconn.read_chunk()
    mtype, ln = struct.unpack(">BI", buf[:5])
    body = buf[5:]
    while len(body) < ln:
        body += await sconn.read_chunk()
    return mtype, body[:ln]


def _strip_scheme(addr: str) -> str:
    for pfx in ("tcp://", "unix://"):
        if addr.startswith(pfx):
            return addr[len(pfx):]
    return addr


class SignerClient:
    """Node-side PrivValidator backed by a remote signer (reference
    privval/signer_client.go). Listens for the signer to dial in."""

    # consensus offloads our (socket-blocking) sign calls to a worker
    # thread instead of blocking its event loop
    REMOTE_BLOCKING = True

    def __init__(self, laddr: str, node_priv: Optional[Ed25519PrivKey] = None,
                 timeout_s: float = 5.0):
        # node_priv authenticates the NODE end of the secret conn
        # (a throwaway key is fine; the signer's identity is what
        # matters operationally)
        self._auth_priv = node_priv or Ed25519PrivKey.generate()
        self.timeout_s = timeout_s
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, daemon=True
        )
        self._thread.start()
        self._sconn: Optional[SecretConnection] = None
        self._connected = threading.Event()
        self._lock = sanitized_lock(threading.Lock(), "privval.sign")
        self.listen_addr = ""
        fut = asyncio.run_coroutine_threadsafe(
            self._listen(laddr), self._loop
        )
        fut.result(10.0)
        self._pubkey: Optional[Ed25519PubKey] = None

    async def _listen(self, laddr: str) -> None:
        host, _, port = _strip_scheme(laddr).rpartition(":")

        async def on_accept(reader, writer):
            try:
                sconn = await SecretConnection.handshake(
                    reader, writer, self._auth_priv
                )
            except asyncio.CancelledError:
                writer.close()
                raise
            except (OSError, ValueError, asyncio.IncompleteReadError):
                # failed auth / torn conn: drop it, keep listening
                writer.close()
                return
            self._sconn = sconn
            self._connected.set()

        self._server = await asyncio.start_server(
            on_accept, host or "127.0.0.1", int(port)
        )
        h, p = self._server.sockets[0].getsockname()[:2]
        self.listen_addr = f"{h}:{p}"

    def wait_for_signer(self, timeout_s: float = 30.0) -> None:
        if not self._connected.wait(timeout_s):
            raise SignerUnavailableError("no remote signer connected")

    # --- request/response ------------------------------------------------

    def _call(self, mtype: int, payload: bytes = b""):
        import concurrent.futures

        self.wait_for_signer(self.timeout_s)
        with self._lock:
            fut = asyncio.run_coroutine_threadsafe(
                self._roundtrip(mtype, payload), self._loop
            )
            try:
                return fut.result(self.timeout_s)
            except RemoteSignerError:
                raise  # clean protocol response; stream still in sync
            except concurrent.futures.TimeoutError:
                # the orphaned round trip may still complete later and
                # leave a stale response in the stream: every request
                # after that would read the WRONG response. Drop the
                # connection so the signer redials and both ends
                # resync (the reference drops on timeout too).
                self._drop_conn()
                raise
            except Exception:
                # transport-level failure: the stream state is unknown
                self._drop_conn()
                raise

    def _drop_conn(self) -> None:
        sconn, self._sconn = self._sconn, None
        self._connected.clear()
        if sconn is not None:
            self._loop.call_soon_threadsafe(sconn.close)

    async def _roundtrip(self, mtype: int, payload: bytes):
        sconn = self._sconn
        if sconn is None:
            raise ConnectionError("remote signer disconnected")
        await _send(sconn, mtype, payload)
        rtype, body = await _recv(sconn)
        if rtype == MSG_ERROR_RESPONSE:
            raise RemoteSignerError(body.decode() or "remote signer error")
        return rtype, body

    # --- PrivValidator interface ----------------------------------------

    def pub_key(self) -> Ed25519PubKey:
        if self._pubkey is None:
            rtype, body = self._call(MSG_PUBKEY_REQUEST)
            if rtype != MSG_PUBKEY_RESPONSE or len(body) != 32:
                raise RemoteSignerError("bad pubkey response")
            self._pubkey = Ed25519PubKey(body)
        return self._pubkey

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        payload = (
            struct.pack(">H", len(chain_id))
            + chain_id.encode()
            + codec.encode_vote(vote)
        )
        rtype, body = self._call(MSG_SIGN_VOTE_REQUEST, payload)
        if rtype != MSG_SIGNED_VOTE_RESPONSE:
            raise RemoteSignerError("bad sign-vote response")
        signed = codec.decode_vote(body)
        vote.signature = signed.signature
        vote.timestamp_ns = signed.timestamp_ns
        # the server extension-signs in the same round trip whenever
        # the request vote carries an extension
        vote.extension_signature = signed.extension_signature

    def sign_vote_extension(self, chain_id: str, vote: Vote) -> None:
        """Dedicated round trip: the server extension-signs even an
        EMPTY extension (matching FilePV — peers at extension-enabled
        heights require the signature regardless of payload). The
        fast path: a non-empty extension was already co-signed during
        SIGN_VOTE."""
        if vote.extension_signature:
            return
        payload = (
            struct.pack(">H", len(chain_id))
            + chain_id.encode()
            + codec.encode_vote(vote)
        )
        rtype, body = self._call(MSG_SIGN_VOTE_EXT_REQUEST, payload)
        if rtype != MSG_SIGNED_VOTE_EXT_RESPONSE:
            raise RemoteSignerError("bad sign-vote-extension response")
        vote.extension_signature = body
        if not vote.extension_signature:
            raise RemoteSignerError(
                "signer did not produce an extension signature"
            )

    def sign_proposal(self, chain_id: str, prop: Proposal) -> None:
        payload = (
            struct.pack(">H", len(chain_id))
            + chain_id.encode()
            + codec.encode_proposal(prop)
        )
        rtype, body = self._call(MSG_SIGN_PROPOSAL_REQUEST, payload)
        if rtype != MSG_SIGNED_PROPOSAL_RESPONSE:
            raise RemoteSignerError("bad sign-proposal response")
        signed = codec.decode_proposal(body)
        prop.signature = signed.signature
        prop.timestamp_ns = signed.timestamp_ns

    def close(self) -> None:
        def _shut():
            if self._sconn:
                self._sconn.close()
            self._server.close()

        self._loop.call_soon_threadsafe(_shut)
        self._loop.call_soon_threadsafe(self._loop.stop)


class RetrySignerClient:
    """Retrying PrivValidator wrapper around SignerClient (reference
    privval/retry_signer_client.go): a transient signer hiccup — a
    dropped connection, a slow redial, a request timeout — must cost a
    bounded delay, not a missed vote or proposal.

    retries=0 retries forever (the reference's semantics for 0).
    DEFINITIVE signer refusals (the signer answered with an error
    payload, e.g. the double-sign guard) are NOT retried: re-asking an
    HSM to double-sign is never correct and only delays the round —
    the one deliberate deviation from the reference, which retries
    every error class."""

    REMOTE_BLOCKING = True

    def __init__(
        self,
        client: SignerClient,
        retries: int = 5,
        interval_s: float = 0.2,
    ):
        self.client = client
        self.retries = retries
        self.interval_s = interval_s

    def _retry(self, what: str, fn, *args):
        import concurrent.futures
        import time as _t

        n = 0
        last: Optional[Exception] = None
        while self.retries == 0 or n < self.retries:
            try:
                return fn(*args)
            except RemoteSignerError:
                raise  # definitive refusal (e.g. double-sign guard)
            except (
                concurrent.futures.TimeoutError,
                TimeoutError,
                ConnectionError,
                OSError,
                asyncio.IncompleteReadError,
            ) as e:
                last = e
            n += 1
            _t.sleep(self.interval_s)
        raise RemoteSignerError(
            f"{what}: exhausted {self.retries} retries "
            f"(last: {last!r})"
        )

    # --- PrivValidator interface (all retried) -------------------------

    def pub_key(self) -> Ed25519PubKey:
        return self._retry("pub_key", self.client.pub_key)

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        self._retry("sign_vote", self.client.sign_vote, chain_id, vote)

    def sign_vote_extension(self, chain_id: str, vote: Vote) -> None:
        self._retry(
            "sign_vote_extension",
            self.client.sign_vote_extension,
            chain_id,
            vote,
        )

    def sign_proposal(self, chain_id: str, prop: Proposal) -> None:
        self._retry(
            "sign_proposal", self.client.sign_proposal, chain_id, prop
        )

    def wait_for_signer(self, timeout_s: float = 30.0) -> None:
        self.client.wait_for_signer(timeout_s)

    @property
    def listen_addr(self) -> str:
        return self.client.listen_addr

    def close(self) -> None:
        self.client.close()


class SignerServer:
    """Signer-side daemon: dials the validator node and serves signing
    requests from a FilePV (reference privval/signer_server.go +
    signer_dialer_endpoint.go). Run via `await serve()`."""

    def __init__(self, file_pv, addr: str,
                 auth_priv: Optional[Ed25519PrivKey] = None):
        self.pv = file_pv
        self.addr = addr
        self._auth_priv = auth_priv or self.pv.priv_key
        self._stopped = False

    async def serve_forever(self, redial_interval_s: float = 0.2) -> None:
        """serve() with redial: when the connection to the node drops
        (or the node is not up yet), dial again after a short pause —
        the reference's SignerDialerEndpoint retry behavior
        (privval/signer_dialer_endpoint.go). Pairs with the node-side
        RetrySignerClient so a transient drop heals from both ends."""
        while not self._stopped:
            try:
                await self.serve()
            except (
                ConnectionError,
                OSError,
                # IncompleteReadError (an EOFError, NOT an OSError):
                # node closed the socket mid-handshake, e.g. a restart
                EOFError,
                asyncio.TimeoutError,
            ):
                pass
            if not self._stopped:
                await asyncio.sleep(redial_interval_s)

    async def serve(self) -> None:
        host, _, port = _strip_scheme(self.addr).rpartition(":")
        reader, writer = await asyncio.open_connection(host, int(port))
        sconn = await SecretConnection.handshake(
            reader, writer, self._auth_priv
        )
        while not self._stopped:
            try:
                mtype, body = await _recv(sconn)
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            try:
                await self._handle(sconn, mtype, body)
            except asyncio.CancelledError:
                raise  # server stop cancels the serve loop
            except Exception as e:
                traceback.print_exc()
                await _send(
                    sconn, MSG_ERROR_RESPONSE, str(e).encode()
                )

    async def _handle(self, sconn, mtype: int, body: bytes) -> None:
        if mtype == MSG_PUBKEY_REQUEST:
            await _send(
                sconn,
                MSG_PUBKEY_RESPONSE,
                bytes(self.pv.pub_key().key_bytes),
            )
        elif mtype == MSG_PING_REQUEST:
            await _send(sconn, MSG_PING_RESPONSE)
        elif mtype == MSG_SIGN_VOTE_EXT_REQUEST:
            (ln,) = struct.unpack(">H", body[:2])
            chain_id = body[2 : 2 + ln].decode()
            vote = codec.decode_vote(body[2 + ln:])
            self.pv.sign_vote_extension(chain_id, vote)
            await _send(
                sconn,
                MSG_SIGNED_VOTE_EXT_RESPONSE,
                vote.extension_signature,
            )
        elif mtype in (MSG_SIGN_VOTE_REQUEST, MSG_SIGN_PROPOSAL_REQUEST):
            (ln,) = struct.unpack(">H", body[:2])
            chain_id = body[2 : 2 + ln].decode()
            rest = body[2 + ln:]
            if mtype == MSG_SIGN_VOTE_REQUEST:
                vote = codec.decode_vote(rest)
                self.pv.sign_vote(chain_id, vote)  # double-sign guard HERE
                if vote.extension:
                    # ABCI vote extensions: sign in the same round trip
                    self.pv.sign_vote_extension(chain_id, vote)
                await _send(
                    sconn,
                    MSG_SIGNED_VOTE_RESPONSE,
                    codec.encode_vote(vote),
                )
            else:
                prop = codec.decode_proposal(rest)
                self.pv.sign_proposal(chain_id, prop)
                await _send(
                    sconn,
                    MSG_SIGNED_PROPOSAL_RESPONSE,
                    codec.encode_proposal(prop),
                )
        else:
            raise RemoteSignerError(f"unknown request type {mtype}")

    def stop(self) -> None:
        self._stopped = True
