"""ABCI socket and gRPC clients: connect a node to an out-of-process app.

A copy of the JAX package's ``abci/socket_client.py``. ``SocketClient``
is the reference's pipelined client (abci/client/socket_client.go):
each request is written at once under a send lock and its future
queued; one reader thread matches responses to the queued futures in
order, so CheckTx pipelines (``check_tx_async``, ``check_tx_batch``)
while a consensus call blocks on its own future. Every call blocks the
calling thread, never an event loop: a node's executor calls it as it
calls the local client. ``GRPCClient`` gives the same surface over one
gRPC channel (reference grpc_client.go). ``connect_app_conns`` gives the
four named connections (reference proxy/multi_app_conn.go): four
sockets, or one gRPC channel shared.
"""

from __future__ import annotations

import socket
import threading
from collections import deque
from concurrent.futures import Future
from typing import List, Optional

from ..utils import proto
from . import codec
from .client import AppConns
from .server import parse_addr


class SocketClient:
    def __init__(self, addr: str, connect_timeout: float = 10.0):
        self.addr = addr
        scheme, target = parse_addr(addr)
        if scheme == "unix":
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.settimeout(connect_timeout)
            self._sock.connect(target)
        else:
            self._sock = socket.create_connection(
                target, timeout=connect_timeout
            )
        self._sock.settimeout(None)
        self._wlock = threading.Lock()
        self._pending: "deque[tuple[int, Future]]" = deque()
        self._plock = threading.Lock()
        self._err: Optional[BaseException] = None
        self._closed = False
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True, name=f"abci-read {addr}"
        )
        self._reader.start()

    # --- transport ----------------------------------------------------

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("abci server closed connection")
            buf += chunk
        return buf

    def _read_frame(self) -> bytes:
        lead = b""
        while True:
            b = self._read_exact(1)
            lead += b
            if not b[0] & 0x80:
                break
            if len(lead) > 10:
                raise ValueError("frame varint too long")
        ln, _ = proto.read_varint(lead, 0)
        if ln < 0 or ln > 64 * 1024 * 1024:
            raise ValueError(f"bad frame length {ln}")
        return self._read_exact(ln)

    def _read_loop(self) -> None:
        try:
            while True:
                frame = self._read_frame()
                kind, resp = None, None
                err = None
                try:
                    kind, resp = codec.decode_response(frame)
                except Exception as e:
                    err = e
                with self._plock:
                    if not self._pending:
                        continue  # unsolicited; drop
                    want, fut = self._pending.popleft()
                if err is not None:
                    fut.set_exception(err)
                elif kind != want:
                    fut.set_exception(
                        RuntimeError(
                            f"abci response kind {kind} != request {want}"
                        )
                    )
                else:
                    fut.set_result(resp)
        except BaseException as e:
            self._err = e
            with self._plock:
                pending, self._pending = list(self._pending), deque()
            for _, fut in pending:
                if not fut.done():
                    fut.set_exception(
                        ConnectionError(f"abci connection lost: {e}")
                    )

    def _send(self, kind: int, req) -> Future:
        if self._err is not None and not self._closed:
            raise ConnectionError(f"abci connection lost: {self._err}")
        data = proto.delimited(codec.encode_request(kind, req))
        fut: Future = Future()
        entry = (kind, fut)
        with self._wlock:
            with self._plock:
                self._pending.append(entry)
            try:
                self._sock.sendall(data)
            except BaseException:
                # a stale entry would desync the FIFO response matching
                with self._plock:
                    try:
                        self._pending.remove(entry)
                    except ValueError:
                        pass
                raise
            # the reader thread may have drained _pending (connection
            # death) between our first _err check and the append; an
            # entry added after the drain would hang its caller forever
            with self._plock:
                if self._err is not None and not fut.done():
                    try:
                        self._pending.remove(entry)
                    except ValueError:
                        pass
                    fut.set_exception(
                        ConnectionError(
                            f"abci connection lost: {self._err}"
                        )
                    )
        return fut

    def _call(self, kind: int, req=None):
        return self._send(kind, req).result()

    # --- client interface (matches LocalClient) -----------------------

    def echo(self, msg: str) -> str:
        return self._call(codec.ECHO, msg)

    def flush(self) -> None:
        self._call(codec.FLUSH)

    def info(self, req):
        return self._call(codec.INFO, req)

    def query(self, req):
        return self._call(codec.QUERY, req)

    def init_chain(self, req):
        return self._call(codec.INIT_CHAIN, req)

    def prepare_proposal(self, req):
        return self._call(codec.PREPARE_PROPOSAL, req)

    def process_proposal(self, req):
        return self._call(codec.PROCESS_PROPOSAL, req)

    def extend_vote(self, req):
        return self._call(codec.EXTEND_VOTE, req)

    def verify_vote_extension(self, req):
        return self._call(codec.VERIFY_VOTE_EXTENSION, req)

    def finalize_block(self, req):
        return self._call(codec.FINALIZE_BLOCK, req)

    def commit(self):
        return self._call(codec.COMMIT, None)

    def check_tx(self, req):
        return self._call(codec.CHECK_TX, req)

    def check_tx_async(self, req) -> Future:
        return self._send(codec.CHECK_TX, req)

    def check_tx_batch(self, reqs):
        """Batched CheckTx over the socket: pipeline every request
        before waiting on any response, so the process boundary costs
        one round-trip per BATCH instead of per tx (the wire protocol
        is unchanged — FIFO request/response matching does the rest)."""
        futs = [self._send(codec.CHECK_TX, r) for r in reqs]
        return [f.result() for f in futs]

    def insert_tx(self, tx: bytes) -> bool:
        return self._call(codec.INSERT_TX, tx)

    def reap_txs(self, max_bytes: int, max_gas: int) -> List[bytes]:
        return self._call(codec.REAP_TXS, (max_bytes, max_gas))

    def list_snapshots(self):
        return self._call(codec.LIST_SNAPSHOTS, None)

    def offer_snapshot(self, snapshot, app_hash):
        return self._call(codec.OFFER_SNAPSHOT, (snapshot, app_hash))

    def load_snapshot_chunk(self, height, format_, chunk) -> bytes:
        return self._call(
            codec.LOAD_SNAPSHOT_CHUNK, (height, format_, chunk)
        )

    def apply_snapshot_chunk(self, index, chunk, sender):
        return self._call(
            codec.APPLY_SNAPSHOT_CHUNK, (index, chunk, sender)
        )


class GRPCClient:
    """Same surface over gRPC (reference abci/client/grpc_client.go);
    gRPC handles its own multiplexing so one channel serves all 4
    logical connections."""

    def __init__(self, addr: str):
        import grpc

        from .server import GRPC_METHOD

        scheme, target = parse_addr(addr)
        if scheme == "unix":
            self._chan = grpc.insecure_channel(f"unix:{target}")
        else:
            self._chan = grpc.insecure_channel(f"{target[0]}:{target[1]}")
        self._callable = self._chan.unary_unary(
            GRPC_METHOD,
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )

    def close(self) -> None:
        self._chan.close()

    @staticmethod
    def _decode(kind: int, raw: bytes):
        got, resp = codec.decode_response(raw)
        if got != kind:
            raise RuntimeError(
                f"abci response kind {got} != request {kind}"
            )
        return resp

    def _call(self, kind: int, req=None):
        raw = self._callable(codec.encode_request(kind, req))
        return self._decode(kind, raw)

    def echo(self, msg: str) -> str:
        return self._call(codec.ECHO, msg)

    def info(self, req):
        return self._call(codec.INFO, req)

    def query(self, req):
        return self._call(codec.QUERY, req)

    def init_chain(self, req):
        return self._call(codec.INIT_CHAIN, req)

    def prepare_proposal(self, req):
        return self._call(codec.PREPARE_PROPOSAL, req)

    def process_proposal(self, req):
        return self._call(codec.PROCESS_PROPOSAL, req)

    def extend_vote(self, req):
        return self._call(codec.EXTEND_VOTE, req)

    def verify_vote_extension(self, req):
        return self._call(codec.VERIFY_VOTE_EXTENSION, req)

    def finalize_block(self, req):
        return self._call(codec.FINALIZE_BLOCK, req)

    def commit(self):
        return self._call(codec.COMMIT, None)

    def check_tx(self, req):
        return self._call(codec.CHECK_TX, req)

    def check_tx_async(self, req) -> Future:
        """Pipelined CheckTx: the grpc future API keeps the caller (the
        node's event loop) off the round-trip, matching SocketClient's
        async semantics."""
        fut: Future = Future()
        try:
            rpc = self._callable.future(
                codec.encode_request(codec.CHECK_TX, req)
            )
        except Exception:
            # channel impls without the future API degrade to blocking
            try:
                fut.set_result(self.check_tx(req))
            except Exception as e:
                fut.set_exception(e)
            return fut

        def _done(f):
            try:
                fut.set_result(self._decode(codec.CHECK_TX, f.result()))
            except Exception as e:
                fut.set_exception(e)

        rpc.add_done_callback(_done)
        return fut

    def insert_tx(self, tx: bytes) -> bool:
        return self._call(codec.INSERT_TX, tx)

    def reap_txs(self, max_bytes: int, max_gas: int) -> List[bytes]:
        return self._call(codec.REAP_TXS, (max_bytes, max_gas))

    def list_snapshots(self):
        return self._call(codec.LIST_SNAPSHOTS, None)

    def offer_snapshot(self, snapshot, app_hash):
        return self._call(codec.OFFER_SNAPSHOT, (snapshot, app_hash))

    def load_snapshot_chunk(self, height, format_, chunk) -> bytes:
        return self._call(
            codec.LOAD_SNAPSHOT_CHUNK, (height, format_, chunk)
        )

    def apply_snapshot_chunk(self, index, chunk, sender):
        return self._call(
            codec.APPLY_SNAPSHOT_CHUNK, (index, chunk, sender)
        )


def connect_app_conns(addr: str, transport: str = "socket") -> AppConns:
    """The reference's proxy.NewMultiAppConn for remote apps: 4 named
    connections (consensus/mempool/query/snapshot) each on its own
    socket so a slow consensus call never blocks CheckTx
    (proxy/multi_app_conn.go:21-62)."""
    if transport == "grpc":
        c = GRPCClient(addr)  # grpc multiplexes internally
        return AppConns(c)
    return AppConns(
        SocketClient(addr),
        mempool=SocketClient(addr),
        query=SocketClient(addr),
        snapshot=SocketClient(addr),
    )
