"""ABCI socket and gRPC servers: host an Application out of process.

A copy of the JAX package's ``abci/server.py`` (reference
abci/server/socket_server.go: varint-delimited request and response
frames, one serialized request stream a connection; grpc_server.go: the
same surface over gRPC). ``parse_addr`` reads ``tcp://host:port``,
``unix:///path`` or a bare ``host:port``; ``handle_request`` dispatches
one decoded request to the app and answers an EXCEPTION envelope when
the app raises; ``ABCIServer`` serves on an asyncio loop and runs each
app call in a worker thread, one lock across connections (the local
client's mutex); ``GRPCServer`` carries the codec envelope in one
generic unary method, with no generated code. A node dials either with
``abci.socket_client``.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Optional

from ..utils import proto
from . import codec
from . import types as abci


def parse_addr(addr: str):
    """'tcp://h:p' | 'unix:///path' -> ('tcp', (h, p)) | ('unix', path)."""
    if addr.startswith("tcp://"):
        hp = addr[len("tcp://") :]
        host, _, port = hp.rpartition(":")
        return "tcp", (host or "127.0.0.1", int(port))
    if addr.startswith("unix://"):
        return "unix", addr[len("unix://") :]
    # bare host:port
    host, _, port = addr.rpartition(":")
    return "tcp", (host or "127.0.0.1", int(port))


def handle_request(app: abci.Application, kind: int, req) -> bytes:
    """Dispatch one decoded request to the Application; returns an
    encoded response (EXCEPTION envelope on error)."""
    try:
        if kind == codec.ECHO:
            return codec.encode_response(kind, app.echo(req))
        if kind == codec.FLUSH:
            return codec.encode_response(kind, None)
        if kind == codec.INFO:
            return codec.encode_response(kind, app.info(req))
        if kind == codec.INIT_CHAIN:
            return codec.encode_response(kind, app.init_chain(req))
        if kind == codec.QUERY:
            return codec.encode_response(kind, app.query(req))
        if kind == codec.CHECK_TX:
            return codec.encode_response(kind, app.check_tx(req))
        if kind == codec.COMMIT:
            return codec.encode_response(kind, app.commit())
        if kind == codec.LIST_SNAPSHOTS:
            return codec.encode_response(kind, app.list_snapshots())
        if kind == codec.OFFER_SNAPSHOT:
            return codec.encode_response(kind, app.offer_snapshot(*req))
        if kind == codec.LOAD_SNAPSHOT_CHUNK:
            return codec.encode_response(
                kind, app.load_snapshot_chunk(*req)
            )
        if kind == codec.APPLY_SNAPSHOT_CHUNK:
            return codec.encode_response(
                kind, app.apply_snapshot_chunk(*req)
            )
        if kind == codec.PREPARE_PROPOSAL:
            return codec.encode_response(kind, app.prepare_proposal(req))
        if kind == codec.PROCESS_PROPOSAL:
            return codec.encode_response(kind, app.process_proposal(req))
        if kind == codec.EXTEND_VOTE:
            return codec.encode_response(kind, app.extend_vote(req))
        if kind == codec.VERIFY_VOTE_EXTENSION:
            return codec.encode_response(
                kind, app.verify_vote_extension(req)
            )
        if kind == codec.FINALIZE_BLOCK:
            return codec.encode_response(kind, app.finalize_block(req))
        if kind == codec.INSERT_TX:
            return codec.encode_response(kind, app.insert_tx(req))
        if kind == codec.REAP_TXS:
            return codec.encode_response(kind, app.reap_txs(*req))
        return codec.encode_response(
            codec.EXCEPTION, f"unknown request kind {kind}"
        )
    except Exception as e:
        return codec.encode_response(codec.EXCEPTION, e)


async def _read_frame(reader: asyncio.StreamReader) -> Optional[bytes]:
    """Read one varint-delimited frame; None on clean EOF."""
    lead = b""
    while True:
        b = await reader.read(1)
        if not b:
            return None if not lead else _trunc()
        lead += b
        if not b[0] & 0x80:
            break
        if len(lead) > 10:
            raise ValueError("frame varint too long")
    ln, _ = proto.read_varint(lead, 0)
    if ln < 0 or ln > 64 * 1024 * 1024:
        raise ValueError(f"bad frame length {ln}")
    return await reader.readexactly(ln)


def _trunc():
    raise ValueError("truncated frame")


class ABCIServer:
    """Asyncio socket server; requests on each connection are handled
    strictly in order (the reference's per-connection serialization,
    abci/server/socket_server.go). The app-level lock serializes across
    connections like the local client's global mutex."""

    def __init__(self, app: abci.Application, addr: str):
        self.app = app
        self.addr = addr
        self._lock = threading.Lock()
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        scheme, target = parse_addr(self.addr)
        if scheme == "unix":
            self._server = await asyncio.start_unix_server(
                self._handle, path=target
            )
        else:
            self._server = await asyncio.start_server(
                self._handle, host=target[0], port=target[1]
            )

    @property
    def listen_addr(self) -> str:
        socks = self._server.sockets
        name = socks[0].getsockname()
        if isinstance(name, tuple):
            return f"tcp://{name[0]}:{name[1]}"
        return f"unix://{name}"

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    def _call(self, kind: int, req) -> bytes:
        with self._lock:
            return handle_request(self.app, kind, req)

    async def _handle(self, reader, writer) -> None:
        try:
            while True:
                frame = await _read_frame(reader)
                if frame is None:
                    break
                kind, req = codec.decode_request(frame)
                # run the (possibly slow) app call off the event loop
                resp = await asyncio.to_thread(self._call, kind, req)
                writer.write(proto.delimited(resp))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        except asyncio.CancelledError:
            raise  # server stop cancels handlers; never swallow it
        except Exception as e:  # malformed frame: report then drop conn
            try:
                writer.write(
                    proto.delimited(
                        codec.encode_response(codec.EXCEPTION, e)
                    )
                )
                await writer.drain()
            except (OSError, RuntimeError):
                pass  # peer already gone / transport torn down
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (OSError, RuntimeError):
                pass  # double-close on a dead transport is fine


GRPC_METHOD = "/cometbft.abci.ABCI/Call"


class GRPCServer:
    """The same ABCI surface over gRPC (reference abci/server/
    grpc_server.go). One unary-unary generic method carries the codec
    envelope; no codegen needed."""

    def __init__(self, app: abci.Application, addr: str):
        self.app = app
        self.addr = addr
        self._server = None
        self._lock = threading.Lock()

    def start(self) -> None:
        import grpc

        def call(request: bytes, context) -> bytes:
            kind, req = codec.decode_request(request)
            with self._lock:
                return handle_request(self.app, kind, req)

        class Handler(grpc.GenericRpcHandler):
            def service(self, details):
                if details.method == GRPC_METHOD:
                    return grpc.unary_unary_rpc_method_handler(call)
                return None

        from concurrent.futures import ThreadPoolExecutor

        self._server = grpc.server(
            ThreadPoolExecutor(max_workers=4), handlers=(Handler(),)
        )
        scheme, target = parse_addr(self.addr)
        if scheme == "unix":
            port = self._server.add_insecure_port(f"unix:{target}")
        else:
            port = self._server.add_insecure_port(
                f"{target[0]}:{target[1]}"
            )
        self.port = port
        self._server.start()

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=0.5)
