"""The gRPC broadcast API (reference rpc/grpc/api.go).

A copy of the JAX package's ``rpc/grpc_api.py``. Two unary methods, Ping
and BroadcastTx, the latter with BroadcastTxCommit's semantics (CheckTx,
then wait for the tx's block), served through generic handlers over
hand-written proto, with no generated code. ``Node`` serves it beside
JSON-RPC when ``rpc.grpc_laddr`` is set; BroadcastTx waits on the RPC
environment's ``CommitWaiterMap``, as the JSON-RPC route does.

Wire shapes (field numbers are the contract):
  RequestBroadcastTx  {1: tx bytes}
  ResponseBroadcastTx {1: check_tx {1: code, 3: log},
                       2: tx_result {1: code, 3: log},
                       3: hash hex string, 4: height varint}
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..utils import proto
from . import core

PING_METHOD = "/cometbft.rpc.grpc.BroadcastAPI/Ping"
BROADCAST_METHOD = "/cometbft.rpc.grpc.BroadcastAPI/BroadcastTx"


class GRPCBroadcastServer:
    """Node-side server; ``loop`` is the node's asyncio loop (the
    broadcast path awaits the tx inclusion event on it, while gRPC
    serves from its own thread pool)."""

    def __init__(
        self,
        env,
        addr: str,
        loop: asyncio.AbstractEventLoop,
        timeout_s: float = 10.0,
    ):
        self.env = env
        self.addr = addr
        self.loop = loop
        self.timeout_s = timeout_s
        self._server = None
        self.port: Optional[int] = None

    def start(self) -> None:
        import grpc

        env, loop, timeout_s = self.env, self.loop, self.timeout_s

        def ping(request: bytes, context) -> bytes:
            return b""

        def broadcast(request: bytes, context) -> bytes:
            m = proto.parse(request)
            tx = proto.get1(m, 1, b"")
            fut = asyncio.run_coroutine_threadsafe(
                core.broadcast_tx_commit(env, tx=tx, timeout_s=timeout_s),
                loop,
            )
            try:
                # small grace over the coroutine's own deadline; on
                # expiry CANCEL the future so the height-keyed
                # CommitWaiterMap entry inside broadcast_tx_commit is
                # released (rpc/fanout.py — this API rides the same
                # one-subscription waiter plane as the JSON-RPC route,
                # so N concurrent gRPC broadcasts cost one dict entry
                # each, not one bus predicate each)
                res = fut.result(timeout_s + 5.0)
            except Exception as e:
                fut.cancel()
                context.abort(grpc.StatusCode.INTERNAL, str(e))
            check = res.get("check_tx") or {}
            txr = res.get("tx_result") or {}
            out = proto.field_message(
                1,
                proto.field_varint(1, int(check.get("code") or 0))
                + proto.field_string(3, str(check.get("log") or "")),
            )
            out += proto.field_message(
                2,
                proto.field_varint(1, int(txr.get("code") or 0))
                + proto.field_string(3, str(txr.get("log") or "")),
            )
            out += proto.field_string(3, str(res.get("hash") or ""))
            out += proto.field_varint(4, int(res.get("height") or 0))
            return out

        class Handler(grpc.GenericRpcHandler):
            def service(self, details):
                if details.method == PING_METHOD:
                    return grpc.unary_unary_rpc_method_handler(ping)
                if details.method == BROADCAST_METHOD:
                    return grpc.unary_unary_rpc_method_handler(broadcast)
                return None

        from concurrent.futures import ThreadPoolExecutor

        self._server = grpc.server(
            ThreadPoolExecutor(max_workers=2), handlers=(Handler(),)
        )
        host, _, port = self.addr.rpartition(":")
        self.port = self._server.add_insecure_port(
            f"{host or '127.0.0.1'}:{port}"
        )
        if not self.port:
            raise RuntimeError(
                f"gRPC broadcast API failed to bind {self.addr}"
            )
        self._server.start()

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=0.5)


class GRPCBroadcastClient:
    """Reference StartGRPCClient analog (rpc/grpc/client_server.go)."""

    def __init__(self, addr: str):
        import grpc

        self._ch = grpc.insecure_channel(addr)
        ident = lambda b: b  # noqa: E731 - raw-bytes serializers
        self._ping = self._ch.unary_unary(
            PING_METHOD, request_serializer=ident,
            response_deserializer=ident,
        )
        self._broadcast = self._ch.unary_unary(
            BROADCAST_METHOD, request_serializer=ident,
            response_deserializer=ident,
        )

    def ping(self) -> None:
        self._ping(b"", timeout=5.0)

    def broadcast_tx(self, tx: bytes, timeout: float = 30.0) -> dict:
        raw = self._broadcast(
            proto.field_bytes(1, tx), timeout=timeout
        )
        m = proto.parse(raw)
        check = proto.parse(proto.get1(m, 1, b""))
        txr = proto.parse(proto.get1(m, 2, b""))
        return {
            "check_tx": {
                "code": proto.get1(check, 1, 0),
                "log": proto.get1(check, 3, b"").decode(),
            },
            "tx_result": {
                "code": proto.get1(txr, 1, 0),
                "log": proto.get1(txr, 3, b"").decode(),
            },
            "hash": proto.get1(m, 3, b"").decode(),
            "height": proto.get1(m, 4, 0),
        }

    def close(self) -> None:
        self._ch.close()
