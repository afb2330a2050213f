"""RPC clients (reference rpc/client/http + /local).

HTTPClient: JSON-RPC over HTTP POST with typed helpers that decode the
lossless `*_b64` fields back into framework types — what the light
client provider and statesync state provider consume. Also supports
WebSocket event subscriptions. A copy of the JAX package's
``rpc/client.py`` over the same ``aiohttp`` stack: it speaks to a JAX
node as to a port node."""

from __future__ import annotations

import asyncio
import base64
import itertools
import json
from typing import Any, AsyncIterator, Dict, Optional

import aiohttp

from ..types.block import Block
from ..types.validator_set import ValidatorSet
from ..utils import codec


class RPCClientError(Exception):
    def __init__(self, code: int, message: str, data: str = ""):
        super().__init__(f"[{code}] {message} {data}".strip())
        self.code = code
        self.message = message
        self.data = data


class HTTPClient:
    def __init__(self, base_url: str, timeout_s: float = 10.0):
        if not base_url.startswith("http"):
            base_url = "http://" + base_url
        self.base_url = base_url.rstrip("/")
        self.timeout = aiohttp.ClientTimeout(total=timeout_s)
        self._session: Optional[aiohttp.ClientSession] = None
        self._ids = itertools.count(1)

    async def _sess(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(timeout=self.timeout)
        return self._session

    async def close(self) -> None:
        if self._session and not self._session.closed:
            # bounded: aiohttp session close can park on
            # connector teardown; never let it hang the caller's stop
            try:
                await asyncio.wait_for(self._session.close(), 5.0)
            except asyncio.TimeoutError:
                pass

    async def call(self, method: str, **params) -> Dict[str, Any]:
        sess = await self._sess()
        req = {
            "jsonrpc": "2.0",
            "id": next(self._ids),
            "method": method,
            "params": {k: v for k, v in params.items() if v is not None},
        }
        async with sess.post(self.base_url + "/", json=req) as resp:
            body = await resp.json()
        if body.get("error"):
            e = body["error"]
            raise RPCClientError(
                e.get("code", -1), e.get("message", ""), e.get("data", "")
            )
        return body["result"]

    # --- typed helpers --------------------------------------------------

    async def status(self) -> Dict[str, Any]:
        return await self.call("status")

    async def block(self, height: Optional[int] = None) -> Dict[str, Any]:
        return await self.call(
            "block", height=str(height) if height else None
        )

    async def block_decoded(self, height: Optional[int] = None) -> Block:
        res = await self.block(height)
        return codec.decode_block(base64.b64decode(res["block_b64"]))

    async def commit_decoded(self, height: Optional[int] = None):
        """(Header, Commit) decoded from the lossless payload."""
        res = await self.call(
            "commit", height=str(height) if height else None
        )
        hdr = codec.decode_header(base64.b64decode(res["header_b64"]))
        cm = codec.decode_commit(base64.b64decode(res["commit_b64"]))
        return hdr, cm

    async def validators_decoded(
        self, height: Optional[int] = None
    ) -> ValidatorSet:
        res = await self.call(
            "validators",
            height=str(height) if height else None,
            per_page="100",
        )
        return codec.decode_validator_set(
            base64.b64decode(res["validator_set_b64"])
        )

    async def broadcast_tx_sync(self, tx: bytes) -> Dict[str, Any]:
        return await self.call(
            "broadcast_tx_sync", tx=base64.b64encode(tx).decode()
        )

    async def broadcast_tx_commit(self, tx: bytes) -> Dict[str, Any]:
        return await self.call(
            "broadcast_tx_commit", tx=base64.b64encode(tx).decode()
        )

    async def abci_query(
        self, path: str, data: bytes, height: int = 0, prove: bool = False
    ) -> Dict[str, Any]:
        return await self.call(
            "abci_query",
            path=path,
            data=data.hex(),
            height=str(height),
            prove=prove,
        )

    # --- websocket subscription -----------------------------------------

    async def subscribe(
        self, query: str
    ) -> AsyncIterator[Dict[str, Any]]:
        """Async iterator of matching events."""
        sess = await self._sess()
        ws = await sess.ws_connect(self.base_url + "/websocket")
        await ws.send_json(
            {
                "jsonrpc": "2.0",
                "id": next(self._ids),
                "method": "subscribe",
                "params": {"query": query},
            }
        )
        first = json.loads((await ws.receive()).data)
        if first.get("error"):
            await ws.close()
            raise RPCClientError(-1, str(first["error"]))

        async def gen():
            try:
                async for msg in ws:
                    if msg.type != aiohttp.WSMsgType.TEXT:
                        break
                    body = json.loads(msg.data)
                    if body.get("result"):
                        yield body["result"]
            finally:
                await ws.close()

        return gen()
