"""HTTP light-block provider (reference light/provider/http).

Fetches (header, commit, valset) triples from a full node's RPC using
the lossless `*_b64` payloads, so every hash recomputes exactly.

The light.Client Provider interface is synchronous; HTTP is async. The
provider owns a dedicated background event loop thread and blocks the
calling thread per request — safe from sync code and from OTHER event
loops (never call it from the provider's own loop).

Connection policy: ONE aiohttp session per provider, reused across
every request (rpc/client.HTTPClient keeps its ClientSession alive —
a keep-alive connection per full node, not a TCP handshake per call),
and transient transport failures retry a bounded number of times with
full-jitter exponential backoff (utils/backoff.py) before surfacing.
``LightBlockNotFound`` never retries — a missing height is an answer,
not an outage.

A copy of the JAX package's ``light/http_provider.py``: it reads a JAX
node as it reads a port node."""

from __future__ import annotations

import asyncio
import base64
import concurrent.futures
import random
import threading
import time
from typing import Optional

from ..rpc.client import HTTPClient, RPCClientError
from ..utils.backoff import Backoff
from .provider import LightBlockNotFound, Provider, ProviderError
from .types import LightBlock

# transient-failure retry envelope: fast first retry, capped well
# under the per-request timeout so a flaky hop gets several tries
# without turning one light_block call into a multi-minute stall
RETRY_ATTEMPTS = 3
RETRY_BASE_S = 0.05
RETRY_CAP_S = 1.0


class HTTPProvider(Provider):
    def __init__(
        self,
        chain_id: str,
        base_url: str,
        timeout_s: float = 10.0,
        retries: int = RETRY_ATTEMPTS,
        rng: Optional[random.Random] = None,
    ):
        self.chain_id = chain_id
        self.base_url = base_url
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, daemon=True
        )
        self._thread.start()
        # one HTTPClient = one persistent aiohttp session for the
        # provider's lifetime (closed in close())
        self._client = HTTPClient(base_url, timeout_s=timeout_s)
        self._timeout_s = timeout_s + 5.0
        self._retries = max(1, retries)
        self._rng = rng or random.Random()
        self.retries_used = 0  # observability (tests/metrics)

    def _run(self, coro):
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        try:
            return fut.result(self._timeout_s)
        except concurrent.futures.TimeoutError:
            # the coroutine is STILL RUNNING on the background loop:
            # cancel it and surface a non-retryable ProviderError —
            # retrying a result-timeout would stack duplicate
            # in-flight RPCs on an already-slow node and multiply the
            # caller's effective deadline by the retry budget
            self._loop.call_soon_threadsafe(fut.cancel)
            raise ProviderError(
                f"rpc timed out after {self._timeout_s:.0f}s"
            )

    def light_block(self, height: int) -> LightBlock:
        backoff = Backoff(
            base_s=RETRY_BASE_S, cap_s=RETRY_CAP_S, rng=self._rng
        )
        last: Optional[Exception] = None
        for attempt in range(self._retries):
            try:
                return self._run(self._light_block(height or None))
            except RPCClientError as e:
                # the node ANSWERED: no-such-height is a verdict, not
                # a transport fault — never retried
                raise LightBlockNotFound(str(e))
            except ProviderError:
                raise
            except Exception as e:
                last = e
                if attempt + 1 < self._retries:
                    self.retries_used += 1
                    time.sleep(backoff.next_delay())
        raise ProviderError(
            f"rpc failure after {self._retries} attempts: {last!r}"
        )

    async def _light_block(self, height: Optional[int]) -> LightBlock:
        hdr, commit = await self._client.commit_decoded(height)
        vals = await self._client.validators_decoded(hdr.height)
        return LightBlock(header=hdr, commit=commit, validator_set=vals)

    def report_evidence(self, ev) -> None:
        try:
            self._run(
                self._client.call(
                    "broadcast_evidence",
                    evidence=base64.b64encode(ev.encode()).decode(),
                )
            )
        except Exception:
            pass

    def close(self) -> None:
        try:
            self._run(self._client.close())
        except Exception:
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)
