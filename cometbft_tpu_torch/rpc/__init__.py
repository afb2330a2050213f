"""JSON-RPC API layer (reference rpc/): HTTP + WebSocket server over
the node's internals, and the matching client library, on ``aiohttp``
as in the JAX package. The gRPC broadcast API is not ported (ROADMAP
A8)."""

from .client import HTTPClient
from .env import Environment
from .server import RPCServer

__all__ = ["RPCServer", "Environment", "HTTPClient"]
