"""The light client (reference light/): verifier, client, providers,
trusted stores and the witness detector. The serving plane, the
verifying proxy and the RPC provider wait for the port's ``rpc/``."""

from .client import SEQUENTIAL, SKIPPING, Client, TrustOptions  # noqa: F401
from .provider import Provider, StoreBackedProvider  # noqa: F401
from .store import LightStore  # noqa: F401
from .types import LightBlock  # noqa: F401
from . import verifier  # noqa: F401
