"""The light client (reference light/): verifier, client, providers
(a node's stores, a node's RPC), trusted stores, the witness detector,
the serving plane (``serving.py``) and the verifying RPC proxy
(``proxy.py``)."""

from .client import SEQUENTIAL, SKIPPING, Client, TrustOptions  # noqa: F401
from .provider import Provider, StoreBackedProvider  # noqa: F401
from .serving import (  # noqa: F401
    CoalescedCommitVerifier,
    LightServingPlane,
    ServingOverloadError,
    VerifiedHeaderCache,
)
from .store import LightStore  # noqa: F401
from .types import LightBlock  # noqa: F401
from . import verifier  # noqa: F401
