"""Statesync: bootstrap a fresh node from application snapshots,
light-client verified (reference statesync/). The port's counterpart
of the JAX package's ``statesync/``; the state provider's light checks
run on its ``device``."""

from .reactor import StateSyncReactor
from .stateprovider import LightClientStateProvider
from .syncer import SyncError, Syncer

__all__ = [
    "StateSyncReactor",
    "Syncer",
    "SyncError",
    "LightClientStateProvider",
]
