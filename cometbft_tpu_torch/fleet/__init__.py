"""Serving fleet (a copy of the JAX package's ``fleet/``):
non-validator follower replicas behind the committee + a session
router in front of them.

The deployment shape for "millions of users": verification and fan-out
cost concentrate server-side (PAPERS.md), so serving capacity scales
OUT across read replicas — each follower tail-follows the committee
and runs the full read stack (replica fan-out, light serving plane
with an optionally shared process-wide VerifiedHeaderCache, indexer
read barrier) while the SessionRouter owns admission, least-loaded
placement, consistency tokens (height-barrier read-your-writes),
lag-aware shedding and lossless failover.
"""

from .follower import (
    FollowerNode,
    NodeReplica,
    ReplicaFanout,
    StoreSource,
    StreamSource,
    height_events,
)
from .router import (
    FleetOverloadError,
    RoutedSession,
    SessionRouter,
    StaleReadError,
)

__all__ = [
    "FollowerNode",
    "NodeReplica",
    "ReplicaFanout",
    "StoreSource",
    "StreamSource",
    "height_events",
    "FleetOverloadError",
    "RoutedSession",
    "SessionRouter",
    "StaleReadError",
]
