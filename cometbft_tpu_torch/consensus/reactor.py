"""Consensus messages (reference consensus/reactor.go).

The part of the JAX package's ``consensus/reactor.py`` that in-process
nets use: ``CommitBlockMessage`` (a committed block with its commit and
extended commit: the catch-up message, reference gossipDataForCatchup)
beside the state machine's own message dataclasses, which the JAX
reactor imports from ``consensus/state.py`` as this module does. The
``ConsensusReactor`` itself (p2p channels, per-peer gossip routines,
the wire codec) needs ``p2p/`` and waits for the network slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..types.block import Block, Commit
from .state import BlockPartMessage, ProposalMessage, TimeoutInfo, VoteMessage  # noqa: F401


@dataclass
class CommitBlockMessage:
    block: Block
    commit: Commit
    # raw extended commit when the sender holds one for this height —
    # catch-up must propagate ECs like every other commit path
    # (reference SaveBlockWithExtendedCommit), or nodes that caught up
    # through consensus can never serve the EC to blocksync joiners
    ec_bytes: Optional[bytes] = None
