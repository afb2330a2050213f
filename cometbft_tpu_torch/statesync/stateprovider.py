"""Light-client-backed state provider (reference
statesync/stateprovider.go:48-125 lightClientStateProvider).

Builds the post-snapshot State entirely from light-verified headers:
the app hash OF height h lives in header h+1, validator sets come from
the verified valset chain, and the commit for h proves the header. All
fetches ride the light client, so a statesyncing node trusts only its
configured (height, hash) root.

A copy of the JAX package's ``statesync/stateprovider.py``. Its
``Client`` runs on ``device`` (None is the GPU, and raises without
one; ``device="cpu"`` the host plane or the plain kernels), at
``PRIORITY_CATCHUP``, and shares ``header_cache`` as the JAX provider
does. A failed verify route raises ``DeviceRouteError`` out of every
method (ROADMAP C3).
"""

from __future__ import annotations

from typing import List

from ..crypto.scheduler import PRIORITY_CATCHUP
from ..device import resolve
from ..light import Client, TrustOptions
from ..light.http_provider import HTTPProvider
from ..state.state_types import State
from ..types.block import Commit


class LightClientStateProvider:
    def __init__(
        self,
        chain_id: str,
        rpc_servers: List[str],
        trust_height: int,
        trust_hash: bytes,
        trust_period_ns: int,
        genesis=None,
        header_cache=None,
        signature_cache=None,
        verify_engine=None,
        device=None,
    ):
        if not rpc_servers:
            raise ValueError("statesync requires at least one RPC server")
        self.device = resolve(device)
        self.chain_id = chain_id
        self.genesis = genesis
        self.primary = HTTPProvider(chain_id, rpc_servers[0])
        self.witnesses = [HTTPProvider(chain_id, s) for s in rpc_servers[1:]]
        # shared serving seams (light/serving.py): heights that
        # concurrent light sessions (or an earlier sync attempt)
        # already verified restore without re-paying commit
        # verification, and what THIS sync verifies is published for
        # them (after cross-check)
        self.header_cache = header_cache
        try:
            self.client = Client(
                chain_id,
                TrustOptions(period_ns=trust_period_ns, height=trust_height, hash=trust_hash),
                primary=self.primary,
                witnesses=self.witnesses,
                signature_cache=signature_cache,
                header_cache=header_cache,
                verify_engine=verify_engine,
                # statesync restore is bulk catch-up work: it must never
                # preempt a live round sharing the verify scheduler
                priority=PRIORITY_CATCHUP,
                device=self.device,
            )
        except BaseException:
            self.close()
            raise

    def cache_stats(self) -> dict:
        """Shared-verification observability for the syncer's log."""
        out = {"bisection_hops": self.client.hops}
        if self.header_cache is not None:
            out.update(self.header_cache.stats())
        return out

    def app_hash(self, height: int) -> bytes:
        """App hash AFTER executing block `height` (header h+1)."""
        return self.client.verify_light_block_at_height(height + 1).header.app_hash

    def commit(self, height: int) -> Commit:
        return self.client.verify_light_block_at_height(height).commit

    def state(self, height: int) -> State:
        """State as of height h, ready for ApplyBlock(h+1)."""
        cur = self.client.verify_light_block_at_height(height)
        nxt = self.client.verify_light_block_at_height(height + 1)
        prev = self.client.verify_light_block_at_height(height - 1) if height > 1 else None
        initial_height = self.genesis.initial_height if self.genesis else 1
        params = (
            self.genesis.consensus_params if self.genesis is not None else State().consensus_params
        )
        return State(
            chain_id=self.chain_id,
            initial_height=initial_height,
            last_block_height=cur.height,
            last_block_id=nxt.header.last_block_id,
            last_block_time_ns=cur.header.time_ns,
            validators=cur.validator_set,
            next_validators=nxt.validator_set,
            last_validators=prev.validator_set if prev else None,
            # earliest height whose valset this bootstrapped node holds
            # as a FULL record (Store.bootstrap writes h..h+2 full):
            # later pointer records must reference a stored-full height
            last_height_validators_changed=cur.height + 2,
            consensus_params=params,
            last_height_consensus_params_changed=0,
            last_results_hash=nxt.header.last_results_hash,
            app_hash=nxt.header.app_hash,
        )

    def close(self) -> None:
        self.primary.close()
        for w in self.witnesses:
            w.close()
