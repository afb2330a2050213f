"""Light block providers (reference light/provider/).

A copy of the JAX package's ``light/provider.py``. A provider serves
(header, commit, validator set) triples by height;
``StoreBackedProvider`` reads them from a full node's block and state
stores. The provider over a node's RPC waits for the port's ``rpc/``.
"""

from __future__ import annotations

from .types import LightBlock


class ProviderError(Exception):
    pass


class LightBlockNotFound(ProviderError):
    pass


class Provider:
    chain_id: str = ""

    def light_block(self, height: int) -> LightBlock:
        """height = 0 means latest."""
        raise NotImplementedError

    def report_evidence(self, ev) -> None:
        raise NotImplementedError


class StoreBackedProvider(Provider):
    """Serves light blocks from a full node's block + state stores."""

    def __init__(self, chain_id, block_store, state_store):
        self.chain_id = chain_id
        self.block_store = block_store
        self.state_store = state_store
        self.reported = []

    def light_block(self, height: int) -> LightBlock:
        if height == 0:
            height = self.block_store.height()
        meta = self.block_store.load_block_meta(height)
        if meta is None:
            raise LightBlockNotFound(f"no block meta at {height}")
        commit = self.block_store.load_seen_commit(height)
        if commit is None:
            commit = self.block_store.load_block_commit(height)
        if commit is None:
            raise LightBlockNotFound(f"no commit at {height}")
        vals = self.state_store.load_validators(height)
        if vals is None:
            raise LightBlockNotFound(f"no validators at {height}")
        return LightBlock(header=meta.header, commit=commit, validator_set=vals)

    def report_evidence(self, ev) -> None:
        self.reported.append(ev)
