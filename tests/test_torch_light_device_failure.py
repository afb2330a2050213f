"""A failed device route leaves the light client as it is.

A stand-in card: the device route pinned (floor 1) on ``device="cpu"``,
with ``ops.ed25519.verify_batch_async`` raising. It raises what the
device route can raise: a CUDA error (``RuntimeError``), a kernel's
shape check (``ValueError``) or a kernel library that does not load
(``OSError``). The port's scheduler resolves such a ticket with a
``DeviceRouteError`` chained to that error (ROADMAP C3); the light
client must let it through as it is. It must not take it for a
verdict on a block:

- the skipping walk raises it and fetches no pivot: only
  ``ErrNotEnoughVotingPower`` from the trusting check makes it bisect;
- re-anchoring a trust root to a sparse persisted store (the skipping
  walk from the stored block below it) raises it, and does not report
  the root as conflicting or forged;
- ``check_against_witnesses`` raises it and keeps the witness, with no
  evidence reported, where a refused conflicting block would have
  removed the witness.

Each case runs once with the card working, as the control.
"""

import pytest
import torch

from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.crypto.scheduler import DeviceRouteError
from cometbft_tpu_torch.light import Client, LightStore, StoreBackedProvider, TrustOptions
from cometbft_tpu_torch.light.client import LightClientError
from cometbft_tpu_torch.light.detector import DivergenceError, check_against_witnesses
from cometbft_tpu_torch.node.inprocess import make_genesis
from cometbft_tpu_torch.ops import ed25519 as ops_ed
from cometbft_tpu_torch.utils.chaingen import make_chain

torch.set_num_threads(1)

CPU = "cpu"
CUDA_ERROR = "CUDA error: launch failed"
# what the stand-in card raises: None = it works (the control)
FAULTS = {
    "card_works": None,
    "cuda_error": RuntimeError(CUDA_ERROR),
    "shape_check": ValueError("ladder: rows 16 apart expected"),
    "library_load": OSError("libladder.so: cannot open shared object file"),
}


@pytest.fixture(autouse=True)
def pinned_device_route():
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    old_backend, old_floor = crypto_batch.default_backend(), crypto_batch._MIN_DEVICE_BATCH
    crypto_batch.set_default_backend("cuda")
    crypto_batch.set_min_device_batch(1)
    yield
    crypto_batch.set_default_backend(old_backend)
    crypto_batch.set_min_device_batch(old_floor)
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


@pytest.fixture
def card(monkeypatch):
    """``card["fault"] = <exception>`` makes every device dispatch raise it."""
    real = ops_ed.verify_batch_async
    state = {"fault": None, "failed": 0}

    def dispatch(items, device=None, precomp=None):
        if state["fault"] is not None:
            state["failed"] += 1
            raise state["fault"]
        return real(items, device=device, precomp=precomp)

    monkeypatch.setattr(ops_ed, "verify_batch_async", dispatch)
    return state


@pytest.fixture(scope="module")
def chains():
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    try:
        gen, privs = make_genesis(4, chain_id="c3-light", seed=13)
        return gen, make_chain(gen, privs, 30, device=CPU), make_chain(gen, privs, 12,
                                                                          txs_per_block=2, device=CPU)
    finally:
        pv.set_engine(None)
        eng.close()


class Recording(StoreBackedProvider):
    def __init__(self, node, chain_id):
        super().__init__(chain_id, node.block_store, node.state_store)
        self.fetched = []

    def light_block(self, height):
        self.fetched.append(height)
        return super().light_block(height)


def _client(gen, node, **kw):
    provider = Recording(node, gen.chain_id)
    root = provider.light_block(1)
    return Client(gen.chain_id, TrustOptions(10**18, 1, root.hash()), provider, device=CPU, **kw)


def _is_the_fault(err, fault):
    """The scheduler's one error type, chained to what the card raised."""
    return isinstance(err, DeviceRouteError) and err.__cause__ is fault


fault_cases = pytest.mark.parametrize("fault", list(FAULTS.values()), ids=list(FAULTS))


@fault_cases
def test_skipping_walk_raises_the_device_error_and_does_not_pivot(chains, card, fault):
    gen, src, _ = chains
    client = _client(gen, src)
    provider, before = client.primary, len(client.primary.fetched)
    card["fault"] = fault
    if fault is None:
        assert client.verify_light_block_at_height(30).height == 30
        assert client.hops == 1
        return
    with pytest.raises(DeviceRouteError) as e:
        client.verify_light_block_at_height(30)
    assert _is_the_fault(e.value, fault)
    assert card["failed"] >= 1
    # the target alone was fetched: no 9/16 pivot (it would be 17)
    assert provider.fetched[before:] == [30]
    assert client.hops == 0 and client.store.latest().height == 1


@fault_cases
def test_reanchoring_raises_the_device_error_and_reports_no_forged_root(chains, card, fault):
    gen, src, _ = chains
    first = _client(gen, src, store=LightStore())
    first.verify_light_block_at_height(9)
    store = first.store
    store.prune(1)  # height 9 alone: trust height 12 is re-anchored to it
    provider = Recording(src, gen.chain_id)
    opts = TrustOptions(10**18, 12, provider.light_block(12).hash())
    card["fault"] = fault
    if fault is None:
        Client(gen.chain_id, opts, provider, store=store, device=CPU)
        return
    with pytest.raises(DeviceRouteError) as e:
        Client(gen.chain_id, opts, provider, store=store, device=CPU)
    assert _is_the_fault(e.value, fault)
    assert not isinstance(e.value, LightClientError)
    assert card["failed"] >= 1


@fault_cases
def test_detector_raises_the_device_error_and_keeps_the_witness(chains, card, fault):
    gen, src, fork = chains
    witness = Recording(fork, gen.chain_id)
    client = _client(gen, src, witnesses=[witness])
    verified = client.primary.light_block(10)
    card["fault"] = fault
    if fault is None:
        # the fork is valid in itself: a divergence, the witness dropped
        with pytest.raises(DivergenceError):
            check_against_witnesses(client, verified, device=CPU)
        assert client.witnesses == []
        return
    with pytest.raises(DeviceRouteError) as e:
        check_against_witnesses(client, verified, device=CPU)
    assert _is_the_fault(e.value, fault)
    assert client.witnesses == [witness]
    assert witness.reported == [] and client.primary.reported == []
    assert card["failed"] >= 1
