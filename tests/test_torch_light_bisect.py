"""BASELINE config 4 in both packages: the light client's bisection.

150 validators of power 10 (keys from ``default_rng(7)``, then a pool
from ``default_rng(99)``), a target 50,000 heights above the trust
root, validator sets rotating by 60 keys every 2,500 heights, the
default trust level of 1/3: the shape of the JAX package's
``bench.py::bench_bisect``. Headers are minted on demand by a provider
in each package (the port's ``utils.chaingen.RotatingLightProvider``,
a copy of the bench's provider here for the JAX package) from one
clock anchor, ``now - (50,000 + 120) s``, with a 10-year trusting
period.

The port runs on ``device="cpu"`` (the host plane), the JAX package
on its "cpu" backend. Both must fetch the same heights in the same
order (the 22 below), take the same 20 hops, submit the same 49
verify tickets with the same labels and widths (cache hits skipped),
end with the same 2,199 signature-cache entries and trust the same
final hash; with one signature forged at pivot 2,816 or at the target
both must refuse at that height with the same exception; and a fork
that is valid in itself, served by a witness, must make both halt with
the same light-client-attack evidence (timestamp aside).
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from cometbft_tpu import types as JT
from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto import scheduler as jsched
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.light import verifier as jverifier
from cometbft_tpu.light.client import Client as JClient
from cometbft_tpu.light.client import TrustOptions as JTrust
from cometbft_tpu.light.detector import DivergenceError as JDivergence
from cometbft_tpu.light.provider import Provider as JProvider
from cometbft_tpu.light.types import LightBlock as JLightBlock
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.light import verifier
from cometbft_tpu_torch.light.client import Client, TrustOptions
from cometbft_tpu_torch.light.detector import DivergenceError
from cometbft_tpu_torch.utils.chaingen import RotatingLightProvider

torch.set_num_threads(1)

CPU = "cpu"
CHAIN_ID = "bench-chain"
N_VALS = 150
TARGET = 50_000
EPOCH = 2_500
SHIFT = 60
PERIOD_NS = 10 * 365 * 86400 * 10**9
T0_NS = time.time_ns() - (TARGET + 120) * 1_000_000_000
FORK_APP_HASH = b"\x0f" * 32

# the JAX package's run of this shape on the host backend
REF_FETCHED = [1, 1, 50000, 28125, 15820, 8899, 5006, 2816, 12792, 11088, 22741, 19713,
               21416, 25769, 40429, 35046, 32018, 33721, 38073, 45812, 43456, 48167]
REF_HOPS = 20
REF_DISPATCHES = 49
REF_CACHE = 2199


def _seeds():
    rng = np.random.default_rng(7)
    seeds = [rng.bytes(32) for _ in range(N_VALS)]
    rng = np.random.default_rng(99)
    n_keys = (TARGET // EPOCH + 2) * SHIFT + N_VALS
    return seeds + [rng.bytes(32) for _ in range(n_keys - N_VALS)]


SEEDS = _seeds()


class JaxRotatingProvider(JProvider):
    """The bench's SyntheticProvider in the JAX package, with the same
    adversaries as the port's ``RotatingLightProvider``."""

    def __init__(self, keys, forge_at=(), app_hash=b""):
        self.chain_id = CHAIN_ID
        self.keys = keys
        self.forge_at = set(forge_at)
        self.app_hash = app_hash
        self.fetched = []
        self.reported = []
        self._sets = {}
        self._by_addr = {k.pub_key().address(): k for k in keys}

    def vals_at(self, height):
        e = height // EPOCH
        if e not in self._sets:
            window = self.keys[e * SHIFT : e * SHIFT + N_VALS]
            self._sets[e] = JT.ValidatorSet([JT.Validator(k.pub_key(), 10) for k in window])
        return self._sets[e]

    def light_block(self, height):
        self.fetched.append(height)
        vals = self.vals_at(height)
        h = JT.Header(
            chain_id=CHAIN_ID,
            height=height,
            time_ns=T0_NS + height * 1_000_000_000,
            validators_hash=vals.hash(),
            next_validators_hash=self.vals_at(height + 1).hash(),
            app_hash=self.app_hash,
        )
        bid = JT.BlockID(h.hash(), JT.PartSetHeader(1, h.hash()))
        sigs = []
        for i, val in enumerate(vals.validators):
            v = JT.Vote(type_=JT.PRECOMMIT, height=height, round=0, block_id=bid,
                        timestamp_ns=h.time_ns, validator_address=val.address,
                        validator_index=i)
            sig = self._by_addr[val.address].sign(v.sign_bytes(CHAIN_ID))
            if i == 0 and height in self.forge_at:
                sig = bytes([sig[0] ^ 1]) + sig[1:]
            sigs.append(JT.CommitSig(block_id_flag=JT.BLOCK_ID_FLAG_COMMIT,
                                     validator_address=val.address,
                                     timestamp_ns=h.time_ns, signature=sig))
        return JLightBlock(h, JT.Commit(height=height, round=0, block_id=bid, signatures=sigs),
                           vals)

    def report_evidence(self, ev):
        self.reported.append(ev)


@pytest.fixture(scope="module")
def keys():
    return ([Ed25519PrivKey.from_seed(s) for s in SEEDS], [JPriv.from_seed(s) for s in SEEDS])


def _run(make_client, provider, sched, verifier_mod, witness=None):
    """Trust height 1, verify the target; returns what the run did:
    ``at`` is the height of the last block a hop checked."""
    dispatches = []
    checked = []
    real = sched.submit
    reals = {name: getattr(verifier_mod, name) for name in ("verify_adjacent", "verify_non_adjacent")}

    def submit(items, **kw):
        dispatches.append((kw.get("label"), len(items)))
        return real(items, **kw)

    def recording(fn):
        def hop(chain_id, trusted, *args, **kw):
            checked.append((args[1] if fn is reals["verify_non_adjacent"] else args[0]).height)
            return fn(chain_id, trusted, *args, **kw)
        return hop

    sched.submit = submit
    for name, fn in reals.items():
        setattr(verifier_mod, name, recording(fn))
    out = {"dispatches": dispatches, "error": None}
    try:
        root = provider.light_block(1)
        client = make_client(root.hash(), provider, [witness] if witness else [])
        out["client"] = client
        lb = client.verify_light_block_at_height(TARGET)
        out["hash"] = bytes(lb.hash())
    except Exception as e:  # the refusal cases: which error, at which height
        out["error"] = e
    finally:
        del sched.submit
        for name, fn in reals.items():
            setattr(verifier_mod, name, fn)
    out["fetched"] = list(provider.fetched)
    out["at"] = checked[-1] if checked else None
    if "client" in out:
        out["hops"] = out["client"].hops
        out["cache"] = len(out["client"].cache)
    return out


def run_port(keys, forge_at=(), fork=False):
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    sched = sched_mod.VerifyScheduler()
    sched_mod.set_scheduler(sched)

    def provider(**kw):
        return RotatingLightProvider(CHAIN_ID, keys, N_VALS, EPOCH, SHIFT, T0_NS, **kw)

    try:
        return _run(
            lambda h, p, w: Client(CHAIN_ID, TrustOptions(PERIOD_NS, 1, h), p, witnesses=w,
                                   device=CPU),
            provider(forge_at=forge_at), sched, verifier,
            witness=provider(app_hash=FORK_APP_HASH) if fork else None)
    finally:
        sched_mod.set_scheduler(None)
        sched.close()
        pv.set_engine(None)
        eng.close()


def run_jax(keys, forge_at=(), fork=False):
    old = jbatch._default_backend
    jbatch.set_default_backend("cpu")
    try:
        return _run(
            lambda h, p, w: JClient(CHAIN_ID, JTrust(PERIOD_NS, 1, h), p, witnesses=w),
            JaxRotatingProvider(keys, forge_at=forge_at), jsched.scheduler(), jverifier,
            witness=JaxRotatingProvider(keys, app_hash=FORK_APP_HASH) if fork else None)
    finally:
        jbatch.set_default_backend(old)


@pytest.fixture(scope="module")
def clean(keys):
    return run_port(keys[0]), run_jax(keys[1])


def test_bisection_fetches_the_same_heights(clean):
    port, jax = clean
    assert port["error"] is None and jax["error"] is None
    assert port["fetched"] == jax["fetched"] == REF_FETCHED
    assert port["hops"] == jax["hops"] == REF_HOPS


def test_bisection_submits_the_same_dispatches(clean):
    port, jax = clean
    assert port["dispatches"] == jax["dispatches"]
    assert len(port["dispatches"]) == REF_DISPATCHES
    assert {label for label, _ in port["dispatches"]} == {"light", "trusting"}
    widths = [n for _, n in port["dispatches"]]
    assert port["dispatches"][0] == ("light", 101)
    assert min(widths) == 30 and max(widths) == 101


def test_bisection_ends_with_the_same_cache_and_trusted_hash(clean):
    port, jax = clean
    assert port["cache"] == jax["cache"] == REF_CACHE
    assert port["hash"] == jax["hash"]
    assert port["client"].trusted_light_block().height == TARGET
    # every pivot the walk verified is in both trusted stores
    assert sorted(port["client"].store._by_height) == sorted(jax["client"].store._by_height)


@pytest.mark.parametrize("forge_at", [2816, TARGET])
def test_forged_signature_refused_at_the_same_height(keys, forge_at):
    port, jax = run_port(keys[0], forge_at=(forge_at,)), run_jax(keys[1], forge_at=(forge_at,))
    assert port["error"] is not None and jax["error"] is not None
    assert type(port["error"]).__name__ == type(jax["error"]).__name__ == "ErrInvalidSignature"
    assert str(port["error"]) == str(jax["error"])
    assert port["at"] == jax["at"] == forge_at
    assert port["fetched"] == jax["fetched"]


def test_diverging_witness_halts_with_the_same_evidence(keys):
    port, jax = run_port(keys[0], fork=True), run_jax(keys[1], fork=True)
    assert isinstance(port["error"], DivergenceError)
    assert isinstance(jax["error"], JDivergence)
    ev, jev = port["error"].evidence, jax["error"].evidence
    assert ev.conflicting_block.height == TARGET
    assert ev.common_height == jev.common_height == REF_FETCHED[-1]
    assert len(ev.byzantine_validators) == len(jev.byzantine_validators) > 0
    # the timestamp is the detector's clock; everything else is equal
    assert (dataclasses.replace(ev, timestamp_ns=0).encode()
            == dataclasses.replace(jev, timestamp_ns=0).encode())
    assert port["client"].witnesses == []
