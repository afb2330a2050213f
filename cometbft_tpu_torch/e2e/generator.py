"""Randomized testnet manifest generator (reference
test/e2e/generator/generate.go + random.go).

A copy of the JAX package's ``e2e/generator.py``: a seed gives the
JAX package's manifest.

Generates deterministic pseudo-random manifests from a seed, covering
the combination space: topology (single / quad / large), sync modes
(blocksync, adaptive ingest, statesync late joiners), storage backend
(sqlite / native logdb), mempool type, tx load, and perturbations
(kill/restart, pause, disconnect, evidence injection, upgrade). A seed
fully determines the manifest, so any failing generated net is
reproducible from its seed alone.
"""

from __future__ import annotations

import random
from typing import List

from .manifest import Manifest, NodeSpec, Perturbation

TOPOLOGIES = ("single", "quad", "large")
DBS = ("sqlite", "logdb")


def _perturb(rng: random.Random, spec: NodeSpec, target: int, is_val: bool):
    """At most one perturbation per node (keeps runs bounded)."""
    lo, hi = 3, max(4, target - 4)
    roll = rng.random()
    if roll < 0.15:
        spec.perturbations.append(
            Perturbation("kill", rng.randint(lo, hi), restart_delay_s=1.0)
        )
    elif roll < 0.30:
        spec.perturbations.append(
            Perturbation("pause", rng.randint(lo, hi), pause_s=2.0)
        )
    elif roll < 0.45:
        spec.perturbations.append(
            Perturbation(
                "disconnect", rng.randint(lo, hi), disconnect_s=2.0
            )
        )
    elif roll < 0.55 and is_val:
        # 60/40 split: duplicate-vote equivocation vs a lunatic-fork
        # light-client attack (both land as committed evidence + ABCI
        # misbehavior; the runner crafts each from the real validator
        # keys)
        kind = "evidence" if rng.random() < 0.6 else "evidence_lca"
        spec.perturbations.append(
            Perturbation(kind, rng.randint(lo, hi))
        )
    elif roll < 0.65:
        # graceful binary-swap restart (reference testnet.go:62
        # PerturbationUpgrade)
        spec.perturbations.append(
            Perturbation("upgrade", rng.randint(lo, hi))
        )


def generate_one(seed: int) -> Manifest:
    rng = random.Random(seed)
    topology = rng.choice(TOPOLOGIES)
    target = rng.randint(8, 14)
    m = Manifest(
        chain_id=f"gen-{seed}",
        target_height=target,
        load_tx_rate=rng.choice((0.0, 2.0, 5.0)),
    )

    n_vals = {"single": 1, "quad": 4, "large": 4}[topology]
    for i in range(n_vals):
        spec = NodeSpec(
            name=f"val{i}",
            mode="validator",
            power=rng.choice((10, 10, 10, 5, 20)),
            db=rng.choice(DBS),
            grpc=rng.random() < 0.35,
        )
        # a single-validator net must keep its only proposer alive
        if n_vals > 1:
            # evidence needs a second running node to receive it
            _perturb(rng, spec, target, is_val=n_vals > 2)
        m.nodes[spec.name] = spec

    if topology == "large":
        for j in range(rng.randint(1, 3)):
            late = rng.random() < 0.6
            spec = NodeSpec(
                name=f"full{j}",
                mode="full",
                start_at=rng.randint(4, 6) if late else 0,
                db=rng.choice(DBS),
                mempool=rng.choice(("clist", "nop")),
            )
            if late:
                spec.block_sync = True
                spec.adaptive_sync = rng.random() < 0.5
            else:
                _perturb(rng, spec, target, is_val=False)
            m.nodes[spec.name] = spec
        if rng.random() < 0.4:
            # a LIGHT node: the verifying RPC proxy daemon, trust-
            # rooted once the chain is a few blocks tall; the runner's
            # status/agreement assertions then exercise the light-
            # verified path end to end
            m.nodes["light0"] = NodeSpec(
                name="light0",
                mode="light",
                start_at=rng.randint(3, 5),
            )

    return m


def generate(seed: int, count: int = 1) -> List[Manifest]:
    """count manifests derived deterministically from one seed."""
    return [generate_one(seed * 1000 + k) for k in range(count)]
