"""Testnet manifests (reference test/e2e/pkg/manifest.go).

A copy of the JAX package's ``e2e/manifest.py``.

TOML schema:

    chain_id = "e2e-net"
    target_height = 20
    load_tx_rate = 5          # txs/sec across the net (0 = off)

    [node.validator0]         # any number of [node.X] tables
    mode = "validator"        # validator | full | seed | light (full = no key)
    power = 10
    start_at = 0              # join later (height); 0 = from genesis
    block_sync = false
    state_sync = false
    adaptive_sync = false
    mempool = "clist"         # clist | nop
    kill_at = 0               # perturbations: height to SIGKILL then restart
    pause_at = 0              # height to SIGSTOP for pause_s seconds
    pause_s = 3.0
    restart_delay_s = 2.0
    disconnect_at = 0         # height to drop all peers, reconnect after
    disconnect_s = 3.0        # how long to stay disconnected
"""

from __future__ import annotations

try:
    import tomllib
except ImportError:  # pragma: no cover - py<3.11: same-API backport
    import tomli as tomllib
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Perturbation:
    kind: str  # "kill" | "pause" | "disconnect" | "evidence" |
    #            "evidence_lca" | "upgrade"
    height: int
    pause_s: float = 3.0
    restart_delay_s: float = 2.0
    disconnect_s: float = 3.0
    upgrade_version: str = "0.2.0-upgrade"


@dataclass
class NodeSpec:
    name: str
    mode: str = "validator"
    power: int = 10
    start_at: int = 0
    block_sync: bool = False
    state_sync: bool = False
    adaptive_sync: bool = False
    mempool: str = "clist"
    db: str = "sqlite"  # sqlite | logdb (native engine) | memdb
    grpc: bool = False  # serve the legacy gRPC broadcast API
    perturbations: List[Perturbation] = field(default_factory=list)


@dataclass
class Manifest:
    chain_id: str = "e2e-net"
    target_height: int = 20
    load_tx_rate: float = 0.0
    nodes: Dict[str, NodeSpec] = field(default_factory=dict)

    @classmethod
    def load(cls, path: str) -> "Manifest":
        with open(path, "rb") as f:
            raw = tomllib.load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "Manifest":
        m = cls(
            chain_id=raw.get("chain_id", "e2e-net"),
            target_height=int(raw.get("target_height", 20)),
            load_tx_rate=float(raw.get("load_tx_rate", 0.0)),
        )
        for name, nd in (raw.get("node") or {}).items():
            spec = NodeSpec(
                name=name,
                mode=nd.get("mode", "validator"),
                power=int(nd.get("power", 10)),
                start_at=int(nd.get("start_at", 0)),
                block_sync=bool(nd.get("block_sync", False)),
                state_sync=bool(nd.get("state_sync", False)),
                adaptive_sync=bool(nd.get("adaptive_sync", False)),
                mempool=nd.get("mempool", "clist"),
                db=nd.get("db", "sqlite"),
                grpc=bool(nd.get("grpc", False)),
            )
            if nd.get("kill_at"):
                spec.perturbations.append(
                    Perturbation(
                        "kill",
                        int(nd["kill_at"]),
                        restart_delay_s=float(
                            nd.get("restart_delay_s", 2.0)
                        ),
                    )
                )
            if nd.get("pause_at"):
                spec.perturbations.append(
                    Perturbation(
                        "pause",
                        int(nd["pause_at"]),
                        pause_s=float(nd.get("pause_s", 3.0)),
                    )
                )
            if nd.get("disconnect_at"):
                spec.perturbations.append(
                    Perturbation(
                        "disconnect",
                        int(nd["disconnect_at"]),
                        disconnect_s=float(nd.get("disconnect_s", 3.0)),
                    )
                )
            if nd.get("upgrade_at"):
                # graceful stop + relaunch as a NEWER software version
                # (single-binary analog of the reference's docker-image
                # swap, testnet.go:62 PerturbationUpgrade +
                # runner/perturb.go:37)
                spec.perturbations.append(
                    Perturbation(
                        "upgrade",
                        int(nd["upgrade_at"]),
                        upgrade_version=nd.get(
                            "upgrade_version", "0.2.0-upgrade"
                        ),
                    )
                )
            if nd.get("evidence_at"):
                # this node's validator key equivocates: crafted
                # DuplicateVoteEvidence is injected via the
                # broadcast_evidence RPC (reference
                # test/e2e/runner/evidence.go:32)
                spec.perturbations.append(
                    Perturbation("evidence", int(nd["evidence_at"]))
                )
            if nd.get("evidence_lca_at"):
                # lunatic-fork LightClientAttackEvidence signed by a
                # >1/3-power subset of the net's validator keys
                # (runner._inject_lca_evidence)
                spec.perturbations.append(
                    Perturbation(
                        "evidence_lca", int(nd["evidence_lca_at"])
                    )
                )
            m.nodes[name] = spec
        if not m.nodes:
            raise ValueError("manifest has no nodes")
        for n in m.nodes.values():
            if n.mode == "light" and any(
                p.kind != "kill" for p in n.perturbations
            ):
                # the light daemon has no p2p/mempool/consensus to
                # pause/disconnect/upgrade/equivocate; only
                # kill+relaunch is meaningful (runner._launch_light)
                raise ValueError(
                    f"light node {n.name} supports only 'kill' "
                    "perturbations"
                )
        if not any(
            n.mode == "validator" and n.start_at == 0
            for n in m.nodes.values()
        ):
            raise ValueError("manifest needs a genesis validator")
        return m
