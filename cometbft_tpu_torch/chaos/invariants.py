"""BFT invariant checkers for chaos runs.

A copy of the JAX package's ``chaos/invariants.py``.

Three invariants, matching the protocol's formal claims (the
agreement/liveness properties formalized for this family in "A
Tendermint Light Client", arxiv 2010.07031):

- **Agreement** — no two honest nodes commit different block IDs at
  the same height, under any <1/3-fault schedule. Checked
  incrementally while the run progresses AND with a full re-scan at
  end-of-run (the re-scan also catches post-hoc store corruption the
  incremental pass already certified — which is exactly how the
  injected byzantine mutation is detected).
- **Liveness** — after the last heal/restart the network height
  advances within a bound.
- **WAL-replay consistency** — a crash/restart loses no committed
  block and changes no committed block ID: the restarted node's store
  must extend its pre-crash prefix byte-for-byte.

Violations carry enough context (heights, node monikers, hex block
IDs) that together with the run's seed + schedule the exact failure
replays.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class InvariantViolation(AssertionError):
    def __init__(self, invariant: str, detail: str):
        super().__init__(f"[{invariant}] {detail}")
        self.invariant = invariant
        self.detail = detail


class AgreementChecker:
    """Tracks the first-seen committed block ID per height across all
    (assumed-honest) nodes; any disagreement is a violation."""

    def __init__(self):
        self._seen: Dict[int, Tuple[bytes, str]] = {}  # h -> (hash, who)
        self._progress: Dict[str, int] = {}  # node name -> checked up to

    def _check_one(self, name: str, height: int, got: Optional[bytes]):
        if got is None:
            return
        prev = self._seen.get(height)
        if prev is None:
            self._seen[height] = (got, name)
        elif prev[0] != got:
            raise InvariantViolation(
                "agreement",
                f"height {height}: {name} committed {got.hex()[:16]} "
                f"but {prev[1]} committed {prev[0].hex()[:16]}",
            )

    def check(self, nodes) -> None:
        """Incremental pass: only heights committed since last call.
        ``nodes``: iterable of (name, node) with node.block_id_hash_at
        + node.height (chaos/net.py running nodes)."""
        for name, node in nodes:
            start = self._progress.get(name, 0) + 1
            top = node.height
            for h in range(start, top + 1):
                self._check_one(name, h, node.block_id_hash_at(h))
            self._progress[name] = max(
                self._progress.get(name, 0), top
            )

    def final_check(self, nodes) -> None:
        """Authoritative end-of-run pass: re-scan EVERY height from
        scratch so nothing certified earlier escapes re-inspection."""
        self._seen.clear()
        self._progress.clear()
        for name, node in nodes:
            for h in range(1, node.height + 1):
                self._check_one(name, h, node.block_id_hash_at(h))


class WALReplayChecker:
    """Crash/restart consistency: snapshot the committed chain before
    a crash, require the restarted node to extend it unchanged."""

    def __init__(self):
        self.checks = 0

    @staticmethod
    def pre_crash(node) -> Dict[int, bytes]:
        return {
            h: node.block_id_hash_at(h)
            for h in range(1, node.height + 1)
        }

    def post_restart(self, name: str, node, snapshot: Dict[int, bytes]):
        self.checks += 1
        if snapshot and node.height < max(snapshot):
            raise InvariantViolation(
                "wal-replay",
                f"{name} lost committed blocks in crash/restart: "
                f"height {node.height} < pre-crash {max(snapshot)}",
            )
        for h, want in snapshot.items():
            got = node.block_id_hash_at(h)
            if got != want:
                raise InvariantViolation(
                    "wal-replay",
                    f"{name} height {h} changed across restart: "
                    f"{None if got is None else got.hex()[:16]} != "
                    f"{want.hex()[:16]}",
                )


def liveness_violation(
    heights: Dict[str, int], target: int, bound_s: float
) -> InvariantViolation:
    lag = {n: h for n, h in heights.items() if h < target}
    return InvariantViolation(
        "liveness",
        f"height {target} not reached within {bound_s:.0f}s after the "
        f"last heal: lagging {lag}",
    )
