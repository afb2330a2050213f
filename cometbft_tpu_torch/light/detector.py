"""Divergence detection against witness providers (reference light/detector.go).

After verifying a header from the primary, compare it against every
witness at the same height. Outcomes per witness (reference
light/client.go:1098-1185 compareFirstLightBlockWithWitnesses):

- agreement: strikes cleared, witness stays;
- unreachable / no block: a consecutive-failure strike; the witness
  is pruned from rotation after Client.MAX_WITNESS_STRIKES;
- INVALID conflicting block (fails validate_basic or its own commit
  check): the witness is lying in a provable way — removed
  immediately, no evidence (reference errBadWitness);
- VALID conflicting block: a real light-client attack on one side —
  LCA evidence is built and reported to every provider, the diverging
  witness is dropped from rotation, and DivergenceError halts the
  caller (reference ErrConflictingHeaders stops the client; operator
  must decide whom to trust).

The port of the JAX package's ``light/detector.py``. The witness's
commit is checked on ``device`` (``None`` = the GPU, which raises
without one; the client passes its own). Departure (ROADMAP C3): the
JAX detector removes a witness on any failure of that check; here a
failed verify route (``DeviceRouteError``, whatever its cause) raises
as it is and leaves the witness in place, and every other failure
removes it, as there.
"""

from __future__ import annotations

import time
from typing import List

from ..crypto.scheduler import DeviceRouteError
from ..device import resolve
from ..evidence.types import LightClientAttackEvidence
from ..types.validation import verify_commit_light
from .types import LightBlock


class DivergenceError(Exception):
    def __init__(self, witness_idx: int, evidence):
        super().__init__(f"witness {witness_idx} diverged")
        self.witness_idx = witness_idx
        self.evidence = evidence


class ProposerPrioritiesDivergeError(Exception):
    """Headers agree but the derived proposer priorities do not
    (reference ErrProposerPrioritiesDiverge): priorities are NOT
    committed in the header, so a lying side cannot be attributed —
    the client halts and the operator picks whom to trust."""

    def __init__(self, witness_idx: int):
        super().__init__(
            f"witness {witness_idx} reports identical header but "
            "conflicting proposer priorities"
        )
        self.witness_idx = witness_idx


def _priorities_diverge(a, b) -> bool:
    """Same valset hash is guaranteed by the header match; compare the
    per-validator priorities (address-keyed — ordering is canonical)."""
    pa = {v.address: v.proposer_priority for v in a.validators}
    pb = {v.address: v.proposer_priority for v in b.validators}
    return pa != pb


def check_against_witnesses(client, verified: LightBlock, device=None) -> None:
    device = resolve(device)
    bad: List[int] = []
    diverged = None  # (idx, evidence)
    for i, w in enumerate(client.witnesses):
        try:
            wlb = w.light_block(verified.height)
        except Exception:
            # unreachable or blockless: benign once, pruned when
            # persistent (reference treats no-response as benign per
            # call; rotation hygiene is the client's strike policy)
            if client.note_witness_failure(w):
                bad.append(i)
            continue
        client.clear_witness_failures(w)
        if wlb.hash() == verified.hash():
            # addresses/powers ARE header-committed: a witness whose
            # valset does not hash to the agreed header's
            # validators_hash is provably lying — remove it (reference
            # errBadWitness), never halt on it. Only a VALID valset
            # with different priorities (the one field the header does
            # not commit) is unattributable and halts.
            if bytes(wlb.validator_set.hash()) != bytes(
                wlb.header.validators_hash
            ):
                bad.append(i)
            elif _priorities_diverge(
                wlb.validator_set, verified.validator_set
            ):
                # clean up staged removals before halting — struck-out
                # witnesses must not survive because a later witness
                # halted the pass
                try:
                    client.remove_witnesses(bad)
                except Exception:
                    pass
                raise ProposerPrioritiesDivergeError(i)
            continue
        # conflicting header: is the witness's block even SELF-valid?
        try:
            wlb.validate_basic(client.chain_id)
            verify_commit_light(
                client.chain_id,
                wlb.validator_set,
                wlb.commit.block_id,
                wlb.height,
                wlb.commit,
                cache=client.cache,
                device=device,
            )
        except DeviceRouteError:
            # no verdict on the block: the card failed (C3)
            raise
        except Exception:
            # provably bad witness (invalid conflicting block):
            # removed, no evidence — nothing here implicates the
            # primary (reference errBadWitness)
            bad.append(i)
            continue
        # genuine divergence: the detector cannot know which side is
        # attacking, so it builds evidence in BOTH directions against
        # the last trusted common header (reference detector.go
        # evAgainstPrimary / evAgainstWitness): the primary receives
        # the witness's block as the suspect, every witness receives
        # the primary's. An honest full node keeps only the evidence
        # whose conflicting block actually conflicts with its chain
        # (evidence/pool._verify_lca rejects the other).
        common = client.store.latest_before(verified.height)
        common_vals = (
            common.validator_set if common else verified.validator_set
        )
        common_height = (
            common.height if common else verified.height - 1
        )

        def _evidence(conflicting):
            ev = LightClientAttackEvidence(
                conflicting_block=conflicting,
                common_height=common_height,
                total_voting_power=common_vals.total_voting_power(),
                timestamp_ns=time.time_ns(),
            )
            # the byzantine set is DERIVED, and receiving pools
            # re-derive it and reject a mismatch (reference
            # evidence/verify.go:124-136)
            ev.byzantine_validators = ev.byzantine_from(common_vals)
            return ev

        ev_against_primary = _evidence(verified)
        ev_against_witness = _evidence(wlb)
        try:
            client.primary.report_evidence(ev_against_witness)
        except Exception:
            pass
        for p in client.witnesses:
            try:
                p.report_evidence(ev_against_primary)
            except Exception:
                pass
        diverged = (i, ev_against_primary)
        bad.append(i)
        break
    if diverged is not None:
        idx, ev = diverged
        try:
            client.remove_witnesses(bad)
        except Exception:
            # set emptied by the removal: the divergence error is the
            # more actionable signal
            pass
        raise DivergenceError(idx, ev)
    client.remove_witnesses(bad)
