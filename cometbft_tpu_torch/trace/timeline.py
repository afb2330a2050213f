"""Cross-node causal timelines (docs/TRACE.md "Cross-node
timelines").

Every ring records monotonic-ns timestamps, which are meaningless
across processes. Node assembly (node/inprocess.py
``record_clock_anchor`` — deliberately outside this package: nothing
in trace/ reads the wall clock) stamps each ring with ONE
monotonic→wall anchor: a ``clock.anchor`` instant whose ``ts_ns`` is
a monotonic read and whose ``args.wall_ns`` is the wall clock read
back-to-back with it. This module rebases every ring onto the shared
wall axis (then zeroes at the earliest event so Perfetto opens at
t=0), merges them into one causally-ordered view, and computes the
per-height **commit-latency waterfall** from the correlated
send/recv instants the p2p stamping plane (p2p/tracewire.py) and the
consensus attribution marks (consensus/state.py) record:

    proposal propagation -> block-part gossip -> time-to-2/3 prevote
    -> time-to-2/3 precommit -> verify -> wal.fsync -> finalize

Alignment caveat (docs/TRACE.md): anchors are only as good as the
nodes' wall clocks. In-process nets (LocalNet, Nodes in one process) share one
clock, so rebased instants are exact; across hosts the residual
error is the NTP skew between them. Rings missing an anchor (ancient
dumps, laps that also outran ``Tracer.meta`` injection) borrow the
median offset of the anchored rings — right for one process, flagged
in the output either way.

A copy of the JAX package's ``trace/timeline.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

ANCHOR_EVENT = "clock.anchor"

EventsByNode = Dict[str, List[dict]]


# --- clock rebasing ------------------------------------------------------


def anchor_offsets(events_by_node: EventsByNode) -> Dict[str, Optional[int]]:
    """{node: wall_ns - mono_ns} from each ring's ``clock.anchor``
    instant; None for rings that never recorded one."""
    out: Dict[str, Optional[int]] = {}
    for node, events in events_by_node.items():
        off = None
        for e in events:
            if e.get("name") == ANCHOR_EVENT:
                wall = (e.get("args") or {}).get("wall_ns")
                if wall is not None:
                    off = int(wall) - int(e["ts_ns"])
                    break
        out[node] = off
    return out


def rebase(
    events_by_node: EventsByNode,
) -> Tuple[EventsByNode, Dict[str, Optional[int]], int]:
    """Rebase every ring onto one shared time axis.

    Returns ``(rebased, offsets, base_wall_ns)``: event copies whose
    ``ts_ns`` is wall-anchored and zeroed at the earliest event
    (stable-sorted by timestamp per node), the per-node raw offsets
    (None marks a ring that borrowed the median), and the wall-ns
    origin the zero corresponds to."""
    offsets = anchor_offsets(events_by_node)
    known = sorted(o for o in offsets.values() if o is not None)
    # same-process fallback: the median anchored offset (0 when no
    # ring is anchored at all — raw monotonic is then the best axis)
    fallback = known[len(known) // 2] if known else 0
    rebased: EventsByNode = {}
    base = None
    for node, events in events_by_node.items():
        off = offsets[node]
        eff = fallback if off is None else off
        evs = [dict(e, ts_ns=e["ts_ns"] + eff) for e in events]
        evs.sort(key=lambda e: e["ts_ns"])  # stable: ties keep order
        rebased[node] = evs
        if evs and (base is None or evs[0]["ts_ns"] < base):
            base = evs[0]["ts_ns"]
    base = base or 0
    for evs in rebased.values():
        for e in evs:
            e["ts_ns"] -= base
    return rebased, offsets, base


def merge_events(rebased: EventsByNode) -> List[dict]:
    """One flat causally-ordered stream: rebased events from every
    ring, each tagged with its node, stable-sorted by timestamp."""
    flat = [
        dict(e, node=node)
        for node in sorted(rebased)
        for e in rebased[node]
    ]
    flat.sort(key=lambda e: e["ts_ns"])  # stable within equal stamps
    return flat


# --- per-height commit-latency attribution -------------------------------


def _harg(e: dict) -> Optional[int]:
    """Height from either arg spelling (spans say ``height``, the
    compact p2p instants say ``h``)."""
    a = e.get("args") or {}
    h = a.get("height", a.get("h"))
    return int(h) if h is not None else None


def attribute_heights(events_by_node: EventsByNode) -> Dict[int, dict]:
    """The per-height commit-latency waterfall over already-rebased
    rings (call ``rebase`` first; raw monotonic input still works for
    single-process dumps).

    A height is attributed when any ring finalized it. Its chain is
    ``complete`` when the proposal send on the proposer correlates to
    an arrival on every other committing node (a proposal/part recv
    or, for catch-up commits, a ``commit_block`` recv) and both
    quorum legs were measured. All ms values are relative to the
    proposal send instant except the per-node quorum durations, which
    are time-from-round-entry as recorded on each node."""
    ms = 1e6
    heights: Dict[int, dict] = {}

    def slot(h: int) -> dict:
        return heights.setdefault(
            h,
            {
                "height": h,
                "proposer": None,
                "proposal_send_ns": None,
                "proposal_recv": {},  # node -> earliest proposal recv
                "part_recv": {},  # node -> earliest block_part recv
                "catchup_recv": {},  # node -> commit_block recv ns
                "proposal_complete": {},  # node -> instant ns
                "quorum_prevote_ms": {},  # node -> dur ms
                "quorum_precommit_ms": {},
                "verify_ms": {},
                "finalize": {},  # node -> {total/persist/wal/apply}
                "committed": [],
            },
        )

    for node, events in events_by_node.items():
        for e in events:
            name = e.get("name")
            if name == "p2p.msg.send":
                a = e.get("args") or {}
                if a.get("kind") == "proposal":
                    h = _harg(e)
                    if h is None:
                        continue
                    s = slot(h)
                    # earliest proposal send = the proposer's own
                    # broadcast (relays come later by causality)
                    if (
                        s["proposal_send_ns"] is None
                        or e["ts_ns"] < s["proposal_send_ns"]
                    ):
                        s["proposal_send_ns"] = e["ts_ns"]
                        s["proposer"] = node
            elif name == "p2p.msg.recv":
                a = e.get("args") or {}
                kind = a.get("kind")
                h = _harg(e)
                if h is None:
                    continue
                if kind in ("proposal", "block_part"):
                    d = slot(h)[
                        "proposal_recv" if kind == "proposal"
                        else "part_recv"
                    ]
                    if node not in d or e["ts_ns"] < d[node]:
                        d[node] = e["ts_ns"]
                elif kind == "commit_block":
                    d = slot(h)["catchup_recv"]
                    if node not in d or e["ts_ns"] < d[node]:
                        d[node] = e["ts_ns"]
            elif name == "consensus.proposal.complete":
                h = _harg(e)
                if h is not None:
                    slot(h)["proposal_complete"][node] = e["ts_ns"]
            elif name in (
                "consensus.quorum.prevote",
                "consensus.quorum.precommit",
            ):
                h = _harg(e)
                if h is None:
                    continue
                key = (
                    "quorum_prevote_ms"
                    if name.endswith("prevote")
                    else "quorum_precommit_ms"
                )
                slot(h)[key][node] = round(e.get("dur_ns", 0) / ms, 3)
            elif name == "consensus.verify":
                h = _harg(e)
                if h is not None:
                    slot(h)["verify_ms"][node] = round(
                        e.get("dur_ns", 0) / ms, 3
                    )
            elif name == "consensus.finalize":
                h = _harg(e)
                if h is None:
                    continue
                a = e.get("args") or {}
                s = slot(h)
                s["finalize"][node] = {
                    "total_ms": round(e.get("dur_ns", 0) / ms, 3),
                    "persist_ms": a.get("persist_ms"),
                    "wal_ms": a.get("wal_ms"),
                    "apply_ms": a.get("apply_ms"),
                }
                s["committed"].append(node)

    # derive the waterfall legs + completeness per committed height
    out: Dict[int, dict] = {}
    for h in sorted(heights):
        s = heights[h]
        if not s["committed"]:
            continue  # gossip about a height nobody (visible) committed
        s["committed"] = sorted(set(s["committed"]))
        send = s["proposal_send_ns"]
        if send is not None:
            s["propagation_ms"] = {
                n: round((t - send) / ms, 3)
                for n, t in sorted(s["proposal_recv"].items())
                if n != s["proposer"]
            }
            s["parts_ms"] = {
                n: round((t - send) / ms, 3)
                for n, t in sorted(s["proposal_complete"].items())
            }
        else:
            s["propagation_ms"] = {}
            s["parts_ms"] = {}
        missing = []
        for n in s["committed"]:
            if n == s["proposer"]:
                continue
            if (
                n not in s["proposal_recv"]
                and n not in s["part_recv"]
                and n not in s["proposal_complete"]
                and n not in s["catchup_recv"]
            ):
                missing.append(n)
        s["missing_arrival"] = missing
        s["complete"] = bool(
            s["proposer"] is not None
            and not missing
            and s["quorum_prevote_ms"]
            and s["quorum_precommit_ms"]
        )
        # the internal correlation keys aren't part of the report
        for k in (
            "proposal_recv", "part_recv", "catchup_recv",
            "proposal_complete",
        ):
            s.pop(k)
        out[h] = s
    return out


def attribution_key(heights: Dict[int, dict]) -> List[tuple]:
    """The deterministic skeleton of an attribution table: per height
    the proposer, the committing nodes and chain completeness — what
    same-seed runs reproduce exactly (latency columns are wall-clock
    and jitter run to run)."""
    return [
        (
            h,
            s["proposer"],
            tuple(s["committed"]),
            s["complete"],
        )
        for h, s in sorted(heights.items())
    ]


def format_waterfall(heights: Dict[int, dict]) -> str:
    """The per-height attribution table the timeline CLI prints: worst
    (max-over-nodes) value per leg, in waterfall order."""
    if not heights:
        return "no committed heights found in the trace"

    def mx(d):
        vals = [v for v in d.values() if v is not None]
        return f"{max(vals):.1f}" if vals else "-"

    hdr = (
        f"{'height':>6} {'proposer':<10} {'prop ms':>8} {'parts ms':>9} "
        f"{'prevote ms':>11} {'precommit ms':>13} {'verify ms':>10} "
        f"{'wal ms':>7} {'final ms':>9} {'nodes':>6} chain"
    )
    lines = [hdr]
    for h in sorted(heights):
        s = heights[h]
        fin = s["finalize"]
        wal = {n: f.get("wal_ms") for n, f in fin.items()}
        tot = {n: f.get("total_ms") for n, f in fin.items()}
        lines.append(
            f"{h:>6} {s['proposer'] or '?':<10} "
            f"{mx(s['propagation_ms']):>8} {mx(s['parts_ms']):>9} "
            f"{mx(s['quorum_prevote_ms']):>11} "
            f"{mx(s['quorum_precommit_ms']):>13} "
            f"{mx(s['verify_ms']):>10} {mx(wal):>7} {mx(tot):>9} "
            f"{len(s['committed']):>6} "
            + ("complete" if s["complete"] else "PARTIAL")
        )
    n_partial = sum(1 for s in heights.values() if not s["complete"])
    lines.append(
        f"attribution: {len(heights)} heights, "
        + (
            "all chains complete"
            if n_partial == 0
            else f"{n_partial} PARTIAL chains"
        )
    )
    return "\n".join(lines)
