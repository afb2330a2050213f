"""Trace export: JSONL (native dump format) and Chrome trace-event
JSON (loadable in Perfetto / chrome://tracing).

JSONL is one event object per line with the owning node name embedded
(`{"node": ..., "seq": ..., "name": ..., "ph": ..., "ts_ns": ...,
"dur_ns": ..., "tid": ..., "args": {...}}`), so files from different
nodes concatenate and re-split trivially.

The Chrome format maps node → pid and track → tid with "M" metadata
events naming both; complete spans are "X" events (ts/dur in
microseconds — the format's unit), instants "i", counters "C".
Timestamps are monotonic ns shared by every tracer in one process, so
multi-node in-process runs (LocalNet, a net of Nodes) land on one
aligned timeline.

A copy of the JAX package's ``trace/export.py``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List

EventsByNode = Dict[str, List[dict]]


# --- JSONL ---------------------------------------------------------------


def write_jsonl(path: str, node: str, events: Iterable[dict]) -> str:
    """Write one node's events as JSONL; returns the path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps({"node": node, **e}) + "\n")
    return path


def read_jsonl(paths: Iterable[str]) -> EventsByNode:
    """Load JSONL trace files (or directories of ``*.jsonl``) into
    {node: [events]}; events keep file order (writers emit
    seq-sorted)."""
    out: EventsByNode = {}
    for p in _expand(paths):
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                e = json.loads(line)
                node = e.pop("node", os.path.basename(p))
                out.setdefault(node, []).append(e)
    return out


def _expand(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(
                os.path.join(p, n)
                for n in sorted(os.listdir(p))
                if n.endswith(".jsonl")
            )
        else:
            out.append(p)
    return out


# --- Chrome trace-event JSON --------------------------------------------


def chrome_trace(events_by_node: EventsByNode) -> dict:
    """Build the Chrome trace-event object (Perfetto-loadable)."""
    te: List[dict] = []
    for pid, node in enumerate(sorted(events_by_node)):
        events = events_by_node[node]
        te.append(
            {
                "ph": "M", "pid": pid, "tid": 0,
                "name": "process_name", "args": {"name": node},
            }
        )
        tids: Dict[str, int] = {}
        for e in events:
            track = e.get("tid") or "main"
            if track not in tids:
                tids[track] = len(tids)
                te.append(
                    {
                        "ph": "M", "pid": pid, "tid": tids[track],
                        "name": "thread_name",
                        "args": {"name": track},
                    }
                )
        for e in events:
            ph = e.get("ph", "X")
            base = {
                "ph": ph,
                "pid": pid,
                "tid": tids[e.get("tid") or "main"],
                "name": e["name"],
                "ts": e["ts_ns"] / 1e3,
                "cat": e["name"].split(".")[0],
                "args": e.get("args") or {},
            }
            if ph == "X":
                base["dur"] = e.get("dur_ns", 0) / 1e3
            elif ph == "i":
                base["s"] = "t"  # thread-scoped instant
            te.append(base)
    return {"traceEvents": te, "displayTimeUnit": "ms"}


def write_chrome(path: str, events_by_node: EventsByNode) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(chrome_trace(events_by_node), f)
    return path
