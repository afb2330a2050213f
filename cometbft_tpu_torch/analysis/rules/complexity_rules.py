"""Committee-scale complexity rules (whole-program pass).

Built on analysis/complexity.py's loop-domain dataflow: every loop
gets an iteration domain (validators, peers, subscribers, heights,
txs), and committee-domain loops propagate interprocedurally. The
bug class is ROADMAP item 1's: at 100+ validators any O(validators)
work on a per-message path is O(V^2) per height, because the number
of messages per height is itself O(V).

- **ASY117 superlinear-msg-handler** — a validators/peers-domain
  loop reachable from a per-message hot-plane handler (receive,
  ``_handle_msg``, vote/part submit, gossip send routines). The
  finding carries BOTH the call chain and the domain-inference
  chain, so a reader can audit each hop.
- **ASY118 nested-committee-loop** — committee x committee nesting
  (validator x validator, peer x validator) in consensus/p2p/types:
  the direct quadratic, same-function or through a call inside the
  outer loop.
- **ASY119 unbounded-growth-in-hot-plane** — a dict/list/set
  attribute in a hot plane with reachable adds but NO reachable
  prune/pop/clear anywhere in the tree: the leak class ROADMAP item
  5's months-horizon soak needs killed.

Suppressing a flagged LOOP line in its own file sanctions it for
ASY117/ASY118 chains (one justified comment kills the whole fan of
chain findings — the ASY114 sanctioned-sink contract). The
suppression-hygiene test requires every such comment to carry a
justification.
"""
from __future__ import annotations

from typing import List

from ..callgraph import Project
from ..complexity import (
    COMMITTEE_DOMAINS,
    collect_growable_attrs,
    collect_pruned_attrs,
    model_for,
    reachable_from,
    render_chain,
    render_trace,
)
from ..findings import Finding
from ..registry import project_rule
from .async_rules import _HOT_PLANE_PREFIXES
from .interproc_rules import _in_scope

# per-message handlers + gossip send routines: the entry points whose
# work is multiplied by O(V) messages per height
_HANDLER_NAMES = {
    "receive",
    "_handle_msg",
    "_on_peer_msg",
    "_on_stream",
    "_submit_vote",
    "_on_cs_broadcast",
    "_on_event",
    "_on_publish",
    "broadcast",
    "_broadcast",
    "_gossip_routine",
    "_broadcast_tx_routine",
}

# where committee x committee nesting is the direct quadratic
_ASY118_PREFIXES = (
    "consensus/",
    "p2p/",
    "lp2p/",
    "types/",
)


def _is_handler(fi) -> bool:
    return fi.name in _HANDLER_NAMES and _in_scope(
        fi.path, _HOT_PLANE_PREFIXES
    )


@project_rule(
    "ASY117",
    "superlinear-msg-handler",
    "a validators/peers-domain loop is reachable from a per-message "
    "hot-plane handler: O(V) work per message times O(V) messages "
    "per height is O(V^2) — make the work incremental "
    "(cursor/index/memo) or justify the loop line",
)
def superlinear_msg_handler(project: Project) -> List[Finding]:
    model = model_for(project)
    out: List[Finding] = []
    seen = set()  # (handler_qual, loop path, loop line) dedup
    for qual in sorted(project.functions):
        fi = project.functions[qual]
        if not _is_handler(fi):
            continue
        s = model.summary(qual)
        for dl in s.committee_loops:
            if project._suppressed(fi.path, dl.line, "ASY117"):
                continue
            key = (qual, fi.path, dl.line)
            if key in seen:
                continue
            seen.add(key)
            out.append(
                Finding(
                    fi.path, dl.line, dl.col,
                    "ASY117", "superlinear-msg-handler",
                    f"per-message handler `{fi.name}` runs a "
                    f"{dl.domain}-domain {dl.kind} over "
                    f"`{dl.spelling}` inline — O({dl.domain}) work "
                    "per message with O(validators) messages per "
                    "height is O(V^2); make it incremental "
                    "(cursor/index/memo) "
                    f"[domain: {render_trace(dl.trace)}]",
                    chain=(fi.name,),
                    domain_trace=dl.trace,
                )
            )
        for cs in fi.calls:
            callee = project.functions.get(cs.callee)
            if callee is None:
                continue
            if callee.is_async and not cs.awaited:
                continue
            if _is_handler(callee):
                continue  # charged to the nearer handler
            hit = model.committee_chain(
                cs.callee, "ASY117", skip=_is_handler
            )
            if hit is None:
                continue
            key = (qual, hit.path, hit.loop.line)
            if key in seen:
                continue
            seen.add(key)
            chain = (cs.spelling,) + hit.chain
            out.append(
                Finding(
                    fi.path, cs.line, cs.col,
                    "ASY117", "superlinear-msg-handler",
                    f"per-message handler `{fi.name}` reaches a "
                    f"{hit.loop.domain}-domain loop: "
                    f"{render_chain(fi.name, chain, hit)} — "
                    f"O({hit.loop.domain}) work per message with "
                    "O(validators) messages per height is O(V^2); "
                    "make the reached work incremental or justify "
                    "the loop line "
                    f"[domain: {render_trace(hit.loop.trace)}]",
                    chain=(fi.name,) + chain,
                    domain_trace=hit.loop.trace,
                )
            )
    return out


@project_rule(
    "ASY118",
    "nested-committee-loop",
    "committee x committee loop nesting (validator x validator, "
    "peer x validator) in consensus/p2p/types — the direct "
    "quadratic; hoist the inner scan into an index built once "
    "outside the loop",
)
def nested_committee_loop(project: Project) -> List[Finding]:
    model = model_for(project)
    out: List[Finding] = []
    for qual in sorted(project.functions):
        fi = project.functions[qual]
        if not _in_scope(fi.path, _ASY118_PREFIXES):
            continue
        s = model.summary(qual)
        for outer, inner in s.nested:
            if project._suppressed(fi.path, inner.line, "ASY118"):
                continue
            out.append(
                Finding(
                    fi.path, inner.line, inner.col,
                    "ASY118", "nested-committee-loop",
                    f"{inner.domain}-domain {inner.kind} over "
                    f"`{inner.spelling}` nested inside a "
                    f"{outer.domain}-domain loop over "
                    f"`{outer.spelling}` (line {outer.line}) in "
                    f"`{fi.name}`: O({outer.domain} x "
                    f"{inner.domain}) — build an index/dict once "
                    "outside the outer loop and look up inside "
                    f"[domain: {render_trace(inner.trace)}]",
                    chain=(fi.name,),
                    domain_trace=inner.trace,
                )
            )
        for cil in s.calls_in_loops:
            callee = project.functions.get(cil.site.callee)
            if callee is None:
                continue
            if callee.is_async and not cil.site.awaited:
                continue
            hit = model.committee_chain(cil.site.callee, "ASY118")
            if hit is None:
                continue
            if project._suppressed(
                fi.path, cil.site.line, "ASY118"
            ):
                continue
            out.append(
                Finding(
                    fi.path, cil.site.line, cil.site.col,
                    "ASY118", "nested-committee-loop",
                    f"`{cil.site.spelling}(...)` called inside a "
                    f"{cil.loop.domain}-domain loop over "
                    f"`{cil.loop.spelling}` (line {cil.loop.line}) "
                    f"reaches a {hit.loop.domain}-domain loop: "
                    f"{render_chain(fi.name, (cil.site.spelling,) + hit.chain, hit)}"
                    f" — O({cil.loop.domain} x {hit.loop.domain}); "
                    "hoist the inner scan or make the callee "
                    "incremental "
                    f"[domain: {render_trace(hit.loop.trace)}]",
                    chain=(fi.name, cil.site.spelling) + hit.chain,
                    domain_trace=hit.loop.trace,
                )
            )
    return out


@project_rule(
    "ASY119",
    "unbounded-growth-in-hot-plane",
    "a dict/list/set attribute in a hot plane has reachable adds "
    "but no reachable prune/pop/clear/LRU anywhere in the tree — "
    "unbounded on the months-horizon soak; bound it or justify the "
    "init line",
)
def unbounded_growth_in_hot_plane(project: Project) -> List[Finding]:
    pruned = collect_pruned_attrs(project)
    # only adds on the per-message closure count: a container grown
    # at registration/startup time scales with config, not traffic
    hot = reachable_from(
        project,
        (fi for fi in project.functions.values() if _is_handler(fi)),
    )
    out: List[Finding] = []
    growable = collect_growable_attrs(
        project, lambda p: _in_scope(p, _HOT_PLANE_PREFIXES)
    )
    for ga in growable:
        if ga.attr in pruned:
            continue
        grows = [g for g in ga.grows if g.func_qual in hot]
        if not grows:
            continue
        if project._suppressed(ga.path, ga.line, "ASY119"):
            continue
        sites = ", ".join(
            f"{g.path.rsplit('/', 1)[-1]}:{g.line} `{g.op}`"
            for g in grows[:3]
        )
        more = (
            f" (+{len(grows) - 3} more)" if len(grows) > 3 else ""
        )
        out.append(
            Finding(
                ga.path, ga.line, ga.col,
                "ASY119", "unbounded-growth-in-hot-plane",
                f"`{ga.class_name}.{ga.attr}` ({ga.kind}) grows on "
                f"the per-message plane at {sites}{more} with no "
                "reachable prune/pop/clear/LRU anywhere in the tree "
                "— unbounded growth under traffic; bound it "
                "(high-water prune, LRU, per-height drop) or "
                "justify this init line",
                chain=(ga.class_name,),
                domain_trace=tuple(
                    f"{g.path}:{g.line} `{g.op}`" for g in grows
                ),
            )
        )
    return sorted(out)
