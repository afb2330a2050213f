"""Empirical committee-scaling probe (a copy of the JAX package's
``analysis/scaling.py``), driving the port's own planes.

Each registered site drives one hot path in-process at committee
sizes {4, 16, 64, 128}, fits a log-log scaling exponent over the
median walls, and compares it against the per-site budget in
tools/scaling_budgets.toml (read unedited). An injected quadratic site
(``inject_quadratic_site``, name-prefixed ``chaos.`` like
runtime.inject_lock_inversion's probes) must be DETECTED — a probe
that cannot flag its own O(n^2) plant proves nothing.

Real sites (the hot paths the JAX package's static complexity pass
flagged and then fixed):

- ``vote_add``        — VoteSet.add_vote for a full committee (the
                        memoized total_voting_power fix: unmemoized,
                        every add resummed O(V) powers → slope ~2)
- ``commit_assembly`` — make_commit + verify_commit through a
                        prewarmed SignatureCache (assembly/tally path
                        only; every lane is a cache hit, so no lane
                        reaches a verifier and the site names the
                        host as its device)
- ``gossip_pick``     — one steady-state gossip tick across all
                        peers' PeerVoteCursors (the incremental-
                        cursor fix: the old rescan was O(V) per peer
                        per tick → slope ~2 committee-wide)
- ``fanout_publish``  — FanoutHub._deliver to N subscribers sharing
                        one query group (O(N) enqueues of a shared
                        payload; per-subscriber encodes → slope >1
                        plus a constant blowup)

Exponents, not absolute walls: wall-clock budgets rot with the box,
but ``log(wall) ~ k*log(n)`` survives CPU scaling — the same
reasoning the reference's benchstat workflows apply to -benchtime
sweeps (types/validator_set_test.go BenchmarkUpdates).
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import tomllib as _toml

SIZES = (4, 16, 64, 128)

# a fixed hot path should be ~linear; 1.35 leaves headroom for
# allocator/cache noise at small n while still refusing anything
# genuinely super-linear (n^1.5 at 4->128 is a 5.6x blowup over n)
DEFAULT_EXPONENT_BUDGET = 1.35

DEFAULT_BUDGET_PATH = os.path.join("tools", "scaling_budgets.toml")

# injected sites carry the same name prefix inject_lock_inversion's
# probe locks do: chaos treats prefixed findings as EXPECTED
INJECTED_PREFIX = "chaos."


def default_budget_file(repo_root: Optional[str] = None) -> str:
    """Package-anchored like obs.budget.default_budget_file: the probe
    must resolve its budgets no matter the caller's cwd."""
    root = repo_root or os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    return os.path.join(root, DEFAULT_BUDGET_PATH)


def load_exponent_budgets(path: Optional[str] = None) -> Dict[str, float]:
    """{site: max_exponent} from tools/scaling_budgets.toml."""
    path = path or default_budget_file()
    with open(path, "rb") as f:
        tables = _toml.load(f).get("scaling") or {}
    out: Dict[str, float] = {}
    for site, entry in tables.items():
        if not isinstance(entry, dict) or "max_exponent" not in entry:
            raise ValueError(
                f"scaling.{site!r}: expected a table with max_exponent"
            )
        out[site] = float(entry["max_exponent"])
    return out


def fit_exponent(
    sizes: Sequence[int], walls: Sequence[float]
) -> float:
    """Least-squares slope of log(wall) vs log(n): the empirical k in
    wall ~ C * n^k. O(1) sites fit k ~ 0, linear ~1, quadratic ~2."""
    if len(sizes) != len(walls) or len(sizes) < 2:
        raise ValueError("need >= 2 (size, wall) points")
    xs = [math.log(n) for n in sizes]
    ys = [math.log(max(w, 1e-12)) for w in walls]
    mx = sum(xs) / len(xs)
    my = sum(ys) / len(ys)
    denom = sum((x - mx) ** 2 for x in xs)
    return sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / denom


@dataclass
class ScalingResult:
    """One site's fitted slope vs its budget (asdict-able for the
    bench checkpoint JSON and the chaos report)."""

    site: str
    sizes: tuple
    walls_s: tuple  # median wall per size, seconds
    exponent: float
    budget: float
    injected: bool = False

    @property
    def ok(self) -> bool:
        return self.exponent <= self.budget

    def as_dict(self) -> dict:
        return {
            "site": self.site,
            "sizes": list(self.sizes),
            "walls_us": [round(w * 1e6, 3) for w in self.walls_s],
            "exponent": round(self.exponent, 4),
            "budget": self.budget,
            "ok": self.ok,
            "injected": self.injected,
        }


def injected_result(r) -> bool:
    """True for results from an injected (``chaos.``-prefixed) site —
    chaos treats those breaches as EXPECTED, mirroring
    analysis/runtime.injected_finding."""
    site = r.site if isinstance(r, ScalingResult) else r.get("site", "")
    return str(site).startswith(INJECTED_PREFIX)


# --- site registry -------------------------------------------------------
#
# A site is ``setup(n) -> run`` where setup builds all n-sized state
# once per committee size and ``run()`` executes ONE unit of the hot
# path (one full-committee round of it). Timing reps are calibrated
# so each sample batch clears the wall floor.

SiteSetup = Callable[[int], Callable[[], object]]

_SITES: Dict[str, SiteSetup] = {}


def register_site(name: str, setup: SiteSetup) -> None:
    _SITES[name] = setup


def site_names() -> List[str]:
    return sorted(_SITES)


def synthetic_site(power: float, unit: int = 40) -> SiteSetup:
    """Pure-compute site whose work is exactly ``unit * n**power``
    loop iterations — the probe's own calibration fixture (tests
    bracket the fitted exponent) and the quadratic injection plant."""

    def setup(n: int) -> Callable[[], int]:
        iters = int(unit * (n ** power)) + 1

        def run() -> int:
            acc = 0
            for i in range(iters):
                acc += i
            return acc

        return run

    return setup


def inject_quadratic_site(
    sites: Optional[Dict[str, SiteSetup]] = None, unit: int = 6
) -> str:
    """Plant a deliberately O(n^2) site (chaos ``scaling_probe``
    fault with inject_quadratic): the probe must flag it or the run
    fails — detection proof, same contract as lock_inversion."""
    name = INJECTED_PREFIX + "injected_quadratic"
    (_SITES if sites is None else sites)[name] = synthetic_site(
        2.0, unit=unit
    )
    return name


# --- real sites ----------------------------------------------------------


def _committee(n: int):
    """(valset, votes, chain_id, height): n fake validators with
    deterministic 32-byte keys (sha-derived 20-byte addresses, no
    keygen — the probe measures the data plane, not Ed25519)."""
    from ..types.block import BlockID, PartSetHeader
    from ..types.validator_set import Validator, ValidatorSet
    from ..types.vote import PRECOMMIT, Vote
    from ..crypto.keys import PubKey

    chain_id = "scaling-probe"
    height = 3
    vals = [
        Validator(PubKey(bytes([7]) + i.to_bytes(31, "big")), 10)
        for i in range(n)
    ]
    vs = ValidatorSet(vals)
    block_id = BlockID(
        hash=b"\xab" * 32,
        part_set_header=PartSetHeader(total=1, hash=b"\xcd" * 32),
    )
    ts = 1_700_000_000_000_000_000
    votes = [
        Vote(
            type_=PRECOMMIT,
            height=height,
            round=0,
            block_id=block_id,
            timestamp_ns=ts,
            validator_address=v.address,
            validator_index=i,
            signature=bytes([i % 251 + 1]) * 64,
        )
        for i, v in enumerate(vs.validators)
    ]
    return vs, votes, chain_id, height


def _site_vote_add(n: int) -> Callable[[], object]:
    """Full committee through VoteSet.add_vote (signatures off): the
    path the total_voting_power memo fixed — unmemoized, each add
    resums O(V) powers and the committee round is O(V^2)."""
    from ..types.vote import PRECOMMIT
    from ..types.vote_set import VoteSet

    valset, votes, chain_id, height = _committee(n)

    def run():
        vs = VoteSet(
            chain_id, height, 0, PRECOMMIT, valset,
            verify_signatures=False,
        )
        for v in votes:
            vs.add_vote(v)
        return vs

    return run


def _site_commit_assembly(n: int) -> Callable[[], object]:
    """make_commit + verify_commit with every signature prewarmed in
    the SignatureCache: measures commit assembly, sign-bytes memo and
    tally — the O(V) floor — with the curve math cache-hit away."""
    from ..types import validation
    from ..types.signature_cache import SignatureCache
    from ..types.vote import PRECOMMIT
    from ..types.vote_set import VoteSet

    valset, votes, chain_id, height = _committee(n)
    vs = VoteSet(
        chain_id, height, 0, PRECOMMIT, valset, verify_signatures=False
    )
    for v in votes:
        vs.add_vote(v)
    cache = SignatureCache(size=max(4096, 4 * n))
    commit0 = vs.make_commit()
    key_by_addr = {
        val.address: val.pub_key.key_bytes for val in valset.validators
    }
    for cs in commit0.signatures:
        sb = validation._commit_sign_bytes(chain_id, commit0, cs)
        cache.add(sb, cs.signature, key_by_addr[cs.validator_address])

    def run():
        commit = vs.make_commit()
        validation.verify_commit(
            chain_id, valset, commit.block_id, height, commit, cache,
            device="cpu",
        )
        return commit

    return run


def _site_gossip_pick(n: int) -> Callable[[], object]:
    """One steady-state gossip tick for a committee of n peers: every
    peer's PeerVoteCursor ingests + picks against fully-acked logs.
    The cursor fix makes each peer O(new + unacked) = O(1) here; the
    rescan it replaced paid O(V) per peer (slope ~2 committee-wide)."""
    from ..consensus.reactor import PeerRoundState, PeerVoteCursor, _vote_key
    from ..types.vote import PRECOMMIT, PREVOTE, Vote
    from ..types.vote_set import VoteSet

    valset, votes, chain_id, height = _committee(n)
    prevotes = VoteSet(
        chain_id, height, 0, PREVOTE, valset, verify_signatures=False
    )
    precommits = VoteSet(
        chain_id, height, 0, PRECOMMIT, valset, verify_signatures=False
    )
    for v in votes:
        precommits.add_vote(v)
        prevotes.add_vote(
            Vote(
                type_=PREVOTE,
                height=v.height,
                round=v.round,
                block_id=v.block_id,
                timestamp_ns=v.timestamp_ns,
                validator_address=v.validator_address,
                validator_index=v.validator_index,
                signature=v.signature,
            )
        )

    class _HVS:
        def prevotes(self, r):
            return prevotes if r == 0 else None

        def precommits(self, r):
            return precommits if r == 0 else None

    class _RS:
        pass

    rs = _RS()
    rs.height = height
    rs.round = 0
    rs.votes = _HVS()
    rs.last_commit = None

    prs = PeerRoundState(height=height, round=0)
    for src in (prevotes, precommits):
        for v in src.vote_log:
            prs.has_votes.add(_vote_key(v))

    cursors = [PeerVoteCursor() for _ in range(n)]
    for cur in cursors:
        cur.reset(height)
        cur.ingest(rs, prs)
        cur.due_votes(prs, 0.0, 1 << 30)  # drain: everything is acked

    def run():
        for cur in cursors:
            cur.ingest(rs, prs)
            cur.due_votes(prs, 0.0, 16)
        return cursors

    return run


def _site_fanout_publish(n: int) -> Callable[[], object]:
    """FanoutHub._deliver to n subscribers sharing one query group:
    one encode then n string splices + bounded enqueues per event
    (the fan-out contract — per-subscriber re-encodes would show up as
    a slope-preserving constant blowup here)."""
    from ..rpc.fanout import FanoutHub, FanoutSubscriber, _Group
    from ..types import events as ev

    class _MatchAll:
        def matches(self, attrs) -> bool:
            return True

    hub = FanoutHub(bus=None)
    group = _Group("probe='scaling'", _MatchAll())
    hub._groups[group.query_str] = group
    subs = []
    for i in range(n):
        sub = FanoutSubscriber(None, i, group.query_str, queue_size=64)
        group.members.add(sub)
        subs.append(sub)
    events = [
        ev.Event("scaling_probe", None, {"seq": str(i)}) for i in range(4)
    ]

    def run():
        for e in events:
            hub._deliver(e)
        for sub in subs:
            q = sub.queue
            while not q.empty():
                q.get_nowait()
        return hub.delivered

    return run


register_site("vote_add", _site_vote_add)
register_site("commit_assembly", _site_commit_assembly)
register_site("gossip_pick", _site_gossip_pick)
register_site("fanout_publish", _site_fanout_publish)


# --- probe driver --------------------------------------------------------


def time_site(
    setup: SiteSetup,
    sizes: Sequence[int] = SIZES,
    min_wall_s: float = 0.01,
    repeats: int = 3,
    max_reps: int = 20000,
) -> List[float]:
    """Median wall per committee size. Reps per sample batch are
    calibrated so each batch clears ``min_wall_s`` — small-n runs are
    microseconds and a single-shot wall would be timer noise."""
    walls: List[float] = []
    for n in sizes:
        run = setup(n)
        run()  # warm allocators / memos
        t0 = time.perf_counter()
        run()
        dt = time.perf_counter() - t0
        reps = max(1, min(max_reps, math.ceil(min_wall_s / max(dt, 1e-9))))
        samples = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(reps):
                run()
            samples.append((time.perf_counter() - t0) / reps)
        samples.sort()
        walls.append(samples[len(samples) // 2])
    return walls


def run_probe(
    sites: Optional[Dict[str, SiteSetup]] = None,
    sizes: Sequence[int] = SIZES,
    budgets: Optional[Dict[str, float]] = None,
    min_wall_s: float = 0.01,
    repeats: int = 3,
) -> List[ScalingResult]:
    """Drive every site, fit exponents, judge against budgets.
    Injected (``chaos.``) sites fall back to the default budget —
    they exist to BREACH it."""
    if sites is None:
        sites = _SITES
    if budgets is None:
        try:
            budgets = load_exponent_budgets()
        except (OSError, ValueError):
            budgets = {}
    out: List[ScalingResult] = []
    for name in sorted(sites):
        walls = time_site(
            sites[name], sizes, min_wall_s=min_wall_s, repeats=repeats
        )
        out.append(
            ScalingResult(
                site=name,
                sizes=tuple(sizes),
                walls_s=tuple(walls),
                exponent=fit_exponent(sizes, walls),
                budget=budgets.get(name, DEFAULT_EXPONENT_BUDGET),
                injected=name.startswith(INJECTED_PREFIX),
            )
        )
    return out


def format_results(results: Sequence[ScalingResult]) -> str:
    """Aligned table, breaches first (chaos/bench log discipline)."""
    lines = [
        f"{'verdict':<8} {'site':<28} {'exponent':>9} {'budget':>7} "
        f"{'walls us @ ' + 'x'.join(str(s) for s in (results[0].sizes if results else SIZES))}"
    ]
    for r in sorted(results, key=lambda r: (r.ok, r.site)):
        walls = " ".join(f"{w * 1e6:.1f}" for w in r.walls_s)
        tag = "OK" if r.ok else ("PLANT" if r.injected else "OVER")
        lines.append(
            f"{tag:<8} {r.site:<28} {r.exponent:>9.3f} {r.budget:>7.2f} {walls}"
        )
    n_over = sum(1 for r in results if not r.ok and not r.injected)
    lines.append(
        "scaling verdict: "
        + ("PASS" if n_over == 0 else f"FAIL ({n_over} site(s) over budget)")
    )
    return "\n".join(lines)


# --- chaos drain ---------------------------------------------------------
#
# Mirrors the runtime sanitizer contract (analysis/runtime.py): a run
# of the probe under load accumulates its results here and the caller
# drains them — un-injected breaches are faults, and a scheduled
# injection that the probe did NOT flag is one too.

_CHAOS_RESULTS: List[ScalingResult] = []


def probe_for_chaos(
    inject_quadratic: bool = False,
    sizes: Sequence[int] = (4, 16, 48),
    min_wall_s: float = 0.004,
) -> dict:
    """The probe under load (the JAX chaos ``scaling_probe`` fault):
    smaller sizes + floor than a full probe — detection proof under
    load, not publication-grade medians."""
    sites = dict(_SITES)
    planted = None
    if inject_quadratic:
        planted = inject_quadratic_site(sites)
    results = run_probe(
        sites=sites, sizes=sizes, min_wall_s=min_wall_s, repeats=3
    )
    _CHAOS_RESULTS.extend(results)
    return {
        "sites": len(results),
        "injected": planted,
        "breaches": [r.site for r in results if not r.ok],
        "exponents": {r.site: round(r.exponent, 3) for r in results},
    }


def drain_chaos_results() -> List[ScalingResult]:
    out = list(_CHAOS_RESULTS)
    _CHAOS_RESULTS.clear()
    return out
