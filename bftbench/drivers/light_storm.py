"""Driver of a light-client storm on one full node's serving plane.

Rounds of ``sessions`` light sessions on ``workers`` threads, a closed
loop: each worker takes the next session as soon as its last one is
answered. A session asks for one of ``heights`` target heights, spread evenly
over ``height_range`` (the same for every seed, which draws the keys),
round robin (``sessions / heights`` sessions a height). Each round runs on a fresh ``LightServingPlane``
(an empty verified-header cache, ``clients`` fresh light clients on
the trust root at height 1), so no round finds another's verified
headers; rounds follow each other without a pause. The ``forged``
highest targets carry a commit with one signature's byte flipped (the
last lane the light check reads): the node must refuse them (the configuration's guarantee is that
nothing is served before its +2/3 commit is verified).

The light blocks are minted at set-up: the targets, then whatever the
untimed warm rounds fetch (the pivots of the clients' bisections, which
depend on the order in which targets finish), round after round until
one fetches nothing new or ``warm_rounds`` have run. A height a timed
round fetches that no warm round did is minted then, on the session's
thread, in about a millisecond (as a node would read it from its
store), and counted with its time (``minted_late``, ``late_s``). Which
heights a round fetches depends on the order in which its bisections
finish, and the heights that some order could fetch are far too many
to mint ahead.
"""

from __future__ import annotations

import threading
import time
from fractions import Fraction

from ..gen.keys import rng_for
from ..gen.light import RotatingLightProvider
from ..reference import chain as ref
from ..reference import ed25519 as ref_ed
from .common import DispatchRecorder, NoRecorder, PinnedRoute, FrozenHeap, RefPool, stats_delta

# the chain's clock: header h is GENESIS_NS + h seconds
GENESIS_NS = 1_735_689_600 * 10**9
TRUST_PERIOD_NS = 10 * 365 * 86400 * 10**9
OK, REFUSED, FAILED = "ok", "refused", "failed"
# how long after the window an answer may still come
LATE_S = 60.0


class _Round:
    __slots__ = ("ready", "plane", "error", "open")

    def __init__(self):
        self.ready = threading.Event()
        self.plane = self.error = None
        self.open = 0  # sessions taken and not yet answered


class Storm:
    """Hands out the sessions of back-to-back rounds, builds each round's
    plane when its first session is taken, and lets a plane go once its
    round's last session is answered, its counters added to
    ``totals``: no finished round stays on the heap."""

    def __init__(self, schedule, build_plane, stop_at=None, rounds=None, marks=None):
        self.schedule = schedule
        self.build_plane = build_plane
        self.stop_at = stop_at
        self.limit = None if rounds is None else rounds * len(schedule)
        self.marks = marks
        self._lock = threading.Lock()
        self._i = 0
        self._rounds: dict = {}
        self.rounds = 0
        self.totals = dict.fromkeys(PLANE_COUNTERS, 0)

    def take(self):
        with self._lock:
            t = time.perf_counter()
            if (self.stop_at is not None and t >= self.stop_at) or (self.limit is not None and self._i >= self.limit):
                return None
            r, k = divmod(self._i, len(self.schedule))
            self._i += 1
            rd = self._rounds.get(r)
            build = rd is None
            if build:
                rd = self._rounds[r] = _Round()
                self.rounds += 1
            rd.open += 1
        if build:
            try:
                if self.marks is not None:
                    with self.marks("bftbench.plane_build"):
                        rd.plane = self.build_plane()
                else:
                    rd.plane = self.build_plane()
            except Exception as e:  # the sessions of this round fail with it
                rd.error = e
            rd.ready.set()
        return r, self.schedule[k], t

    def plane(self, r):
        rd = self._rounds[r]
        rd.ready.wait()
        if rd.error is not None:
            raise rd.error
        return rd.plane

    def answered(self, r) -> None:
        with self._lock:
            rd = self._rounds[r]
            rd.open -= 1
            whole = self._i >= (r + 1) * len(self.schedule) or self.stop_at is not None and \
                time.perf_counter() >= self.stop_at
            if rd.open or not whole:
                return
            del self._rounds[r]
        if rd.plane is not None:
            _add_stats(self.totals, rd.plane.stats())

    def finish(self) -> None:
        """Add the counters of the rounds still held (the window's last)."""
        with self._lock:
            rest, self._rounds = list(self._rounds.values()), {}
        for rd in rest:
            if rd.plane is not None:
                _add_stats(self.totals, rd.plane.stats())


def _serve(storm: Storm, refusals, failures, out: list, marks, cpu: list) -> None:
    from cometbft_tpu_torch.crypto.scheduler import DeviceRouteError

    while True:
        item = storm.take()
        if item is None:
            cpu.append(time.thread_time())
            return
        r, h, t_issue = item
        lb, err = None, None
        try:
            plane = storm.plane(r)
            if marks is not None:
                with marks("bftbench.request"):
                    with plane.open_session() as s:
                        lb = s.verified_block(h)
            else:
                with plane.open_session() as s:
                    lb = s.verified_block(h)
            status = OK
        except DeviceRouteError as e:
            status, err = FAILED, e
        except refusals:
            status = REFUSED
        except Exception as e:  # not a verdict: a failure of the node
            status, err = FAILED, e
        out.append((t_issue, time.perf_counter(), status, h, lb))
        storm.answered(r)
        if err is not None and len(failures) < 4:
            failures.append(repr(err))


def _run_storm(storm: Storm, workers: int, marks=None, join_s: float = LATE_S):
    """Every worker until the storm hands out no more sessions; then
    (records, failures, workers still running, the CPU seconds of the
    workers that ended)."""
    from cometbft_tpu_torch.light import verifier
    from cometbft_tpu_torch.light.client import LightClientError
    from cometbft_tpu_torch.types.validation import CommitVerifyError

    refusals = (CommitVerifyError, verifier.LightClientError, LightClientError)
    outs = [[] for _ in range(workers)]
    failures: list = []
    cpu: list = []
    threads = [threading.Thread(target=_serve, args=(storm, refusals, failures, outs[i], marks, cpu), daemon=True,
                                name=f"bftbench-session-{i}") for i in range(workers)]
    for t in threads:
        t.start()
    deadline = time.perf_counter() + join_s + (storm.stop_at - time.perf_counter() if storm.stop_at else 600)
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
    alive = sum(t.is_alive() for t in threads)
    storm.finish()
    return [r for o in outs for r in o], failures, alive, sum(cpu)


PLANE_COUNTERS = ("dispatches", "jobs_batched", "hits", "misses", "flight_waits", "requests_shed",
                  "sessions_shed")


def _add_stats(totals: dict, s: dict) -> None:
    totals["dispatches"] += s["coalesce"]["dispatches"]
    totals["jobs_batched"] += s["coalesce"]["jobs_batched"]
    for k in ("hits", "misses", "flight_waits"):
        totals[k] += s["cache"][k]
    totals["requests_shed"] += s["requests_shed"]
    totals["sessions_shed"] += s["sessions_shed"]


def run(cfg: dict, traffic: dict, seed: int, w, device, log, fault=None, ref_workers=None) -> dict:
    """Set up, run the window ``w``; the run's context, with the check to
    run once the window has closed."""
    from cometbft_tpu_torch.light import Client, LightServingPlane, TrustOptions
    from cometbft_tpu_torch.trace import NOOP, Tracer

    n_vals, epoch, shift, power = cfg["validators"], cfg["epoch"], cfg["shift"], cfg["power"]
    chain_id = cfg["chain_id"]
    n_keys = (cfg["chain_height"] // epoch + 2) * shift + n_vals
    krng = rng_for(seed, 1)
    seeds = [krng.bytes(32) for _ in range(n_keys)]
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey

    keys = [Ed25519PrivKey.from_seed(s) for s in seeds]
    lo, hi = traffic["height_range"]
    n_heights = traffic["heights"]
    # the same heights for every seed (the seed draws the keys): evenly spaced
    targets = [lo + (2 * i + 1) * (hi - lo) // (2 * n_heights) for i in range(n_heights)]
    forged = targets[len(targets) - traffic["forged"]:] if traffic["forged"] else []
    schedule = [targets[i % n_heights] for i in range(traffic["sessions"])]
    provider = RotatingLightProvider(chain_id, seeds, keys, n_vals, epoch, shift, power, GENESIS_NS,
                                     forge_at=forged)
    trust_level = Fraction(*traffic["trust_level"])
    provider.mint([1, *targets])
    tracer = NOOP
    if w.trace:
        tracer = Tracer(name="bftbench")
        tracer.add_observer(w.observe)
    ctx: dict = {}
    with PinnedRoute(device) as route:
        trust = TrustOptions(TRUST_PERIOD_NS, 1, provider.light_block(1).hash())

        def build_plane():
            clients = [Client(chain_id, trust, provider, trust_level=trust_level, device=device)
                       for _ in range(traffic["clients"])]
            return LightServingPlane(clients, max_sessions=traffic["sessions"] + traffic["workers"],
                                     max_inflight=traffic["workers"], device=device, tracer=tracer)

        # warm rounds mint the pivots the bisections fetch, until a
        # round fetches no height the others did not
        warm_rounds = 0
        while warm_rounds < traffic["warm_rounds"]:
            before_mint = len(provider.minted())
            _, warm_fail, _, _ = _run_storm(Storm(schedule, build_plane, rounds=1), traffic["workers"])
            warm_rounds += 1
            if warm_fail or len(provider.minted()) == before_mint:
                break
        log(f"light: {len(targets)} targets, {len(forged)} forged, {len(provider.minted())} heights minted in "
            f"{warm_rounds} warm rounds, failures {warm_fail}")
        provider.minted_late, provider.late_s = 0, 0.0
        if fault is not None:
            fault()
        before = route.stats()
        marks = w.mark if w.trace else None
        with FrozenHeap(), DispatchRecorder() if w.trace else NoRecorder() as rec:
            t0 = w.start()
            storm = Storm(schedule, build_plane, stop_at=w.end, marks=marks)
            recs, failures, alive, session_cpu = _run_storm(storm, traffic["workers"], marks)
            w.stop()
        after = route.stats()
        rows = rec.rows if w.trace else []
    end = t0 + w.seconds
    ctx.update(t0=t0, end=end, seconds=w.seconds)
    ctx["attempted"] = len(recs) + alive
    ctx["failed"] = sum(1 for r in recs if r[2] == FAILED) + alive
    ctx["done"] = [r[1] for r in recs if r[2] == OK]
    ctx["latencies_ms"] = [(r[1] - r[0]) * 1e3 if r[2] != FAILED else float("inf") for r in recs]
    ctx["latencies_ms"] += [float("inf")] * alive
    ctx["light"] = dict(storm.totals)
    ctx["sched"] = stats_delta(before, after)
    ctx["light"]["lanes"] = ctx["sched"]["by_class"].get("light", 0)
    ctx["light"]["verify_ns"] = sum(b - a for n, a, b in w.host_spans if n == "light.verify.coalesced")
    ctx["rounds"] = storm.rounds
    tenths = [0] * 10
    for t in ctx["done"]:
        if t0 <= t < end:
            tenths[int(10 * (t - t0) / w.seconds)] += 1
    log(f"light: verified headers by tenth of the window {tenths}")
    ctx["dispatch_rows"] = rows
    log(f"light: the session threads used {session_cpu:.2f} s of CPU in the window")
    log(f"light: {len(recs)} requests in {ctx['rounds']} rounds, failures {failures}, "
        f"{provider.minted_late} heights minted late in {provider.late_s:.3f} s, plane {ctx['light']}")
    ctx["device"] = device
    ctx["_check"] = lambda: check(recs, alive, provider, seeds, targets, cfg, ref_workers, log)
    return ctx


def check(recs, alive, provider, seeds, targets, cfg, ref_workers, log) -> list:
    """Every answer of the window against the reference: a served header
    must be the chain's header at its height, and only a height whose
    commit holds more than 2/3 of the power in valid signatures may be
    served. (name, number, limit) for each number compared."""
    n_vals, epoch, shift, power = cfg["validators"], cfg["epoch"], cfg["shift"], cfg["power"]
    chain_id = cfg["chain_id"]
    epochs = sorted({h // epoch for h in targets} | {(h + 1) // epoch for h in targets})
    need = sorted({i for e in epochs for i in range(e * shift, e * shift + n_vals)})
    with RefPool(ref_workers) as pool:
        pks = dict(zip(need, pool.map_chunks(ref_ed.public_keys, [seeds[i] for i in need], chunk=32)))
        sets = {}
        for e in epochs:
            members = [(pks[i], power) for i in range(e * shift, e * shift + n_vals)]
            order = sorted(members, key=lambda v: ref.address(v[0]))
            sets[e] = (order, ref.validator_set_hash(members))
        expected = {}
        rows, lanes_of = [], {}
        for h in targets:
            expected[h] = ref.header_hash(dict(
                version_block=11, version_app=0, chain_id=chain_id, height=h,
                time_ns=GENESIS_NS + h * 1_000_000_000, last_block_id=(b"", 0, b""), last_commit_hash=b"",
                data_hash=b"", validators_hash=sets[h // epoch][1], next_validators_hash=sets[(h + 1) // epoch][1],
                consensus_hash=b"", app_hash=b"", last_results_hash=b"", evidence_hash=b"", proposer_address=b""))
            commit = provider.light_block(h).commit
            order = sets[h // epoch][0]
            bid = (bytes(commit.block_id.hash), commit.block_id.part_set_header.total,
                   bytes(commit.block_id.part_set_header.hash))
            first, tallied = len(rows), 0
            ok_shape = len(commit.signatures) == len(order)
            for (pk, pw), cs in zip(order, commit.signatures):
                if cs.block_id_flag != ref.BLOCK_ID_FLAG_COMMIT or bytes(cs.validator_address) != ref.address(pk):
                    ok_shape = False
                    break
                rows.append((pk, ref.precommit_sign_bytes(chain_id, h, commit.round, bid, cs.timestamp_ns),
                             bytes(cs.signature)))
                tallied += pw
                if tallied * 3 > power * n_vals * 2:
                    break
            lanes_of[h] = (first, len(rows), ok_shape and tallied * 3 > power * n_vals * 2 and bid[0] == expected[h])
        oks = pool.map_chunks(ref_ed.verify_rows, rows)
    valid = {h: ok and all(oks[a:b]) for h, (a, b, ok) in lanes_of.items()}
    log(f"light reference: {len(rows)} signatures verified; valid heights {sum(valid.values())} of {len(valid)}")
    header_bad = verdict_bad = 0
    seen: dict = {}
    for _, _, status, h, lb in recs:
        if status == OK:
            got = seen.get(id(lb))
            if got is None:
                hd = lb.header
                got = seen[id(lb)] = (lb, ref.header_hash(dict(
                    version_block=hd.version_block, version_app=hd.version_app, chain_id=hd.chain_id,
                    height=hd.height, time_ns=hd.time_ns,
                    last_block_id=(bytes(hd.last_block_id.hash), hd.last_block_id.part_set_header.total,
                                   bytes(hd.last_block_id.part_set_header.hash)),
                    last_commit_hash=hd.last_commit_hash, data_hash=hd.data_hash,
                    validators_hash=hd.validators_hash, next_validators_hash=hd.next_validators_hash,
                    consensus_hash=hd.consensus_hash, app_hash=hd.app_hash,
                    last_results_hash=hd.last_results_hash, evidence_hash=hd.evidence_hash,
                    proposer_address=hd.proposer_address)))
            if got[1] != expected[h]:
                header_bad += 1
            if not valid[h]:
                verdict_bad += 1
        elif status == REFUSED and valid[h]:
            verdict_bad += 1
    return [("header_mismatches", header_bad, 0), ("verdict_mismatches", verdict_bad, 0),
            ("unanswered", alive, 0)]
