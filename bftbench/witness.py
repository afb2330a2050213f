"""A witness of the card's verdicts on the cells' own verify path.

    python3 bftbench/witness.py --seed 5 --seconds 20 --threads 8

Every lane is a valid signature: a pool of (key, message, signature)
lanes is signed from the seed, checked once by the plain reference,
then submitted over and over, in tickets of 150 to 4,740 lanes drawn
from the seed, by ``--threads`` threads at once to the pinned
``VerifyScheduler`` (the route both cells take: the scheduler's
dispatcher, host packing, K1-K3), at catch-up and light priority. Each
lane that comes back invalid is counted with its ticket's size and the
time. Prints one JSON line; exits 2 without a card.
"""

import argparse
import json
import os
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bftbench import core  # noqa: E402
from bftbench.drivers.common import PinnedRoute, RefPool  # noqa: E402
from bftbench.gen.keys import rng_for  # noqa: E402
from bftbench.gen.sign import Signer  # noqa: E402
from bftbench.reference import ed25519 as ref_ed  # noqa: E402

POOL = 8192
WIDTHS = (150, 180, 1_000, 3_000, 4_740)


def make_pool(seed: int, n: int, ref_workers=None) -> list:
    """(program pubkey, message, signature) lanes, every one valid by
    the reference."""
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey

    rng = rng_for(seed, 11)
    seeds = [rng.bytes(32) for _ in range(180)]
    pubs = [Ed25519PrivKey.from_seed(s).pub_key() for s in seeds]
    # commit sign bytes run 110-130 bytes
    msgs = [rng.bytes(int(rng.integers(100, 140))) for _ in range(n)]
    which = rng.integers(0, len(seeds), size=n)
    sigs = Signer().sign([(seeds[k], m) for k, m in zip(which, msgs)])
    with RefPool(ref_workers) as pool:
        pks = pool.map_chunks(ref_ed.public_keys, seeds, chunk=32)
        ok = pool.map_chunks(ref_ed.verify_rows, [(pks[k], m, s) for k, m, s in zip(which, msgs, sigs)])
    if not all(ok):
        raise RuntimeError("the reference refused a signature of the pool")
    return [(pubs[k], m, s) for k, m, s in zip(which, msgs, sigs)]


def witness(seed: int, seconds: float, threads: int, device, ref_workers=None) -> dict:
    from cometbft_tpu_torch.crypto.scheduler import PRIORITY_CATCHUP, PRIORITY_LIGHT

    pool = make_pool(seed, POOL, ref_workers)
    counts = {"tickets": 0, "lanes": 0, "false_lanes": 0}
    falses: list = []
    lock = threading.Lock()
    end = time.perf_counter() + seconds

    def feed(i):
        rng = rng_for(seed, 100 + i)
        while time.perf_counter() < end:
            n = int(WIDTHS[int(rng.integers(0, len(WIDTHS)))])
            start = int(rng.integers(0, POOL - n))
            prio = PRIORITY_LIGHT if i % 2 else PRIORITY_CATCHUP
            ok, verdicts = sched.submit(pool[start: start + n], priority=prio, device=device).result(120)
            bad = [start + j for j, v in enumerate(verdicts) if not v]
            with lock:
                counts["tickets"] += 1
                counts["lanes"] += n
                counts["false_lanes"] += len(bad) + (len(verdicts) != n)
                if bad and len(falses) < 20:
                    falses.append({"lanes": bad[:8], "ticket": n, "t": round(seconds - (end - time.perf_counter()), 3)})

    with PinnedRoute(device) as route:
        sched = route.sched
        ts = [threading.Thread(target=feed, args=(i,), daemon=True) for i in range(threads)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        wall = time.perf_counter() - t0
        stats = route.stats()
    return dict(counts, seconds=wall, threads=threads, device_dispatches=stats["device_dispatches"],
                host_chunks=stats["host_chunks"], degraded=stats["degraded"], falses=falses)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args(argv)
    core.cache_env()
    try:
        device = core.card(1)
    except core.BenchError as e:
        print(f"witness: {e}", file=sys.stderr)
        return 2
    import torch

    out = witness(args.seed, args.seconds, args.threads, device)
    out.update(seed=args.seed, kind=torch.cuda.get_device_name(device))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)
