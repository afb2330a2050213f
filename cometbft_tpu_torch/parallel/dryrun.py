"""The multi-process dryrun: lanes over ranks, the tally summed across them.

The port's form of the JAX package's ``dryrun_multichip``
(``__graft_entry__.py``), which runs the sharded verify core and the
``psum`` quorum step on a virtual n-device CPU mesh. Here the mesh is
n processes joined by a gloo process group on the CPU (the shape an
n-card host takes with one card a rank): each rank verifies its slice
of the lanes with the kernels' plain versions, the ranks
``all_reduce`` the int32 tally through ``make_quorum_reducer``, and
rank 0 gathers the verdicts, checks them against
``crypto/ref_ed25519.verify_zip215`` and checks the quorum.

    python -m cometbft_tpu_torch.parallel.dryrun 4

prints ``dryrun_multichip OK: ...`` and exits 0, or exits non-zero.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

# the ranks' share of the run: process start, import, the group's
# rendezvous, the verify and the all_reduce (a few seconds on a loaded
# CPU); past it every rank is ended and the dryrun fails
DEFAULT_KERNEL_BUDGET_S = 120
# the whole dryrun, the parent included, as tests/test_dryrun.py pins
# the JAX one
DRYRUN_WALL_CAP_S = 240

LANES_PER_RANK = 2
BAD_LANES = (3,)
POWER = 10
SEED = 7

_ROOT = Path(__file__).resolve().parents[2]


def _items(n: int):
    """n (pk, msg, sig) lanes from SEED, with BAD_LANES' signatures
    corrupted (the JAX dryrun's items)."""
    import numpy as np

    from ..crypto import ref_ed25519 as ref

    rng = np.random.default_rng(SEED)
    items = []
    for i in range(n):
        sk = rng.bytes(32)
        pk = ref.public_from_seed(sk)
        m = bytes(rng.bytes(23))
        sig = ref.sign(sk, m)
        if i in BAD_LANES:
            sig = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
        items.append((pk, m, sig))
    return items


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, init: str, budget_s: float) -> int:
    """One rank: verify this rank's lanes on the CPU, sum the tally over
    the group; rank 0 checks everything and prints the result."""
    import torch
    import torch.distributed as dist

    from ..crypto import ref_ed25519 as ref
    from ..ops import ed25519 as ed
    from .mesh import make_mesh
    from .sharded_verify import make_quorum_reducer

    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank,
                            timeout=timedelta(seconds=budget_s))
    try:
        n = world * LANES_PER_RANK
        items = _items(n)
        lo, hi = rank * LANES_PER_RANK, (rank + 1) * LANES_PER_RANK
        mine = [(m, pk, sig) for pk, m, sig in items[lo:hi]]
        t0 = time.perf_counter()
        verdicts = ed.verify_batch(mine, device="cpu")
        verify_s = time.perf_counter() - t0
        ok = torch.as_tensor(verdicts, dtype=torch.bool)
        reducer = make_quorum_reducer(make_mesh(devices=["cpu"]))
        total = POWER * n
        quorum, tally, ok_lanes = reducer(ok, torch.full((hi - lo,), POWER, dtype=torch.int32),
                                          total * 2 // 3)
        gathered = [torch.zeros(LANES_PER_RANK, dtype=torch.uint8) for _ in range(world)]
        dist.all_gather(gathered, ok_lanes.to(torch.uint8))
        if rank == 0:
            got = [bool(v) for g in gathered for v in g.tolist()]
            want = [ref.verify_zip215(pk, m, sig) for pk, m, sig in items]
            assert got == want, (got, want)
            assert [i for i, v in enumerate(got) if not v] == list(BAD_LANES), got
            tally = int(tally)
            assert tally == total - POWER * len(BAD_LANES), (tally, total)
            assert bool(quorum) == (tally * 3 > total * 2) and bool(quorum)
            print(json.dumps({"mesh": world, "lanes": n, "tally": tally, "total": total,
                              "quorum": bool(quorum), "verify_s": verify_s,
                              "kernel_leg": "sharded-plain(gloo)",
                              "dispatch": {k: v for k, v in ed.LAST_DISPATCH.items()
                                           if k != "launches"}}), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def dryrun_multichip(n_devices: int) -> dict:
    """Run the dryrun over ``n_devices`` gloo processes on the CPU and
    return rank 0's result (mesh, lanes, tally, quorum, wall_s). Raises
    RuntimeError if a rank fails or the ranks outlive
    DEFAULT_KERNEL_BUDGET_S; every process it started has ended when it
    returns."""
    if n_devices < 2:
        raise ValueError("the dryrun needs at least two ranks")
    budget_s = DEFAULT_KERNEL_BUDGET_S
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(_ROOT), env.get("PYTHONPATH", "")) if p)
    env.setdefault("OMP_NUM_THREADS", "1")
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "cometbft_tpu_torch.parallel.dryrun", "--rank", str(r),
             "--world", str(n_devices), "--init", init, "--budget", str(budget_s)],
            cwd=str(_ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(n_devices)
    ]
    outs = []
    try:
        for p in procs:
            left = max(1.0, budget_s - (time.perf_counter() - t0))
            outs.append(p.communicate(timeout=left))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"dryrun_multichip: the ranks outlived their {budget_s}s budget") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    failed = [(r, p.returncode, outs[r][1][-2000:]) for r, p in enumerate(procs) if p.returncode]
    if failed:
        raise RuntimeError(f"dryrun_multichip: ranks failed: {failed}")
    lines = [ln for ln in outs[0][0].splitlines() if ln.startswith("{")]
    if not lines:
        raise RuntimeError(f"dryrun_multichip: rank 0 printed no result: {outs[0][0][-2000:]}")
    result = json.loads(lines[-1])
    result["wall_s"] = wall
    return result


def main(argv) -> int:
    if "--rank" in argv:
        opt = lambda k: argv[argv.index(k) + 1]  # noqa: E731
        return _rank_main(int(opt("--rank")), int(opt("--world")), opt("--init"),
                          float(opt("--budget")))
    n = int(argv[0]) if argv else 4
    r = dryrun_multichip(n)
    print(f"dryrun_multichip OK: mesh={r['mesh']} lanes={r['lanes']} "
          f"tally={r['tally']}/{r['total']} quorum={r['quorum']} "
          f"kernel_leg={r['kernel_leg']} wall_s={r['wall_s']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
