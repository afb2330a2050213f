"""Benchmark of cometbft_tpu_torch on an NVIDIA GPU: one cell, one run.

    python3 bftbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell (an entry of ``workloads`` in
``BENCHMARK.json``) names a configuration and a traffic mix; the mix's
driver sets up from the seed, measures for ``--seconds``, then checks
every answer of the window against the plain reference. Standard
output's last line is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end metrics, or with ``--trace 1``
the per-layer ones), ``device`` and, traced, ``breakdown``; its last
key, ``checks``, holds each number compared beside its limit, which
also end standard error. Without a CUDA device, or with a module of
JAX or of the JAX package loaded, it exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bftbench import core  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started, read at ``T_START``'s moment
    from /proc (0 where it cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK") - (time.perf_counter() - T_START))
    except (OSError, ValueError, IndexError):
        return 0.0


def host_probe_ms() -> float:
    """A fixed piece of interpreter work, timed: how fast this host runs
    Python now (for reading spreads; no metric)."""
    t = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc = (acc * 31 + i) & 0xFFFFFFFF
    return (time.perf_counter() - t) * 1e3


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None, overrides=None, fault=None,
             ref_workers=None, bench=None) -> dict:
    """One run of cell ``name``; the result line as a dict. ``device``
    None takes the card (and refuses to run without one); ``overrides``
    replace keys of the configuration and the traffic mix, ``fault`` is
    called just before the window, and ``bench`` stands for
    BENCHMARK.json (for tests and the control)."""
    bench = bench or core.load_benchmark()
    cell = core.find_cell(bench, name)
    cfg = dict(core.load_config(bench, cell["config"]))
    traffic = dict(core.load_json("traffic", cell["traffic"]))
    for key, value in (overrides or {}).items():
        (traffic if key in traffic else cfg)[key] = value
    core.cache_env()
    import torch

    if device is None:
        device = core.card(cell["chips"])
    else:
        device = torch.device(device)
    age = process_age_s()
    log(f"host: a fixed pure-Python loop took {host_probe_ms():.1f} ms")
    scratch = core.scratch_dir()
    w = core.Window(seconds, trace, device, scratch)
    driver = core.load_driver(traffic)
    ctx = driver.run(cfg, traffic, seed, w, device, log, fault=fault, ref_workers=ref_workers)
    ctx["setup_s"] = ctx["t0"] - T_START + age
    log(f"host: in the window {core.host_report(w.host0, w.host1, seconds)}; after it a fixed pure-Python "
        f"loop took {host_probe_ms():.1f} ms")
    try:
        if trace and w.trace_path is not None:
            ctx["trace"] = core.read_trace(w)
        device_line = core.device_line(device, cell["chips"])
        checks = ctx["_check"]()
    finally:
        if "_cleanup" in ctx:
            ctx["_cleanup"]()
        import shutil

        shutil.rmtree(scratch, ignore_errors=True)
    metrics = core.read_metrics(core.metrics_for(bench, cell, trace), ctx, trace)
    found = core.forbidden_modules()
    if found:
        raise core.BenchError(f"forbidden modules loaded in the run: {found}")
    line = {
        "correct": all(v <= lim for _, v, lim in checks),
        "attempted": ctx["attempted"],
        "failed": ctx["failed"],
        "metrics": metrics,
        "device": device_line,
    }
    if trace and ctx.get("trace"):
        tr = ctx["trace"]
        from bftbench.drivers.common import dispatch_metrics

        log(f"trace: busy {tr['busy_s']} s of {tr['window_s']} s; dispatches "
            f"{dispatch_metrics(ctx.get('dispatch_rows', []), tr['kernel_s'], device)}")
        line["device"]["busy_s"] = tr["busy_s"]
        line["device"]["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except core.BenchError as e:
        log(f"bftbench: {e}")
        return 2
    for n, c in line["checks"].items():
        log(f"check {n} = {c['value']} (limit {c['limit']})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # daemon threads of the program (the verify scheduler's dispatcher,
    # the host plane) end with the process
    os._exit(code)
