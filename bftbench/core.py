"""The harness: finds a cell's configuration, traffic mix, metrics and
driver by name, holds the measured window, reads the device trace, and
builds the result line.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives: ``configs/<config>.json``, ``traffic/<traffic>.json`` (whose
``driver`` key names a module of ``drivers/``), ``e2e/<metric>.py`` and
``metrics/<metric>.py`` (each with ``read(ctx)``, which returns a
number, or None when the run has nothing to read for it).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# whole top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "cometbft_tpu")


class BenchError(Exception):
    """The run cannot give a result (no card, unknown cell, a forbidden
    module loaded): nothing is printed on standard output."""


# --- finding things by name ---------------------------------------------------


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise BenchError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise BenchError(f"no workload named {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise BenchError(f"no {kind} file {path.name}")
    return json.loads(path.read_text())


def load_config(bench: dict, name: str) -> dict:
    for cfg in bench["configs"]:
        if cfg["name"] == name:
            return json.loads((ROOT / cfg["file"]).read_text())
    raise BenchError(f"no config named {name!r} in BENCHMARK.json")


def load_driver(traffic: dict):
    return importlib.import_module(f"bftbench.drivers.{traffic['driver']}")


def _load_reader(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no reader {kind}/{path.name}")
    spec = importlib.util.spec_from_file_location(f"bftbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, cell: dict, trace: bool) -> list:
    """The cell's metric entries: its end-to-end ones, or with ``trace``
    its per-layer ones; an entry with ``workloads`` counts only there."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if cell["name"] in m.get("workloads", [cell["name"]])]


def read_metrics(entries: list, ctx: dict, trace: bool) -> dict:
    kind = "metrics" if trace else "e2e"
    out = {}
    for m in entries:
        value = _load_reader(kind, m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


# --- window arithmetic --------------------------------------------------------


def rate(done_times, t0: float, t1: float) -> float:
    """Completions in [t0, t1] over the window's seconds: all the work
    and all the time of the window."""
    return sum(1 for t in done_times if t0 <= t <= t1) / (t1 - t0)


def percentile(values, q: float) -> float:
    """The nearest-rank q-quantile of every value."""
    if not values:
        raise ValueError("no values")
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


# --- the measured window ------------------------------------------------------


class Window:
    """The measured window. ``start()`` marks its first timed request;
    with ``trace`` the profiler runs from there to ``stop()``, and
    ``host_spans`` collects (name, start ns, end ns) on the monotonic
    clock, from the program's tracers and the drivers' own marks."""

    def __init__(self, seconds: float, trace: bool, device, scratch: Path):
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.scratch = scratch
        self.t0 = None
        self.host_spans: list = []
        self._prof = None
        self._sync = None
        self.trace_path = None

    def observe(self, name, dur_ns, args) -> None:
        """A tracer observer: a completed span ends now."""
        if dur_ns:
            end = time.monotonic_ns()
            self.host_spans.append((name, end - dur_ns, end))

    def mark(self, name: str):
        """A span of the driver's own around a call into the program."""
        return _Mark(self, name)

    def start(self) -> float:
        if self.trace and self.device.type == "cuda":
            import torch

            self._prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            self._prof.start()
            with torch.profiler.record_function("bftbench.sync"):
                self._sync = time.monotonic_ns()
        self.host0 = host_sample()
        self.t0 = time.perf_counter()
        self.mono0 = time.monotonic_ns()
        return self.t0

    @property
    def end(self) -> float:
        return self.t0 + self.seconds

    def stop(self) -> None:
        """After the window's last answer: the trace is read over the
        window's nominal length at most."""
        self.mono1 = min(time.monotonic_ns(), self.mono0 + int(self.seconds * 1e9))
        self.host1 = host_sample()
        if self._prof is not None:
            import torch

            torch.cuda.synchronize(self.device)
            self._prof.stop()
            self.trace_path = self.scratch / "trace.json"
            self._prof.export_chrome_trace(str(self.trace_path))
            self._prof = None


def host_sample() -> tuple:
    """(this process's CPU seconds, CPU seconds by kind of thread): to
    tell a slow host from a slow program, and which threads spend it."""
    return time.process_time(), thread_cpu()


def thread_cpu() -> dict:
    """CPU seconds of this process's threads from /proc, summed by name:
    Python's thread names with their numbers cut, else the kernel's
    (the CUDA and OpenMP threads); empty where /proc cannot be read."""
    import re
    import threading

    names = {t.native_id: re.sub(r"[-_]?\d+$", "", t.name) for t in threading.enumerate()}
    out: dict = {}
    tick = os.sysconf("SC_CLK_TCK")
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                comm, rest = f.read().rsplit(")", 1)
            fields = rest.split()
            cpu = (int(fields[11]) + int(fields[12])) / tick
        except (OSError, ValueError, IndexError):
            continue
        name = names.get(int(tid)) or comm.split("(", 1)[1] + " (native)"
        out[name] = out.get(name, 0.0) + cpu
    return out


def host_report(a: tuple, b: tuple, seconds: float) -> str:
    """The window's host use, for the log: no metric reads it."""
    by = {k: v - a[1].get(k, 0.0) for k, v in b[1].items()}
    top = ", ".join(f"{k} {v:.2f}" for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:6])
    return f"this process used {b[0] - a[0]:.2f} s of CPU in {seconds:.2f} s; by thread: {top}"


class _Mark:
    __slots__ = ("w", "name", "t")

    def __init__(self, w, name):
        self.w, self.name = w, name

    def __enter__(self):
        self.t = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        self.w.host_spans.append((self.name, self.t, time.monotonic_ns()))
        return False


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_trace(w: Window, top: int = 10) -> dict:
    """From the exported trace: device busy seconds within the window
    (the union of kernels, copies and sets), the window's length, kernel
    seconds by name, the device ops that took most time, and the idle
    gaps summed by what the host was doing (the shortest host span
    around each gap's middle, else ``host.other``)."""
    events = json.loads(w.trace_path.read_text())["traceEvents"]
    sync = [e for e in events if e.get("name") == "bftbench.sync" and "ts" in e]
    if not sync:
        return {}
    # profiler microseconds -> monotonic nanoseconds
    off_ns = w._sync - sync[0]["ts"] * 1e3
    lo, hi = w.mono0, w.mono1
    spans = []
    by_name: dict = {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a = e["ts"] * 1e3 + off_ns
        b = a + e["dur"] * 1e3
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        spans.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) / 1e9
    spans.sort()
    busy = 0.0
    gaps = []
    cur_a = cur_b = None
    last = lo
    for a, b in spans:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            if a > last:
                gaps.append((last, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
        last = max(last, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    if hi > last:
        gaps.append((last, hi))
    host = sorted(w.host_spans, key=lambda s: s[1])
    labelled: dict = {}
    starts = [s[1] for s in host]
    import bisect

    for a, b in gaps:
        mid = (a + b) / 2
        best = None
        # spans starting before the middle; the shortest that covers it
        for s in host[: bisect.bisect_right(starts, mid)][-4096:]:
            if s[2] >= mid and (best is None or s[2] - s[1] < best[2] - best[1]):
                best = s
        name = best[0] if best is not None else "host.other"
        labelled[name] = labelled.get(name, 0.0) + (b - a) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": busy / 1e9,
        "window_s": (hi - lo) / 1e9,
        "kernel_s": by_name,
        "device_ops": [[k, v] for k, v in ops[:top]],
        "idle_gaps": [[k, v] for k, v in sorted(labelled.items(), key=lambda kv: -kv[1])[:top]],
    }


# --- the card -----------------------------------------------------------------


def card(chips: int):
    """The first CUDA device, after checking that the cell's cards are there."""
    import torch

    if not torch.cuda.is_available():
        raise BenchError("torch.cuda.is_available() is false: this benchmark runs on an NVIDIA GPU")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} cards, {torch.cuda.device_count()} are visible")
    return torch.device("cuda", 0)


def device_line(device, chips: int) -> dict:
    import torch

    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
        return {"platform": "gpu", "kind": kind, "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def scratch_dir() -> Path:
    """Where a run keeps its working files: under TMPDIR."""
    import tempfile

    return Path(tempfile.mkdtemp(prefix="bftbench_"))


def cache_env(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = root / "build" / "bftbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))
