"""Kernel loader: nvcc build, ctypes binding, launch counters.

Every CUDA source in ``csrc/`` is compiled by its own ``nvcc`` into a
shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), loaded with ``ctypes``. All sources are built
together, in parallel, the first time any kernel is asked for; the
libraries go to ``build/kernels/`` at the repository root (listed in
``.gitignore``) and are rebuilt when a source is newer than its
library.

Each C entry point returns ``cudaGetLastError()``; :func:`launch`
raises on anything but 0. Each kernel wrapper adds one to its counter
in ``LAUNCHES`` exactly where it launches, so a run can show which
kernels it went through.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

# kernel name -> source file; one shared library per source
SOURCES = {
    "ladder": "ladder.cu",
    "decompress": "decompress.cu",
    "hash_digits": "hash_digits.cu",
}

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points and their argument types (pointers and the stream as
# c_void_p: a plain int argument would be cut to 32 bits)
SIGNATURES = {
    "ladder": {
        "ladder_set_btable": [_P],
        "straus_launch": [_P, _P, _I, _P, _I, _P, _P, _P],
        "verify_launch": [
            _P, _P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P,
        ],
    },
    "decompress": {"decompress_launch": [_P, _I, _I, _P, _I, _P, _P]},
    "hash_digits": {
        "hash_digits_launch": [
            _P, _I, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P,
        ],
    },
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

LAUNCHES = {name: 0 for name in SOURCES}
BUILD_INFO: dict = {}

_libs: dict = {}
_lock = threading.Lock()


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    so = _lib_path(name)
    if not so.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir())
    return so.stat().st_mtime < newest


def _ptxas_summary(log: str) -> list:
    """Per compiled function: registers, spill stores and loads."""
    out = []
    func = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line) or re.search(
            r"Function properties for (\S+)", line
        )
        if m:
            func = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and func and not any(o["function"] == func for o in out):
            out.append({"function": func, "spill_stores": int(m.group(1)),
                        "spill_loads": int(m.group(2))})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and func and out and out[-1]["function"] == func:
            out[-1]["registers"] = int(m.group(1))
    return out


def build_all(force: bool = False) -> dict:
    """Build every stale source, one nvcc per source, all at once.
    Returns BUILD_INFO: per kernel its seconds and ptxas summary.
    Raises with nvcc's output when a build fails."""
    with _lock:
        todo = [n for n in SOURCES if force or _stale(n)]
        if not todo:
            return BUILD_INFO
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for name in todo:
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o",
                   str(_lib_path(name)), str(CSRC / SOURCES[name])]
            procs[name] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
        failed = []
        logs = []
        for name, proc in procs.items():
            out, _ = proc.communicate()
            secs = time.perf_counter() - t0
            logs.append(f"== {name} ({secs:.1f}s, rc={proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(name)
            BUILD_INFO[name] = {"seconds": round(secs, 2),
                                "ptxas": _ptxas_summary(out)}
        (BUILD_DIR / "build.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError(
                f"nvcc failed for {failed}:\n" + "\n".join(logs)[-8000:]
            )
        return BUILD_INFO


def load(name: str, on_load=None) -> ctypes.CDLL:
    """The built library of kernel ``name`` with its argtypes set.
    ``on_load(lib)`` runs once, right after the first load."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all()
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            if on_load is not None:
                check(on_load(lib), f"{name} init")
            _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA error {rc} in {what}")


def launch(name: str, fn: str, *args, on_load=None) -> None:
    """Call C entry ``fn`` of kernel ``name``, raise on a CUDA error,
    and count the launch."""
    lib = load(name, on_load)
    check(getattr(lib, fn)(*args), f"{name}.{fn}")
    LAUNCHES[name] += 1


def require(t, dtype, shape) -> None:
    """Raise unless tensor ``t`` lies on a CUDA device with this dtype
    and shape."""
    if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"kernel input {tuple(t.shape)} {t.dtype} on {t.device}: "
            f"want {tuple(shape)} {dtype} on cuda"
        )


def require_rows(t, ld: int) -> None:
    """Raise unless ``t`` is rows of contiguous lanes, ``ld`` apart."""
    if t.stride(-1) != 1 or (t.dim() > 1 and t.stride(-2) != ld):
        raise ValueError(
            f"kernel input strides {t.stride()}: want lanes contiguous, "
            f"rows {ld} apart"
        )


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
