"""Kernel loader: nvcc build, ctypes binding, launch counters.

Every CUDA source in ``csrc/`` is compiled by its own ``nvcc`` into a
shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), loaded with ``ctypes``. All sources are built
together, in parallel, the first time any kernel is asked for; the
libraries go to ``build/kernels/`` at the repository root (listed in
``.gitignore``) and are rebuilt when a source is newer than its
library.

Each C entry point returns ``cudaGetLastError()``; :func:`launch`
raises on anything but 0. ``BUILD_INFO`` keeps, per kernel, what
``ptxas -v`` reported; :func:`sass` counts chosen instructions in a
built library's SASS, for reports only. Each kernel wrapper adds one to
its counter in ``LAUNCHES`` exactly where it launches, so a run can
show which kernels it went through.
"""

from __future__ import annotations

import ctypes
import importlib.util
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
        "ladder_init": [_P],
        "straus_launch": [_P, _P, _I, _P, _I, _P, _P],
        "verify_launch": [_P, _P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P],
        "ladder_info": [_I, _P],
    },
    "decompress": {
        "decompress_launch": [_P, _I, _I, _P, _I, _P, _P],
        "decompress_info": [_P],
    },
    "hash_digits": {
        "hash_digits_launch": [
            _P, _I, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P,
        ],
        "hash_digits_info": [_P],
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
    """Whether kernel ``name``'s library is missing or older than its
    source or the field layer every source includes."""
    so = _lib_path(name)
    if not so.exists():
        return True
    deps = (CSRC / SOURCES[name], CSRC / "fe25519.cuh")
    return so.stat().st_mtime < max(p.stat().st_mtime for p in deps)


def _ptxas_summary(log: str) -> list:
    """Per compiled function: stack frame, spill stores and loads, and,
    for entry functions, registers and static shared memory bytes."""
    out = []
    func = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line) or re.search(
            r"Function properties for (\S+)", line
        )
        if m:
            func = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and func and not any(o["function"] == func for o in out):
            out.append({"function": func, "stack_frame": int(m.group(1)),
                        "spill_stores": int(m.group(2)),
                        "spill_loads": int(m.group(3))})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and func and out and out[-1]["function"] == func:
            out[-1]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[-1]["smem"] = int(smem.group(1)) if smem else 0
    return out


# SASS instructions counted per function: the 32 x 32 -> 64 products,
# the exchanges between threads, global loads, block barriers, and what
# would mean a call or local memory (spills, arrays the compiler could
# not keep in registers)
SASS_OPS = ("IMAD.WIDE", "SHFL", "LDS", "STS", "LDG", "BAR", "LDL", "STL", "CALL")


def _cuobjdump():
    """cuobjdump from PATH, the CUDA toolkit or Triton's package, or None."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    if cand.exists():
        return str(cand)
    spec = importlib.util.find_spec("triton")
    for loc in (spec.submodule_search_locations or []) if spec else []:
        cand = Path(loc) / "backends" / "nvidia" / "bin" / "cuobjdump"
        if cand.exists():
            return str(cand)
    return None


def sass_counts(sass: str) -> dict:
    """Static counts, per function of ``cuobjdump -sass`` output, of the
    instructions in ``SASS_OPS`` (by mnemonic, any suffix) and in all."""
    out = {}
    func = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = out.setdefault(m.group(1), {**dict.fromkeys(SASS_OPS, 0), "total": 0})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and func is not None:
            op = m.group(1)
            func["total"] += 1
            if op.startswith("IMAD.WIDE"):
                func["IMAD.WIDE"] += 1
            elif op.split(".")[0] in SASS_OPS:
                func[op.split(".")[0]] += 1
    return out


def sass(name: str, timeout: float = 120):
    """:func:`sass_counts` of kernel ``name``'s built library, or why
    there are none (no cuobjdump, or it failed or timed out)."""
    tool = _cuobjdump()
    if tool is None:
        return "cuobjdump not found"
    try:
        res = subprocess.run([tool, "-sass", str(_lib_path(name))],
                             capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return f"cuobjdump timed out after {timeout} s"
    if res.returncode != 0:
        return f"cuobjdump failed: {res.stderr.strip()[-300:]}"
    return sass_counts(res.stdout)


def nvcc_command(src: Path, lib: Path, nvcc: str | None = None) -> list:
    """The nvcc command line that builds ``src`` into the shared library
    ``lib`` (the kernels' flags; csrc/ on the include path)."""
    return [nvcc or _nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(lib), str(src)]


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
            procs[name] = subprocess.Popen(
                nvcc_command(CSRC / SOURCES[name], _lib_path(name), nvcc),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
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
