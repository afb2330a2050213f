"""Loader of the native chunk verifier (``native/batchverify.cpp``).

The port's counterpart of the JAX package's ``crypto/native_verify.py``.
The C++ source lives at the repository root, outside both packages,
and is read, never written. It is built on first use with ``g++`` into
``build/native/_batchverify.so`` at the repository root (git-ignored;
rebuilt when the source is newer) and loaded as a CPython extension.
The JAX package keeps its own build elsewhere; the two never share a
library.

Why it exists: per lane, the Python path makes several short ctypes
calls with the GIL taken back between them, so the host plane's
threads convoy on the GIL. The extension verifies a whole chunk in one
call with the GIL released for the whole C loop.

Verdicts are exactly ``keys.Ed25519PubKey.verify``'s: OpenSSL (RFC
8032, the strict subset of ZIP-215) accepts → True; OpenSSL rejects →
the lane runs ``pk.verify`` itself, liberal check included. Lanes of
other key types and malformed lengths run ``pk.verify`` unchanged.
``GRAFT_NATIVE_VERIFY=0`` disables the extension, as in the JAX
package.
"""

from __future__ import annotations

import importlib.util
import os
import struct
import subprocess
import sysconfig
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

from .keys import Ed25519PubKey

_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _ROOT / "native" / "batchverify.cpp"
_SO = _ROOT / "build" / "native" / "_batchverify.so"

_mod = None
_tried = False
_lock = threading.Lock()


def _build() -> None:
    """g++ into a temporary name beside the target, then an atomic
    rename: concurrent processes never load a half-written library."""
    _SO.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_SO.parent)
    os.close(fd)
    try:
        subprocess.run(
            [
                "g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                "-I", sysconfig.get_paths()["include"],
                str(_SRC), "-ldl", "-o", tmp,
            ],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def module():
    """The extension module, or None (no compiler, no Python headers,
    no libcrypto, or disabled)."""
    global _mod, _tried
    if _tried:
        return _mod
    with _lock:
        if _tried:
            return _mod
        _tried = True
        if os.environ.get("GRAFT_NATIVE_VERIFY") == "0":
            return None
        try:
            if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
                _build()
            spec = importlib.util.spec_from_file_location("_batchverify", _SO)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            if mod.available():
                _mod = mod
        except (OSError, ImportError, subprocess.CalledProcessError):
            _mod = None
        return _mod


def verify_chunk(items) -> Optional[List[bool]]:
    """Verdicts for [(pk, msg, sig)] through ONE GIL-releasing native
    call, or None when the extension is unavailable (the caller then
    runs the per-lane Python loop)."""
    mod = module()
    if mod is None:
        return None
    n = len(items)
    ed_idx: List[int] = []
    pubs = bytearray()
    sigs = bytearray()
    msgs = bytearray()
    lens: List[int] = []
    for i, (pk, msg, sig) in enumerate(items):
        if isinstance(pk, Ed25519PubKey) and len(pk.key_bytes) == 32 and len(sig) == 64:
            ed_idx.append(i)
            pubs += pk.key_bytes
            sigs += sig
            msgs += msg
            lens.append(len(msg))
    oks = [False] * n
    if ed_idx:
        verdicts = mod.verify_ed25519(
            bytes(pubs), bytes(sigs), bytes(msgs),
            struct.pack(f"={len(lens)}I", *lens), len(ed_idx),
        )
        for j, i in enumerate(ed_idx):
            if verdicts[j]:
                oks[i] = True
            else:
                # OpenSSL's rejection is not ZIP-215's: the lane takes
                # the full per-lane path, liberal check included
                pk, msg, sig = items[i]
                oks[i] = pk.verify(msg, sig)
    covered = set(ed_idx)
    for i in range(n):
        if i not in covered:
            pk, msg, sig = items[i]
            oks[i] = pk.verify(msg, sig)
    return oks
