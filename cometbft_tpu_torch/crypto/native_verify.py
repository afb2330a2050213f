"""Loader of the native chunk verifier (``native/batchverify.cpp``).

The port's counterpart of the JAX package's ``crypto/native_verify.py``.
The C++ source lives at the repository root, outside both packages,
and is read, never written. ``utils/native.py`` builds it on first use
with ``g++`` into ``build/native/_batchverify.so`` at the repository
root (git-ignored; rebuilt when the source is newer), by the routine
that builds the other native lanes, and loads it as a CPython
extension. The JAX package keeps its own build elsewhere; the two never
share a library.

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

import struct
from typing import List, Optional

from ..utils import native
from .keys import Ed25519PubKey

# blocking: the host plane's worker threads call it, never a loop
LANE = native.Lane("batchverify", gate="GRAFT_NATIVE_VERIFY", blocking=True,
                   check=lambda mod: mod.available())


def module():
    """The extension module, or None (no compiler, no Python headers,
    no libcrypto, or disabled; ``LANE.reason`` says which)."""
    return LANE.module()


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
