"""Batch signature verification backends (reference crypto/batch).

Mirrors the JAX package's ``crypto/batch.py`` registry: callers
accumulate (pubkey, msg, sig) triples and call ``verify()`` or
``verify_async()``.

- ``CpuBatchVerifier`` — sequential ZIP-215 on the host (OpenSSL with
  the pure-Python liberal check behind it): the correctness baseline.
- ``CudaBatchVerifier`` — registered as ``"cuda"``, the default: every
  ed25519 lane goes to the GPU kernels (``ops/ed25519.py``) in one
  dispatch; lanes of any other key type verify on the host and the
  verdicts are re-interleaved (the mixed-curve split). The calibrated
  host-vs-device routing of the JAX package waits for the scheduler
  slice: here ed25519 lanes always go to the device.
"""

from __future__ import annotations

from typing import List, Tuple

from ..device import resolve
from .keys import Ed25519PubKey, PubKey


class ResolvedVerdicts:
    """Already-computed verdicts behind the async-handle interface."""

    def __init__(self, all_ok: bool, oks: List[bool]) -> None:
        self._res = (all_ok, oks)

    def result(self) -> Tuple[bool, List[bool]]:
        return self._res


class _PendingVerdicts:
    """In-flight device dispatch: host lanes already in ``oks``;
    ``result()`` fills the ed25519 lanes from the device handle."""

    __slots__ = ("_handle", "_ed_idx", "_oks")

    def __init__(self, handle, ed_idx, oks) -> None:
        self._handle = handle
        self._ed_idx = ed_idx
        self._oks = oks

    def result(self) -> Tuple[bool, List[bool]]:
        oks = self._oks
        for i, v in zip(self._ed_idx, self._handle.result()):
            oks[i] = bool(v)
        return all(oks) and bool(oks), oks


class BatchVerifier:
    """Accumulate signatures, verify all at once; add() order is kept
    and verify() returns (all_ok, per_item_ok)."""

    def __init__(self) -> None:
        self.items: List[Tuple[PubKey, bytes, bytes]] = []

    def add(self, pk: PubKey, msg: bytes, sig: bytes) -> None:
        self.items.append((pk, msg, sig))

    def __len__(self) -> int:
        return len(self.items)

    def verify(self) -> Tuple[bool, List[bool]]:
        return self.verify_async().result()

    def verify_async(self):
        raise NotImplementedError


class CpuBatchVerifier(BatchVerifier):
    """Sequential host verification."""

    def verify_async(self):
        oks = [pk.verify(msg, sig) for pk, msg, sig in self.items]
        return ResolvedVerdicts(all(oks) and bool(oks), oks)


class CudaBatchVerifier(BatchVerifier):
    """ed25519 lanes to the GPU kernels, everything else to the host.
    ``device="cpu"`` runs the kernels' plain versions instead."""

    def __init__(self, device=None) -> None:
        super().__init__()
        self.device = resolve(device)

    def verify_async(self):
        from ..ops import ed25519 as _ed

        ed_idx, ed_items = [], []
        oks = [False] * len(self.items)
        for i, (pk, msg, sig) in enumerate(self.items):
            if isinstance(pk, Ed25519PubKey):
                ed_idx.append(i)
                ed_items.append((msg, pk.key_bytes, sig))
            else:
                oks[i] = pk.verify(msg, sig)
        if not ed_items:
            return ResolvedVerdicts(all(oks) and bool(oks), oks)
        handle = _ed.verify_batch_async(ed_items, device=self.device)
        return _PendingVerdicts(handle, ed_idx, oks)


_default_backend = "cuda"

# Backend registry: every coalesced caller goes through
# create_batch_verifier(), so the backend selected here serves all of
# them. A factory takes the ``device`` keyword.
_BACKENDS = {
    "cuda": CudaBatchVerifier,
    "cpu": lambda device=None: CpuBatchVerifier(),
}


def set_default_backend(name: str) -> None:
    """Process-wide backend for create_batch_verifier ("cuda", "cpu")."""
    global _default_backend
    if name not in _BACKENDS:
        raise ValueError(f"unknown backend {name!r}; have {tuple(_BACKENDS)}")
    _default_backend = name


def create_batch_verifier(device=None) -> BatchVerifier:
    """Factory mirroring crypto/batch.CreateBatchVerifier: the
    configured backend ("cuda" by default) on ``device``."""
    return _BACKENDS[_default_backend](device=device)
