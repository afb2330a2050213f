"""Multi-device batch-verification backend (registered as "mesh").

The port's counterpart of the JAX package's ``crypto/mesh_backend.py``:
a config-selectable backend (``[crypto] batch_backend = "mesh"``) whose
ed25519 lanes go to the cards through ``ops/ed25519.verify_batch_async``
on the verifier's device. That splits them over every CUDA device when
more than one is visible (``parallel/mesh.mesh_for``); each card
verifies its contiguous slice and the verdicts come back in lane
order. With one card the batch runs there unsharded.

With no card at all the batch verifies on the cpu-parallel host plane,
as the JAX backend does without a mesh: a routing choice, which a
scheduler ticket reports as ``backend == "mesh-degraded"``. Unlike the
"cuda" backend there is no calibration gate: the operator chose the
device plane, so any batch at or above the device floor
(``batch._MIN_DEVICE_BATCH``; ``set_min_device_batch(1)`` forces) goes
to the cards. How a dispatch ran is in ``ops/ed25519.LAST_DISPATCH``.

Departures from the JAX package: there, fewer than two devices is no
mesh and the batch degrades to the host even with one card present;
here one card takes it. And a mesh dispatch that fails degrades to the
host plane there; here it raises ``crypto/scheduler.DeviceRouteError``
chained to its cause (C3), and no lane gets a host verdict in its
place.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..device import resolve
from ..utils.log import get_logger
from . import batch as crypto_batch
from .batch import BatchVerifier, ResolvedVerdicts, split_curves

_log = get_logger("crypto.mesh")


def mesh_devices() -> int:
    """The CUDA device count, 0 without CUDA: with none, a mesh-backend
    batch degrades to the host plane."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def use_mesh(n_ed: int, devices: int) -> bool:
    """Whether n_ed ed25519 lanes of a mesh-backend batch go to the
    device: ``devices`` (``mesh_devices()``) are visible and the batch
    reaches the device floor."""
    return devices > 0 and n_ed > 0 and n_ed >= crypto_batch._MIN_DEVICE_BATCH


def _route_error(n: int, exc: BaseException):
    from .scheduler import DeviceRouteError

    _log.error("mesh dispatch failed; the batch raises", err=repr(exc), lanes=n)
    err = DeviceRouteError(f"mesh route failed ({n} lanes): {exc!r}")
    err.__cause__ = exc
    return err


class _PendingMeshVerdicts:
    """An in-flight mesh dispatch behind the async-handle interface."""

    def __init__(self, handle, ed_idx, oks) -> None:
        self._handle = handle
        self._ed_idx = ed_idx
        self._oks = oks

    def result(self) -> Tuple[bool, List[bool]]:
        try:
            verdicts = self._handle.wait().result()
        except Exception as e:
            raise _route_error(len(self._ed_idx), e) from e
        oks = self._oks
        for i, v in zip(self._ed_idx, verdicts):
            oks[i] = bool(v)
        return all(oks) and bool(oks), oks


class MeshBatchVerifier(BatchVerifier):
    """Sends the ed25519 lanes to the device (over every card when more
    than one is visible); verifies them on the cpu-parallel host plane
    when no card exists or the batch is below the floor. Lanes of other
    curves verify on the host."""

    def __init__(self, device=None) -> None:
        super().__init__()
        self.device = resolve(device)

    def _host(self, oks, ed_idx, other_idx) -> Tuple[bool, List[bool]]:
        if ed_idx:
            from .parallel_verify import engine

            verdicts = engine().verify([self.items[i] for i in ed_idx])
            for i, v in zip(ed_idx, verdicts):
                oks[i] = bool(v)
        self._other(oks, other_idx)
        return all(oks) and bool(oks), oks

    def _other(self, oks, other_idx) -> None:
        for i in other_idx:
            pk, msg, sig = self.items[i]
            oks[i] = pk.verify(msg, sig)

    def verify_async(self):
        ed_idx, ed_items, other_idx = split_curves(self.items)
        oks = [False] * len(self.items)
        if not use_mesh(len(ed_items), mesh_devices()):
            return ResolvedVerdicts(*self._host(oks, ed_idx, other_idx))
        from ..ops import ed25519 as _ed

        try:
            handle = _ed.verify_batch_async(ed_items, device=self.device)
        except Exception as e:
            raise _route_error(len(ed_items), e) from e
        self._other(oks, other_idx)
        return _PendingMeshVerdicts(handle, ed_idx, oks)

