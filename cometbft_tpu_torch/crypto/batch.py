"""Batch signature verification backends (reference crypto/batch).

The port's counterpart of the JAX package's ``crypto/batch.py``:
callers accumulate (pubkey, msg, sig) triples and call ``verify()`` or
``verify_async()``. Backends live in a registry (``register_backend``)
and every coalesced caller gets the one ``create_batch_verifier``
returns:

- ``CpuBatchVerifier`` (``"cpu"``) — sequential ZIP-215 on the host:
  the correctness baseline.
- ``CpuParallelBatchVerifier`` (``"cpu-parallel"``) — the multi-core
  host plane (``crypto/parallel_verify``): lanes fan out in calibrated
  chunks over a persistent pool, verdicts merge in input order,
  bit-identical to the serial backend.
- ``CudaBatchVerifier`` (``"cuda"``, the default) — one ticket on the
  verify scheduler (``crypto/scheduler.py``), which sends the ed25519
  lanes to the GPU kernels (``ops/ed25519.py``) or to the host plane by
  the measured host-vs-device crossover (``route_to_device``,
  ``_Calibration``); lanes of any other key type verify on the host
  and the verdicts are re-interleaved (the mixed-curve split).
- ``MeshBatchVerifier`` (``"mesh"``, ``crypto/mesh_backend.py``) — the
  ed25519 lanes on the cards with no calibration gate, split over
  every CUDA device when more than one is visible, or the host plane
  when none is.

Every factory takes the ``device`` keyword, resolved first:
``None`` is the GPU and raises without one; ``"cpu"`` is allowed.
"""

from __future__ import annotations

import threading
from typing import List, Tuple

from ..device import resolve
from .keys import Ed25519PubKey, PubKey

# Floor below which the device is never considered (the JAX package's
# ``_MIN_TPU_BATCH`` / ``set_min_tpu_batch``). The real cutoff is
# measured at run time (``_Calibration``). A floor <= 1 FORCES the
# device route and bypasses calibration: tests and chip_smoke.py's
# pinned main-path phase rely on that. On ``device="cpu"`` the forced
# route runs the kernels' plain versions.
_MIN_DEVICE_BATCH = 64


def set_min_device_batch(n: int) -> None:
    global _MIN_DEVICE_BATCH
    _MIN_DEVICE_BATCH = n


class _Calibration:
    """Measured host-vs-device crossover (the reference's dual path —
    per-vote single verify against a batch, types/validation.go:15-21 —
    made measurement-driven).

    Model: device_wall(n) = flat_s + n * lane_s; host_wall(n) =
    n * host_s. ``flat_s`` and ``host_s`` are EWMAs of observed walls;
    ``lane_s`` is a constant. A device wall runs from just before
    ``verify_batch_async`` (host packing and the copies included) to
    the dispatch's CUDA event; a host wall is the host plane's
    multi-core wall per lane. Only unforced dispatches on a CUDA device
    are observed (``scheduler._dispatch_device``): a forced one, or the
    plain versions on the CPU, says nothing of the card. Samples that
    look like a build (wall over _COMPILE_CUTOFF_S, or a first sample
    over 1 s: the first call builds the kernels with nvcc) never enter
    the EWMA.

    The seeds were measured on the card's machine by chip_smoke.py's
    dispatch phase (its "fit"; PERF.md names the run), NVIDIA H100
    80GB HBM3, power limit 700.00 W: ``lane_s`` and ``flat_s`` are the
    slope and intercept of the device route's median walls at 150,
    4,740 and 32,768 lanes, ``host_s`` the host plane's median wall per
    lane at 32,768 (8 worker threads on that machine's 8 cores).
    """

    _COMPILE_CUTOFF_S = 10.0
    _ALPHA = 0.4
    EXPLORE_EVERY = 256
    # No real dispatch and fetch completes under this; a shorter wall
    # is an artifact of a wait that did not block, and would pull
    # flat_s optimistic.
    _WALL_FLOOR_S = 2e-4

    def __init__(self) -> None:
        # the card's seeds: NVIDIA H100 80GB HBM3, 700.00 W, 8-core host
        self.host_s = 2.96e-5
        self.lane_s = 3.36e-6
        self.flat_s = 5.49e-4
        self.device_samples = 0
        self._host_streak = 0
        self._lock = threading.Lock()

    def observe_host(self, n: int, wall: float) -> None:
        if n <= 0 or wall <= 0:
            return
        with self._lock:
            self.host_s += self._ALPHA * (wall / n - self.host_s)

    def observe_device(self, n: int, wall: float) -> None:
        if n <= 0 or not (self._WALL_FLOOR_S <= wall < self._COMPILE_CUTOFF_S):
            return
        with self._lock:
            # a process's first dispatch builds the kernels: a wall of
            # seconds would freeze routing on the host for good
            if self.device_samples == 0 and wall >= 1.0:
                return
            flat_obs = max(wall - n * self.lane_s, 1e-5)
            self.flat_s += self._ALPHA * (flat_obs - self.flat_s)
            self.device_samples += 1

    def device_wins(self, n: int) -> bool:
        with self._lock:
            return self.flat_s + n * self.lane_s < n * self.host_s

    def should_explore(self) -> bool:
        """Recovery for a poisoned flat_s: a stall that slips past the
        build filter inflates the EWMA, every batch then routes to the
        host, and without device traffic the estimate could never heal.
        Every EXPLORE_EVERY host-routed eligible batches, one goes to
        the device anyway."""
        with self._lock:
            self._host_streak += 1
            if self._host_streak >= self.EXPLORE_EVERY:
                self._host_streak = 0
                return True
            return False

    def note_device_used(self) -> None:
        with self._lock:
            self._host_streak = 0

    def crossover(self) -> int:
        """Smallest batch the device is predicted to win."""
        with self._lock:
            margin = self.host_s - self.lane_s
            if margin <= 0:
                return 1 << 30
            return max(1, int(self.flat_s / margin) + 1)

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "flat_s": self.flat_s,
                "lane_s": self.lane_s,
                "host_s": self.host_s,
                "device_samples": self.device_samples,
            }
        out["crossover"] = self.crossover()
        return out


calibration = _Calibration()

# Last routing decision (which path the calibrated dispatch chose).
LAST_ROUTE = {"path": None, "n": 0, "crossover": None}


def split_curves(items):
    """(ed_idx, ed_items, other_idx): the ed25519 lanes as kernel items
    (msg, key bytes, sig) and the indices of every other lane."""
    ed_idx: List[int] = []
    ed_items = []
    other_idx: List[int] = []
    for i, (pk, msg, sig) in enumerate(items):
        if isinstance(pk, Ed25519PubKey):
            ed_idx.append(i)
            ed_items.append((msg, pk.key_bytes, sig))
        else:
            other_idx.append(i)
    return ed_idx, ed_items, other_idx


def route_to_device(n_ed: int, device) -> bool:
    """The verify scheduler's routing decision for n_ed ed25519 lanes
    of a "cuda"-backend ticket on ``device``. Unforced, a CPU device
    always routes to the host plane (the plain versions never beat
    OpenSSL); forced (floor <= 1), the device route is taken whatever
    the calibration says."""
    forced = _MIN_DEVICE_BATCH <= 1
    use_device = n_ed >= _MIN_DEVICE_BATCH and (
        forced
        or (
            device.type == "cuda"
            and (calibration.device_wins(n_ed) or calibration.should_explore())
        )
    )
    if use_device and not forced:
        calibration.note_device_used()
    LAST_ROUTE.update(
        path="device" if use_device else "host",
        n=n_ed,
        crossover=None if forced else calibration.crossover(),
    )
    return use_device


def _verdicts(oks: List[bool]) -> Tuple[bool, List[bool]]:
    return all(oks) and bool(oks), oks


class ResolvedVerdicts:
    """Already-computed verdicts behind the async-handle interface."""

    def __init__(self, all_ok: bool, oks: List[bool]) -> None:
        self._res = (all_ok, oks)

    def result(self) -> Tuple[bool, List[bool]]:
        return self._res


class _PendingParallelVerdicts:
    """In-flight host-plane batch behind the async-handle interface."""

    __slots__ = ("_handle",)

    def __init__(self, handle) -> None:
        self._handle = handle

    def result(self) -> Tuple[bool, List[bool]]:
        return _verdicts(self._handle.result())


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
        return ResolvedVerdicts(*_verdicts([pk.verify(m, s) for pk, m, s in self.items]))


class CpuParallelBatchVerifier(BatchVerifier):
    """The multi-core host plane: lanes fan out over the shared engine
    (``crypto/parallel_verify.engine()``); verdicts are bit-identical
    to ``CpuBatchVerifier`` and order-stable, and ``verify_async()``
    really enqueues."""

    def verify_async(self):
        from .parallel_verify import engine

        return _PendingParallelVerdicts(engine().verify_async(self.items))


class CudaBatchVerifier(BatchVerifier):
    """ed25519 lanes to the GPU kernels or to the host plane, by the
    calibrated crossover; everything else to the host."""

    def __init__(self, device=None) -> None:
        super().__init__()
        self.device = resolve(device)

    def verify_async(self):
        """One ticket on the shared verify scheduler
        (``crypto/scheduler.py``), routed as the "cuda" backend: the
        ticket's ``result()`` gives ``(all_ok, oks)``."""
        from .scheduler import scheduler

        return scheduler().submit(self.items, device=self.device, backend="cuda")


def _mesh_factory(device):
    from .mesh_backend import MeshBatchVerifier

    return MeshBatchVerifier(device=device)


_default_backend = "cuda"
_lock = threading.Lock()

# Backend registry: every coalesced caller goes through
# create_batch_verifier(), so the backend selected here serves all of
# them. A factory takes the resolved ``device`` keyword.
_BACKENDS = {
    "cuda": CudaBatchVerifier,
    "cpu": lambda device: CpuBatchVerifier(),
    "cpu-parallel": lambda device: CpuParallelBatchVerifier(),
    "mesh": _mesh_factory,
}


def register_backend(name: str, factory) -> None:
    """Add or replace a named backend (factory: (device=) -> BatchVerifier)."""
    with _lock:
        _BACKENDS[name] = factory


def backends() -> Tuple[str, ...]:
    return tuple(_BACKENDS)


def default_backend() -> str:
    """Name of the backend create_batch_verifier() would build; the
    verify scheduler (``crypto/scheduler.py``) routes by it."""
    with _lock:
        return _default_backend


def set_default_backend(name: str) -> None:
    """Process-wide backend: any registered name ("cuda", "cpu",
    "cpu-parallel", "mesh", ...)."""
    global _default_backend
    with _lock:
        if name not in _BACKENDS:
            raise ValueError(f"unknown backend {name!r}; have {tuple(_BACKENDS)}")
        _default_backend = name


def config_backend(name: str) -> str:
    """The registry name for a ``[crypto] batch_backend`` value. The
    JAX package's "tpu" is its device route, so it means "cuda" here;
    "mesh" splits the lanes over every CUDA device
    (``crypto/mesh_backend.py``)."""
    return "cuda" if name == "tpu" else name


def create_batch_verifier(device=None, backend=None) -> BatchVerifier:
    """Factory mirroring crypto/batch.CreateBatchVerifier: the
    configured backend ("cuda" by default), or the one named, on
    ``device``."""
    dev = resolve(device)
    with _lock:
        factory = _BACKENDS[backend or _default_backend]
    return factory(device=dev)


def supports_batch_verification(pk: PubKey) -> bool:
    """Mirrors crypto/batch.SupportsBatchVerifier; the cuda verifier
    also takes mixed sets by splitting them."""
    return isinstance(pk, Ed25519PubKey)
