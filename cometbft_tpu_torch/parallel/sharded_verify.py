"""Multi-device commit verification: signature lanes split over a mesh.

The port's counterpart of the JAX package's
``parallel/sharded_verify.py``. Two composable steps:

  1. ``make_sharded_core`` — each device of the mesh runs one K1-K3
     pass (``ops/ed25519.verify_lanes``) on its contiguous slice of
     the signature lanes, with no communication. Every dispatch of
     ``ops/ed25519.verify_batch_async`` runs through it; a mesh of one
     device is the unsharded dispatch.
  2. ``make_quorum_reducer`` — the weighted voting-power tally of the
     verdict lanes, one int32 partial a device, summed over the mesh,
     plus the quorum compare.

Together they mirror the reference's VerifyCommit semantics
(types/validation.go:30: sum the voting power of valid signatures,
compare against 2/3 of the total).

Where the JAX package compiles one ``shard_map`` program and reduces
with ``psum``, here each slice is copied to its device and launched on
that device's current stream, so the launches stay asynchronous and
two cards overlap; the verdicts come back in lane order. In one
process the tally's partials are copied to the mesh's first device and
added there; across processes (one card a rank) they are summed with
``torch.distributed.all_reduce``: NCCL on the cards, gloo on the CPU.

No partial fallback: a slice that fails raises, and the caller's
ticket fails with it (``crypto/scheduler.DeviceRouteError``). No lane
gets a host verdict in its place.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops import ed25519 as ed
from ..ops import fe25519 as fe

# "precomp_tuple" is the JAX package's pytree layout of the expanded
# keys; parity is held on results, so it runs the port's precomp path
MODES = ("plain", "precomp", "precomp_tuple")


def on_device(dev):
    """``dev`` made the current CUDA device (and so its current stream
    the one the kernels launch on); nothing for a CPU device."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _pad(arr: np.ndarray, lanes: int) -> np.ndarray:
    if arr.shape[0] == lanes:
        return arr
    out = np.zeros((lanes,) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def make_sharded_core(mesh, mode: str = "precomp"):
    """Lane-split verify over ``mesh`` (``parallel/mesh.make_mesh``):
    per-device ZIP-215 verdicts, no cross-device communication.
    ``mode`` is "plain" (keys decompressed on the device), "precomp"
    or "precomp_tuple" (host-expanded keys).

    The returned ``core(msgs, lens, pr, ss, a_arr=None)`` takes
    ``ops/ed25519.pack``'s lane-major host arrays for n lanes (``pr``
    is [keys | rs], 2n rows; ``a_arr`` (n, 4, 10) int32 in the
    precomp modes, None in plain) and returns ``(verdicts, events)``:
    one bool tensor and one CUDA event (None on the CPU) a device, in
    lane order. The lanes are padded to a multiple of ``len(mesh)``
    with zero lanes, whose verdicts the caller drops."""
    if mode not in MODES:
        raise ValueError(f"unknown sharded mode {mode!r}; have {MODES}")
    devs = list(mesh)
    k = len(devs)
    precomp = mode != "plain"

    def core(msgs, lens, pr, ss, a_arr=None):
        if precomp != (a_arr is not None):
            raise ValueError(f"mode {mode!r} takes {'the expanded keys' if precomp else 'no expanded keys'}")
        n = msgs.shape[0]
        per = -(-n // k)
        lanes = per * k
        keys, rs = pr[:n], pr[n:]
        msgs, lens, keys, rs, ss = (_pad(a, lanes) for a in (msgs, lens, keys, rs, ss))
        if precomp:
            a_arr = _pad(a_arr, lanes)
        verdicts, events = [], []
        for i, dev in enumerate(devs):
            lo, hi = i * per, (i + 1) * per
            with on_device(dev):
                a_dev = None
                if precomp:
                    a_dev = ed._to_device(a_arr[lo:hi].reshape(per, -1), dev).view(4, fe.NLIMBS, per)
                # one slice: pr is already its [keys | rs]
                pr_i = pr if k == 1 else np.concatenate([keys[lo:hi], rs[lo:hi]])
                verdicts.append(ed.verify_lanes(
                    ed._to_device(msgs[lo:hi], dev),
                    ed._to_device(lens[lo:hi], dev, transpose=False),
                    ed._to_device(pr_i, dev),
                    ed._to_device(ss[lo:hi], dev),
                    a_dev,
                ))
                event = None
                if dev.type == "cuda":
                    event = torch.cuda.Event()
                    event.record()
                events.append(event)
        return verdicts, events

    return core


def _multi_process() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def make_quorum_reducer(mesh):
    """Weighted tally of verdict lanes, summed over the mesh (and over
    the ranks of the default process group when one of more than one
    rank is up), plus the quorum compare. Composes with
    make_sharded_core.

    The returned ``step(ok, powers, threshold)`` gives ``(quorum,
    tally, ok_lanes)``: ``tally`` the int32 sum of ``powers`` where
    ``ok``, ``quorum`` whether it exceeds ``threshold``, ``ok_lanes``
    the verdict lanes gathered back in order. All three lie on the
    mesh's first device. Across processes each rank passes its own
    lanes, and ``ok_lanes`` are that rank's.

    The device tally is int32: ``step`` refuses a total voting power of
    2^31 or more on the host before anything is dispatched. The
    production path (types/validation.py) recomputes the authoritative
    tally on the host in arbitrary precision either way."""
    devs = list(mesh)
    k = len(devs)
    first = devs[0]

    def step(ok, powers, threshold):
        import torch.distributed as dist

        ok = torch.as_tensor(ok, dtype=torch.bool)
        powers = torch.as_tensor(powers)
        multi = _multi_process()
        comm = first if multi and dist.get_backend() == "nccl" else torch.device("cpu")
        total = powers.to(torch.int64).sum().to(comm)
        if multi:
            dist.all_reduce(total)
        if int(total) >= 2**31:
            raise ValueError(
                "total voting power overflows the int32 device tally; "
                "use the host tally path (types/validation.py)"
            )
        n = ok.shape[0]
        per = -(-n // k)
        partials, slices = [], []
        for i, dev in enumerate(devs):
            lo, hi = min(i * per, n), min((i + 1) * per, n)
            ok_i = ok[lo:hi].to(dev)
            pw_i = powers[lo:hi].to(dev, torch.int32)
            partials.append(torch.where(ok_i, pw_i, torch.zeros_like(pw_i)).sum(dtype=torch.int32))
            slices.append(ok_i)
        tally = partials[0]
        for p in partials[1:]:
            tally = tally + p.to(first)
        if multi:
            t = tally.to(comm)
            dist.all_reduce(t)
            tally = t.to(first)
        threshold = torch.as_tensor(threshold, dtype=torch.int32, device=first)
        ok_lanes = torch.cat([s.to(first) for s in slices])
        return tally > threshold, tally, ok_lanes

    return step
