"""Batched ed25519 verification on the GPU: one dispatch, three kernels.

Counterpart of the JAX package's ``ops/ed25519.py``
(``verify_batch_async`` -> ``_verify_core`` / ``_verify_core_precomp``):

    per lane:  h  = SHA-512(R || A || M) mod L
               ok = [8]([S]B - [h]A - R) == identity   (ZIP-215, cofactored)

A dispatch packs the items on the host, copies them to the device and
launches, on PyTorch's current stream:

- K2 ``decompress`` (``curve25519.decompress``) — over [pks | rs] in
  one launch (plain mode), or over rs only when the public keys come
  expanded from the host LRU (precomp mode);
- K3 ``hash_digits`` (``sc25519.hash_digits``) — SHA-512, h mod L,
  window digits of s and of -h, s < L;
- K1 ``verify`` (``ladder.verify``) — the Straus ladder plus the
  cofactored identity check, one verdict per lane.

Every lane gets its own verdict; malformed key or signature lengths
give False. On a CPU device each wrapper runs its plain version.

The copies, the three launches and the dispatch's event all go on the
calling thread's current stream (``kernels.stream_ptr``), so a
dispatch made from the verify scheduler's thread is ordered on that
thread's stream. Each handle carries its own dispatch record
(``AsyncVerdicts.dispatch``); ``LAST_DISPATCH`` repeats the newest one.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import kernels
from ..device import resolve
from . import curve25519 as curve
from . import fe25519 as fe
from . import ladder
from . import sc25519 as sc

# message capacity buckets: the hash input is 64 + cap bytes; each cap
# makes the padded hash input exactly 1, 2, 4 or 8 SHA-512 blocks
MSG_CAPS = (47, 175, 431, 943)

# Largest batch dispatched in precomp mode (host-expanded public keys,
# only R decompressed on the device); larger batches decompress A on
# the device too. Measured on an H100 by chip_smoke.py's crossover
# phase (PERF.md): precomp saves at most ~7% of device time (>= 32k
# lanes; nothing below 16k, where the kernels sit on their latency
# floor) and always costs more in host packing than that, so no width
# gains from it and the default is the plain mode. precomp=True still
# forces it.
PRECOMP_MAX_LANES = 0


def bucket_cap(max_len: int) -> int:
    for c in MSG_CAPS:
        if max_len <= c:
            return c
    raise ValueError(f"message too long for verify kernel: {max_len}")


# --- host-side expanded-pubkey cache -----------------------------------
# pk bytes -> (4, 10) int32 extended limbs (x, y, 1, xy), or None for
# keys that fail ZIP-215 decompression. LRU, like the reference's
# expanded ed25519 key cache (crypto/ed25519/ed25519.go:31).
_A_CACHE: dict = {}
_A_CACHE_MAX = 4096


def _expand_pubkey(pk: bytes):
    if pk in _A_CACHE:
        val = _A_CACHE.pop(pk)  # re-inserted below: the newest entry
    else:
        from ..crypto import ref_ed25519 as _ref

        val = None
        pt = _ref.point_decompress(pk)
        if pt is not None:
            x, y, _z, t = pt
            val = np.stack(
                [fe.raw_limbs(x), fe.raw_limbs(y), fe.raw_limbs(1), fe.raw_limbs(t)]
            ).astype(np.int32)
        if len(_A_CACHE) >= _A_CACHE_MAX:
            _A_CACHE.pop(next(iter(_A_CACHE)))  # the least recently used
    _A_CACHE[pk] = val
    return val


# How the newest dispatch ran: lanes, bucket, mode, device, host
# packing time and the launches of each kernel it made.
LAST_DISPATCH: dict = {}
# held from the first launch of a dispatch to its event, so the launch
# counts a dispatch records are its own when threads dispatch at once
_LAUNCH_LOCK = threading.Lock()


class AsyncVerdicts:
    """Handle for an in-flight dispatch. The kernels are enqueued on
    the stream; ``wait()`` blocks on a CUDA event recorded after the
    last one, ``result()`` copies the verdicts to the host.
    ``dispatch`` is how this dispatch ran (see ``LAST_DISPATCH``)."""

    def __init__(self, verdict, bad, n, event=None, dispatch=None):
        self._verdict = verdict
        self._bad = bad
        self._n = n
        self._event = event
        self.dispatch = dispatch or {}

    def wait(self) -> "AsyncVerdicts":
        if self._event is not None:
            self._event.synchronize()
        return self

    def result(self) -> np.ndarray:
        if self._n == 0:
            return np.zeros(0, bool)
        out = self._verdict.cpu().numpy()[: self._n].copy()
        out[self._bad] = False
        return out


def pack(items, precomp: bool):
    """Host packing: items -> numpy arrays in lane-major rows (the
    device transposes them to the kernels' byte-major layout)."""
    n = len(items)
    cap = bucket_cap(max(len(m) for m, _, _ in items))
    bad = np.zeros(n, bool)
    msgs = np.zeros((n, cap), np.uint8)
    lens = np.zeros(n, np.int32)
    keys = bytearray(32 * n)
    sigs = bytearray(64 * n)
    a_arr = np.zeros((n, 4, fe.NLIMBS), np.int32) if precomp else None
    for i, (m, pk, sig) in enumerate(items):
        if len(pk) != 32 or len(sig) != 64:
            bad[i] = True
            continue
        if precomp:
            A = _expand_pubkey(bytes(pk))
            if A is None:  # the key fails ZIP-215 decompression
                bad[i] = True
                continue
            a_arr[i] = A
        msgs[i, : len(m)] = np.frombuffer(m, np.uint8)
        lens[i] = len(m)
        keys[32 * i : 32 * i + 32] = pk
        sigs[64 * i : 64 * i + 64] = sig
    keys = np.frombuffer(keys, np.uint8).reshape(n, 32)
    sigs = np.frombuffer(sigs, np.uint8).reshape(n, 64)
    # [pks | rs] as 2n lanes: one decompression launch covers both
    pr = np.concatenate([keys, sigs[:, :32]])
    return msgs, lens, pr, np.ascontiguousarray(sigs[:, 32:]), a_arr, bad


def _to_device(arr, dev, transpose=True):
    t = torch.from_numpy(arr)
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    return t.t().contiguous() if transpose else t


def verify_lanes(msgs, lens, pr, ss, a_arr=None):
    """The device part of a dispatch, on byte-major tensors: msgs
    (cap, N), lens (N,), pr (32, 2N) = [pks | rs], ss (32, N), and in
    precomp mode a_arr (4, 10, N) int32. Returns (N,) bool verdicts."""
    n = msgs.shape[1]
    pks, rs = pr[:, :n], pr[:, n:]
    ds, dh, ok_s = sc.hash_digits(msgs, lens, pks, rs, ss)
    if a_arr is None:
        pt, ok = curve.decompress(pr)
        A, R, ok_a, ok_r = pt[..., :n], pt[..., n:], ok[:n], ok[n:]
    else:
        R, ok_r = curve.decompress(rs)
        A, ok_a = a_arr, None
    return ladder.verify(ds, dh, A, R, ok_a, ok_r, ok_s)


def verify_batch_async(items, device=None, precomp=None) -> AsyncVerdicts:
    """Enqueue one verify dispatch without waiting for the verdicts.

    items: list of (msg, pubkey 32 B, sig 64 B). ``precomp`` forces the
    mode; by default batches up to PRECOMP_MAX_LANES lanes use the
    host-expanded keys."""
    dev = resolve(device)
    n = len(items)
    if n == 0:
        return AsyncVerdicts(None, np.zeros(0, bool), 0)
    if precomp is None:
        precomp = n <= PRECOMP_MAX_LANES
    t0 = time.perf_counter()
    msgs, lens, pr, ss, a_arr, bad = pack(items, precomp)
    pack_s = time.perf_counter() - t0
    with _LAUNCH_LOCK:
        before = dict(kernels.LAUNCHES)
        verdict = verify_lanes(
            _to_device(msgs, dev),
            _to_device(lens, dev, transpose=False),
            _to_device(pr, dev),
            _to_device(ss, dev),
            None if a_arr is None
            else _to_device(a_arr.reshape(n, -1), dev).view(4, fe.NLIMBS, n),
        )
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        launches = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    dispatch = dict(
        lanes=n,
        cap=msgs.shape[1],
        precomp=precomp,
        device=str(dev),
        pack_ms=pack_s * 1e3,
        launches=launches,
    )
    global LAST_DISPATCH
    LAST_DISPATCH = dispatch
    return AsyncVerdicts(verdict, bad, n, event, dispatch)


def verify_batch(items, device=None, precomp=None) -> np.ndarray:
    """items = list of (msg, pubkey, sig) -> np.ndarray of bool verdicts."""
    return verify_batch_async(items, device, precomp).result()
