"""The Straus ladder: K1 wrappers (``csrc/ladder.cu``) and plain versions.

Counterpart of the JAX package's only Pallas kernel,
``ops/pallas_ladder.py::_ladder_kernel`` (with its XLA twins
``ed25519._straus`` and ``_straus_compact``): per lane, [s]B + [-h]A
by a 4-bit joint Straus ladder. The lane's table cached([d]A),
d = 0..15, is built from the extended A by 15 complete adds; then 64
windows run top down, each 4 doubles, one cached add from the A table
and one cached-affine add from the shared [d]B table. The result is
the T-less (X, Y, Z).

``verify`` is the second entry of the same kernel: it also runs the
epilogue of the JAX package's ``_verify_core`` — add -R, multiply by
the cofactor, test for the identity, AND with ok_a, ok_r, ok_s — and
writes one verdict per lane. On the GPU the window-width policy of
the Pallas path (``pallas_enabled``, ``min_lanes``) does not apply:
the kernel runs at every width.

K1 runs four threads per lane (``csrc/ladder.cu``), with both window
tables in shared memory: it needs no device scratch besides its inputs
and output.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import kernels
from . import curve25519 as curve
from . import fe25519 as fe

_BTAB = curve.base_window_table()  # (16, 3, 10) int64, host constant
_BTAB_I32 = np.ascontiguousarray(_BTAB, dtype=np.int32)
_BTAB_T: dict = {}


def _btab(device) -> torch.Tensor:
    t = _BTAB_T.get(device)
    if t is None:
        t = torch.as_tensor(_BTAB, device=device)
        _BTAB_T[device] = t
    return t


_INIT_CARDS: set = set()  # indices of the cards K1 has been set up on
_INIT_LOCK = threading.Lock()


def _init(lib) -> int:
    """Copy the [d]B table to the current card and allow K1 its shared
    memory there. Both are per card: a sharded dispatch sets up each
    card it launches on (``_on_card``)."""
    return lib.ladder_init(_BTAB_I32.ctypes.data)


def _on_card(dev):
    """K1's library, set up on card ``dev`` unless that was done: its
    only setup path. The launch that follows runs with ``dev``
    current."""
    lib = kernels.load("ladder")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx in _INIT_CARDS:
        return lib
    with _INIT_LOCK, torch.cuda.device(idx):
        if idx not in _INIT_CARDS:
            kernels.check(_init(lib), "ladder init")
            _INIT_CARDS.add(idx)
    return lib


def _a_table(A):
    """cached([d]A) for d = 0..15 as (16, 4, 10, *batch) int64."""
    ext = curve.identity(A[0])
    entries = [torch.stack(curve.to_cached(ext))]
    for _ in range(15):
        ext = curve.add(ext, A)
        entries.append(torch.stack(curve.to_cached(ext)))
    return torch.stack(entries)


def _unstack(pt: torch.Tensor):
    return tuple(pt[k].to(torch.int64) for k in range(pt.shape[0]))


def _ladder_plain(ds, dh, A):
    """Plain ladder on tuple points; returns the T-less (X, Y, Z, None)."""
    table = _a_table(A)
    n = ds.shape[1]
    bt = _btab(ds.device)
    q = curve.identity(A[0])[:3] + (None,)
    for i in range(64):
        j = 63 - i
        q = curve.double(curve.double(curve.double(q, False), False), False)
        q = curve.double(q)
        idx = dh[j].to(torch.int64).view(1, 1, 1, n).expand(1, 4, fe.NLIMBS, n)
        ca = torch.gather(table, 0, idx)[0]
        q = curve.add_cached(q, tuple(ca.unbind(0)))
        cb = bt[ds[j].to(torch.int64)].permute(1, 2, 0)  # (3, 10, N)
        q = curve.add_affine_cached(q, tuple(cb.unbind(0)), need_t=False)
    return q


def straus_plain(ds, dh, A):
    """Plain version of K1's bare entry: ds, dh (64, N) digits; A
    (4, 10, N) extended point. Returns (3, 10, N) int32 X, Y, Z."""
    q = _ladder_plain(ds, dh, _unstack(A))
    return torch.stack(q[:3]).to(torch.int32)


def verify_plain(ds, dh, A, R, ok_a, ok_r, ok_s):
    """Plain version of K1's fused entry: the ladder, then
    [8](q - R) == identity AND the three ok flags, per lane."""
    q = _ladder_plain(ds, dh, _unstack(A))
    RX, RY, RZ = _unstack(R)[:3]
    p8 = curve.mul_by_cofactor(curve.add_projective(q, (fe.neg(RX), RY, RZ)))
    return ok_a & ok_r & ok_s & curve.is_identity(p8)


def _check_point(t, n) -> int:
    kernels.require(t, torch.int32, (t.shape[0], fe.NLIMBS, n))
    ld = t.stride(1)
    if t.stride(2) != 1 or t.stride(0) != fe.NLIMBS * ld:
        raise ValueError(f"point strides {t.stride()}: want (10*ld, ld, 1)")
    return ld


def _check_digits(ds, dh, n) -> None:
    for d in (ds, dh):
        kernels.require(d, torch.uint8, (64, n))
        kernels.require_rows(d, n)


def straus(ds, dh, A):
    """[s]B + [-h]A per lane. ds, dh (64, N) uint8 window digits
    (little-endian window order); A (4, 10, N) int32 extended point
    (lanes contiguous; may be a lane slice of a wider array). Returns
    (3, 10, N) int32. CPU tensors take the plain version; CUDA
    tensors launch K1's bare entry."""
    if ds.device.type == "cpu":
        return straus_plain(ds, dh, A)
    n = ds.shape[1]
    _check_digits(ds, dh, n)
    ld_a = _check_point(A, n)
    dev = ds.device
    out = torch.empty((3, fe.NLIMBS, n), dtype=torch.int32, device=dev)
    if n:
        _on_card(dev)
        kernels.launch(
            "ladder", "straus_launch",
            ds.data_ptr(), dh.data_ptr(), n, A.data_ptr(), ld_a,
            out.data_ptr(), kernels.stream_ptr(dev),
        )
    return out


def verify(ds, dh, A, R, ok_a, ok_r, ok_s):
    """Ladder plus the cofactored check: ok_a & ok_r & ok_s &
    [8]([s]B - [h]A - R) == identity, one bool per lane. ok_a may be
    None (all keys valid: the precomp mode marks bad keys on the
    host). CPU tensors take the plain version; CUDA tensors launch
    K1's fused entry."""
    n = ds.shape[1]
    if ok_a is None:
        ok_a = torch.ones(n, dtype=torch.bool, device=ds.device)
    if ds.device.type == "cpu":
        return verify_plain(ds, dh, A, R, ok_a, ok_r, ok_s)
    _check_digits(ds, dh, n)
    ld_a = _check_point(A, n)
    ld_r = _check_point(R, n)
    for ok in (ok_a, ok_r, ok_s):
        kernels.require(ok, torch.bool, (n,))
        kernels.require_rows(ok, n)
    dev = ds.device
    verdict = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        _on_card(dev)
        kernels.launch(
            "ladder", "verify_launch",
            ds.data_ptr(), dh.data_ptr(), n, A.data_ptr(), ld_a,
            R.data_ptr(), ld_r, ok_a.data_ptr(), ok_r.data_ptr(),
            ok_s.data_ptr(), verdict.data_ptr(), kernels.stream_ptr(dev),
        )
    return verdict
