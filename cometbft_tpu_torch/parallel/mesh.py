"""Device mesh helpers: the framework's data-parallel axis.

The port's counterpart of the JAX package's ``parallel/mesh.py``. The
reference scales commit verification with CPU batch verification
(types/validation.go:261) — one core, SIMD lanes. Here signature lanes
are split over the cards of one host: each card verifies its slice,
and the weighted voting-power tally is summed over them
(``parallel/sharded_verify.py``). Consensus networking between hosts
stays on the p2p layer; the mesh carries only the crypto data
parallelism.

A mesh is an ordered list of ``torch.device``s. By default it is every
CUDA device; an explicit ``devices`` list may repeat a device, which
is how the tests stand eight CPU entries in for the JAX package's
eight virtual CPU devices, and how the smoke splits lanes into four
slices on one card. ``mesh_for`` is the one rule for which devices a
verify dispatch splits its lanes over.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..device import resolve

DATA_AXIS = "sig"  # signature-lane data parallelism


def make_mesh(
    n_devices: Optional[int] = None, devices: Optional[Sequence] = None
) -> List[torch.device]:
    """The first ``n_devices`` of ``devices`` (default: every CUDA
    device, ``cuda:0`` .. ``cuda:k-1``). With no GPU and no explicit
    list this raises, as ``device.resolve`` does."""
    if devices is None:
        resolve("cuda")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return devs


def mesh_for(device) -> List[torch.device]:
    """The devices a verify dispatch for ``device`` splits its lanes
    over: an explicit list as given; every CUDA device for a CUDA
    device that names no card by index (None or plain "cuda"), which
    is the JAX rule of "every local device"; otherwise the one device.
    A list of one device is an unsharded dispatch."""
    if isinstance(device, (list, tuple)):
        return make_mesh(devices=device)
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.device_count() > 1:
        return make_mesh()
    return [dev]
