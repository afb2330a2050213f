"""Loader of the native wire codec (``native/wirecodec.cpp``).

The port's counterpart of the JAX package's ``utils/wirecodec.py``. The
extension, built by ``utils/native.py`` into
``build/native/_wirecodec.so``, has ``varints``, ``encode_commit``,
``decode_commit``, ``merkle_root``, ``commit_merkle_root`` and
``sha256_many``. ``module()`` returns it or None: callers
(``utils/codec.py``, ``crypto/merkle.py``, ``types/block.py``,
``state/store.py``, ``mempool/mempool.py``) keep the pure-Python path
as the fallback and the semantic source of truth, and the native
decoder defers to Python on any ``ValueError``, so adversarial input
behaves the same with or without a compiler. ``module()`` never makes
a caller wait for a build in flight (it returns None meanwhile);
``build_node`` calls ``prewarm()``. ``GRAFT_NATIVE_CODEC=0`` disables
the lane.
"""

from __future__ import annotations

from . import native

LANE = native.Lane("wirecodec", gate="GRAFT_NATIVE_CODEC")


def module():
    """The extension module, or None (``LANE.reason`` says why)."""
    return LANE.module()


def prewarm():
    """Start the one-time build on a daemon thread; None once tried."""
    return LANE.prewarm()
