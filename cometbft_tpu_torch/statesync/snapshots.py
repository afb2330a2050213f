"""On-disk snapshot store: node-side snapshot generation and serving
(reference statesync/chunks.go persistence direction, the e2e app's
snapshots/ dir, abci/example/kvstore persisted snapshots).

A copy of the JAX package's ``statesync/snapshots.py``, same on-disk
layout byte for byte. The ``SnapshotStore`` persists chunked app
snapshots under ``<home>/snapshots/<height>/``:

    snapshots/
      000000000000200/        (height, zero-padded for sort order)
        meta.json             (height/format/chunks/hash/metadata)
        chunk.0000 chunk.0001 ...

Writes are crash-safe in the store's one direction: chunks land
first, ``meta.json`` is written to a temp file and atomically renamed
LAST — a snapshot without meta.json is garbage a restart sweeps, one
with it is complete and servable. Rotation keeps the newest
``keep_recent`` snapshots. The store is thread-safe (taken from the
retention plane's worker thread, served from reactor to_thread
calls).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import List, Optional

from ..abci import types as abci

# one chunk file per this many bytes (matches the model app's wire
# chunking so served chunks are byte-identical to the RAM-era ones)
CHUNK_SIZE = 1024


def _hdir(root: str, height: int) -> str:
    return os.path.join(root, f"{height:015d}")


class SnapshotStore:
    """Chunked app snapshots on disk with keep-recent rotation."""

    def __init__(self, root: str, keep_recent: int = 2):
        self.root = root
        self.keep_recent = max(1, int(keep_recent))
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)
        self._sweep_incomplete()

    # --- write side ---------------------------------------------------

    def save(
        self,
        height: int,
        blob: bytes,
        format_: int = 1,
        metadata: bytes = b"",
        chunk_size: int = CHUNK_SIZE,
    ) -> abci.Snapshot:
        """Persist one snapshot: chunks first, meta.json atomically
        last (the completeness marker). Idempotent per height."""
        with self._lock:
            d = _hdir(self.root, height)
            os.makedirs(d, exist_ok=True)
            nchunks = max(1, (len(blob) + chunk_size - 1) // chunk_size)
            for i in range(nchunks):
                part = blob[i * chunk_size : (i + 1) * chunk_size]
                tmp = os.path.join(d, f".chunk.{i:04d}.tmp")
                with open(tmp, "wb") as f:
                    f.write(part)
                os.replace(tmp, os.path.join(d, f"chunk.{i:04d}"))
            meta = {
                "height": height,
                "format": format_,
                "chunks": nchunks,
                "chunk_size": chunk_size,
                "hash": hashlib.sha256(blob).hexdigest(),
                "metadata": metadata.hex(),
            }
            tmp = os.path.join(d, ".meta.json.tmp")
            with open(tmp, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, os.path.join(d, "meta.json"))
            self._rotate_locked()
            return self._snap_from_meta(meta)

    def _rotate_locked(self) -> None:
        hs = self._heights_locked()
        for h in hs[: -self.keep_recent]:
            shutil.rmtree(_hdir(self.root, h), ignore_errors=True)

    def _sweep_incomplete(self) -> None:
        """Drop half-written snapshot dirs (no meta.json): a crash
        mid-save must never leave an unservable height advertised."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for name in names:
            d = os.path.join(self.root, name)
            if os.path.isdir(d) and not os.path.exists(
                os.path.join(d, "meta.json")
            ):
                shutil.rmtree(d, ignore_errors=True)

    # --- read side ----------------------------------------------------

    def _heights_locked(self) -> List[int]:
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in names:
            if not name.isdigit():
                continue
            if os.path.exists(
                os.path.join(self.root, name, "meta.json")
            ):
                out.append(int(name))
        return sorted(out)

    def heights(self) -> List[int]:
        with self._lock:
            return self._heights_locked()

    def latest_height(self) -> int:
        """Newest complete snapshot height, 0 when none — the
        retention plane's snapshot floor (never prune above it while
        snapshotting is on, or the only bootstrap anchor dies)."""
        hs = self.heights()
        return hs[-1] if hs else 0

    def _meta(self, height: int) -> Optional[dict]:
        try:
            with open(
                os.path.join(_hdir(self.root, height), "meta.json")
            ) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    @staticmethod
    def _snap_from_meta(m: dict) -> abci.Snapshot:
        return abci.Snapshot(
            height=m["height"],
            format=m["format"],
            chunks=m["chunks"],
            hash=bytes.fromhex(m["hash"]),
            metadata=bytes.fromhex(m.get("metadata", "")),
        )

    def list_snapshots(self) -> List[abci.Snapshot]:
        out = []
        for h in self.heights():
            m = self._meta(h)
            if m is not None:
                out.append(self._snap_from_meta(m))
        return out

    def load_chunk(self, height: int, format_: int, index: int) -> bytes:
        m = self._meta(height)
        if m is None or m["format"] != format_ or index >= m["chunks"]:
            return b""
        try:
            with open(
                os.path.join(_hdir(self.root, height), f"chunk.{index:04d}"),
                "rb",
            ) as f:
                return f.read()
        except OSError:
            return b""

    def load_blob(self, height: int) -> Optional[bytes]:
        """The whole snapshot body (restore-side convenience)."""
        m = self._meta(height)
        if m is None:
            return None
        parts = [
            self.load_chunk(height, m["format"], i)
            for i in range(m["chunks"])
        ]
        blob = b"".join(parts)
        if hashlib.sha256(blob).hexdigest() != m["hash"]:
            return None
        return blob

    def disk_bytes(self) -> int:
        total = 0
        for dirpath, _, files in os.walk(self.root):
            for name in files:
                try:
                    total += os.path.getsize(os.path.join(dirpath, name))
                except OSError:
                    pass
        return total

    def stats(self) -> dict:
        hs = self.heights()
        return {
            "snapshots": len(hs),
            "latest": hs[-1] if hs else 0,
            "oldest": hs[0] if hs else 0,
            "disk_bytes": self.disk_bytes(),
        }
