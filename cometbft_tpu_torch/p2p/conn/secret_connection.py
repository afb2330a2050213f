"""Authenticated encrypted duplex connection (STS protocol).

Parity with reference p2p/conn/secret_connection.go:33-60,129-152,349:
ephemeral X25519 ECDH -> transcript hash -> HKDF-SHA256 key schedule ->
ChaCha20-Poly1305 AEAD over fixed 1024-byte frames, then each side
proves its long-lived ed25519 identity by signing the handshake
challenge INSIDE the encrypted channel (so eavesdroppers never link
node identity to address). Wire format is framework-native, not
byte-compatible with the reference (merlin transcripts are replaced by
a plain SHA-256 transcript chain); it is the JAX package's
``p2p/conn/secret_connection.py`` byte for byte, so a port node and a
JAX node complete the handshake with each other.

Frames: plaintext = 2-byte BE length || data, zero-padded to
DATA_MAX_SIZE+2; ciphertext = frame || 16-byte tag. Nonce = 12-byte
little-endian per-direction send counter (independent keys per
direction, so counters never collide).
"""

from __future__ import annotations

import asyncio
import hashlib
import struct
from typing import Optional, Tuple

# both primitives are dependency-gated (the wheel, libcrypto through
# ctypes, pure Python); the AEAD class is looked up per connection so
# its tier is the module's current one
from ...crypto import chacha20poly1305 as _aead
from ...crypto import x25519 as _x25519
from ...crypto.keys import Ed25519PrivKey, Ed25519PubKey

DATA_LEN_SIZE = 2
DATA_MAX_SIZE = 1022
FRAME_SIZE = DATA_LEN_SIZE + DATA_MAX_SIZE  # 1024
SEALED_FRAME_SIZE = FRAME_SIZE + 16
TRANSCRIPT_DOMAIN = b"COMETBFT_TPU_SECRET_CONNECTION_V1"


class HandshakeError(Exception):
    pass


def _kdf(shared: bytes, transcript: bytes) -> Tuple[bytes, bytes, bytes]:
    """96 bytes of key material: (key_lo, key_hi, challenge)."""
    okm = b""
    prk = hashlib.sha256(transcript + shared).digest()
    t = b""
    for i in range(3):
        t = hashlib.sha256(prk + t + bytes([i + 1])).digest()
        okm += t
    return okm[0:32], okm[32:64], okm[64:96]


class SecretConnection:
    """Wraps an (asyncio) byte stream after a successful handshake."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        send_key: bytes,
        recv_key: bytes,
        remote_pubkey: Ed25519PubKey,
    ):
        self._reader = reader
        self._writer = writer
        self._send_aead = _aead.ChaCha20Poly1305(send_key)
        self._recv_aead = _aead.ChaCha20Poly1305(recv_key)
        self._send_nonce = 0
        self._recv_nonce = 0
        self.remote_pubkey = remote_pubkey
        self._recv_buf = b""
        self._write_lock = asyncio.Lock()
        self._read_lock = asyncio.Lock()

    # --- handshake ----------------------------------------------------

    @classmethod
    async def handshake(
        cls,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        priv_key: Ed25519PrivKey,
        timeout: float = 10.0,
    ) -> "SecretConnection":
        return await asyncio.wait_for(
            cls._handshake(reader, writer, priv_key), timeout
        )

    @classmethod
    async def _handshake(cls, reader, writer, priv_key):
        eph_priv = _x25519.generate_private()
        eph_pub = _x25519.public(eph_priv)
        writer.write(eph_pub)
        await writer.drain()
        their_eph = await reader.readexactly(32)
        if their_eph == eph_pub:
            raise HandshakeError("reflected ephemeral key (self-connection?)")

        lo, hi = sorted((eph_pub, their_eph))
        transcript = hashlib.sha256(
            TRANSCRIPT_DOMAIN + lo + hi
        ).digest()
        shared = _x25519.shared(eph_priv, their_eph)
        key_lo, key_hi, challenge = _kdf(shared, transcript)
        # the party whose ephemeral key sorts lower sends with key_lo
        if eph_pub == lo:
            send_key, recv_key = key_lo, key_hi
        else:
            send_key, recv_key = key_hi, key_lo

        conn = cls.__new__(cls)
        SecretConnection.__init__(
            conn, reader, writer, send_key, recv_key, None
        )

        # authenticate inside the encrypted channel: pubkey || sig(challenge)
        my_pub = bytes(priv_key.pub_key().key_bytes)
        sig = priv_key.sign(challenge)
        await conn.write_msg(my_pub + sig)
        auth = await conn.read_msg()
        if len(auth) != 32 + 64:
            raise HandshakeError("bad auth message length")
        remote_pub = Ed25519PubKey(auth[:32])
        if not remote_pub.verify(challenge, auth[32:]):
            raise HandshakeError("challenge signature verification failed")
        conn.remote_pubkey = remote_pub
        return conn

    # --- framed AEAD I/O ----------------------------------------------

    def _seal(self, data: bytes) -> bytes:
        frame = struct.pack(">H", len(data)) + data
        frame += b"\x00" * (FRAME_SIZE - len(frame))
        nonce = self._send_nonce.to_bytes(12, "little")
        self._send_nonce += 1
        return self._send_aead.encrypt(nonce, frame, None)

    def _open(self, sealed: bytes) -> bytes:
        nonce = self._recv_nonce.to_bytes(12, "little")
        self._recv_nonce += 1
        frame = self._recv_aead.decrypt(nonce, sealed, None)
        (n,) = struct.unpack(">H", frame[:DATA_LEN_SIZE])
        if n > DATA_MAX_SIZE:
            raise HandshakeError("corrupt frame length")
        return frame[DATA_LEN_SIZE : DATA_LEN_SIZE + n]

    async def write_msg(self, data: bytes) -> int:
        """Write data as one or more sealed frames. Returns bytes sent
        on the wire."""
        sent = 0
        async with self._write_lock:
            for i in range(0, len(data) or 1, DATA_MAX_SIZE):
                chunk = data[i : i + DATA_MAX_SIZE]
                sealed = self._seal(chunk)
                self._writer.write(sealed)
                sent += len(sealed)
            await self._writer.drain()
        return sent

    async def read_chunk(self) -> bytes:
        """Read exactly one frame's payload (<= DATA_MAX_SIZE bytes)."""
        async with self._read_lock:
            sealed = await self._reader.readexactly(SEALED_FRAME_SIZE)
        return self._open(sealed)

    async def read_msg(self) -> bytes:
        """Read one frame payload (handshake helper; MConnection does
        its own message reassembly from chunks)."""
        return await self.read_chunk()

    def close(self) -> None:
        try:
            self._writer.close()
        except Exception:
            pass
