"""ASCII armor for key material (a copy of the JAX package's
``crypto/armor.py``; reference crypto/armor/armor.go:11 —
EncodeArmor/DecodeArmor over the OpenPGP armor format, RFC 4880 §6):

    -----BEGIN <block type>-----
    Header-Key: value

    <base64 body, wrapped>
    =<base64 CRC-24>
    -----END <block type>-----

Used by key-export tooling (the reference's cosmos-sdk consumers armor
privkeys with block type "TENDERMINT PRIVATE KEY" and a kdf/salt
header, encrypting with xsalsa20symmetric — see privval/armor helpers).
"""

from __future__ import annotations

import base64
import binascii
from typing import Dict, Tuple

_LINE = 64
_CRC24_INIT = 0xB704CE
_CRC24_POLY = 0x1864CFB


def _crc24(data: bytes) -> int:
    """OpenPGP radix-64 checksum (RFC 4880 §6.1)."""
    crc = _CRC24_INIT
    for b in data:
        crc ^= b << 16
        for _ in range(8):
            crc <<= 1
            if crc & 0x1000000:
                crc ^= _CRC24_POLY
    return crc & 0xFFFFFF


def encode_armor(
    block_type: str, headers: Dict[str, str], data: bytes
) -> str:
    lines = [f"-----BEGIN {block_type}-----"]
    for k in sorted(headers):
        lines.append(f"{k}: {headers[k]}")
    lines.append("")
    b64 = base64.b64encode(data).decode()
    for i in range(0, len(b64), _LINE):
        lines.append(b64[i : i + _LINE])
    crc = base64.b64encode(_crc24(data).to_bytes(3, "big")).decode()
    lines.append(f"={crc}")
    lines.append(f"-----END {block_type}-----")
    return "\n".join(lines) + "\n"


def decode_armor(armor_str: str) -> Tuple[str, Dict[str, str], bytes]:
    """Returns (block_type, headers, data); raises ValueError on any
    malformed framing, base64, or checksum mismatch."""
    lines = [l.rstrip("\r") for l in armor_str.strip().split("\n")]
    if not lines or not lines[0].startswith("-----BEGIN "):
        raise ValueError("missing armor BEGIN line")
    if not lines[0].endswith("-----"):
        raise ValueError("malformed BEGIN line")
    block_type = lines[0][len("-----BEGIN ") : -len("-----")]
    if lines[-1] != f"-----END {block_type}-----":
        raise ValueError("missing/mismatched armor END line")
    headers: Dict[str, str] = {}
    i = 1
    while i < len(lines) - 1 and lines[i].strip():
        if ":" not in lines[i]:
            break  # body starts without the customary blank line
        k, v = lines[i].split(":", 1)
        headers[k.strip()] = v.strip()
        i += 1
    if i < len(lines) - 1 and not lines[i].strip():
        i += 1  # blank separator
    body_lines = []
    crc_line = None
    for l in lines[i:-1]:
        if l.startswith("="):
            crc_line = l[1:]
        elif l.strip():
            body_lines.append(l.strip())
    try:
        data = base64.b64decode("".join(body_lines), validate=True)
    except (binascii.Error, ValueError) as e:
        raise ValueError(f"bad armor body: {e}") from None
    if crc_line is not None:
        try:
            want = int.from_bytes(
                base64.b64decode(crc_line, validate=True), "big"
            )
        except (binascii.Error, ValueError) as e:
            raise ValueError(f"bad armor checksum: {e}") from None
        if want != _crc24(data):
            raise ValueError("armor checksum mismatch")
    return block_type, headers, data
