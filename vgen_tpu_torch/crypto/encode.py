"""Host-side address/key string encodings.

Base58Check, Bech32/Bech32m (BIP173/BIP350), WIF, hex + EIP-55 checksum.
Ground truth for the device encoder kernels; the reference delegates these
to the `bitcoin` crate (address.rs:114-150) and hand-rolls EIP-55
(address.rs:176-198).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from vgen_tpu_torch.crypto.hashes import keccak256, sha256d

BASE58_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_B58_INDEX = {c: i for i, c in enumerate(BASE58_ALPHABET)}

BECH32_CHARSET = "qpzry9x8gf2tvdw0s3jn54khce6mua7l"
_BECH32_INDEX = {c: i for i, c in enumerate(BECH32_CHARSET)}

BECH32_CONST = 1
BECH32M_CONST = 0x2BC830A3


# ---------------------------------------------------------------------------
# Base58 / Base58Check
# ---------------------------------------------------------------------------

def base58_encode(data: bytes) -> str:
    n = int.from_bytes(data, "big")
    digits = []
    while n:
        n, r = divmod(n, 58)
        digits.append(BASE58_ALPHABET[r])
    pad = 0
    for b in data:
        if b == 0:
            pad += 1
        else:
            break
    return "1" * pad + "".join(reversed(digits))


def base58_decode(s: str) -> bytes:
    n = 0
    for c in s:
        if c not in _B58_INDEX:
            raise ValueError(f"invalid base58 character {c!r}")
        n = n * 58 + _B58_INDEX[c]
    raw = n.to_bytes((n.bit_length() + 7) // 8, "big") if n else b""
    pad = 0
    for c in s:
        if c == "1":
            pad += 1
        else:
            break
    return b"\x00" * pad + raw


def base58check_encode(payload: bytes) -> str:
    return base58_encode(payload + sha256d(payload)[:4])


def base58check_decode(s: str) -> bytes:
    raw = base58_decode(s)
    if len(raw) < 5:
        raise ValueError("base58check string too short")
    payload, check = raw[:-4], raw[-4:]
    if sha256d(payload)[:4] != check:
        raise ValueError("base58check checksum mismatch")
    return payload


# ---------------------------------------------------------------------------
# Bech32 / Bech32m (BIP173 / BIP350)
# ---------------------------------------------------------------------------

def _bech32_polymod(values: List[int]) -> int:
    gen = [0x3B6A57B2, 0x26508E6D, 0x1EA119FA, 0x3D4233DD, 0x2A1462B3]
    chk = 1
    for v in values:
        top = chk >> 25
        chk = (chk & 0x1FFFFFF) << 5 ^ v
        for i in range(5):
            if (top >> i) & 1:
                chk ^= gen[i]
    return chk


def _bech32_hrp_expand(hrp: str) -> List[int]:
    return [ord(c) >> 5 for c in hrp] + [0] + [ord(c) & 31 for c in hrp]


def _bech32_create_checksum(hrp: str, data: List[int], const: int) -> List[int]:
    values = _bech32_hrp_expand(hrp) + data
    polymod = _bech32_polymod(values + [0, 0, 0, 0, 0, 0]) ^ const
    return [(polymod >> 5 * (5 - i)) & 31 for i in range(6)]


def bech32_encode(hrp: str, data: List[int], const: int = BECH32_CONST) -> str:
    combined = data + _bech32_create_checksum(hrp, data, const)
    return hrp + "1" + "".join(BECH32_CHARSET[d] for d in combined)


def bech32_decode(addr: str) -> Tuple[str, List[int], int]:
    """Returns (hrp, data-without-checksum, checksum-constant)."""
    if addr != addr.lower() and addr != addr.upper():
        raise ValueError("mixed-case bech32 string")
    addr = addr.lower()
    pos = addr.rfind("1")
    if pos < 1 or pos + 7 > len(addr):
        raise ValueError("invalid bech32 separator position")
    hrp, rest = addr[:pos], addr[pos + 1 :]
    data = []
    for c in rest:
        if c not in _BECH32_INDEX:
            raise ValueError(f"invalid bech32 character {c!r}")
        data.append(_BECH32_INDEX[c])
    const = _bech32_polymod(_bech32_hrp_expand(hrp) + data)
    if const not in (BECH32_CONST, BECH32M_CONST):
        raise ValueError("bech32 checksum mismatch")
    return hrp, data[:-6], const


def convertbits(
    data: bytes, frombits: int, tobits: int, pad: bool = True
) -> Optional[List[int]]:
    """General power-of-2 base regrouping (BIP173 reference semantics)."""
    acc = 0
    bits = 0
    ret = []
    maxv = (1 << tobits) - 1
    max_acc = (1 << (frombits + tobits - 1)) - 1
    for value in data:
        if value < 0 or value >> frombits:
            return None
        acc = ((acc << frombits) | value) & max_acc
        bits += frombits
        while bits >= tobits:
            bits -= tobits
            ret.append((acc >> bits) & maxv)
    if pad:
        if bits:
            ret.append((acc << (tobits - bits)) & maxv)
    elif bits >= frombits or ((acc << (tobits - bits)) & maxv):
        return None
    return ret


def segwit_addr_encode(hrp: str, witver: int, witprog: bytes) -> str:
    const = BECH32_CONST if witver == 0 else BECH32M_CONST
    data = [witver] + (convertbits(witprog, 8, 5) or [])
    return bech32_encode(hrp, data, const)


# ---------------------------------------------------------------------------
# WIF (wallet import format)
# ---------------------------------------------------------------------------

WIF_VERSION_MAINNET = 0x80


def wif_encode(
    secret32: bytes, compressed: bool = True, version: int = WIF_VERSION_MAINNET
) -> str:
    if len(secret32) != 32:
        raise ValueError("secret must be 32 bytes")
    payload = bytes([version]) + secret32 + (b"\x01" if compressed else b"")
    return base58check_encode(payload)


def wif_decode(wif: str) -> Tuple[bytes, bool, int]:
    """Returns (secret32, compressed, version)."""
    payload = base58check_decode(wif)
    version = payload[0]
    body = payload[1:]
    if len(body) == 33 and body[-1] == 0x01:
        return body[:32], True, version
    if len(body) == 32:
        return body, False, version
    raise ValueError("invalid WIF payload length")


# ---------------------------------------------------------------------------
# Ethereum hex + EIP-55
# ---------------------------------------------------------------------------

def eip55_checksum_address(addr20: bytes) -> str:
    """0x-prefixed EIP-55 mixed-case address for a 20-byte account."""
    lower = addr20.hex()
    digest = keccak256(lower.encode()).hex()
    out = []
    for c, h in zip(lower, digest):
        if c.isalpha() and int(h, 16) >= 8:
            out.append(c.upper())
        else:
            out.append(c)
    return "0x" + "".join(out)
