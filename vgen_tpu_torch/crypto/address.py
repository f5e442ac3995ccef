"""Address formats and key -> address derivations (host oracle).

Behavioral parity target: reference address.rs (AddressFormat address.rs:11-24,
AddressGenerator::generate address.rs:92-151, to_checksum_address
address.rs:176-198, WIF helpers address.rs:168-172,201-211) and the `verify`
subcommand derivations (lib.rs:377-494).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, Optional

from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.crypto.encode import (
    base58check_encode,
    eip55_checksum_address,
    segwit_addr_encode,
    wif_decode,
    wif_encode,
)
from vgen_tpu_torch.crypto.hashes import hash160, tagged_hash


class AddressFormat(enum.Enum):
    P2PKH = "p2pkh"
    P2WPKH = "p2wpkh"
    P2SH_P2WPKH = "p2sh-p2wpkh"
    P2TR = "p2tr"
    P2PKH_UNCOMPRESSED = "p2pkh-uncompressed"
    ETHEREUM = "ethereum"

    @classmethod
    def from_str(cls, s: str) -> "AddressFormat":
        s = s.strip().lower().replace("_", "-")
        aliases = {
            "p2pkh": cls.P2PKH,
            "p2wpkh": cls.P2WPKH,
            "p2sh-p2wpkh": cls.P2SH_P2WPKH,
            "p2shp2wpkh": cls.P2SH_P2WPKH,
            "p2sh": cls.P2SH_P2WPKH,
            "p2tr": cls.P2TR,
            "p2pkh-uncompressed": cls.P2PKH_UNCOMPRESSED,
            "ethereum": cls.ETHEREUM,
            "eth": cls.ETHEREUM,
        }
        if s not in aliases:
            raise ValueError(f"unknown address format: {s}")
        return aliases[s]

    @property
    def charset_name(self) -> str:
        """Reference parity: address.rs:39-45."""
        if self in (
            AddressFormat.P2PKH,
            AddressFormat.P2PKH_UNCOMPRESSED,
            AddressFormat.P2SH_P2WPKH,
        ):
            return "Base58"
        if self in (AddressFormat.P2WPKH, AddressFormat.P2TR):
            return "Bech32"
        return "Hex"

    @property
    def display_name(self) -> str:
        """Reference parity: address.rs:48-59."""
        return {
            AddressFormat.P2PKH: "P2PKH",
            AddressFormat.P2WPKH: "P2WPKH",
            AddressFormat.P2SH_P2WPKH: "P2SH-P2WPKH",
            AddressFormat.P2TR: "P2TR",
            AddressFormat.P2PKH_UNCOMPRESSED: "P2PKH (Uncompressed)",
            AddressFormat.ETHEREUM: "Ethereum",
        }[self]

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.display_name


@dataclass
class GeneratedAddress:
    address: str
    wif: str  # WIF for Bitcoin formats; hex secret for Ethereum (parity: address.rs:111)
    hex: str  # hex-encoded 32-byte secret
    format: AddressFormat


def p2pkh_address(pubkey_ser: bytes) -> str:
    return base58check_encode(b"\x00" + hash160(pubkey_ser))


def p2wpkh_address(pubkey33: bytes) -> str:
    return segwit_addr_encode("bc", 0, hash160(pubkey33))


def p2sh_p2wpkh_address(pubkey33: bytes) -> str:
    witness_script = b"\x00\x14" + hash160(pubkey33)  # OP_0 PUSH20 <h160>
    return base58check_encode(b"\x05" + hash160(witness_script))


def taproot_tweak(internal_x: int) -> int:
    """BIP341 key-path-only tweak scalar t = H_TapTweak(x)."""
    t = int.from_bytes(tagged_hash("TapTweak", internal_x.to_bytes(32, "big")), "big")
    if t >= ec.N:
        raise ValueError("taproot tweak out of range (negligible probability)")
    return t


def taproot_output_x(internal_x: int) -> int:
    """X coordinate of Q = lift_x(internal_x) + t*G."""
    p = ec.lift_x(internal_x)
    if p is None:
        raise ValueError("internal key x not on curve")
    q = ec.point_add(p, ec.scalar_mult(taproot_tweak(internal_x), ec.G))
    if q is None:
        raise ValueError("taproot output at infinity (negligible probability)")
    return q[0]


def p2tr_address(internal_x: int) -> str:
    return segwit_addr_encode("bc", 1, taproot_output_x(internal_x).to_bytes(32, "big"))


def ethereum_address(pubkey_uncompressed65: bytes) -> str:
    from vgen_tpu_torch.crypto.hashes import keccak256

    return eip55_checksum_address(keccak256(pubkey_uncompressed65[1:])[12:])


class AddressGenerator:
    """Key -> address generator (parity: AddressGenerator, address.rs:75-151)."""

    def __init__(self, fmt: AddressFormat):
        self.format = fmt

    def generate(self, secret: bytes) -> Optional[GeneratedAddress]:
        """Derive the address for a 32-byte secret; None if the key is invalid
        (zero or >= curve order), matching SecretKey::from_slice semantics
        (address.rs:93)."""
        if len(secret) != 32:
            raise ValueError("secret must be 32 bytes")
        k = int.from_bytes(secret, "big")
        if not 1 <= k < ec.N:
            return None
        point = ec.scalar_mult(k, ec.G)
        fmt = self.format
        hexkey = secret.hex()
        if fmt == AddressFormat.ETHEREUM:
            addr = ethereum_address(ec.serialize_uncompressed(point))
            return GeneratedAddress(addr, hexkey, hexkey, fmt)
        if fmt == AddressFormat.P2PKH_UNCOMPRESSED:
            addr = p2pkh_address(ec.serialize_uncompressed(point))
            return GeneratedAddress(addr, wif_encode(secret, False), hexkey, fmt)
        pub33 = ec.serialize_compressed(point)
        if fmt == AddressFormat.P2PKH:
            addr = p2pkh_address(pub33)
        elif fmt == AddressFormat.P2WPKH:
            addr = p2wpkh_address(pub33)
        elif fmt == AddressFormat.P2SH_P2WPKH:
            addr = p2sh_p2wpkh_address(pub33)
        elif fmt == AddressFormat.P2TR:
            x, _ = ec.xonly(point)
            addr = p2tr_address(x)
        else:  # pragma: no cover
            raise AssertionError(fmt)
        return GeneratedAddress(addr, wif_encode(secret, True), hexkey, fmt)


def derive_all(secret: bytes) -> Dict[str, str]:
    """All derivations from one secret, for the `verify` subcommand
    (parity: lib.rs:401-448)."""
    k = int.from_bytes(secret, "big")
    if not 1 <= k < ec.N:
        raise ValueError("invalid secret key")
    point = ec.scalar_mult(k, ec.G)
    pub33 = ec.serialize_compressed(point)
    pub65 = ec.serialize_uncompressed(point)
    x, _ = ec.xonly(point)
    return {
        "wif": wif_encode(secret, True),
        "wif_uncompressed": wif_encode(secret, False),
        "hex": secret.hex(),
        "p2pkh": p2pkh_address(pub33),
        "p2pkh_uncompressed": p2pkh_address(pub65),
        "p2wpkh": p2wpkh_address(pub33),
        "p2sh_p2wpkh": p2sh_p2wpkh_address(pub33),
        "p2tr": p2tr_address(x),
        "ethereum": ethereum_address(pub65),
    }


def parse_private_key(s: str) -> bytes:
    """Parse WIF or hex private key (parity: lib.rs:388-399)."""
    try:
        secret, _, version = wif_decode(s)
        if version != 0x80:
            raise ValueError("not a mainnet WIF")
        return secret
    except ValueError:
        pass
    h = s.strip()
    if h.lower().startswith("0x"):
        h = h[2:]
    raw = bytes.fromhex(h)
    if len(raw) != 32:
        raise ValueError("hex key must be 32 bytes")
    return raw
