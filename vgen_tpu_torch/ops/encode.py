"""The hashed values of the hash formats from limbs (hash160 of a
compressed or uncompressed public key, the P2SH-P2WPKH script hash), and
the address symbols the DFA walks, as digit values in the format's
alphabet: Base58Check (P2PKH and uncompressed P2PKH with version 0,
P2SH-P2WPKH with version 5), bech32 (P2WPKH), EIP-55 cased hex (Ethereum)
and bech32m (P2TR) (plain PyTorch versions of ``csrc/encode.cuh``;
counterparts of ``vgen_tpu/ops/encode.py``).

Words and digits are int64 tensors; hashed values are 5 big-endian uint32
words.  The reference's base-58 conversion is an f32 matmul against a
digit basis, a TPU workaround; here it is long division of the 25-byte
payload, 58^5 at a time, as on the card.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from vgen_tpu_torch.ops import keccak, ripemd160, sha256

M32 = 0xFFFFFFFF
BASE58_SYMS = 34  # symbols of a Base58Check address (version 0 or 5), at most
ETH_SYMS = 40  # hex digits of an Ethereum account after "0x"
BECH32_SYMS = 39  # [witver] + 32 five-bit groups + 6 checksum symbols
BECH32M_SYMS = 59  # [witver 1] + 52 five-bit groups + 6 checksum symbols
BECH32M_CONST = 0x2BC830A3  # BIP350
_B58_POW5 = 58 ** 5  # < 2^32, so (remainder << 32) | word stays < 2^62

_BECH32_GEN = (0x3B6A57B2, 0x26508E6D, 0x1EA119FA, 0x3D4233DD, 0x2A1462B3)


def hash160_33_words_from_x(x: torch.Tensor, parity) -> List[torch.Tensor]:
    """5 big-endian uint32 words of RIPEMD-160(SHA-256(parity || x_be)),
    from (8, *S) int64 32-bit limbs; ``parity`` is 2, 3 or a tensor."""
    return ripemd160.ripemd160_sha_state_words(
        sha256.sha256_x33_state(x, parity)
    )


def hash160_65_words_from_xy(x: torch.Tensor, y: torch.Tensor
                             ) -> List[torch.Tensor]:
    """5 big-endian words of hash160(04 || x_be || y_be), the uncompressed
    key's hash, from (8, *S) int64 32-bit limbs."""
    return ripemd160.ripemd160_sha_state_words(sha256.sha256_x65_state(x, y))


def script_hash_words(h160w: List[torch.Tensor]) -> List[torch.Tensor]:
    """5 big-endian words of hash160(00 14 || h160), the P2SH-P2WPKH
    redeem script's hash: one SHA-256 compression of the 22-byte script
    (pad 0x80 at byte 22, bit length 176), then RIPEMD-160."""
    w = [0x00140000 | (h160w[0] >> 16)]
    for i in range(1, 5):
        w.append(((h160w[i - 1] & 0xFFFF) << 16) | (h160w[i] >> 16))
    w.append(((h160w[4] & 0xFFFF) << 16) | 0x8000)
    w += [0] * 9 + [176]
    iv = [torch.full_like(h160w[0], v) for v in sha256.IV]
    return ripemd160.ripemd160_sha_state_words(sha256.compress(iv, w))


def base58check_checksum_word(version: int, h160w: List[torch.Tensor]):
    """First big-endian word of SHA256d(version || h160): the 4 checksum
    bytes (``vgen_tpu/ops/encode.py`` ``base58check_checksum_word``)."""
    w = [((version << 24) | (h160w[0] >> 8)) & M32]
    for i in range(1, 5):
        w.append((((h160w[i - 1] & 0xFF) << 24) | (h160w[i] >> 8)) & M32)
    w.append(((h160w[4] & 0xFF) << 24) | 0x00800000)
    w += [0] * 9 + [168]
    like = h160w[0]
    iv = [torch.full_like(like, v) for v in sha256.IV]
    st = sha256.compress(iv, w)
    st2 = sha256.compress(iv, list(st) + [0x80000000, 0, 0, 0, 0, 0, 0, 256])
    return st2[0]


def _leading_zeros(rows: List[torch.Tensor]) -> torch.Tensor:
    run = torch.ones_like(rows[0], dtype=torch.bool)
    count = torch.zeros_like(rows[0])
    for r in rows:
        run = run & (r == 0)
        count = count + run.to(count.dtype)
    return count


def base58check_symbols(version: int, h160w: List[torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Base58Check of version || h160 || checksum -> (syms (34, *S) int64
    digit values, most significant first; length (*S,) int64).

    The reference's shift (``_base58_from_payload25``): one digit 0 ('1')
    per leading zero byte of the 25-byte payload, then the significant
    digits, left-aligned and padded with 0; length = 34 - (leading zero
    digits - leading zero bytes)."""
    n = [torch.full_like(h160w[0], version)] + list(h160w) + [
        base58check_checksum_word(version, h160w)]
    payload_bytes = [n[0]] + [(w >> sh) & 0xFF for w in n[1:]
                              for sh in (24, 16, 8, 0)]
    digits = []  # least significant first
    for _ in range(7):
        rem = torch.zeros_like(n[0])
        for i in range(7):
            cur = (rem << 32) | n[i]
            n[i] = cur // _B58_POW5
            rem = cur - n[i] * _B58_POW5
        for _ in range(5):
            digits.append(rem % 58)
            rem = rem // 58
    # the 35th digit is 0: the payload is below 6 * 2^192 < 58^34 for
    # versions 0 and 5
    msd = digits[BASE58_SYMS - 1::-1]
    shift = _leading_zeros(msd) - _leading_zeros(payload_bytes)
    ext = torch.stack(msd + [torch.zeros_like(msd[0])] * BASE58_SYMS)
    pos = torch.arange(BASE58_SYMS, device=ext.device).reshape(
        (BASE58_SYMS,) + (1,) * shift.dim())
    syms = torch.gather(ext, 0, pos + shift.unsqueeze(0))
    return syms, BASE58_SYMS - shift


def eth_symbols(acct: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """EIP-55 symbols of an Ethereum account after "0x" -> (syms (40, *S)
    int64, length (*S,) = 40), from its 5 big-endian words: nibble i
    (most significant first) is 0-9 -> 0..9, a-f -> 10..15, and A-F ->
    16..21 where nibble i of keccak256 of the 40 lowercase-hex ASCII bytes
    is 8 or more (``vgen_tpu/ops/encode.py`` ``eth_symbols``)."""
    nib = [(acct[i // 8] >> (28 - 4 * (i % 8))) & 0xF for i in range(ETH_SYMS)]
    ascii_lower = [n + 48 + torch.where(n >= 10, 39, 0) for n in nib]
    digest = keccak.keccak256_hex40_bytes(ascii_lower)
    syms = []
    for i, n in enumerate(nib):
        cs = (digest[i // 2] >> (4 if i % 2 == 0 else 0)) & 0xF
        syms.append(torch.where((n >= 10) & (cs >= 8), n + 6, n))
    return torch.stack(syms), torch.full_like(nib[0], ETH_SYMS)


def polymod_init(hrp: str, witver: int) -> int:
    """bech32 polymod state after the constant prefix: the expansion of
    ``hrp`` and the witness version (host, as the reference's
    ``_polymod_init``)."""
    chk = 1
    values = ([ord(c) >> 5 for c in hrp] + [0]
              + [ord(c) & 31 for c in hrp] + [witver])
    for v in values:
        chk = _polymod_step(chk, v)
    return chk


def _polymod_step(chk, v):
    top = chk >> 25
    chk = ((chk & 0x1FFFFFF) << 5) ^ v
    for i in range(5):
        chk = chk ^ (((top >> i) & 1) * _BECH32_GEN[i])
    return chk


BECH32_INIT_BC_V0 = polymod_init("bc", 0)  # csrc/encode.cuh kBech32InitBcV0
BECH32_INIT_BC_V1 = polymod_init("bc", 1)  # csrc/encode.cuh kBech32InitBcV1


def bech32_p2wpkh_symbols(h160w: List[torch.Tensor]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """bech32 symbols of a P2WPKH address after "bc1" -> (syms (39, *S)
    int64, length (*S,) = 39): witness version 0, the 160 bits as 32
    five-bit groups (most significant first, no padding needed), and the
    six checksum symbols (bech32 constant 1)."""
    bits = [(w >> (31 - j)) & 1 for w in h160w for j in range(32)]
    groups = []
    for g in range(32):
        v = torch.zeros_like(h160w[0])
        for j in range(5):
            v = (v << 1) | bits[5 * g + j]
        groups.append(v)
    chk = torch.full_like(h160w[0], BECH32_INIT_BC_V0)
    for v in groups:
        chk = _polymod_step(chk, v)
    for _ in range(6):
        chk = _polymod_step(chk, 0)
    chk = chk ^ 1
    checksum = [(chk >> (5 * (5 - i))) & 31 for i in range(6)]
    syms = torch.stack([torch.zeros_like(chk)] + groups + checksum)
    return syms, torch.full_like(chk, BECH32_SYMS)


def bech32m_p2tr_symbols(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """bech32m symbols of a P2TR address after "bc1" -> (syms (59, *S)
    int64, length (*S,) = 59): witness version 1, the output key's 256 bits
    (x: (8, *S) int64 32-bit limbs, limb 7 the most significant) as 52
    five-bit groups, most significant first, the last padded with 4 zero
    bits, and the six checksum symbols (bech32m constant 0x2BC830A3).  The
    counterpart of ``segwit_symbols(program, 1)``."""
    bits = [(x[7 - i // 32] >> (31 - i % 32)) & 1 for i in range(256)]
    bits += [torch.zeros_like(x[0])] * 4
    groups = []
    for g in range(52):
        v = torch.zeros_like(x[0])
        for j in range(5):
            v = (v << 1) | bits[5 * g + j]
        groups.append(v)
    chk = torch.full_like(x[0], BECH32_INIT_BC_V1)
    for v in groups:
        chk = _polymod_step(chk, v)
    for _ in range(6):
        chk = _polymod_step(chk, 0)
    chk = chk ^ BECH32M_CONST
    checksum = [(chk >> (5 * (5 - i))) & 31 for i in range(6)]
    syms = torch.stack([torch.ones_like(chk)] + groups + checksum)
    return syms, torch.full_like(chk, BECH32M_SYMS)
