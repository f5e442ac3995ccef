"""Interval matching, address symbols and the DFA walk, the GLV variant
masks and top-k (plain PyTorch), plus the host helpers the scan needs from
``vgen_tpu/ops/pipeline.py``.

That module imports jax at its top level, so the few numpy helpers the
slice uses are re-expressed here; ``tests/test_torch_scanner.py`` holds
them equal to the originals.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.ops import encode, field, keccak, u256

TOP_K = 16  # index slots per window in a packed row
PACKED_WIDTH = 2 + 2 * TOP_K  # [count, ops, idx x16, vbits x16]
MAX_INTERVALS = 8  # comparator slots

# DFA width (digits + EOS + PAD) per format (``FORMAT_DFA_WIDTH``)
FORMAT_DFA_WIDTH = {
    AddressFormat.P2PKH: 60,
    AddressFormat.P2PKH_UNCOMPRESSED: 60,
    AddressFormat.P2SH_P2WPKH: 60,
    AddressFormat.P2WPKH: 34,
    AddressFormat.P2TR: 34,
    AddressFormat.ETHEREUM: 24,
}

# big-endian 32-bit words of the value the interval route compares
# (``INTERVAL_WORDS``): hash160 of the key (P2PKH, P2WPKH, uncompressed), of
# the redeem script (P2SH-P2WPKH), the account (Ethereum), the output key's
# x (P2TR)
INTERVAL_WORDS = {
    AddressFormat.P2PKH: 5,
    AddressFormat.P2PKH_UNCOMPRESSED: 5,
    AddressFormat.P2SH_P2WPKH: 5,
    AddressFormat.P2WPKH: 5,
    AddressFormat.P2TR: 8,
    AddressFormat.ETHEREUM: 5,
}

GLV_FORMATS = (
    AddressFormat.P2PKH,
    AddressFormat.P2PKH_UNCOMPRESSED,
    AddressFormat.P2WPKH,
    AddressFormat.P2SH_P2WPKH,
    AddressFormat.ETHEREUM,
)

# GLV formats whose hashed value covers y (``GLV_EXACT_Y``): the kernels run
# the full finish, and bit 2v+pi of a GLV mask is the point (beta^v x, +y)
# for pi = 0 and (beta^v x, -y) for pi = 1, so the host resolves each bit to
# one key (``glv_bit_variant_keys(parity_exact=True)``).  The other GLV
# formats hash the compressed key, whose +- pair is the two prefix parities.
GLV_EXACT_Y = (
    AddressFormat.P2PKH_UNCOMPRESSED,
    AddressFormat.ETHEREUM,
)


def intervals_to_words(ivs, n_words: int = 5, n_slots: int = MAX_INTERVALS):
    """Host: [(lo, hi)] ints -> (lo, hi) uint32 arrays (n_slots, n_words) of
    big-endian words, padded with empty slots (lo = 1 > hi = 0)."""
    lo = np.zeros((n_slots, n_words), dtype=np.uint32)
    hi = np.zeros((n_slots, n_words), dtype=np.uint32)
    lo[:, n_words - 1] = 1
    for j, (l, h) in enumerate(ivs):
        for w in range(n_words):
            sh = 32 * (n_words - 1 - w)
            lo[j, w] = (l >> sh) & 0xFFFFFFFF
            hi[j, w] = (h >> sh) & 0xFFFFFFFF
    return lo, hi


def interval_slot_count(n_ivs: int) -> int:
    """Slots for n_ivs intervals: the next power of two, capped at
    MAX_INTERVALS."""
    return min(MAX_INTERVALS, max(1, 1 << (n_ivs - 1).bit_length()))


def in_intervals(words: List[torch.Tensor], lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """Lexicographic lo <= words <= hi (word 0 most significant, inclusive)
    against any of the slots.  words: W int64 tensors; lo, hi: (n_slots, W)
    int64 tensors of uint32 values."""
    n = len(words)
    matched = torch.zeros(words[0].shape, dtype=torch.bool,
                          device=words[0].device)
    for j in range(lo.shape[0]):
        ge = words[n - 1] >= lo[j, n - 1]
        le = words[n - 1] <= hi[j, n - 1]
        for w in range(n - 2, -1, -1):
            ge = (words[w] > lo[j, w]) | ((words[w] == lo[j, w]) & ge)
            le = (words[w] < hi[j, w]) | ((words[w] == hi[j, w]) & le)
        matched = matched | (ge & le)
    return matched


def _glv_mask(fmt: AddressFormat, x3: torch.Tensor, y3, hit) -> torch.Tensor:
    """6-bit GLV variant mask: bit 2v+pi is set when ``hit`` holds for the
    value words of variant (beta^v x, pi).  The x-coordinates {x, beta x,
    beta^2 x} carry the six keys {+-k, +-lk, +-l^2 k}; pi is the prefix
    parity 2 + pi of the compressed key (y unused, pass None), or for the
    GLV_EXACT_Y formats the sign of y (pi = 0: y3, pi = 1: -y3)."""
    xs = (x3, field.mul(x3, u256.constant(ec.BETA, x3)),
          field.mul(x3, u256.constant(ec.BETA2, x3)))
    ys = (y3, field.neg(y3)) if fmt in GLV_EXACT_Y else (None, None)
    mask = torch.zeros(x3.shape[1:], dtype=torch.int64, device=x3.device)
    for v, xv in enumerate(xs):
        for pi in range(2):
            m = hit(variant_value_words(fmt, xv, ys[pi], pi))
            mask = mask | (m.to(torch.int64) << (2 * v + pi))
    return mask


def glv_interval_mask(fmt: AddressFormat, x3: torch.Tensor, y3,
                      lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """GLV variant mask of the interval route (``glv_interval_mask``): the
    variant's value lies in an interval.  y3 (canonical) only for the
    GLV_EXACT_Y formats."""
    return _glv_mask(fmt, x3, y3, lambda w: in_intervals(w, lo, hi))


def top_k_match_indices(scores: torch.Tensor) -> torch.Tensor:
    """The TOP_K largest scores along the last axis, in descending order
    (scores are the index for a match and -1 otherwise, so the result is
    the highest matching indices padded with -1)."""
    return torch.topk(scores, TOP_K, dim=-1, sorted=True).values


def x_words(x: torch.Tensor) -> List[torch.Tensor]:
    """The interval value of P2TR: the output key's x as 8 big-endian
    words, from (8, *S) int64 limbs."""
    return [x[7 - i] for i in range(8)]


def _compressed_value(fmt: AddressFormat, x: torch.Tensor, parity):
    """The value of a compressed-key format: hash160(parity || x), and for
    P2SH-P2WPKH the hash160 of its redeem script 00 14 || hash160."""
    h = encode.hash160_33_words_from_x(x, parity)
    return encode.script_hash_words(h) if fmt == AddressFormat.P2SH_P2WPKH else h


def interval_value_words(fmt: AddressFormat, x3: torch.Tensor,
                         y3: torch.Tensor) -> List[torch.Tensor]:
    """The value a hash format's interval route compares, as 5 big-endian
    words, for the point (x3, y3) (canonical (8, *S) limbs): hash160 of the
    compressed key (P2PKH, P2WPKH), of its redeem script (P2SH-P2WPKH),
    hash160 of 04 || x || y (uncompressed P2PKH), or the Ethereum account
    (``interval_value_words``)."""
    if fmt == AddressFormat.P2PKH_UNCOMPRESSED:
        return encode.hash160_65_words_from_xy(x3, y3)
    if fmt == AddressFormat.ETHEREUM:
        return keccak.eth_account_words_from_xy(x3, y3)
    if fmt in (AddressFormat.P2PKH, AddressFormat.P2WPKH,
               AddressFormat.P2SH_P2WPKH):
        return _compressed_value(fmt, x3, 2 + (y3[0] & 1))
    raise ValueError(f"no hashed value for {fmt.value}")


def variant_value_words(fmt: AddressFormat, xv: torch.Tensor, yv,
                        pi: int) -> List[torch.Tensor]:
    """The value words of GLV variant (xv, pi): the compressed key with
    prefix 2 + pi, or for the GLV_EXACT_Y formats the point (xv, yv)."""
    if fmt in GLV_EXACT_Y:
        return interval_value_words(fmt, xv, yv)
    return _compressed_value(fmt, xv, 2 + pi)


def address_symbols(fmt: AddressFormat, words: List[torch.Tensor]):
    """(syms (T, *S), length (*S,)) of the address of a value: Base58Check
    with version 0 (P2PKH, uncompressed) or 5 (P2SH-P2WPKH), bech32 after
    "bc1" (P2WPKH), EIP-55 hex after "0x" (Ethereum)."""
    if fmt in (AddressFormat.P2PKH, AddressFormat.P2PKH_UNCOMPRESSED):
        return encode.base58check_symbols(0, words)
    if fmt == AddressFormat.P2SH_P2WPKH:
        return encode.base58check_symbols(5, words)
    if fmt == AddressFormat.P2WPKH:
        return encode.bech32_p2wpkh_symbols(words)
    if fmt == AddressFormat.ETHEREUM:
        return encode.eth_symbols(words)
    raise ValueError(f"no address symbols for {fmt.value}")


def dfa_walk(table: torch.Tensor, accept: torch.Tensor, start: int,
             syms: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """``match_symbols_gather``: T + 1 steps over table (S, W); step j
    feeds syms[j] while j < length, EOS (W - 2) at j == length and PAD
    (W - 1) after it -> accept[state] as bool.  Any state count."""
    W = table.shape[1]
    flat = table.reshape(-1).to(torch.int64)
    T = syms.shape[0]
    state = torch.full(length.shape, int(start), dtype=torch.int64,
                       device=syms.device)
    for j in range(T + 1):
        sym = torch.where(j < length, syms[min(j, T - 1)],
                          torch.where(j == length, W - 2, W - 1))
        state = flat[state * W + sym]
    return accept.to(torch.int64)[state] != 0


def dfa_matches(fmt: AddressFormat, words: List[torch.Tensor],
                table: torch.Tensor, accept: torch.Tensor,
                start: int) -> torch.Tensor:
    """Whether the address of each value (5 big-endian words) is accepted
    by the DFA."""
    syms, length = address_symbols(fmt, words)
    return dfa_walk(table, accept, start, syms, length)


def glv_dfa_mask(fmt: AddressFormat, x3: torch.Tensor, y3, table: torch.Tensor,
                 accept: torch.Tensor, start: int) -> torch.Tensor:
    """GLV variant mask for the DFA: the variant's address is accepted (the
    bit layout of ``glv_interval_mask`` and ``glv_variant_symbols``)."""
    return _glv_mask(
        fmt, x3, y3, lambda w: dfa_matches(fmt, w, table, accept, start))
