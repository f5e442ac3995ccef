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
from vgen_tpu_torch.ops import encode, field, u256

TOP_K = 16  # index slots per window in a packed row
PACKED_WIDTH = 2 + 2 * TOP_K  # [count, ops, idx x16, vbits x16]
MAX_INTERVALS = 8  # comparator slots

# DFA width (digits + EOS + PAD) of the formats the DFA kernels serve
# (``FORMAT_DFA_WIDTH``)
FORMAT_DFA_WIDTH = {
    AddressFormat.P2PKH: 60,
    AddressFormat.P2WPKH: 34,
    AddressFormat.P2TR: 34,
}

# big-endian 32-bit words of the value the interval route compares
# (``INTERVAL_WORDS``): hash160 for P2PKH and P2WPKH, the output key's x
# for P2TR
INTERVAL_WORDS = {
    AddressFormat.P2PKH: 5,
    AddressFormat.P2WPKH: 5,
    AddressFormat.P2TR: 8,
}

GLV_FORMATS = (
    AddressFormat.P2PKH,
    AddressFormat.P2PKH_UNCOMPRESSED,
    AddressFormat.P2WPKH,
    AddressFormat.P2SH_P2WPKH,
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


def _glv_mask(x3: torch.Tensor, hit) -> torch.Tensor:
    """6-bit GLV variant mask: bit 2v+pi is set when ``hit`` holds for
    hash160((2+pi) || beta^v * x).  The x-coordinates {x, beta x, beta^2 x}
    carry the six keys {±k, ±λk, ±λ²k}; the ± pair is the two prefix
    parities, so y is never needed."""
    xs = (x3, field.mul(x3, u256.constant(ec.BETA, x3)),
          field.mul(x3, u256.constant(ec.BETA2, x3)))
    mask = torch.zeros(x3.shape[1:], dtype=torch.int64, device=x3.device)
    for v, xv in enumerate(xs):
        for pi in range(2):
            m = hit(encode.hash160_33_words_from_x(xv, 2 + pi))
            mask = mask | (m.to(torch.int64) << (2 * v + pi))
    return mask


def glv_interval_mask(x3: torch.Tensor, lo: torch.Tensor,
                      hi: torch.Tensor) -> torch.Tensor:
    """GLV variant mask of the compressed-hash160 formats: the hash160 lies
    in an interval."""
    return _glv_mask(x3, lambda h160w: in_intervals(h160w, lo, hi))


def top_k_match_indices(scores: torch.Tensor) -> torch.Tensor:
    """The TOP_K largest scores along the last axis, in descending order
    (scores are the index for a match and -1 otherwise, so the result is
    the highest matching indices padded with -1)."""
    return torch.topk(scores, TOP_K, dim=-1, sorted=True).values


def x_words(x: torch.Tensor) -> List[torch.Tensor]:
    """The interval value of P2TR: the output key's x as 8 big-endian
    words, from (8, *S) int64 limbs."""
    return [x[7 - i] for i in range(8)]


def hash160_words(x3: torch.Tensor, y3: torch.Tensor) -> List[torch.Tensor]:
    """The interval value of P2PKH and P2WPKH: hash160 of the compressed
    key, prefix 2 + (y & 1), as 5 big-endian words
    (``interval_value_words``).  y3 must be canonical."""
    return encode.hash160_33_words_from_x(x3, 2 + (y3[0] & 1))


def address_symbols(fmt: AddressFormat, h160w: List[torch.Tensor]):
    """(syms (T, *S), length (*S,)) of the address of a hash160:
    Base58Check for P2PKH, bech32 after "bc1" for P2WPKH."""
    if fmt == AddressFormat.P2PKH:
        return encode.base58check_symbols(0, h160w)
    if fmt == AddressFormat.P2WPKH:
        return encode.bech32_p2wpkh_symbols(h160w)
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


def dfa_matches(fmt: AddressFormat, h160w: List[torch.Tensor],
                table: torch.Tensor, accept: torch.Tensor,
                start: int) -> torch.Tensor:
    """Whether the address of each hash160 is accepted by the DFA."""
    syms, length = address_symbols(fmt, h160w)
    return dfa_walk(table, accept, start, syms, length)


def glv_dfa_mask(fmt: AddressFormat, x3: torch.Tensor, table: torch.Tensor,
                 accept: torch.Tensor, start: int) -> torch.Tensor:
    """GLV variant mask for the DFA: the address of the hash160 is accepted
    (the bit layout of ``glv_interval_mask`` and ``glv_variant_symbols``)."""
    return _glv_mask(
        x3, lambda h160w: dfa_matches(fmt, h160w, table, accept, start))
