"""Anchored-literal-prefix patterns compiled to hash-value intervals.

The reference (and every vanity searcher) runs the full encode+regex per
candidate.  For the dominant pattern shape -- ``^<literal prefix>`` -- the
set of matching addresses is the preimage of a union of a few *contiguous
integer intervals* of the hashed payload (hash160 for Base58Check/segwit-v0,
the x-only output key for P2TR, the account bytes for Ethereum).  Checking
``lo <= h <= hi`` on-device replaces the Base58Check checksum double-SHA,
the 34-step base conversion, and the DFA scan with a handful of word
compares -- the same specialization VanitySearch uses to reach Gkeys/s
(reference README.md:194 cites it as the speed yardstick).

Correctness contract: the interval union may be a slight OVER-approximation
(checksum bytes are treated as free, so bounds are widened by < 1 part in
2^32); it must never under-approximate.  The host re-derives and
regex-checks every device-reported candidate (scan/scanner.py drain path),
so false positives are filtered; false negatives would be unsound and are
impossible by construction (any matching address's payload value lies in
the exact digit-prefix interval, which we only ever widen).

Reference behavior being specialized: pattern.rs:43-45 (regex match) over
addresses produced per gpu.rs:1030-1093.
"""

from __future__ import annotations

import string
from functools import lru_cache
from typing import List, Optional, Tuple

from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.crypto.encode import BASE58_ALPHABET, BECH32_CHARSET

# Interval endpoints are inclusive ints on the format's device-checked value.
Interval = Tuple[int, int]

# device-side comparator slots; patterns needing more fall back to the DFA
MAX_INTERVALS = 8

_SAFE_LITERALS = set(string.ascii_letters + string.digits)


def literal_prefix(pattern: str) -> Optional[str]:
    """Extract the literal prefix of an ``^literal`` / ``^literal.*`` pattern.

    Returns None when the pattern is not a plain anchored literal (any
    metachar, class, alternation, or escape -> general DFA path).
    """
    if not pattern.startswith("^"):
        return None
    body = pattern[1:]
    if body.endswith(".*"):
        body = body[:-2]
    if any(c not in _SAFE_LITERALS for c in body):
        return None
    return body


def _merge(ivs: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for lo, hi in sorted(i for i in ivs if i[0] <= i[1]):
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _b58_value(s: str) -> Optional[int]:
    v = 0
    for c in s:
        i = BASE58_ALPHABET.find(c)
        if i < 0:
            return None
        v = v * 58 + i
    return v


def _base58check_intervals(version: int, prefix: str) -> List[Interval]:
    """Intervals on the 160-bit hash H where Base58Check(version||H||cksum)
    starts with ``prefix``.

    Payload = version(1) || H(20) || checksum(4) = 25 bytes; its integer
    value V = base·2^224? no -- V = version·256^24 + H·2^32 + c with
    c ∈ [0, 2^32).  The encoding is '1' per leading zero byte followed by
    the canonical base-58 digits of V.  For a digit-length L and digit
    prefix Q, V ranges over [val(Q)·58^(L-|Q|), (val(Q)+1)·58^(L-|Q|)) ∩
    [58^(L-1), 58^L); intersecting with the byte-structure range for each
    leading-zero count and projecting out the free checksum word yields
    inclusive intervals on H.
    """
    total = 25
    full_hi = (1 << 160) - 1
    out: List[Interval] = []
    z_values = range(1, total + 1) if version == 0 else [0]
    for z in z_values:
        n = total - z
        if version == 0:
            if n == 0:
                continue  # all-zero payload cannot occur (checksum != 0 w.h.p.)
            m_min = 1 << (8 * (n - 1))
            m_max = (1 << (8 * n)) - 1
        else:
            m_min = version << (8 * 24)
            m_max = ((version + 1) << (8 * 24)) - 1
        # the literal must match the run of '1's then be a digit prefix
        if len(prefix) <= z:
            if prefix != "1" * len(prefix):
                continue
            q = ""
        else:
            if prefix[:z] != "1" * z:
                continue
            q = prefix[z:]
            if q[0] == "1":
                continue  # canonical digits never lead with value-0 digit
        qval = _b58_value(q)
        if qval is None:
            continue  # non-base58 char: never matches
        k = len(q)
        L = max(k, 1)
        while 58 ** (L - 1) <= m_max:
            lo = max(58 ** (L - 1), m_min)
            hi = min(58**L - 1, m_max)
            if k > 0:
                lo = max(lo, qval * 58 ** (L - k))
                hi = min(hi, (qval + 1) * 58 ** (L - k) - 1)
            if lo <= hi:
                base = version << (8 * 24)
                h_lo = max(lo - base, 0) >> 32
                h_hi = (hi - base) >> 32
                if h_lo <= full_hi:
                    out.append((h_lo, min(h_hi, full_hi)))
            L += 1
    return _merge(out)


def _bech32_intervals(
    prefix: str, witver: int, nbits: int
) -> Optional[List[Interval]]:
    """Intervals on the nbits-bit witness program for a bech32 address
    prefix.  Data part = [witver] + ceil(nbits/5) base-32 groups (zero
    padded) + 6 checksum chars; a literal reaching into the checksum is not
    interval-compilable (returns None -> DFA path)."""
    hrp_ver = "bc1" + BECH32_CHARSET[witver]
    n_groups = (nbits + 4) // 5
    full = [(0, (1 << nbits) - 1)]
    if len(prefix) <= len(hrp_ver):
        return full if hrp_ver.startswith(prefix) else []
    if not prefix.startswith(hrp_ver):
        return []
    q = prefix[len(hrp_ver):]
    if len(q) > n_groups:
        return None  # constrains checksum chars: general path
    qval = 0
    for c in q:
        i = BECH32_CHARSET.find(c)
        if i < 0:
            return []
        qval = qval * 32 + i
    shift = nbits - 5 * len(q)
    if shift >= 0:
        return [(qval << shift, ((qval + 1) << shift) - 1)]
    # last group contains (-shift) padding bits that must be zero (BIP173)
    pad = -shift
    if qval & ((1 << pad) - 1):
        return []
    v = qval >> pad
    return [(v, v)]


def _eth_intervals(prefix: str) -> Optional[List[Interval]]:
    """Intervals on the 20-byte account value for an ``0x...`` hex prefix.

    EIP-55 casing depends on a hash of the whole address, so letter case is
    NOT resolvable per-position; the interval ignores case (an
    over-approximation) and the host-side regex filters the casing.  This
    keeps soundness: every correctly-cased match falls in the interval.
    """
    full = [(0, (1 << 160) - 1)]
    if len(prefix) <= 2:
        return full if "0x".startswith(prefix) else []
    if not prefix.startswith("0x"):
        return []
    q = prefix[2:]
    if len(q) > 40:
        return []
    try:
        qval = int(q, 16)
    except ValueError:
        return []
    shift = 160 - 4 * len(q)
    return [(qval << shift, ((qval + 1) << shift) - 1)]


def _prefix_char_sets(pattern: str, case_insensitive: bool):
    """Per-position character sets of the pattern's anchored prefix, from
    the redfa AST: the run of single-symbol atoms (literals/classes)
    following ^, stopping at the first quantifier/alternation/anchor or
    any unenumerable (> 64 chars) class."""
    from vgen_tpu_torch.pattern.redfa import BOT, EOS, RegexError, _Parser

    try:
        node = _Parser(pattern, case_insensitive).parse()
    except RegexError:
        return None
    seq = node[1] if node[0] == "cat" else [node]
    if not seq or seq[0][0] != "sym" or seq[0][1] != frozenset([BOT]):
        return None
    sets = []
    for nd in seq[1:]:
        if nd[0] != "sym":
            break
        s = nd[1]
        if BOT in s or EOS in s or len(s) > 64:
            break
        sets.append("".join(sorted(chr(b) for b in s)))
    return sets or None


def _compile_prefix(fmt: AddressFormat, prefix: str) -> Optional[List[Interval]]:
    """Interval union for one literal address prefix (None = needs DFA)."""
    if fmt in (AddressFormat.P2PKH, AddressFormat.P2PKH_UNCOMPRESSED):
        return _base58check_intervals(0, prefix)
    if fmt == AddressFormat.P2SH_P2WPKH:
        return _base58check_intervals(5, prefix)
    if fmt == AddressFormat.P2WPKH:
        return _bech32_intervals(prefix, 0, 160)
    if fmt == AddressFormat.P2TR:
        return _bech32_intervals(prefix, 1, 256)
    if fmt == AddressFormat.ETHEREUM:
        return _eth_intervals(prefix.lower())
    return None  # pragma: no cover


_VALUE_BITS = {
    AddressFormat.P2PKH: 160,
    AddressFormat.P2PKH_UNCOMPRESSED: 160,
    AddressFormat.P2SH_P2WPKH: 160,
    AddressFormat.P2WPKH: 160,
    AddressFormat.P2TR: 256,
    AddressFormat.ETHEREUM: 160,
}

_MAX_PREFIX_VARIANTS = 256


@lru_cache(maxsize=256)
def prefilter_intervals(
    fmt: AddressFormat, pattern: str, case_insensitive: bool
) -> Optional[Tuple[Tuple[Interval, ...], float]]:
    """Interval OVER-approximation of a general pattern via its longest
    interval-compilable anchored prefix, plus the approximation's match
    probability.

    A pattern like ``^1C[ab]x.*z`` is not interval-compilable, but its
    prefix ``^1C[ab]x`` is (two literal variants); matching the prefix
    intervals on-device and running the full regex only on the (rare)
    survivors on the host turns the 2.4x-slower DFA path back into the
    interval fast path.  Soundness is inherited from the interval
    contract: every full-pattern match is a prefix match, and the scan
    drain already regex-filters every reported candidate.

    Returns (intervals, probability) for the LONGEST feasible prefix
    (longer prefix => lower survivor probability), or None when no prefix
    is usable.  The caller gates on probability * window size to bound
    host-side survivor work.
    """
    sets = _prefix_char_sets(pattern, case_insensitive)
    if sets is None:
        return None
    bits = _VALUE_BITS[fmt]
    import itertools

    for k in range(len(sets), 0, -1):
        n_var = 1
        for s in sets[:k]:
            n_var *= len(s)
        if n_var > _MAX_PREFIX_VARIANTS:
            continue
        ivs: List[Interval] = []
        feasible = True
        for chars in itertools.product(*sets[:k]):
            got = _compile_prefix(fmt, "".join(chars))
            if got is None:  # e.g. bech32 prefix reaching the checksum
                feasible = False
                break
            ivs.extend(got)
        if not feasible:
            continue
        merged = _merge(ivs)
        if len(merged) > MAX_INTERVALS:
            continue
        p = sum(hi - lo + 1 for lo, hi in merged) / float(1 << bits)
        return tuple(merged), p
    return None


@lru_cache(maxsize=256)
def match_intervals(
    fmt: AddressFormat, pattern: str, case_insensitive: bool
) -> Optional[Tuple[Interval, ...]]:
    """Compile a pattern to inclusive intervals on the format's device value.

    Returns None when the pattern is not interval-compilable (general DFA
    path); an empty tuple means the pattern can never match any address of
    the format.  Value domains: hash160(pubkey) for P2PKH/P2WPKH/
    uncompressed, hash160(redeem script) for P2SH-P2WPKH, x-only output key
    for P2TR, account bytes for Ethereum.
    """
    prefix = literal_prefix(pattern)
    if prefix is None:
        return None
    b58_prefixes = [prefix]
    if case_insensitive and any(c.isalpha() for c in prefix):
        if fmt in (AddressFormat.P2WPKH, AddressFormat.P2TR):
            # bech32 addresses are emitted lowercase; fold and proceed
            prefix = prefix.lower()
        elif fmt == AddressFormat.ETHEREUM:
            pass  # hex value is case-independent; casing filtered on host
        else:
            # Base58 is case-significant: expand the case-combination
            # variants (each its own literal prefix; variants with
            # non-base58 letters like O/I/l contribute nothing) and take
            # the interval union.  Short alphabetic prefixes fit the
            # MAX_INTERVALS comparator slots; longer ones exceed the slot
            # budget below and fall back to the DFA path.  (The reference
            # just prepends (?i) and regexes per candidate,
            # pattern.rs:26-30.)
            import itertools

            n_alpha = sum(c.isalpha() for c in prefix)
            if n_alpha > 4:  # 2^n variants; > 16 never fits 8 slots
                return None
            b58_prefixes = [
                "".join(chars)
                for chars in itertools.product(
                    *[
                        (c.lower(), c.upper()) if c.isalpha() else (c,)
                        for c in prefix
                    ]
                )
            ]
    if fmt in (AddressFormat.P2PKH, AddressFormat.P2PKH_UNCOMPRESSED):
        ivs = _merge(
            [iv for p in b58_prefixes for iv in _base58check_intervals(0, p)]
        )
    elif fmt == AddressFormat.P2SH_P2WPKH:
        ivs = _merge(
            [iv for p in b58_prefixes for iv in _base58check_intervals(5, p)]
        )
    elif fmt == AddressFormat.P2WPKH:
        ivs = _bech32_intervals(prefix, 0, 160)
    elif fmt == AddressFormat.P2TR:
        ivs = _bech32_intervals(prefix, 1, 256)
    elif fmt == AddressFormat.ETHEREUM:
        ivs = _eth_intervals(prefix.lower() if case_insensitive else prefix)
    else:  # pragma: no cover
        return None
    if ivs is None or len(ivs) > MAX_INTERVALS:
        return None
    return tuple(ivs)
