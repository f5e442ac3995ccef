"""Pattern: compiled address-matching pattern + difficulty/charset analysis.

Behavioral parity with the reference's Pattern (pattern.rs:9-294):
  * ``matches``            -- regex is_match on the address string
  * ``validate_charset``   -- flag literals outside the format alphabet
                              (pattern.rs:49-177 semantics, incl. class
                              range expansion and negated-class skip)
  * ``estimate_difficulty``-- alphabet^fixed_chars with anchored network
                              prefix subtraction (pattern.rs:183-253)

plus what the reference does NOT have: ahead-of-time compilation to a dense
DFA projected onto each address format's *digit alphabet* so the device can
match without ever materializing ASCII strings on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List

import numpy as np

from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.crypto.encode import BASE58_ALPHABET, BECH32_CHARSET
from vgen_tpu_torch.pattern.redfa import BOT, EOS, DFA, RegexError, compile_dfa

# Valid literal characters per charset (pattern.rs:50-59)
_VALID_CHARS = {
    "Base58": BASE58_ALPHABET,
    "Bech32": "023456789acdefghjklmnpqrstuvwxyz",
    "Hex": "0123456789abcdefABCDEFx",
}

# Device symbol alphabets: device emits symbol indices, the projected table
# maps them through the byte DFA.  Ethereum needs cased hex because EIP-55
# addresses are mixed-case (address.rs:176-198).
DIGITS_BASE58 = BASE58_ALPHABET
DIGITS_BECH32 = BECH32_CHARSET
DIGITS_ETH = "0123456789abcdef" + "ABCDEF"

# Constant address prefixes the device never emits as symbols; pre-run on the
# byte DFA at compile time.
_DEVICE_ALPHABETS: Dict[AddressFormat, tuple] = {
    AddressFormat.P2PKH: (DIGITS_BASE58, ""),
    AddressFormat.P2PKH_UNCOMPRESSED: (DIGITS_BASE58, ""),
    AddressFormat.P2SH_P2WPKH: (DIGITS_BASE58, ""),
    AddressFormat.P2WPKH: (DIGITS_BECH32, "bc1"),
    AddressFormat.P2TR: (DIGITS_BECH32, "bc1"),
    AddressFormat.ETHEREUM: (DIGITS_ETH, "0x"),
}


@dataclass
class DeviceDFA:
    """DFA projected onto a format's digit alphabet for on-device matching.

    table[state, sym] with sym in [0, n_digits) for address digits, then
    sym == n_digits for EOS and sym == n_digits+1 for PAD.  ``start`` already
    accounts for BOT and any constant address prefix ("bc1", "0x").
    """

    table: np.ndarray  # [n_states, n_digits + 2] int32
    accept: np.ndarray  # [n_states] bool
    start: int
    n_digits: int

    @property
    def eos_symbol(self) -> int:
        return self.n_digits

    @property
    def pad_symbol(self) -> int:
        return self.n_digits + 1

    def run(self, symbols: List[int]) -> bool:
        s = self.start
        for sym in symbols:
            s = int(self.table[s, sym])
        return bool(self.accept[s])


class Pattern:
    def __init__(self, pattern: str, case_insensitive: bool = False):
        if pattern == "":
            raise RegexError("Pattern cannot be empty")
        self._original = pattern
        self._case_insensitive = case_insensitive
        self._dfa: DFA = compile_dfa(pattern, case_insensitive)

    @property
    def original(self) -> str:
        return self._original

    @property
    def is_case_insensitive(self) -> bool:
        return self._case_insensitive

    def matches(self, address: str) -> bool:
        return self._dfa.matches_text(address)

    @property
    def char_dfa(self) -> DFA:
        """The byte-level DFA (used by the native CPU scanner)."""
        return self._dfa

    # -- device projection -------------------------------------------------

    @lru_cache(maxsize=None)
    def device_dfa(self, fmt: AddressFormat) -> DeviceDFA:
        digits, prefix = _DEVICE_ALPHABETS[fmt]
        dfa = self._dfa
        start = dfa.run_symbols([BOT] + [ord(c) for c in prefix])
        n_digits = len(digits)
        n_states = dfa.n_states
        table = np.zeros((n_states, n_digits + 2), dtype=np.int32)
        for i, c in enumerate(digits):
            table[:, i] = dfa.table[:, dfa.classes[ord(c)]]
        table[:, n_digits] = dfa.table[:, dfa.classes[EOS]]
        # PAD: freeze accepting sinks, kill everything else (input is over)
        pad_col = np.where(dfa.accept, np.arange(n_states), 0)
        table[:, n_digits + 1] = pad_col
        return DeviceDFA(
            table=table, accept=dfa.accept.copy(), start=start, n_digits=n_digits
        )

    def match_intervals(self, fmt: AddressFormat):
        """Interval compilation for anchored-literal prefixes (see
        pattern.intervals): tuple of inclusive (lo, hi) ints on the format's
        device-checked hash value, () if unsatisfiable, or None when the
        pattern needs the general DFA path."""
        from vgen_tpu_torch.pattern.intervals import match_intervals

        return match_intervals(fmt, self._original, self._case_insensitive)

    def prefilter_intervals(self, fmt: AddressFormat):
        """Interval over-approximation via the longest compilable anchored
        prefix (see pattern.intervals.prefilter_intervals): (intervals,
        match probability) or None.  Used by the scanners to keep general
        patterns with selective literal prefixes on the interval fast path,
        with the full regex applied to survivors on the host."""
        from vgen_tpu_torch.pattern.intervals import prefilter_intervals

        return prefilter_intervals(
            fmt, self._original, self._case_insensitive
        )

    # -- reference-parity analyses ----------------------------------------

    @lru_cache(maxsize=1)
    def _literal_events(self):
        """Literal/class event stream from the redfa parser (the single
        parsing source -- no second hand-rolled scanner; the reference
        duplicates its scanner between pattern.rs:49-177 and :269-294)."""
        from vgen_tpu_torch.pattern.redfa import parse_literal_events

        return tuple(parse_literal_events(self._original))

    def validate_charset(self, fmt: AddressFormat) -> List[str]:
        """Literal chars in the pattern that the format's alphabet excludes.

        Reference behavior (pattern.rs:49-177): a class is flagged only when
        ALL its members are invalid (then every member is reported), negated
        classes never flag, ranges expand, metacharacters and escaped atoms
        outside classes are skipped.  Derived here from the redfa parse
        events instead of a second scanner; '-' inside a class is treated as
        the range operator, not a checkable literal (matching the
        reference's prev_char/pending_range handling of [-0] / [A-])."""
        valid_chars = _VALID_CHARS[fmt.charset_name]

        def is_valid(c: str) -> bool:
            if self._case_insensitive:
                return c.lower() in valid_chars or c.upper() in valid_chars
            return c in valid_chars

        invalid: List[str] = []

        def flag(c: str) -> None:
            if c not in invalid:
                invalid.append(c)

        for ev in self._literal_events():
            if ev[0] == "lit":
                c = ev[1]
                if c.isalnum() and not is_valid(c):
                    flag(c)
            else:
                _, negated, chars = ev
                if negated:
                    continue
                chars = [c for c in chars if c != "-"]
                if chars and not any(is_valid(c) for c in chars):
                    for c in chars:
                        flag(c)
        return invalid

    def estimate_difficulty(self, fmt: AddressFormat) -> int:
        """1-in-N difficulty heuristic (pattern.rs:183-253 semantics)."""
        if fmt.charset_name == "Base58":
            alphabet = 34 if self._case_insensitive else 58
        elif fmt.charset_name == "Bech32":
            alphabet = 32
        else:
            alphabet = 16

        fixed = sum(
            1
            for ev in self._literal_events()
            if ev[0] == "lit" and ev[1].isalnum()
        )

        prefix_sub = 0
        if self._original.startswith("^"):
            rest = self._original[1:]
            if fmt in (AddressFormat.P2PKH, AddressFormat.P2PKH_UNCOMPRESSED):
                prefix_sub = 1 if rest.startswith("1") else 0
            elif fmt == AddressFormat.P2SH_P2WPKH:
                prefix_sub = 1 if rest.startswith("3") else 0
            elif fmt in (AddressFormat.P2WPKH, AddressFormat.P2TR):
                net = "bc1q" if fmt == AddressFormat.P2WPKH else "bc1p"
                for ln in (4, 3, 2, 1):
                    if rest.startswith(net[:ln]):
                        prefix_sub = ln
                        break
            elif fmt == AddressFormat.ETHEREUM:
                if rest.startswith("0x") or rest.startswith("0X"):
                    prefix_sub = 2
                elif rest.startswith("0"):
                    prefix_sub = 1

        effective = max(0, fixed - prefix_sub)
        if effective == 0:
            return 1
        # saturating like the reference's u64 saturating_pow
        result = alphabet**effective
        return min(result, (1 << 64) - 1)


