"""Ahead-of-time regex -> DFA compiler for on-device matching.

The reference matches addresses with the `regex` crate on the CPU per
candidate (pattern.rs:43-45, gpu.rs:1069).  The TPU build instead compiles
the pattern ONCE into a dense DFA transition table that the device applies
byte-parallel over encoded address strings (SURVEY.md §7 layer 5).

Model
-----
The matched text is the address string framed with two virtual symbols:

    BOT  c0 c1 ... c(L-1)  EOS  PAD PAD ...

* ``^`` compiles to a transition on BOT; unanchored patterns get a
  start-state self-loop on every symbol (including BOT) instead.
* ``$`` compiles to a transition on EOS; patterns without ``$`` accept as
  soon as the body matches, and acceptance is *sticky* (ACCEPT is a sink),
  which implements `is_match` (match-anywhere) semantics exactly.
* PAD fills the fixed-width device buffers after EOS; it self-loops on
  ACCEPT and falls to DEAD elsewhere, so fixed-width padding never changes
  the answer.

Mid-pattern ``^``/``$`` degenerate to unmatchable transitions, which is the
same observable behavior as the reference's regex engine on single-line
haystacks.

Supported syntax: literals, ``.``, escapes, ``[...]`` classes with ranges &
negation, ``^`` ``$`` anchors, ``|`` alternation, ``(...)``/``(?:...)``
groups, ``* + ?`` and ``{m}`` ``{m,}`` ``{m,n}`` quantifiers, and a
case-insensitive mode (the reference prepends ``(?i)``, pattern.rs:26-30).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

BOT = 256  # beginning-of-text virtual symbol
EOS = 257  # end-of-text virtual symbol
N_SYMBOLS = 258

_MAX_REPEAT = 128


class RegexError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Parsing to AST
# ---------------------------------------------------------------------------

# AST nodes: ("sym", frozenset[int]) | ("cat", [nodes]) | ("alt", [nodes])
#            | ("star", node) | ("plus", node) | ("opt", node) | ("empty",)


class _Parser:
    def __init__(self, pattern: str, ignore_case: bool, events=None):
        self.src = pattern
        self.pos = 0
        self.ignore_case = ignore_case
        # Optional side channel for charset/difficulty analysis
        # (pattern.Pattern.validate_charset / estimate_difficulty): records
        # ("lit", char) for each unescaped literal atom and
        # ("class", negated, [chars in first-appearance order]) for each
        # character class, AS PARSED -- the analyses share this parser
        # instead of re-scanning the pattern with a second hand-rolled
        # scanner (the reference duplicates its scanning logic between
        # pattern.rs:49-177 and :269-294).
        self.events = events

    def peek(self) -> Optional[str]:
        return self.src[self.pos] if self.pos < len(self.src) else None

    def take(self) -> str:
        c = self.src[self.pos]
        self.pos += 1
        return c

    def parse(self):
        node = self.alternation()
        if self.pos != len(self.src):
            raise RegexError(f"unexpected {self.src[self.pos]!r} at {self.pos}")
        return node

    def alternation(self):
        branches = [self.concat()]
        while self.peek() == "|":
            self.take()
            branches.append(self.concat())
        if len(branches) == 1:
            return branches[0]
        return ("alt", branches)

    def concat(self):
        parts = []
        while self.peek() is not None and self.peek() not in "|)":
            parts.append(self.repeat())
        if not parts:
            return ("empty",)
        if len(parts) == 1:
            return parts[0]
        return ("cat", parts)

    def repeat(self):
        node = self.atom()
        while True:
            c = self.peek()
            if c == "*":
                self.take()
                node = ("star", node)
            elif c == "+":
                self.take()
                node = ("plus", node)
            elif c == "?":
                self.take()
                node = ("opt", node)
            elif c == "{":
                save = self.pos
                counted = self._try_counted()
                if counted is None:
                    self.pos = save
                    break  # literal '{' handled by atom next time? no: treat as literal via atom already consumed; stop
                lo, hi = counted
                node = self._expand_counted(node, lo, hi)
            else:
                break
        return node

    def _try_counted(self) -> Optional[Tuple[int, Optional[int]]]:
        # at '{'; returns (lo, hi|None) or None if not a valid counted repeat
        assert self.take() == "{"
        digits = ""
        while self.peek() and self.peek().isdigit():
            digits += self.take()
        if not digits:
            return None
        lo = int(digits)
        hi: Optional[int] = lo
        if self.peek() == ",":
            self.take()
            digits2 = ""
            while self.peek() and self.peek().isdigit():
                digits2 += self.take()
            hi = int(digits2) if digits2 else None
        if self.peek() != "}":
            return None
        self.take()
        if hi is not None and hi < lo:
            raise RegexError("counted repeat with max < min")
        if lo > _MAX_REPEAT or (hi or 0) > _MAX_REPEAT:
            raise RegexError(f"counted repeat larger than {_MAX_REPEAT}")
        return lo, hi

    def _expand_counted(self, node, lo: int, hi: Optional[int]):
        parts = [node] * lo
        if hi is None:
            parts.append(("star", node))
        else:
            parts.extend(("opt", node) for _ in range(hi - lo))
        if not parts:
            return ("empty",)
        if len(parts) == 1:
            return parts[0]
        return ("cat", parts)

    def atom(self):
        c = self.take()
        if c == "(":
            if self.peek() == "?":
                self.take()
                nxt = self.peek()
                if nxt == ":":
                    self.take()
                elif nxt == "P" or nxt == "<":
                    # named group (?P<name>...) / (?<name>...): the name has
                    # no matching semantics -- parse and drop it (parity with
                    # the regex crate, which accepts both spellings)
                    if nxt == "P":
                        self.take()
                        if self.peek() != "<":
                            raise RegexError(
                                "unsupported group flags (?P"
                                f"{self.peek()!r}"
                            )
                    self.take()  # '<'
                    while self.peek() is not None and self.peek() != ">":
                        self.take()
                    if self.take() != ">":
                        raise RegexError("unterminated group name")
                elif nxt == "i":
                    # inline (?i) flag group: apply globally (good enough for
                    # the flat patterns this tool sees)
                    self.take()
                    if self.peek() == ")":
                        self.take()
                        self.ignore_case = True
                        return ("empty",)
                    if self.peek() == ":":
                        self.take()
                        self.ignore_case = True
                else:
                    raise RegexError(
                        f"unsupported group flags (?{nxt}: only (?:...), "
                        "(?i), (?i:...), and named groups are supported"
                    )
            node = self.alternation()
            if self.peek() != ")":
                raise RegexError("unbalanced parenthesis")
            self.take()
            return node
        if c == ")":
            raise RegexError("unbalanced parenthesis")
        if c == "[":
            return ("sym", self.char_class())
        if c == ".":
            return ("sym", frozenset(range(256)) - {10, 13})
        if c == "^":
            return ("sym", frozenset([BOT]))
        if c == "$":
            return ("sym", frozenset([EOS]))
        if c == "\\":
            return ("sym", self.escape_class())
        if self.events is not None:
            self.events.append(("lit", c))
        return ("sym", self._literal(c))

    def _literal(self, c: str) -> FrozenSet[int]:
        b = ord(c)
        if b > 255:
            raise RegexError("non-ASCII literal in pattern")
        if self.ignore_case and c.isalpha():
            return frozenset({ord(c.lower()), ord(c.upper())})
        return frozenset({b})

    def escape_class(self, raw: bool = False) -> FrozenSet[int]:
        """raw=True: no case folding (char_class folds after range
        expansion, so escaped range endpoints stay single bytes)."""
        if self.peek() is None:
            raise RegexError("dangling escape")
        c = self.take()
        digits = frozenset(range(ord("0"), ord("9") + 1))
        word = frozenset(
            list(range(ord("a"), ord("z") + 1))
            + list(range(ord("A"), ord("Z") + 1))
            + list(range(ord("0"), ord("9") + 1))
            + [ord("_")]
        )
        space = frozenset(map(ord, " \t\n\r\f\v"))
        table = {
            "d": digits,
            "D": frozenset(range(256)) - digits,
            "w": word,
            "W": frozenset(range(256)) - word,
            "s": space,
            "S": frozenset(range(256)) - space,
            "n": frozenset([10]),
            "t": frozenset([9]),
            "r": frozenset([13]),
        }
        if c in table:
            return table[c]
        if c == "x":
            # \xHH hex escape (regex-crate surface, VERDICT r1 item 9)
            h = ""
            if self.peek() == "{":  # \x{HH..} form
                self.take()
                while self.peek() is not None and self.peek() != "}":
                    h += self.take()
                if self.take() != "}":
                    raise RegexError("unterminated \\x{...} escape")
            else:
                for _ in range(2):
                    if self.peek() is None:
                        raise RegexError("truncated \\x escape")
                    h += self.take()
            try:
                b = int(h, 16)
            except ValueError:
                raise RegexError(f"invalid hex escape \\x{h}")
            if b > 255:
                raise RegexError("non-ASCII \\x escape in pattern")
            if not raw and self.ignore_case and chr(b).isalpha():
                return frozenset({ord(chr(b).lower()), ord(chr(b).upper())})
            return frozenset({b})
        if raw:
            if ord(c) > 255:
                raise RegexError("non-ASCII literal in pattern")
            return frozenset({ord(c)})
        return self._literal(c)

    def char_class(self) -> FrozenSet[int]:
        # after '['
        negated = False
        if self.peek() == "^":
            self.take()
            negated = True
        members: Set[int] = set()
        ordered: List[int] = []  # first-appearance order, for analyses

        def addm(v: int) -> None:
            if v not in members:
                members.add(v)
                ordered.append(v)

        first = True
        while True:
            c = self.peek()
            if c is None:
                raise RegexError("unterminated character class")
            if c == "]" and not first:
                self.take()
                break
            first = False
            if c == "\\":
                self.take()
                esc = self.escape_class(raw=True)
                if (
                    len(esc) == 1
                    and self.peek() == "-"
                    and self.pos + 1 < len(self.src)
                    and self.src[self.pos + 1] not in ("]",)
                ):
                    # escaped left range endpoint: [\x41-\x43]
                    lo = next(iter(esc))
                    self.take()  # '-'
                    hi_c = self.take()
                    if hi_c == "\\":
                        esc2 = self.escape_class(raw=True)
                        if len(esc2) != 1:
                            raise RegexError("invalid range endpoint")
                        hi = next(iter(esc2))
                    else:
                        hi = ord(hi_c)
                    if hi < lo:
                        raise RegexError("invalid class range")
                    for v in range(lo, hi + 1):
                        addm(v)
                    if self.ignore_case:
                        for v in range(lo, hi + 1):
                            ch = chr(v)
                            if ch.isalpha():
                                addm(ord(ch.swapcase()))
                    continue
                for v in sorted(esc):
                    addm(v)
                if self.ignore_case:
                    for v in sorted(esc):
                        ch = chr(v)
                        if v < 128 and ch.isalpha():
                            addm(ord(ch.swapcase()))
                continue
            if (
                c == "["
                and self.pos + 1 < len(self.src)
                and self.src[self.pos + 1] == ":"
            ):
                for v in sorted(self._posix_class()):
                    addm(v)
                continue
            self.take()
            lo = ord(c)
            if lo > 255:
                raise RegexError("non-ASCII in class")
            if self.peek() == "-" and self.pos + 1 < len(self.src) and self.src[
                self.pos + 1
            ] not in ("]",):
                self.take()  # '-'
                hi_c = self.take()
                if hi_c == "\\":
                    esc = self.escape_class(raw=True)
                    if len(esc) != 1:
                        raise RegexError("invalid range endpoint")
                    hi = next(iter(esc))
                else:
                    hi = ord(hi_c)
                if hi < lo:
                    raise RegexError("invalid class range")
                for v in range(lo, hi + 1):
                    addm(v)
                if self.ignore_case:
                    for v in range(lo, hi + 1):
                        ch = chr(v)
                        if ch.isalpha():
                            addm(ord(ch.swapcase()))
            else:
                addm(lo)
                if self.ignore_case and c.isalpha():
                    addm(ord(c.swapcase()))
        if self.events is not None:
            self.events.append(
                ("class", negated, [chr(v) for v in ordered])
            )
        if negated:
            return frozenset(range(256)) - frozenset(members)
        return frozenset(members)

    _POSIX = {
        "alpha": set(range(65, 91)) | set(range(97, 123)),
        "digit": set(range(48, 58)),
        "alnum": set(range(48, 58)) | set(range(65, 91))
        | set(range(97, 123)),
        "upper": set(range(65, 91)),
        "lower": set(range(97, 123)),
        "xdigit": set(range(48, 58)) | set(range(65, 71))
        | set(range(97, 103)),
        "space": set(map(ord, " \t\n\r\f\v")),
        "punct": {v for v in range(33, 127) if not chr(v).isalnum()},
        "word": set(range(48, 58)) | set(range(65, 91))
        | set(range(97, 123)) | {95},
        "blank": {32, 9},
        "cntrl": set(range(0, 32)) | {127},
        "graph": set(range(33, 127)),
        "print": set(range(32, 127)),
    }

    def _posix_class(self) -> FrozenSet[int]:
        """[[:name:]] POSIX class inside a character class (regex-crate
        surface).  Called at '[' with ':' lookahead-confirmed."""
        self.take()  # '['
        self.take()  # ':'
        negated = False
        if self.peek() == "^":
            self.take()
            negated = True
        name = ""
        while self.peek() is not None and self.peek() != ":":
            name += self.take()
        if self.take() != ":" or self.take() != "]":
            raise RegexError("unterminated POSIX class")
        if name not in self._POSIX:
            raise RegexError(f"unknown POSIX class [:{name}:]")
        members = self._POSIX[name]
        if negated:
            return frozenset(range(256)) - frozenset(members)
        return frozenset(members)


def parse_literal_events(pattern: str) -> List[tuple]:
    """Parse ``pattern`` (case-sensitive) and return its literal/class event
    stream: ("lit", char) per unescaped literal atom, ("class", negated,
    [member chars in first-appearance order]) per character class.

    The single parsing source for pattern.Pattern's charset validation and
    difficulty estimate -- case folding is applied by the caller so literal
    atoms stay single characters."""
    events: List[tuple] = []
    _Parser(pattern, False, events).parse()
    return events


# ---------------------------------------------------------------------------
# Thompson NFA
# ---------------------------------------------------------------------------


@dataclass
class _NFA:
    # transitions: list per state of (symbol_set, target)
    edges: List[List[Tuple[FrozenSet[int], int]]] = field(default_factory=list)
    eps: List[List[int]] = field(default_factory=list)

    def new_state(self) -> int:
        self.edges.append([])
        self.eps.append([])
        return len(self.edges) - 1

    def add_edge(self, src: int, syms: FrozenSet[int], dst: int) -> None:
        self.edges[src].append((syms, dst))

    def add_eps(self, src: int, dst: int) -> None:
        self.eps[src].append(dst)


def _build_nfa(node, nfa: _NFA) -> Tuple[int, int]:
    kind = node[0]
    if kind == "empty":
        s = nfa.new_state()
        return s, s
    if kind == "sym":
        s, t = nfa.new_state(), nfa.new_state()
        nfa.add_edge(s, node[1], t)
        return s, t
    if kind == "cat":
        first_s, prev_t = _build_nfa(node[1][0], nfa)
        for sub in node[1][1:]:
            s, t = _build_nfa(sub, nfa)
            nfa.add_eps(prev_t, s)
            prev_t = t
        return first_s, prev_t
    if kind == "alt":
        s, t = nfa.new_state(), nfa.new_state()
        for sub in node[1]:
            bs, bt = _build_nfa(sub, nfa)
            nfa.add_eps(s, bs)
            nfa.add_eps(bt, t)
        return s, t
    if kind == "star":
        s, t = nfa.new_state(), nfa.new_state()
        bs, bt = _build_nfa(node[1], nfa)
        nfa.add_eps(s, bs)
        nfa.add_eps(s, t)
        nfa.add_eps(bt, bs)
        nfa.add_eps(bt, t)
        return s, t
    if kind == "plus":
        bs, bt = _build_nfa(node[1], nfa)
        t = nfa.new_state()
        nfa.add_eps(bt, bs)
        nfa.add_eps(bt, t)
        return bs, t
    if kind == "opt":
        s, t = nfa.new_state(), nfa.new_state()
        bs, bt = _build_nfa(node[1], nfa)
        nfa.add_eps(s, bs)
        nfa.add_eps(bt, t)
        nfa.add_eps(s, t)
        return s, t
    raise AssertionError(kind)


def _eps_closure(nfa: _NFA, states: Set[int]) -> FrozenSet[int]:
    stack = list(states)
    seen = set(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


# ---------------------------------------------------------------------------
# DFA
# ---------------------------------------------------------------------------


@dataclass
class DFA:
    """Dense DFA over the 258-symbol alphabet (bytes + BOT + EOS).

    table[state, cls] -> state, where cls = classes[symbol].
    State 0 is DEAD (all-self-loop non-accepting); ACCEPT states are sinks.
    ``start`` is the state *before* consuming BOT.
    """

    table: np.ndarray  # [n_states, n_classes] int32
    accept: np.ndarray  # [n_states] bool
    classes: np.ndarray  # [N_SYMBOLS] int32 symbol -> class
    start: int

    @property
    def n_states(self) -> int:
        return self.table.shape[0]

    def run_symbols(self, syms, state: Optional[int] = None) -> int:
        s = self.start if state is None else state
        for sym in syms:
            s = int(self.table[s, self.classes[sym]])
        return s

    def matches_text(self, text: str) -> bool:
        data = text.encode("utf-8", errors="replace")
        if any(b > 255 for b in data):  # pragma: no cover - bytes cap at 255
            return False
        s = self.run_symbols([BOT] + list(data) + [EOS])
        return bool(self.accept[s])


def compile_dfa(pattern: str, ignore_case: bool = False) -> DFA:
    if pattern == "":
        raise RegexError("Pattern cannot be empty")
    parser = _Parser(pattern, ignore_case)
    ast = parser.parse()

    nfa = _NFA()
    start, end = _build_nfa(ast, nfa)

    # Unanchored search: self-loop on the start state over every symbol.
    # (The '^' anchor, when present, is an explicit BOT edge inside the AST;
    # the self-loop still allows a later-starting match, matching is_match.)
    all_syms = frozenset(range(N_SYMBOLS))
    nfa.add_edge(start, all_syms, start)

    accept_nfa = end

    # symbol equivalence classes from the distinct edge label sets
    label_sets = sorted(
        {syms for st in nfa.edges for (syms, _) in st},
        key=lambda s: (len(s), sorted(s)[:4] if s else []),
    )
    signature = np.zeros(N_SYMBOLS, dtype=np.int64)
    for i, syms in enumerate(label_sets):
        arr = np.zeros(N_SYMBOLS, dtype=bool)
        arr[list(syms)] = True
        signature = signature * 2 + arr  # may overflow for >62 sets; use tuple
    if len(label_sets) > 60:
        sig_cols = []
        for syms in label_sets:
            arr = np.zeros(N_SYMBOLS, dtype=np.int8)
            arr[list(syms)] = 1
            sig_cols.append(arr)
        sig_matrix = np.stack(sig_cols, axis=1)
        _, classes = np.unique(sig_matrix, axis=0, return_inverse=True)
    else:
        _, classes = np.unique(signature, return_inverse=True)
    n_classes = int(classes.max()) + 1
    classes = classes.astype(np.int32)

    # representative symbol per class
    reps = np.zeros(n_classes, dtype=np.int32)
    for cls in range(n_classes):
        reps[cls] = int(np.argmax(classes == cls))

    # subset construction
    start_set = _eps_closure(nfa, {start})
    subsets: Dict[FrozenSet[int], int] = {}
    rows: List[List[int]] = []
    accept_rows: List[bool] = []

    DEAD = 0
    ACCEPT = 1
    # pre-seed DEAD and ACCEPT sinks
    rows.append([DEAD] * n_classes)
    accept_rows.append(False)
    rows.append([ACCEPT] * n_classes)
    accept_rows.append(True)

    def intern(subset: FrozenSet[int]) -> int:
        if accept_nfa in subset:
            return ACCEPT  # sticky accept: is_match semantics
        if not subset:
            return DEAD
        if subset in subsets:
            return subsets[subset]
        idx = len(rows)
        subsets[subset] = idx
        rows.append([DEAD] * n_classes)
        accept_rows.append(False)
        work.append((subset, idx))
        return idx

    work: List[Tuple[FrozenSet[int], int]] = []
    start_idx = intern(start_set)
    while work:
        subset, idx = work.pop()
        for cls in range(n_classes):
            sym = int(reps[cls])
            nxt: Set[int] = set()
            for s in subset:
                for syms, dst in nfa.edges[s]:
                    if sym in syms:
                        nxt.add(dst)
            rows[idx][cls] = intern(_eps_closure(nfa, nxt))

    table = np.array(rows, dtype=np.int32)
    accept = np.array(accept_rows, dtype=bool)
    return DFA(table=table, accept=accept, classes=classes, start=start_idx)
