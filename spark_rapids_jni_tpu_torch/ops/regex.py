"""Regular expressions over STRING columns (port of ``ops/regex.py``):
a DFA compiled on the host, run on the device as one table gather a
byte.

  host:   pattern -> Thompson NFA -> byte equivalence classes -> dense
          (states x classes) DFA transition table (numpy, cached)
  device: a loop over the pad columns of the (n, pad) byte matrix; each
          step is one gather into the transition table for every row.

The span ops (``find_re``, ``extract_re``, ``replace_re``, ``count_re``)
run one DFA a start offset: their state is an (n, pad) matrix and each
step advances every start at once, giving the leftmost-longest span
table in ``pad`` steps.

Supported syntax (byte-level, the JAX package's subset): literals, ``.``,
escapes (``\\n \\t \\r \\f \\v \\xHH`` and escaped specials), ``[...]``
classes with ranges and negation, ``\\d \\D \\w \\W \\s \\S``,
alternation, groups ``(...)`` / ``(?:...)``, quantifiers ``* + ? {m}
{m,} {m,n}``, and ``^`` / ``$`` at the pattern ends. Matches are
leftmost-longest (POSIX). ``replace_re`` sizes its output on the host
(one sync), as the JAX package's eager call does.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import dtype as dt
from ..column import Column
from .strings import _require_string, _shift_left, const, row_cumsum

_MAX_DFA_STATES = 1024
_MAX_COUNTED_REPEAT = 64


class UnsupportedPatternError(ValueError):
    """Pattern outside the engine's documented subset (or beyond its
    DFA-size budget). Typed so a Spark layer can catch it and fall back
    to CPU evaluation instead of failing the query — the posture cudf
    takes for its unsupported regex corners. Subclasses ValueError so
    existing raise-on-unsupported callers keep working."""

_DIGIT = frozenset(range(ord("0"), ord("9") + 1))
_WORD = frozenset(
    set(_DIGIT)
    | set(range(ord("a"), ord("z") + 1))
    | set(range(ord("A"), ord("Z") + 1))
    | {ord("_")}
)
_SPACE = frozenset(b" \t\n\r\f\v")
_ALL = frozenset(range(256))
_DOT = _ALL - {ord("\n")}
_SPECIALS = set("\\^$.|?*+()[]{}")


# ---------------------------------------------------------------------------
# AST: ('lit', charset) | ('cat', [nodes]) | ('alt', [nodes])
#      ('star'|'plus'|'opt', node) | ('group', node, index)
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.ngroups = 0

    def _peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def _take(self):
        c = self.p[self.i]
        self.i += 1
        return c

    def _error(self, msg):
        raise UnsupportedPatternError(
            f"regex: {msg} at position {self.i} in {self.p!r}"
        )

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            self._error(f"unexpected {self._peek()!r}")
        return node

    def _alt(self):
        branches = [self._cat()]
        while self._peek() == "|":
            self._take()
            branches.append(self._cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _cat(self):
        items = []
        while self._peek() not in (None, "|", ")"):
            items.append(self._repeat())
        if len(items) == 1:
            return items[0]
        return ("cat", items)

    def _repeat(self):
        node = self._atom()
        while True:
            c = self._peek()
            if c == "*":
                self._take()
                node = ("star", node)
            elif c == "+":
                self._take()
                node = ("plus", node)
            elif c == "?":
                self._take()
                node = ("opt", node)
            elif c == "{":
                node = self._counted(node)
            else:
                return node

    def _counted(self, node):
        self._take()  # '{'
        spec = ""
        while self._peek() not in (None, "}"):
            spec += self._take()
        if self._peek() != "}":
            self._error("unterminated {m,n}")
        self._take()
        parts = spec.split(",")
        try:
            lo = int(parts[0])
            if len(parts) == 1:
                hi = lo
            elif parts[1] == "":
                hi = None
            else:
                hi = int(parts[1])
        except ValueError:
            self._error(f"bad counted repeat {{{spec}}}")
        if hi is not None and (hi < lo or hi > _MAX_COUNTED_REPEAT):
            self._error(f"counted repeat bound must be <= {_MAX_COUNTED_REPEAT}")
        if lo > _MAX_COUNTED_REPEAT:
            self._error(f"counted repeat bound must be <= {_MAX_COUNTED_REPEAT}")
        items = [node] * lo
        if hi is None:
            items.append(("star", node))
        else:
            items.extend([("opt", node)] * (hi - lo))
        return ("cat", items)

    def _atom(self):
        c = self._peek()
        if c is None:
            self._error("expected atom")
        if c == "(":
            self._take()
            capturing = True
            if self.p[self.i : self.i + 2] == "?:":
                self.i += 2
                capturing = False
            inner = self._alt()
            if self._peek() != ")":
                self._error("unterminated group")
            self._take()
            if capturing:
                self.ngroups += 1
                return ("group", inner, self.ngroups)
            return inner
        if c == "[":
            return ("lit", self._char_class())
        if c == ".":
            self._take()
            return ("lit", _DOT)
        if c == "\\":
            return ("lit", self._escape())
        if c in "^$":
            self._error(f"anchor {c!r} only supported at the pattern ends")
        if c in "*+?{":
            self._error(f"quantifier {c!r} with nothing to repeat")
        self._take()
        return ("lit", frozenset({ord(c)}))

    def _escape(self) -> frozenset:
        self._take()  # backslash
        c = self._peek()
        if c is None:
            self._error("trailing backslash")
        self._take()
        simple = {"n": 10, "t": 9, "r": 13, "f": 12, "v": 11, "0": 0}
        if c in simple:
            return frozenset({simple[c]})
        if c == "x":
            hh = self.p[self.i : self.i + 2]
            if len(hh) != 2:
                self._error("bad \\xHH escape")
            self.i += 2
            return frozenset({int(hh, 16)})
        classes = {
            "d": _DIGIT, "D": _ALL - _DIGIT,
            "w": _WORD, "W": _ALL - _WORD,
            "s": _SPACE, "S": _ALL - _SPACE,
        }
        if c in classes:
            return classes[c]
        if c in _SPECIALS or not c.isalnum():
            return frozenset({ord(c)})
        self._error(f"unsupported escape \\{c}")

    def _char_class(self) -> frozenset:
        self._take()  # '['
        negate = False
        if self._peek() == "^":
            negate = True
            self._take()
        members: set = set()
        while True:
            c = self._peek()
            if c is None:
                self._error("unterminated character class")
            if c == "]":
                self._take()
                break
            if c == "\\":
                sub = self._escape()
                if len(sub) > 1:  # \d etc. — no range allowed off it
                    members |= sub
                    continue
                lo = next(iter(sub))
            else:
                self._take()
                lo = ord(c)
            if self._peek() == "-" and self.p[self.i + 1 : self.i + 2] not in (
                "", "]",
            ):
                self._take()  # '-'
                c2 = self._take()
                if c2 == "\\":
                    self.i -= 1
                    sub2 = self._escape()
                    if len(sub2) > 1:
                        self._error("bad range endpoint")
                    hi = next(iter(sub2))
                else:
                    hi = ord(c2)
                if hi < lo:
                    self._error("reversed character-class range")
                members |= set(range(lo, hi + 1))
            else:
                members.add(lo)
        return frozenset(_ALL - members if negate else members)


def _split_top_level(pattern: str) -> list[str]:
    """Split on ``|`` at nesting depth 0 (host-side, respecting escapes,
    groups and character classes) — how Java scopes anchors: in
    ``^a|b`` the ``^`` binds only the first branch."""
    branches = []
    depth = 0
    in_class = False
    cur = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            cur.append(pattern[i : i + 2])
            i += 2
            continue
        if in_class:
            if c == "]":
                in_class = False
        elif c == "[":
            in_class = True
        elif c == "(":
            depth += 1
        elif c == ")":
            depth = max(0, depth - 1)
        elif c == "|" and depth == 0:
            branches.append("".join(cur))
            cur = []
            i += 1
            continue
        cur.append(c)
        i += 1
    branches.append("".join(cur))
    return branches


def _branch_anchored(branch: str) -> bool:
    if branch.startswith("^"):
        return True
    if branch.endswith("$"):
        nbs = len(branch[:-1]) - len(branch[:-1].rstrip("\\"))
        return nbs % 2 == 0
    return False


def _strip_anchors(pattern: str):
    """Peel ``^``/``$`` off the pattern ends (the only positions the
    subset supports; elsewhere the parser errors out)."""
    anchored_start = pattern.startswith("^")
    if anchored_start:
        pattern = pattern[1:]
    # '$' anchors only when not escaped: count trailing backslashes
    anchored_end = False
    if pattern.endswith("$"):
        nbs = len(pattern[:-1]) - len(pattern[:-1].rstrip("\\"))
        if nbs % 2 == 0:
            anchored_end = True
            pattern = pattern[:-1]
    return pattern, anchored_start, anchored_end


# ---------------------------------------------------------------------------
# Thompson NFA + subset construction over byte equivalence classes
# ---------------------------------------------------------------------------


class _NFA:
    def __init__(self):
        self.nstates = 0
        self.eps: list[set] = []
        self.trans: list[tuple[int, frozenset, int]] = []

    def state(self) -> int:
        self.eps.append(set())
        self.nstates += 1
        return self.nstates - 1

    def add(self, src, charset, dst):
        self.trans.append((src, charset, dst))

    def compile(self, node) -> tuple[int, int]:
        """Thompson fragment: returns (start, accept)."""
        kind = node[0]
        if kind == "lit":
            s, a = self.state(), self.state()
            self.add(s, node[1], a)
            return s, a
        if kind == "cat":
            if not node[1]:
                s = self.state()
                return s, s
            frags = [self.compile(ch) for ch in node[1]]
            for (_, a), (s2, _) in zip(frags, frags[1:]):
                self.eps[a].add(s2)
            return frags[0][0], frags[-1][1]
        if kind == "alt":
            s, a = self.state(), self.state()
            for branch in node[1]:
                bs, ba = self.compile(branch)
                self.eps[s].add(bs)
                self.eps[ba].add(a)
            return s, a
        if kind == "star":
            s, a = self.state(), self.state()
            bs, ba = self.compile(node[1])
            self.eps[s] |= {bs, a}
            self.eps[ba] |= {bs, a}
            return s, a
        if kind == "plus":
            bs, ba = self.compile(node[1])
            s, a = self.state(), self.state()
            self.eps[s].add(bs)
            self.eps[ba] |= {bs, a}
            return s, a
        if kind == "opt":
            s, a = self.state(), self.state()
            bs, ba = self.compile(node[1])
            self.eps[s] |= {bs, a}
            self.eps[ba].add(a)
            return s, a
        if kind == "group":
            return self.compile(node[1])
        raise AssertionError(f"unknown AST node {kind}")

    def closure(self, states: frozenset) -> frozenset:
        out = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for t in self.eps[s]:
                if t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)


@dataclasses.dataclass(frozen=True)
class CompiledRegex:
    """Dense DFA tables (host numpy; copied to the column's device per call)."""

    class_map: np.ndarray  # (256,) int32: byte -> equivalence class
    trans: np.ndarray      # (S, C) int32: state × class -> state
    accepting: np.ndarray  # (S,) bool
    anchored_start: bool
    anchored_end: bool
    # capture-group geometry for extract (None when not applicable)
    prefix_len: int | None = None
    suffix_len: int | None = None

    @property
    def num_classes(self) -> int:
        return self.trans.shape[1]


def _byte_classes(nfa: _NFA) -> np.ndarray:
    """Partition bytes by the set of NFA edges they can drive — the DFA
    only needs one column per class, keeping the table small."""
    sig = {}
    class_map = np.zeros(256, dtype=np.int32)
    for b in range(256):
        key = frozenset(
            i for i, (_, cs, _) in enumerate(nfa.trans) if b in cs
        )
        if key not in sig:
            sig[key] = len(sig)
        class_map[b] = sig[key]
    return class_map


def _determinize(nfa: _NFA, start: int, accept: int, class_map) -> tuple:
    nclasses = int(class_map.max()) + 1
    rep_byte = [int(np.argmax(class_map == c)) for c in range(nclasses)]
    start_set = nfa.closure(frozenset({start}))
    ids = {start_set: 0}
    rows = []
    work = [start_set]
    while work:
        cur = work.pop(0)
        row = []
        for c in range(nclasses):
            b = rep_byte[c]
            moved = frozenset(
                d for (s, cs, d) in nfa.trans if s in cur and b in cs
            )
            nxt = nfa.closure(moved) if moved else frozenset()
            if nxt not in ids:
                if len(ids) >= _MAX_DFA_STATES:
                    raise UnsupportedPatternError(
                        f"regex too complex: DFA exceeds {_MAX_DFA_STATES} states"
                    )
                ids[nxt] = len(ids)
                work.append(nxt)
            row.append(ids[nxt])
        rows.append(row)
    trans = np.asarray(rows, dtype=np.int32)
    accepting = np.zeros(len(ids), dtype=bool)
    for sset, i in ids.items():
        accepting[i] = accept in sset
    return trans, accepting


def _node_len_range(node) -> tuple[int, float]:
    kind = node[0]
    if kind == "lit":
        return 1, 1
    if kind == "cat":
        lo = hi = 0
        for ch in node[1]:
            l, h = _node_len_range(ch)
            lo, hi = lo + l, hi + h
        return lo, hi
    if kind == "alt":
        ranges = [_node_len_range(b) for b in node[1]]
        return min(r[0] for r in ranges), max(r[1] for r in ranges)
    if kind == "star":
        return 0, float("inf")
    if kind == "plus":
        return _node_len_range(node[1])[0], float("inf")
    if kind == "opt":
        return 0, _node_len_range(node[1])[1]
    if kind == "group":
        return _node_len_range(node[1])
    raise AssertionError(kind)


def _group_geometry(node):
    """For extract: the pattern must be a concatenation containing exactly
    one capture group, with fixed-length prefix and suffix around it (the
    shape of practical ``regexp_extract`` patterns like ``id=(\\d+)``).
    Returns (prefix_len, suffix_len) or raises."""
    items = node[1] if node[0] == "cat" else [node]
    gidx = [i for i, it in enumerate(items) if it[0] == "group"]
    if len(gidx) != 1:
        raise UnsupportedPatternError(
            "extract_re: pattern must contain exactly one capture group"
        )
    g = gidx[0]
    pre_lo, pre_hi = _node_len_range(("cat", items[:g]))
    suf_lo, suf_hi = _node_len_range(("cat", items[g + 1 :]))
    if pre_lo != pre_hi or suf_lo != suf_hi:
        raise UnsupportedPatternError(
            "extract_re: text before/after the capture group must have a "
            "fixed match length (use {m} instead of open quantifiers there)"
        )
    return int(pre_lo), int(suf_lo)


@functools.lru_cache(maxsize=256)
def compile_re(
    pattern: str, *, search_prefix: bool = False, with_group: bool = False
) -> CompiledRegex:
    """Compile to DFA tables. ``search_prefix`` prepends an implicit
    ``.*`` (any byte, including newline) for find-anywhere semantics;
    ``with_group`` additionally computes extract geometry."""
    body, anch_s, anch_e = _strip_anchors(pattern)
    parser = _Parser(body)
    ast = parser.parse()
    if (anch_s or anch_e) and ast[0] == "alt":
        # '^a|b' must NOT become '^(a|b)': Java/Spark scope anchors to
        # one branch. contains_re/matches_re split branches
        # before reaching here; span ops (extract/replace) surface the
        # typed error instead of silently changing match semantics.
        raise UnsupportedPatternError(
            "anchor over a top-level alternation: in Java the anchor "
            "binds one branch, which the single-DFA span engine cannot "
            "express — split the pattern into per-branch calls"
        )
    pre = suf = None
    if with_group:
        pre, suf = _group_geometry(ast)
    if search_prefix and not anch_s:
        ast = ("cat", [("star", ("lit", _ALL)), ast])
    nfa = _NFA()
    start, accept = nfa.compile(ast)
    class_map = _byte_classes(nfa)
    trans, accepting = _determinize(nfa, start, accept, class_map)
    return CompiledRegex(
        class_map=class_map,
        trans=trans,
        accepting=accepting,
        anchored_start=anch_s,
        anchored_end=anch_e,
        prefix_len=pre,
        suffix_len=suf,
    )



# ---------------------------------------------------------------------------
# Device execution
# ---------------------------------------------------------------------------


def _dfa_tables(rx: CompiledRegex, device):
    """(class map, flat transitions, accepting, classes) on ``device``,
    copied there once a compiled pattern."""
    return (const(tuple(rx.class_map.tolist()), torch.int64, device),
            const(tuple(rx.trans.reshape(-1).tolist()), torch.int64, device),
            const(tuple(rx.accepting.tolist()), torch.bool, device),
            rx.trans.shape[1])


def _or_branches(col: Column, pattern: str, fn):
    """``fn`` over each top-level branch, OR-ed."""
    out = None
    for b in _split_top_level(pattern):
        nxt = fn(col, b).data
        out = nxt if out is None else out | nxt
    return Column(out, dt.BOOL8, col.validity)


def contains_re(col: Column, pattern: str) -> Column:
    """True where the pattern matches anywhere in the string: Spark
    ``rlike``. One DFA state a row, ``pad`` steps of one gather each.
    Anchored top-level alternations (``^a|b``) run one DFA a branch and
    OR them: the anchor binds its own branch, as in Java."""
    _require_string(col)
    branches = _split_top_level(pattern)
    if len(branches) > 1 and any(_branch_anchored(b) for b in branches):
        return _or_branches(col, pattern, contains_re)
    rx = compile_re(pattern, search_prefix=True)
    cmap, tflat, acc, C = _dfa_tables(rx, col.data.device)
    n, pad = col.data.shape
    lens = col.lengths
    cls = cmap[col.data.T.to(torch.int64)].contiguous()  # (pad, n) classes
    state = torch.zeros(n, dtype=torch.int64, device=col.data.device)
    found = acc[0].expand(n).clone()
    for j in range(pad):
        live = j < lens
        state = torch.where(live, tflat[state * C + cls[j]], state)
        found = found | (acc[state] & live)
    if rx.anchored_end:
        # the match must end at the string end: only the final state
        found = acc[state]
    return Column(found, dt.BOOL8, col.validity)


def matches_re(col: Column, pattern: str) -> Column:
    """Full-string match (Java ``String.matches``); a top-level
    alternation matches when any branch does."""
    _require_string(col)
    if len(_split_top_level(pattern)) > 1:
        return _or_branches(col, pattern, matches_re)
    body, _, _ = _strip_anchors(pattern)
    return contains_re(col, "^" + body + "$")


def rlike(col: Column, pattern: str) -> Column:
    """Spark SQL ``rlike``: :func:`contains_re`."""
    return contains_re(col, pattern)


def _span_table(col: Column, rx: CompiledRegex) -> torch.Tensor:
    """best[i, s]: the largest e with a match over bytes [s, e) of row i
    (the leftmost-longest span table), or -1."""
    dev = col.data.device
    cmap, tflat, acc, C = _dfa_tables(rx, dev)
    n, pad = col.data.shape
    lens = col.lengths[:, None]
    starts = torch.arange(pad, dtype=torch.int32, device=dev)[None, :]
    empty_ok = acc[0] & (starts <= lens)
    if rx.anchored_end:
        empty_ok = empty_ok & (starts == lens)
    best = torch.where(empty_ok, starts, -1)
    cls = cmap[col.data.to(torch.int64)]
    states = torch.zeros((n, pad), dtype=torch.int64, device=dev)
    for j in range(pad):
        live = (starts <= j) & (j < lens)
        states = torch.where(live, tflat[states * C + cls[:, j:j + 1]], states)
        hit = live & acc[states]
        if rx.anchored_end:
            hit = hit & (lens == j + 1)
        best = torch.where(hit, j + 1, best)
    if rx.anchored_start:
        best = torch.where(starts == 0, best, -1)
    return best.to(torch.int32)


def _first_start(best: torch.Tensor):
    """(has a match, leftmost start) of each row."""
    m = best >= 0
    return m.any(dim=1), m.to(torch.uint8).argmax(dim=1)


def find_re(col: Column, pattern: str) -> Column:
    """Byte offset of the leftmost match, -1 when there is none."""
    _require_string(col)
    has, pos = _first_start(_span_table(col, compile_re(pattern)))
    return Column(torch.where(has, pos, -1).to(torch.int32), dt.INT32,
                  col.validity)


def extract_re(col: Column, pattern: str) -> Column:
    """The single capture group at the leftmost-longest match (Spark
    ``regexp_extract(s, p, 1)``); rows without a match are null. The
    group sits between fixed-length prefix and suffix patterns."""
    _require_string(col)
    rx = compile_re(pattern, with_group=True)
    best = _span_table(col, rx)
    has, s_star = _first_start(best)
    e_star = torch.gather(best, 1, s_star[:, None])[:, 0]
    gs = s_star + rx.prefix_len
    glen = torch.where(has, (e_star - rx.suffix_len - gs).clamp(min=0), 0)
    out = _shift_left(col, gs, glen)
    validity = has if col.validity is None else col.validity & has
    return Column(out.data, dt.STRING, validity, out.lengths)


def _select_spans(best: torch.Tensor):
    """The greedy leftmost non-overlapping matches: (is_start, in_match)
    (n, pad) masks; empty-width matches are skipped."""
    n, pad = best.shape
    cursor = torch.zeros(n, dtype=torch.int32, device=best.device)
    is_start, in_match = [], []
    for s in range(pad):
        can = (cursor <= s) & (best[:, s] > s)
        cursor = torch.where(can, best[:, s], cursor)
        is_start.append(can)
        in_match.append(cursor > s)
    return torch.stack(is_start, 1), torch.stack(in_match, 1)


def replace_re(col: Column, pattern: str, repl) -> Column:
    """Every non-overlapping leftmost-longest match replaced by the
    literal ``repl`` (Spark ``regexp_replace`` without backreferences);
    empty-width matches are skipped. The output pad width is the longest
    result, read on the host."""
    _require_string(col)
    if isinstance(repl, str):
        repl = repl.encode("utf-8", "surrogateescape")
    m = len(repl)
    n, pad = col.data.shape
    if n == 0:
        return col
    is_start, in_match = _select_spans(_span_table(col, compile_re(pattern)))
    dev = col.data.device
    j = torch.arange(pad, dtype=torch.int32, device=dev)[None, :]
    lens = col.lengths
    in_str = j < lens[:, None]
    copied = in_str & ~in_match
    starts_i = is_start.to(torch.int64)
    copied_i = copied.to(torch.int64)
    out_pos = (row_cumsum(copied) - copied_i
               + m * (row_cumsum(is_start) - starts_i))
    new_len = (lens - (in_match & in_str).sum(dim=1)
               + m * starts_i.sum(dim=1)).to(torch.int32)
    pad_out = max(int(new_len.max()), 1)
    out = torch.zeros((n, pad_out + 1), dtype=torch.uint8, device=dev)
    dump = pad_out  # the column past the end takes the unused writes
    rows = torch.arange(n, device=dev)[:, None].expand(n, pad)
    idx = torch.where(copied, out_pos.clamp(max=dump), dump)
    out[rows[copied], idx[copied]] = col.data[copied]
    for k in range(m):
        at = torch.where(is_start, (out_pos + k).clamp(max=dump), dump)
        out[rows[is_start], at[is_start]] = repl[k]
    data = out[:, :pad_out]
    data = torch.where(torch.arange(pad_out, device=dev)[None, :]
                       < new_len[:, None], data, 0).to(torch.uint8)
    return Column(data, dt.STRING, col.validity, new_len)


def count_re(col: Column, pattern: str) -> Column:
    """Non-overlapping matches a row (empty-width matches not counted)."""
    _require_string(col)
    is_start, _ = _select_spans(_span_table(col, compile_re(pattern)))
    return Column(is_start.sum(dim=1).to(torch.int32), dt.INT32,
                  col.validity)
