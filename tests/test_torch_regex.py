"""Regular expressions: the port's ``ops/regex.py`` against the JAX
package's on the CPU, and the ``rlike`` dispatch op through the wire.

The patterns are the JAX tests' (``tests/test_regex.py``). Tolerance 0:
the compiled DFA tables equal, and every op's data bytes, validity and
lengths equal on a fixed corpus plus numpy-seeded random strings, nulls
and non-ASCII bytes included. ``contains_re`` is also held to Python's
``re.search``, ``matches_re`` to ``re.fullmatch``.
"""

import json
import re

import numpy as np
import pytest

from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.ops import regex as jregex
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.column import Column
from spark_rapids_jni_tpu_torch.ops import regex

from test_torch_strings_cast import _same
from test_torch_strings_keys import string_wire

WORDS = [
    "", "a", "ab", "abc", "aabbb", "id=123", "id=", "x1y2z3",
    "hello world", "2024-01-31", "not-a-date", "foo.txt", "foo_txt",
    "  padded  ", "aaaa", "abab", "cabbage", "12.5", "-7", "+e",
    "tail123", "123head", "a|b", "[x]", "line\nbreak", "CAPS", "MiXeD",
    "Électron", None,
]


def _corpus():
    rng = np.random.default_rng(21)
    rand = ["".join(rng.choice(list("abc01 .-="), int(rng.integers(0, 12))))
            for _ in range(120)]
    return WORDS + rand


def _live(col, values) -> list:
    """The BOOL8 results of the non-null rows."""
    return [bool(g) for g, v in zip(col.data.tolist(), values)
            if v is not None]


def _pair(values):
    return JColumn.from_strings(values), Column.from_strings(values,
                                                              device="cpu")


CONTAINS = [r"abc", r"a+b", r"\d+", r"[a-c]{2}", r"a.c", r"(ab)+", r"a|0",
            r"^a", r"c$", r"^[a-z0-9]*$", r"\s", r"\.", r"[^a-z]", r"b{2,3}",
            r"-?\d+\.\d+", r"^a|b", r"b|^a", r"a$|b", r"^a|b$", r"a$|^b",
            r"z*", r"\xc3\x89", r"^(Books|Electronics|Music)$"]
MATCHES = [r"[a-z]+", r"\d{4}-\d{2}-\d{2}", r"a*", r"a.*c", r"(?:ab|ba)+",
           r"a|b", r"a+|b", r"^a|b", r"a|"]
FIND = [r"\d+", r"[bc]+", r"ab", r"^a+", r"c$", r"a.c"]
EXTRACT = [r"id=(\d+)", r"(\d+)", r"^(\w+)\.txt$", r"-(\d{2})-"]
REPLACE = [(r"\d+", "#"), (r"[aeiou]", ""), (r"ab", "xyz"), (r"\s+", "_"),
           (r"a.c", "QQ"), (r"[ab]+", "<>")]
COUNT = [r"\d+", r"a", r"[bc]{2}", r"ab"]


@pytest.mark.parametrize("pattern", sorted(set(CONTAINS + MATCHES + FIND)))
def test_compiled_tables_match_jax(pattern):
    for kw in ({}, {"search_prefix": True}):
        try:
            want = jregex.compile_re(pattern, **kw)
        except jregex.UnsupportedPatternError as e:
            with pytest.raises(regex.UnsupportedPatternError,
                               match=re.escape(str(e))):
                regex.compile_re(pattern, **kw)
            continue
        got = regex.compile_re(pattern, **kw)
        np.testing.assert_array_equal(got.class_map, want.class_map)
        np.testing.assert_array_equal(got.trans, want.trans)
        np.testing.assert_array_equal(got.accepting, want.accepting)
        assert (got.anchored_start, got.anchored_end) == (
            want.anchored_start, want.anchored_end)


@pytest.mark.parametrize("pattern", CONTAINS)
def test_contains_re(pattern):
    values = _corpus()
    j, p = _pair(values)
    got = regex.contains_re(p, pattern)
    _same(jregex.contains_re(j, pattern), got)
    assert _live(got, values) == [
        re.search(pattern.encode(), v.encode()) is not None
        for v in values if v is not None]


@pytest.mark.parametrize("pattern", MATCHES)
def test_matches_re(pattern):
    values = _corpus()
    j, p = _pair(values)
    got = regex.matches_re(p, pattern)
    _same(jregex.matches_re(j, pattern), got)
    assert _live(got, values) == [
        re.fullmatch(f"(?:{pattern})".encode(), v.encode()) is not None
        for v in values if v is not None]


@pytest.mark.parametrize("op,pattern", [("find_re", p) for p in FIND]
                         + [("extract_re", p) for p in EXTRACT]
                         + [("count_re", p) for p in COUNT])
def test_span_ops(op, pattern):
    j, p = _pair(_corpus())
    want, got = getattr(jregex, op)(j, pattern), getattr(regex, op)(p, pattern)
    if op == "count_re":
        # the JAX count_re's INT32 column holds int64 data (its sum
        # widens under x64; ROADMAP Queue 3): the port keeps int32
        assert np.asarray(want.data).dtype == np.int64
        want = JColumn(np.asarray(want.data).astype(np.int32), want.dtype,
                       want.validity)
    _same(want, got)


@pytest.mark.parametrize("pattern,repl", REPLACE)
def test_replace_re(pattern, repl):
    j, p = _pair(_corpus())
    _same(jregex.replace_re(j, pattern, repl),
          regex.replace_re(p, pattern, repl))


def test_unsupported_patterns_raise_alike():
    _, p = _pair(["a"])
    for bad in [r"a(?=b)", r"(a", r"a{1,999}", r"a\k", r"mid^dle",
                r"(?:a|b)*a(?:a|b){12}"]:
        with pytest.raises(jregex.UnsupportedPatternError) as want:
            jregex.compile_re(bad)
        with pytest.raises(regex.UnsupportedPatternError) as got:
            regex.contains_re(p, bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(regex.UnsupportedPatternError, match="alternation"):
        regex.replace_re(p, r"^a|b", "X")
    with pytest.raises(regex.UnsupportedPatternError, match="capture"):
        regex.extract_re(p, r"(\d+)(\w+)")


@pytest.mark.parametrize("n", [1023, 1024, 1025])
def test_rlike_plan_matches_jax(n):
    rng = np.random.default_rng(n)
    cats = [b"Books", b"Electronics", b"Music", b"Home", b"Sports", b"",
            b"Books ", "Électronique".encode()]
    vals = [None if rng.random() < 0.05 else cats[i]
            for i in rng.integers(0, len(cats), n)]
    s, sv = string_wire(vals)
    wire = ([4, 23], [0, 0], [np.arange(n, dtype=np.int64).tobytes(), s],
            [None, sv], n)
    plan = json.dumps([{"op": "rlike", "column": 1,
                        "pattern": r"^(Books|Electronics|Music)$"},
                       {"op": "sort_by", "keys": [{"column": 1,
                                                   "ascending": False},
                                                  {"column": 0}]}])
    want = jrb.table_plan_wire(plan, *wire)
    got = rb.table_plan_wire(plan, *wire, device="cpu")
    assert tuple(got) == tuple(want)
