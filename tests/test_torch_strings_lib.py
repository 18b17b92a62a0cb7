"""The STRING function library (``ops/strings.py`` ``length`` ...
``translate``): the port against the JAX package on the CPU.

One seeded table holds every edge at once: empty strings, nulls, strings
of 1, 16 and 17 bytes in a column of pad 17 (and a column of pad 1),
multi-byte and invalid UTF-8, delimiters at both ends, ``%``-escapes cut
short, signs before digits, runs of the strip set. Each function runs
once over all rows in both packages (the JAX side jitted where it
computes on the device alone, eager where it reads the host) and the
results compare byte for byte: data, pad width, lengths and validity.
Tolerance 0.
"""

import jax
import numpy as np
import pytest

from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.ops import strings as jstrings
from spark_rapids_jni_tpu_torch.column import Column
from spark_rapids_jni_tpu_torch.ops import strings

EDGES = [
    "", None, "a", "Z", " ", ",", "%", "7", "  hello  ", "\thi\t", "xxabcxx",
    "banana", "aaaa", "abcabc", "a,b,c", ",x,", ",,", "a,,b", "one",
    "hello%20world", "%4", "%4G", "%zz", "%41%", "a+b%2B", "100%", "+12",
    "-3", "42", "-", "ÀÉÎõü", "straße", "日本語", "😀x", "ΑΒΓ αβγ",
    "Hello World foo-bar", "UPPER", "lower", "MiXeD123", "\n\t ",
    "abc123", "1234567890123456", "12345678901234567", "x" * 17, "ab%",
    "a~b.c_d-e", "ololo", "Ünïcödé", "é,é", "\x00a",
]
INVALID = [b"\xff\xfe", b"\xc3", b"a\x80b", b"\xe2\x82", b"\xc3(,"]
ALPHABET = list("abcAB ,%+-._~019xyz") + ["é", "ß", "日", "%4", "%2b"]
PAD = 17
ROWS = 400


def _values(seed: int = 7) -> list:
    rng = np.random.default_rng(seed)
    vals = list(EDGES) + list(INVALID)
    while len(vals) < ROWS:
        if rng.random() < 0.08:
            vals.append(None)
            continue
        s = "".join(ALPHABET[i] for i in rng.integers(0, len(ALPHABET),
                                                       rng.integers(0, 9)))
        b = s.encode()[:PAD]
        vals.append(b.decode("utf-8", "surrogateescape"))
    raw = [v.encode("utf-8", "surrogateescape") if isinstance(v, str)
           else v for v in vals]
    # at most PAD bytes: a longer edge is cut, mid-character at times
    return [None if v is None else v[:PAD].decode("utf-8", "surrogateescape")
            for v in raw]


VALUES = _values()
PAD1 = ["", None, "a", " ", ",", "%", "Z", "7", "\udcff"]  # the last: byte 0xFF


def _cols(values, pad):
    return (JColumn.from_strings(values, pad_width=pad),
            Column.from_strings(values, pad_width=pad, device="cpu"))


def same(j: JColumn, p: Column) -> None:
    """Equal dtype, data bytes (pad width included), lengths, validity."""
    assert (j.dtype.id.value, j.dtype.scale) == (p.dtype.id.value,
                                                 p.dtype.scale)
    jd, pd = np.asarray(j.data), p.data.numpy()
    assert jd.shape == pd.shape and jd.dtype == pd.dtype
    np.testing.assert_array_equal(jd, pd)
    for a, b in ((j.validity, p.validity), (j.lengths, p.lengths)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


# name -> (function, arguments after the column, does the JAX function
# read the host: run it eagerly)
CASES = {
    "length": ("length", (), False),
    "upper": ("upper", (), False),
    "lower": ("lower", (), False),
    "contains_a": ("contains", ("a",), False),
    "contains_multi": ("contains", ("%2",), False),
    "contains_utf8": ("contains", ("é",), False),
    "contains_empty": ("contains", ("",), False),
    "contains_past_pad": ("contains", ("x" * 18,), False),
    "starts_with": ("starts_with", ("ab",), False),
    "starts_with_empty": ("starts_with", ("",), False),
    "ends_with": ("ends_with", ("c",), False),
    "ends_with_two": ("ends_with", ("xx",), False),
    "substring": ("substring", (0, 3), False),
    "substring_mid": ("substring", (2, 5), False),
    "substring_long": ("substring", (1, 100), False),
    "substring_empty": ("substring", (5, 0), False),
    "substring_negative": ("substring", (-1, 2), False),
    "strip": ("strip", (), False),
    "lstrip": ("lstrip", (), False),
    "rstrip": ("rstrip", (), False),
    "lstrip_x": ("lstrip", ("x",), False),
    "rstrip_ws": ("rstrip", (" \t",), False),
    "find": ("find", ("lo",), False),
    "find_delim": ("find", ("a,",), False),
    "find_empty": ("find", ("",), False),
    "find_past_pad": ("find", ("y" * 18,), False),
    "rpad_8": ("pad", (8, "right", "*"), False),
    "lpad_4": ("pad", (4, "left", "ab"), False),
    "pad_1": ("pad", (1, "left", "0"), False),
    "pad_16": ("pad", (16, "right", "-="), False),
    "pad_17": ("pad", (17, "left", "é"), False),
    "pad_0": ("pad", (0, "right", " "), False),
    "replace_equal": ("replace", ("an", "AN"), False),
    "replace_greedy": ("replace", ("aa", "bb"), False),
    "replace_grow": ("replace", ("a", "xyz"), True),
    "replace_delete": ("replace", (",", ""), True),
    "replace_empty": ("replace", ("", "x"), False),
    "split_get_0": ("split_get", (",", 0), False),
    "split_get_1": ("split_get", (",", 1), False),
    "split_get_5": ("split_get", (",", 5), False),
    "reverse": ("reverse", (), False),
    "is_digit": ("is_digit", (), False),
    "is_alpha": ("is_alpha", (), False),
    "is_alnum": ("is_alnum", (), False),
    "is_space": ("is_space", (), False),
    "is_upper": ("is_upper", (), False),
    "is_lower": ("is_lower", (), False),
    "zfill_5": ("zfill", (5,), False),
    "zfill_20": ("zfill", (20,), False),
    "capitalize": ("capitalize", (), False),
    "title": ("title", (), False),
    "url_decode": ("url_decode", (), False),
    "url_encode": ("url_encode", (), True),
    "translate": ("translate", ("abc", "xy"), False),
    "translate_map": ("translate", ("a,", "A;"), False),
    "translate_dup": ("translate", ("aab", "xyz"), False),
}


def _run(name, values, pad):
    fn, args, host = CASES[name]
    jc, pc = _cols(values, pad)
    jfn = getattr(jstrings, fn)
    want = None
    if not host:
        try:
            want = jax.jit(lambda c: jfn(c, *args))(jc)
        except jax.errors.JAXTypeError:  # this shape takes a host path
            pass
    if want is None:
        want = jfn(jc, *args)
    same(want, getattr(strings, fn)(pc, *args))


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_jax(name):
    _run(name, VALUES, PAD)


@pytest.mark.parametrize("name", ["length", "upper", "contains_a",
                                  "ends_with", "substring", "find",
                                  "pad_1", "replace_equal", "replace_grow",
                                  "split_get_1", "reverse", "is_space",
                                  "zfill_5", "title", "url_encode",
                                  "translate"])
def test_function_matches_jax_at_pad_1(name):
    _run(name, PAD1, 1)


def test_url_decode_at_pad_1():
    """At pad 1 the JAX package's ``url_decode`` broadcasts its two-byte
    look-ahead to a pad of 2 and doubles every byte ("a" -> "aa"); the
    port keeps one byte, '+' decoded to a space (ROADMAP Queue 3)."""
    vals = PAD1 + ["+"]
    jc, pc = _cols(vals, 1)
    got = strings.url_decode(pc)
    assert got.data.shape == (len(vals), 1)
    assert got.to_pylist() == [None if v is None else v.replace("+", " ")
                               for v in vals]
    assert jstrings.url_decode(jc).to_pylist()[2] == "aa"


def _int_cols(vals):
    from spark_rapids_jni_tpu_torch import dtype as dt
    from spark_rapids_jni_tpu import dtype as jdt

    arr = np.array([0 if v is None else v for v in vals], np.int32)
    valid = np.array([v is not None for v in vals])
    return (JColumn.from_numpy(arr, validity=valid, dtype=jdt.INT32),
            Column.from_numpy(arr, valid, dt.INT32, device="cpu"))


def test_substring_column_matches_jax():
    rng = np.random.default_rng(11)
    n = len(VALUES)
    starts = [None if rng.random() < 0.05 else int(v)
              for v in rng.integers(-3, 20, n)]
    lens = [None if rng.random() < 0.05 else int(v)
            for v in rng.integers(-2, 20, n)]
    (js, ps), (jl, pl) = _int_cols(starts), _int_cols(lens)
    jc, pc = _cols(VALUES, PAD)
    want = jax.jit(jstrings.substring_column)(jc, js, jl)
    same(want, strings.substring_column(pc, ps, pl))


@pytest.mark.parametrize("sep", ["-", "", ", "])
def test_concat_ws_matches_jax(sep):
    a, b = VALUES, VALUES[::-1]
    c = VALUES[len(VALUES) // 2:] + VALUES[:len(VALUES) // 2]
    (ja, pa), (jb, pb), (jc, pc) = (_cols(a, PAD), _cols(b, PAD),
                                    _cols(c, 9 + PAD))
    want = jax.jit(lambda *cs: jstrings.concat_ws(sep, *cs))(ja, jb, jc)
    same(want, strings.concat_ws(sep, pa, pb, pc))
    same(jax.jit(lambda x: jstrings.concat_ws(sep, x))(ja),
         strings.concat_ws(sep, pa))


def test_raises_as_jax():
    jc, pc = _cols(["a"], 1)
    for fn, args in (("pad", (3, "right", "")), ("pad", (3, "middle")),
                     ("split_get", (",,", 0)), ("translate", ("é", "e"))):
        with pytest.raises(ValueError) as je:
            getattr(jstrings, fn)(jc, *args)
        with pytest.raises(ValueError) as pe:
            getattr(strings, fn)(pc, *args)
        assert str(je.value) == str(pe.value)
    with pytest.raises(ValueError, match="at least one"):
        strings.concat_ws(",")
    with pytest.raises(TypeError):
        strings.length(Column.from_numpy(np.zeros(2, np.int32), device="cpu"))
