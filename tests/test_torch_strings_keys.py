"""STRING columns through the wire entries and the dispatch plane: the
port against the JAX package on the CPU.

Both packages get the same wire bytes (numpy, fixed seeds). Tolerance 0:
the wire 5-tuples (type ids, scales, data bytes, validity bytes, rows)
equal. The string keys hold nulls, empty strings, embedded NUL bytes,
bytes >= 0x80 (UTF-8 and raw), strings longer than one 8-byte order
word, and the two tables of a join, concat or cross join have different
pad widths. Row counts sit on the bucket edges 1023/1024/1025.
"""

import json

import numpy as np
import pytest

from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.ops import hashing as jhashing
from spark_rapids_jni_tpu.ops import strings as jstrings
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.column import Column, Table
from spark_rapids_jni_tpu_torch.ops import hashing, strings
from spark_rapids_jni_tpu_torch.utils import config as pconfig


@pytest.fixture(autouse=True)
def _registries_unchanged():
    """A test leaves the resident registries of both bridges as it found
    them: a table left behind would show in a later test's count."""
    before = (jrb.resident_table_count(), len(rb._RESIDENT))
    yield
    assert (jrb.resident_table_count(), len(rb._RESIDENT)) == before


WORDS = [b"", b"a", b"b", b"ab", b"a\x00", b"a\x00b", b"\x00", b"zz\xff",
         "Électron".encode(), "東京".encode(), b"hello world",
         b"abcdefghijklmnopq", b"abcdefgh", b"abcdefgi", b"brand #1",
         b"brand #10", b"\x80\x81", b"12345678901234567890123"]


def string_wire(vals) -> tuple:
    """(offsets + payload bytes, validity bytes | None) of a STRING
    column; None is null."""
    lens = [0 if v is None else len(v) for v in vals]
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    valid = (None if all(v is not None for v in vals) else
             np.array([v is not None for v in vals], np.uint8).tobytes())
    return offs.tobytes() + b"".join(v for v in vals if v is not None), valid


def make_wire(n: int, seed: int, words=WORDS, nulls: float = 0.1):
    """(s STRING, v INT64, i INT32 ~10 % null, f FLOAT64)."""
    rng = np.random.default_rng(seed)
    vals = [None if rng.random() < nulls else words[i]
            for i in rng.integers(0, len(words), n)]
    s, sv = string_wire(vals)
    v = rng.integers(-1000, 1000, n).astype(np.int64)
    i = rng.integers(0, 5, n).astype(np.int32)
    f = rng.standard_normal(n)
    iv = (rng.random(n) > 0.1).astype(np.uint8).tobytes()
    return ([23, 4, 3, 10], [0, 0, 0, 0],
            [s, v.tobytes(), i.tobytes(), f.tobytes()], [sv, None, iv, None],
            n)


SHORT = [w for w in WORDS if len(w) <= 3]

PLANS = {
    "sort_asc": [{"op": "sort_by", "keys": [{"column": 0}, {"column": 1}]}],
    "sort_desc": [{"op": "sort_by", "keys": [{"column": 0,
                                               "ascending": False},
                                              {"column": 1}]}],
    "distinct_key": [{"op": "distinct", "keys": [0]}],
    "distinct_all": [{"op": "distinct", "keys": [0, 2]}],
    "groupby": [{"op": "groupby", "by": [0], "aggs": [
        {"column": 1, "agg": a} for a in ("sum", "count", "min", "max",
                                          "mean")]}],
    "groupby_two_keys": [{"op": "groupby", "by": [2, 0],
                          "aggs": [{"column": 1, "agg": "sum"}]}],
    "partition_string": [{"op": "partition", "kind": "hash", "keys": [0],
                          "num": 7}],
    "partition_mixed": [{"op": "partition", "kind": "hash", "keys": [2, 0, 1],
                         "num": 200}],
    "partition_range": [{"op": "partition", "kind": "range", "keys": [0],
                         "num": 4}],
    "slice_repeat": [{"op": "slice", "start": 3, "stop": 700},
                     {"op": "repeat", "count": 2}],
    "sample": [{"op": "sample", "n": 50, "seed": 3}],
    **{f"join_{h}": [{"op": "join", "how": h, "on": [0]}]
       for h in ("inner", "left", "semi", "anti", "right", "full")},
    "join_two_keys": [{"op": "join", "how": "inner", "on": [2, 0]}],
    "concat": [{"op": "concat"}],
    "cross_join": [{"op": "slice", "start": 0, "stop": 40},
                   {"op": "cross_join"}],
}


def _resident(mod, plan, wires, **kw):
    ids = [mod.table_upload_wire(*w, **kw) for w in wires]
    try:
        out = mod.table_plan_resident(json.dumps(plan), ids)
        ids.append(out)
        return tuple(mod.table_download_wire(out))
    finally:
        for t in ids:
            mod.table_free(t)


TIER = ("join_inner", "join_semi", "join_anti", "groupby")
CASES = [(name, n, tier) for name in sorted(PLANS) for n in (1023, 1024, 1025)
         for tier in (("off", "on") if name in TIER else ("off",))]


@pytest.mark.parametrize("name,n,tier", CASES)
def test_string_plans_match_jax(name, n, tier):
    # the second table's strings are shorter: another pad width
    wires = [make_wire(n, n), make_wire(max(n // 4, 1), n + 1, SHORT)]
    if name.startswith("join_") and name not in ("join_right", "join_full"):
        wires = [make_wire(n, n), make_wire(60, n + 2, SHORT, nulls=0.2)]
    try:
        for c in (jconfig, pconfig):
            c.set_flag("KERNELS", tier)
        try:
            want = _resident(jrb, PLANS[name], wires)
        except (TypeError, ValueError):
            # the JAX outer joins raise on string keys of two pad widths,
            # and its ``concat`` on unnamed wire tables (ROADMAP Queue 3):
            # hold the port to the JAX ops on one pad and names instead
            want = None
        got = _resident(rb, PLANS[name], wires, device="cpu")
    finally:
        for c in (jconfig, pconfig):
            c.clear_flag("KERNELS")
    if want is not None:
        assert got == want
    else:
        _check_against_named_jax(name, wires, got)


def _check_against_named_jax(name, wires, got):
    """The JAX ops on named tables whose STRING columns share one pad."""
    from spark_rapids_jni_tpu import ops as jops

    tables = [jrb._table_from_wire(*w[:5], None) for w in wires]
    pad = max(t.columns[0].data.shape[1] for t in tables)
    named = [JTable([jstrings.repad(t.columns[0], pad), *t.columns[1:]],
                    ["s", "v", "i", "f"]) for t in tables]
    if name == "concat":
        out = jops.concatenate(named)
    else:
        how = name.split("_")[1]
        out = getattr(jops, f"{how}_join")(named[0], named[1], [0])
    assert got == tuple(jrb._table_to_wire(out))


def test_wire_round_trip_and_corrupt_offsets():
    wire = make_wire(1025, 5)
    for mod, kw in ((jrb, {}), (rb, {"device": "cpu"})):
        tid = mod.table_upload_wire(*wire, **kw)
        got = tuple(mod.table_download_wire(tid))
        mod.table_free(tid)
        assert got == tuple(wire)
    data = bytearray(wire[2][0])
    bad = {
        "non-decreasing": np.array([0, 5, 3], np.int32).tobytes() + b"abcde",
        "start at 0": np.array([2, 3, 4], np.int32).tobytes() + b"abcd",
        "needed for": bytes(data[:8]),
        "offsets require": np.array([0, 5, 9], np.int32).tobytes() + b"ab",
    }
    for match, buf in bad.items():
        for mod, kw in ((jrb, {}), (rb, {"device": "cpu"})):
            with pytest.raises(ValueError, match=match):
                mod.table_upload_wire([23], [0], [buf], [None], 2, **kw)


def test_murmur3_of_strings_matches_jax():
    """Spark's Murmur3 of one STRING key and of mixed keys, tail bytes
    >= 0x80 (sign-extended) included, at every tail length."""
    rng = np.random.default_rng(8)
    vals = [bytes(rng.integers(0, 256, k, dtype=np.uint8)) for k in
            list(range(0, 13)) * 40]
    vals = [None if i % 17 == 0 else v for i, v in enumerate(vals)]
    n = len(vals)
    ints = rng.integers(-50, 50, n).astype(np.int64)
    jt = JTable([JColumn.from_strings(vals), JColumn.from_numpy(ints)])
    pt = Table([Column.from_strings(vals, device="cpu"),
                Column.from_numpy(ints, device="cpu")])
    for keys in ([0], [1, 0], [0, 1]):
        want = np.asarray(jhashing.murmur3_table(jt, keys).data)
        np.testing.assert_array_equal(hashing.murmur3_table(pt, keys)
                                      .data.numpy(), want)


def test_dictionary_codes_match_jax():
    rng = np.random.default_rng(4)
    left = [WORDS[i] for i in rng.integers(0, len(WORDS), 300)]
    right = [SHORT[i] for i in rng.integers(0, len(SHORT), 90)]
    left[::7] = [None] * len(left[::7])
    jl, jr = JColumn.from_strings(left), JColumn.from_strings(right)
    pl = Column.from_strings(left, device="cpu")
    pr = Column.from_strings(right, device="cpu")
    for jc, pc in zip(jstrings.encode_join_keys(jl, jr),
                      strings.encode_join_keys(pl, pr)):
        np.testing.assert_array_equal(np.asarray(jc.data), pc.data.numpy())
    (jcodes, juniq), (pcodes, puniq) = (jstrings.dictionary_encode(jl),
                                        strings.dictionary_encode(pl))
    np.testing.assert_array_equal(np.asarray(jcodes.data), pcodes.data.numpy())
    assert juniq.to_pylist() == puniq.to_pylist()
    ids = [rb.table_upload_wire(*make_wire(8, 1), device="cpu"),
           rb.table_upload_wire([4], [0], [np.arange(8).tobytes()], [None], 8,
                                device="cpu")]
    with pytest.raises(TypeError, match="STRING vs non-STRING"):
        rb.table_plan_resident(json.dumps([{"op": "join", "on": [0]}]), ids)
    for t in ids:
        rb.table_free(t)
