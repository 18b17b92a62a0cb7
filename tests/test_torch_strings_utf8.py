"""UTF-8-aware string ops (``ops/strings_utf8.py``): the port against the
JAX package on the CPU.

The rows are the string library's seeded edge table (empty, null, 1-,
16- and 17-byte strings, multi-byte and invalid UTF-8, strings cut
mid-character) and a corpus of the JAX package's
``tests/test_strings_utf8.py`` cases (Latin-1, Greek, Cyrillic, CJK,
full-width forms, 4-byte characters, ß and İ, whose mappings change the
byte length). Each function runs once over all rows in both packages,
the JAX side jitted; data, pad width, lengths and validity compare byte
for byte. The port builds its own BMP case table: it must equal the JAX
package's entry for entry.
"""

import jax
import numpy as np
import pytest

from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.ops import strings_utf8 as jutf8
from spark_rapids_jni_tpu_torch.column import Column
from spark_rapids_jni_tpu_torch.ops import strings_utf8 as utf8

from test_torch_strings_lib import VALUES, same

CORPUS = ["héllo", "ÀÉÎÕÜ", "àéîõü", "straße", "İstanbul", "ΑΒΓΔ αβγδ",
          "Привет мир", "日本語テキスト", "ＡＢＣａｂｃ", "𝐀𝐁 plain ascii",
          "😀😃x", "ǅǈǋ", "ĀāĂă", "ﬀ", "Ωmega", "x́y", ""]
PAD = 40


def _rows():
    vals = VALUES + CORPUS
    return (JColumn.from_strings(vals, pad_width=PAD),
            Column.from_strings(vals, pad_width=PAD, device="cpu"))


CASES = {
    "char_length": ("char_length", ()),
    "upper": ("utf8_upper", ()),
    "lower": ("utf8_lower", ()),
    "substring_0_2": ("utf8_substring", (0, 2)),
    "substring_1": ("utf8_substring", (1, None)),
    "substring_neg_2": ("utf8_substring", (-2, None)),
    "substring_neg_10_3": ("utf8_substring", (-10, 3)),
    "substring_5_0": ("utf8_substring", (5, 0)),
    "substring_past_end": ("utf8_substring", (30, 4)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_utf8_function_matches_jax(name):
    fn, args = CASES[name]
    jc, pc = _rows()
    want = jax.jit(lambda c: getattr(jutf8, fn)(c, *args))(jc)
    same(want, getattr(utf8, fn)(pc, *args))


@pytest.mark.parametrize("upper", [True, False])
def test_case_table_matches_jax(upper):
    np.testing.assert_array_equal(
        jutf8._bmp_case_table(upper).astype(np.int64),
        utf8._bmp_case_table(upper).astype(np.int64))


def test_length_changing_mappings_pass_through():
    pc = Column.from_strings(["straße", "İstanbul", "😀a"], device="cpu")
    assert utf8.utf8_upper(pc).to_pylist() == ["STRAßE", "İSTANBUL", "😀A"]
    assert utf8.utf8_lower(pc).to_pylist()[0] == "straße"
