"""The port's op library exports every name of the JAX package's
``ops.__all__`` but a pinned waiting list, and (on a machine with an
NVIDIA GPU) the new ops give the CPU's bytes on the card.

The card's tests import no JAX (the card's machine has none): run them
with ``python3 -m pytest --noconftest -m cuda tests/test_torch_ops_exports.py``.
Their inputs are finite (the card's NaN bits are its own), with -0.0,
+0.0 and subnormals.
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu_torch import ops
from spark_rapids_jni_tpu_torch.column import Column, Table
from spark_rapids_jni_tpu_torch.kernels import scan16
from spark_rapids_jni_tpu_torch.ops import datetime as pdtm
from spark_rapids_jni_tpu_torch.ops import window

#: the JAX exports still to port, each with its ROADMAP Queue 1 item
WAITING = {
    "split_explode": "item 6",
}


def test_exports_match_the_jax_package_but_the_waiting_list():
    from spark_rapids_jni_tpu import ops as jops

    missing = set(jops.__all__) - set(ops.__all__)
    assert missing == set(WAITING)
    assert set(ops.WAITING) == set(WAITING)
    for name in ops.__all__:
        assert getattr(ops, name) is not None, name


def test_waiting_names_are_not_exported():
    for name in WAITING:
        assert not hasattr(ops, name), name


ROWS = 1 << 20


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")


def _batch(device: str) -> Table:
    rng = np.random.default_rng(14)
    price = rng.integers(1, 30_000, ROWS) / 100
    price[rng.random(ROWS) < 0.01] = -0.0
    price[rng.random(ROWS) < 0.01] = 5e-324
    qty = rng.integers(1, 101, ROWS)
    return Table([
        Column.from_numpy(rng.zipf(1.3, ROWS) % 2000, device=device),
        Column.from_numpy(rng.integers(0, 1800, ROWS).astype(np.int32),
                          device=device),
        Column.from_numpy(price, rng.random(ROWS) > 0.02, device=device),
        Column.from_numpy(qty, rng.random(ROWS) > 0.02, device=device),
    ], ["item", "date", "price", "qty"])


def _bytes(c: Column):
    return (c.data.cpu().numpy().tobytes(),
            None if c.validity is None else c.validity.cpu().numpy().tobytes())


@pytest.mark.cuda
def test_window_float_sums_through_scan16_match_the_cpu():
    _cuda()
    cpu, gpu = _batch("cpu"), _batch("cuda")
    before = scan16.SCAN16.launches
    for agg, pre, fol in (("sum", 1 << 30, 0), ("mean", 1 << 30, 1 << 30),
                          ("sum", 3, 3)):
        args = (["item"], ["date"], "price", pre, fol, agg)
        assert _bytes(window.grouped_rolling_aggregate(gpu, *args)) == \
            _bytes(window.grouped_rolling_aggregate(cpu, *args)), agg
    assert scan16.SCAN16.launches - before >= 3
    want = ops.reduce_column(cpu.column("price"), "sum")
    assert _bytes(ops.reduce_column(gpu.column("price"), "sum")) == \
        _bytes(want)


@pytest.mark.cuda
def test_window_minmax_sparse_table_matches_the_cpu():
    _cuda()
    cpu, gpu = _batch("cpu"), _batch("cuda")
    for value in ("qty", "price"):
        for agg in ("min", "max"):
            args = (["item"], ["date"], value, 3, 3, agg)
            assert _bytes(window.grouped_rolling_aggregate(gpu, *args)) == \
                _bytes(window.grouped_rolling_aggregate(cpu, *args))
    for fn in ("rank", "dense_rank", "row_number", "percent_rank"):
        assert _bytes(getattr(window, fn)(gpu, ["item"], ["price"])) == \
            _bytes(getattr(window, fn)(cpu, ["item"], ["price"])), fn


@pytest.mark.cuda
def test_datetime_at_the_int64_extremes_matches_the_cpu():
    _cuda()
    from spark_rapids_jni_tpu_torch import dtype as dt

    big = np.iinfo(np.int64)
    rng = np.random.default_rng(2)
    ticks = np.concatenate([[big.min, big.max, big.min + 1, big.max - 1,
                             -1, 0], rng.integers(big.min, big.max, 4090)])
    for tid in (dt.TypeId.TIMESTAMP_NANOSECONDS,
                dt.TypeId.TIMESTAMP_MICROSECONDS):
        c = {d: Column.from_numpy(ticks, dtype=dt.DType(tid), device=d)
             for d in ("cpu", "cuda")}
        for f in ("year", "month", "day", "hour", "minute", "second",
                  "weekday", "day_of_year", "quarter", "last_day_of_month",
                  "millisecond_fraction", "microsecond_fraction",
                  "nanosecond_fraction", "day_of_week_sunday"):
            assert _bytes(getattr(pdtm, f)(c["cuda"])) == \
                _bytes(getattr(pdtm, f)(c["cpu"])), f
        for unit in ("year", "quarter", "month", "week", "day", "hour",
                     "minute", "second"):
            assert _bytes(pdtm.truncate(c["cuda"], unit)) == \
                _bytes(pdtm.truncate(c["cpu"], unit)), unit
        assert _bytes(pdtm.add_calendrical_months(c["cuda"], 7)) == \
            _bytes(pdtm.add_calendrical_months(c["cpu"], 7))
