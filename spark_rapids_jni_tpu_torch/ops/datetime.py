"""Datetime field extraction and arithmetic (port of ``ops/datetime.py``:
cudf ``datetime`` ops).

Timestamps store int64 ticks since the Unix epoch in the column's unit
(TIMESTAMP_DAYS: int32 days). All field math is branch-free int64
arithmetic with floor division (the civil-calendar algorithms), which
torch's ``//`` and ``%`` on integer tensors give, so dates before 1970
and before year 1 land on the JAX package's values; ticks near the
int64 extremes wrap as they do there.
"""

from __future__ import annotations

import torch

from .. import dtype as dt
from ..column import Column

_TICKS_PER_DAY = {
    dt.TypeId.TIMESTAMP_DAYS: 1,
    dt.TypeId.TIMESTAMP_SECONDS: 86_400,
    dt.TypeId.TIMESTAMP_MILLISECONDS: 86_400_000,
    dt.TypeId.TIMESTAMP_MICROSECONDS: 86_400_000_000,
    dt.TypeId.TIMESTAMP_NANOSECONDS: 86_400_000_000_000,
}

_TICKS_PER_SECOND = {
    dt.TypeId.TIMESTAMP_SECONDS: 1,
    dt.TypeId.TIMESTAMP_MILLISECONDS: 1_000,
    dt.TypeId.TIMESTAMP_MICROSECONDS: 1_000_000,
    dt.TypeId.TIMESTAMP_NANOSECONDS: 1_000_000_000,
}


def _require_timestamp(col: Column):
    if col.dtype.id not in _TICKS_PER_DAY:
        raise TypeError(f"expected a timestamp column, got {col.dtype}")


def _days_and_seconds(col: Column):
    """(days since epoch, seconds within day) — floor semantics so
    pre-1970 instants land in the correct civil day."""
    ticks = col.data.to(torch.int64)
    per_day = _TICKS_PER_DAY[col.dtype.id]
    days = ticks // per_day
    if col.dtype.id == dt.TypeId.TIMESTAMP_DAYS:
        return days, torch.zeros_like(days)
    per_sec = _TICKS_PER_SECOND[col.dtype.id]
    secs = (ticks - days * per_day) // per_sec
    return days, secs


def _civil_from_days(days):
    """days since 1970-01-01 -> (year, month, day), proleptic Gregorian:
    the branch-free era/day-of-era decomposition."""
    z = days + 719_468
    era = torch.where(z >= 0, z, z - 146_096) // 146_097
    doe = z - era * 146_097  # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36_524 - doe // 146_096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)  # [0, 365]
    mp = (5 * doy + 2) // 153  # [0, 11], March-based
    d = doy - (153 * mp + 2) // 5 + 1  # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)  # [1, 12]
    year = torch.where(m <= 2, y + 1, y)
    return year, m, d


def _days_from_civil(y, m, d):
    """(year, month, day) -> days since epoch; inverse of
    _civil_from_days."""
    y_adj = torch.where(m <= 2, y - 1, y)
    era = torch.where(y_adj >= 0, y_adj, y_adj - 399) // 400
    yoe = y_adj - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146_097 + doe - 719_468


def _field(col: Column, fn) -> Column:
    _require_timestamp(col)
    days, secs = _days_and_seconds(col)
    out = fn(days, secs).to(torch.int16)
    return Column(out, dt.INT16, col.validity)


def year(col: Column) -> Column:
    return _field(col, lambda d, s: _civil_from_days(d)[0])


def month(col: Column) -> Column:
    return _field(col, lambda d, s: _civil_from_days(d)[1])


def day(col: Column) -> Column:
    return _field(col, lambda d, s: _civil_from_days(d)[2])


def hour(col: Column) -> Column:
    return _field(col, lambda d, s: s // 3600)


def minute(col: Column) -> Column:
    return _field(col, lambda d, s: (s // 60) % 60)


def second(col: Column) -> Column:
    return _field(col, lambda d, s: s % 60)


def weekday(col: Column) -> Column:
    """ISO day-of-week: Monday=1 .. Sunday=7 (cudf convention)."""
    # 1970-01-01 was a Thursday (ISO 4)
    return _field(col, lambda d, s: ((d + 3) % 7) + 1)


def day_of_year(col: Column) -> Column:
    def f(days, secs):
        y, m, _ = _civil_from_days(days)
        one = torch.ones_like(m)
        return days - _days_from_civil(y, one, one) + 1

    return _field(col, f)


def last_day_of_month(col: Column) -> Column:
    """TIMESTAMP_DAYS column of each instant's month-end date."""
    _require_timestamp(col)
    days, _ = _days_and_seconds(col)
    y, m, _d = _civil_from_days(days)
    ny = torch.where(m == 12, y + 1, y)
    nm = torch.where(m == 12, torch.ones_like(m), m + 1)
    first_next = _days_from_civil(ny, nm, torch.ones_like(nm))
    out = (first_next - 1).to(torch.int32)
    return Column(out, dt.TIMESTAMP_DAYS, col.validity)


def add_calendrical_months(col: Column, months) -> Column:
    """Shift by calendar months, clamping the day to the target month's
    length (cudf add_calendrical_months / Spark add_months)."""
    _require_timestamp(col)
    days, secs = _days_and_seconds(col)
    delta = months.data.to(torch.int64) if isinstance(months, Column) \
        else months
    y, m, d = _civil_from_days(days)
    total = y * 12 + (m - 1) + delta
    ny = total // 12
    nm = total % 12 + 1
    one = torch.ones_like(nm)
    # clamp day to the length of the target month
    ny2 = torch.where(nm == 12, ny + 1, ny)
    nm2 = torch.where(nm == 12, one, nm + 1)
    month_len = _days_from_civil(ny2, nm2, one) - _days_from_civil(
        ny, nm, one)
    nd = torch.minimum(d, month_len)
    out_days = _days_from_civil(ny, nm, nd)
    per_day = _TICKS_PER_DAY[col.dtype.id]
    ticks = out_days * per_day + (col.data.to(torch.int64) - days * per_day)
    out = ticks.to(col.dtype.storage_dtype)
    valid = col.validity
    if isinstance(months, Column) and months.validity is not None:
        valid = months.validity if valid is None else valid & months.validity
    return Column(out, col.dtype, valid)


def quarter(col: Column) -> Column:
    """Quarter 1-4 (Spark ``quarter`` / cudf ``extract_quarter``)."""
    return _field(
        col, lambda days, secs: (_civil_from_days(days)[1] - 1) // 3 + 1)


def truncate(col: Column, unit: str) -> Column:
    """Round the timestamp DOWN to the unit boundary (Spark
    ``date_trunc`` / cudf ``floor_temporal``). Units: year, quarter,
    month, week (ISO Monday), day, hour, minute, second. Result keeps
    the input timestamp type."""
    _require_timestamp(col)
    days, secs = _days_and_seconds(col)
    unit = unit.lower()
    zero = torch.zeros_like(secs)
    if unit in ("year", "quarter", "month"):
        y, m, _ = _civil_from_days(days)
        one = torch.ones_like(m)
        if unit == "year":
            m_out = one
        elif unit == "quarter":
            m_out = ((m - 1) // 3) * 3 + 1
        else:
            m_out = m
        new_days, new_secs = _days_from_civil(y, m_out, one), zero
    elif unit == "week":
        # ISO week starts Monday; 1970-01-01 was a Thursday (weekday 3
        # with Monday=0)
        new_days, new_secs = days - (days + 3) % 7, zero
    elif unit == "day":
        new_days, new_secs = days, zero
    elif unit in ("hour", "minute", "second"):
        step = {"hour": 3600, "minute": 60, "second": 1}[unit]
        new_days, new_secs = days, (secs // step) * step
    else:
        raise ValueError(f"date_trunc: unknown unit {unit!r}")
    if col.dtype.id == dt.TypeId.TIMESTAMP_DAYS:
        ticks = new_days
    else:
        ticks = (new_days * _TICKS_PER_DAY[col.dtype.id]
                 + new_secs * _TICKS_PER_SECOND[col.dtype.id])
    return Column(ticks.to(col.data.dtype), col.dtype, col.validity)


def _subsecond_ticks(col: Column):
    """Ticks past the whole second (floor semantics), in the column's
    own resolution; zero for second/day resolutions."""
    _require_timestamp(col)
    per_sec = _TICKS_PER_SECOND.get(col.dtype.id, 1)
    if per_sec == 1:
        return torch.zeros(col.data.shape, dtype=torch.int64,
                           device=col.data.device)
    ticks = col.data.to(torch.int64)
    return ticks - (ticks // per_sec) * per_sec


def millisecond_fraction(col: Column) -> Column:
    """Milliseconds past the second, 0-999 (cudf
    ``extract_millisecond_fraction``)."""
    per_sec = _TICKS_PER_SECOND.get(col.dtype.id, 1)
    # sub-second ticks are already zero below millisecond resolution,
    # so the unconditional formula covers every unit
    out = _subsecond_ticks(col) * 1_000 // max(per_sec, 1_000)
    return Column(out.to(torch.int16), dt.INT16, col.validity)


def microsecond_fraction(col: Column) -> Column:
    """Microseconds within the millisecond, 0-999 (cudf
    ``extract_microsecond_fraction``)."""
    _require_timestamp(col)
    per_sec = _TICKS_PER_SECOND.get(col.dtype.id, 1)
    if per_sec < 1_000_000:
        out = torch.zeros(col.data.shape, dtype=torch.int16,
                          device=col.data.device)
        return Column(out, dt.INT16, col.validity)
    us = _subsecond_ticks(col) * 1_000_000 // per_sec
    return Column((us % 1_000).to(torch.int16), dt.INT16, col.validity)


def nanosecond_fraction(col: Column) -> Column:
    """Nanoseconds within the microsecond, 0-999 (cudf
    ``extract_nanosecond_fraction``)."""
    if col.dtype.id != dt.TypeId.TIMESTAMP_NANOSECONDS:
        _require_timestamp(col)
        out = torch.zeros(col.data.shape, dtype=torch.int16,
                          device=col.data.device)
        return Column(out, dt.INT16, col.validity)
    ns = _subsecond_ticks(col)
    return Column((ns % 1_000).to(torch.int16), dt.INT16, col.validity)


def day_of_week_sunday(col: Column) -> Column:
    """Spark ``dayofweek``: 1=Sunday .. 7=Saturday (vs ``weekday``'s
    ISO 1=Monday .. 7=Sunday)."""
    # 1970-01-01 was a Thursday: Sunday-based index 5 (Sun=1)
    return _field(col, lambda d, s: ((d + 4) % 7) + 1)
