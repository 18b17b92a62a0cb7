"""Device-memory footprint planning (port of ``utils/hbm.py``, in full).

Conservative per-op byte estimates against a per-device budget, used to
size batch and chunk parameters so the batched APIs never assemble a
resident set past the card, and to tell the spill tier when a plan will
not fit (the pressure listeners).

Budget: ``SPARK_RAPIDS_TPU_HBM_BUDGET_GB`` (``utils/config.py``) when
set; otherwise the device's own memory — on CUDA its total memory
(``torch.cuda.get_device_properties(dev).total_memory``), on the CPU the
JAX package's 16 GiB, so that plans on the CPU equal the JAX package's.
Either way it is scaled by :data:`RESERVE_FRACTION`, the share left to
the caching allocator's reserve and the ops' temporaries, which the
estimates below do not enumerate.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import config, flight, lockcheck, log, metrics, profiler

GIB = 1 << 30

# share of the budget left to temporaries; the estimates here count
# steady-state buffers only
RESERVE_FRACTION = 0.35

# what a CPU run plans against: the JAX package's per-chip figure
_CPU_HBM_GB = 16.0


def _as_device(device) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def backend_hbm_gb(device=None) -> float:
    """Device memory in GiB: a CUDA device's total memory, or 16 on the
    CPU."""
    dev = _as_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory / GIB
    return _CPU_HBM_GB


def budget_bytes(device=None) -> int:
    """Usable device bytes for steady-state buffers (``device`` None: the
    first CUDA device where there is one, else the CPU)."""
    gb = config.get_flag("HBM_BUDGET_GB")
    if not gb:
        gb = backend_hbm_gb(device)
    return int(float(gb) * GIB * (1.0 - RESERVE_FRACTION))


def tensor_bytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else int(t.numel() * t.element_size())


def column_bytes(col) -> int:
    """Resident bytes of one column (data + validity + lengths)."""
    return (tensor_bytes(col.data) + tensor_bytes(col.validity)
            + tensor_bytes(col.lengths))


def table_bytes(table) -> int:
    return sum(column_bytes(c) for c in table.columns)


def row_bytes(table) -> int:
    """Per-row resident bytes (ceil): the sizing unit of join output."""
    n = max(table.row_count, 1)
    return -(-table_bytes(table) // n)


def key_word_count(cols: Sequence) -> int:
    """u64 order words per row for a key column list (``ops/keys.py``):
    strings cost pad/8 + 1 words, DECIMAL128 two, the rest one, plus a
    validity word per nullable column."""
    words = 0
    for c in cols:
        if c.dtype.is_string:
            words += c.data.shape[1] // 8 + 1
        elif c.data.dim() == 2:
            words += c.data.shape[1]
        else:
            words += 1
        if c.validity is not None:
            words += 1
    return words


def _table_device(table) -> Optional[torch.device]:
    cols = getattr(table, "columns", None)
    return cols[0].data.device if cols else None


# Donation listeners (the serving tier credits a tenant's budget back).
# They run on the donate path whatever the telemetry flags and must be
# cheap and must not raise.
_DONATION_LISTENERS: list = []

# cumulative donated bytes for the flight counter track (kept here so
# the track survives flight-only mode and metrics resets)
_DONATED_LOCK = lockcheck.make_lock("hbm.donated")
_DONATED_TOTAL = 0


def register_donation_listener(fn) -> None:
    """Register ``fn(nbytes)`` to observe every buffer donation."""
    if fn not in _DONATION_LISTENERS:
        _DONATION_LISTENERS.append(fn)


def note_donation(nbytes: int) -> None:
    """Record one donation: ``nbytes`` of an input the plan consumed, so
    they were released as the op that read them returned instead of
    living beside the plan's output (``hbm.donations``,
    ``hbm.donated_bytes``; the profiler's segment and, under
    ``FLIGHT``, a cumulative ``hbm.donated_bytes`` counter track)."""
    global _DONATED_TOTAL
    profiler.note_donation(int(nbytes))
    for fn in tuple(_DONATION_LISTENERS):
        fn(int(nbytes))
    if not (metrics.enabled() or flight.enabled()):
        return
    metrics.counter_add("hbm.donations")
    metrics.bytes_add("hbm.donated_bytes", int(nbytes))
    if flight.enabled():
        with _DONATED_LOCK:
            _DONATED_TOTAL += int(nbytes)
            total = _DONATED_TOTAL
        flight.record("C", "hbm.donated_bytes", total)


# Pressure listeners: the spill tier (utils/spill.py) registers one so a
# plan that does not fit the budget frees the deficit before the launch
# runs out of memory. Fired whatever the telemetry flags, with the byte
# deficit; listeners gate themselves and must not raise.
_PRESSURE_LISTENERS: list = []


def register_pressure_listener(fn) -> None:
    """Register ``fn(deficit_bytes)`` to observe every over-budget plan."""
    if fn not in _PRESSURE_LISTENERS:
        _PRESSURE_LISTENERS.append(fn)


def _record_plan(kind: str, plan: dict, planned_bytes: int) -> None:
    """Plan-vs-budget decisions on the metrics plane: how many plans
    ran, the bytes they committed, and how often a shape did not fit."""
    if not plan["fits"]:
        deficit = max(planned_bytes - plan["budget_bytes"], 1)
        for fn in tuple(_PRESSURE_LISTENERS):
            fn(deficit)
    if not metrics.enabled():
        return
    metrics.counter_add("hbm.plan." + kind)
    metrics.bytes_add("hbm.planned_bytes", planned_bytes)
    metrics.gauge_set("hbm.budget_bytes", plan["budget_bytes"])
    if not plan["fits"]:
        metrics.counter_add("hbm.plan_over_budget")


def join_plan(left, right, left_on: Sequence, right_on: Sequence,
              device=None) -> dict:
    """Steady-state byte plan of a batched join: what is resident across
    one probe-chunk iteration, and the probe_rows that fits.

    Resident set per iteration (``ops/join.py`` ``inner_join_batches``):
      inputs        both tables
      build         sorted key words (W_r + 1 occupancy) * 8 B * m
                    + the permutation (4 B * m)
      probe chunk   chunk slice of left + lo/counts/lvalid (9 B/row)
      output        capacity * output row bytes (pow2 of the chunk's
                    matches; planned at 1x expansion and enforced at run
                    time by re-splitting oversized chunks)
    """
    for c in left_on:
        left.column(c)  # an unknown key raises here
    rcols = [right.column(c) for c in right_on]
    m = right.row_count
    budget = budget_bytes(device or _table_device(left))
    fixed = (table_bytes(left) + table_bytes(right)
             + (key_word_count(rcols) + 1) * 8 * m + 4 * m)
    out_row = row_bytes(left) + row_bytes(right)
    per_probe_row = row_bytes(left) + 9 + 2 * out_row
    avail = budget - fixed
    probe_rows = max(1024, avail // max(per_probe_row, 1))
    plan = {
        "budget_bytes": budget,
        "fixed_bytes": int(fixed),
        "per_probe_row_bytes": int(per_probe_row),
        "output_row_bytes": int(out_row),
        "probe_rows": int(probe_rows),
        "fits": avail > 0,
    }
    log.log("INFO", "hbm", "join_plan", **plan)
    _record_plan("join", plan, int(fixed))
    if metrics.enabled() and probe_rows < left.row_count:
        metrics.counter_add("hbm.join_chunk_decisions")
    return plan


def sort_plan(table, n_key_words: int, device=None) -> dict:
    """Variadic payload sort: operands (keys + iota + every buffer) live
    twice (input + output) during the sort."""
    n = table.row_count
    operand = n_key_words * 8 * n + 4 * n + table_bytes(table)
    total = 2 * operand
    budget = budget_bytes(device or _table_device(table))
    plan = {"budget_bytes": budget, "total_bytes": int(total),
            "fits": total <= budget}
    log.log("INFO", "hbm", "sort_plan", rows=n, **plan)
    _record_plan("sort", plan, int(total))
    return plan


def groupby_plan(table, by: Sequence, num_segments: int,
                 device=None) -> dict:
    """Single-pass capped groupby: the variadic sort (keys + payload,
    doubled) plus the num_segments-sized output and bounds."""
    key_cols = [table.column(c) for c in by]
    n = table.row_count
    words = key_word_count(key_cols) + 1  # + occupancy/iota word
    sort_bytes = 2 * (words * 8 * n + 4 * n + table_bytes(table))
    seg_bytes = num_segments * (8 + 2 * 4) + num_segments * row_bytes(table)
    total = sort_bytes + seg_bytes
    budget = budget_bytes(device or _table_device(table))
    plan = {"budget_bytes": budget, "total_bytes": int(total),
            "fits": total <= budget}
    log.log("INFO", "hbm", "groupby_plan", rows=n, segments=num_segments,
            **plan)
    _record_plan("groupby", plan, int(total))
    return plan
