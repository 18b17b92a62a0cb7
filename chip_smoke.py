#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold every
hand-written kernel against its plain PyTorch version.

Run from the root of the repository, with one CUDA device:

    python3 chip_smoke.py [--seed N]

The kernels are built from ``spark_rapids_jni_tpu_torch/csrc`` with
``nvcc`` first (one compiler per source, all started together). Then:

(a) query — one Spark task's batch of TPC-DS SF100 ``store_sales``
    (2^23 rows, handed over as packed rows) joined with ``item``
    (204,000 rows), through ``table_upload_wire`` ->
    ``table_plan_resident`` -> ``table_download_wire`` -> ``table_free``:
    from_rows -> filter -> inner join -> groupby by brand
    (sum/count/min/max of quantity) -> to_rows. The result is held
    against a numpy oracle of the same SQL. Every kernel's launch count
    is set to 0 just before the first run and read just after it.
(b) row conversion — the RowConversionTest schema (SURVEY.md §4) at
    2^22 rows through the plan [to_rows, from_rows]; the round trip must
    give back the uploaded bytes.
(d) exchange — the map side of a shuffle on the same 2^23-row batch:
    from_rows -> partition (Spark's hash partitioning on ss_item_sk and
    the nullable ss_customer_sk, 200 partitions: Spark's default
    spark.sql.shuffle.partitions) -> to_rows. The result is held against
    a numpy Murmur3 oracle: pmod 200, stable argsort, the row bytes.
(e) sort — the SortExec of a sort-merge join on ss_item_sk over the same
    batch: from_rows -> sort_by item_sk -> to_rows, held against a stable
    numpy argsort of the row bytes.
(f) packed groupby — SUM/COUNT of an int64 value grouped by an int64 key
    of 10,000 values over 16,000,000 rows (BASELINE config 1), through
    ``ops.groupby_packed.groupby_aggregate_packed_chunked`` (chunks of
    2^17 rows, 2^14 partials a chunk) under each phase-1 engine: "lax"
    (torch.sort), "pallas" (K4a) and "pallas32" (K4b); the three results
    must equal a numpy oracle and each other byte for byte, and each
    engine is profiled. The eager router ``groupby_aggregate_packed`` runs
    once against the same oracle.
(g) query_step — ``graft_entry.query_step`` (WHERE qty > 5 -> capped
    inner join -> mul -> capped groupby SUM/COUNT(qty * price), the port
    of the repository's entry point ``__graft_entry__.query_step``) over
    a TPC-DS SF100 store_sales batch of 2^23 rows (ss_item_sk Zipf(1.3)
    mod 204,000, ss_quantity 1-100, ss_sales_price in cents) and the
    204,000-row item table: group count, keys and counts exact against
    numpy, the FLOAT64 sums bit-exact against the port's own CPU run of
    the same tables and within 1e-9 of numpy's; host syncs counted.
    Step 0 times the plain FLOAT64 scan (``_scan_sum16``) beside
    ``torch.cumsum``, and the scan16 kernel is held bit for bit against
    it there and at every tile edge.
(h) wire plan — ``table_plan_wire`` over (a)'s batch as wire bytes:
    from_rows -> filter -> cast quantity to INT64 -> groupby the sold date
    (SUM/COUNT/MIN/MAX) -> sort_by the date -> to_rows, exact against
    numpy, once with SPARK_RAPIDS_TPU_KERNELS=on and once off (equal
    5-tuples; the tier's launch and decline counters printed for each):
    [filter, cast, groupby] is one fused segment, where the tier is not
    consulted; a 2^20-row legacy flat UINT8 input under the same default
    ladder (one fused segment, no fallback); then (a)'s batch once op by
    op (SPARK_RAPIDS_TPU_BUCKETS=off), where the groupby runs K2a.
(i) the rest of the dispatch plane — four resident plans through
    ``table_upload_wire`` + ``table_plan_resident`` over (a)'s batch:
    (i1) a LEFT SEMI join with the ~20,400 items of one category (K2a +
    K2b through the kernel tier), then per-day mean/variance/std of the
    quantity and first/last customer, sorted, to rows; (i2) a LEFT ANTI
    join with the same items, then SELECT DISTINCT customer, date; (i3) a
    LEFT OUTER join with SF100 customer (2,000,000 keys, every 20th left
    out; birth year 3.5 % null), then count/nunique(item)/sum(quantity)
    by birth year; (i4) UNION ALL of two 2^23-row batches (an explicit
    ``rest``), FULL OUTER join with item, counts by category. Each is
    held against a numpy oracle (integers exact, floats within 1e-9),
    (i1) also byte for byte against the port's own CPU run; then 5 timed
    runs and a profiled window.
(j) every other new op once at 2^20 rows through ``table_op_resident``
    (right join, cross_join of 1,826 dates x 10 categories, slice,
    repeat, sample with and without replacement, collect_list/collect_set
    by day, a donated input) and at the ops level (distinct_capped,
    drop_nulls), byte for byte against the port's own CPU run.
(k) STRING columns — resident plans over (a)'s batch and SF100 item and
    customer with dsdgen-shaped strings: (k1) inner join with item
    (carrying i_brand/i_category/i_class; K1b, K2a, K2b), rlike
    '^(Books|Electronics|Music)$' on i_category, SUM/COUNT(quantity) by
    i_brand, ORDER BY the sum desc, brand (q3/q52/q55); (k2) the rows
    with a customer, inner join with customer (K2a, K2b), SUM(quantity)
    by (c_customer_id, c_first_name, c_last_name), inner join on the
    16-byte c_customer_id with the birth country, hash partition on
    c_customer_id into 200 (q11/q74); (k3) CAST of a 2^23-row price
    column and an INT64 column to STRING and the price back. Each equals
    the port's own CPU run byte for byte and a numpy oracle ((k1)'s regex
    also Python's re.fullmatch; (k3)'s strings Java's Double.toString
    layout on a sample, its round trip bit-exact); then 5 timed runs, the
    host syncs of one run and a profiled window, and the DFA scan and
    the Murmur3 string chain alone under the profiler. (k4) runs the
    rest of the string surface once at 2^20 rows against the CPU's
    bytes: explode, distinct, a descending sort on a nullable string,
    concat and cross_join of two pad widths, rlike, casts with
    unparseable rows, the regex span ops, comparisons and ||. (k5) runs
    the string function library (``ops/strings.py`` length ... translate,
    ``ops/strings_utf8.py``, ``concat_ws``, ``substring_column`` and
    ``ops.split_explode``) over a 2,000,000-row multi-byte UTF-8 column
    made from ``--seed`` beside customer's names, each call byte
    for byte against the port's own CPU run, with its device time and
    launches from the profiler. That CPU run is a child process of this
    script (``--k5-cpu-reference``, every core but one) that runs while
    (k5)'s calls run on the card; (k5) then compares its buffers as
    before.
(l) DECIMAL128 — one Spark task's batch of TPC-H lineitem (2^23 rows,
    the specification's value ranges, the money columns DECIMAL64 at
    scale -2 with ~2 % nulls) through ``table_upload_wire`` +
    ``table_plan_resident``: (l1) q1's DECIMAL128 core (the shipdate
    filter, the casts to decimal(22,2) that Spark's SUM inserts,
    SUM/AVG/COUNT by returnflag and linestatus, ORDER BY both), sums and
    counts exact against Python ints; (l2) ORDER BY l_extendedprice DESC
    on the decimal(22,2) key, exact against a stable numpy argsort; both
    byte for byte against the port's own CPU run, timed like (i) and (k).
    (l3) runs the rest once at 2^20 rows with values near +-10^37 and
    +-2^64: joins, distinct, sum/mean/min/max/variance/std, the casts to
    and from INT64, FLOAT64, DECIMAL64 and STRING, add/sub/comparisons
    at mixed scales, against the CPU run's bytes and Python ints.
(m) the execution services under the wire entries, over 8 batches of
    (a)'s shape (268 MB of wire bytes each, ``ss_sold_date_sk`` shifted by
    the batch's index so every answer differs): (m1) ``table_stream_wire``
    with (h)'s plan at PIPELINE off, 1, 2 and 4, every 5-tuple equal to
    ``table_plan_wire`` of its batch and to numpy, in input order; wall a
    batch (median of 3 streams), the host time a batch of decode, plan and
    encode with the pipeline off, the device busy share at depth off and
    2, the pipeline counters and K1b/K2a/K1a's launches a stream; (m2)
    SPILL on with a device budget that holds 2 of 6 resident tables and
    a host budget of one, a resident plan over each id and the first
    again, equal to the unspilled bytes, eviction/repage/demotion counts,
    no spill file left, and one table's eviction and repage GB/s (pinned,
    through the spill tier; pageable, direct copies of the same tensors)
    beside the PCIe link ``nvidia-smi`` reports; (m3)
    seeded transient faults at dispatch, serde, kernel and spill over the
    stream at depth 2 and a resident spill sequence (the same bytes; the
    retries, the kernel site's retries of the same kernel and the spill
    errors equal the injections, and nothing fell back), a
    permanent fault surfacing typed, and an allocation past the card
    classified ResourceExhausted, given up after RETRY_MAX, with (h)'s
    plan exact after it; (m4) the registry's count back to its start and
    ``table_reclaim`` returning the table's bytes as
    ``torch.cuda.memory_allocated`` falls by them.
(n) the op library at the ops level over (a)'s 2^23 rows as columns,
    with a FLOAT64 ``ss_sales_price``, the sold date as TIMESTAMP_DAYS,
    a TIMESTAMP_MICROSECONDS sold time and a DECIMAL64 price (~2 %
    null), partitioned by ss_item_sk: (n1) window functions (q51's
    running SUM, q47/q57's AVG over the item, MIN/MAX over ROWS 3
    PRECEDING to 3 FOLLOWING, COUNT over RANGE 30 days PRECEDING, the
    rank family by price descending, LAG/LEAD), whose FLOAT64 prefixes
    run scan16; (n2) every datetime field and truncate unit, ROUND to 1
    place HALF_UP/HALF_EVEN, the replace family; (n3) the ten
    reductions, scans, quantiles under five interpolations, Spark's
    range partitioning into 200 by ``upper_bound`` and
    ``contains_column``; (n4) STRUCT pack/argsort/gather/filter/unpack.
    Every output equals the port's own CPU run byte for byte and a
    numpy oracle (integers exact, floats within 1e-9); each part's wall,
    host syncs and profile, the MIN window's peak memory and
    ``_lex_searchsorted`` alone under the profiler. That CPU run is a
    child process of this script (``--oplib-cpu-reference``) that runs
    while (n)'s calls run on the card; it sends back the SHA-256 of every
    output buffer.
(o) the shape-bucket plane — a Spark task's ragged stream of 8 batches
    of (a)'s rows (8,388,608, 4,194,305, 3,000,000, 1,048,577,
    1,048,575, 200,001, 1,025 and 1 rows: a full batch, a file's last
    partial batches, AQE-coalesced and filter-shrunk ones): (h)'s plan
    through ``table_plan_wire``, and the resident chain from_rows ->
    filter -> sort_by ss_item_sk -> LEFT SEMI join with (i1)'s category
    items -> hash partition 200 -> to_rows through ``table_upload_wire``
    + ``table_plan_resident`` (donated) + ``table_download_wire``, each
    batch exact against numpy; then the stream through
    ``table_stream_wire`` at depth 2; all once with the default bucket
    ladder and once with ``SPARK_RAPIDS_TPU_BUCKETS=off`` (equal
    5-tuples). Per batch and setting: wall and device time, the
    ``bucket.*`` and ``compile_cache.*`` counters, the tier's launches
    and declines and each kernel's launches.
(p) the formulations — BASELINE config 1 (16,000,000 rows, 10,000
    int64 keys, SUM/COUNT) with a FLOAT64 SUM through
    ``ops.groupby_aggregate`` under ``SPARK_RAPIDS_TPU_GROUPBY_FORMULATION``
    single, packed (K4b through the router) and chunked: integers equal
    numpy and each other, each FLOAT64 sum the port's CPU bytes for the
    same formulation; ``sort_table_packed`` of (e)'s batch by
    ss_item_sk against ``sort_table`` and ``inner_join_batched_packed``
    of (a)'s batch with item against ``inner_join`` (K3 sorts the packed
    words), equal bytes; each part timed and its device time profiled.
(q) plan fusion — (h)'s plan and (o)'s resident chain over (a)'s 2^23
    rows with the default ladder ([filter, cast, groupby] and [filter,
    sort_by] are fused segments) and with ``SPARK_RAPIDS_TPU_BUCKETS=off``
    (op by op): equal 5-tuples, each exact against numpy; the ``plan.*``
    counters asserted (no fallback); the host syncs inside each fused
    segment counted (at most one, its count); wall and device time.
(r) the IO layer — one Spark task's input split of TPC-DS SF100
    store_sales (2^23 rows, (a)'s distributions, INT32 keys and quantity,
    ss_item_sk NOT NULL, sorted by the sold date) written with pyarrow to a
    temporary directory (snappy, dictionary pages, 8 row groups of 2^20)
    beside item (i_item_sk NOT NULL, i_brand_id, a STRING i_brand): (r1)
    WHERE d_year = 2000 through ``io.read_parquet`` and
    ``io.scan_parquet`` with the Arrow and the device decode: the 2 row
    groups of 8 that the footer's statistics keep, the three tables equal
    (a validity of None as all valid) and equal to numpy's rows; then
    [join item, groupby i_brand_id SUM/COUNT/MIN/MAX(ss_quantity),
    to_rows] through ``plan.run_plan``, exact against numpy; (r2) the
    whole file one row group a batch through the same plan, device decode
    at prefetch 0 and 2 and the Arrow decode at prefetch 2, each batch
    exact against numpy, ``decode_row_group``'s fallback lists (none for
    the fact file, i_brand for item), the wall a batch (median of 3
    streams), the host half of the device decode a batch, the device time
    a batch of the decode and of the plan (profiler), the bytes uploaded
    still encoded against the decoded columns' and K2a/K2b/K1a's
    launches; (r3) ORC, CSV, JSON and Arrow IPC at 2^20 of the rows with
    i_brand and Avro at 2^16 written by the port and read back with the
    (r1) predicate, each equal to the Parquet read of the same rows byte
    for byte. Where pyarrow is absent, the phase says so on a line of its
    own and decodes numpy-encoded PLAIN and dictionary pages on the card
    against numpy, then round-trips Avro.
(s) the distributed tier (``spark_rapids_jni_tpu_torch.parallel``) over
    (a)'s batch as columns and item, on a mesh of every visible GPU or 4
    logical shards of one card: (s1) distributed_groupby of
    SUM/COUNT/MIN/MAX(quantity) by ss_item_sk (the skew split off on 4
    shards; on 8 it engages, with the bytes of SKEW_SPLIT=0), (s2) the
    shuffle and broadcast inner joins with item, (s3) semi and anti joins
    with (i1)'s category items, (s4) distinct ss_customer_sk, (s5)
    distributed_sort by ss_item_sk with 3 payloads, each against the
    port's single-device op (rows with exact bytes; each hash-exchanged
    row on shard pmod(murmur3(key), P)); (s6) ``run_plan`` over (h)'s
    [filter, cast] and a hash partition 200 on a ``MeshRunner``, byte
    for byte the single-device plan, then under a seeded collective fault
    that degrades the mesh to 2, and the batch's halves through
    ``run_plan_mesh_stream`` at PIPELINE 2; (s7)
    ``graft_entry.dryrun_multichip(4)``, its TPC-DS q5 step last (the
    line it prints must say ``tpcds q5 cats=N ok``).
(t) the observability tier — (h)'s plan over (a)'s 2^23-row batch with
    TRACE, FLIGHT, PROFILE, PLANSTATS, LOCKCHECK and REFCOUNT_DEBUG all
    on, against the same call with all of them off: equal bytes, equal
    ``kernel.*`` and ``plan.*`` counters and launches, one host sync in
    the fused segment; the profile session's segments equal
    ``plancheck.predict_segments`` and each segment's execute + compile +
    serde + stall equals its wall; five calls leave a stats file whose
    drift report has no segmentation finding; ``capture_trace`` of one
    call leaves a Chrome trace whose ``plan`` range holds CUDA kernels;
    ``metrics.snapshot()`` names every span; the flight ring holds the
    ``plan``/``plan.segment`` pairs under the one ``tracing.activate``
    trace id. Then (m1)'s stream at depth 2 over 4 batches with LOCKCHECK
    and FLIGHT on (equal bytes, no lock cycle or inversion; the locks
    held across ``device_dispatch`` printed), the leak report (empty; a
    kept table shows with its span stack), and a child process
    (``--telemetry-dump-child``) whose ``FLIGHT_DUMP``, ``PROFILE_DUMP``
    and ``METRICS_DUMP`` parse with their ``resident_leaks``,
    ``lockcheck`` and ``profile_sessions`` sections. Printed, not gated:
    (h)'s wall and device time off against on, median of 5 alternating
    pairs, beside the card's name and power limit.
    Each operator's wall, device time, bytes through the all-to-all and
    host syncs are printed; K5 must have launched.
(u) the serving daemon (``spark_rapids_jni_tpu_torch.serving``) on the
    card, with Spark RAPIDS users' defaults: 2 scheduler workers
    (spark.rapids.sql.concurrentGpuTasks=2), 4 sessions
    (spark.executor.cores=4). (u1) one session, then four client threads
    at once, each uploading (a)'s batch and item, running (a)'s plan with
    donate, downloading and freeing, then streaming two of (m1)'s batches
    with (h)'s plan at PIPELINE 2: every result equal to the in-process
    bridge's bytes and (a)'s and (h)'s oracles; K1b, K2a, K2b, K1a; each
    session's wall and p95 queue wait, the device busy share. (u2) typed
    refusals (over budget under a small SERVE_SESSION_HBM_FRACTION, BUSY
    at SERVE_QUEUE_DEPTH 1, a fifth hello past 4 sessions), each followed
    by a served request; a client killed with a stream in flight leaves
    the registry at its start count and the allocated memory falls back
    by its tables' bytes. (u3) DURABLE in a child process
    (``--serve-child``): the put of a donating [from_rows, filter] is
    acknowledged, the child is killed with SIGKILL, a second child
    restores (``restore.warm_compiles`` >= 1, K1b in its warm replay), the
    client resumes with its token, reads the same bytes and runs the rest
    of (a)'s plan (K2a, K2b, K1a); the checkpoint write's GB/s and the
    restore's seconds. (u4) a ``mesh=4`` session streams [filter, cast,
    partition hash 200] over (a)'s batch as columns: the single-device
    session's bytes, through the mesh path, K5 launched.
(v) the native shim — ``libspark_rapids_tpu_torch.so`` built with g++
    (its seconds printed); ``native_demo_torch`` (HOST mode) and
    ``jni_harness_torch`` on the card; then through ``utils/native.py``
    (JOIN mode) (a)'s batch [from_rows, filter, to_rows] op by op and as
    a resident chain (upload, ops, download, free), each equal to
    ``table_op_wire`` on the card and to numpy, K1b and K1a launched; the
    wall through the shim against the in-process calls.
(w) the TPC-DS query tier (``spark_rapids_jni_tpu_torch.tpcds``): (w1)
    ``datagen.generate`` at one task's 2^23 store_sales rows (from
    ``--seed``): q5, q23 and q64 on one device and on ``MESH_SHARDS``
    logical shards (``q*_distributed``, unpadded), each exact against
    pandas over the same host arrays (counts and cents sums), the mesh's
    results equal to the single device's, K5 launched in the mesh runs;
    (w2) ``streams.generate_parquet`` at SF1 (2,880,000 store_sales rows in
    6 row groups, 720,000 web_sales, 100,000 customers, 18,000 items)
    and the three streams at prefetch 2 (Parquet scan with pushdown,
    broadcast join, two-level groupby), every verdict of the JAX
    runner's oracle comparisons true (``stream_verdicts``); (w3)
    ``streams.load_tables`` of the same files through the three mesh
    queries, equal to the single-device DAGs. Each query's wall, device
    time, busy share and host syncs, K5's launches, and the host seconds
    of the generation and the oracles.
(c) kernels — each kernel against its plain version on the card, at the
    shapes of (a), (b), (d), (e) and (f), by exact equality (tolerance 0:
    every kernel computes integers and bytes), with CUDA-event times, the
    bound and, where one PyTorch call computes the same function, that
    call's time. K3 also runs keys only at (e)'s key, beside torch.sort
    of the same carrier, and K3 and K4a are held against their plain
    version on hard key classes (``sort_key_classes``) at 4 x 2^16 and at
    the one-block edges 4 x 4096 and 4 x 8192, with the digits each class
    makes the radix sort run; K4b on rows of distinct keys at 4 x 1024,
    4096, 8192 and 2^17, keys only and with two payloads; K2a, run twice,
    on hard builds (one key, (a)'s Zipf brands, one home slot that
    overflows, max_probes 2, 20 % nulls, slot counts either side of the
    shared-memory regime, 8192-row chunks, the join's 2^19 slots); K2b on
    those tables (``phase_probe_cases``: the groupby's chunks, the
    one-home-slot chain, max_probes 2, null, absent and unaligned
    queries, more chunks than the grid's y limit); K2a and K2b also at
    (i1)'s semi shapes and (k2)'s 2,000,000-key customer join. The
    registers, spills
    and shared memory that ``nvcc -Xptxas -v`` reported for each kernel
    of the build are printed first.

Every phase sets the kernels' launch counts to 0 just before its first
run (in (f): before the first run of each engine) and reads them just
after; each fails if a kernel of its path was never launched.

Output: progress lines, then one JSON line of kernel records, the
``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}`` last. Any failed phase exits nonzero
without the result line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

FACT_ROWS = 1 << 23  # one task's batch; the JAX package's largest bucket
ITEM_ROWS = 204_000  # TPC-DS SF100 item
ROWCONV_ROWS = 1 << 22
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
# Peak for the kernels' 32-bit integer operations: Hopper has half as
# many INT32 lanes per SM as FP32 lanes (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0), so half the
# data sheet's 67 TFLOP/s float32 rate outside the tensor cores
INT_OPS_PER_S = 33.5e12

FACT_TYPES = [4, 4, 4, 3, 11]  # item_sk, customer_sk, sold_date_sk, quantity, keep
PLAN = [
    {"op": "from_rows", "type_ids": FACT_TYPES, "scales": [0] * 5},
    {"op": "filter", "mask": 4},
    {"op": "join", "how": "inner", "on": [0]},
    {"op": "groupby", "by": [4],
     "aggs": [{"column": 3, "agg": a} for a in ("sum", "count", "min", "max")]},
    {"op": "to_rows"},
]
QUERY_KERNELS = ("unpack_rows", "build_table", "probe_table", "pack_rows")
FROM_FACT_ROWS = PLAN[0]
EXCHANGE_PARTITIONS = 200  # Spark's default spark.sql.shuffle.partitions
EXCHANGE_PLAN = [
    FROM_FACT_ROWS,
    {"op": "partition", "kind": "hash", "keys": [0, 1],
     "num": EXCHANGE_PARTITIONS},
    {"op": "to_rows"},
]
SORT_PLAN = [FROM_FACT_ROWS, {"op": "sort_by", "keys": [{"column": 0}]},
             {"op": "to_rows"}]
# RowConversionTest: INT64, FLOAT64, INT32, BOOL8, FLOAT32, INT8,
# DECIMAL32(-3), DECIMAL64(-8)
ROWCONV_TYPES = [4, 10, 3, 11, 9, 1, 25, 26]
ROWCONV_SCALES = [0, 0, 0, 0, 0, 0, -3, -8]
# Schemas of the transpose checks (K1a/K1b against their plain versions),
# as (type id, scale) lists: the fact batch and RowConversionTest; a
# DECIMAL128 column (two 8-byte halves) between narrow ones; INT8, BOOL8
# and INT16 columns at odd offsets; 9 and 17 columns (2 and 3 validity
# bytes); and 128 columns, the kernels' limit
_CYCLE = [(1, 0), (2, 0), (3, 0), (4, 0), (11, 0), (9, 0), (10, 0),
          (27, -2)]
TRANSPOSE_SCHEMAS = {
    "fact": [(t, 0) for t in FACT_TYPES],
    "rowconv": list(zip(ROWCONV_TYPES, ROWCONV_SCALES)),
    "decimal128": [(3, 0), (27, -4), (1, 0), (27, 0), (11, 0)],
    "narrow_odd": [(1, 0), (11, 0), (2, 0), (1, 0), (11, 0), (3, 0), (1, 0),
                   (4, 0), (11, 0)],
    "cols9": [(4, 0), (1, 0), (3, 0), (11, 0), (2, 0), (10, 0), (1, 0),
              (9, 0), (25, -2)],
    "cols17": [_CYCLE[i % 7] for i in range(17)],
    "cols128": [_CYCLE[(i * 3) % 8] for i in range(128)],
}
# row counts of the transpose checks: either side of 32 and of 256 rows
# (the kernels' tiles are multiples of 32 rows), and the bucket edges
TRANSPOSE_ROWS = (1, 31, 32, 33, 255, 257, 1023, 1024, 1025)
# on the card also a size the kernels cut into 512-row tiles (they shrink
# tiles to spread fewer rows over the SMs), the last one ragged
CARD_TRANSPOSE_ROWS = TRANSPOSE_ROWS + (2 * 132 * 512 + 1,)
# The smallest FLOAT64 input on which a torch.cumsum sum differed from the
# JAX package's (one group of 18 values), and the JAX package's sum bits
F1_ROWS = [
    59.63198219465419, 45.74272252693389, 56.12098844525571,
    34.20261247180689, 35.982419628235824, 50.43377073016518,
    46.69028133288621, 63.24105197899112, 47.04639965020695,
    32.05416904543981, 50.4039802369896, 46.83751887868299,
    51.69847399455005, 38.121552257154136, 42.02478881412041,
    50.43059145863465, 57.234759796412106, 53.94155534565769,
]
F1_SUM_BITS = 0x408AEEB78A0DF287
FLOAT_GROUPBY_ROWS = 1025
# (f): the JAX package's groupby16m_packed_pallas32 shape; the key's
# value count is also the output capacity (num_segments)
GROUPBY_ROWS = 16_000_000
GROUPBY_KEYS = 10_000
GROUPBY_CHUNK_ROWS = 1 << 17
GROUPBY_CHUNK_SEGMENTS = 1 << 14
ROUTER_CHUNK_ROWS = 1 << 18  # groupby_aggregate_packed's default
# phase-1 engine -> the kernel its run must launch
GROUPBY_ENGINES = {"lax": None, "pallas": "batched_sort_u64",
                   "pallas32": "batched_sort_u32"}
# (rows, T) of the key-class checks of K3 and K4a: a many-tile row, and the
# lengths on either side of the one-block regime (T <= 4096)
KEY_CLASS_SHAPES = ((4, 1 << 16), (4, 4096), (4, 8192))
# (g): graft_entry.query_step over a TPC-DS SF100 store_sales task batch
QS_ROWS = 1 << 23
QS_ITEMS = 204_000
QS_SUM_RTOL = 1e-9  # the sums against numpy's (another add order)
# (h): the wire plan "quantity sold a day" over (a)'s fact batch:
# Spark widens SUM's INT32 input to LONG before it aggregates
WIRE_PLAN = [
    FROM_FACT_ROWS,
    {"op": "filter", "mask": 4},
    {"op": "cast", "column": 3, "type_id": 4},
    {"op": "groupby", "by": [2],
     "aggs": [{"column": 3, "agg": a} for a in ("sum", "count", "min", "max")]},
    {"op": "sort_by", "keys": [{"column": 0}]},
    {"op": "to_rows"},
]
# the tier's kernels (h) runs: [filter, cast, groupby] is one fused
# segment (no tier inside it), and the sort's key comes out of the
# groupby with a validity vector, so packed_sort (K3) declines in both
# packages; op by op (BUCKETS=off) the groupby runs K2a too
WIRE_KERNELS = ("unpack_rows", "pack_rows")
WIRE_OFF_KERNELS = ("unpack_rows", "build_table", "pack_rows")
FLAT_ROWS = 1 << 20  # (h)'s second run: a legacy flat UINT8 buffer


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# data, made with numpy from the seed
# ---------------------------------------------------------------------------


def make_query_data(rng, n: int, n_items: int) -> dict:
    d = {
        "item_sk": (rng.zipf(1.3, n) % n_items).astype(np.int64),
        "customer_sk": rng.integers(1, 2_000_001, n).astype(np.int64),
        "customer_ok": rng.random(n) > 0.03,
        "date_sk": rng.integers(2_450_816, 2_452_642, n).astype(np.int64),
        "quantity": rng.integers(1, 101, n).astype(np.int32),
        "quantity_ok": rng.random(n) > 0.03,
        "keep": rng.random(n) < 1 / 3,
        "i_item_sk": np.arange(n_items, dtype=np.int64),
        "i_brand_id": rng.integers(1_001_001, 1_002_001, n_items).astype(np.int32),
        "i_category_id": rng.integers(1, 11, n_items).astype(np.int32),
    }
    rows = np.zeros((n, 32), np.uint8)
    for off, key in ((0, "item_sk"), (8, "customer_sk"), (16, "date_sk"),
                     (24, "quantity")):
        a = d[key]
        rows[:, off:off + a.itemsize] = a.view(np.uint8).reshape(n, a.itemsize)
    rows[:, 28] = d["keep"]
    rows[:, 29] = (1 | (d["customer_ok"].astype(np.uint8) << 1) | 4
                   | (d["quantity_ok"].astype(np.uint8) << 3) | 16)
    d["rows"] = rows
    offs = (np.arange(n + 1, dtype=np.int64) * 32).astype(np.int32)
    d["fact_wire"] = ([24], [5], [offs.tobytes() + rows.tobytes()], [None], n)
    d["item_wire"] = (
        [4, 3, 3], [0, 0, 0],
        [d["i_item_sk"].tobytes(), d["i_brand_id"].tobytes(),
         d["i_category_id"].tobytes()],
        [None] * 3, n_items,
    )
    return d


def query_oracle(d: dict) -> dict:
    """The same SQL in numpy: WHERE keep, JOIN item USING (item_sk),
    GROUP BY i_brand_id: SUM/COUNT/MIN/MAX(ss_quantity), nulls skipped."""
    m = d["keep"]
    brand = d["i_brand_id"][d["item_sk"][m]]  # item_sk == row index
    qty = d["quantity"][m].astype(np.int64)
    ok = d["quantity_ok"][m]
    groups, inv = np.unique(brand, return_inverse=True)
    g = groups.shape[0]
    count = np.bincount(inv[ok], minlength=g).astype(np.int64)
    total = np.zeros(g, np.int64)
    np.add.at(total, inv[ok], qty[ok])
    lo = np.full(g, np.iinfo(np.int64).max)
    hi = np.full(g, np.iinfo(np.int64).min)
    np.minimum.at(lo, inv[ok], qty[ok])
    np.maximum.at(hi, inv[ok], qty[ok])
    return {"brand": groups, "sum": total, "count": count, "min": lo,
            "max": hi, "has": count > 0, "filtered_rows": int(m.sum())}


def check_query_result(wire, want: dict) -> int:
    """Decode the downloaded packed rows and compare with the oracle."""
    type_ids, scales, datas, valids, nrows = wire
    if type_ids != [24] or scales != [5] or valids != [None]:
        raise AssertionError(f"unexpected result schema {type_ids} {scales}")
    g = want["brand"].shape[0]
    if nrows != g:
        raise AssertionError(f"{nrows} groups, oracle has {g}")
    offs = np.frombuffer(datas[0], np.int32, nrows + 1)
    if not np.array_equal(offs, np.arange(nrows + 1) * 40):
        raise AssertionError("result rows are not 40 bytes each")
    rows = np.frombuffer(datas[0], np.uint8, offset=4 * (nrows + 1)).reshape(g, 40)
    brand = rows[:, 0:4].copy().view(np.int32)[:, 0]
    total = rows[:, 8:16].copy().view(np.int64)[:, 0]
    count = rows[:, 16:24].copy().view(np.int64)[:, 0]
    lo = rows[:, 24:28].copy().view(np.int32)[:, 0]
    hi = rows[:, 28:32].copy().view(np.int32)[:, 0]
    bits = rows[:, 32]
    has = want["has"]
    checks = {
        "brand": np.array_equal(brand, want["brand"]),
        "count": np.array_equal(count, want["count"]),
        "sum": np.array_equal(total[has], want["sum"][has]),
        "min": np.array_equal(lo[has], want["min"][has]),
        "max": np.array_equal(hi[has], want["max"][has]),
        "validity": np.array_equal(
            bits, 1 | 4 | (has.astype(np.uint8) * (2 | 8 | 16))),
        "padding": not rows[:, 4:8].any() and not rows[:, 33:].any(),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"query result differs from the oracle: {bad}")
    return g


def _rotl32(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _mix_k1(k1):
    return _rotl32(k1 * np.uint32(0xCC9E2D51), 15) * np.uint32(0x1B873593)


def _mix_h1(h1, k1):
    return _rotl32(h1 ^ k1, 13) * np.uint32(5) + np.uint32(0xE6546B64)


def murmur3_long_np(values: np.ndarray, valid, h: np.ndarray) -> np.ndarray:
    """Spark's Murmur3_x86_32.hashLong of int64 ``values`` with the running
    hash ``h`` as seed, in numpy uint32; null rows keep ``h``."""
    u = values.view(np.uint64)
    h1 = _mix_h1(h, _mix_k1((u & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
    h1 = _mix_h1(h1, _mix_k1((u >> np.uint64(32)).astype(np.uint32)))
    h1 = h1 ^ np.uint32(8)
    h1 = h1 ^ (h1 >> np.uint32(16))
    h1 = h1 * np.uint32(0x85EBCA6B)
    h1 = h1 ^ (h1 >> np.uint32(13))
    h1 = h1 * np.uint32(0xC2B2AE35)
    h1 = h1 ^ (h1 >> np.uint32(16))
    return h1 if valid is None else np.where(valid, h1, h)


def exchange_oracle(d: dict) -> np.ndarray:
    """Rows of (d): Spark's Pmod(Murmur3Hash(item_sk, customer_sk), 200)
    with seed 42, then a stable argsort by partition id."""
    h = np.full(d["item_sk"].shape[0], 42, np.uint32)
    h = murmur3_long_np(d["item_sk"], None, h)
    h = murmur3_long_np(d["customer_sk"], d["customer_ok"], h)
    pid = np.mod(h.view(np.int32).astype(np.int64), EXCHANGE_PARTITIONS)
    return d["rows"][np.argsort(pid, kind="stable")]


def sort_oracle(d: dict) -> np.ndarray:
    """Rows of (e): a stable argsort by item_sk."""
    return d["rows"][np.argsort(d["item_sk"], kind="stable")]


def make_groupby_data(rng, n: int, n_keys: int) -> dict:
    """(f)'s table: key uniform on [0, n_keys), value on [-1000, 1000)."""
    return {"k": rng.integers(0, n_keys, n, dtype=np.int64),
            "v": rng.integers(-1000, 1000, n, dtype=np.int64)}


def groupby_oracle(d: dict) -> dict:
    """SELECT k, SUM(v), COUNT(v) GROUP BY k ORDER BY k, in numpy (the
    float64 bincount of int64 weights is exact below 2^53)."""
    count = np.bincount(d["k"])
    total = np.bincount(d["k"], weights=d["v"])
    keys = np.flatnonzero(count)
    return {"k": keys, "sum": total[keys].astype(np.int64),
            "count": count[keys].astype(np.int64)}


def groupby_rows(table, g: int) -> dict:
    """The first ``g`` rows of a groupby result, on the host."""
    return {n: c.data[:g].cpu().numpy() for n, c in zip(table.names,
                                                         table.columns)}


def check_groupby(got: dict, want: dict, what: str) -> None:
    bad = [n for n, w in (("k", want["k"]), ("sum_v", want["sum"]),
                          ("count_v", want["count"]))
           if got[n].dtype != np.int64 or not np.array_equal(got[n], w)]
    if bad:
        raise AssertionError(f"{what} differs from the numpy oracle: {bad}")


def check_rows(wire, want: np.ndarray) -> None:
    """The downloaded LIST<UINT8> packed rows must equal ``want`` byte for
    byte."""
    type_ids, scales, datas, valids, nrows = wire
    n, size = want.shape
    if type_ids != [24] or scales != [5] or valids != [None] or nrows != n:
        raise AssertionError(f"unexpected result {type_ids} {scales} {nrows}")
    offs = (np.arange(n + 1, dtype=np.int64) * size).astype(np.int32)
    if datas[0] != offs.tobytes() + want.tobytes():
        got = np.frombuffer(datas[0], np.uint8, offset=4 * (n + 1))
        bad = np.flatnonzero(got != want.reshape(-1))
        raise AssertionError(
            f"rows differ from the oracle at {bad.shape[0]} bytes, first "
            f"at row {bad[0] // size if bad.shape[0] else 'offsets'}")


def make_rowconv_wire(rng, n: int):
    cols = [
        rng.integers(-2**62, 2**62, n).astype(np.int64),
        rng.standard_normal(n) * 1e6,
        rng.integers(-2**31, 2**31, n).astype(np.int32),
        (rng.random(n) > 0.5).astype(np.uint8),
        rng.standard_normal(n).astype(np.float32),
        rng.integers(-128, 128, n).astype(np.int8),
        rng.integers(-10**8, 10**8, n).astype(np.int32),
        rng.integers(-10**15, 10**15, n).astype(np.int64),
    ]
    valids = []
    for i in range(len(cols)):
        v = rng.random(n) > 0.1
        v[n - 1 - i:] = False  # trailing nulls in every column
        valids.append(v.astype(np.uint8).tobytes())
    return (list(ROWCONV_TYPES), list(ROWCONV_SCALES),
            [c.tobytes() for c in cols], valids, n)


def transpose_inputs(rng, widths, n: int):
    """Column byte matrices of ``widths`` and an (n, cols) 0/1 validity
    matrix with nulls everywhere and in the last rows, in numpy."""
    cols = [rng.integers(0, 256, (n, w), dtype=np.uint8) for w in widths]
    valid = (rng.random((n, len(widths))) > 0.3).astype(np.uint8)
    valid[-3:] = 0
    return cols, valid


def sort_key_classes(rng, c: int, t: int) -> dict:
    """Hard inputs of the u64 sorts K3 and K4a: (c, t) uint64 keys by class
    name. Each class varies in a known set of bytes (the radix sort's
    digits) and repeats keys, so a wrong digit plan, a lost pass or an
    unstable rank shows as a wrong key or perm."""
    m64 = np.uint64(2**64 - 1)

    def base():
        return rng.integers(0, 2**64, dtype=np.uint64, endpoint=False)

    def in_byte(byte: int, k=None):
        k = np.full((c, t), base(), np.uint64) if k is None else k
        shift = np.uint64(8 * byte)
        v = rng.integers(0, 256, (c, t)).astype(np.uint64) << shift
        return (k & (m64 ^ (np.uint64(0xFF) << shift))) | v

    pool = rng.integers(0, 2**64, max(t // 4, 2), dtype=np.uint64)
    top = np.full((c, t), base() & np.uint64(2**63 - 1), np.uint64)
    top |= rng.integers(0, 2, (c, t)).astype(np.uint64) << np.uint64(63)
    # rows whose varying digits differ; the last is packed as (f) packs its
    # words, (rel << log2 t) | iota, with all-ones words in its tail
    mixed = np.empty((c, t), np.uint64)
    bits = np.uint64(t.bit_length() - 1)
    for r in range(c - 1):
        kind = r % 3
        if kind == 0:
            mixed[r] = in_byte(1)[r]
        elif kind == 1:
            mixed[r] = in_byte(6, in_byte(0))[r]
        else:
            mixed[r] = base()
    rel = rng.integers(0, 10_000, t).astype(np.uint64)
    mixed[c - 1] = (rel << bits) | np.arange(t, dtype=np.uint64)
    mixed[c - 1, t - t // 3:] = m64
    return {
        "all_equal": np.full((c, t), base(), np.uint64),
        "byte0": in_byte(0), "byte3": in_byte(3), "byte7": in_byte(7),
        "top_bit": top,
        "random_repeats": pool[rng.integers(0, pool.shape[0], (c, t))],
        "mixed_rows_padded": mixed,
    }


def distinct_u32_rows(rng, c: int, t: int) -> np.ndarray:
    """(c, t) uint32 rows of keys distinct within each row, as the packed
    groupby makes its words: random high bits over an embedded iota, with
    the top bit alone and the all-ones word among them."""
    ib = t.bit_length() - 1
    high = rng.integers(0, 2 ** (32 - ib), (c, t), dtype=np.uint64)
    high[:, -1] = 2 ** (32 - ib) - 1
    high[:, 0] = 2 ** (31 - ib)
    iota = np.arange(t, dtype=np.uint64)
    return ((high << np.uint64(ib)) | iota).astype(np.uint32)


def hash_word_np(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """The hash table's slot hash of the u64 word (hi << 32 | lo) in numpy
    uint32: fmix32 of lo ^ hi * 0x9E3779B9."""
    h = lo ^ (hi * np.uint32(0x9E3779B9))
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def one_home_keys(rng, t: int, s: int):
    """``t`` distinct u64 keys, as (lo, hi) uint32 arrays, that all hash to
    home slot 0 of a table of ``s`` slots: a build of them places one key
    a round and overflows the rest at its probe bound."""
    found, need = [], t
    while need > 0:
        w = rng.integers(0, 2**64, 1 << 22, dtype=np.uint64, endpoint=False)
        lo = (w & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (w >> np.uint64(32)).astype(np.uint32)
        w = w[(hash_word_np(lo, hi) & np.uint32(s - 1)) == 0]
        found.append(w)
        need -= w.shape[0]
    w = rng.permutation(np.unique(np.concatenate(found)))[:t]
    return ((w & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (w >> np.uint64(32)).astype(np.uint32))


def active_digits(key_bits: torch.Tensor) -> torch.Tensor:
    """(C, D) bool: the 8-bit digits (byte 0 lowest) in which some key of
    each row of ``key_bits`` (u64 bits in int64, D = 8, or u32 bits in
    int32, D = 4) differs from the row's first key — the passes the radix
    sort makes; a row of equal keys makes one, on digit 0."""
    c, t = key_bits.shape
    x = (key_bits ^ key_bits[:, :1]).contiguous().view(torch.uint8)
    act = (x.reshape(c, t, key_bits.element_size()) != 0).any(dim=1)
    act[:, 0] |= ~act.any(dim=1)
    return act


def radix_sort_ops(key_bits: torch.Tensor, index: bool = True) -> int:
    """Integer operations the radix sort (K3, K4a, K4b) does on these keys.
    T <= 4096: the bitonic network, T log2 T compare-exchanges a row at 5
    each where an index rides (the (key, index) compare and its selects),
    at 2 for K4b keys only (one u32 min and max). Above: the plan, 2 + 2 D
    a key for D digits (the XOR and OR of the varying bits, D digit
    extractions and counts: 18 for a u64, 10 for a u32), and 7 a key for
    each pass a row makes (the digit, its count, its rank, the scatter
    address)."""
    c, t = key_bits.shape
    if t <= 4096:
        return (5 if index else 2) * c * t * max(t.bit_length() - 1, 1)
    passes = int(active_digits(key_bits).sum())
    return (2 + 2 * key_bits.element_size()) * c * t + 7 * t * passes


def digits_str(key_bits: torch.Tensor) -> str:
    """The rows' active digits, as distinct lists with their row counts."""
    act = active_digits(key_bits).cpu().numpy()
    rows = {}
    for a in act:
        k = str(np.flatnonzero(a).tolist())
        rows[k] = rows.get(k, 0) + 1
    return ", ".join(f"{k} x{n}" for k, n in rows.items())


# ---------------------------------------------------------------------------
# timing and kernel records
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    """Largest absolute difference over every output tensor (as int64);
    shapes and dtypes must match."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"output {tuple(g.shape)} {g.dtype} vs "
                                 f"{tuple(w.shape)} {w.dtype}")
        if g.numel():
            d = (g.to(torch.int64) - w.to(torch.int64)).abs().max()
            # a difference of 2^63 wraps to a negative abs: count it as 1
            err = max(err, int(d), int(bool((g != w).any())))
    return err


def transpose_bytes(layout, n: int) -> int:
    """Bytes a row transpose must move: the column bytes and the 0/1
    validity bytes on one side, the packed rows on the other."""
    return n * (sum(layout.column_widths) + len(layout.column_widths)
                + layout.row_size)


def queued_ms(fn, reps: int = 20) -> float:
    """Mean CUDA-event time a call of ``fn`` over ``reps`` calls queued back
    to back, after one warm-up call: once the host runs ahead of the
    device, the device's time a call, without the host's share that the
    per-call ``cuda_ms`` includes and that varies between calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def ahead_ms(fn, reps: int = 20):
    """(device, host) ms a call of ``fn`` over ``reps`` calls enqueued
    while the stream waits behind a sleep kernel: CUDA events around the
    calls, which run back to back once the sleep ends, give the device's
    own time a call whatever the wrapper's host work (``queued_ms`` reads
    the host's pace where that work is the longer); the host clock around
    the enqueue gives the host's time a call. The sleep grows until it
    outlasts the enqueue; device is None when it never did (a wrapper
    that synchronises)."""
    fn()
    torch.cuda.synchronize()
    cycles = 2_000_000  # about 1 ms at the H100's clocks
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / reps
        late = start.query()  # the sleep ended before the last enqueue
        stop.record()
        stop.synchronize()
        if not late:
            return start.elapsed_time(stop) / reps, host
        cycles *= 4
    return None, host


def kernel_record(info, tag: str, shape: str, launches: int, kernel_fn,
                  plain_fn, nbytes: int, nops: int, reps: int = 20,
                  library_fn=None, note: str = "") -> dict:
    """Compare a kernel with its plain version on the same inputs, time
    both (and ``library_fn``, one PyTorch call computing the same
    function, where there is one), and return its record for the kernels
    line: ``ms`` a call, ``queued_ms`` a call queued back to back,
    ``ahead_ms`` and ``host_ms`` the device's and the host's time a call
    (see :func:`ahead_ms`)."""
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    ms = cuda_ms(kernel_fn, reps)
    ahead, host = ahead_ms(kernel_fn, reps)
    times = {"queued_ms": queued_ms(kernel_fn, reps), "ahead_ms": ahead,
             "host_ms": host}
    plain_ms = cuda_ms(plain_fn, 3)
    library_ms = None if library_fn is None else cuda_ms(library_fn, reps)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / INT_OPS_PER_S * 1e3
    rec = {
        "name": f"{info.name}/{tag}", "route": "cuda", "source": info.source,
        "replaces": info.replaces, "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms, "shape": shape, "bytes": nbytes,
    }
    if note:
        rec["note"] = note
    rec.update(times)
    lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
    lib += "".join(f", {k} {v:.4f}" if v is not None else f", {k} None"
                   for k, v in times.items())
    log(f"(c) {rec['name']} {shape}: max_abs_err={err} kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms{lib}"
        + (f" ({note})" if note else ""))
    if err:
        raise AssertionError(f"{rec['name']} disagrees with its plain version")
    return rec


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_query(rb, kernels, d: dict) -> dict:
    want = query_oracle(d)
    fid = rb.table_upload_wire(*d["fact_wire"], device=DEVICE)
    iid = rb.table_upload_wire(*d["item_wire"], device=DEVICE)
    plan = json.dumps(PLAN)
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = rb.table_plan_resident(plan, [fid, iid])
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kernels.KERNELS.items()}
    groups = check_query_result(rb.table_download_wire(out), want)
    rb.table_free(out)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = rb.table_plan_resident(plan, [fid, iid])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        rb.table_free(out)
    log(f"(a) query: {groups} groups from {want['filtered_rows']} filtered "
        f"rows match the numpy oracle; plan median {statistics.median(times):.2f} ms "
        f"over {len(times)} runs (all: {[round(t, 2) for t in times]}); "
        f"launches {launches}")
    profile = profile_plan(plan_runner(rb, plan, [fid, iid]),
                           statistics.median(times), "(a)")
    rb.table_free(fid)
    rb.table_free(iid)
    missing = [k for k in QUERY_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"the query never launched {missing}")
    return {"launches": launches, "groups": groups,
            "filtered_rows": want["filtered_rows"],
            "plan_ms": statistics.median(times), "profile": profile}


def plan_runner(rb, plan: str, ids):
    """One run of ``plan`` over the resident tables ``ids``: synchronised,
    its result freed."""
    def run():
        out = rb.table_plan_resident(plan, ids)
        torch.cuda.synchronize()
        rb.table_free(out)

    return run


def device_events(prof) -> list:
    """The kernel, memcpy and memset entries of a ``torch.profiler``
    capture's ``key_averages()``. A ``record_function`` range (under
    ``TRACE``) also becomes a user annotation on the device's timeline
    that spans the kernels launched inside it; those entries are left
    out, so no device time is counted twice."""
    from torch.autograd import DeviceType

    avg = prof.key_averages()
    cpu = {e.key for e in avg if e.device_type == DeviceType.CPU}
    return [e for e in avg if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.key not in cpu]


def profile_plan(run, wall_ms: float, tag: str, runs: int = 5) -> dict:
    """A steady window of ``runs`` calls of ``run`` (one run that ends in a
    synchronise) under ``torch.profiler``, each timed as the unprofiled
    runs are: device time by kernel name per run, and the device's busy
    share. The profiler adds host time to every launch, so the share is
    taken against ``wall_ms``, the unprofiled median wall of the same run
    in this call; the profiled wall is kept beside it. Kernel time is
    summed, so overlapping kernels would count twice; each run is on one
    stream. Beside the top 12 kernels, every hand-written kernel gets a
    line by name (0 where the run did not launch it)."""
    from torch.profiler import ProfilerActivity, profile

    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            t0 = time.perf_counter()
            run()
            walls.append((time.perf_counter() - t0) * 1e3)
    # device-side events only: a CPU op's entry repeats its kernels' time
    events = [e for e in device_events(prof) if e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / runs
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)
    top = [{"name": e.key[:80], "calls_per_run": e.count / runs,
            "device_ms_per_run": e.self_device_time_total / 1e3 / runs}
           for e in top[:12]]
    own = {}
    for name in csrc_functions():
        hits = [e for e in events
                if re.match(rf"(?:void\s+)?(?:\(anonymous namespace\)::)?"
                            rf"{name}\s*[<(]", e.key)]
        own[name] = {
            "calls_per_run": sum(e.count for e in hits) / runs,
            "device_ms_per_run":
                sum(e.self_device_time_total for e in hits) / 1e3 / runs}
    profiled_ms = statistics.median(walls)
    log(f"{tag} profiled window of {runs} runs: device busy {device_ms:.3f} ms "
        f"a run = {100 * device_ms / wall_ms:.1f} % of the unprofiled "
        f"{wall_ms:.2f} ms wall ({100 * device_ms / profiled_ms:.1f} % of the "
        f"profiled {profiled_ms:.2f} ms)")
    for t in top:
        log(f"    {t['device_ms_per_run']:8.3f} ms  x{t['calls_per_run']:<6g} "
            f"{t['name']}")
    for name, t in own.items():
        log(f"    {t['device_ms_per_run']:8.4f} ms  x{t['calls_per_run']:<6g} "
            f"{name} (hand-written)")
    return {"runs": runs, "wall_ms": wall_ms, "profiled_wall_ms": profiled_ms,
            "device_ms": device_ms, "busy_share": device_ms / wall_ms,
            "top": top, "hand_written": own}


def csrc_functions() -> list:
    """The name of every hand-written device kernel (each ``__global__``
    function of the port's ``csrc/``), for the profiles' by-name lines."""
    from spark_rapids_jni_tpu_torch import kernels

    names = []
    for p in sorted(kernels.CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            names += re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                r"(\w+)\s*\(", p.read_text())
    return names


def phase_rowconv(rb, kernels, wire) -> dict:
    tid = rb.table_upload_wire(*wire, device=DEVICE)
    plan = json.dumps([
        {"op": "to_rows"},
        {"op": "from_rows", "type_ids": ROWCONV_TYPES, "scales": ROWCONV_SCALES},
    ])
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = rb.table_plan_resident(plan, [tid])
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kernels.KERNELS.items()}
    back = rb.table_download_wire(out)
    rb.table_free(out)
    if tuple(back) != tuple(wire):
        raise AssertionError("row conversion round trip changed the bytes")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = rb.table_plan_resident(plan, [tid])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        rb.table_free(out)
    median = statistics.median(times)
    log(f"(b) row conversion: {wire[4]} rows round-trip exact; plan median "
        f"{median:.2f} ms (all: {[round(t, 2) for t in times]}); launches "
        f"{launches}")
    profile = profile_plan(plan_runner(rb, plan, [tid]), median, "(b)")
    rb.table_free(tid)
    for k in ("pack_rows", "unpack_rows"):
        if launches[k] == 0:
            raise AssertionError(f"row conversion never launched {k}")
    return {"launches": launches, "plan_ms": median, "profile": profile}


def phase_rows_plan(rb, kernels, tag: str, plan_ops, wire, want: np.ndarray,
                    needs) -> dict:
    """Phases (d) and (e): one plan over the uploaded fact batch whose
    packed-row result must equal ``want``; ``needs`` names the kernels
    the run must have launched."""
    tid = rb.table_upload_wire(*wire, device=DEVICE)
    plan = json.dumps(plan_ops)
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = rb.table_plan_resident(plan, [tid])
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kernels.KERNELS.items()}
    check_rows(rb.table_download_wire(out), want)
    rb.table_free(out)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = rb.table_plan_resident(plan, [tid])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        rb.table_free(out)
    median = statistics.median(times)
    log(f"{tag} {want.shape[0]} rows match the numpy oracle; plan median "
        f"{median:.2f} ms over {len(times)} runs (all: "
        f"{[round(t, 2) for t in times]}); launches {launches}")
    profile = profile_plan(plan_runner(rb, plan, [tid]), median, tag)
    rb.table_free(tid)
    missing = [k for k in needs if launches[k] == 0]
    if missing:
        raise AssertionError(f"{tag} never launched {missing}")
    return {"launches": launches, "plan_ms": median, "profile": profile}


def phase_groupby(kernels, g: dict) -> dict:
    """(f): the packed two-level groupby under each phase-1 engine, on a
    table uploaded to the card, against the numpy oracle and each other."""
    from spark_rapids_jni_tpu_torch.column import Table
    from spark_rapids_jni_tpu_torch.ops import groupby_packed as gp
    from spark_rapids_jni_tpu_torch.ops.groupby import GroupbyAgg

    want = groupby_oracle(g)
    t = Table.from_pydict({"k": g["k"], "v": g["v"]}, device=DEVICE)
    aggs = [GroupbyAgg("v", "sum"), GroupbyAgg("v", "count")]

    def runner(engine):
        def run():
            out = gp.groupby_aggregate_packed_chunked(
                t, ["k"], aggs, num_segments=GROUPBY_KEYS,
                chunk_rows=GROUPBY_CHUNK_ROWS,
                chunk_segments=GROUPBY_CHUNK_SEGMENTS, engine=engine)
            torch.cuda.synchronize()
            return out

        return run

    res = {"launches": {}, "plan_ms": {}}
    first = None
    for engine, needs in GROUPBY_ENGINES.items():
        run = runner(engine)
        torch.cuda.synchronize()
        kernels.reset_launches()
        out, num_groups, max_chunk, overflow = run()
        launches = {k: v.launches for k, v in kernels.KERNELS.items()}
        ng, mc = int(num_groups), int(max_chunk)
        if bool(overflow) or mc > GROUPBY_CHUNK_SEGMENTS or ng != want["k"].size:
            raise AssertionError(
                f"(f) {engine}: overflow {bool(overflow)}, max_chunk {mc}, "
                f"{ng} groups for {want['k'].size} distinct keys")
        rows = groupby_rows(out, ng)
        check_groupby(rows, want, f"(f) {engine}")
        if first is None:
            first = rows
        elif any(rows[n].tobytes() != first[n].tobytes() for n in first):
            raise AssertionError(f"(f) {engine} differs from the lax engine")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3)
        res["launches"][engine] = launches
        res["plan_ms"][engine] = statistics.median(times)
        log(f"(f) groupby {engine}: {ng} groups of {GROUPBY_ROWS} rows match "
            f"the numpy oracle, max_chunk {mc}; median "
            f"{res['plan_ms'][engine]:.2f} ms over {len(times)} runs (all: "
            f"{[round(x, 2) for x in times]}); launches {launches}")
        if needs is not None and launches[needs] == 0:
            raise AssertionError(f"(f) {engine} never launched {needs}")
    eager = gp.groupby_aggregate_packed(t, ["k"], aggs,
                                        chunk_rows=ROUTER_CHUNK_ROWS)
    if eager is None:
        raise AssertionError("(f) the eager router declined the shape")
    check_groupby(groupby_rows(eager, eager.row_count), want, "(f) router")
    log(f"(f) eager router: {eager.row_count} groups match the numpy oracle")
    res["profile"] = {e: profile_plan(runner(e), res["plan_ms"][e], f"(f) {e}")
                      for e in GROUPBY_ENGINES}
    res["table"] = t
    return res


def key_halves(values: np.ndarray, d_type):
    """The (1, n) int32 lo/hi halves of a column's order words on the card,
    as the registry's hash builds take them."""
    from spark_rapids_jni_tpu_torch.column import Column
    from spark_rapids_jni_tpu_torch.ops import keys

    col = Column(torch.from_numpy(values).to(DEVICE), d_type)
    lo, hi = keys.split_u32(keys.column_order_keys(col)[0])
    return lo[None, :].contiguous(), hi[None, :].contiguous()


def brand_chunks(d: dict, t: int):
    """The groupby build of (a): the brand of every filtered row, as (C, t)
    lo/hi halves and valid flags, the padding rows of the last chunk
    invalid — the registry's chunked hash groupby's input."""
    from spark_rapids_jni_tpu_torch import dtype as dt

    brand = d["i_brand_id"][d["item_sk"][d["keep"]]]
    n = brand.shape[0]
    c = -(-n // t)

    def chunked(x):
        return torch.nn.functional.pad(x[0], (0, c * t - n)).reshape(c, t)

    lo, hi = key_halves(brand, dt.INT32)
    ones = torch.ones((1, n), dtype=torch.int32, device=DEVICE)
    return chunked(lo), chunked(hi), chunked(ones)


def phase_kernels(d: dict, qa: dict, qb: dict, qd: dict, qe: dict,
                  qf: dict) -> list:
    from spark_rapids_jni_tpu_torch import dtype as dt
    from spark_rapids_jni_tpu_torch import rows
    from spark_rapids_jni_tpu_torch.column import Column
    from spark_rapids_jni_tpu_torch.kernels import bitonic_sort as bs
    from spark_rapids_jni_tpu_torch.kernels import hash_table as ht
    from spark_rapids_jni_tpu_torch.kernels import hashing as kh
    from spark_rapids_jni_tpu_torch.kernels import registry
    from spark_rapids_jni_tpu_torch.kernels import row_transpose as rt
    from spark_rapids_jni_tpu_torch.ops import groupby_packed as gp
    from spark_rapids_jni_tpu_torch.ops import keys

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    la, lb = qa["launches"], qb["launches"]
    recs = []

    def pack_record(tag, layout, n, launches, note=""):
        """K1a as ``rows._pack`` calls it: a validity vector a column."""
        col_bytes = [torch.randint(0, 256, (n, w), dtype=torch.uint8,
                                   device=dev, generator=gen)
                     for w in layout.column_widths]
        vecs = [torch.randint(0, 2, (n,), dtype=torch.uint8, device=dev,
                              generator=gen) != 0 for _ in col_bytes]
        return kernel_record(
            rt.PACK, tag, f"{n}x{layout.row_size}B", launches,
            lambda: [rt.pack_rows_columns(col_bytes, vecs, layout)],
            lambda: [rt.pack_rows_columns_plain(col_bytes, vecs, layout)],
            transpose_bytes(layout, n), n * layout.row_size, note=note)

    def unpack_record(tag, layout, src, launches, note=""):
        """K1b as ``rows.from_rows`` calls it: a validity vector a column
        and null counts."""
        def columns(fn):
            cols, vecs, nulls = fn(src, layout)
            return [*cols, *vecs, nulls]

        return kernel_record(
            rt.UNPACK, tag, f"{src.shape[0]}x{layout.row_size}B", launches,
            lambda: columns(rt.unpack_rows_columns),
            lambda: columns(rt.unpack_rows_columns_plain),
            transpose_bytes(layout, src.shape[0]),
            src.shape[0] * layout.row_size, note=note)

    # K1b at the query's input batch, K1a at its ~1000-row output
    fact_layout = rows.compute_fixed_width_layout(
        [dt.DType(dt.TypeId(t)) for t in FACT_TYPES])
    recs.append(unpack_record(
        "query", fact_layout, torch.from_numpy(d["rows"]).to(dev),
        la["unpack_rows"],
        note="(d) and (e) each launch it once more at this shape"))
    out_layout = rows.compute_fixed_width_layout(
        [dt.INT32, dt.INT64, dt.INT64, dt.INT32, dt.INT32])
    recs.append(pack_record("query", out_layout, qa["groups"],
                            la["pack_rows"]))
    recs.append(pack_record(
        "exchange", fact_layout, FACT_ROWS, qd["launches"]["pack_rows"],
        note=f"the launch count is (d)'s, (e) launches it "
             f"{qe['launches']['pack_rows']} time(s) at this shape too"))

    # K2a + K2b: the join's build over item keys, its probe with the
    # filtered fact keys, and the groupby's chunked build over brands
    m = d["keep"]
    blo, bhi = key_halves(d["i_item_sk"], dt.INT64)
    bval = torch.ones_like(blo)
    slots = 2 * registry._next_pow2(blo.shape[1])
    built = ht.build_table(blo, bhi, bval, table_slots=slots)
    nb, ns = blo.shape[1], slots
    rounds = build_rounds(blo, bhi, bval, built, slots, ht.MAX_PROBES)
    recs.append(kernel_record(
        ht.BUILD, "join", f"1x{nb} keys, {ns} slots", la["build_table"],
        lambda: ht.build_table(blo, bhi, bval, table_slots=slots),
        lambda: ht.build_table_plain(blo, bhi, bval, table_slots=slots),
        12 * nb + 4 * nb + 12 * ns + 8, 20 * nb,
        note=f"regime {ht.build_regime(nb, ns)}, {rounds} probe rounds"))
    plo, phi = key_halves(d["item_sk"][m], dt.INT64)
    pval = torch.ones_like(plo)
    npb = plo.shape[1]
    tables = built[1:4]
    recs.append(kernel_record(
        ht.PROBE, "join", f"1x{npb} keys, {ns} slots", la["probe_table"],
        lambda: ht.probe_table(plo, phi, pval, *tables),
        lambda: ht.probe_table_plain(plo, phi, pval, *tables),
        12 * npb + 12 * ns + 8 * npb + 4, 20 * npb))
    t = registry.GROUPBY_CHUNK_ROWS
    glo, ghi, gval = brand_chunks(d, t)
    c = glo.shape[0]
    gs = 2 * t
    gbuilt = ht.build_table(glo, ghi, gval, table_slots=gs)
    rounds = build_rounds(glo, ghi, gval, gbuilt, gs, ht.MAX_PROBES)
    recs.append(kernel_record(
        ht.BUILD, "groupby", f"{c}x{t} keys, {c}x{gs} slots",
        la["build_table"],
        lambda: ht.build_table(glo, ghi, gval, table_slots=gs),
        lambda: ht.build_table_plain(glo, ghi, gval, table_slots=gs),
        16 * c * t + 12 * c * gs + 8, 20 * c * t,
        note=f"regime {ht.build_regime(t, gs)}, {rounds} probe rounds "
             "(the slowest chunk's)"))

    # K1a + K1b at the row-conversion shape
    rc_layout = rows.compute_fixed_width_layout(
        [dt.DType(dt.TypeId(ti), s) for ti, s in zip(ROWCONV_TYPES, ROWCONV_SCALES)])
    recs.append(pack_record("rowconv", rc_layout, ROWCONV_ROWS,
                            lb["pack_rows"]))
    src = rt.pack_rows(
        [torch.randint(0, 256, (ROWCONV_ROWS, w), dtype=torch.uint8,
                       device=dev, generator=gen)
         for w in rc_layout.column_widths],
        torch.randint(0, 2, (ROWCONV_ROWS, len(ROWCONV_TYPES)),
                      dtype=torch.uint8, device=dev, generator=gen),
        rc_layout)
    recs.append(unpack_record("rowconv", rc_layout, src, lb["unpack_rows"]))

    # K5 at the exchange's keys: item_sk, and customer_sk with its nulls.
    # Bytes: the keys, one validity byte, 4 B of output a row. Operations:
    # 11 a u32 word (mix_k1 + mix_h1) and 10 a column (finalizer, select).
    def on_dev(a):
        return torch.from_numpy(a).to(dev)

    n = FACT_ROWS
    hcols = [Column(on_dev(d["item_sk"]), dt.INT64),
             Column(on_dev(d["customer_sk"]), dt.INT64,
                    on_dev(d["customer_ok"]))]
    recs.append(kernel_record(
        kh.MURMUR3, "exchange", f"{n} rows x 2 INT64 keys (1 nullable)",
        qd["launches"]["murmur3_table_fused"],
        lambda: [kh.murmur3_columns(hcols)], lambda: [kh.murmur3_plain(hcols)],
        n * (8 + 8 + 1 + 4), n * 2 * (2 * 11 + 10)))

    # K3 at the sort's shape: the item_sk key bits and every 1-D buffer of
    # the from_rows table as payloads (five data columns, two validities),
    # and the same key alone. Bytes: one read of key and payloads, one
    # write of key, perm and payloads. Operations: radix_sort_ops. The
    # library yardstick is torch.sort of the int64 order carrier (stable):
    # the sorted key and the perm — the keys-only record's own function;
    # the payload record adds the gather it leaves out.
    def sort_record(info, tag, key_bits, pays, launches, fn, note=""):
        c, t = key_bits.shape
        pbytes = sum(p.element_size() for p in pays)
        carrier = keys.to_unsigned_bits(key_bits)  # the flip is its own inverse
        what = (f"{len(pays)} payloads ({pbytes} B a row)" if pays
                else "keys only")
        log(f"(c) {info.name}/{tag}: digits a row {digits_str(key_bits)}")
        return kernel_record(
            info, tag, f"{c}x{t}, {what}", launches,
            lambda: list(fn(key_bits, *pays)),
            lambda: list(bs.batched_sort_plain(key_bits, *pays)),
            c * t * (8 + pbytes) + c * t * (12 + pbytes),
            radix_sort_ops(key_bits),
            library_fn=lambda: torch.sort(carrier, dim=1, stable=True),
            note=note)

    item = on_dev(d["item_sk"])
    item_bits = keys.to_unsigned_bits(item)[None, :]
    sort_pays = [item, on_dev(d["customer_sk"]), on_dev(d["date_sk"]),
                 on_dev(d["quantity"]), on_dev(d["keep"]),
                 on_dev(d["customer_ok"]), on_dev(d["quantity_ok"])]
    k3 = qe["launches"]["batched_sort_u64_looped"]
    recs.append(sort_record(bs.SORT, "sort", item_bits,
                            [p[None, :] for p in sort_pays], k3,
                            bs.batched_sort_u64_looped))
    recs.append(sort_record(
        bs.SORT, "sort_keys", item_bits, [], k3, bs.batched_sort_u64_looped,
        note="(e)'s key alone, the function torch.sort computes; the main "
             "path's launch is the 7-payload sort above"))
    small = torch.randint(0, 64, (1, 1024), dtype=torch.int64, device=dev,
                          generator=gen)
    recs.append(sort_record(
        bs.SORT, "one_block", keys.to_unsigned_bits(small),
        [small, small.to(torch.int32), small > 31], 0,
        bs.batched_sort_u64_looped,
        note="the one-block regime (T <= 4096: the whole row in one "
             "shared-memory launch); no main-path phase sorts 1024 rows, "
             "so its main-path launch count is 0"))

    # K4a and K4b at (f)'s phase-1 shape: the packed words of the (f)
    # table, C = ceil(rows / 2^17) chunks of T = 2^17, keys only. Bytes:
    # K4a reads 8 B and writes 8 + 4 B (key, perm) a word; K4b reads and
    # writes 4 B. Operations: radix_sort_ops (K4b: no index rides). Library:
    # torch.sort of the order carrier (int64 for K4a, stable; int32 with its
    # top bit flipped for K4b).
    kw = keys.column_order_keys(qf["table"]["k"])[0]
    words, _ = gp.pack_chunks(kw - kw.min(), GROUPBY_CHUNK_ROWS)
    low = words.view(torch.int32)[:, 0::2].contiguous()  # u32 words
    c, t = words.shape
    shape = f"{c}x{t} packed words, keys only"
    recs.append(sort_record(bs.SORT_U64, "groupby", words, [],
                            qf["launches"]["pallas"]["batched_sort_u64"],
                            bs.batched_sort_u64))
    low_carrier = low ^ -2**31
    log(f"(c) {bs.SORT_U32.name}/groupby: digits a row {digits_str(low)}")
    recs.append(kernel_record(
        bs.SORT_U32, "groupby", shape,
        qf["launches"]["pallas32"]["batched_sort_u32"],
        lambda: list(bs.batched_sort_u32(low)),
        lambda: list(bs.batched_sort_u32_plain(low)), c * t * 8,
        radix_sort_ops(low, index=False),
        library_fn=lambda: torch.sort(low_carrier, dim=1)))
    # the payload branch of K4b (a riding index, one gather): distinct keys
    # are its contract, so the padding words become 0xFFFE0000 | iota
    iota = torch.arange(t, dtype=torch.int32, device=dev)
    distinct = torch.where(low == -1, iota | -(1 << 17), low)
    p32 = torch.randint(-2**31, 2**31 - 1, (c, t), dtype=torch.int32,
                        device=dev, generator=gen)
    p16 = torch.randint(-2**15, 2**15 - 1, (c, t), dtype=torch.int16,
                        device=dev, generator=gen)
    recs.append(kernel_record(
        bs.SORT_U32, "payloads", f"{c}x{t}, 2 payloads (int32, int16)", 0,
        lambda: list(bs.batched_sort_u32(distinct, p32, p16)),
        lambda: list(bs.batched_sort_u32_plain(distinct, p32, p16)),
        c * t * (8 + 2 * (4 + 2)), radix_sort_ops(distinct),
        library_fn=lambda: torch.sort(distinct ^ -2**31, dim=1),
        note="the payload branch (a riding u32 index, one gather); the "
             "groupby sorts keys only, so its main-path launch count is 0"))
    return recs


def phase_key_classes(seed: int) -> list:
    """K3 (with an int32 and a bool payload) and K4a (keys only) against
    their plain version, exactly, on every class of ``sort_key_classes`` at
    each of KEY_CLASS_SHAPES; returns one summary a (class, shape)."""
    from spark_rapids_jni_tpu_torch.kernels import bitonic_sort as bs

    rng = np.random.default_rng(seed + 4)
    out = []
    for c, t in KEY_CLASS_SHAPES:
        for name, key in sort_key_classes(rng, c, t).items():
            bits = torch.from_numpy(key.view(np.int64)).to(DEVICE)
            pay = torch.from_numpy(
                rng.integers(-2**31, 2**31, (c, t)).astype(np.int32)).to(DEVICE)
            flag = pay > 0
            want = bs.batched_sort_plain(bits, pay, flag)
            got3 = bs.batched_sort_u64_looped(bits, pay, flag)
            got4 = bs.batched_sort_u64(bits)
            torch.cuda.synchronize()
            err3 = max_abs_err(got3, want)
            err4 = max_abs_err(got4, want[:2])
            digits = digits_str(bits)
            log(f"(c) key class {name} {c}x{t}: digits a row {digits}; "
                f"max_abs_err K3 {err3}, K4a {err4}")
            out.append({"class": name, "shape": f"{c}x{t}", "digits": digits,
                        "max_abs_err_k3": err3, "max_abs_err_k4a": err4})
            if err3 or err4:
                raise AssertionError(
                    f"key class {name} {c}x{t}: K3 or K4a differs from the "
                    "plain version")
    return out


def build_rounds(lo, hi, valid, out, s: int, max_probes: int) -> int:
    """Probe rounds a K2a build ran, from its result ``out``: a live row
    moves one slot a round, so a row placed ``(slot - home) mod S`` slots
    from its home placed in that round (counted from 1); the build runs
    as many rounds as its last row needs, all of them when a row
    overflows."""
    from spark_rapids_jni_tpu_torch.kernels import hash_table as ht

    if int(out[4]):
        return max_probes
    slot = out[0].to(torch.int64)
    placed = (slot >= 0) & (valid != 0)
    if not bool(placed.any()):
        return 0
    home = ht.hash_word(lo.to(torch.int64) & 0xFFFFFFFF,
                        hi.to(torch.int64) & 0xFFFFFFFF) & (s - 1)
    return int(((slot - home) & (s - 1))[placed].max()) + 1


def phase_build_cases(d: dict, seed: int, tables: dict) -> list:
    """K2a against its plain version, exactly, on hard builds, each run
    twice (no race checker runs on the card: a barrier fault shows as a
    difference from the plain version in one of the runs). The groupby's
    chunking of (a) (684 x 4096 rows) with its Zipf brands, one key, keys
    sharing one home slot, random keys (under max_probes 2 too), 20 %
    nulls, slot counts either side of the shared-memory regime, 8192-row
    chunks and 2^19 slots, and the join's item keys; returns one summary a
    case, and leaves each case's inputs and plain result in ``tables``
    (name -> (lo, hi, valid, result)) for the probe cases."""
    from spark_rapids_jni_tpu_torch import dtype as dt
    from spark_rapids_jni_tpu_torch.kernels import hash_table as ht
    from spark_rapids_jni_tpu_torch.kernels import registry

    rng = np.random.default_rng(seed + 6)
    t = registry.GROUPBY_CHUNK_ROWS
    glo, ghi, gval = brand_chunks(d, t)
    c = glo.shape[0]

    def on_dev(a):
        return torch.from_numpy(
            np.array(a, np.uint32, order="C").view(np.int32)).to(DEVICE)

    def full(v):
        return torch.full((c, t), int(v), dtype=torch.int32, device=DEVICE)

    ones = torch.ones((c, t), dtype=torch.int32, device=DEVICE)
    one = rng.integers(0, 2**31, 2)
    hlo, hhi = one_home_keys(rng, t, 2 * t)
    rand = rng.integers(0, 2**32, (2, c, t), dtype=np.uint64).astype(np.uint32)
    nulls = torch.from_numpy((rng.random((c, t)) >= 0.2).astype(np.int32)).to(DEVICE)
    big_t = 2 * t  # over build_chunk's 4096 rows
    c2 = -(-c * t // big_t)
    pad2 = c2 * big_t - c * t

    def rechunk(x):
        return torch.nn.functional.pad(x.reshape(-1), (0, pad2)).reshape(c2, big_t)

    blo, bhi = key_halves(d["i_item_sk"], dt.INT64)
    join_s = 2 * registry._next_pow2(blo.shape[1])
    # name -> (lo, hi, valid, table_slots, max_probes)
    cases = {
        "one_key": (full(one[0]), full(one[1]), ones, 2 * t, ht.MAX_PROBES),
        "zipf_brands": (glo, ghi, gval, 2 * t, ht.MAX_PROBES),
        "one_home_slot": (on_dev(np.broadcast_to(hlo, (c, t))),
                          on_dev(np.broadcast_to(hhi, (c, t))), ones, 2 * t,
                          ht.MAX_PROBES),
        "max_probes_2": (on_dev(rand[0]), on_dev(rand[1]), ones, 2 * t, 2),
        "nulls_20pct": (glo, ghi, gval * nulls, 2 * t, ht.MAX_PROBES),
        "random_s8192": (on_dev(rand[0]), on_dev(rand[1]), ones, 8192,
                         ht.MAX_PROBES),
        "random_s16384": (on_dev(rand[0]), on_dev(rand[1]), ones, 16384,
                          ht.MAX_PROBES),
        "random_s32768": (on_dev(rand[0]), on_dev(rand[1]), ones, 32768,
                          ht.MAX_PROBES),
        "t8192_s16384": (rechunk(glo), rechunk(ghi), rechunk(gval), 16384,
                         ht.MAX_PROBES),
        "join_items_s2^19": (blo, bhi, torch.ones_like(blo), join_s,
                             ht.MAX_PROBES),
        "zipf_brands_s2^19": (glo, ghi, gval, 1 << 19, ht.MAX_PROBES),
    }
    out = []
    for name, (lo, hi, valid, slots, probes) in cases.items():
        cc, tt = lo.shape
        want = ht.build_table_plain(lo, hi, valid, table_slots=slots,
                                    max_probes=probes)
        errs = []
        for _ in range(2):
            got = ht.build_table(lo, hi, valid, table_slots=slots,
                                 max_probes=probes)
            torch.cuda.synchronize()
            errs.append(max_abs_err(got, want))
        regime = ht.build_regime(tt, slots)
        ovf, dup = int(want[4]), int(want[5])
        rounds = build_rounds(lo, hi, valid, want, slots, probes)
        log(f"(c) build case {name} {cc}x{tt} keys, {slots} slots, "
            f"max_probes {probes}: regime {regime}, {rounds} rounds, "
            f"overflow {ovf}, dup {dup}; max_abs_err {errs[0]}, {errs[1]}")
        out.append({"case": name, "shape": f"{cc}x{tt}", "slots": slots,
                    "max_probes": probes, "regime": regime, "rounds": rounds,
                    "overflow": ovf, "dup": dup, "max_abs_err": max(errs)})
        tables[name] = (lo, hi, valid, want)
        if any(errs):
            raise AssertionError(f"build case {name}: K2a differs from the "
                                 "plain version")
    return out


# chunks of the probe case over the launch grid's y limit (65,535)
PROBE_MANY_CHUNKS = 70_000


def phase_probe_cases(d: dict, seed: int, tables: dict) -> list:
    """K2b against its plain version, exactly, on the tables of
    ``phase_build_cases``: the groupby's 684 x 4096 chunks with their keys
    in a new order, the one-home-slot chain, max_probes 2 (unresolved
    queries), 20 % null queries, keys absent from the table, more chunks
    than the grid's y limit at a tiny T, the join's queries cut by 3 rows,
    and queries that are views one row (one 4-byte key) into their
    buffers; returns one summary a case."""
    from spark_rapids_jni_tpu_torch import dtype as dt
    from spark_rapids_jni_tpu_torch.kernels import hash_table as ht

    rng = np.random.default_rng(seed + 9)

    def table(name):
        return tables[name][3][1:4]

    def permuted(name):
        lo, hi, valid = tables[name][:3]
        perm = torch.from_numpy(rng.permutation(lo.shape[1])).to(DEVICE)
        return lo[:, perm], hi[:, perm], valid[:, perm]

    def rand_keys(c, t):
        k = rng.integers(0, 2**32, (2, c, t), dtype=np.uint64)
        k = k.astype(np.uint32)
        return tuple(torch.from_numpy(x.view(np.int32)).to(DEVICE) for x in k)

    def nulls(shape, frac):
        return torch.from_numpy(
            (rng.random(shape) >= frac).astype(np.int32)).to(DEVICE)

    glo, ghi, gval = permuted("zipf_brands")
    c, t = glo.shape
    alo, ahi = rand_keys(c, t)
    # many chunks of 3 rows into 4 slots: half the build's keys, half new
    mc, mt, ms = PROBE_MANY_CHUNKS, 3, 4
    mlo, mhi = rand_keys(mc, mt)
    mval = nulls((mc, mt), 0.1)
    many = ht.build_table_plain(mlo, mhi, mval, table_slots=ms)
    qlo, qhi = rand_keys(mc, mt)
    keep = torch.from_numpy(rng.random((mc, mt)) < 0.5).to(DEVICE)
    qlo, qhi = torch.where(keep, mlo, qlo), torch.where(keep, mhi, qhi)
    jlo, jhi = key_halves(d["item_sk"][d["keep"]], dt.INT64)
    jval = torch.ones_like(jlo)
    # name -> (lo, hi, valid, table, max_probes, what the case must show)
    cases = {
        "groupby_chunks": (glo, ghi, gval, table("zipf_brands"),
                           ht.MAX_PROBES, "all_found"),
        "one_home_slot": (*permuted("one_home_slot"), table("one_home_slot"),
                          ht.MAX_PROBES, "unresolved"),
        "max_probes_2": (*permuted("max_probes_2"), table("max_probes_2"), 2,
                         "unresolved"),
        "nulls_20pct": (glo, ghi, nulls((c, t), 0.2), table("nulls_20pct"),
                        ht.MAX_PROBES, ""),
        "absent_keys": (alo, ahi, torch.ones_like(alo), table("random_s8192"),
                        ht.MAX_PROBES, "none_found"),
        "chunks_over_grid_y": (qlo, qhi, nulls((mc, mt), 0.1), many[1:4],
                               ht.MAX_PROBES, ""),
        "join_ragged_tail": (jlo[:, :-3].contiguous(),
                             jhi[:, :-3].contiguous(), jval[:, :-3],
                             table("join_items_s2^19"), ht.MAX_PROBES, ""),
        "join_views_one_row_in": (*(shifted(x, 1) for x in (jlo, jhi, jval)),
                                  table("join_items_s2^19"), ht.MAX_PROBES,
                                  ""),
        "groupby_views_one_row_in": (
            *(shifted(x, 1) for x in (glo, ghi, gval)), table("zipf_brands"),
            ht.MAX_PROBES, "all_found"),
    }
    out = []
    for name, (lo, hi, valid, tab, probes, must) in cases.items():
        cc, tt = lo.shape
        want = ht.probe_table_plain(lo, hi, valid, *tab, max_probes=probes)
        got = ht.probe_table(lo, hi, valid, *tab, max_probes=probes)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        nfound, unres = int(want[0].sum()), int(want[2])
        nvalid = int((valid != 0).sum())
        log(f"(c) probe case {name} {cc}x{tt} queries, {tab[0].shape[1]} "
            f"slots, max_probes {probes}: found {nfound} of {nvalid} valid, "
            f"unresolved {unres}; max_abs_err {err}")
        out.append({"case": name, "shape": f"{cc}x{tt}",
                    "slots": int(tab[0].shape[1]), "max_probes": probes,
                    "found": nfound, "valid": nvalid, "unresolved": unres,
                    "max_abs_err": err})
        if err:
            raise AssertionError(f"probe case {name}: K2b differs from the "
                                 "plain version")
        if ((must == "all_found" and nfound != nvalid)
                or (must == "none_found" and nfound)
                or (must == "unresolved" and not unres)):
            raise AssertionError(f"probe case {name}: expected {must}")
    return out


# (rows, T) of the K4b checks: either side of the one-block regime
# (T <= 4096) and (f)'s chunk length
U32_ROW_SHAPES = ((4, 1024), (4, 4096), (4, 8192), (4, 1 << 17))


def phase_u32_rows(seed: int) -> list:
    """K4b against its plain version, exactly, on rows of distinct keys
    (``distinct_u32_rows``) at each of U32_ROW_SHAPES, keys only and with
    an int32 and an int16 payload; returns one summary a shape."""
    from spark_rapids_jni_tpu_torch.kernels import bitonic_sort as bs

    rng = np.random.default_rng(seed + 5)
    out = []
    for c, t in U32_ROW_SHAPES:
        key = torch.from_numpy(distinct_u32_rows(rng, c, t).view(np.int32))
        p32 = torch.from_numpy(
            rng.integers(-2**31, 2**31, (c, t)).astype(np.int32))
        p16 = torch.from_numpy(
            rng.integers(-2**15, 2**15, (c, t)).astype(np.int16))
        key, p32, p16 = key.to(DEVICE), p32.to(DEVICE), p16.to(DEVICE)
        want = bs.batched_sort_u32_plain(key, p32, p16)
        got_keys = bs.batched_sort_u32(key)
        got_pay = bs.batched_sort_u32(key, p32, p16)
        torch.cuda.synchronize()
        err_keys = max_abs_err(got_keys, want[:1])
        err_pay = max_abs_err(got_pay, want)
        log(f"(c) K4b distinct rows {c}x{t}: digits a row {digits_str(key)}; "
            f"max_abs_err keys only {err_keys}, with 2 payloads {err_pay}")
        out.append({"shape": f"{c}x{t}", "max_abs_err_keys": err_keys,
                    "max_abs_err_payloads": err_pay})
        if err_keys or err_pay:
            raise AssertionError(f"K4b {c}x{t} differs from the plain version")
    return out


def phase_transpose_cases(seed: int) -> list:
    """K1a and K1b against their plain versions, exactly, on every schema
    of TRANSPOSE_SCHEMAS at every row count of CARD_TRANSPOSE_ROWS: on fresh
    tensors, and on views that start one element into their buffers (no
    slice on 16 bytes: the kernels' guarded path), through the JAX-contract
    entries and the per-column ones; then ``rows.to_rows``
    of a table in batches of 96 rows (the start-offset slices
    ``rows._pack`` makes) against the same call on the CPU. Returns one
    summary a schema."""
    from spark_rapids_jni_tpu_torch import dtype as dt
    from spark_rapids_jni_tpu_torch import rows
    from spark_rapids_jni_tpu_torch.column import Column, Table
    from spark_rapids_jni_tpu_torch.kernels import row_transpose as rt

    rng = np.random.default_rng(seed + 7)

    out = []
    for name, schema in TRANSPOSE_SCHEMAS.items():
        dtypes = [dt.DType(dt.TypeId(t), sc) for t, sc in schema]
        layout = rows.compute_fixed_width_layout(dtypes)
        errs = []
        for n in CARD_TRANSPOSE_ROWS:
            cols_np, valid_np = transpose_inputs(rng, layout.column_widths, n)
            cols = [torch.from_numpy(c).to(DEVICE) for c in cols_np]
            valid = torch.from_numpy(valid_np).to(DEVICE)
            want = rt.pack_rows_plain(cols, valid, layout)
            wcols, wvalid = rt.unpack_rows_plain(want, layout)
            for view in (lambda t: t, shifted):  # a row: one (w,) slice
                got = rt.pack_rows([view(c) for c in cols], view(valid), layout)
                gcols, gvalid = rt.unpack_rows(view(want), layout)
                torch.cuda.synchronize()
                errs.append(max(max_abs_err([got], [want]),
                                max_abs_err([*gcols, gvalid],
                                            [*wcols, wvalid])))
            # one validity vector a column, every third without one
            vecs = [None if i % 3 == 1 else valid[:, i] != 0
                    for i in range(valid.shape[1])]
            want_c = rt.pack_rows_columns_plain(cols, vecs, layout)
            got_c = rt.pack_rows_columns(cols, vecs, layout)
            unpacked = [[*a, *b, c] for a, b, c in (
                rt.unpack_rows_columns(want_c, layout),
                rt.unpack_rows_columns_plain(want_c, layout))]
            torch.cuda.synchronize()
            errs.append(max(max_abs_err([got_c], [want_c]),
                            max_abs_err(*unpacked)))
        # rows._pack's batches start at multiples of 96 rows: a table made
        # on the CPU by the plain unpack, and its copy on the card
        n = TRANSPOSE_ROWS[-1]
        cols_np, valid_np = transpose_inputs(rng, layout.column_widths, n)
        host = rows.from_rows(rows.PackedRows(rt.pack_rows_plain(
            [torch.from_numpy(c) for c in cols_np],
            torch.from_numpy(valid_np), layout), layout), dtypes)
        card = Table([Column(c.data.to(DEVICE), c.dtype,
                             None if c.validity is None
                             else c.validity.to(DEVICE))
                      for c in host.columns])
        want_b = rows.to_rows(host, batch_rows=96)
        got_b = rows.to_rows(card, batch_rows=96)
        torch.cuda.synchronize()
        batch_err = max(max_abs_err([g.data.cpu()], [w.data])
                        for g, w in zip(got_b, want_b))
        back = table_bytes(rows.from_rows(got_b, dtypes))
        errs.extend([batch_err, int(back != table_bytes(host))])
        log(f"(c) transpose schema {name}: {len(schema)} columns, "
            f"{layout.row_size} B rows; "
            f"rows {list(CARD_TRANSPOSE_ROWS)} fresh and shifted, and "
            f"{len(got_b)} batches of 96: max_abs_err {max(errs)}")
        out.append({"schema": name, "columns": len(schema),
                    "row_size": layout.row_size,
                    "max_abs_err": max(errs)})
        if max(errs):
            raise AssertionError(f"transpose schema {name}: K1a or K1b "
                                 "differs from the plain version")
    return out


def shifted(t, per: int | None = None):
    """A copy of ``t`` that starts one row (``per`` elements; by default
    one slice along its first dimension) into a bigger buffer."""
    if per is None:
        per = t[0].numel() if t.dim() > 1 else 1
    buf = torch.zeros(t.numel() + per, dtype=t.dtype, device=t.device)
    buf[per:] = t.reshape(-1)
    return buf[per:].view(t.shape)


def table_bytes(t) -> list:
    """Every buffer of every column of a port table, as host bytes (None
    where a column has no validity)."""
    from spark_rapids_jni_tpu_torch import interop

    return [tuple(None if b is None else b.tobytes() for b in c[:3]) + c[3:]
            for c in interop.table_to_buffers(t)]


def float_groupby_inputs(seed: int):
    """(keys, values) of the card's float groupby check: 8 keys over
    normal(50, 10) FLOAT64 values at FLOAT_GROUPBY_ROWS rows, a run of
    -0.0 among them and key 7 holding only -0.0."""
    rng = np.random.default_rng(seed + 8)
    n = FLOAT_GROUPBY_ROWS
    keys = rng.integers(0, 7, n).astype(np.int64)
    vals = rng.normal(50, 10, n)
    vals[100:300] = -0.0
    keys[500:520] = 7
    vals[500:520] = -0.0
    return keys, vals


def phase_float_groupby(seed: int) -> dict:
    """FLOAT64 SUM/MIN/MAX groupbys on the card must give the port's CPU
    bytes (the float cumsum adds in XLA's CPU order, IEEE adds are
    deterministic, and -0.0 extremes come out +0.0 as in the JAX
    package): through the ops and through the wire ``groupby``, on
    ``float_groupby_inputs``; and F1_ROWS must sum to F1_SUM_BITS."""
    from spark_rapids_jni_tpu_torch import interop, ops
    from spark_rapids_jni_tpu_torch import runtime_bridge as rb

    keys, vals = float_groupby_inputs(seed)
    aggs = ["sum", "min", "max"]
    plan = json.dumps([{"op": "groupby", "by": [0],
                        "aggs": [{"column": 1, "agg": a} for a in aggs]}])

    def run(k, v, device):
        bufs = [(k, None, None, 4, 0), (v.view(np.int64), None, None, 10, 0)]
        t = interop.table_from_buffers(bufs, None, device=device)
        by_ops = table_bytes(ops.groupby_aggregate(
            t, [0], [ops.GroupbyAgg(1, a) for a in aggs]))
        tid = rb.table_upload_wire([4, 10], [0, 0], [k.tobytes(),
                                                     v.tobytes()],
                                   [None, None], k.shape[0], device=device)
        res = rb.table_plan_resident(plan, [tid])
        wire = rb.table_download_wire(res)
        rb.table_free(res)
        rb.table_free(tid)
        return by_ops, wire

    card = run(keys, vals, DEVICE)
    host = run(keys, vals, "cpu")
    f1 = np.array(F1_ROWS)
    f1_card = run(np.zeros(18, np.int64), f1, DEVICE)[0][1][0]
    f1_bits = int(np.frombuffer(f1_card, np.uint64)[0])
    neg = sum(int((np.frombuffer(c[0], np.uint64) == 1 << 63).sum())
              for c in card[0][1:])
    log(f"(c) float groupby: {keys.shape[0]} rows, sum/min/max bytes on the "
        f"card {'equal' if card == host else 'DIFFER FROM'} the CPU's (ops "
        f"and wire); -0.0 results {neg}; F1 sum bits {f1_bits:#x} "
        f"(expected {F1_SUM_BITS:#x})")
    if card != host or f1_bits != F1_SUM_BITS:
        raise AssertionError("float groupby on the card differs from the CPU")
    return {"rows": int(keys.shape[0]), "equal": True,
            "f1_sum_bits": f"{f1_bits:#x}"}


def make_query_step_data(rng, n: int, n_items: int) -> dict:
    """(g)'s store_sales batch and SF100 item table: ss_item_sk Zipf(1.3)
    mod 204,000, ss_quantity 1-100, ss_sales_price in cents below $200;
    i_category_id 1-10."""
    return {
        "item": (rng.zipf(1.3, n) % n_items).astype(np.int64),
        "qty": rng.integers(1, 101, n).astype(np.int64),
        "price": rng.integers(0, 20_000, n) / 100.0,
        "i_item": np.arange(n_items, dtype=np.int64),
        "cat": rng.integers(1, 11, n_items).astype(np.int64),
    }


def query_step_oracle(q: dict) -> dict:
    m = q["qty"] > 5
    cat = q["cat"][q["item"][m]]  # i_item_sk == row index: one match a row
    rev = q["qty"][m] * q["price"][m]
    keys, inv = np.unique(cat, return_inverse=True)
    return {"keys": keys, "count": np.bincount(inv).astype(np.int64),
            "sum": np.bincount(inv, weights=rev)}


def query_step_tables(q: dict, device):
    from spark_rapids_jni_tpu_torch.column import Table

    sales = Table.from_pydict({"item": q["item"], "qty": q["qty"],
                               "price": q["price"]}, device=device)
    items = Table.from_pydict({"item": q["i_item"], "cat": q["cat"]},
                              device=device)
    return sales, items


def sync_sites(fn) -> list:
    """Where one call of ``fn`` syncs with the host ("file:line" of the
    Python call of each op that warns under
    ``torch.cuda.set_sync_debug_mode("warn")``)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{w.filename.rsplit('/', 2)[-1]}:{w.lineno}" for w in caught
            if "called a synchronizing" in str(w.message)]


def count_syncs(fn) -> int:
    """Host syncs one call of ``fn`` makes (:func:`sync_sites`)."""
    return len(sync_sites(fn))


def phase_scan16(n: int, seed: int, launches: int) -> dict:
    """Step 0 of (g) and scan16's record: the plain ``_scan_sum16`` (the
    FLOAT64 sum's scan in XLA's order) at ``n`` rows beside one
    ``torch.cumsum`` of the same vector, CUDA events a call and the
    device and host time a call (:func:`ahead_ms`); then the scan16
    kernel held bit for bit against the plain version on that vector."""
    from spark_rapids_jni_tpu_torch.kernels import scan16
    from spark_rapids_jni_tpu_torch.ops.groupby import _scan_sum16

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    v = torch.randn(n, dtype=torch.float64, device=DEVICE, generator=g) * 50
    out = {}
    for name, fn in (("scan_sum16", lambda: _scan_sum16(v, n)),
                     ("cumsum", lambda: torch.cumsum(v, 0))):
        # the plain scan's ~500 launches a call (its subnormal flushes)
        # fill the launch queue behind ahead_ms's sleep, so its device
        # time a call comes back None: not measured
        dev, host = ahead_ms(fn, 5)
        out[name] = {"ms": cuda_ms(fn, 20), "ahead_ms": dev, "host_ms": host}
    log(f"(g) step 0: at {n} FLOAT64 rows _scan_sum16 {out['scan_sum16']} "
        f"vs torch.cumsum {out['cumsum']} (ms a call)")
    # bytes: the vector read once, the scan written once; operations: one
    # FLOAT64 add an element and level (16/15 of n), at the card's FP64
    # rate outside the tensor cores (34 TFLOP/s, NVIDIA's data sheet)
    out["record"] = kernel_record(
        scan16.SCAN16, "query_step", f"{n} x FLOAT64", launches,
        lambda: [scan16.scan_sum16(v, n).view(torch.int64)],
        lambda: [_scan_sum16(v, n).view(torch.int64)],
        16 * n, 0, library_fn=lambda: torch.cumsum(v, 0),
        note="bits compared; ops bound: 16/15 n FP64 adds at 34 TFLOP/s "
             f"= {16 * n / 15 / 34e12 * 1e3:.5f} ms")
    return out


SCAN16_CASE_ROWS = (1, 2, 15, 16, 17, 255, 256, 257, 4095, 4096, 4097,
                    65536, 65537, 1 << 20, 4096 * 4097 + 5)


def device_launches(fn, calls: int = 20, tries: int = 4) -> dict:
    """The device operations a call of ``fn`` makes, by name, from
    ``torch.profiler`` over ``calls`` calls (kernels and memsets). A short
    window on the card came back without its device events: the window
    waits 20 ms before its calls, and one that recorded none is taken
    again, up to ``tries`` times ({} if none did)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ops = {e.key[:60]: e.count / calls for e in device_events(prof)
               if e.count}
        if ops:
            return ops
    return {}


SCAN16_PHASE_NAMES = ("ticket", "load", "levels", "publish", "look-back",
                      "fold", "write")


def scan16_phases(n: int, seed: int) -> dict:
    """Where a scan16 tile's time goes: ``csrc/scan16.cu`` built again
    with its phase clock (``-DSCAN16_PHASES``: %globaltimer as each step
    starts), one call on ``n`` FLOAT64 elements after two warm-up calls;
    per step the 10th/50th/90th percentile over the tiles (us), a tile's
    lifetime, the call's span and the tiles alive at its midpoint."""
    import ctypes

    from spark_rapids_jni_tpu_torch import kernels

    out_dir = kernels.BUILD_ROOT / kernels._digest()
    lib_path = out_dir / "libscan16_phases.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-DSCAN16_PHASES",
                        "-o", str(lib_path), str(kernels.CSRC / "scan16.cu")],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.srt_scan16_scratch_bytes.argtypes = [ctypes.c_int64]
    lib.srt_scan16_scratch_bytes.restype = ctypes.c_int64
    lib.srt_scan16.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_void_p]
    lib.srt_scan16_phases.argtypes = [ctypes.c_void_p]
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    v = torch.randn(n, dtype=torch.float64, device=DEVICE, generator=g)
    size = lib.srt_scan16_scratch_bytes(n)
    for _ in range(3):
        scratch = torch.empty(max(size, 8), dtype=torch.uint8, device=DEVICE)
        res = torch.empty_like(v)
        torch.cuda.synchronize()
        if lib.srt_scan16(v.data_ptr(), n, scratch.data_ptr(), size,
                          res.data_ptr(),
                          torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("scan16 with its phase clock did not launch")
        torch.cuda.synchronize()
    stamps = np.zeros((len(SCAN16_PHASE_NAMES) + 2, 8192), np.int64)
    if lib.srt_scan16_phases(stamps.ctypes.data) != 0:
        raise RuntimeError("scan16's phase clock could not be read")
    tiles = min(-(-n // 4096), stamps.shape[1])
    t = stamps[:-1, :tiles]
    steps = {}
    for k, name in enumerate(SCAN16_PHASE_NAMES):
        us = (t[k + 1] - t[k]) / 1e3
        steps[name] = [float(np.percentile(us, q)) for q in (10, 50, 90)]
    life = (t[-1] - t[0]) / 1e3
    mid = t[0].min() + (t[-1].max() - t[0].min()) / 2
    rec = {"n": n, "tiles": tiles, "steps_us_p10_p50_p90": steps,
           "lifetime_us_p50": float(np.median(life)),
           "span_us": float((t[-1].max() - t[0].min()) / 1e3),
           "alive_at_midpoint": int(((t[0] <= mid) & (t[-1] >= mid)).sum()),
           "sms": int(np.unique(stamps[-1, :tiles]).shape[0])}
    log(f"(c) scan16 phases at {n} elements ({tiles} tiles on {rec['sms']} "
        f"SMs): span {rec['span_us']:.1f} us, a tile's lifetime "
        f"{rec['lifetime_us_p50']:.2f} us (p50), {rec['alive_at_midpoint']} "
        f"alive at the midpoint; steps p10/p50/p90 us " + ", ".join(
            f"{k} {a:.2f}/{b:.2f}/{c:.2f}" for k, (a, b, c) in steps.items()))
    return rec


def phase_scan16_cases(seed: int) -> dict:
    """scan16 against its plain version, bit for bit, on the lengths
    around each level and tile edge and past two recursion levels, with
    -0.0 runs, mixed magnitudes, inf and NaN, and ``rows`` 1 and 2 for a
    one-element vector. Each length runs 20 calls back to back on one
    stream (timed together) and every one of them is checked: a flag or
    ticket left over from the call before would show there. The
    launches a call are read from the profile; then the phase breakdown
    (:func:`scan16_phases`) at (g)'s and (i1)'s lengths."""
    from spark_rapids_jni_tpu_torch.kernels import scan16
    from spark_rapids_jni_tpu_torch.ops.groupby import _scan_sum16

    rng = np.random.default_rng(seed + 16)
    out = []
    for n in SCAN16_CASE_ROWS:
        x = rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n)
        x[rng.random(n) < 0.05] = -0.0
        if n > 300:
            x[100:140] = -0.0
            x[rng.integers(0, n)] = np.inf
        v = torch.from_numpy(x).to(DEVICE)
        for rows in ({None, 1, 2} if n == 1 else {None}):
            want = _scan_sum16(v, rows).view(torch.int64)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            calls = [scan16.scan_sum16(v, rows) for _ in range(20)]
            stop.record()
            stop.synchronize()
            errs = [max_abs_err([c.view(torch.int64)], [want]) for c in calls]
            del calls
            ops_a_call = device_launches(lambda: scan16.scan_sum16(v, rows))
            out.append({"rows": n, "rows_arg": rows, "calls": len(errs),
                        "max_abs_err": max(errs),
                        "bad_calls": sum(e != 0 for e in errs),
                        "queued_ms": start.elapsed_time(stop) / len(errs),
                        "device_ops_a_call": ops_a_call})
            if max(errs):
                raise AssertionError(
                    f"scan16 differs at {n} rows ({rows}) in "
                    f"{out[-1]['bad_calls']} of {len(errs)} calls")
    nan = torch.tensor([1.0, float("nan"), 2.0] * 3000, dtype=torch.float64,
                       device=DEVICE)
    if not torch.equal(torch.isnan(scan16.scan_sum16(nan)),
                       torch.isnan(_scan_sum16(nan))):
        raise AssertionError("scan16 NaN positions differ")
    phases = [scan16_phases(n, seed) for n in (QS_ROWS, 982_146)]  # (g), (i1)
    big = out[-1]
    log(f"(c) scan16 cases: {len(out)} cases over the lengths "
        f"{list(SCAN16_CASE_ROWS)}, 20 "
        f"calls back to back at each, every call bit-exact against "
        f"_scan_sum16; NaN propagates alike; device operations a call at "
        f"{big['rows']}: {big['device_ops_a_call']} (queued "
        f"{big['queued_ms']:.4f} ms a call)")
    return {"cases": out, "phases": phases}


def phase_query_step(kernels, q: dict, seed: int) -> dict:
    """(g): ``graft_entry.query_step`` on the card at full width: the
    group count, keys and counts exact against numpy, the sums bit-exact
    against the port's own CPU run of the same tables and within
    ``QS_SUM_RTOL`` of numpy's; wall, profile, host syncs, and Step 0."""
    from spark_rapids_jni_tpu_torch import graft_entry

    want = query_step_oracle(q)
    sales, items = query_step_tables(q, DEVICE)
    torch.cuda.synchronize()
    kernels.reset_launches()
    agg, ngroups = graft_entry.query_step(sales, items)
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kernels.KERNELS.items()}
    card = table_bytes(agg)
    g = int(ngroups)
    host_agg, host_g = graft_entry.query_step(*query_step_tables(q, "cpu"))
    keys = agg["cat"].data[:g].cpu().numpy()
    count = agg["count_rev"].data[:g].cpu().numpy()
    sums = agg["sum_rev"].to_numpy()[:g]
    valid = [c.validity.cpu().numpy() for c in agg.columns]
    checks = {
        "ngroups": g == want["keys"].shape[0] == int(host_g),
        "keys": np.array_equal(keys, want["keys"]),
        "count": np.array_equal(count, want["count"]),
        "validity": all(np.array_equal(v, np.arange(64) < g) for v in valid),
        "sum_bits_equal_cpu": card == table_bytes(host_agg),
        "sum_vs_numpy": bool(np.allclose(sums, want["sum"], rtol=QS_SUM_RTOL,
                                         atol=0)),
    }
    rel = float(np.max(np.abs(sums - want["sum"]) / np.abs(want["sum"])))
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        graft_entry.query_step(sales, items)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    median = statistics.median(times)
    syncs = count_syncs(lambda: graft_entry.query_step(sales, items))
    log(f"(g) query_step: {q['qty'].shape[0]} x {q['cat'].shape[0]} rows, "
        f"{g} groups; checks {checks}; sums max relative difference from "
        f"numpy {rel:.3e}; wall median {median:.2f} ms over 5 runs (all: "
        f"{[round(t, 2) for t in times]}); host syncs a run {syncs}; "
        f"launches {launches}")
    def run():
        graft_entry.query_step(sales, items)
        torch.cuda.synchronize()

    profile = profile_plan(run, median, "(g)")
    step0 = phase_scan16(q["qty"].shape[0], seed, launches["scan16"])
    plain = step0["scan_sum16"]["ahead_ms"]
    share = None if plain is None else plain / profile["device_ms"]
    log(f"(g) step 0: the plain _scan_sum16's device time a call is "
        + ("not measured (its launches outrun the sleep)" if plain is None
           else f"{plain:.4f} ms, {100 * share:.1f} % of (g)'s "
                f"{profile['device_ms']:.3f} ms a run (which runs the "
                f"scan16 kernel)"))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"(g) query_step differs: {bad}")
    if launches["scan16"] == 0:
        raise AssertionError("(g) never launched scan16")
    return {"launches": launches, "groups": g, "wall_ms": median,
            "syncs": syncs, "profile": profile, "step0": step0,
            "scan_share": share, "sum_max_rel_diff": rel}


def wire_plan_oracle(d: dict, n: int) -> np.ndarray:
    """(h)'s result rows in numpy: per sold date (ascending), SUM, COUNT,
    MIN and MAX of the non-null quantities of the kept rows, as 48-byte
    packed rows (five INT64 columns and a validity byte; a null result
    keeps the groupby's 0 sum and sentinel extremes)."""
    m = d["keep"][:n]
    date = d["date_sk"][:n][m]
    qty = d["quantity"][:n][m].astype(np.int64)
    ok = d["quantity_ok"][:n][m]
    keys, inv = np.unique(date, return_inverse=True)
    g = keys.shape[0]
    count = np.bincount(inv[ok], minlength=g).astype(np.int64)
    total = np.bincount(inv[ok], weights=qty[ok], minlength=g).astype(np.int64)
    lo = np.full(g, np.iinfo(np.int64).max)
    hi = np.full(g, np.iinfo(np.int64).min)
    np.minimum.at(lo, inv[ok], qty[ok])
    np.maximum.at(hi, inv[ok], qty[ok])
    rows = np.zeros((g, 48), np.uint8)
    for j, col in enumerate((keys, total, count, lo, hi)):
        rows[:, 8 * j:8 * j + 8] = col.astype(np.int64).view(np.uint8).reshape(g, 8)
    # date and count always valid; sum/min/max null where no quantity is
    rows[:, 40] = 1 | 4 | ((count > 0).astype(np.uint8) * (2 | 8 | 16))
    return rows


def phase_wire_plan(kernels, d: dict) -> dict:
    """(h): ``table_plan_wire`` over (a)'s fact batch as wire bytes, with
    the kernel tier on and off (equal 5-tuples, both exact against
    numpy), its counters for each; then a legacy flat UINT8 input."""
    from spark_rapids_jni_tpu_torch import runtime_bridge as rb
    from spark_rapids_jni_tpu_torch.utils import config, metrics

    plan = json.dumps(WIRE_PLAN)
    want = wire_plan_oracle(d, FACT_ROWS)
    config.set_flag("METRICS", True)
    out, counters = {}, {}
    try:
        for mode in ("on", "off"):
            config.set_flag("KERNELS", mode)
            metrics.reset()
            torch.cuda.synchronize()
            kernels.reset_launches()
            out[mode] = rb.table_plan_wire(plan, *d["fact_wire"], device=DEVICE)
            torch.cuda.synchronize()
            counters[mode] = {
                "tier": metrics.counter_values(["kernel.launches",
                                                "kernel.declines"]),
                "kernels": {k: v.launches for k, v in kernels.KERNELS.items()}}
            check_rows(out[mode], want)
        config.set_flag("KERNELS", "on")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            rb.table_plan_wire(plan, *d["fact_wire"], device=DEVICE)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        median = statistics.median(times)
        log(f"(h) wire plan: {want.shape[0]} dates match the numpy oracle "
            f"with the tier on and off; the two 5-tuples are "
            f"{'equal' if out['on'] == out['off'] else 'DIFFERENT'}; counters "
            f"{counters}; wall median (on) {median:.2f} ms over 5 runs (all: "
            f"{[round(t, 2) for t in times]})")

        def run():
            rb.table_plan_wire(plan, *d["fact_wire"], device=DEVICE)
            torch.cuda.synchronize()

        profile = profile_plan(run, median, "(h)")
        # a legacy flat UINT8 input under the default ladder: a padded
        # upload and the fused [filter, cast, groupby] segment
        n = FLAT_ROWS
        flat = ([5], [0], [d["rows"][:n].tobytes()], [None], n * 32)
        flat_plan = [dict(WIRE_PLAN[0], num_rows=n)] + WIRE_PLAN[1:]
        metrics.reset()
        kernels.reset_launches()
        got = rb.table_plan_wire(json.dumps(flat_plan), *flat, device=DEVICE)
        torch.cuda.synchronize()
        flat_launches = {k: v.launches for k, v in kernels.KERNELS.items()}
        flat_plan_counters = metrics.counter_values(
            ["plan.fused_segments", "plan.fallbacks", "plan.declined"])
        check_rows(got, wire_plan_oracle(d, n))
        # op by op: the groupby meets the tier (K2a)
        config.set_flag("BUCKETS", "off")
        kernels.reset_launches()
        out["per_op"] = rb.table_plan_wire(plan, *d["fact_wire"],
                                           device=DEVICE)
        torch.cuda.synchronize()
        per_op_launches = {k: v.launches for k, v in kernels.KERNELS.items()}
        check_rows(out["per_op"], want)
        log(f"(h) legacy flat UINT8 input: {n} rows exact; launches "
            f"{flat_launches}; counters {flat_plan_counters}; op by op "
            f"(BUCKETS=off): equal 5-tuple, launches {per_op_launches}")
    finally:
        config.clear_flag("KERNELS")
        config.clear_flag("METRICS")
        config.clear_flag("BUCKETS")
    if not out["on"] == out["off"] == out["per_op"]:
        raise AssertionError("(h) tier on, off and op by op give different "
                             "bytes")
    missing = ([k for k in WIRE_KERNELS
                if counters["on"]["kernels"][k] == 0 or flat_launches[k] == 0]
               + [k for k in WIRE_OFF_KERNELS if per_op_launches[k] == 0])
    if missing:
        raise AssertionError(f"(h) never launched {missing}")
    if (flat_plan_counters["plan.fused_segments"] != 1
            or flat_plan_counters["plan.fallbacks"]
            or flat_plan_counters["plan.declined"]):
        raise AssertionError(f"(h) the flat input's fused segment did not "
                             f"run fused: {flat_plan_counters}")
    return {"counters": counters, "wall_ms": median, "profile": profile,
            "per_op_launches": per_op_launches,
            "flat_launches": flat_launches}


# ---------------------------------------------------------------------------
# (i) and (j): the rest of the dispatch plane
# ---------------------------------------------------------------------------

CUSTOMER_ROWS = 2_000_000  # TPC-DS SF100 customer
CATEGORY = 1  # (i1)/(i2): the items with i_category_id 1
OPS_ROWS = 1 << 20  # (j)
DISPATCH_RTOL = 1e-9  # (i1)'s float statistics against numpy's
DISPATCH_KERNELS = {
    "i1": ("unpack_rows", "build_table", "probe_table", "scan16",
           "pack_rows"),
    "i2": ("unpack_rows", "build_table", "probe_table", "pack_rows"),
    "i3": ("unpack_rows", "pack_rows"),
    "i4": ("unpack_rows", "pack_rows"),
}
I1_AGGS = ([{"column": 3, "agg": a} for a in ("mean", "variance", "std")]
           + [{"column": 1, "agg": "first"}, {"column": 1, "agg": "last"},
              {"column": 3, "agg": "count"}])
DISPATCH_PLANS = {
    # WHERE ss_item_sk IN (items of one category), then per-day statistics
    "i1": [FROM_FACT_ROWS, {"op": "join", "how": "semi", "on": [0]},
           {"op": "groupby", "by": [2], "aggs": I1_AGGS},
           {"op": "sort_by", "keys": [{"column": 0}]}, {"op": "to_rows"}],
    # NOT EXISTS, then SELECT DISTINCT customer, date
    "i2": [FROM_FACT_ROWS, {"op": "join", "how": "anti", "on": [0]},
           {"op": "distinct", "keys": [1, 2]}, {"op": "to_rows"}],
    # sales LEFT OUTER JOIN customer, by birth year
    "i3": [FROM_FACT_ROWS, {"op": "join", "how": "left", "on": [1]},
           {"op": "groupby", "by": [5],
            "aggs": [{"column": 0, "agg": "count"},
                     {"column": 0, "agg": "nunique"},
                     {"column": 3, "agg": "sum"}]},
           {"op": "to_rows"}],
    # (batch UNION ALL batch) FULL OUTER JOIN item, by category
    "i4": [{"op": "concat", "rest": [0]}, FROM_FACT_ROWS,
           {"op": "join", "how": "full", "on": [0], "rest": [1]},
           {"op": "groupby", "by": [6],
            "aggs": [{"column": 0, "agg": "count"},
                     {"column": 3, "agg": "count"}]},
           {"op": "to_rows"}],
}


def make_dispatch_data(rng, d: dict) -> dict:
    """(i)'s other tables: the item keys of one category, SF100's customer
    table (every 20th key left out), and a second fact batch."""
    items = d["i_item_sk"][d["i_category_id"] == CATEGORY]
    sk = np.arange(1, CUSTOMER_ROWS + 1, dtype=np.int64)
    sk = sk[sk % 20 != 0]
    birth = rng.integers(1924, 1993, sk.shape[0]).astype(np.int32)
    birth_ok = rng.random(sk.shape[0]) > 0.035
    d2 = make_query_data(rng, FACT_ROWS, ITEM_ROWS)
    return {
        "items": items, "sk": sk, "birth": birth, "birth_ok": birth_ok,
        "d2": d2,
        "item_cat_wire": ([4], [0], [items.tobytes()], [None], items.shape[0]),
        "customer_wire": ([3, 4], [0, 0], [birth.tobytes(), sk.tobytes()],
                          [birth_ok.astype(np.uint8).tobytes(), None],
                          sk.shape[0]),
    }


def wire_rows(wire, size: int) -> np.ndarray:
    """The (n, size) packed rows of a LIST<UINT8> wire result."""
    type_ids, scales, datas, valids, n = wire
    if type_ids != [24] or scales != [5] or valids != [None]:
        raise AssertionError(f"unexpected result schema {type_ids} {scales}")
    offs = np.frombuffer(datas[0], np.int32, n + 1)
    if not np.array_equal(offs, np.arange(n + 1) * size):
        raise AssertionError(f"result rows are not {size} bytes each")
    return np.frombuffer(datas[0], np.uint8, offset=4 * (n + 1)).reshape(n, size)


def field(rows: np.ndarray, off: int, dtype) -> np.ndarray:
    w = np.dtype(dtype).itemsize
    return rows[:, off:off + w].copy().view(dtype)[:, 0]


def category_mask(dd: dict) -> np.ndarray:
    cat = np.zeros(ITEM_ROWS, bool)
    cat[dd["items"]] = True
    return cat


def check_i1(d: dict, dd: dict, wire) -> dict:
    """(i1) against numpy: dates, first/last customer, counts and validity
    exact; mean, variance, std within DISPATCH_RTOL."""
    m = category_mask(dd)[d["item_sk"]]
    date, qty = d["date_sk"][m], d["quantity"][m].astype(np.float64)
    qok, cust, cok = d["quantity_ok"][m], d["customer_sk"][m], d["customer_ok"][m]
    keys, inv = np.unique(date, return_inverse=True)
    g = keys.shape[0]
    cnt = np.bincount(inv[qok], minlength=g)
    mean = np.bincount(inv[qok], weights=qty[qok], minlength=g) / np.maximum(cnt, 1)
    dev = (qty - mean[inv])[qok]
    var = (np.bincount(inv[qok], weights=dev * dev, minlength=g)
           / np.maximum(cnt - 1, 1))
    vi = np.flatnonzero(cok)
    first, last = np.zeros(g, np.int64), np.zeros(g, np.int64)
    has_c = np.zeros(g, bool)
    u, i = np.unique(inv[vi], return_index=True)
    first[u], has_c[u] = cust[vi[i]], True
    u, i = np.unique(inv[vi][::-1], return_index=True)
    last[u] = cust[vi[::-1][i]]
    rows = wire_rows(wire, 64)
    bits = (1 | 64 | (cnt > 0) * 2 | (cnt > 1) * (4 | 8)
            | has_c * (16 | 32)).astype(np.uint8)
    rel = 0.0
    for off, want, ok in ((8, mean, cnt > 0), (16, var, cnt > 1),
                          (24, np.sqrt(var), cnt > 1)):
        got = field(rows, off, np.float64)[ok]
        rel = max(rel, float(np.max(np.abs(got - want[ok])
                                    / np.maximum(np.abs(want[ok]), 1e-300))))
    checks = {
        "groups": rows.shape[0] == g,
        "date": np.array_equal(field(rows, 0, np.int64), keys),
        "first": np.array_equal(field(rows, 32, np.int64)[has_c], first[has_c]),
        "last": np.array_equal(field(rows, 40, np.int64)[has_c], last[has_c]),
        "count": np.array_equal(field(rows, 48, np.int64), cnt),
        "validity": np.array_equal(rows[:, 56], bits),
        "padding": not rows[:, 57:].any(),
        "float_rtol": rel <= DISPATCH_RTOL,
    }
    return {"checks": checks, "rows_in": int(m.sum()), "groups": g,
            "float_max_rel": rel}


def check_i2(d: dict, dd: dict, wire) -> dict:
    """(i2) against numpy: the first fact row of each distinct (customer,
    date) among the rows whose item is not of the category, in order,
    byte for byte."""
    idx = np.flatnonzero(~category_mask(dd)[d["item_sk"]])
    ck = np.where(d["customer_ok"][idx], d["customer_sk"][idx], -1)
    key = (ck + 1) * 2048 + (d["date_sk"][idx] - 2_450_816)
    _, first = np.unique(key, return_index=True)
    want = d["rows"][idx[np.sort(first)]]
    check_rows(wire, want)
    return {"checks": {"rows": True}, "rows_in": int(idx.shape[0]),
            "groups": int(want.shape[0])}


def check_i3(d: dict, dd: dict, wire) -> dict:
    """(i3) against numpy: per birth year (null first), the rows, the
    distinct items and the quantity sum."""
    cust, cok = d["customer_sk"], d["customer_ok"]
    byear = np.zeros(CUSTOMER_ROWS + 1, np.int32)
    bok = np.zeros(CUSTOMER_ROWS + 1, bool)
    byear[dd["sk"]], bok[dd["sk"]] = dd["birth"], dd["birth_ok"]
    at = np.where(cok, cust, 0)
    g = np.where(cok & bok[at], byear[at] - 1923, 0)  # 0: the null year
    qok = d["quantity_ok"]
    groups = np.unique(g)
    count = np.bincount(g, minlength=70)[groups]
    pairs = np.unique(g * ITEM_ROWS + d["item_sk"])
    nuniq = np.bincount(pairs // ITEM_ROWS, minlength=70)[groups]
    total = np.bincount(g[qok], weights=d["quantity"][qok],
                        minlength=70).astype(np.int64)[groups]
    has = np.bincount(g[qok], minlength=70)[groups] > 0
    rows = wire_rows(wire, 40)
    key_ok = groups > 0
    bits = (key_ok * 1 | 2 | 4 | has * 8).astype(np.uint8)
    checks = {
        "groups": rows.shape[0] == groups.shape[0],
        "year": np.array_equal(field(rows, 0, np.int32)[key_ok],
                               groups[key_ok] + 1923),
        "count": np.array_equal(field(rows, 8, np.int64), count),
        "nunique": np.array_equal(field(rows, 16, np.int64), nuniq),
        "sum": np.array_equal(field(rows, 24, np.int64)[has], total[has]),
        "validity": np.array_equal(rows[:, 32], bits),
    }
    return {"checks": checks, "groups": int(groups.shape[0])}


def check_i4(d: dict, dd: dict, wire) -> dict:
    """(i4) against numpy: per category, the rows of both batches plus the
    items sold in neither, and the rows with a quantity."""
    d2 = dd["d2"]
    cat = d["i_category_id"]
    sold = np.concatenate([d["item_sk"], d2["item_sk"]])
    qok = np.concatenate([d["quantity_ok"], d2["quantity_ok"]])
    unsold = np.ones(ITEM_ROWS, bool)
    unsold[sold] = False
    count0 = (np.bincount(cat[sold], minlength=11)
              + np.bincount(cat[unsold], minlength=11))[1:]
    count3 = np.bincount(cat[sold][qok], minlength=11)[1:]
    rows = wire_rows(wire, 32)
    checks = {
        "groups": rows.shape[0] == 10,
        "category": np.array_equal(field(rows, 0, np.int32), np.arange(1, 11)),
        "count_rows": np.array_equal(field(rows, 8, np.int64), count0),
        "count_quantity": np.array_equal(field(rows, 16, np.int64), count3),
        "validity": bool((rows[:, 24] == 7).all()),
    }
    return {"checks": checks, "rows_in": int(sold.shape[0]),
            "right_only": int(unsold.sum())}


DISPATCH_CHECKS = {"i1": check_i1, "i2": check_i2, "i3": check_i3,
                   "i4": check_i4}


def phase_dispatch(rb, kernels, d: dict, dd: dict) -> dict:
    """(i): the four plans through ``table_upload_wire`` +
    ``table_plan_resident``, each run once and checked, then 5 timed runs
    and a profiled window; (i1)'s bytes also equal the port's own CPU run
    of the same plan."""
    from spark_rapids_jni_tpu_torch.utils import config, metrics

    inputs = {
        "i1": [d["fact_wire"], dd["item_cat_wire"]],
        "i2": [d["fact_wire"], dd["item_cat_wire"]],
        "i3": [d["fact_wire"], dd["customer_wire"]],
        "i4": [d["fact_wire"], dd["d2"]["fact_wire"], d["item_wire"]],
    }
    out = {}
    config.set_flag("METRICS", True)
    try:
        for tag, plan_ops in DISPATCH_PLANS.items():
            plan = json.dumps(plan_ops)
            ids = [rb.table_upload_wire(*w, device=DEVICE) for w in inputs[tag]]
            torch.cuda.synchronize()
            metrics.reset()
            kernels.reset_launches()
            res = rb.table_plan_resident(plan, ids)
            torch.cuda.synchronize()
            launches = {k: v.launches for k, v in kernels.KERNELS.items()}
            tier = metrics.counter_values(["kernel.launches", "kernel.declines"])
            wire = rb.table_download_wire(res)
            rb.table_free(res)
            got = DISPATCH_CHECKS[tag](d, dd, wire)
            if tag == "i1":
                cpu = [rb.table_upload_wire(*w, device="cpu")
                       for w in inputs[tag]]
                ref = rb.table_plan_resident(plan, cpu)
                got["checks"]["bytes_equal_cpu"] = (
                    tuple(rb.table_download_wire(ref)) == tuple(wire))
                for t in cpu + [ref]:
                    rb.table_free(t)
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                res = rb.table_plan_resident(plan, ids)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                rb.table_free(res)
            median = statistics.median(times)
            log(f"({tag}) {got}; wall median {median:.2f} ms over 5 runs (all: "
                f"{[round(t, 2) for t in times]}); launches {launches}; "
                f"tier {tier}")
            profile = profile_plan(plan_runner(rb, plan, ids), median,
                                   f"({tag})")
            for t in ids:
                rb.table_free(t)
            bad = [k for k, ok in got["checks"].items() if not ok]
            if bad:
                raise AssertionError(f"({tag}) differs: {bad}")
            missing = [k for k in DISPATCH_KERNELS[tag] if launches[k] == 0]
            if missing:
                raise AssertionError(f"({tag}) never launched {missing}")
            out[tag] = {"launches": launches, "tier": tier, "wall_ms": median,
                        "profile": profile, **got}
    finally:
        config.clear_flag("METRICS")
    return out


def dispatch_kernel_records(d: dict, dd: dict, qi: dict) -> list:
    """K2a and K2b at (i1)'s semi join: the build over the category's item
    keys and the probe with every fact key. Bytes as the join's records
    count them."""
    from spark_rapids_jni_tpu_torch import dtype as dt
    from spark_rapids_jni_tpu_torch.kernels import hash_table as ht
    from spark_rapids_jni_tpu_torch.kernels import registry

    la = qi["i1"]["launches"]
    blo, bhi = key_halves(dd["items"], dt.INT64)
    bval = torch.ones_like(blo)
    nb = blo.shape[1]
    ns = 2 * registry._next_pow2(nb)
    built = ht.build_table(blo, bhi, bval, table_slots=ns)
    rounds = build_rounds(blo, bhi, bval, built, ns, ht.MAX_PROBES)
    recs = [kernel_record(
        ht.BUILD, "semi", f"1x{nb} keys, {ns} slots", la["build_table"],
        lambda: ht.build_table(blo, bhi, bval, table_slots=ns),
        lambda: ht.build_table_plain(blo, bhi, bval, table_slots=ns),
        12 * nb + 4 * nb + 12 * ns + 8, 20 * nb,
        note=f"(i1)/(i2)'s build; regime {ht.build_regime(nb, ns)}, "
             f"{rounds} probe rounds")]
    plo, phi = key_halves(d["item_sk"], dt.INT64)
    pval = torch.ones_like(plo)
    npb = plo.shape[1]
    tables = built[1:4]
    recs.append(kernel_record(
        ht.PROBE, "semi", f"1x{npb} keys, {ns} slots", la["probe_table"],
        lambda: ht.probe_table(plo, phi, pval, *tables),
        lambda: ht.probe_table_plain(plo, phi, pval, *tables),
        12 * npb + 12 * ns + 8 * npb + 4, 20 * npb,
        note="(i1)/(i2)'s probe: every fact row"))
    return recs


def same_buffers(a, b, what: str) -> None:
    """Two tables' host buffers (``interop.table_to_buffers``) equal."""
    for i, (x, y) in enumerate(zip(a, b)):
        for part, u, v in zip(("data", "validity", "lengths"), x[:3], y[:3]):
            if (u is None) != (v is None) or (
                    u is not None and (u.dtype != v.dtype
                                       or not np.array_equal(u, v))):
                raise AssertionError(f"{what}: column {i} {part} differs")
        if x[3:] != y[3:]:
            raise AssertionError(f"{what}: column {i} type differs")
    if len(a) != len(b):
        raise AssertionError(f"{what}: column counts differ")


def phase_remaining_ops(rb, d: dict, seed: int) -> dict:
    """(j): every other new op once on the card at 2^20 rows, byte for
    byte against the port's own CPU run of the same call (``sample``'s
    rows come from the seed, so they must match too)."""
    from spark_rapids_jni_tpu_torch import interop, ops

    n = OPS_ROWS
    fact = (FACT_TYPES[:4] + [11], [0] * 5,
            [d[k][:n].tobytes() for k in ("item_sk", "customer_sk", "date_sk",
                                          "quantity", "keep")],
            [None, d["customer_ok"][:n].astype(np.uint8).tobytes(), None,
             d["quantity_ok"][:n].astype(np.uint8).tobytes(), None], n)
    dates = np.arange(2_450_816, 2_452_642, dtype=np.int64)
    cats = np.arange(1, 11, dtype=np.int32)
    dates_wire = ([4], [0], [dates.tobytes()], [None], dates.shape[0])
    cats_wire = ([3], [0], [cats.tobytes()], [None], cats.shape[0])
    cases = {
        "right join": ([fact, d["item_wire"]],
                       {"op": "join", "how": "right", "on": [0]}),
        "cross_join": ([dates_wire, cats_wire], {"op": "cross_join"}),
        "slice": ([fact], {"op": "slice", "start": 1000, "stop": 700_000}),
        "repeat": ([fact], {"op": "repeat", "count": 3}),
        "sample": ([fact], {"op": "sample", "n": n // 10, "seed": seed + 7}),
        "sample with replacement": (
            [fact], {"op": "sample", "n": n // 10, "seed": seed + 7,
                     "replacement": True}),
        "collect by day": (
            [fact], {"op": "groupby", "by": [2],
                     "aggs": [{"column": 3, "agg": "collect_list"},
                              {"column": 3, "agg": "collect_set"}]}),
    }
    out = {}
    for what, (wires, op) in cases.items():
        got = []
        for dev in (DEVICE, "cpu"):
            ids = [rb.table_upload_wire(*w, device=dev) for w in wires]
            res = rb.table_op_resident(json.dumps(op), ids)
            got.append(rb.table_download_wire(res))
            for t in ids + [res]:
                rb.table_free(t)
        if tuple(got[0]) != tuple(got[1]):
            raise AssertionError(f"(j) {what}: the card's bytes differ from "
                                 "the CPU's")
        out[what] = int(got[0][4])
    # a donated input is freed by the call, after the op's check
    donated = rb.table_upload_wire(*fact, device=DEVICE)
    res = rb.table_op_resident(json.dumps(cases["slice"][1]), [donated],
                               donate=True)
    try:
        rb.table_num_rows(donated)
        raise AssertionError("(j) a donated input is still live")
    except KeyError:
        pass
    rb.table_free(res)
    # the ops-level calls
    bufs = {dev: interop.table_from_buffers(
        [(np.frombuffer(b, np.dtype(t)), None if v is None
          else np.frombuffer(v, np.uint8).astype(bool), None, tid, 0)
         for b, v, t, tid in zip(fact[2], fact[3],
                                 ("<i8", "<i8", "<i8", "<i4", "u1"),
                                 fact[0])], device=dev)
        for dev in (DEVICE, "cpu")}
    for what, fn in (
            ("distinct_capped",
             lambda t: ops.distinct_capped(t, keys=[1, 2])[0]),
            ("drop_nulls", lambda t: ops.drop_nulls(t, keys=[1, 3]))):
        card, host = (interop.table_to_buffers(fn(bufs[k]))
                      for k in (DEVICE, "cpu"))
        same_buffers(card, host, f"(j) {what}")
        out[what] = int(card[0][0].shape[0])
    log(f"(j) remaining ops at {n} rows: equal to the CPU run's bytes; rows "
        f"out {out}; a donated input was freed")
    return out


# ---------------------------------------------------------------------------
# (k): STRING columns through the wire and the dispatch plane
# ---------------------------------------------------------------------------

# dsdgen's vocabularies, cut to the shapes the cells need: i_brand is two
# brand syllables and " #n" (11-20 bytes, 1,000 brands), i_category one of
# the 10 TPC-DS categories, i_class 32 class names; c_customer_id the 16
# letters of mk_bkey, the names and birth countries from fixed lists
BRAND_SYLLABLES = [b"amalg", b"edu pack", b"export", b"import", b"scholar",
                   b"univ", b"corp", b"brand", b"maxi", b"nameless"]
CATEGORIES = [b"Women", b"Men", b"Children", b"Shoes", b"Music", b"Jewelry",
              b"Home", b"Sports", b"Books", b"Electronics"]
CLASSES = [b"dresses", b"shirts", b"pants", b"accessories", b"athletic",
           b"kids", b"infants", b"toddlers", b"newborn", b"womens", b"mens",
           b"swimwear", b"fragrances", b"pop", b"rock", b"country",
           b"classical", b"jewelry boxes", b"bracelets", b"rings", b"bedding",
           b"furniture", b"lighting", b"golf", b"tennis", b"fiction",
           b"history", b"reference", b"computers", b"televisions", b"cameras",
           b"stereo"]
FIRST_NAMES = [b"James", b"Mary", b"John", b"Patricia", b"Robert",
               b"Jennifer", b"Michael", b"Linda", b"William", b"Elizabeth",
               b"David", b"Barbara", b"Richard", b"Susan", b"Joseph",
               b"Jessica", b"Thomas", b"Sarah", b"Charles", b"Karen",
               b"Christopher", b"Nancy", b"Daniel", b"Lisa", b"Matthew",
               b"Betty", b"Anthony", b"Margaret", b"Mark", b"Sandra",
               "José".encode(), "Zoë".encode()]
LAST_NAMES = [b"Smith", b"Johnson", b"Williams", b"Brown", b"Jones",
              b"Garcia", b"Miller", b"Davis", b"Rodriguez", b"Martinez",
              b"Hernandez", b"Lopez", b"Gonzalez", b"Wilson", b"Anderson",
              b"Thomas", b"Taylor", b"Moore", b"Jackson", b"Martin", b"Lee",
              b"Perez", b"Thompson", b"White", b"Harris", b"Sanchez",
              b"Clark", b"Ramirez", b"Lewis", b"Robinson", "Müller".encode(),
              "Nakamura".encode()]
COUNTRIES = [b"UNITED STATES", b"CANADA", b"MEXICO", b"GERMANY", b"FRANCE",
             b"JAPAN", b"CHINA", b"INDIA", b"BRAZIL", b"NIGERIA",
             b"NEW ZEALAND", b"SOUTH AFRICA", b"FIJI", b"PERU", b"SPAIN",
             "CÔTE D'IVOIRE".encode()]
NAME_NULLS = 0.035
K1_PATTERN = "^(Books|Electronics|Music)$"
K3_ROWS = 1 << 23
K4_ROWS = 1 << 20
STRING_PLANS = {
    # SUM/COUNT(ss_quantity) by i_brand over three categories, ORDER BY
    # the sum desc, brand (TPC-DS q3/q52/q55's shape)
    "k1": [FROM_FACT_ROWS, {"op": "join", "how": "inner", "on": [0]},
           {"op": "rlike", "column": 6, "pattern": K1_PATTERN},
           {"op": "groupby", "by": [5], "aggs": [
               {"column": 3, "agg": "sum"}, {"column": 3, "agg": "count"}]},
           {"op": "sort_by", "keys": [{"column": 1, "ascending": False},
                                      {"column": 0}]}],
    # a customer's total by (c_customer_id, c_first_name, c_last_name),
    # joined on c_customer_id with the birth country, then the shuffle
    # on c_customer_id (TPC-DS q11/q74's shape)
    "k2": [FROM_FACT_ROWS, {"op": "join", "how": "inner", "on": [1]},
           {"op": "groupby", "by": [5, 6, 7],
            "aggs": [{"column": 3, "agg": "sum"}]},
           {"op": "join", "how": "inner", "on": [0]},
           {"op": "partition", "kind": "hash", "keys": [0],
            "num": EXCHANGE_PARTITIONS}],
    # CAST(price AS STRING), CAST(bigint AS STRING), and the price's
    # round trip CAST(CAST(price AS STRING) AS DOUBLE)
    "k3": [{"op": "cast", "column": 0, "type_id": 23},
           {"op": "cast", "column": 1, "type_id": 23},
           {"op": "cast", "column": 2, "type_id": 23},
           {"op": "cast", "column": 2, "type_id": 10}],
}
STRING_KERNELS = {"k1": ("unpack_rows", "build_table", "probe_table"),
                  "k2": ("unpack_rows", "build_table", "probe_table"),
                  "k3": ()}


def string_wire(vocab, idx: np.ndarray, valid=None):
    """(offsets + payload bytes, validity bytes | None) of a STRING column
    whose row i is ``vocab[idx[i]]`` (null where ``valid`` is False)."""
    lens_v = np.array([len(v) for v in vocab], np.int32)
    mat_v = np.zeros((len(vocab), max(lens_v.max(), 1)), np.uint8)
    for i, v in enumerate(vocab):
        mat_v[i, :len(v)] = np.frombuffer(v, np.uint8)
    lens = lens_v[idx]
    if valid is not None:
        lens = np.where(valid, lens, 0).astype(np.int32)
    return padded_wire(mat_v[idx], lens, valid)


def padded_wire(mat: np.ndarray, lens: np.ndarray, valid=None):
    offs = np.zeros(lens.shape[0] + 1, np.int32)
    np.cumsum(lens, out=offs[1:])
    payload = mat[np.arange(mat.shape[1])[None, :] < lens[:, None]]
    return (offs.tobytes() + payload.tobytes(),
            None if valid is None else valid.astype(np.uint8).tobytes())


def customer_ids(sk: np.ndarray) -> np.ndarray:
    """dsdgen's c_customer_id: 16 letters, "AAAAAAAA" then the key's eight
    nibbles as 'A' + nibble, the low nibble first."""
    n = sk.shape[0]
    mat = np.full((n, 16), ord("A"), np.uint8)
    for k in range(8):
        mat[:, 8 + k] += ((sk >> (4 * k)) & 15).astype(np.uint8)
    return mat


def make_string_data(rng, d: dict) -> dict:
    """(k)'s tables: SF100 item with i_brand/i_category/i_class, SF100
    customer with c_customer_id and ~3.5 % null names, the (c_customer_id,
    c_birth_country) side, (k2)'s fact rows (those of (a)'s batch whose
    ss_customer_sk is not null: Spark infers isnotnull for the inner
    join's key and pushes it into the scan), (k3)'s prices and bigints."""
    brands = [a + b + b" #" + str(c + 1).encode() for a in BRAND_SYLLABLES
              for b in BRAND_SYLLABLES for c in range(10)]
    brand_idx = d["i_brand_id"] - 1_001_001
    cat_idx = d["i_category_id"] - 1
    class_idx = rng.integers(0, len(CLASSES), ITEM_ROWS)
    cols = [string_wire(brands, brand_idx), string_wire(CATEGORIES, cat_idx),
            string_wire(CLASSES, class_idx)]
    item = ([4, 23, 23, 23], [0] * 4,
            [d["i_item_sk"].tobytes()] + [c[0] for c in cols],
            [None] * 4, ITEM_ROWS)
    sk = np.arange(1, CUSTOMER_ROWS + 1, dtype=np.int64)
    ids = customer_ids(sk)
    id_wire = padded_wire(ids, np.full(CUSTOMER_ROWS, 16, np.int32))
    first_ok = rng.random(CUSTOMER_ROWS) > NAME_NULLS
    last_ok = rng.random(CUSTOMER_ROWS) > NAME_NULLS
    first = string_wire(FIRST_NAMES, rng.integers(0, len(FIRST_NAMES),
                                                  CUSTOMER_ROWS), first_ok)
    last = string_wire(LAST_NAMES, rng.integers(0, len(LAST_NAMES),
                                                CUSTOMER_ROWS), last_ok)
    country_idx = rng.integers(0, len(COUNTRIES), CUSTOMER_ROWS)
    country = string_wire(COUNTRIES, country_idx)
    # the join key at the fact's customer_sk index: a join's "on" names
    # one column index on both sides
    customer = ([23, 4, 23, 23], [0] * 4,
                [id_wire[0], sk.tobytes(), first[0], last[0]],
                [None, None, first[1], last[1]], CUSTOMER_ROWS)
    id_country = ([23, 23], [0, 0], [id_wire[0], country[0]], [None, None],
                  CUSTOMER_ROWS)
    keep = d["customer_ok"]
    rows = d["rows"][keep]
    n2 = rows.shape[0]
    offs = (np.arange(n2 + 1, dtype=np.int64) * 32).astype(np.int32)
    fact2 = ([24], [5], [offs.tobytes() + rows.tobytes()], [None], n2)
    price = np.round(rng.random(K3_ROWS) * 200, 2)
    bigint = rng.integers(-2**63, 2**63 - 1, K3_ROWS, dtype=np.int64,
                          endpoint=True)
    bigint[:4] = [0, -1, -2**63, 2**63 - 1]
    casts = ([10, 4, 10], [0, 0, 0],
             [price.tobytes(), bigint.tobytes(), price.tobytes()],
             [None] * 3, K3_ROWS)
    return {"brands": brands, "brand_idx": brand_idx, "cat_idx": cat_idx,
            "item_wire": item, "customer_wire": customer,
            "id_country_wire": id_country, "fact2_wire": fact2,
            "fact2_rows": n2, "cast_wire": casts, "price": price,
            "bigint": bigint, "country_idx": country_idx, "ids": ids,
            "first_ok": first_ok, "last_ok": last_ok}


def wire_strings(wire, col: int) -> list:
    """Column ``col`` of a wire result as bytes values (None for null)."""
    type_ids, _, datas, valids, n = wire
    if type_ids[col] != 23:
        raise AssertionError(f"column {col} is not STRING")
    offs = np.frombuffer(datas[col], np.int32, n + 1)
    payload = datas[col][4 * (n + 1):]
    valid = (np.ones(n, bool) if valids[col] is None
             else np.frombuffer(valids[col], np.uint8, n).astype(bool))
    return [payload[offs[i]:offs[i + 1]] if valid[i] else None
            for i in range(n)]


def wire_values(wire, col: int, dtype) -> np.ndarray:
    return np.frombuffer(wire[2][col], dtype, wire[4])


def check_k1(d: dict, sd: dict, wire) -> dict:
    """(k1) against numpy and Python's ``re.fullmatch``: the kept
    categories, per brand the quantity sum and count, the order."""
    keep_cat = np.array([re.fullmatch(K1_PATTERN.encode(), c) is not None
                         for c in CATEGORIES])
    m = keep_cat[sd["cat_idx"][d["item_sk"]]]
    brand = sd["brand_idx"][d["item_sk"]][m]
    qok, qty = d["quantity_ok"][m], d["quantity"][m].astype(np.int64)
    total = np.bincount(brand[qok], weights=qty[qok], minlength=1000)
    count = np.bincount(brand[qok], minlength=1000)
    seen = np.bincount(brand, minlength=1000) > 0
    ids = np.flatnonzero(seen)
    names = [sd["brands"][i] for i in ids]
    order = sorted(range(ids.shape[0]),
                   key=lambda i: (-int(total[ids[i]]), names[i]))
    want_names = [names[i] for i in order]
    got_names = wire_strings(wire, 0)
    checks = {
        "rows": wire[4] == ids.shape[0],
        "brand": got_names == want_names,
        "sum": np.array_equal(wire_values(wire, 1, np.int64),
                              total[ids[order]].astype(np.int64)),
        "count": np.array_equal(wire_values(wire, 2, np.int64),
                                count[ids[order]]),
        "categories": [c.decode() for c, k in zip(CATEGORIES, keep_cat) if k]
        == ["Music", "Books", "Electronics"],
    }
    return {"checks": checks, "rows_kept": int(m.sum()),
            "brands": int(ids.shape[0])}


def check_k2(d: dict, sd: dict, wire) -> dict:
    """(k2) against numpy: the customers that bought, each with its sum,
    names and birth country, and every row in the partition Spark's
    Murmur3 of the 16-byte id gives (pmod 200, non-decreasing)."""
    keep = d["customer_ok"]
    cust = d["customer_sk"][keep]
    qok = d["quantity_ok"][keep]
    total = np.bincount(cust[qok], weights=d["quantity"][keep][qok],
                        minlength=CUSTOMER_ROWS + 1).astype(np.int64)
    seen = np.bincount(cust, minlength=CUSTOMER_ROWS + 1) > 0
    n = wire[4]
    ids = np.frombuffer(wire[2][0], np.uint8, offset=4 * (n + 1)).reshape(n, 16)
    got_sk = ((ids[:, 8:].astype(np.int64) - 65)
              << (4 * np.arange(8))[None, :]).sum(axis=1)
    h = murmur3_string_np(ids)
    part = np.mod(h.view(np.int32).astype(np.int64), EXCHANGE_PARTITIONS)
    countries = wire_strings(wire, 4)
    checks = {
        "rows": wire[4] == int(seen.sum()),
        "customers": np.array_equal(np.sort(got_sk), np.flatnonzero(seen)),
        "sum": np.array_equal(wire_values(wire, 3, np.int64), total[got_sk]),
        "country": countries == [COUNTRIES[i]
                                 for i in sd["country_idx"][got_sk - 1]],
        "first_null": np.array_equal(
            np.array([v is None for v in wire_strings(wire, 1)]),
            ~sd["first_ok"][got_sk - 1]),
        "partition_order": bool(np.all(np.diff(part) >= 0)),
    }
    return {"checks": checks, "rows_in": int(sd["fact2_rows"]),
            "groups": int(wire[4])}


def murmur3_string_np(mat: np.ndarray) -> np.ndarray:
    """Spark's Murmur3 (seed 42) of equal-length byte strings whose length
    is a multiple of 4 (no tail), as uint32."""
    n, width = mat.shape
    h = np.full(n, 42, np.uint32)
    words = mat.view("<u4")
    for w in range(width // 4):
        h = _mix_h1(h, _mix_k1(words[:, w].copy()))
    h = h ^ np.uint32(width)
    h ^= h >> np.uint32(16)
    h = h * np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def java_double_string(v: float) -> str:
    """Java ``Double.toString``'s layout of a finite double, the rules the
    JAX package's tests encode: plain decimal in [1e-3, 1e7) with at
    least one fraction digit, else the shortest digits as d.dddE[-]x."""
    if v == 0.0:
        return "-0.0" if np.signbit(v) else "0.0"
    if 1e-3 <= abs(v) < 1e7:
        return f"{v:.1f}" if v == int(v) else repr(float(v))
    s = repr(abs(float(v)))
    m, e10 = (s.split("e")[0], int(s.split("e")[1])) if "e" in s else (s, 0)
    ip, _, fp = m.partition(".")
    raw = ip + fp
    digs = raw.lstrip("0").rstrip("0") or "0"
    exp10 = e10 - len(fp) + (len(raw) - len(raw.rstrip("0")))
    sci = len(digs) - 1 + exp10
    return f"{'-' if v < 0 else ''}{digs[0]}.{digs[1:] or '0'}E{sci}"


def check_k3(sd: dict, wire) -> dict:
    """(k3): the price's round trip gives back its bits; a sample of the
    price strings follows Java's Double.toString, of the bigint strings
    Python's ``str``."""
    price, bigint = sd["price"], sd["bigint"]
    back = wire_values(wire, 2, np.float64)
    sample = np.unique(np.concatenate([np.arange(4), np.random.default_rng(
        1).integers(0, K3_ROWS, 20_000)]))
    type_ids, _, datas, _, n = wire
    pstr, bstr = (np.frombuffer(datas[c], np.int32, n + 1) for c in (0, 1))
    def at(col, offs, i):
        return datas[col][4 * (n + 1) + offs[i]:4 * (n + 1) + offs[i + 1]]
    checks = {
        "types": type_ids == [23, 23, 10],
        "round_trip_bits": np.array_equal(back.view(np.uint64),
                                          price.view(np.uint64)),
        "java_strings": all(at(0, pstr, i).decode()
                            == java_double_string(price[i]) for i in sample),
        "bigint_strings": all(at(1, bstr, i).decode() == str(bigint[i])
                              for i in sample),
    }
    return {"checks": checks, "sampled": int(sample.shape[0])}


STRING_CHECKS = {"k1": check_k1, "k2": check_k2}


def op_profile(fn, tag: str, nbytes: int, runs: int = 3) -> dict:
    """Launches and device time a call of one plain op, from
    ``torch.profiler`` (the DFA scan and the Murmur3 string chain run
    small ops a pad column), beside the bound of ``nbytes`` moved once."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = [e for e in device_events(prof) if e.self_device_time_total > 0]
    out = {"launches": sum(e.count for e in events) / runs,
           "device_ms": sum(e.self_device_time_total for e in events)
           / 1e3 / runs, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    log(f"{tag}: {out['launches']:g} launches, {out['device_ms']:.3f} ms of "
        f"device time a call (bound {out['bound_ms']:.4f} ms)")
    return out


def phase_strings(rb, kernels, d: dict, sd: dict) -> dict:
    """(k1)-(k3): resident plans through ``table_upload_wire`` +
    ``table_plan_resident``, each run once, checked against numpy and
    byte for byte against the port's own CPU run, then 5 timed runs, the
    host syncs of one run and a profiled window."""
    from spark_rapids_jni_tpu_torch.utils import config, metrics

    inputs = {"k1": [d["fact_wire"], sd["item_wire"]],
              "k2": [sd["fact2_wire"], sd["customer_wire"],
                     sd["id_country_wire"]],
              "k3": [sd["cast_wire"]]}
    out = {}
    config.set_flag("METRICS", True)
    try:
        for tag, plan_ops in STRING_PLANS.items():
            plan = json.dumps(plan_ops)
            ids = [rb.table_upload_wire(*w, device=DEVICE) for w in inputs[tag]]
            torch.cuda.synchronize()
            metrics.reset()
            kernels.reset_launches()
            res = rb.table_plan_resident(plan, ids)
            torch.cuda.synchronize()
            launches = {k: v.launches for k, v in kernels.KERNELS.items()}
            tier = metrics.counter_values(["kernel.launches", "kernel.declines"])
            wire = rb.table_download_wire(res)
            rb.table_free(res)
            got = (check_k3(sd, wire) if tag == "k3"
                   else STRING_CHECKS[tag](d, sd, wire))
            cpu = [rb.table_upload_wire(*w, device="cpu") for w in inputs[tag]]
            ref = rb.table_plan_resident(plan, cpu)
            got["checks"]["bytes_equal_cpu"] = (
                tuple(rb.table_download_wire(ref)) == tuple(wire))
            for t in cpu + [ref]:
                rb.table_free(t)
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                res = rb.table_plan_resident(plan, ids)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                rb.table_free(res)
            median = statistics.median(times)
            syncs = count_syncs(plan_runner(rb, plan, ids))
            log(f"({tag}) {got}; wall median {median:.2f} ms over 5 runs (all: "
                f"{[round(t, 2) for t in times]}); host syncs a run {syncs}; "
                f"launches {launches}; tier {tier}")
            profile = profile_plan(plan_runner(rb, plan, ids), median,
                                   f"({tag})")
            for t in ids:
                rb.table_free(t)
            bad = [k for k, ok in got["checks"].items() if not ok]
            if bad:
                raise AssertionError(f"({tag}) differs: {bad}")
            missing = [k for k in STRING_KERNELS[tag] if launches[k] == 0]
            if missing:
                raise AssertionError(f"({tag}) never launched {missing}")
            out[tag] = {"launches": launches, "tier": tier, "wall_ms": median,
                        "syncs": syncs, "profile": profile, **got}
    finally:
        config.clear_flag("METRICS")
    out["plain_ops"] = string_op_profiles(rb, sd)
    return out


def string_op_profiles(rb, sd: dict) -> dict:
    """The DFA scan of (k1)'s rlike over its 2^23 joined category strings
    (pad 11) and the Murmur3 string chain of (k2)'s partition over the
    2,000,000 customer ids (pad 16), alone: launches and device time a
    call."""
    from spark_rapids_jni_tpu_torch.column import Column, Table
    from spark_rapids_jni_tpu_torch.ops import hashing, regex

    cats = Column.from_strings(
        [CATEGORIES[i] for i in range(10)], device=DEVICE)
    idx = torch.from_numpy(sd["cat_idx"][np.random.default_rng(2).integers(
        0, ITEM_ROWS, FACT_ROWS)]).to(DEVICE)
    joined = Column(cats.data[idx], cats.dtype, None, cats.lengths[idx])
    ids = torch.from_numpy(sd["ids"]).to(DEVICE)
    keys = Table([Column(ids, joined.dtype, None,
                         torch.full((ids.shape[0],), 16, dtype=torch.int32,
                                    device=DEVICE))])
    n, pad = joined.data.shape
    m = ids.shape[0]
    return {
        # bytes and int32 lengths in, a bool a row out
        "dfa_scan": op_profile(lambda: regex.contains_re(joined, K1_PATTERN),
                               f"(k) DFA scan, {n} x pad {pad}",
                               n * (pad + 4 + 1)),
        # bytes and int32 lengths in, an int32 hash a row out
        "murmur3_string": op_profile(
            lambda: hashing.murmur3_table(keys, [0]),
            f"(k) Murmur3 string chain, {m} x pad 16", m * (16 + 4 + 4)),
    }


def string_kernel_records(d: dict, sd: dict, qk: dict) -> list:
    """K2a and K2b at (k2)'s join: the build over SF100's 2,000,000
    customer keys (the largest build of any cell) and the probe with the
    fact rows that have a customer. Bytes as the join's records count
    them."""
    from spark_rapids_jni_tpu_torch import dtype as dt
    from spark_rapids_jni_tpu_torch.kernels import hash_table as ht
    from spark_rapids_jni_tpu_torch.kernels import registry

    la = qk["k2"]["launches"]
    sk = np.arange(1, CUSTOMER_ROWS + 1, dtype=np.int64)
    blo, bhi = key_halves(sk, dt.INT64)
    bval = torch.ones_like(blo)
    nb = blo.shape[1]
    ns = 2 * registry._next_pow2(nb)
    built = ht.build_table(blo, bhi, bval, table_slots=ns)
    rounds = build_rounds(blo, bhi, bval, built, ns, ht.MAX_PROBES)
    recs = [kernel_record(
        ht.BUILD, "customer", f"1x{nb} keys, {ns} slots", la["build_table"],
        lambda: ht.build_table(blo, bhi, bval, table_slots=ns),
        lambda: ht.build_table_plain(blo, bhi, bval, table_slots=ns),
        12 * nb + 4 * nb + 12 * ns + 8, 20 * nb,
        note=f"(k2)'s build; regime {ht.build_regime(nb, ns)}, "
             f"{rounds} probe rounds")]
    plo, phi = key_halves(d["customer_sk"][d["customer_ok"]], dt.INT64)
    pval = torch.ones_like(plo)
    npb = plo.shape[1]
    tables = built[1:4]
    recs.append(kernel_record(
        ht.PROBE, "customer", f"1x{npb} keys, {ns} slots", la["probe_table"],
        lambda: ht.probe_table(plo, phi, pval, *tables),
        lambda: ht.probe_table_plain(plo, phi, pval, *tables),
        12 * npb + 12 * ns + 8 * npb + 4, 20 * npb,
        note="(k2)'s probe: the fact rows with a customer"))
    return recs


def same_column(a, b, what: str) -> None:
    """Two columns' host buffers equal (data, validity, lengths, type)."""
    from spark_rapids_jni_tpu_torch import interop
    from spark_rapids_jni_tpu_torch.column import Table

    same_buffers(interop.table_to_buffers(Table([a])),
                 interop.table_to_buffers(Table([b])), what)


def phase_string_ops(rb, sd: dict, seed: int) -> dict:
    """(k4): the rest of the string surface once at 2^20 rows on the card,
    byte for byte against the port's own CPU run: explode/explode_outer,
    the regex span ops, comparisons and ||, distinct on strings, a
    descending sort on a nullable string, concat and cross_join of tables
    of two pad widths, STRING -> BOOL/INT/DECIMAL64 with unparseable
    rows; the strings hold non-ASCII UTF-8."""
    from spark_rapids_jni_tpu_torch import dtype as dt
    from spark_rapids_jni_tpu_torch import interop
    from spark_rapids_jni_tpu_torch.column import Column
    from spark_rapids_jni_tpu_torch.ops import binaryop, lists, regex
    from spark_rapids_jni_tpu_torch.ops import strings as strings_mod
    from spark_rapids_jni_tpu_torch.ops.cast import cast

    rng = np.random.default_rng(seed + 11)
    n = K4_ROWS
    words = sd["brands"][:200] + CATEGORIES + CLASSES + FIRST_NAMES[-2:] + [
        "Électron".encode(), "東京".encode(), b""]
    numbers = [b"0", b"42", b" -17 ", b"3.75", b"1e3", b"abc", b"", b"true",
               b"NO", b"9223372036854775808", b"-12.345", "１２".encode(),
               b"99999999999999999.99", b"+0.5", b"y"]
    s_ok = rng.random(n) > 0.05
    s_idx = rng.integers(0, len(words), n)
    n_idx = rng.integers(0, len(numbers), n)
    lens = rng.integers(0, 5, n).astype(np.int32)
    l_ok = rng.random(n) > 0.1
    lens = np.where(l_ok, lens, 0).astype(np.int32)
    payload = rng.integers(-50, 50, int(lens.sum())).astype(np.int32)
    list_wire = (np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
                 .tobytes() + payload.tobytes(),
                 l_ok.astype(np.uint8).tobytes())
    s_wire = string_wire(words, s_idx, s_ok)
    table = ([23, 23, 24, 4], [0, 0, 3, 0],
             [s_wire[0], string_wire(numbers, n_idx)[0], list_wire[0],
              np.arange(n, dtype=np.int64).tobytes()],
             [s_wire[1], None, list_wire[1], None], n)
    # (s, numbers, row) without the LIST column, and a 64-row table of
    # the same schema whose strings have another pad width
    flat = ([23, 23, 4], [0, 0, 0], [table[2][i] for i in (0, 1, 3)],
            [table[3][i] for i in (0, 1, 3)], n)
    short = string_wire(CATEGORIES, rng.integers(0, 10, 64))
    short_wire = ([23, 23, 4], [0, 0, 0],
                  [short[0], short[0], np.arange(64, dtype=np.int64).tobytes()],
                  [None] * 3, 64)
    cases = {
        "explode": ([table], {"op": "explode", "column": 2}),
        "distinct": ([table], {"op": "distinct", "keys": [0]}),
        "sort desc nullable": ([table], {"op": "sort_by", "keys": [
            {"column": 0, "ascending": False}, {"column": 3}]}),
        "concat two pads": ([flat, short_wire], {"op": "concat"}),
        "cross_join two pads": ([short_wire, short_wire],
                                {"op": "cross_join"}),
        "rlike": ([table], {"op": "rlike", "column": 0,
                            "pattern": r"#\d$|^[A-Z][a-z]+s$"}),
        "cast to int": ([table], {"op": "cast", "column": 1, "type_id": 4}),
    }
    out = {}
    for what, (wires, op) in cases.items():
        got = []
        for dev in (DEVICE, "cpu"):
            ids = [rb.table_upload_wire(*w, device=dev) for w in wires]
            res = rb.table_op_resident(json.dumps(op), ids)
            got.append(rb.table_download_wire(res))
            for t in ids + [res]:
                rb.table_free(t)
        if tuple(got[0]) != tuple(got[1]):
            raise AssertionError(f"(k4) {what}: the card's bytes differ from "
                                 "the CPU's")
        out[what] = int(got[0][4])
    vals = [None if not ok else words[i] for i, ok in zip(s_idx, s_ok)]
    nums = [numbers[i] for i in n_idx]
    cols = {dev: (Column.from_strings(vals, device=dev),
                  Column.from_strings(nums, device=dev))
            for dev in (DEVICE, "cpu")}
    ops_level = {
        "find_re": lambda s, u: regex.find_re(s, r"\d+"),
        "extract_re": lambda s, u: regex.extract_re(s, r"#(\d+)"),
        "replace_re": lambda s, u: regex.replace_re(s, r"[aeiou]+", "*"),
        "count_re": lambda s, u: regex.count_re(s, r"a"),
        "matches_re": lambda s, u: regex.matches_re(s, r"[a-z ]+"),
        "lt": lambda s, u: binaryop.lt(s, u),
        "eq": lambda s, u: binaryop.eq(s, u),
        "concat ||": lambda s, u: binaryop.add(s, u),
        "to bool": lambda s, u: cast(u, dt.BOOL8),
        "to int32": lambda s, u: cast(u, dt.INT32),
        "to decimal64": lambda s, u: cast(u, dt.decimal64(-2)),
        "to float64": lambda s, u: cast(u, dt.FLOAT64),
        "dictionary": lambda s, u: strings_mod.dictionary_encode(s)[1],
    }
    for what, fn in ops_level.items():
        same_column(fn(*cols[DEVICE]), fn(*cols["cpu"]), f"(k4) {what}")
    list_cols = {dev: rb._table_from_wire(*table[:5], torch.device(dev))
                 for dev in (DEVICE, "cpu")}
    for what, fn in (("explode_outer", lambda t: lists.explode_outer(t, 2)),
                     ("explode_position",
                      lambda t: lists.explode_position(t, 2, outer=True))):
        same_buffers(interop.table_to_buffers(fn(list_cols[DEVICE])),
                     interop.table_to_buffers(fn(list_cols["cpu"])),
                     f"(k4) {what}")
    log(f"(k4) string ops at {n} rows: equal to the CPU run's bytes; rows out "
        f"{out}; ops-level {sorted(ops_level)} and explode_outer/position "
        f"equal")
    return out


# (k5): the string function library over (k)'s customer table and a
# multi-byte UTF-8 column made from --seed: Spark's length, upper,
# substring, instr, lpad/rpad, replace, split(...)[i], concat_ws,
# translate, url codecs, the character classes and their UTF-8 forms
K5_WORDS = ["UNITED STATES", "Mary", "Smith", "Électron", "東京", "Zürich",
            "straße", "Ωmega", "Привет", "😀", "%41", "%2", "%zz", "a+b",
            " pad ", "-12", "+7", "007", "x", "", "İstanbul", "ǅemal"]
K5_INVALID = [b"\xff", b"\xc3", b"a\x80"]
K5_VOCAB = 4096  # distinct composite strings; rows draw from them
K5_NULLS = 0.05


def string_lib() -> dict:
    """name -> one call of the library on a STRING column."""
    from spark_rapids_jni_tpu_torch.ops import strings, strings_utf8

    return {
        "length": lambda c: strings.length(c),
        "upper": lambda c: strings.upper(c),
        "contains": lambda c: strings.contains(c, "an"),
        "starts_with": lambda c: strings.starts_with(c, "Mi"),
        "ends_with": lambda c: strings.ends_with(c, "a"),
        "substring": lambda c: strings.substring(c, 1, 4),
        "lstrip": lambda c: strings.lstrip(c),
        "rstrip": lambda c: strings.rstrip(c, " ,"),
        "find": lambda c: strings.find(c, "an"),
        "lpad": lambda c: strings.pad(c, 16, "left", "*"),
        "rpad": lambda c: strings.pad(c, 17, "right", "-="),
        "replace": lambda c: strings.replace(c, "a", "4"),
        "split_get": lambda c: strings.split_get(c, ",", 1),
        "reverse": lambda c: strings.reverse(c),
        "is_digit": lambda c: strings.is_digit(c),
        "is_alpha": lambda c: strings.is_alpha(c),
        "is_alnum": lambda c: strings.is_alnum(c),
        "is_space": lambda c: strings.is_space(c),
        "is_upper": lambda c: strings.is_upper(c),
        "is_lower": lambda c: strings.is_lower(c),
        "zfill": lambda c: strings.zfill(c, 12),
        "capitalize": lambda c: strings.capitalize(c),
        "title": lambda c: strings.title(c),
        "url_decode": lambda c: strings.url_decode(c),
        "url_encode": lambda c: strings.url_encode(c),
        "translate": lambda c: strings.translate(c, "aeiou,", "AEIOU"),
        "char_length": lambda c: strings_utf8.char_length(c),
        "utf8_substring": lambda c: strings_utf8.utf8_substring(c, 1, 3),
        "utf8_upper": lambda c: strings_utf8.utf8_upper(c),
        "utf8_lower": lambda c: strings_utf8.utf8_lower(c),
    }


def make_k5_wire(seed: int, n: int):
    """(k5)'s UTF-8 column: ``K5_VOCAB`` strings of one to three words
    joined by ',' (at times with a ',' at either end), drawn ``n`` times,
    ``K5_NULLS`` of the rows null."""
    rng = np.random.default_rng(seed + 16)
    words = [w.encode() for w in K5_WORDS] + K5_INVALID
    vocab = []
    for _ in range(K5_VOCAB):
        k = int(rng.integers(1, 4))
        v = b",".join(words[i] for i in rng.integers(0, len(words), k))
        r = rng.random()
        vocab.append(b"," + v if r < 0.1 else v + b"," if r < 0.2 else v)
    idx = rng.integers(0, K5_VOCAB, n)
    ok = rng.random(n) > K5_NULLS
    starts = rng.integers(-2, 12, n).astype(np.int32)
    lens = rng.integers(-1, 10, n).astype(np.int32)
    return string_wire(vocab, idx, ok), starts, lens


# (k5)'s CPU reference child: every core but the one the parent's
# launches run on
K5_REF_THREADS = max((os.cpu_count() or 2) - 1, 1)


def k5_wire(sd: dict, seed: int):
    """(k5)'s input wire table: customer's c_last_name and c_first_name,
    the UTF-8 column (``make_k5_wire``) and the substring starts and
    lengths."""
    n = CUSTOMER_ROWS
    (u_data, u_valid), starts, lens = make_k5_wire(seed, n)
    return ([23, 23, 23, 3, 3], [0] * 5,
            [sd["customer_wire"][2][3], sd["customer_wire"][2][2], u_data,
             starts.tobytes(), lens.tobytes()],
            [sd["customer_wire"][3][3], sd["customer_wire"][3][2], u_valid,
             None, None], n)


def k5_cases() -> dict:
    """(k5)'s calls, each a function of the input table: every function
    of ``string_lib`` over the UTF-8 column, ``concat_ws``,
    ``substring_column``, the width-changing ``replace``; and
    ``split_explode`` (a table)."""
    from spark_rapids_jni_tpu_torch.column import Table
    from spark_rapids_jni_tpu_torch.ops import lists, strings

    last, first, utf8 = 0, 1, 2
    cases = {name: (lambda t, f=fn: Table([f(t.columns[utf8])]))
             for name, fn in string_lib().items()}
    cases.update({
        "concat_ws": lambda t: Table([strings.concat_ws(
            " ", t.columns[first], t.columns[last], t.columns[utf8])]),
        "substring_column": lambda t: Table([strings.substring_column(
            t.columns[utf8], t.columns[3], t.columns[4])]),
        "replace width-changing utf8": lambda t: Table([strings.replace(
            t.columns[utf8], ",", ", ")]),
        "split_explode": lambda t: lists.split_explode(
            Table([t.columns[3], t.columns[utf8]], ["k", "s"]), "s", ","),
    })
    return cases


def k5_cpu_reference(in_path: str, out_path: str) -> int:
    """The body of (k5)'s CPU reference child (``--k5-cpu-reference IN
    OUT``): every call of :func:`k5_cases` on the CPU over the pickled
    input wire table, its host buffers (``interop.table_to_buffers``)
    pickled to ``out_path``. Needs no GPU."""
    import pickle

    from spark_rapids_jni_tpu_torch import interop
    from spark_rapids_jni_tpu_torch import runtime_bridge as rb

    torch.set_num_threads(K5_REF_THREADS)
    with open(in_path, "rb") as f:
        wire = pickle.load(f)
    t0 = time.perf_counter()
    table = rb._table_from_wire(*wire, torch.device("cpu"))
    out = {what: interop.table_to_buffers(fn(table))
           for what, fn in k5_cases().items()}
    out["_cpu_s"] = time.perf_counter() - t0
    write_reference(out_path, out)
    return 0


class CpuReference:
    """A phase's CPU run as a child process, started with the phase so
    that it runs beside the phase's calls on the card: it pickles the
    phase's input to ``build/<tag>_reference/``, runs this script with
    ``flag IN OUT`` there (``K5_REF_THREADS`` torch threads, its output
    in ``child.log``), and :meth:`result` waits for the child's pickled
    buffers. :meth:`stop` ends it and removes the files."""

    def __init__(self, tag: str, flag: str, payload):
        import pickle

        self.tag = tag
        self.dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "build", f"{tag}_reference")
        os.makedirs(self.dir, exist_ok=True)
        self.inp = os.path.join(self.dir, "in.pkl")
        self.out = os.path.join(self.dir, "out.pkl")
        for path in (self.inp, self.out):
            if os.path.exists(path):
                os.remove(path)
        with open(self.inp, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        self.log = open(os.path.join(self.dir, "child.log"), "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, self.inp,
             self.out], stdout=self.log, stderr=subprocess.STDOUT)

    def result(self, timeout: float = 900.0) -> dict:
        import pickle

        rc = self.proc.wait(timeout=timeout)
        waited = time.perf_counter() - self.t0
        if rc != 0:
            self.log.flush()
            with open(os.path.join(self.dir, "child.log")) as f:
                tail = f.read()[-3000:]
            raise RuntimeError(
                f"({self.tag}) CPU reference child exited {rc}:\n{tail}")
        with open(self.out, "rb") as f:
            ref = pickle.load(f)
        log(f"({self.tag}) CPU reference child: {ref['_cpu_s']:.1f} s of CPU "
            f"run ({K5_REF_THREADS} torch threads), done {waited:.1f} s "
            "after its start")
        ref["_waited_s"] = waited
        return ref

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()
        for path in (self.inp, self.out):
            if os.path.exists(path):
                os.remove(path)


def write_reference(out_path: str, out: dict) -> None:
    """A CPU reference child's result, pickled to ``out_path`` at once
    (the parent reads only a whole file)."""
    import pickle

    with open(out_path + ".part", "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(out_path + ".part", out_path)


def phase_string_lib(rb, sd: dict, seed: int) -> dict:
    """(k5): every function of the string library (``string_lib``, then
    ``concat_ws`` of the customer table's c_first_name and c_last_name
    (nulls) with a 2,000,000-row multi-byte UTF-8 column,
    ``substring_column``, the width-changing ``replace`` and
    ``split_explode``) on the card over the UTF-8 column, byte for byte
    against the port's own CPU run of the same function on the same
    input, which a :class:`CpuReference` child computes while the calls
    run on the card; each function's device time and launches from the
    profiler."""
    from spark_rapids_jni_tpu_torch import interop

    n = CUSTOMER_ROWS
    reference = CpuReference("k5", "--k5-cpu-reference", k5_wire(sd, seed))
    try:
        table = rb._table_from_wire(*k5_wire(sd, seed), torch.device(DEVICE))
        out, got = {}, {}
        for what, fn in k5_cases().items():
            res = fn(table)
            got[what] = interop.table_to_buffers(res)
            nbytes = (table.columns[2].data.numel() if what == "split_explode"
                      else table.columns[2].data.numel() + 5 * n)
            out[what] = op_profile(lambda f=fn: f(table), f"(k5) {what}",
                                   nbytes)
            if what == "split_explode":
                out[what]["rows_out"] = res.row_count
            del res
        want = reference.result()
    finally:
        reference.stop()
    for what, bufs in got.items():
        same_buffers(bufs, want[what], f"(k5) {what}")
    log(f"(k5) string library at {n} rows: {len(got)} calls equal to "
        f"the CPU run's bytes; split_explode gives "
        f"{out['split_explode']['rows_out']} rows")
    return out


def ptxas_lines(text: str) -> list:
    """One line a kernel from ``nvcc -Xptxas -v`` output: its (mangled)
    name, registers, static shared memory and spills."""
    out, name, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spill stores/loads {m.group(1)}/{m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, "
                       f"{m.group(2) or 0} B static smem, {spill}")
            name = None
    return out


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# (l) DECIMAL128: one Spark task's batch of TPC-H lineitem
# ---------------------------------------------------------------------------

DEC_ROWS = 1 << 23  # one task's batch, as (a)
DEC_OPS_ROWS = 1 << 20  # (l3), cut as (j) for the script's time
DEC_NULLS = 0.02
EPOCH_1992 = 8036  # days from 1970-01-01 to 1992-01-01
SHIP_FIRST, SHIP_LAST = EPOCH_1992 + 1, EPOCH_1992 + 2526  # 1992-01-02, 1998-12-01
SHIP_CUTOFF = EPOCH_1992 + 2436  # 1998-09-02: q1's DATE '1998-12-01' - 90 days
TPCH_CURRENT = EPOCH_1992 + 1263  # 1995-06-17, the spec's CURRENTDATE
RETURNFLAGS = [b"A", b"N", b"R"]
LINESTATUS = [b"F", b"O"]
# lineitem as the wire carries it: l_quantity, l_extendedprice, l_discount
# and l_tax as DECIMAL64 at scale -2 (decimal(12,2)), l_returnflag and
# l_linestatus as STRING, l_shipdate as TIMESTAMP_DAYS, and the scan's
# q1 predicate l_shipdate <= DATE '1998-09-02' as a BOOL8 column
LINEITEM_TYPES = [26, 26, 26, 26, 23, 23, 12, 11]
LINEITEM_SCALES = [-2, -2, -2, -2, 0, 0, 0, 0]
# q1 with Spark's SUM result type decimal(22,2): the casts Spark inserts,
# then SUM/AVG/COUNT by (l_returnflag, l_linestatus), ORDER BY both;
# sum_disc_price and sum_charge need a DECIMAL128 product, which the JAX
# package does not have (binaryop.py:349-351)
Q1_PLAN = [
    {"op": "filter", "mask": 7},
    {"op": "cast", "column": 0, "type_id": 27, "scale": -2},
    {"op": "cast", "column": 1, "type_id": 27, "scale": -2},
    {"op": "groupby", "by": [4, 5], "aggs": [
        {"column": 0, "agg": "sum"}, {"column": 1, "agg": "sum"},
        {"column": 0, "agg": "mean"}, {"column": 1, "agg": "mean"},
        {"column": 2, "agg": "mean"}, {"column": 6, "agg": "count"}]},
    {"op": "sort_by", "keys": [{"column": 0}, {"column": 1}]},
]
# (l2): ORDER BY l_extendedprice DESC on the decimal(22,2) key (the row
# number rides along as the permutation's witness)
ORDER_PLAN = [
    {"op": "cast", "column": 1, "type_id": 27, "scale": -2},
    {"op": "sort_by", "keys": [{"column": 1, "ascending": False}]},
]
DEC_KERNELS = {"l1": (), "l2": ()}  # no tier kernel takes these (ROADMAP)
DEC_EDGES = [0, 1, -1, 2**63 - 1, 2**63, -(2**63), 2**64 - 1, 2**64,
             -(2**64), 2**64 + 1, -(2**64) - 1, 10**37, -(10**37),
             10**37 + 1, -(10**37) - 1, 10**38 - 1, -(10**38) + 1]


def make_lineitem_data(rng, n: int) -> dict:
    """(l)'s lineitem batch with the TPC-H specification's value ranges
    (clause 4.2.3): quantity 1-50, extendedprice = quantity x a part's
    retail price of 900.00-2,098.99, discount 0.00-0.10, tax 0.00-0.08,
    each ~2 % null; shipdate in 1992-01-02..1998-12-01; linestatus F when
    the ship date is past the spec's CURRENTDATE (1995-06-17), else O;
    returnflag N for a receipt after it, else R or A."""
    qty = rng.integers(1, 51, n).astype(np.int64)
    retail = rng.integers(90_000, 209_900, n).astype(np.int64)
    cents = {"qty": qty * 100, "price": qty * retail,
             "disc": rng.integers(0, 11, n).astype(np.int64),
             "tax": rng.integers(0, 9, n).astype(np.int64)}
    ok = {k: rng.random(n) > DEC_NULLS for k in cents}
    ship = rng.integers(SHIP_FIRST, SHIP_LAST + 1, n).astype(np.int32)
    receipt = ship + rng.integers(1, 31, n)
    status = (ship <= TPCH_CURRENT).astype(np.int64) ^ 1  # 0 F, 1 O
    flag = np.where(receipt > TPCH_CURRENT, 1,
                    np.where(rng.random(n) < 0.5, 0, 2)).astype(np.int64)
    keep = ship <= SHIP_CUTOFF
    names = ("qty", "price", "disc", "tax")
    rf, ls = string_wire(RETURNFLAGS, flag), string_wire(LINESTATUS, status)
    wire = (list(LINEITEM_TYPES), list(LINEITEM_SCALES),
            [cents[k].tobytes() for k in names] + [rf[0], ls[0],
                                                   ship.tobytes(),
                                                   keep.astype(np.uint8)
                                                   .tobytes()],
            [ok[k].astype(np.uint8).tobytes() for k in names]
            + [None] * 4, n)
    rowid = np.arange(n, dtype=np.int64)
    order_wire = ([4, 26], [0, -2], [rowid.tobytes(), cents["price"].tobytes()],
                  [None, ok["price"].astype(np.uint8).tobytes()], n)
    return {"cents": cents, "ok": ok, "flag": flag, "status": status,
            "keep": keep, "wire": wire, "order_wire": order_wire}


def q1_oracle(ld: dict) -> dict:
    """q1's DECIMAL128 core in numpy: per (returnflag, linestatus) of the
    kept rows, the exact sums (int64 holds them: < 2^63 cents), the
    valid counts behind the means, and count(*)."""
    m = ld["keep"]
    grp = (ld["flag"] * 2 + ld["status"])[m]
    out = {}
    for k in ("qty", "price", "disc"):
        v = ld["ok"][k][m]
        vals = ld["cents"][k][m]
        out[f"sum_{k}"] = np.array([int(vals[v & (grp == g)].sum())
                                    for g in range(6)])
        out[f"n_{k}"] = np.bincount(grp[v], minlength=6)
    out["count"] = np.bincount(grp, minlength=6)
    return out


def dec128_ints(data: bytes, n: int) -> list:
    """Signed Python ints of ``n`` DECIMAL128 wire values."""
    limbs = np.frombuffer(data, np.uint64, 2 * n).reshape(n, 2)
    return [((int(h) << 64) | int(lo)) - ((int(h) >> 63) << 128)
            for lo, h in limbs]


def check_l1(ld: dict, wire) -> dict:
    """(l1)'s 5-tuple against :func:`q1_oracle`: the groups in key order,
    the DECIMAL128 sums and count(*) exact, the means within 1e-12 of
    numpy's (they are held bit for bit against the CPU run apart)."""
    type_ids, scales, datas, valids, g = wire
    want = q1_oracle(ld)
    present = [i for i in range(6) if want["count"][i] > 0]
    rf = np.frombuffer(datas[0], np.int32, g + 1)
    ls = np.frombuffer(datas[1], np.int32, g + 1)
    keys = [(datas[0][4 * (g + 1) + rf[i]:4 * (g + 1) + rf[i + 1]],
             datas[1][4 * (g + 1) + ls[i]:4 * (g + 1) + ls[i + 1]])
            for i in range(g)]
    want_keys = [(RETURNFLAGS[i // 2], LINESTATUS[i % 2]) for i in present]
    means = [np.frombuffer(datas[c], np.float64, g) for c in (4, 5, 6)]
    rel = 0.0
    for j, k in enumerate(("qty", "price", "disc")):
        w = want[f"sum_{k}"][present] / want[f"n_{k}"][present] * 0.01
        rel = max(rel, float(np.max(np.abs(means[j] - w) / np.abs(w))))
    checks = {
        "schema": (type_ids == [23, 23, 27, 27, 10, 10, 10, 4]
                   and scales[2:4] == [-2, -2]),
        "keys": keys == want_keys,
        "sum_qty": dec128_ints(datas[2], g) == [int(v) for v in
                                                want["sum_qty"][present]],
        "sum_base_price": dec128_ints(datas[3], g) == [
            int(v) for v in want["sum_price"][present]],
        "count": np.array_equal(np.frombuffer(datas[7], np.int64, g),
                                want["count"][present]),
        "means_vs_numpy": rel < 1e-12,
    }
    return {"groups": g, "checks": checks, "means_max_rel_diff": rel}


def check_l2(ld: dict, wire) -> dict:
    """(l2)'s rows: a stable descending order of the price's Python ints,
    nulls last (Spark's default for DESC), the row numbers as witness."""
    type_ids, scales, datas, valids, n = wire
    price, ok = ld["cents"]["price"], ld["ok"]["price"]
    rows = np.arange(n)
    want = np.concatenate([rows[ok][np.argsort(-price[ok], kind="stable")],
                           rows[~ok]])
    got = np.frombuffer(datas[0], np.int64, n)
    valid = np.frombuffer(valids[1], np.uint8, n).astype(bool)
    vals = np.frombuffer(datas[1], np.int64, 2 * n).reshape(n, 2)
    checks = {
        "schema": type_ids == [4, 27] and scales == [0, -2],
        "order": np.array_equal(got, want),
        "values": np.array_equal(vals[valid, 0], price[got[valid]])
        and not vals[valid, 1].any(),
        "nulls_last": np.array_equal(valid, ok[got]) and not valid[
            int(ok.sum()):].any(),
    }
    return {"rows": n, "checks": checks}


def phase_decimal(rb, kernels, ld: dict) -> dict:
    """(l1) q1's DECIMAL128 core and (l2) ORDER BY a decimal(22,2) key
    over 2^23 lineitem rows, through ``table_upload_wire`` +
    ``table_plan_resident``: checked against Python ints and byte for
    byte against the port's own CPU run, then timed like (i) and (k):
    wall over 5 runs, the host syncs of one run and a profiled window."""
    from spark_rapids_jni_tpu_torch.utils import config, metrics

    cells = {"l1": (Q1_PLAN, ld["wire"], check_l1),
             "l2": (ORDER_PLAN, ld["order_wire"], check_l2)}
    out = {}
    config.set_flag("METRICS", True)
    try:
        for tag, (plan_ops, wire_in, check) in cells.items():
            plan = json.dumps(plan_ops)
            ids = [rb.table_upload_wire(*wire_in, device=DEVICE)]
            torch.cuda.synchronize()
            metrics.reset()
            kernels.reset_launches()
            res = rb.table_plan_resident(plan, ids)
            torch.cuda.synchronize()
            launches = {k: v.launches for k, v in kernels.KERNELS.items()}
            tier = metrics.counter_values(["kernel.launches", "kernel.declines"])
            wire = rb.table_download_wire(res)
            rb.table_free(res)
            got = check(ld, wire)
            cpu = rb.table_upload_wire(*wire_in, device="cpu")
            ref = rb.table_plan_resident(plan, [cpu])
            got["checks"]["bytes_equal_cpu"] = (
                tuple(rb.table_download_wire(ref)) == tuple(wire))
            for t in (cpu, ref):
                rb.table_free(t)
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                res = rb.table_plan_resident(plan, ids)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                rb.table_free(res)
            median = statistics.median(times)
            syncs = count_syncs(plan_runner(rb, plan, ids))
            log(f"({tag}) {got}; wall median {median:.2f} ms over 5 runs (all: "
                f"{[round(t, 2) for t in times]}); host syncs a run {syncs}; "
                f"launches {launches}; tier {tier}")
            profile = profile_plan(plan_runner(rb, plan, ids), median,
                                   f"({tag})")
            for t in ids:
                rb.table_free(t)
            bad = [k for k, ok in got["checks"].items() if not ok]
            if bad:
                raise AssertionError(f"({tag}) differs: {bad}")
            missing = [k for k in DEC_KERNELS[tag] if launches[k] == 0]
            if missing:
                raise AssertionError(f"({tag}) never launched {missing}")
            out[tag] = {"launches": launches, "tier": tier, "wall_ms": median,
                        "syncs": syncs, "profile": profile, **got}
    finally:
        config.clear_flag("METRICS")
    return out


def dec_ops_wire(rng, n: int, pool: list, draw: bool = True):
    """(l3)'s table: k INT64 (~10 % null), d DECIMAL128(-2) drawn from
    ``pool`` (~15 % null; repeats, so it keys joins and groups) or, with
    ``draw`` False, ``pool`` itself in order (a join's build side, one
    row a key), e DECIMAL128(-5), i INT64, s DECIMAL64(-3); and d's
    Python ints and validity."""
    from spark_rapids_jni_tpu_torch.ops import int128

    d = [pool[i] for i in rng.integers(0, len(pool), n)] if draw else pool
    e = [int(v) * 10**int(s) for v, s in zip(
        rng.integers(-2**62, 2**62, n), rng.integers(0, 19, n))]
    dv = rng.random(n) > 0.15
    cols = [rng.integers(0, 1000, n).astype(np.int64).tobytes(),
            int128.from_py_ints(d).tobytes(), int128.from_py_ints(e).tobytes(),
            rng.integers(-10**6, 10**6, n).astype(np.int64).tobytes(),
            rng.integers(-10**15, 10**15, n).astype(np.int64).tobytes()]
    valids = [(rng.random(n) > 0.1).astype(np.uint8).tobytes(),
              dv.astype(np.uint8).tobytes(), None, None, None]
    return ([4, 27, 27, 4, 26], [0, -2, -5, 0, -3], cols, valids, n), d, dv


DEC_OPS_PLANS = {
    "join_inner": [{"op": "join", "how": "inner", "on": [1]}],
    "join_left": [{"op": "join", "how": "left", "on": [1]}],
    "groupby": [{"op": "groupby", "by": [0], "aggs": [
        {"column": c, "agg": a} for c in (1, 2)
        for a in ("sum", "mean", "min", "max", "variance", "std", "count")]}],
    "distinct": [{"op": "distinct", "keys": [1]}],
    **{f"cast_{name}": [{"op": "cast", "column": c, "type_id": t,
                         "scale": s}]
       for name, c, t, s in (("to_int64", 1, 4, 0), ("to_float64", 2, 10, 0),
                             ("to_decimal64", 1, 26, -2),
                             ("to_decimal128", 2, 27, -9),
                             ("int64_to", 3, 27, -20),
                             ("decimal64_to", 4, 27, -6))},
    "string_round_trip": [{"op": "cast", "column": 1, "type_id": 23},
                          {"op": "cast", "column": 1, "type_id": 27,
                           "scale": -2}],
}
DEC_OPS_BINARY = ("add", "sub", "eq", "lt", "ge", "null_safe_eq")


def phase_decimal_ops(rb, seed: int) -> dict:
    """(l3): the rest of DECIMAL128 once at 2^20 rows with values near
    +-10^37 and +-2^64 (every carry and borrow): joins on DECIMAL128 keys,
    the groupby's sum/mean/min/max/variance/std, distinct, the casts to
    and from INT64, FLOAT64, DECIMAL64 and STRING through the wire, and
    add/sub/comparisons at mixed scales (scale -2 with -5 and with an
    INT64) at the ops level; each byte for byte against the port's CPU
    run, and against Python ints where they give the answer."""
    from spark_rapids_jni_tpu_torch import interop, kernels, ops
    from spark_rapids_jni_tpu_torch.column import Table

    rng = np.random.default_rng(seed + 128)
    big = [int(v) for v in rng.integers(-2**62, 2**62, 40)]
    pool = DEC_EDGES + [v * 10**19 + 7 for v in big]
    wire, d, dv = dec_ops_wire(rng, DEC_OPS_ROWS, pool)
    side, sd_vals, sdv = dec_ops_wire(rng, len(pool), pool, draw=False)
    kernels.reset_launches()
    out = {}
    for name, plan_ops in DEC_OPS_PLANS.items():
        plan = json.dumps(plan_ops)
        wires = [wire, side] if name.startswith("join") else [wire]
        res = []
        for dev in (DEVICE, "cpu"):
            ids = [rb.table_upload_wire(*w, device=dev) for w in wires]
            r = rb.table_plan_resident(plan, ids)
            res.append(tuple(rb.table_download_wire(r)))
            for t in ids + [r]:
                rb.table_free(t)
        if res[0] != res[1]:
            raise AssertionError(f"(l3) {name}: card and CPU bytes differ")
        out[name] = {"rows": res[0][4]}
    # oracles in Python ints
    ids = [rb.table_upload_wire(*wire, device=DEVICE)]
    r = rb.table_plan_resident(json.dumps(DEC_OPS_PLANS["string_round_trip"]),
                               ids)
    rt = rb.table_download_wire(r)
    for t in ids + [r]:
        rb.table_free(t)
    valid = np.frombuffer(rt[3][1], np.uint8, DEC_OPS_ROWS).astype(bool)
    got_rt = dec128_ints(rt[2][1], DEC_OPS_ROWS)
    if not (np.array_equal(valid, dv) and all(
            g == w for g, w, ok in zip(got_rt, d, dv) if ok)):
        raise AssertionError("(l3) DECIMAL128 -> STRING -> DECIMAL128 differs")
    counts = {}
    for v, ok in zip(sd_vals, sdv):
        if ok:
            counts[v] = counts.get(v, 0) + 1
    want_join = sum(counts.get(v, 0) for v, ok in zip(d, dv) if ok)
    if out["join_inner"]["rows"] != want_join:
        raise AssertionError(f"(l3) inner join rows {out['join_inner']} != "
                             f"{want_join}")
    keys = np.frombuffer(wire[2][0], np.int64)
    kv = np.frombuffer(wire[3][0], np.uint8).astype(bool)
    ids = [rb.table_upload_wire(*wire, device=DEVICE)]
    r = rb.table_plan_resident(json.dumps([{"op": "groupby", "by": [0], "aggs": [
        {"column": 1, "agg": a} for a in ("min", "max", "sum")]}]), ids)
    gb = rb.table_download_wire(r)
    for t in ids + [r]:
        rb.table_free(t)
    g = gb[4]
    gk = np.frombuffer(gb[2][0], np.int64, g)
    gk_ok = np.frombuffer(gb[3][0], np.uint8, g).astype(bool)
    mins, maxs, sums = (dec128_ints(gb[2][c], g) for c in (1, 2, 3))
    mod = 1 << 128
    groups = {}
    for v, k, okk, ok in zip(d, keys.tolist(), kv.tolist(), dv.tolist()):
        if ok:
            lo, hi, tot = groups.get(k if okk else None, (v, v, 0))
            groups[k if okk else None] = (min(lo, v), max(hi, v), tot + v)
    for i in range(g):
        want = groups.get(int(gk[i]) if gk_ok[i] else None)
        if want is None:
            continue
        want = (want[0], want[1], (want[2] + mod // 2) % mod - mod // 2)
        if (mins[i], maxs[i], sums[i]) != want:
            raise AssertionError(f"(l3) group {i} min/max/sum differ")
    # binary ops at mixed scales, ops level, on the card and the CPU
    cols = {}
    for dev in (DEVICE, "cpu"):
        t = interop.table_from_buffers(
            [(np.frombuffer(wire[2][c], np.uint64).reshape(-1, 2)
              if wire[0][c] == 27 else np.frombuffer(wire[2][c], np.int64),
              None if wire[3][c] is None
              else np.frombuffer(wire[3][c], np.uint8).astype(bool), None,
              wire[0][c], wire[1][c]) for c in range(5)], None, device=dev)
        cols[dev] = {f"{op}_{o}": ops.binary_op(op, t.columns[1],
                                                 t.columns[o])
                     for op in DEC_OPS_BINARY for o in (2, 3)}
    for k, c in cols[DEVICE].items():
        same_buffers(interop.table_to_buffers(Table([c])),
                     interop.table_to_buffers(Table([cols["cpu"][k]])),
                     f"(l3) binary {k}")
    e = dec128_ints(wire[2][2], DEC_OPS_ROWS)
    m = min(20_000, DEC_OPS_ROWS)
    add = dec128_ints(cols["cpu"]["add_2"].data[:m].numpy().tobytes(), m)
    if any(a != ((x * 1000 + y + mod // 2) % mod - mod // 2)
           for a, x, y, ok in zip(add, d, e, dv) if ok):
        raise AssertionError("(l3) add at mixed scales differs from Python")
    launches = {k: v.launches for k, v in kernels.KERNELS.items()}
    log(f"(l3) {len(DEC_OPS_PLANS)} wire plans and "
        f"{len(cols[DEVICE])} binary ops at {DEC_OPS_ROWS} rows equal the CPU "
        f"run's bytes; string round trip, join rows ({want_join}), group "
        f"min/max/sum and add equal Python ints; launches {launches}")
    if launches["scan16"] == 0:
        raise AssertionError("(l3) never launched scan16 (variance/std)")
    return {"plans": out, "binary_ops": sorted(cols[DEVICE]),
            "join_rows": want_join, "launches": launches}


# ---------------------------------------------------------------------------
# (m) the execution services: the pipelined stream, spill, faults, registry
# ---------------------------------------------------------------------------

STREAM_BATCHES = 8  # (m1): 8 batches of (a)'s shape, ~2.1 GB of wire bytes
STREAM_DEPTHS = ("off", "1", "2", "4")
STREAM_RUNS = 3  # streams a depth; the wall per batch is their median's
SPILL_TABLES = 6  # (m2): resident (a)-shaped tables, 2 of which fit
SPILL_RATE_RUNS = 3
# (m3): seeded transient faults at every site the stream and a resident
# spill sequence pass
STREAM_FAULTS = ("seed=12,dispatch:transient:0.05:4,serde:transient:0.25:3,"
                 "kernel:transient:0.2:3,spill:transient:0.5:2")
SERVICE_FLAGS = ("PIPELINE", "SPILL", "SPILL_DIR", "HOST_SPILL_BUDGET_GB",
                 "HBM_BUDGET_GB", "FAULTS", "RETRY_BASE_MS", "METRICS")


def clear_service_flags() -> None:
    from spark_rapids_jni_tpu_torch import pipeline
    from spark_rapids_jni_tpu_torch.utils import config

    pipeline.drain()
    for name in SERVICE_FLAGS:
        config.clear_flag(name)
    pipeline.depth()  # PIPELINE is off: the worker pool goes
    pipeline.drain_io()


def stream_batch(d: dict, k: int):
    """(a)'s fact batch as wire bytes with ``ss_sold_date_sk`` shifted by
    ``k``: every batch's groupby-by-date answer differs."""
    n = d["rows"].shape[0]
    buf = bytearray(4 * (n + 1) + 32 * n)
    np.frombuffer(buf, np.int32, n + 1)[:] = np.arange(n + 1, dtype=np.int64) * 32
    rows = np.frombuffer(buf, np.uint8, 32 * n, 4 * (n + 1)).reshape(n, 32)
    rows[:] = d["rows"]
    date = rows[:, 16:24].view(np.int64)
    date += k
    return ([24], [5], [buf], [None], n)


def stream_oracle(want0: np.ndarray, k: int) -> np.ndarray:
    """(h)'s oracle rows with every date shifted by ``k``."""
    rows = want0.copy()
    rows[:, 0:8].view(np.int64)[:] += k
    return rows


def stream_launches(kernels) -> dict:
    return {k: v.launches for k, v in kernels.KERNELS.items()}


def phase_stream(rb, kernels, d: dict, ctx: dict) -> dict:
    """(m1): ``table_stream_wire`` over 8 of (a)'s batches with (h)'s
    plan at PIPELINE off, 1, 2 and 4: every 5-tuple equal to
    ``table_plan_wire`` of its batch and to the numpy oracle, in input
    order; wall per batch (median of 3 streams), the host time a batch
    of decode, plan and encode with the pipeline off, the device busy
    share, the pipeline counters and the kernels' launches a stream."""
    from spark_rapids_jni_tpu_torch import plan as plan_mod
    from spark_rapids_jni_tpu_torch.utils import config, metrics

    ctx["start_count"] = rb.resident_table_count()
    plan = json.dumps(WIRE_PLAN)
    plan_ops = json.loads(plan)
    t0 = time.perf_counter()
    batches = [stream_batch(d, k) for k in range(STREAM_BATCHES)]
    want0 = wire_plan_oracle(d, FACT_ROWS)
    ref = []
    for k, b in enumerate(batches):
        ref.append(tuple(rb.table_plan_wire(plan, *b, device=DEVICE)))
        check_rows(ref[-1], stream_oracle(want0, k))
    ctx.update(batches=batches, ref=ref, want0=want0)
    log(f"(m1) {STREAM_BATCHES} batches made and run one by one through "
        f"table_plan_wire in {time.perf_counter() - t0:.1f} s; each equals "
        f"its numpy oracle")
    # the host time a batch of each stage, pipeline off
    dev = torch.device(DEVICE)
    split = {"decode": [], "plan": [], "encode": []}
    for b in batches:
        t0 = time.perf_counter()
        tbl = rb._table_from_wire(b[0], b[1], b[2], b[3], b[4], dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = plan_mod.run_plan(plan_ops, tbl, donate_input=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rb._table_to_wire(out)
        t3 = time.perf_counter()
        for key, dt_s in (("decode", t1 - t0), ("plan", t2 - t1),
                          ("encode", t3 - t2)):
            split[key].append(dt_s * 1e3)
        del tbl, out
    split_ms = {k: statistics.median(v) for k, v in split.items()}
    log(f"(m1) host ms a batch, pipeline off (median of {STREAM_BATCHES}): "
        f"{ {k: round(v, 2) for k, v in split_ms.items()} }")
    out = {"split_ms": split_ms, "depths": {}}
    try:
        config.set_flag("METRICS", True)
        for depth in STREAM_DEPTHS:
            config.set_flag("PIPELINE", depth)
            walls, launches, counters = [], None, None
            for run in range(STREAM_RUNS):
                metrics.reset()
                torch.cuda.synchronize()
                kernels.reset_launches()
                t0 = time.perf_counter()
                got = rb.table_stream_wire(plan, batches, device=DEVICE)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                if [tuple(g) for g in got] != ref:
                    bad = [k for k, g in enumerate(got) if tuple(g) != ref[k]]
                    raise AssertionError(
                        f"(m1) depth {depth}: batches {bad} differ from "
                        "table_plan_wire (or come out of order)")
                if run == 0:
                    launches = stream_launches(kernels)
                    snap = metrics.snapshot()
                    hist = snap["histograms"]
                    counters = {
                        **{k: v for k, v in snap["counters"].items()
                           if k.startswith("pipeline.")},
                        "overlap_ms": hist.get("pipeline.overlap_ms",
                                               {}).get("sum", 0.0),
                        "stall_ms": hist.get("pipeline.stall_ms",
                                             {}).get("sum", 0.0)}
            wall = statistics.median(walls)
            per_batch = wall / STREAM_BATCHES
            missing = [k for k in WIRE_KERNELS if launches[k] < STREAM_BATCHES]
            if missing:
                raise AssertionError(
                    f"(m1) depth {depth}: {missing} launched fewer than once "
                    f"a batch: {launches}")
            rec = {"wall_ms": wall, "walls_ms": walls,
                   "ms_per_batch": per_batch, "launches": launches,
                   "counters": counters}
            if depth in ("off", "2"):
                def run():
                    rb.table_stream_wire(plan, batches, device=DEVICE)
                    torch.cuda.synchronize()

                rec["profile"] = profile_plan(run, wall, f"(m1) depth {depth}",
                                              runs=1)
            out["depths"][depth] = rec
            log(f"(m1) depth {depth}: {per_batch:.2f} ms a batch (stream "
                f"walls {[round(w, 1) for w in walls]} ms for "
                f"{STREAM_BATCHES} batches); every 5-tuple equal to "
                f"table_plan_wire in order; launches "
                f"{ {k: launches[k] for k in WIRE_KERNELS} }; counters "
                f"{counters}")
    finally:
        clear_service_flags()
    out["launches"] = out["depths"]["2"]["launches"]
    out["groups"] = want0.shape[0]
    return out


def link_line() -> str:
    """The host link as ``nvidia-smi -q`` reports it: the PCIe generation
    and link width, current and max (its words where it reads N/A)."""
    r = subprocess.run(["nvidia-smi", "-q"], capture_output=True, text=True,
                       timeout=60, check=True)
    fields, section = {}, None
    for line in r.stdout.splitlines():
        key, _, value = line.partition(":")
        key = key.strip()
        if key in ("PCIe Generation", "Link Width"):
            section = key
        elif section and key in ("Max", "Current", "Device Current",
                                 "Device Max", "Host Max"):
            fields.setdefault(f"{section} {key}", value.strip())
        elif key and not value.strip():
            section = None
    return "; ".join(f"{k} {v}" for k, v in fields.items()) or "not reported"


def phase_spill(rb, ctx: dict) -> dict:
    """(m2): SPILL on, a device budget that holds 2 of 6 resident
    (a)-shaped tables and a host budget of one table, so evictions reach
    the disk tier: (h)'s plan over each id in turn, then over the first
    again, every result equal to the unspilled run's bytes; eviction and
    repage counters; no spill file left. Then the GB/s of one eviction
    and one repage of a table through the spill tier (pinned), and of
    direct pageable copies of the same table's tensors."""
    import os
    import shutil

    from spark_rapids_jni_tpu_torch import pipeline
    from spark_rapids_jni_tpu_torch.column import table_tensors
    from spark_rapids_jni_tpu_torch.utils import config, hbm, metrics, spill

    batches, ref = ctx["batches"], ctx["ref"]
    plan = json.dumps(WIRE_PLAN)
    spill_dir = os.path.join("build", "spill")
    shutil.rmtree(spill_dir, ignore_errors=True)
    probe = rb.table_upload_wire(*batches[0], device=DEVICE)
    nbytes = hbm.table_bytes(rb._resident_get(probe))
    rb.table_free(probe)
    gib = float(1 << 30)
    budget_gb = 2.5 * nbytes / gib / (1 - hbm.RESERVE_FRACTION)
    out = {"table_bytes": nbytes, "hbm_budget_gb": budget_gb,
           "host_budget_gb": 1.5 * nbytes / gib}
    ids = []
    try:
        config.set_flag("METRICS", True)
        metrics.reset()
        config.set_flag("SPILL", True)
        config.set_flag("SPILL_DIR", spill_dir)
        config.set_flag("HBM_BUDGET_GB", budget_gb)
        config.set_flag("HOST_SPILL_BUDGET_GB", out["host_budget_gb"])
        t0 = time.perf_counter()
        ids = [rb.table_upload_wire(*batches[k], device=DEVICE)
               for k in range(SPILL_TABLES)]
        doc_after_puts = spill.stats_doc()
        order = list(range(SPILL_TABLES)) + [0]
        for k in order:
            res = rb.table_plan_resident(plan, [ids[k]])
            got = tuple(rb.table_download_wire(res))
            rb.table_free(res)
            if got != ref[k]:
                raise AssertionError(f"(m2) table {k} differs after spill")
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
        snap = metrics.snapshot()
        counters = {k: v for k, v in snap["counters"].items()
                    if k.startswith("spill.")}
        moved = {k: v for k, v in snap["bytes"].items()
                 if k.startswith("spill.")}
        for t in ids:
            rb.table_free(t)
        ids = []
        pipeline.drain_io()
        left = spill.spill_file_count()
        files = os.listdir(spill_dir) if os.path.isdir(spill_dir) else []
        if counters.get("spill.evictions", 0) < SPILL_TABLES - 2:
            raise AssertionError(f"(m2) too few evictions: {counters}")
        if counters.get("spill.repages", 0) < 1 or not counters.get(
                "spill.demotions"):
            raise AssertionError(f"(m2) no repage or no disk tier: {counters}")
        if left or files:
            raise AssertionError(f"(m2) spill files left: {left} {files}")
        out.update(counters=counters, bytes=moved, sequence_s=seq_s,
                   after_puts=doc_after_puts)
        log(f"(m2) {SPILL_TABLES} resident tables of {nbytes} B under a "
            f"{budget_gb:.3f} GiB budget: {len(order)} plans equal the "
            f"unspilled bytes in {seq_s:.2f} s; counters {counters}; bytes "
            f"{moved}; no spill file left")
        # the rates: one table evicted and repaged through the spill tier
        # (pinned host memory), and the same table's tensors copied
        # straight into pageable host memory and back
        config.set_flag("HBM_BUDGET_GB", 0.0)
        config.set_flag("HOST_SPILL_BUDGET_GB", 64.0)
        runs = {"pinned": ([], []), "pageable": ([], [])}
        for _ in range(SPILL_RATE_RUNS):
            tid = rb.table_upload_wire(*batches[1], device=DEVICE)
            ids = [tid]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            freed = spill.request_headroom(1 << 50)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rb.table_num_rows(tid)  # repages
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if freed != nbytes:
                raise AssertionError(f"(m2) evicted {freed} of {nbytes}")
            runs["pinned"][0].append(nbytes / (t1 - t0) / 1e9)
            runs["pinned"][1].append(nbytes / (t2 - t1) / 1e9)
            dev = [x for x in table_tensors(rb._resident_get(tid))
                   if x is not None]
            moved_b = sum(x.numel() * x.element_size() for x in dev)
            t0 = time.perf_counter()
            host = [torch.empty(x.shape, dtype=x.dtype).copy_(x)
                    for x in dev]
            t1 = time.perf_counter()
            back = [h.to(DEVICE) for h in host]
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if not all(torch.equal(a, b) for a, b in zip(dev, back)):
                raise AssertionError("(m2) a pageable round trip differs")
            runs["pageable"][0].append(moved_b / (t1 - t0) / 1e9)
            runs["pageable"][1].append(moved_b / (t2 - t1) / 1e9)
            del dev, host, back
            res = rb.table_plan_resident(plan, [tid])
            got = tuple(rb.table_download_wire(res))
            rb.table_free(res)
            rb.table_free(tid)
            ids = []
            if got != ref[1]:
                raise AssertionError("(m2) a repaged table differs")
        rates = {key: {"evict_gb_s": statistics.median(ev),
                       "repage_gb_s": statistics.median(rp),
                       "evict_all": ev, "repage_all": rp}
                 for key, (ev, rp) in runs.items()}
        out["rates"] = rates
        try:
            out["link"] = link_line()
        except (OSError, subprocess.SubprocessError, ValueError) as e:
            out["link"] = f"not read: {e}"
        log(f"(m2) one table of {nbytes} B: "
            + "; ".join(f"{k}: evict {v['evict_gb_s']:.2f} GB/s, repage "
                        f"{v['repage_gb_s']:.2f} GB/s" for k, v in rates.items())
            + f"; host link {out['link']}")
    finally:
        for t in ids:
            rb.table_free(t)
        clear_service_flags()
        spill.reset()
        shutil.rmtree(spill_dir, ignore_errors=True)
    return out


def phase_faults(rb, ctx: dict) -> dict:
    """(m3): seeded transient faults at dispatch, serde, kernel and spill
    over (m1)'s stream at PIPELINE 2 and a resident spill sequence: the
    bytes equal the fault-free run, and the retries (the kernel site's
    retry the same kernel) and spill errors account for every injection. Then a permanent fault
    surfaces with its own type, and a real out-of-memory error is
    classified ResourceExhausted, given up after RETRY_MAX, and leaves a
    context that runs (h)'s plan to the same bytes."""
    from spark_rapids_jni_tpu_torch.utils import config, faults, hbm, metrics

    batches, ref = ctx["batches"], ctx["ref"]
    plan = json.dumps(WIRE_PLAN)
    out = {}
    ids = []
    try:
        # every flag first: a flag change recompiles the fault plan, which
        # restarts its decision stream
        probe = rb.table_upload_wire(*batches[2], device=DEVICE)
        nbytes = hbm.table_bytes(rb._resident_get(probe))
        rb.table_free(probe)
        config.set_flag("METRICS", True)
        config.set_flag("RETRY_BASE_MS", "1")
        config.set_flag("PIPELINE", "2")
        config.set_flag("SPILL", True)
        config.set_flag("HBM_BUDGET_GB", 1.5 * nbytes / float(1 << 30)
                        / (1 - hbm.RESERVE_FRACTION))
        metrics.reset()
        config.set_flag("FAULTS", STREAM_FAULTS)
        got = rb.table_stream_wire(plan, batches, device=DEVICE)
        torch.cuda.synchronize()
        if [tuple(g) for g in got] != ref:
            raise AssertionError("(m3) the faulted stream differs")
        # the spill site: two resident tables under a one-table budget,
        # the plans over them enqueued on the pipeline
        ids = [rb.table_upload_wire(*batches[k], device=DEVICE)
               for k in (2, 3)]
        for k, tid in zip((2, 3, 2, 3), ids * 2):
            res = rb.table_plan_resident(plan, [tid])
            if tuple(rb.table_download_wire(res)) != ref[k]:
                raise AssertionError(f"(m3) resident table {k} differs")
            rb.table_free(res)
        for t in ids:
            rb.table_free(t)
        ids = []
        stats = faults.injection_stats()
        c = metrics.counter_values(["retry.attempts", "retry.giveups",
                                    "kernel.retries", "kernel.fallbacks",
                                    "spill.errors", "faults.injected"])
        injected = {k: v["injected"] for k, v in stats.items()}
        total = sum(injected.values())
        if (c["retry.attempts"] + c["kernel.retries"] + c["spill.errors"]
                != total or c["faults.injected"] != total
                or c["kernel.retries"] != injected["kernel:transient"]
                or c["kernel.fallbacks"] or c["retry.giveups"]
                or total == 0):
            raise AssertionError(f"(m3) counters {c} do not account for the "
                                 f"injections {stats}")
        out["transient"] = {"stats": stats, "counters": c}
        log(f"(m3) faulted stream and spill sequence equal the fault-free "
            f"bytes; injections {injected}; counters {c}")
        clear_service_flags()
        config.set_flag("FAULTS", "dispatch:permanent:1:1")
        try:
            rb.table_plan_wire(plan, *batches[0], device=DEVICE)
        except faults.PermanentError as e:
            out["permanent"] = f"{type(e).__name__}: {e}"
        else:
            raise AssertionError("(m3) the permanent fault did not surface")
        config.set_flag("FAULTS", "")
        config.set_flag("METRICS", True)
        config.set_flag("RETRY_BASE_MS", "1")
        metrics.reset()
        total_mem = torch.cuda.get_device_properties(0).total_memory

        def too_big():
            return torch.empty(2 * total_mem, dtype=torch.uint8,
                               device=DEVICE)

        try:
            faults.run_with_retry(too_big, "oom.probe")
        except faults.ResourceExhausted as e:
            cause = e.__cause__
            if not isinstance(cause, torch.cuda.OutOfMemoryError):
                raise AssertionError(f"(m3) OOM cause {cause!r}")
            out["oom"] = {"raised": type(e).__name__,
                          "cause": type(cause).__name__,
                          "counters": metrics.counter_values(
                              ["retry.attempts", "retry.giveups"])}
        else:
            raise AssertionError("(m3) an allocation past the card passed")
        if out["oom"]["counters"] != {"retry.attempts": faults.retry_max(),
                                      "retry.giveups": 1}:
            raise AssertionError(f"(m3) OOM retries {out['oom']}")
        after = tuple(rb.table_plan_wire(plan, *batches[0], device=DEVICE))
        if after != ref[0]:
            raise AssertionError("(m3) (h)'s plan differs after the OOM")
        log(f"(m3) permanent: {out['permanent']}; real OOM: {out['oom']}; "
            f"(h)'s plan after it gives the same bytes")
    finally:
        for t in ids:
            rb.table_free(t)
        clear_service_flags()
    return out


def phase_registry(rb, ctx: dict) -> dict:
    """(m4): the registry's count is back to its start after (m1)-(m3),
    and ``table_reclaim`` returns the table's bytes while
    ``torch.cuda.memory_allocated`` falls by them."""
    count = rb.resident_table_count()
    if count != ctx["start_count"]:
        raise AssertionError(f"(m4) {count} resident tables, "
                             f"{ctx['start_count']} before (m)")
    tid = rb.table_upload_wire(*ctx["batches"][0], device=DEVICE)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    nbytes = rb.table_reclaim(tid)
    torch.cuda.synchronize()
    drop = before - torch.cuda.memory_allocated()
    if not 0 <= drop - nbytes < (1 << 20) or nbytes <= 0:
        raise AssertionError(f"(m4) reclaim returned {nbytes} B, "
                             f"memory_allocated fell {drop} B")
    log(f"(m4) resident tables back to {count}; table_reclaim returned "
        f"{nbytes} B and memory_allocated fell {drop} B")
    ctx.clear()  # the 2.1 GB of batches go
    return {"count": count, "reclaimed": nbytes, "allocated_drop": drop}


def stream_kernel_records(d: dict, qm: dict) -> list:
    """K1b and K1a at (m)'s shapes (one batch of the stream: (h)'s plan),
    with the launches of (m1)'s first stream at depth 2. The plan's
    groupby closes its fused segment, so K2a is not on (m)'s path."""
    from spark_rapids_jni_tpu_torch import dtype as dt
    from spark_rapids_jni_tpu_torch import rows
    from spark_rapids_jni_tpu_torch.kernels import row_transpose as rt

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    la = qm["launches"]
    note = f"(m1), depth 2: {STREAM_BATCHES} batches a stream"
    fact_layout = rows.compute_fixed_width_layout(
        [dt.DType(dt.TypeId(t)) for t in FACT_TYPES])
    src = torch.from_numpy(d["rows"]).to(dev)

    def columns(fn):
        cols, vecs, nulls = fn(src, fact_layout)
        return [*cols, *vecs, nulls]

    recs = [kernel_record(
        rt.UNPACK, "stream", f"{src.shape[0]}x{fact_layout.row_size}B",
        la["unpack_rows"], lambda: columns(rt.unpack_rows_columns),
        lambda: columns(rt.unpack_rows_columns_plain),
        transpose_bytes(fact_layout, src.shape[0]),
        src.shape[0] * fact_layout.row_size, note=note)]
    out_layout = rows.compute_fixed_width_layout([dt.INT64] * 5)
    g = qm["groups"]
    col_bytes = [torch.randint(0, 256, (g, w), dtype=torch.uint8, device=dev,
                               generator=gen)
                 for w in out_layout.column_widths]
    vecs = [torch.randint(0, 2, (g,), dtype=torch.uint8, device=dev,
                          generator=gen) != 0 for _ in col_bytes]
    recs.append(kernel_record(
        rt.PACK, "stream", f"{g}x{out_layout.row_size}B", la["pack_rows"],
        lambda: [rt.pack_rows_columns(col_bytes, vecs, out_layout)],
        lambda: [rt.pack_rows_columns_plain(col_bytes, vecs, out_layout)],
        transpose_bytes(out_layout, g), g * out_layout.row_size, note=note))
    return recs


# ---------------------------------------------------------------------------
# (n) the op library: windows, datetime, rounding, replace, reductions,
# scans, quantiles, search, STRUCT
# ---------------------------------------------------------------------------

OPLIB_ITEMS = 204_000  # (a)'s ss_item_sk partitions
JULIAN_1970 = 2_440_588  # TPC-DS date keys are Julian day numbers
OPLIB_RTOL = 1e-9  # floats against numpy (another add order)
OPLIB_QS = (0.25, 0.5, 0.75, 0.95)
OPLIB_INTERP = ("linear", "lower", "higher", "midpoint", "nearest")
RANGE_SPLITS = 200  # Spark's range partitioning into 200 partitions
UNBOUNDED = 1 << 30  # a ROWS frame past any partition
DT_FIELDS = ("year", "month", "day", "hour", "minute", "second", "weekday",
             "day_of_year", "quarter", "last_day_of_month",
             "millisecond_fraction", "microsecond_fraction",
             "nanosecond_fraction", "day_of_week_sunday")
TRUNC_UNITS = ("year", "quarter", "month", "week", "day", "hour", "minute",
               "second")
REDUCTIONS = ("sum", "min", "max", "mean", "count", "product", "variance",
              "std")


def make_oplib_data(rng, d: dict) -> dict:
    """(n)'s columns beside (a)'s batch: ss_sales_price in cents / 100
    (1-19,999 cents), the sold date as TIMESTAMP_DAYS (date_sk - the
    Julian day of 1970-01-01), the sold time as TIMESTAMP_MICROSECONDS
    (the date plus a second of the day and random microseconds), the
    price as DECIMAL64 scale -2 with ~2 % nulls, a list price with ~1 %
    NaN, 199 range-partition bounds sampled from the (item, date) rows
    and 1,000 promoted items. For the products, whose quantity and price
    forms are 0 (64 factors of 2 wrap INT64 to 0) and +inf at 2^23 rows:
    the price's ratio to 100.00, 1 + (cents - 10,000) / 10^7 (within
    1e-3 of 1, so the product of 2^23 stays finite), and the odd
    quantity 2 * quantity + 1 (an INT64 product that wraps but is never
    0)."""
    n = d["item_sk"].shape[0]
    cents = rng.integers(1, 20_000, n)
    days = (d["date_sk"] - JULIAN_1970).astype(np.int32)
    micros = (days.astype(np.int64) * 86_400_000_000
              + rng.integers(0, 86_400, n) * 1_000_000
              + rng.integers(0, 1_000_000, n))
    lp = cents * 1.5 / 100
    lp[rng.random(n) < 0.01] = np.nan
    pick = np.sort(rng.choice(n, RANGE_SPLITS - 1, replace=False))
    bounds = np.lexsort((days[pick], d["item_sk"][pick]))
    return {"cents": cents, "price": cents / 100, "days": days,
            "ratio": 1 + (cents - 10_000) / 1e7,
            "micros": micros, "dec_ok": rng.random(n) > 0.02,
            "list_price": lp, "bound_rows": pick[bounds],
            "promo": rng.choice(OPLIB_ITEMS, 1000, replace=False)}


def oplib_table(d: dict, od: dict, device):
    from spark_rapids_jni_tpu_torch import dtype as dt
    from spark_rapids_jni_tpu_torch.column import Column, Table

    def col(a, ok=None, dtype=None):
        return Column.from_numpy(a, ok, dtype, device=device)

    return Table([
        col(d["item_sk"]),
        col(d["customer_sk"], d["customer_ok"]),
        col(od["days"], None, dt.DType(dt.TypeId.TIMESTAMP_DAYS)),
        col(od["micros"], None, dt.DType(dt.TypeId.TIMESTAMP_MICROSECONDS)),
        col(d["quantity"], d["quantity_ok"]),
        col(od["price"]),
        col(od["cents"], od["dec_ok"], dt.decimal64(-2)),
        col(od["list_price"]),
        col(d["keep"]),
        col(od["ratio"]),
        col(2 * d["quantity"].astype(np.int64) + 1, d["quantity_ok"]),
    ], ["item", "customer", "date", "time", "qty", "price", "dprice",
        "list_price", "keep", "ratio", "odd_qty"])


def oplib_n1(t) -> dict:
    """(n1): q51's running SUM(price) by item ordered by date, q47/q57's
    AVG(price) over the item, MIN/MAX(quantity) over ROWS 3 PRECEDING to
    3 FOLLOWING, COUNT(quantity) over RANGE 30 days PRECEDING, the rank
    family by item ordered by price descending (q44/q67/q70), and LAG /
    LEAD(price, 1) within the item ordered by date."""
    from spark_rapids_jni_tpu_torch import ops
    from spark_rapids_jni_tpu_torch.ops import window as w

    desc = [ops.SortKey("price", ascending=False)]
    by_date = ops.sort_table(t, ["item", "date"])
    pids = by_date.column("item").data
    return {
        "running_sum": w.grouped_rolling_aggregate(
            t, ["item"], ["date"], "price", UNBOUNDED, 0, "sum"),
        "avg": w.grouped_rolling_aggregate(
            t, ["item"], ["date"], "price", UNBOUNDED, UNBOUNDED, "mean"),
        "min3": w.grouped_rolling_aggregate(
            t, ["item"], ["date"], "qty", 3, 3, "min"),
        "max3": w.grouped_rolling_aggregate(
            t, ["item"], ["date"], "qty", 3, 3, "max"),
        "count30": w.grouped_range_rolling_aggregate(
            t, ["item"], "date", "qty", 30, 0, "count"),
        "rank": w.rank(t, ["item"], desc),
        "dense_rank": w.dense_rank(t, ["item"], desc),
        "row_number": w.row_number(t, ["item"], desc),
        "percent_rank": w.percent_rank(t, ["item"], desc),
        "ntile4": w.ntile(t, ["item"], desc, 4),
        "lag": w.lag(by_date.column("price"), 1, pids),
        "lead": w.lead(by_date.column("price"), 1, pids),
    }


def oplib_n2(t) -> dict:
    """(n2): every datetime field and truncate unit on the date and the
    sold time, ROUND(price, 1) of the FLOAT64 and DECIMAL64 prices under
    HALF_UP and HALF_EVEN, and the replace family."""
    from spark_rapids_jni_tpu_torch import ops
    from spark_rapids_jni_tpu_torch.ops import datetime as dtm

    out = {}
    for src in ("date", "time"):
        c = t.column(src)
        for f in DT_FIELDS:
            out[f"{src}.{f}"] = getattr(dtm, f)(c)
        for u in TRUNC_UNITS:
            out[f"{src}.trunc_{u}"] = dtm.truncate(c, u)
        out[f"{src}.add_months"] = dtm.add_calendrical_months(c, 7)
    for how in ("half_up", "half_even"):
        out[f"round_price_{how}"] = ops.round_column(t.column("price"), 1, how)
        out[f"round_dprice_{how}"] = ops.round_column(t.column("dprice"), 1,
                                                      how)
    out["replace_nulls"] = ops.replace_nulls(t.column("customer"), 0)
    out["clamp"] = ops.clamp(t.column("qty"), 5, 95)
    out["nans_to_nulls"] = ops.nans_to_nulls(t.column("list_price"))
    out["find_and_replace"] = ops.find_and_replace(t.column("qty"), [1, 100],
                                                   [0, 99])
    return out


def oplib_n3(t, bounds, promo) -> dict:
    """(n3): the reductions over quantity and price (any/all over keep),
    scans, quantiles, Spark's range partitioning by (item, date) into 200
    partitions (``upper_bound`` against 199 sorted bounds) and
    ``contains_column`` of the promoted items."""
    from spark_rapids_jni_tpu_torch import ops

    out = {}
    for src in ("qty", "price"):
        for op in REDUCTIONS:
            out[f"{src}.{op}"] = ops.reduce_column(t.column(src), op)
    for src in ("ratio", "odd_qty"):
        out[f"{src}.product"] = ops.reduce_column(t.column(src), "product")
    for op in ("any", "all"):
        out[f"keep.{op}"] = ops.reduce_column(t.column("keep"), op)
    out["scan_sum_qty"] = ops.scan(t.column("qty"), "sum")
    out["scan_max_qty"] = ops.scan(t.column("qty"), "max")
    out["scan_sum_price"] = ops.scan(t.column("price"), "sum")
    for how in OPLIB_INTERP:
        out[f"quantile_{how}"] = ops.quantile(t.column("price"), OPLIB_QS,
                                              how)
    keys = t.__class__([t.column("item"), t.column("date")], ["item", "date"])
    out["range_part"] = ops.upper_bound(bounds, keys)
    out["promoted"] = ops.contains_column(promo, t.column("item"))
    return out


def oplib_n4(t) -> dict:
    """(n4): STRUCT(item, date, price): pack, argsort, gather by that
    order, filter on keep, unpack."""
    from spark_rapids_jni_tpu_torch import struct as st
    from spark_rapids_jni_tpu_torch.ops import gather_column

    s = st.pack(t, ["item", "date", "price"])
    order = s.argsort()
    sorted_s = s.gather(order)
    keep = gather_column(t.column("keep"), order)
    kept = sorted_s.filter(keep)
    out = {"order": order}
    for name, c in zip(kept.names, st.unpack(kept).columns):
        out[f"unpack.{name}"] = c
    return out


def oplib_inputs(t, od: dict, device):
    from spark_rapids_jni_tpu_torch.column import Column, Table
    from spark_rapids_jni_tpu_torch.ops import gather_table

    rows = torch.from_numpy(od["bound_rows"]).to(device)
    keys = Table([t.column("item"), t.column("date")], ["item", "date"])
    bounds = gather_table(keys, rows)
    promo = Column.from_numpy(od["promo"], device=device)
    return bounds, promo


OPLIB_PARTS = {
    "n1": lambda t, b, p: oplib_n1(t), "n2": lambda t, b, p: oplib_n2(t),
    "n3": lambda t, b, p: oplib_n3(t, b, p), "n4": lambda t, b, p: oplib_n4(t),
}


def column_bytes(c) -> tuple:
    """A result's host bytes: a column's data, validity and lengths, or a
    bare tensor."""
    if isinstance(c, torch.Tensor):
        return (c.cpu().numpy().tobytes(),)
    return tuple(None if x is None else x.cpu().numpy().tobytes()
                 for x in (c.data, c.validity, c.lengths))


def column_digest(c) -> tuple:
    """The SHA-256 of each buffer of :func:`column_bytes` (what (n)'s CPU
    reference child sends back instead of the bytes)."""
    import hashlib

    return tuple(None if b is None else hashlib.sha256(b).hexdigest()
                 for b in column_bytes(c))


def host_values(c):
    """(values, valid) on the host: FLOAT64 as float64."""
    if isinstance(c, torch.Tensor):
        return c.cpu().numpy(), None
    v = c.to_numpy()
    ok = (np.ones(v.shape[0], bool) if c.validity is None
          else c.validity.cpu().numpy())
    return v, ok


def oplib_check(name: str, got, want, valid=None, rtol=0.0, atol=0.0) -> None:
    """One output against its numpy oracle: validity equal where given,
    values exact (rtol = atol = 0) or within the bound, where valid."""
    v, ok = host_values(got)
    if valid is not None:
        if not np.array_equal(ok, valid):
            raise AssertionError(f"(n) {name}: validity differs from numpy")
        v, want = v[valid], np.asarray(want)[valid]
    want = np.asarray(want)
    if v.shape != want.shape:
        raise AssertionError(f"(n) {name}: shape {v.shape} vs {want.shape}")
    if rtol == 0.0 and atol == 0.0:
        if not np.array_equal(v, want.astype(v.dtype)):
            bad = int(np.sum(v != want))
            raise AssertionError(f"(n) {name}: {bad} values differ from numpy")
    elif not np.allclose(v, want, rtol=rtol, atol=atol, equal_nan=True):
        raise AssertionError(f"(n) {name}: past rtol {rtol} atol {atol}")


def segment_starts(keys: np.ndarray) -> np.ndarray:
    """For sorted ``keys``, the index of each row's run start."""
    n = keys.shape[0]
    new = np.ones(n, bool)
    new[1:] = keys[1:] != keys[:-1]
    return np.maximum.accumulate(np.where(new, np.arange(n), 0))


def oracle_n1(d: dict, od: dict, out: dict) -> None:
    """(n1) against numpy: integers and ranks exact, float sums within
    ``OPLIB_RTOL`` of the exact cent sums (plus the rounding of the
    2^23-row prefix the difference is taken of)."""
    n = d["item_sk"].shape[0]
    item, days, cents = d["item_sk"], od["days"].astype(np.int64), od["cents"]
    qty, qok = d["quantity"], d["quantity_ok"]
    perm = np.lexsort((days, item))  # stable, as the port's sort
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    si, sd, sc = item[perm], days[perm], cents[perm]
    start = segment_starts(si)
    pos = np.arange(n)
    ends = np.empty(n, np.int64)
    new = np.r_[True, si[1:] != si[:-1]]
    firsts = np.flatnonzero(new)
    seg_end = np.r_[firsts[1:], n]
    ends = np.repeat(seg_end, np.diff(np.r_[firsts, n]))
    cum = np.cumsum(sc)
    before = np.where(start > 0, cum[start - 1], 0)
    run = (cum - before)[inv] / 100
    total = (cum[ends - 1] - before)[inv]
    size = (ends - start)[inv]
    prefix_err = 8 * float(cum[-1]) / 100 * 2.0**-52
    oplib_check("running_sum", out["running_sum"], run, np.ones(n, bool),
                OPLIB_RTOL, prefix_err)
    oplib_check("avg", out["avg"], total / 100 / size, np.ones(n, bool),
                OPLIB_RTOL, prefix_err)
    sq, sok = qty[perm].astype(np.int64), qok[perm]
    for name, fn, fill in (("min3", np.minimum, 1 << 40),
                           ("max3", np.maximum, -(1 << 40))):
        acc = np.full(n, fill, np.int64)
        cnt = np.zeros(n, np.int64)
        for k in range(-3, 4):
            j = pos + k
            inside = (j >= start) & (j < ends)
            jj = np.clip(j, 0, n - 1)
            use = inside & sok[jj]
            acc = np.where(use, fn(acc, sq[jj]), acc)
            cnt += use
        oplib_check(name, out[name], acc[inv], (cnt > 0)[inv])
    comp = si * (1 << 21) + sd  # days < 2^21 here
    lo = np.searchsorted(comp, si * (1 << 21) + sd - 30, "left")
    hi = np.searchsorted(comp, comp, "right")
    vc = np.r_[0, np.cumsum(sok)]
    cnt30 = (vc[hi] - vc[lo])[inv]
    # a frame without a valid quantity is null (min_periods 1, cudf's rule)
    oplib_check("count30", out["count30"], cnt30, cnt30 > 0)
    # ranks by item, price descending (stable: ties keep row order)
    rperm = np.lexsort((-cents, item))
    rinv = np.empty(n, np.int64)
    rinv[rperm] = np.arange(n)
    ri, rc = item[rperm], cents[rperm]
    rstart = segment_starts(ri)
    rnew = np.r_[True, ri[1:] != ri[:-1]]
    rf = np.flatnonzero(rnew)
    rends = np.repeat(np.r_[rf[1:], n], np.diff(np.r_[rf, n]))
    tie = np.r_[True, (ri[1:] != ri[:-1]) | (rc[1:] != rc[:-1])]
    group_start = np.maximum.accumulate(np.where(tie, pos, 0))
    rank = group_start - rstart + 1
    ctie = np.cumsum(tie)
    dense = ctie - ctie[rstart] + 1
    rsize = rends - rstart
    ones = np.ones(n, bool)
    oplib_check("rank", out["rank"], rank[rinv], ones)
    oplib_check("dense_rank", out["dense_rank"], dense[rinv], ones)
    oplib_check("row_number", out["row_number"], (pos - rstart + 1)[rinv],
                ones)
    pr = np.where(rsize > 1, (rank - 1) / np.maximum(rsize - 1, 1), 0.0)
    oplib_check("percent_rank", out["percent_rank"], pr[rinv], ones,
                OPLIB_RTOL)
    rp = pos - rstart
    base, rem = rsize // 4, rsize % 4
    big = rem * (base + 1)
    tile = np.where(rp < big, rp // np.maximum(base + 1, 1),
                    rem + (rp - big) // np.maximum(base, 1)) + 1
    oplib_check("ntile4", out["ntile4"], tile[rinv], ones)
    sp = sc / 100
    lag_ok = np.r_[False, si[1:] == si[:-1]]
    lead_ok = np.r_[si[1:] == si[:-1], False]
    oplib_check("lag", out["lag"], np.r_[0.0, sp[:-1]], lag_ok)
    oplib_check("lead", out["lead"], np.r_[sp[1:], 0.0], lead_ok)


def oracle_n2(d: dict, od: dict, out: dict) -> None:
    """(n2) against numpy's datetime64 calendar and integer rounding."""
    n = d["item_sk"].shape[0]
    ones = np.ones(n, bool)
    for src, ticks, unit in (("date", od["days"], "D"),
                             ("time", od["micros"], "us")):
        t64 = ticks.astype(np.int64).astype(f"datetime64[{unit}]")
        D = t64.astype("datetime64[D]")
        Y, M = D.astype("datetime64[Y]"), D.astype("datetime64[M]")
        sod = (t64 - D).astype("timedelta64[us]").astype(np.int64) // 10**6
        sub_us = (t64 - t64.astype("datetime64[s]")).astype(
            "timedelta64[us]").astype(np.int64)
        month = M.astype(np.int64) % 12 + 1
        days = D.astype(np.int64)
        want = {
            "year": Y.astype(np.int64) + 1970, "month": month,
            "day": (D - M.astype("datetime64[D]")).astype(np.int64) + 1,
            "hour": sod // 3600, "minute": sod // 60 % 60, "second": sod % 60,
            "weekday": (D - np.datetime64("1970-01-05")).astype(np.int64) % 7 + 1,
            "day_of_year": (D - Y.astype("datetime64[D]")).astype(np.int64) + 1,
            "quarter": (month - 1) // 3 + 1,
            "last_day_of_month": ((M + 1).astype("datetime64[D]")
                                  - np.timedelta64(1, "D")).astype(np.int64),
            "millisecond_fraction": sub_us // 1000,
            "microsecond_fraction": sub_us % 1000,
            "nanosecond_fraction": np.zeros(n, np.int64),
            "day_of_week_sunday":
                (D - np.datetime64("1970-01-04")).astype(np.int64) % 7 + 1,
        }
        for f in DT_FIELDS:
            oplib_check(f"{src}.{f}", out[f"{src}.{f}"], want[f], ones)
        q_start = M - ((month - 1) % 3).astype("timedelta64[M]")
        week = D - ((D - np.datetime64("1970-01-05")).astype(np.int64)
                    % 7).astype("timedelta64[D]")
        trunc = {"year": Y, "quarter": q_start, "month": M, "week": week,
                 "day": D, "hour": t64.astype("datetime64[h]"),
                 "minute": t64.astype("datetime64[m]"),
                 "second": t64.astype("datetime64[s]")}
        for u in TRUNC_UNITS:
            oplib_check(f"{src}.trunc_{u}", out[f"{src}.trunc_{u}"],
                        trunc[u].astype(f"datetime64[{unit}]").astype(np.int64),
                        ones)
        tod = t64 - D
        m7 = M + np.timedelta64(7, "M")
        day = (D - M.astype("datetime64[D]")).astype(np.int64)
        mlen = ((m7 + 1).astype("datetime64[D]")
                - m7.astype("datetime64[D]")).astype(np.int64)
        shifted = (m7.astype("datetime64[D]")
                   + np.minimum(day, mlen - 1).astype("timedelta64[D]"))
        oplib_check(f"{src}.add_months", out[f"{src}.add_months"],
                    (shifted.astype(f"datetime64[{unit}]") + tod).astype(
                        np.int64), ones)
    p, cents = od["price"], od["cents"]
    s = p * 10
    oplib_check("round_price_half_up", out["round_price_half_up"],
                np.where(s >= 0, np.floor(s + 0.5), np.ceil(s - 0.5)) / 10,
                ones)
    oplib_check("round_price_half_even", out["round_price_half_even"],
                np.round(s) / 10, ones)
    oplib_check("round_dprice_half_up", out["round_dprice_half_up"],
                (cents + 5) // 10 * 10, od["dec_ok"])
    oplib_check("round_dprice_half_even", out["round_dprice_half_even"],
                np.round(cents / 10).astype(np.int64) * 10, od["dec_ok"])
    oplib_check("replace_nulls", out["replace_nulls"],
                np.where(d["customer_ok"], d["customer_sk"], 0), ones)
    q = d["quantity"]
    oplib_check("clamp", out["clamp"], np.clip(q, 5, 95), d["quantity_ok"])
    lp = od["list_price"]
    oplib_check("nans_to_nulls", out["nans_to_nulls"], lp, ~np.isnan(lp))
    oplib_check("find_and_replace", out["find_and_replace"],
                np.where(q == 1, 0, np.where(q == 100, 99, q)),
                d["quantity_ok"])


def oracle_n3(d: dict, od: dict, out: dict) -> None:
    """(n3) against numpy: integer reductions and scans exact, float ones
    within ``OPLIB_RTOL``."""
    q = d["quantity"].astype(np.int64)
    qok = d["quantity_ok"]
    qv, p, cents = q[qok], od["price"], od["cents"]
    with np.errstate(over="ignore"):
        # INT64 products wrap mod 2^64, as the port's: the quantity's is
        # 0 and the price's +inf at 2^23 rows, the odd quantity's and
        # the ratio's are not
        prod_q = np.prod(qv)
        prod_p = np.prod(p)
        prod_odd = np.prod(2 * qv + 1)
    prod_ratio = np.prod(od["ratio"])
    if prod_odd == 0 or not np.isfinite(prod_ratio):
        raise AssertionError("(n) odd_qty.product is 0 or ratio.product is "
                             "not finite: these products would check "
                             "nothing")
    one = np.ones(1, bool)
    exact = {"qty.sum": qv.sum(), "qty.min": qv.min(), "qty.max": qv.max(),
             "qty.count": qok.sum(), "qty.product": prod_q,
             "price.min": p.min(), "price.max": p.max(),
             "price.count": p.shape[0], "price.product": prod_p,
             "odd_qty.product": prod_odd}
    for k, v in exact.items():
        oplib_check(k, out[k], [v], one)
    close = {"qty.mean": qv.mean(), "qty.variance": qv.var(ddof=1),
             "qty.std": qv.std(ddof=1), "price.sum": cents.sum() / 100,
             "price.mean": cents.sum() / 100 / p.shape[0],
             "price.variance": p.var(ddof=1), "price.std": p.std(ddof=1),
             "ratio.product": prod_ratio}
    for k, v in close.items():
        oplib_check(k, out[k], [v], one, OPLIB_RTOL)
    keep = d["keep"]
    oplib_check("keep.any", out["keep.any"], [keep.any()], one)
    oplib_check("keep.all", out["keep.all"], [keep.all()], one)
    oplib_check("scan_sum_qty", out["scan_sum_qty"],
                np.cumsum(np.where(qok, q, 0)), qok)
    oplib_check("scan_max_qty", out["scan_max_qty"],
                np.maximum.accumulate(np.where(qok, q, -(1 << 31))), qok)
    oplib_check("scan_sum_price", out["scan_sum_price"],
                np.cumsum(cents) / 100, np.ones(p.shape[0], bool), OPLIB_RTOL)
    sp = np.sort(p)
    pos = np.asarray(OPLIB_QS) * (p.shape[0] - 1)
    lo, hi = np.floor(pos).astype(np.int64), np.ceil(pos).astype(np.int64)
    frac = pos - np.floor(pos)
    want = {"linear": sp[lo] + (sp[hi] - sp[lo]) * frac, "lower": sp[lo],
            "higher": sp[hi], "midpoint": (sp[lo] + sp[hi]) * 0.5,
            "nearest": np.where(frac <= 0.5, sp[lo], sp[hi])}
    qone = np.ones(len(OPLIB_QS), bool)
    for how in OPLIB_INTERP:
        oplib_check(f"quantile_{how}", out[f"quantile_{how}"], want[how],
                    qone, OPLIB_RTOL)
    item, days = d["item_sk"], od["days"].astype(np.int64)
    comp = item * (1 << 21) + days
    b = od["bound_rows"]
    part = np.searchsorted(comp[b], comp, "right")
    oplib_check("range_part", out["range_part"], part,
                np.ones(item.shape[0], bool))
    oplib_check("promoted", out["promoted"], np.isin(item, od["promo"]),
                np.ones(item.shape[0], bool))


def oracle_n4(d: dict, od: dict, out: dict) -> None:
    """(n4) against a stable numpy lexsort and a boolean filter."""
    item, days, p = d["item_sk"], od["days"], od["price"]
    order = np.lexsort((p, days, item))
    oplib_check("order", out["order"], order)
    kept = order[d["keep"][order]]
    ones = np.ones(kept.shape[0], bool)
    for name, src in (("item", item), ("date", days), ("price", p)):
        oplib_check(f"unpack.{name}", out[f"unpack.{name}"], src[kept], ones)


OPLIB_ORACLES = {"n1": oracle_n1, "n2": oracle_n2, "n3": oracle_n3,
                 "n4": oracle_n4}


OPLIB_FACT_KEYS = ("item_sk", "customer_sk", "customer_ok", "quantity",
                   "quantity_ok", "keep")  # what oplib_table reads of (a)


def oplib_cpu_reference(in_path: str, out_path: str) -> int:
    """The body of (n)'s CPU reference child (``--oplib-cpu-reference IN
    OUT``): every part of ``OPLIB_PARTS`` on the CPU over the pickled
    (d, od) columns, each output's digest (:func:`column_digest`) and the
    part's CPU seconds pickled to ``out_path``. Needs no GPU."""
    import pickle

    torch.set_num_threads(K5_REF_THREADS)
    with open(in_path, "rb") as f:
        d, od = pickle.load(f)
    t0 = time.perf_counter()
    cpu = oplib_table(d, od, "cpu")
    cin = oplib_inputs(cpu, od, "cpu")
    out = {}
    for part, fn in OPLIB_PARTS.items():
        t1 = time.perf_counter()
        want = fn(cpu, *cin)
        out[part] = {k: column_digest(v) for k, v in want.items()}
        out[part + "_s"] = time.perf_counter() - t1
        del want
    out["_cpu_s"] = time.perf_counter() - t0
    write_reference(out_path, out)
    return 0


def phase_oplib(kernels, d: dict, od: dict) -> dict:
    """(n): each part on the card once with the launch counts set to 0
    just before and read just after (S1 must be launched in (n1)), every
    output byte for byte against the port's own CPU run of the same
    inputs (a :class:`CpuReference` child that runs beside the card's
    calls; the SHA-256 of every buffer compared) and against numpy; then the wall (median of 5 runs after the
    checked run), the host syncs of one run, a profiled window (device
    time, busy share, top kernels), and for (n1) the peak device memory
    of the MIN window (its sparse table) and ``_lex_searchsorted`` alone
    under the profiler (launches and device time)."""
    from spark_rapids_jni_tpu_torch.ops import join as pjoin
    from spark_rapids_jni_tpu_torch.ops import keys as pkeys
    from spark_rapids_jni_tpu_torch.ops import window as pw

    reference = CpuReference(
        "oplib", "--oplib-cpu-reference",
        ({k: d[k] for k in OPLIB_FACT_KEYS}, od))
    try:
        gpu = oplib_table(d, od, DEVICE)
        gin = oplib_inputs(gpu, od, DEVICE)
        out, got_digests = {}, {}
        for part, fn in OPLIB_PARTS.items():
            torch.cuda.synchronize()
            kernels.reset_launches()
            got = fn(gpu, *gin)
            torch.cuda.synchronize()
            launches = {k: v.launches for k, v in kernels.KERNELS.items()}
            got_digests[part] = {k: column_digest(v) for k, v in got.items()}
            OPLIB_ORACLES[part](d, od, got)
            runner = oplib_runner(fn, gpu, gin)
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                runner()
                times.append((time.perf_counter() - t0) * 1e3)
            median = statistics.median(times)
            syncs = count_syncs(runner)
            log(f"({part}) {len(got)} outputs equal numpy; wall median "
                f"{median:.2f} ms over 5 runs (all: "
                f"{[round(t, 2) for t in times]}); host syncs a run {syncs}; "
                f"launches {launches}")
            profile = profile_plan(runner, median, f"({part})")
            out[part] = {"outputs": len(got), "wall_ms": median,
                         "syncs": syncs, "launches": launches,
                         "profile": profile}
            del got
        ref = reference.result()
    finally:
        reference.stop()
    for part in OPLIB_PARTS:
        want = ref[part]
        differ = [k for k in got_digests[part] if got_digests[part][k] != want[k]]
        if differ:
            raise AssertionError(f"({part}) differs from the CPU run: {differ}")
        out[part]["cpu_run_s"] = ref[part + "_s"]
        log(f"({part}) {len(want)} outputs equal the CPU run's bytes (CPU run "
            f"{ref[part + '_s']:.1f} s in the child)")
    out["cpu_reference_wait_s"] = ref["_waited_s"]
    del got_digests, ref
    if out["n1"]["launches"]["scan16"] == 0:
        raise AssertionError("(n1) never launched scan16")
    # the MIN window's peak: the sparse table of 24 levels at 2^23 rows
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = pw.grouped_rolling_aggregate(gpu, ["item"], ["date"], "qty", 3, 3,
                                       "min")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del res
    n = gpu.row_count
    table_bytes = (1 + (n - 1).bit_length()) * n * 4
    log(f"(n1) MIN window: peak {peak / 2**20:.1f} MiB above the inputs "
        f"(the position table alone {table_bytes / 2**20:.1f} MiB)")
    out["n1"]["minmax_peak_bytes"] = peak
    out["n1"]["sparse_table_bytes"] = table_bytes
    # _lex_searchsorted alone: (n3)'s range partitioning of the 2^23 rows
    hw = pkeys.table_order_keys(list(gin[0].columns))
    qw = pkeys.table_order_keys([gpu.column("item"), gpu.column("date")])
    m = hw[0].shape[0]
    out["n3"]["lex_searchsorted"] = op_profile(
        lambda: pjoin._lex_searchsorted(hw, qw, "right"),
        f"(n3) _lex_searchsorted of {n} rows in {m} bounds "
        f"({max(1, m.bit_length())} steps, 2 words)", 8 * 2 * n + 4 * n)
    out["n3"]["lex_searchsorted"]["wall_ms"] = cuda_ms(
        lambda: pjoin._lex_searchsorted(hw, qw, "right"), 5)
    return out


def oplib_runner(fn, t, inputs):
    def run():
        fn(t, *inputs)
        torch.cuda.synchronize()

    return run


def oplib_kernel_records(d: dict, od: dict, qn: dict) -> list:
    """S1 at (n1)'s shape: the FLOAT64 running sum's prefix over the
    2^23 prices in (item, date) order, with (n1)'s launches."""
    from spark_rapids_jni_tpu_torch.kernels import scan16
    from spark_rapids_jni_tpu_torch.ops.groupby import _scan_sum16

    perm = np.lexsort((od["days"], d["item_sk"]))
    v = torch.from_numpy(od["price"][perm]).to(DEVICE)
    n = v.shape[0]
    return [kernel_record(
        scan16.SCAN16, "window", f"{n} x FLOAT64",
        qn["n1"]["launches"]["scan16"],
        lambda: [scan16.scan_sum16(v).view(torch.int64)],
        lambda: [_scan_sum16(v).view(torch.int64)],
        16 * n, 0, library_fn=lambda: torch.cumsum(v, 0),
        note="(n1): the window SUM/AVG prefix; bits compared")]


# ---------------------------------------------------------------------------
# (o) the shape-bucket plane over a ragged batch stream; (p) the packed and
# chunked formulations and the eager groupby's router
# ---------------------------------------------------------------------------

# (o): a Spark task's ragged stream: a full batch, batches a row past a
# bucket or short of one (a file's last partial batch, AQE-coalesced or
# filter-shrunk batches), and the smallest
BUCKET_BATCH_ROWS = (8_388_608, 4_194_305, 3_000_000, 1_048_577, 1_048_575,
                     200_001, 1_025, 1)
# (o)'s resident chain: the semi join's build side is (i1)'s category
# items (table_ids[1]); the partition is (d)'s
BUCKET_RESIDENT_PLAN = [
    FROM_FACT_ROWS,
    {"op": "filter", "mask": 4},
    {"op": "sort_by", "keys": [{"column": 0}]},
    {"op": "join", "how": "semi", "on": [0]},
    {"op": "partition", "kind": "hash", "keys": [0, 1],
     "num": EXCHANGE_PARTITIONS},
    {"op": "to_rows"},
]
# the kernels each (o) run launches on some batch: under the default
# ladder the plan's groupby closes the fused [filter, cast, groupby] and
# the chain's sort_by sits in the fused [filter, sort_by], where the tier
# is not consulted, so K2a and K3 run there only op by op
_CHAIN_KERNELS = ("unpack_rows", "build_table", "probe_table",
                  "murmur3_table_fused", "pack_rows")
BUCKET_KERNELS = {
    ("default", "plan"): (WIRE_KERNELS, ("build_table",)),
    ("off", "plan"): (WIRE_OFF_KERNELS, ()),
    ("default", "chain"): (_CHAIN_KERNELS, ("batched_sort_u64_looped",)),
    ("off", "chain"): (_CHAIN_KERNELS + ("batched_sort_u64_looped",), ()),
}
BUCKET_COUNTERS = ("bucket.pad_tables", "compile_cache.hit",
                   "compile_cache.miss", "kernel.launches", "kernel.declines",
                   "bucket.dispatched", "bucket.declined")
# (p): BASELINE config 1 (16,000,000 rows, 10,000 int64 keys, SUM/COUNT)
# with a FLOAT64 SUM beside it, under each GROUPBY_FORMULATION
FORMULATIONS = ("single", "packed", "chunked")


def prefix_wire(d: dict, n: int):
    """The LIST<UINT8> wire batch of the first ``n`` fact rows."""
    offs = (np.arange(n + 1, dtype=np.int64) * 32).astype(np.int32)
    return ([24], [5], [offs.tobytes() + d["rows"][:n].tobytes()], [None], n)


def bucket_chain_oracle(d: dict, dd: dict, n: int) -> np.ndarray:
    """(o)'s resident chain over the first ``n`` rows in numpy: the kept
    rows of the category's items, stably sorted by item_sk, then stably
    by Spark's Pmod(Murmur3(item_sk, customer_sk), 200), as 32-byte rows
    of four columns (the keep flag gone: its validity bit too)."""
    m = d["keep"][:n] & category_mask(dd)[d["item_sk"][:n]]
    idx = np.flatnonzero(m)
    idx = idx[np.argsort(d["item_sk"][idx], kind="stable")]
    h = np.full(idx.shape[0], 42, np.uint32)
    h = murmur3_long_np(d["item_sk"][idx], None, h)
    h = murmur3_long_np(d["customer_sk"][idx], d["customer_ok"][idx], h)
    pid = np.mod(h.view(np.int32).astype(np.int64), EXCHANGE_PARTITIONS)
    idx = idx[np.argsort(pid, kind="stable")]
    rows = np.zeros((idx.shape[0], 32), np.uint8)
    rows[:, :28] = d["rows"][idx, :28]
    rows[:, 28] = d["rows"][idx, 29] & 0x0F
    return rows


def device_window_ms(run, runs: int = 2) -> float:
    """Device time a call of ``run`` (which ends in a synchronise), summed
    over every kernel and copy ``torch.profiler`` saw
    (:func:`device_events`), after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            run()
    return sum(e.self_device_time_total
               for e in device_events(prof)) / 1e3 / runs


def phase_buckets(rb, kernels, d: dict, dd: dict) -> dict:
    """(o): (h)'s plan through ``table_plan_wire`` and the resident chain
    ``BUCKET_RESIDENT_PLAN`` on each batch of ``BUCKET_BATCH_ROWS``, then
    the stream through ``table_stream_wire`` at depth 2, once with the
    default ladder and once with ``BUCKETS=off``: every result exact
    against numpy and the two runs' 5-tuples equal; per batch the wall
    and device time, the bucket and runner-cache counters and the tier's
    launches and declines, for each setting."""
    from spark_rapids_jni_tpu_torch.utils import buckets, config, metrics

    plan = json.dumps(WIRE_PLAN)
    chain = json.dumps(BUCKET_RESIDENT_PLAN)
    wires = {n: prefix_wire(d, n) for n in BUCKET_BATCH_ROWS}
    oracles = {n: (wire_plan_oracle(d, n), bucket_chain_oracle(d, dd, n))
               for n in BUCKET_BATCH_ROWS}
    out, rows = {}, []
    config.set_flag("METRICS", True)
    try:
        for setting in ("", "off"):
            config.set_flag("BUCKETS", setting)
            buckets.cache_clear()
            label = setting or "default"
            for n in BUCKET_BATCH_ROWS:
                rec = {"rows": n, "buckets": label,
                       "bucket": buckets.bucket_for(n)}

                def run_plan():
                    res = rb.table_plan_wire(plan, *wires[n], device=DEVICE)
                    torch.cuda.synchronize()
                    return res

                def run_chain():
                    ids = [rb.table_upload_wire(*wires[n], device=DEVICE),
                           rb.table_upload_wire(*dd["item_cat_wire"],
                                                device=DEVICE)]
                    try:
                        tid = rb.table_plan_resident(chain, ids, donate=True)
                        try:
                            return rb.table_download_wire(tid)
                        finally:
                            rb.table_free(tid)
                    finally:
                        rb.table_free(ids[1])

                for tag, fn in (("plan", run_plan), ("chain", run_chain)):
                    metrics.reset()
                    kernels.reset_launches()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = fn()
                    wall = (time.perf_counter() - t0) * 1e3
                    c = metrics.snapshot()
                    rec[tag] = {
                        "first_wall_ms": wall,
                        "counters": {k: c["counters"].get(k, 0)
                                     for k in BUCKET_COUNTERS},
                        "pad_waste_bytes": c["bytes"].get(
                            "bucket.pad_waste_bytes", 0),
                        "launches": {k: v.launches
                                     for k, v in kernels.KERNELS.items()
                                     if v.launches}}
                    out[(label, tag, n)] = res
                    times = []
                    for _ in range(3):
                        t0 = time.perf_counter()
                        fn()
                        times.append((time.perf_counter() - t0) * 1e3)
                    rec[tag]["wall_ms"] = statistics.median(times)
                    rec[tag]["device_ms"] = device_window_ms(fn)
                free = [k for k in rb._RESIDENT]
                if free:
                    raise AssertionError(f"(o) left resident ids {free}")
                check_rows(out[(label, "plan", n)], oracles[n][0])
                check_rows(out[(label, "chain", n)], oracles[n][1])
                log(f"(o) {label:7s} {n:>9,} rows (bucket {rec['bucket']}): "
                    f"plan {rec['plan']['wall_ms']:.2f} ms wall, "
                    f"{rec['plan']['device_ms']:.3f} ms device, "
                    f"{rec['plan']['counters']}, waste "
                    f"{rec['plan']['pad_waste_bytes']} B, launches "
                    f"{rec['plan']['launches']}; chain "
                    f"{rec['chain']['wall_ms']:.2f} ms wall, "
                    f"{rec['chain']['device_ms']:.3f} ms device, "
                    f"{rec['chain']['counters']}, waste "
                    f"{rec['chain']['pad_waste_bytes']} B, launches "
                    f"{rec['chain']['launches']}")
                rows.append(rec)
            config.set_flag("PIPELINE", "2")
            try:
                batches = [wires[n] for n in BUCKET_BATCH_ROWS]
                rb.table_stream_wire(plan, batches[-2:], device=DEVICE)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = rb.table_stream_wire(plan, batches, device=DEVICE)
                torch.cuda.synchronize()
                stream_ms = (time.perf_counter() - t0) * 1e3
            finally:
                config.clear_flag("PIPELINE")
            for n, res in zip(BUCKET_BATCH_ROWS, got):
                if tuple(res) != tuple(out[(label, "plan", n)]):
                    raise AssertionError(
                        f"(o) stream batch of {n} rows differs from "
                        "table_plan_wire")
            out[(label, "stream")] = stream_ms
            log(f"(o) {label} stream of {len(batches)} batches at depth 2: "
                f"{stream_ms:.1f} ms, every batch equal to table_plan_wire")
    finally:
        config.clear_flag("BUCKETS")
        config.clear_flag("METRICS")
    differ = [(tag, n) for n in BUCKET_BATCH_ROWS for tag in ("plan", "chain")
              if tuple(out[("default", tag, n)]) != tuple(out[("off", tag, n)])]
    if differ:
        raise AssertionError(f"(o) buckets default and off differ: {differ}")
    for (label, tag), (want, fused_out) in BUCKET_KERNELS.items():
        runs = [r[tag]["launches"] for r in rows if r["buckets"] == label]
        never = [k for k in want if not any(la.get(k) for la in runs)]
        if never:
            raise AssertionError(f"(o) {label} {tag} never launched {never}")
        inside = [k for k in fused_out if any(la.get(k) for la in runs)]
        if inside:
            raise AssertionError(f"(o) {label} {tag} launched {inside} "
                                 "inside a fused segment")
    log("(o) buckets default and off: equal 5-tuples for every batch")
    return {"batches": rows,
            "stream_ms": {k: out[(k, "stream")] for k in ("default", "off")}}


def phase_formulations(kernels, g: dict, d: dict, seed: int) -> dict:
    """(p): ``ops.groupby_aggregate`` of BASELINE config 1 with a FLOAT64
    sum under each ``GROUPBY_FORMULATION``: the integer columns equal
    numpy and each other, each FLOAT64 sum the port's CPU bytes for the
    same formulation; then ``sort_table_packed`` of (e)'s batch against
    ``sort_table`` and ``inner_join_batched_packed`` of (a)'s batch with
    item against ``inner_join``, equal bytes; each part profiled."""
    from spark_rapids_jni_tpu_torch import dtype as dt
    from spark_rapids_jni_tpu_torch import ops, rows as rows_mod
    from spark_rapids_jni_tpu_torch.column import Column, Table
    from spark_rapids_jni_tpu_torch.ops.join_packed import (
        inner_join_batched_packed,
    )
    from spark_rapids_jni_tpu_torch.ops.sort_packed import sort_table_packed
    from spark_rapids_jni_tpu_torch.utils import config

    rng = np.random.default_rng(seed + 15)
    f = rng.normal(50, 10, g["k"].shape[0])
    aggs = [ops.GroupbyAgg(1, "sum"), ops.GroupbyAgg(1, "count"),
            ops.GroupbyAgg(2, "sum")]

    def table(dev):
        return Table([Column.from_numpy(g["k"], device=dev),
                      Column.from_numpy(g["v"], device=dev),
                      Column.from_numpy(f, device=dev)], ["k", "v", "f"])

    keys, inv = np.unique(g["k"], return_inverse=True)
    want_sum = np.bincount(inv, weights=g["v"]).astype(np.int64)
    want_cnt = np.bincount(inv).astype(np.int64)
    gt, ct = table(DEVICE), table("cpu")
    res, parts = {}, {}
    try:
        for form in FORMULATIONS:
            config.set_flag("GROUPBY_FORMULATION", form)
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = ops.groupby_aggregate(gt, [0], aggs)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            launches = {k: v.launches for k, v in kernels.KERNELS.items()
                        if v.launches}
            cols = [c.data.cpu().numpy() for c in out.columns]
            for name, got, want in (("key", cols[0], keys),
                                    ("sum", cols[1], want_sum),
                                    ("count", cols[2], want_cnt)):
                if not np.array_equal(got, want):
                    raise AssertionError(f"(p) {form} {name} != numpy")
            cpu = ops.groupby_aggregate(ct, [0], aggs)
            fsum = cols[3].tobytes()
            if fsum != cpu.columns[3].data.numpy().tobytes():
                raise AssertionError(
                    f"(p) {form} FLOAT64 sums differ from the CPU's bytes")
            res[form] = cols

            def run():
                ops.groupby_aggregate(gt, [0], aggs)
                torch.cuda.synchronize()

            parts[form] = {"first_wall_ms": wall, "launches": launches,
                           "device_ms": device_window_ms(run),
                           "wall_ms": cuda_ms(run, 3)}
            log(f"(p) groupby {form}: {keys.shape[0]} groups exact, FLOAT64 "
                f"sums equal the CPU's bytes; {parts[form]['wall_ms']:.2f} ms "
                f"wall, {parts[form]['device_ms']:.3f} ms device; launches "
                f"{launches}")
    finally:
        config.clear_flag("GROUPBY_FORMULATION")
    for form in FORMULATIONS[1:]:
        for i in range(3):
            if not np.array_equal(res[form][i], res["single"][i]):
                raise AssertionError(f"(p) {form} column {i} != single's")
        parts[form]["float_sums_differ_from_single"] = int(
            (res[form][3] != res["single"][3]).sum())
    if not parts["packed"]["launches"].get("batched_sort_u32"):
        raise AssertionError("(p) the packed router launched no K4b")

    n = d["rows"].shape[0]
    fact = rows_mod.from_rows_list(
        Column(torch.from_numpy(d["rows"]).to(DEVICE), dt.DType(dt.TypeId.LIST),
               None, torch.full((n,), 32, dtype=torch.int32, device=DEVICE)),
        [dt.DType(dt.TypeId(t)) for t in FACT_TYPES])
    item = Table([Column.from_numpy(d["i_item_sk"], device=DEVICE),
                  Column.from_numpy(d["i_brand_id"], device=DEVICE),
                  Column.from_numpy(d["i_category_id"], device=DEVICE)])

    def same(a, b, what):
        for i, (x, y) in enumerate(zip(a.columns, b.columns)):
            for attr in ("data", "validity", "lengths"):
                u, v = getattr(x, attr), getattr(y, attr)
                if (u is None) != (v is None) or (
                        u is not None and not torch.equal(u, v)):
                    raise AssertionError(f"(p) {what}: column {i} {attr}")

    for tag, packed_fn, plain_fn in (
        ("sort_table_packed",
         lambda: sort_table_packed(fact, [0]),
         lambda: ops.sort_table(fact, [ops.SortKey(0)])),
        ("inner_join_batched_packed",
         lambda: inner_join_batched_packed(fact, item, [0]),
         lambda: ops.inner_join(fact, item, [0])),
    ):
        kernels.reset_launches()
        got = packed_fn()
        torch.cuda.synchronize()
        launches = {k: v.launches for k, v in kernels.KERNELS.items()
                    if v.launches}
        if got is None:
            raise AssertionError(f"(p) {tag} declined (e)'s batch")
        same(got, plain_fn(), tag)

        def run(fn=packed_fn):
            fn()
            torch.cuda.synchronize()

        def run_plain(fn=plain_fn):
            fn()
            torch.cuda.synchronize()

        parts[tag] = {"launches": launches, "rows": got.row_count,
                      "device_ms": device_window_ms(run),
                      "wall_ms": cuda_ms(run, 3),
                      "plain_device_ms": device_window_ms(run_plain),
                      "plain_wall_ms": cuda_ms(run_plain, 3)}
        log(f"(p) {tag}: {got.row_count} rows equal the general op's bytes; "
            f"{parts[tag]['wall_ms']:.2f} ms wall, "
            f"{parts[tag]['device_ms']:.3f} ms device (general op "
            f"{parts[tag]['plain_wall_ms']:.2f} ms wall, "
            f"{parts[tag]['plain_device_ms']:.3f} ms device); launches "
            f"{launches}")
        if not launches.get("batched_sort_u64_looped"):
            raise AssertionError(f"(p) {tag} launched no K3")
    return parts


# ---------------------------------------------------------------------------
# (q) plan fusion
# ---------------------------------------------------------------------------

FUSION_COUNTERS = ("plan.calls", "plan.segments", "plan.fused_segments",
                   "plan.fused_ops", "plan.exact_ops", "plan.fallbacks",
                   "plan.declined", "plan.chunked_segments")
# the segments under the default ladder: (h)'s plan is [from_rows]
# [filter, cast, groupby] [sort_by] [to_rows]; (o)'s chain is
# [from_rows] [filter, sort_by] [join] [partition] [to_rows]
FUSION_WANT = {
    "plan": {"plan.segments": 4, "plan.fused_segments": 1,
             "plan.fused_ops": 3, "plan.exact_ops": 3, "plan.fallbacks": 0},
    "chain": {"plan.segments": 5, "plan.fused_segments": 1,
              "plan.fused_ops": 2, "plan.exact_ops": 4, "plan.fallbacks": 0},
}
FUSION_OPS = {"plan": len(WIRE_PLAN), "chain": len(BUCKET_RESIDENT_PLAN)}


def phase_fusion(rb, d: dict, dd: dict) -> dict:
    """(q): (h)'s plan through ``table_plan_wire`` and (o)'s resident
    chain (donated) over (a)'s 2^23-row batch, with the default ladder
    (fused segments) and with ``BUCKETS=off`` (op by op): each exact
    against its numpy oracle, the two settings' 5-tuples equal, the
    ``plan.*`` counters as ``FUSION_WANT`` (no fallback), every fused
    segment's host syncs counted (at most one: its count), wall (median
    of 3) and device time for each setting."""
    from spark_rapids_jni_tpu_torch import plan as plan_mod
    from spark_rapids_jni_tpu_torch.utils import buckets, config, metrics

    n = FACT_ROWS
    wire = prefix_wire(d, n)
    oracles = {"plan": wire_plan_oracle(d, n),
               "chain": bucket_chain_oracle(d, dd, n)}
    plan, chain = json.dumps(WIRE_PLAN), json.dumps(BUCKET_RESIDENT_PLAN)

    def run_plan():
        res = rb.table_plan_wire(plan, *wire, device=DEVICE)
        torch.cuda.synchronize()
        return res

    def run_chain():
        ids = [rb.table_upload_wire(*wire, device=DEVICE),
               rb.table_upload_wire(*dd["item_cat_wire"], device=DEVICE)]
        try:
            tid = rb.table_plan_resident(chain, ids, donate=True)
            try:
                return rb.table_download_wire(tid)
            finally:
                rb.table_free(tid)
        finally:
            rb.table_free(ids[1])

    real, syncs = plan_mod._run_fused, []

    def counted(seg_ops, table):
        box = {}
        syncs.append(sync_sites(
            lambda: box.setdefault("out", real(seg_ops, table))))
        return box["out"]

    out, recs = {}, {}
    config.set_flag("METRICS", True)
    try:
        for setting in ("", "off"):
            label = setting or "default"
            config.set_flag("BUCKETS", setting)
            buckets.cache_clear()
            for tag, fn in (("plan", run_plan), ("chain", run_chain)):
                metrics.reset()
                syncs.clear()
                plan_mod._run_fused = counted
                try:
                    res = fn()
                finally:
                    plan_mod._run_fused = real
                counters = metrics.counter_values(list(FUSION_COUNTERS))
                check_rows(res, oracles[tag])
                out[(label, tag)] = res
                times = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    fn()
                    times.append((time.perf_counter() - t0) * 1e3)
                rec = {"counters": counters, "segment_syncs": list(syncs),
                       "wall_ms": statistics.median(times),
                       "device_ms": device_window_ms(fn)}
                recs[f"{label} {tag}"] = rec
                log(f"(q) {label:7s} {tag:5s}: exact against numpy; "
                    f"{rec['wall_ms']:.2f} ms wall, {rec['device_ms']:.3f} ms "
                    f"device; host syncs of each fused segment (where) "
                    f"{rec['segment_syncs']}"
                    f"; {counters}")
    finally:
        plan_mod._run_fused = real
        config.clear_flag("BUCKETS")
        config.clear_flag("METRICS")
    for tag, want in FUSION_WANT.items():
        if tuple(out[("default", tag)]) != tuple(out[("off", tag)]):
            raise AssertionError(f"(q) {tag}: default and off differ")
        got = recs[f"default {tag}"]
        bad = {k: (got["counters"][k], v) for k, v in want.items()
               if got["counters"][k] != v}
        if bad:
            raise AssertionError(f"(q) {tag} counters (got, want): {bad}")
        if (len(got["segment_syncs"]) != 1
                or max(map(len, got["segment_syncs"])) > 1):
            raise AssertionError(f"(q) {tag}: a fused segment read the host "
                                 f"{got['segment_syncs']} times")
        off = recs[f"off {tag}"]["counters"]
        if (off["plan.fused_segments"], off["plan.exact_ops"]) != (
                0, FUSION_OPS[tag]):
            raise AssertionError(f"(q) {tag} off did not run op by op: {off}")
    log("(q) plan fusion: default and off equal for the plan and the chain; "
        "no fallback; one host read a fused segment at most")
    return recs


# ---------------------------------------------------------------------------
# (r) the IO layer: a Parquet scan into the query plan
# ---------------------------------------------------------------------------

IO_ROW_GROUP = 1 << 20  # 8 row groups of the 2^23-row split
YEAR_2000 = (2_451_545, 2_451_910)  # d_year = 2000 as date_dim surrogate keys
IO_PRED = [("ss_sold_date_sk", ">=", YEAR_2000[0]),
           ("ss_sold_date_sk", "<=", YEAR_2000[1])]
IO_FACT_COLUMNS = ["ss_item_sk", "ss_customer_sk", "ss_sold_date_sk",
                   "ss_quantity"]
# (a)'s plan after its filter: the scan's pushdown is the WHERE
IO_PLAN = PLAN[2:]
IO_KERNELS = ("build_table", "probe_table", "pack_rows")
IO_STREAM = (("device decode, prefetch 0", True, 0),
             ("device decode, prefetch 2", True, 2),
             ("Arrow decode, prefetch 2", False, 2))
IO_STREAM_RUNS = 3
IO_OTHER_ROWS = 1 << 20  # (r3): ORC, CSV, JSON, Arrow IPC
IO_AVRO_ROWS = 1 << 16  # (r3): the Avro codec decodes a value at a time
IO_BRAND_PAD = 24  # the longest brand name is 20 bytes


def make_io_data(d: dict) -> dict:
    """(r)'s split: (a)'s columns as TPC-DS types (INT32 keys and
    quantity), sorted by the sold date as a date-clustered fact table
    lies on disk, and item's brand strings."""
    order = np.argsort(d["date_sk"], kind="stable")
    s = {
        "item_sk": d["item_sk"][order].astype(np.int32),
        "customer_sk": d["customer_sk"][order].astype(np.int32),
        "customer_ok": d["customer_ok"][order],
        "date_sk": d["date_sk"][order].astype(np.int32),
        "quantity": d["quantity"][order],
        "quantity_ok": d["quantity_ok"][order],
        "i_item_sk": d["i_item_sk"].astype(np.int32),
        "i_brand_id": d["i_brand_id"],
    }
    brands = [a + b + b" #" + str(c + 1).encode() for a in BRAND_SYLLABLES
              for b in BRAND_SYLLABLES for c in range(10)]
    s["brands"] = brands
    s["brand_idx"] = d["i_brand_id"] - 1_001_001
    return s


def io_fact_arrow(s: dict, rows=slice(None), brand: bool = False):
    """The fact rows ``rows`` as an Arrow table with TPC-DS's schema
    (ss_item_sk NOT NULL), plus i_brand where ``brand``."""
    import pyarrow as pa

    cols = {
        "ss_item_sk": pa.array(s["item_sk"][rows]),
        "ss_customer_sk": pa.array(s["customer_sk"][rows],
                                   mask=~s["customer_ok"][rows]),
        "ss_sold_date_sk": pa.array(s["date_sk"][rows]),
        "ss_quantity": pa.array(s["quantity"][rows],
                                mask=~s["quantity_ok"][rows]),
    }
    fields = [pa.field(k, pa.int32(), nullable=k != "ss_item_sk")
              for k in cols]
    if brand:
        idx = s["brand_idx"][s["item_sk"][rows]]
        cols["i_brand"] = pa.array([s["brands"][i] for i in idx], pa.string())
        fields.append(pa.field("i_brand", pa.string()))
    return pa.table(list(cols.values()), schema=pa.schema(fields))


def write_io_files(s: dict, root: str) -> dict:
    """store_sales (snappy, pyarrow's default dictionary encoding, 8 row
    groups of 2^20) and item (i_item_sk NOT NULL, i_brand_id, i_brand)."""
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq

    fact = os.path.join(root, "store_sales.parquet")
    pq.write_table(io_fact_arrow(s), fact, row_group_size=IO_ROW_GROUP,
                   compression="snappy")
    item = os.path.join(root, "item.parquet")
    n = s["i_item_sk"].shape[0]
    pq.write_table(pa.table(
        [pa.array(s["i_item_sk"]), pa.array(s["i_brand_id"]),
         pa.array([s["brands"][i] for i in s["brand_idx"]], pa.string())],
        schema=pa.schema([pa.field("i_item_sk", pa.int32(), nullable=False),
                          pa.field("i_brand_id", pa.int32()),
                          pa.field("i_brand", pa.string())])), item,
        row_group_size=n, compression="snappy")
    return {"fact": fact, "item": item}


def host_columns(t) -> dict:
    """Every column of a port table on the host: (data, validity with
    None as all valid, lengths)."""
    out = {}
    for name, c in zip(t.names, t.columns):
        v = (np.ones(c.row_count, np.bool_) if c.validity is None
             else c.validity.cpu().numpy())
        lens = None if c.lengths is None else c.lengths.cpu().numpy()
        out[name] = (c.data.cpu().numpy(), v, lens)
    return out


def same_host_columns(a: dict, b: dict, what: str) -> None:
    if list(a) != list(b):
        raise AssertionError(f"{what}: columns {list(a)} != {list(b)}")
    for name in a:
        for x, y, part in zip(a[name], b[name], ("data", "validity",
                                                 "lengths")):
            if (x is None) != (y is None) or (
                    x is not None and (x.shape != y.shape
                                       or x.tobytes() != y.tobytes())):
                raise AssertionError(f"{what}: {name} {part} differs")


def io_numpy_rows(s: dict, mask: np.ndarray) -> dict:
    """numpy's rows of the fact columns under ``mask``, nulls as 0."""
    out = {}
    for name, key, ok in (("ss_item_sk", "item_sk", None),
                          ("ss_customer_sk", "customer_sk", "customer_ok"),
                          ("ss_sold_date_sk", "date_sk", None),
                          ("ss_quantity", "quantity", "quantity_ok")):
        valid = (np.ones(int(mask.sum()), np.bool_) if ok is None
                 else s[ok][mask])
        out[name] = (np.where(valid, s[key][mask], 0).astype(np.int32),
                     valid, None)
    return out


def io_check_plan(rb, out, s: dict, mask: np.ndarray) -> int:
    want = query_oracle({**s, "keep": mask})
    return check_query_result(rb._table_to_wire(out), want)


def io_host_decode(pdev, path: str, pf, rg: int, columns) -> dict:
    """The host half of the device decode of one row group, alone: page
    headers, decompression and the RLE run headers. Returns its time and
    the bytes the device path uploads still encoded."""
    schema = pf.schema_arrow
    meta = pf.metadata.row_group(rg)
    by_name = {meta.column(i).path_in_schema: i for i in range(meta.num_columns)}
    t0 = time.perf_counter()
    encoded = 0
    with open(path, "rb") as f:
        for name in columns:
            nullable = schema.field(name).nullable
            for p in pdev.read_chunk_pages(f, meta.column(by_name[name])):
                encoded += len(p.payload)
                if p.kind == pdev._PAGE_DICT:
                    continue
                pos, n_dense = 0, p.num_values
                if nullable:
                    dl = int.from_bytes(p.payload[:4], "little")
                    raw = p.payload[4:4 + dl]
                    runs = pdev.parse_rle_runs(raw, 1, p.num_values)
                    n_dense = pdev._defined_count(runs, raw, p.num_values)
                    pos = 4 + dl
                if p.encoding != pdev._ENC_PLAIN:
                    bw = p.payload[pos]
                    if bw:
                        pdev.parse_rle_runs(p.payload[pos + 1:], bw,
                                            max(n_dense, 1))
    return {"host_ms": (time.perf_counter() - t0) * 1e3, "encoded": encoded}


def phase_io(kernels, d: dict) -> dict:
    """(r): the IO layer on the card. A Spark task's input split of TPC-DS
    SF100 store_sales (2^23 rows, (a)'s distributions, sorted by the sold
    date) is written to Parquet in a temporary directory with item:
    (r1) WHERE d_year = 2000 through ``read_parquet`` and ``scan_parquet``
    with each decode: the row groups kept against the footer's statistics,
    the three tables equal and equal to numpy's rows, then (a)'s join ->
    groupby -> to_rows through ``plan.run_plan``, exact against numpy;
    (r2) the whole file one row group a batch (device decode at prefetch 0
    and 2, the Arrow decode at prefetch 2), each batch's plan result exact,
    the fallback lists, walls, host and device times, bytes and launches;
    (r3) ORC, CSV, JSON and Arrow IPC at 2^20 of the rows with i_brand and
    Avro at 2^16, each read with the predicate equal to Parquet's."""
    import shutil
    import tempfile

    try:
        import pyarrow  # noqa: F401
    except ImportError as e:
        log(f"(r) pyarrow: absent ({e})")
        return phase_io_without_pyarrow(d)
    log(f"(r) pyarrow: {pyarrow.__version__}")
    root = tempfile.mkdtemp(prefix="chip_smoke_io_")
    try:
        return phase_io_files(kernels, make_io_data(d), root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_io_files(kernels, s: dict, root: str) -> dict:
    import pyarrow.parquet as pq

    from spark_rapids_jni_tpu_torch import io as pio
    from spark_rapids_jni_tpu_torch import plan as plan_mod
    from spark_rapids_jni_tpu_torch import runtime_bridge as rb
    from spark_rapids_jni_tpu_torch.io import parquet as pparquet
    from spark_rapids_jni_tpu_torch.io import parquet_device as pdev
    from spark_rapids_jni_tpu_torch.io import predicates as ppreds
    from spark_rapids_jni_tpu_torch.ops.copying import concatenate

    t0 = time.perf_counter()
    paths = write_io_files(s, root)
    log(f"(r) wrote the {FACT_ROWS}-row split and item in "
        f"{time.perf_counter() - t0:.1f} s")
    res = {}
    pf = pq.ParquetFile(paths["fact"])
    n_groups = pf.metadata.num_row_groups
    # (r1) pushdown
    kept = [rg for rg in range(n_groups)
            if (pf.metadata.row_group(rg).column(2).statistics.max
                >= YEAR_2000[0])
            and (pf.metadata.row_group(rg).column(2).statistics.min
                 <= YEAR_2000[1])]
    pruned = pparquet._surviving_row_groups(pf, ppreds.from_dnf(IO_PRED))
    if pruned != kept or len(kept) != 2 or n_groups != 8:
        raise AssertionError(f"(r1) kept row groups {pruned}, the footer's "
                             f"{kept} of {n_groups} (2 of 8 expected)")
    coarse = list(pio.scan_parquet(paths["fact"], filters=IO_PRED,
                                   exact_filter=False, device=DEVICE))
    if [t.row_count for t in coarse] != [IO_ROW_GROUP] * 2:
        raise AssertionError("(r1) the scan decoded other row groups")
    del coarse
    mask = (s["date_sk"] >= YEAR_2000[0]) & (s["date_sk"] <= YEAR_2000[1])
    want_rows = io_numpy_rows(s, mask)
    item = pio.read_parquet(paths["item"], columns=["i_item_sk", "i_brand_id"],
                            device=DEVICE)
    tables = {
        "read_parquet": pio.read_parquet(paths["fact"], columns=IO_FACT_COLUMNS,
                                         filters=IO_PRED, device=DEVICE),
        "scan Arrow decode": concatenate(list(pio.scan_parquet(
            paths["fact"], columns=IO_FACT_COLUMNS, filters=IO_PRED,
            device=DEVICE))),
        "scan device decode": concatenate(list(pio.scan_parquet(
            paths["fact"], columns=IO_FACT_COLUMNS, filters=IO_PRED,
            device_decode=True, device=DEVICE))),
    }
    for tag, t in tables.items():
        same_host_columns(host_columns(t), want_rows, f"(r1) {tag}")
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = plan_mod.run_plan(IO_PLAN, tables["scan device decode"], [item])
    torch.cuda.synchronize()
    launches = {k: kernels.KERNELS[k].launches for k in IO_KERNELS}
    groups = io_check_plan(rb, out, s, mask)
    log(f"(r1) pushdown: row groups {kept} of {n_groups} kept (the footer's "
        f"statistics); {int(mask.sum())} rows from read_parquet and both scans "
        f"equal numpy's; join -> groupby -> to_rows: {groups} groups exact "
        f"against numpy; launches {launches}")
    res["r1"] = {"kept": kept, "rows": int(mask.sum()), "groups": groups,
                 "launches": launches}
    del tables, out
    # (r2) the stream; the fallback lists of its device decodes recorded
    ipf = pq.ParquetFile(paths["item"])
    item_fb = pdev.decode_row_group(paths["item"], ipf, 0, ipf.schema_arrow.names,
                                    DEVICE)[1]
    fb, decode_row_group = {}, pdev.decode_row_group

    def recorded(path, pf_, rg, columns, device):
        out = decode_row_group(path, pf_, rg, columns, device)
        fb.setdefault(rg, out[1])
        return out

    bounds = [(rg * IO_ROW_GROUP, (rg + 1) * IO_ROW_GROUP)
              for rg in range(n_groups)]

    def stream(dd: bool, prefetch: int) -> list:
        outs = []
        for batch in pio.scan_parquet(paths["fact"], columns=IO_FACT_COLUMNS,
                                      device_decode=dd, prefetch=prefetch,
                                      device=DEVICE):
            outs.append(plan_mod.run_plan(IO_PLAN, batch, [item]))
        torch.cuda.synchronize()
        return outs

    stream_res = {}
    for tag, dd, prefetch in IO_STREAM:
        walls = []
        for run in range(IO_STREAM_RUNS):
            torch.cuda.synchronize()
            kernels.reset_launches()
            pdev.decode_row_group = recorded if run == 0 else decode_row_group
            t0 = time.perf_counter()
            try:
                outs = stream(dd, prefetch)
            finally:
                pdev.decode_row_group = decode_row_group
            walls.append((time.perf_counter() - t0) * 1e3 / n_groups)
            if run:
                continue
            # the first stream's launches and results, read after its wall
            launches = {k: kernels.KERNELS[k].launches for k in IO_KERNELS}
            if len(outs) != n_groups:
                raise AssertionError(f"(r2) {tag}: {len(outs)} batches")
            for (lo, hi), o in zip(bounds, outs):
                m = np.zeros(FACT_ROWS, np.bool_)
                m[lo:hi] = True
                io_check_plan(rb, o, s, m)
        del outs
        missing = [k for k in IO_KERNELS if launches[k] == 0]
        if missing:
            raise AssertionError(f"(r2) {tag} never launched {missing}")
        stream_res[tag] = {"wall_ms_per_batch": statistics.median(walls),
                           "walls": walls, "launches": launches}
        log(f"(r2) {tag}: {n_groups} batches exact against numpy; wall "
            f"{statistics.median(walls):.2f} ms a batch (median of "
            f"{IO_STREAM_RUNS} streams: {[round(w, 2) for w in walls]}); "
            f"launches a stream {launches}")
    if sorted(fb) != list(range(n_groups)) or any(fb.values()) or (
            item_fb != ["i_brand"]):
        raise AssertionError(f"(r2) fallback lists: fact {fb}, item {item_fb}")
    log(f"(r2) fallback lists: none for the fact file's {n_groups} row "
        f"groups, {item_fb} for item")
    host = [io_host_decode(pdev, paths["fact"], pf, rg, IO_FACT_COLUMNS)
            for rg in range(n_groups)]
    host_ms = statistics.median(h["host_ms"] for h in host)
    encoded = statistics.median(h["encoded"] for h in host)
    decoded = IO_ROW_GROUP * (4 * len(IO_FACT_COLUMNS) + 3)  # + 3 validity
    log(f"(r2) host half of the device decode (page headers, decompression, "
        f"run headers): {host_ms:.2f} ms a batch (median of {n_groups}); "
        f"uploaded still encoded {encoded} bytes a batch against "
        f"{decoded} bytes of decoded columns ({decoded / encoded:.2f}x)")

    def decode_one():
        pparquet._device_decode_batch(paths["fact"], pf, [0], IO_FACT_COLUMNS,
                                      None, torch.device(DEVICE))
        torch.cuda.synchronize()

    first = next(iter(pio.scan_parquet(paths["fact"], columns=IO_FACT_COLUMNS,
                                       device_decode=True, device=DEVICE)))

    def plan_one():
        plan_mod.run_plan(IO_PLAN, first, [item])
        torch.cuda.synchronize()

    prof = {}
    for tag, fn in (("decode", decode_one), ("plan", plan_one)):
        fn()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        prof[tag] = profile_plan(fn, statistics.median(walls),
                                 f"(r2) {tag} of one batch", runs=3)
    log(f"(r2) device time a batch: decode {prof['decode']['device_ms']:.3f} "
        f"ms, plan {prof['plan']['device_ms']:.3f} ms (profiler)")
    res["r2"] = {"stream": stream_res, "host_decode_ms": host_ms,
                 "encoded_bytes": encoded, "decoded_bytes": decoded,
                 "device_decode_ms": prof["decode"]["device_ms"],
                 "device_plan_ms": prof["plan"]["device_ms"],
                 "decode_profile": prof["decode"],
                 "plan_profile": prof["plan"]}
    res["r3"] = phase_io_formats(s, root)
    return res


def phase_io_formats(s: dict, root: str) -> dict:
    """(r3): the other formats against the Parquet read of the same rows."""
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq

    from spark_rapids_jni_tpu_torch import interop
    from spark_rapids_jni_tpu_torch import io as pio
    from spark_rapids_jni_tpu_torch.io import parquet as pparquet
    from spark_rapids_jni_tpu_torch.io import predicates as ppreds
    from spark_rapids_jni_tpu_torch.ops.copying import concatenate

    pads = {"i_brand": IO_BRAND_PAD}
    pins = {k: pa.int32() for k in IO_FACT_COLUMNS}
    pred = ppreds.from_dnf(IO_PRED)
    out = {}
    for n, formats in ((IO_OTHER_ROWS, ("orc", "csv", "json", "ipc")),
                       (IO_AVRO_ROWS, ("avro",))):
        atbl = io_fact_arrow(s, slice(None, None, FACT_ROWS // n), brand=True)
        ref_path = os.path.join(root, f"rows_{n}.parquet")
        pq.write_table(atbl, ref_path)
        want = host_columns(pio.read_parquet(ref_path, filters=IO_PRED,
                                             pad_widths=pads, device=DEVICE))
        t = interop.table_from_arrow(atbl, device=DEVICE)
        for fmt in formats:
            path = os.path.join(root, f"rows_{n}.{fmt}")
            t0 = time.perf_counter()
            getattr(pio, {"orc": "write_orc", "csv": "write_csv",
                          "json": "write_json", "ipc": "write_arrow_ipc",
                          "avro": "write_avro"}[fmt])(t, path)
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            reads = {
                "orc": lambda: {
                    "read_orc": pio.read_orc(path, filters=IO_PRED,
                                             pad_widths=pads, device=DEVICE),
                    "scan_orc": concatenate(list(pio.scan_orc(
                        path, filters=IO_PRED, pad_widths=pads, prefetch=2,
                        device=DEVICE)))},
                "csv": lambda: {
                    "read_csv": pio.read_csv(path, filters=IO_PRED, dtypes=pins,
                                             pad_widths=pads, device=DEVICE),
                    "scan_csv": concatenate(list(pio.scan_csv(
                        path, filters=IO_PRED, dtypes=pins, pad_widths=pads,
                        prefetch=2, device=DEVICE)))},
                "json": lambda: {
                    "read_json": pio.read_json(path, filters=IO_PRED,
                                               dtypes=pins, pad_widths=pads,
                                               device=DEVICE),
                    "scan_json": concatenate(list(pio.scan_json(
                        path, filters=IO_PRED, dtypes=pins, pad_widths=pads,
                        block_rows=1 << 18, prefetch=2, device=DEVICE)))},
                # the IPC reader takes no predicate: the residual the other
                # readers run, applied to its table
                "ipc": lambda: {"read_arrow_ipc": pparquet._apply_exact_filter(
                    pio.read_arrow_ipc(path, pad_widths=pads, device=DEVICE),
                    pred, None)},
                "avro": lambda: {"read_avro": pio.read_avro(
                    path, filters=IO_PRED, pad_widths=pads, device=DEVICE)},
            }[fmt]()
            read_s = time.perf_counter() - t0
            for tag, got in reads.items():
                same_host_columns(host_columns(got), want, f"(r3) {tag}")
            out[fmt] = {"rows": n, "write_s": write_s, "read_s": read_s,
                        "bytes": os.path.getsize(path)}
            log(f"(r3) {fmt}: {n} rows written in {write_s:.2f} s "
                f"({os.path.getsize(path)} bytes), read back with the "
                f"predicate in {read_s:.2f} s through {sorted(reads)}: equal "
                f"to the Parquet read byte for byte")
    return out


def encode_hybrid(values: np.ndarray, bw: int) -> bytes:
    """An RLE/bit-packed hybrid stream of ``values`` (parquet-format
    Encodings.md): a repeated run where 8 or more values repeat, else
    bit-packed groups of 8 (the tail zero-filled)."""
    out, i, n = bytearray(), 0, len(values)

    def varint(v):
        while True:
            b, v = v & 0x7F, v >> 7
            out.append(b | 0x80 if v else b)
            if not v:
                return

    while i < n:
        j = i
        while j < n and values[j] == values[i]:
            j += 1
        if j - i >= 8:
            varint((j - i) << 1)
            out.extend(int(values[i]).to_bytes((bw + 7) // 8, "little"))
            i = j
            continue
        k = min(n, i + 8 * 16)
        group = np.zeros(-(-(k - i) // 8) * 8, np.int64)
        group[:k - i] = values[i:k]
        bits = ((group[:, None] >> np.arange(bw)) & 1).astype(np.uint8)
        varint(((len(group) // 8) << 1) | 1)
        out.extend(np.packbits(bits.ravel(), bitorder="little").tobytes())
        i = k
    return bytes(out)


def phase_io_without_pyarrow(d: dict) -> dict:
    """(r) where pyarrow is absent: UNCOMPRESSED v1 pages encoded here with
    numpy (PLAIN values; a PLAIN dictionary with RLE/bit-packed indices;
    RLE definition levels) through ``_decode_data_page`` against numpy,
    ``_defined_count`` and ``parse_rle_runs``; then Avro's round trip."""
    import os
    import shutil
    import struct as _struct
    import tempfile

    from spark_rapids_jni_tpu_torch import Table
    from spark_rapids_jni_tpu_torch.io import avro as pavro
    from spark_rapids_jni_tpu_torch.io import parquet_device as pdev

    n = IO_ROW_GROUP
    dev = torch.device(DEVICE)
    out = {}
    for name, key, ok in (("ss_item_sk", "item_sk", None),
                          ("ss_quantity", "quantity", "quantity_ok")):
        vals = d[key][:n].astype(np.int32)
        valid = np.ones(n, np.bool_) if ok is None else d[ok][:n]
        dense = vals[valid]
        defs = b""
        if ok is not None:
            levels = encode_hybrid(valid.astype(np.int64), 1)
            defs = _struct.pack("<i", len(levels)) + levels
            runs = pdev.parse_rle_runs(levels, 1, n)
            if pdev._defined_count(runs, levels, n) != int(valid.sum()):
                raise AssertionError(f"(r) {name}: _defined_count")
        want = np.where(valid, vals, 0)
        plain = pdev._Page(pdev._PAGE_DATA, n, pdev._ENC_PLAIN, pdev._ENC_RLE,
                           defs + dense.tobytes())
        uniq, idx = np.unique(dense, return_inverse=True)
        bw = max(int(len(uniq) - 1).bit_length(), 1)
        indices = encode_hybrid(idx.astype(np.int64), bw)
        if not np.array_equal(pdev._device_expand_runs(
                pdev.parse_rle_runs(indices, bw, len(idx)),
                torch.frombuffer(bytearray(indices), dtype=torch.uint8).to(dev),
                bw, len(idx)).cpu().numpy(), idx):
            raise AssertionError(f"(r) {name}: RLE/bit-packed indices")
        dictionary = pdev._device_plain(
            torch.frombuffer(bytearray(uniq.tobytes()), dtype=torch.uint8).to(dev),
            1, len(uniq))
        keyed = pdev._Page(pdev._PAGE_DATA, n, pdev._ENC_RLE_DICT,
                           pdev._ENC_RLE, defs + bytes([bw]) + indices)
        for tag, page, dvals in (("PLAIN", plain, None),
                                 ("dictionary", keyed, dictionary)):
            got, defined = pdev._decode_data_page(page, 1, ok is not None,
                                                  dvals, dev)
            torch.cuda.synchronize()
            if not (np.array_equal(got.cpu().numpy(), want)
                    and np.array_equal(defined.cpu().numpy(), valid)):
                raise AssertionError(f"(r) {name} {tag} page != numpy")
        out[name] = {"rows": n, "dictionary": len(uniq), "bit_width": bw}
        log(f"(r) {name}: numpy-encoded PLAIN and dictionary pages ({n} rows, "
            f"{len(uniq)} dictionary values, bit width {bw}) decode on the "
            f"card equal to numpy")
    root = tempfile.mkdtemp(prefix="chip_smoke_io_")
    try:
        path = os.path.join(root, "rows.avro")
        rows = slice(None, IO_AVRO_ROWS)
        cols = {"ss_item_sk": d["item_sk"][rows].astype(np.int32),
                "ss_quantity": [int(q) if v else None for q, v in
                                zip(d["quantity"][rows], d["quantity_ok"][rows])]}
        t = Table.from_pydict(cols, device=DEVICE)
        pavro.write_avro(t, path, codec="deflate")
        back = pavro.read_avro(path, device=DEVICE)
        same_host_columns(host_columns(back), host_columns(t), "(r) avro")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"(r) avro: {IO_AVRO_ROWS} rows round-trip byte for byte; the "
        "Arrow-based readers were not run (no pyarrow)")
    out["avro_rows"] = IO_AVRO_ROWS
    return out


# ---------------------------------------------------------------------------
# (s) the distributed tier: the mesh exchange of one task's batch
# ---------------------------------------------------------------------------

MESH_SHARDS = 4  # logical shards on one card (every visible GPU where more)
SKEW_SHARDS = 8  # (s1)'s second run, where Zipf(1.3)'s top key passes 2x
MESH_PARTITIONS = 200  # the plan's partition op: spark.sql.shuffle.partitions
MESH_PLAN = [{"op": "filter", "mask": 4},
             {"op": "cast", "column": 3, "type_id": 4},
             {"op": "partition", "kind": "hash", "keys": [0],
              "num": MESH_PARTITIONS}]
MESH_FAULTS = "seed=5,collective:transient:1:1"  # one dead rung: 4 -> 2
MESH_COUNTERS = ("shuffle.exchanges", "shuffle.retries", "mesh.all_to_all",
                 "mesh.degraded", "shuffle.skew_splits", "plan.mesh_segments",
                 "plan.mesh_fallbacks")


def mesh_pool(n: int) -> list:
    """(s)'s mesh: every visible GPU, repeated in turn up to ``n`` shards
    where fewer are visible (one card carries logical shards)."""
    if torch.device(DEVICE).type != "cuda":
        return [torch.device(DEVICE)] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(max(n, count))]


def mesh_fact(d: dict):
    """(a)'s batch as columns with a row id: ss_item_sk, ss_customer_sk
    (nullable), ss_sold_date_sk, ss_quantity (INT32, nullable), keep
    (BOOL8), row."""
    from spark_rapids_jni_tpu_torch import dtype as dt
    from spark_rapids_jni_tpu_torch.column import Column, Table

    n = d["item_sk"].shape[0]
    cols = [Column.from_numpy(d["item_sk"], device=DEVICE),
            Column.from_numpy(d["customer_sk"], d["customer_ok"], device=DEVICE),
            Column.from_numpy(d["date_sk"], device=DEVICE),
            Column.from_numpy(d["quantity"], d["quantity_ok"], device=DEVICE),
            Column.from_numpy(d["keep"], dtype=dt.BOOL8, device=DEVICE),
            Column.from_numpy(np.arange(n, dtype=np.int64), device=DEVICE)]
    return Table(cols, ["ss_item_sk", "ss_customer_sk", "ss_sold_date_sk",
                        "ss_quantity", "keep", "row"])


def occupied_rows(parts, occ_or_counts):
    """The occupied rows of every shard in mesh order (a Sharded
    occupancy, or one group count a shard), each moved to ``DEVICE``."""
    from spark_rapids_jni_tpu_torch import dtype as dt
    from spark_rapids_jni_tpu_torch.column import Column
    from spark_rapids_jni_tpu_torch.ops.copying import slice_rows
    from spark_rapids_jni_tpu_torch.ops.filter import filter_table
    from spark_rapids_jni_tpu_torch.parallel.mesh import map_tensors

    if isinstance(occ_or_counts, torch.Tensor):
        counts = occ_or_counts.tolist()
        kept = [slice_rows(p, 0, int(g)) for p, g in zip(parts, counts)]
    else:
        kept = [filter_table(p, Column(o, dt.BOOL8, None))
                for p, o in zip(parts, occ_or_counts)]
    return [map_tensors(t, lambda x: x.to(DEVICE)) for t in kept]


def same_rows(got, want, key: str, what: str) -> None:
    """Two tables as multisets of rows with exact bytes: both sorted by
    ``key`` (stable), then every column's validity and its data where
    valid equal."""
    from spark_rapids_jni_tpu_torch.ops.sort import SortKey, sort_table

    if got.row_count != want.row_count or got.names != want.names:
        raise AssertionError(f"{what}: {got.row_count} rows {got.names} != "
                             f"{want.row_count} rows {want.names}")
    a = sort_table(got, [SortKey(key)])
    b = sort_table(want, [SortKey(key)])
    for name, ca, cb in zip(a.names, a.columns, b.columns):
        va = (torch.ones(ca.row_count, dtype=torch.bool, device=ca.data.device)
              if ca.validity is None else ca.validity)
        vb = (torch.ones(cb.row_count, dtype=torch.bool, device=cb.data.device)
              if cb.validity is None else cb.validity)
        if not torch.equal(va, vb) or not torch.equal(ca.data[va], cb.data[vb]):
            raise AssertionError(f"{what}: column {name} differs")


def same_tables(a, b, what: str) -> None:
    """Two tables with the same names, dtypes and buffers, byte for
    byte (a None validity equal only to None)."""
    if a.names != b.names or a.row_count != b.row_count:
        raise AssertionError(f"{what}: {a.row_count} rows {a.names} != "
                             f"{b.row_count} rows {b.names}")
    names = a.names or [f"c{i}" for i in range(a.num_columns)]
    for name, x, y in zip(names, a.columns, b.columns):
        for part in ("data", "validity", "lengths"):
            u, v = getattr(x, part), getattr(y, part)
            if (u is None) != (v is None) or (u is not None and (
                    u.dtype != v.dtype or not torch.equal(u, v))):
                raise AssertionError(f"{what}: column {name} {part} differs")


def check_placement(parts, key: str, size: int, what: str) -> None:
    """Every row of shard d has pmod(murmur3(key), size) == d (numpy's
    Murmur3, seed 42; a null key hashes to the seed)."""
    for d, p in enumerate(parts):
        c = p[key]
        vals = c.data.cpu().numpy().astype(np.int64)
        ok = None if c.validity is None else c.validity.cpu().numpy()
        h = murmur3_long_np(vals, ok, np.full(vals.shape[0], 42, np.uint32))
        pid = np.mod(h.view(np.int32).astype(np.int64), size)
        if (pid != d).any():
            raise AssertionError(f"{what}: {int((pid != d).sum())} rows of "
                                 f"shard {d} belong elsewhere")


def mesh_measure(tag: str, run, runs: int = 3) -> dict:
    """Wall (CUDA-synchronised, the median of ``runs`` after a warm-up),
    device time (profiler), bytes through the all-to-all, host syncs and
    the tier's counters of one call of ``run``."""
    from spark_rapids_jni_tpu_torch.utils import metrics

    def once():
        run()
        torch.cuda.synchronize()

    once()
    before = metrics.snapshot()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        once()
        walls.append((time.perf_counter() - t0) * 1e3)
    after = metrics.snapshot()
    moved = (after["bytes"].get("mesh.exchanged_bytes", 0)
             - before["bytes"].get("mesh.exchanged_bytes", 0)) // runs
    counters = {k: (after["counters"].get(k, 0)
                    - before["counters"].get(k, 0)) // runs
                for k in MESH_COUNTERS}
    dev_ms = device_window_ms(once, runs=1)
    syncs = count_syncs(once)
    wall = statistics.median(walls)
    out = {"wall_ms": wall, "walls_ms": walls, "device_ms": dev_ms,
           "exchanged_bytes": moved, "host_syncs": syncs,
           "counters": counters}
    log(f"(s) {tag}: wall {wall:.2f} ms (median of "
        f"{[round(w, 2) for w in walls]}), device "
        f"{dev_ms:.3f} ms, {moved} bytes through the all-to-all, {syncs} "
        f"host syncs, counters {counters}")
    return out


def phase_mesh(kernels, d: dict, dd: dict) -> dict:
    """(s): the distributed tier on one card over (a)'s 2^23-row batch as
    columns and SF100 item: a mesh of every visible GPU, or 4 logical
    shards of one. (s1) distributed_groupby SUM/COUNT/MIN/MAX(quantity)
    by ss_item_sk (Zipf(1.3): on 4 shards the hottest destination is
    about 1.75x the mean and the skew split stays off; on 8 about 2.8x
    and it engages, with the bytes of SKEW_SPLIT=0); (s2) the shuffle and
    broadcast inner joins with item; (s3) semi and anti joins with (i1)'s
    category items; (s4) distinct ss_customer_sk; (s5) distributed_sort by
    ss_item_sk with 3 payloads; each against the port's single-device op
    as a multiset of rows with exact bytes, the hash-exchanged ones also
    each row on shard pmod(murmur3(key), P). (s6) run_plan over (h)'s
    [filter, cast] and a hash partition 200 on a MeshRunner, byte for
    byte the single-device run_plan, then again under a seeded collective
    fault that degrades the mesh to 2, and ``run_plan_mesh_stream`` of
    the batch's two halves at PIPELINE 2. (s7) dryrun_multichip(4). K5's
    launches are counted over (s1)-(s6) (before the stream), the kernels'
    over (s7) apart. Each operator, and the
    single-device op it was held against, is timed once more."""
    from spark_rapids_jni_tpu_torch import dtype as dt
    from spark_rapids_jni_tpu_torch import graft_entry, parallel
    from spark_rapids_jni_tpu_torch import plan as plan_mod
    from spark_rapids_jni_tpu_torch.column import Column, Table
    from spark_rapids_jni_tpu_torch.kernels import hashing as kh
    from spark_rapids_jni_tpu_torch.ops import join as join_mod
    from spark_rapids_jni_tpu_torch.ops.copying import concatenate
    from spark_rapids_jni_tpu_torch.ops.groupby import (
        GroupbyAgg, groupby_aggregate,
    )
    from spark_rapids_jni_tpu_torch.ops.sort import SortKey, sort_table
    from spark_rapids_jni_tpu_torch.utils import buckets, config, metrics

    pool = mesh_pool(MESH_SHARDS)
    size = len(pool)
    gpus = len({p for p in pool if p.type == "cuda"})
    log(f"(s) mesh: {size} shards on {gpus} GPU(s) "
        f"({[str(p) for p in pool]})")
    mesh = parallel.make_mesh(size, devices=pool)
    fact = mesh_fact(d)
    item = Table([Column.from_numpy(d["i_item_sk"], device=DEVICE),
                  Column.from_numpy(d["i_brand_id"], device=DEVICE),
                  Column.from_numpy(d["i_category_id"], device=DEVICE)],
                 ["ss_item_sk", "i_brand_id", "i_category_id"])
    cat = dd["items"]
    pad = -(-cat.shape[0] // SKEW_SHARDS) * SKEW_SHARDS - cat.shape[0]
    # padded with a key no fact row carries, to a multiple of the shards
    cat_t = Table([Column.from_numpy(
        np.concatenate([cat, np.full(pad, -1, np.int64)]), device=DEVICE)],
        ["ss_item_sk"])
    aggs = [GroupbyAgg("ss_quantity", a) for a in ("sum", "count", "min",
                                                    "max")]
    key = "ss_item_sk"
    res = {"shards": size, "gpus": gpus}
    config.set_flag("METRICS", "1")
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        outs = {
            "groupby": parallel.distributed_groupby(fact, [key], aggs, mesh),
            "inner_join": parallel.distributed_inner_join(fact, item, [key],
                                                          mesh),
            "broadcast_join": parallel.broadcast_inner_join(fact, item, [key],
                                                            mesh),
            "semi_join": parallel.distributed_semi_join(fact, cat_t, [key],
                                                        mesh),
            "anti_join": parallel.distributed_anti_join(fact, cat_t, [key],
                                                        mesh),
            "distinct": parallel.distributed_distinct(
                fact, ["ss_customer_sk"], mesh),
            "sort": parallel.distributed_sort(
                Table(fact.columns[:4], fact.names[:4]), [key], mesh),
        }
        runner = parallel.MeshRunner(size, devices=pool)
        plan_out = plan_mod.run_plan(MESH_PLAN, fact, mesh_runner=runner)
        torch.cuda.synchronize()
        launches = {k: v.launches for k, v in kernels.KERNELS.items()}
        res["drive_s"] = time.perf_counter() - t0
        log(f"(s) main path: {res['drive_s']:.1f} s, launches {launches}")
        if launches[kh.MURMUR3.name] == 0:
            raise AssertionError("(s) never launched K5 (murmur3_table_fused)")
        res["launches"] = launches

        # (s1) groupby
        agg, ng, ov = outs["groupby"]
        if int(ov.max()) > 0:
            raise AssertionError("(s1) groupby overflowed")
        parts = occupied_rows(agg, ng)
        check_placement(parts, key, size, "(s1) groupby")
        same_rows(concatenate(parts), groupby_aggregate(fact, [key], aggs),
                  key, "(s1) groupby")
        res["groupby_groups"] = int(ng.sum())
        skew = parallel.plan_skew(parallel.partition_counts(
            parallel.shard_table(fact, mesh), [key], mesh))
        res["groupby_skew"] = skew.to_doc()
        if skew.engaged:
            raise AssertionError(f"(s1) the split engaged on {size} shards: "
                                 f"{skew.to_doc()}")
        pool8 = mesh_pool(SKEW_SHARDS)
        mesh8 = parallel.make_mesh(len(pool8), devices=pool8)
        splits = metrics.snapshot()["counters"].get("shuffle.skew_splits", 0)
        agg8, ng8, ov8 = parallel.distributed_groupby(fact, [key], aggs, mesh8)
        split_n = (metrics.snapshot()["counters"].get("shuffle.skew_splits", 0)
                   - splits)
        gauges = {k: v["value"] for k, v in metrics.snapshot()["gauges"].items()
                  if k.startswith("shuffle.skew")}
        config.set_flag("SKEW_SPLIT", "0")
        agg0, ng0, _ = parallel.distributed_groupby(fact, [key], aggs, mesh8)
        config.clear_flag("SKEW_SPLIT")
        if split_n < 1:
            raise AssertionError("(s1) the split did not engage on 8 shards")
        if not torch.equal(ng8, ng0):
            raise AssertionError("(s1) split group counts differ")
        for a, b in zip(occupied_rows(agg8, ng8), occupied_rows(agg0, ng0)):
            same_tables(a, b, "(s1) split against SKEW_SPLIT=0")
        res["skew8"] = {"splits": split_n, "gauges": gauges}
        log(f"(s1) groupby: {res['groupby_groups']} groups exact on "
            f"{size} shards (split off: {skew.to_doc()}); on "
            f"{len(pool8)} shards the split engaged ({split_n} hot "
            f"destinations), the bytes of SKEW_SPLIT=0; gauges {gauges}")

        # (s2) joins with item
        want = join_mod.inner_join(fact, item, [key])
        out, cnt, lov, rov = outs["inner_join"]
        parts = occupied_rows(out, cnt)
        check_placement(parts, key, size, "(s2) inner join")
        same_rows(concatenate(parts), want, "row", "(s2) inner join")
        bout, bcnt = outs["broadcast_join"]
        same_rows(concatenate(occupied_rows(bout, bcnt)), want, "row",
                  "(s2) broadcast join")
        res["join_rows"] = want.row_count

        # (s3) semi / anti with the category items
        for name, fn in (("semi_join", join_mod.semi_join),
                         ("anti_join", join_mod.anti_join)):
            ls, occ, _, _ = outs[name]
            parts = occupied_rows(ls, occ)
            check_placement(parts, key, size, f"(s3) {name}")
            want_t = fn(fact, cat_t, [key])
            same_rows(concatenate(parts), want_t, "row", f"(s3) {name}")
            res[name + "_rows"] = want_t.row_count

        # (s4) distinct customers
        dk, dcnt, _ = outs["distinct"]
        parts = occupied_rows(dk, dcnt)
        check_placement(parts, "ss_customer_sk", size, "(s4) distinct")
        same_rows(concatenate(parts),
                  groupby_aggregate(fact, ["ss_customer_sk"], []),
                  "ss_customer_sk", "(s4) distinct")
        res["distinct_rows"] = int(dcnt.sum())

        # (s5) sort: the occupied rows in mesh order are the stable sort
        sout, socc, _ = outs["sort"]
        got = concatenate(occupied_rows(sout, socc))
        want_s = sort_table(Table(fact.columns[:4], fact.names[:4]),
                            [SortKey(key)])
        k = got[key].data
        if not bool((k[1:] >= k[:-1]).all()):
            raise AssertionError("(s5) distributed sort out of order")
        same_tables(got, want_s, "(s5) sort")

        # (s6) the plan on the mesh, then under a fault that degrades it
        want_p = buckets.unpad_table(plan_mod.run_plan(MESH_PLAN, fact))
        same_tables(plan_out, want_p, "(s6) mesh plan")
        config.set_flag("RETRY_MAX", "0")
        config.set_flag("FAULTS", MESH_FAULTS)
        degraded = metrics.snapshot()["counters"].get("mesh.degraded", 0)
        runner2 = parallel.MeshRunner(size, devices=pool)
        got_p = plan_mod.run_plan(MESH_PLAN, fact, mesh_runner=runner2)
        config.clear_flag("FAULTS")
        config.clear_flag("RETRY_MAX")
        same_tables(got_p, want_p, "(s6) degraded mesh plan")
        doc = runner2.to_doc()
        if (metrics.snapshot()["counters"].get("mesh.degraded", 0) - degraded
                < 1 or doc["devices"] != max(size // 2, 1)):
            raise AssertionError(f"(s6) the mesh did not degrade: {doc}")
        res["plan"] = {"rows": want_p.row_count, "degraded": doc}
        # the stream of two halves, the next half's pack and counts pass
        # staged on a pipeline worker while this one's exchange runs
        half = fact.row_count // 2
        halves = [Table([Column(c.data[a:b], c.dtype,
                                None if c.validity is None
                                else c.validity[a:b]) for c in fact.columns],
                        fact.names) for a, b in ((0, half),
                                                 (half, fact.row_count))]
        config.set_flag("PIPELINE", "2")
        streamed = parallel.run_plan_mesh_stream(MESH_PLAN, halves, runner)
        config.clear_flag("PIPELINE")
        for i, (got_h, h) in enumerate(zip(streamed, halves)):
            same_tables(got_h, buckets.unpad_table(
                plan_mod.run_plan(MESH_PLAN, h)), f"(s6) stream batch {i}")
        log(f"(s) every operator exact against the single-device ops: "
            f"{res['join_rows']} join rows, {res['semi_join_rows']} semi and "
            f"{res['anti_join_rows']} anti rows, {res['distinct_rows']} "
            f"distinct customers, {got.row_count} sorted rows, the plan's "
            f"{want_p.row_count} rows on {size} shards and after {doc}")

        # measurements: one call of each operator
        res["measure"] = {
            "groupby": mesh_measure("groupby", lambda: parallel.distributed_groupby(
                fact, [key], aggs, mesh)),
            "groupby_split8": mesh_measure(
                "groupby on 8 (split)", lambda: parallel.distributed_groupby(
                    fact, [key], aggs, mesh8)),
            "inner_join": mesh_measure(
                "inner join", lambda: parallel.distributed_inner_join(
                    fact, item, [key], mesh)),
            "broadcast_join": mesh_measure(
                "broadcast join", lambda: parallel.broadcast_inner_join(
                    fact, item, [key], mesh)),
            "semi_join": mesh_measure(
                "semi join", lambda: parallel.distributed_semi_join(
                    fact, cat_t, [key], mesh)),
            "distinct": mesh_measure(
                "distinct", lambda: parallel.distributed_distinct(
                    fact, ["ss_customer_sk"], mesh)),
            "sort": mesh_measure("sort", lambda: parallel.distributed_sort(
                Table(fact.columns[:4], fact.names[:4]), [key], mesh)),
            "plan": mesh_measure("plan", lambda: plan_mod.run_plan(
                MESH_PLAN, fact, mesh_runner=runner)),
            "plan_single": mesh_measure("plan, one device", lambda: (
                plan_mod.run_plan(MESH_PLAN, fact))),
        }
        # the single-device ops the mesh's results were held against
        one = Table(fact.columns[:4], fact.names[:4])
        for name, fn in (
                ("groupby", lambda: groupby_aggregate(fact, [key], aggs)),
                ("inner_join", lambda: join_mod.inner_join(fact, item, [key])),
                ("semi_join", lambda: join_mod.semi_join(fact, cat_t, [key])),
                ("distinct", lambda: groupby_aggregate(
                    fact, ["ss_customer_sk"], [])),
                ("sort", lambda: sort_table(one, [SortKey(key)]))):
            res["measure"][name + "_single"] = mesh_measure(
                f"{name}, one device", fn)
    finally:
        for name in ("METRICS", "FAULTS", "RETRY_MAX", "SKEW_SPLIT",
                     "PIPELINE"):
            config.clear_flag(name)

    # (s7) the dry run, its TPC-DS q5 step included
    import contextlib
    import io

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        graft_entry.dryrun_multichip(MESH_SHARDS, device=DEVICE)
    torch.cuda.synchronize()
    res["dryrun_s"] = time.perf_counter() - t0
    res["dryrun_launches"] = {k: v.launches
                              for k, v in kernels.KERNELS.items()}
    said = said.getvalue().strip()
    if not re.search(r"tpcds q5 cats=\d+ ok", said):
        raise AssertionError(f"(s7) the dry run's q5 step said {said!r}")
    log(f"(s7) {said}")
    log(f"(s7) dryrun_multichip({MESH_SHARDS}): {res['dryrun_s']:.1f} s, "
        f"launches {res['dryrun_launches']}")
    res["k5_shard_rows"] = fact.row_count // size
    return res


def mesh_kernel_records(d: dict, qs: dict) -> list:
    """K5 at (s)'s shape: one shard's ss_item_sk keys, as every hash
    exchange of (s) hashes them, with (s)'s launches."""
    from spark_rapids_jni_tpu_torch import dtype as dt
    from spark_rapids_jni_tpu_torch.column import Column
    from spark_rapids_jni_tpu_torch.kernels import hashing as kh

    n = qs["k5_shard_rows"]
    keys = [Column(torch.from_numpy(d["item_sk"][:n]).to(DEVICE), dt.INT64)]
    return [kernel_record(
        kh.MURMUR3, "mesh", f"{n} rows x 1 INT64 key (one of {qs['shards']} "
        "shards)", qs["launches"][kh.MURMUR3.name],
        lambda: [kh.murmur3_columns(keys)], lambda: [kh.murmur3_plain(keys)],
        n * (8 + 4), n * (2 * 11 + 10),
        note=f"(s): {qs['shards']} shards on {qs['gpus']} GPU(s)")]


# ---------------------------------------------------------------------------
# (t) the observability tier: every plane on, against every plane off
# ---------------------------------------------------------------------------

TELEMETRY_FLAGS = ("TRACE", "FLIGHT", "PROFILE", "PLANSTATS", "LOCKCHECK",
                   "REFCOUNT_DEBUG")
TELEMETRY_COUNTERS = (
    "kernel.launches", "kernel.declines", "plan.calls", "plan.segments",
    "plan.fused_segments", "plan.fused_ops", "plan.exact_ops",
    "plan.fallbacks", "plan.declined", "plan.chunked_segments",
    "plan.oom_spill_retries")
TELEMETRY_PAIRS = 5  # alternating off/on calls of (h) for the wall and device
TELEMETRY_STATS_CALLS = 5  # calls whose stats records the drift report reads
TELEMETRY_STREAM = 4  # (m1)'s batches the lockcheck stream takes, at depth 2
TELEMETRY_CHILD_ROWS = 1 << 16  # the dump child's batch: a prefix of (a)'s


def telemetry_dump_child(in_path: str) -> int:
    """The body of (t)'s dump child (``--telemetry-dump-child IN``): with
    ``FLIGHT_DUMP``, ``PROFILE_DUMP`` and ``METRICS_DUMP`` (and
    ``LOCKCHECK``) in its environment it runs (h)'s plan over the pickled
    wire batch on the card and keeps one resident table, so that the
    dumps written at its exit carry a profile session, a lock report and
    a leak."""
    import pickle

    from spark_rapids_jni_tpu_torch import runtime_bridge as rb
    from spark_rapids_jni_tpu_torch.utils import metrics

    with open(in_path, "rb") as f:
        wire = pickle.load(f)
    rb.table_plan_wire(json.dumps(WIRE_PLAN), *wire, device=DEVICE)
    with metrics.span("t.child_keep"):
        rb.table_upload_wire(*wire, device=DEVICE)  # left for the report
    torch.cuda.synchronize()
    return 0


def _telemetry(on: bool, stats_dir: str) -> None:
    from spark_rapids_jni_tpu_torch.utils import config

    for flag in TELEMETRY_FLAGS:
        if on:
            config.set_flag(flag, "on")
        else:
            config.clear_flag(flag)
    if on:
        config.set_flag("PLANSTATS_DIR", stats_dir)
    else:
        config.clear_flag("PLANSTATS_DIR")


def chrome_kernels_in(trace: dict, name: str) -> tuple:
    """(ranges named ``name``, CUDA kernel events whose start lies in one
    of them) of a ``torch.profiler`` Chrome trace: the host range and its
    annotation on the device's timeline both count as a window."""
    wins = [(e["ts"], e["ts"] + e.get("dur", 0))
            for e in trace.get("traceEvents", [])
            if e.get("name") == name and e.get("ph") == "X"]
    kernels = [e for e in trace.get("traceEvents", [])
               if e.get("cat") == "kernel" and e.get("ph") == "X"]
    inside = [e for e in kernels if any(a <= e["ts"] <= b for a, b in wins)]
    return len(wins), len(inside)


def phase_telemetry(rb, kernels, d: dict, ctx: dict) -> dict:
    """(t): (h)'s plan through ``table_plan_wire`` over (a)'s 2^23-row
    batch with TRACE, FLIGHT, PROFILE, PLANSTATS, LOCKCHECK and
    REFCOUNT_DEBUG all on, against the same call with all of them off.
    Gates: equal bytes, equal ``kernel.*``/``plan.*`` counters and
    launches, one host sync in the fused segment, the profile session's
    segments equal to ``plancheck.predict_segments`` with splits summing
    to each wall, a stats file after five calls with no segmentation
    drift, a Chrome trace whose ``plan`` range holds kernels, every span
    in ``metrics.snapshot()``, the flight ring's ``plan``/``plan.segment``
    pairs under one trace id, (m1)'s stream at depth 2 over 4 batches
    with LOCKCHECK and FLIGHT on (equal bytes, no cycle or inversion), an
    empty leak report and a kept table in it, and a child's dumps at
    exit. Printed: (h)'s wall and device time off and on, median of 5
    alternating pairs."""
    import pickle
    import shutil
    import tempfile

    from spark_rapids_jni_tpu_torch import plan as plan_mod
    from spark_rapids_jni_tpu_torch import plancheck
    from spark_rapids_jni_tpu_torch.utils import (
        config, flight, lockcheck, metrics, planstats, profiler, tracing,
    )

    plan = json.dumps(WIRE_PLAN)
    wire = d["fact_wire"]
    tmp = tempfile.mkdtemp(prefix="srt-telemetry-")
    stats_dir = os.path.join(tmp, "stats")
    # the dump child runs beside the gates below and is waited for
    # before the timed pairs
    small = prefix_wire(d, min(TELEMETRY_CHILD_ROWS, d["rows"].shape[0]))
    paths = {k: os.path.join(tmp, f"{k}.json")
             for k in ("flight", "profile", "metrics")}
    inp = os.path.join(tmp, "child_in.pkl")
    with open(inp, "wb") as f:
        pickle.dump(small, f)
    env = dict(os.environ, SPARK_RAPIDS_TPU_FLIGHT_DUMP=paths["flight"],
               SPARK_RAPIDS_TPU_PROFILE_DUMP=paths["profile"],
               SPARK_RAPIDS_TPU_METRICS_DUMP=paths["metrics"],
               SPARK_RAPIDS_TPU_LOCKCHECK="1")
    t_child = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--telemetry-dump-child",
         inp], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)

    def call():
        res = rb.table_plan_wire(plan, *wire, device=DEVICE)
        torch.cuda.synchronize()
        return res

    real, syncs = plan_mod._run_fused, []

    def counted(seg_ops, table):
        box = {}
        syncs.append(sync_sites(
            lambda: box.setdefault("out", real(seg_ops, table))))
        return box["out"]

    def measured(on: bool):
        _telemetry(on, stats_dir)
        metrics.reset()
        kernels.reset_launches()
        syncs.clear()
        plan_mod._run_fused = counted
        try:
            res = call()
        finally:
            plan_mod._run_fused = real
        return (res, metrics.counter_values(list(TELEMETRY_COUNTERS)),
                {k: v.launches for k, v in kernels.KERNELS.items()},
                list(syncs))

    res = {}
    try:
        config.set_flag("METRICS", True)
        for mod in (flight, profiler, planstats, lockcheck):
            mod.reset()
        off = measured(False)
        trace = tracing.new_context()
        with tracing.activate(trace):
            on = measured(True)
        if tuple(on[0]) != tuple(off[0]):
            raise AssertionError("(t) telemetry on changed the output bytes")
        if on[1] != off[1] or on[2] != off[2]:
            raise AssertionError(f"(t) counters or launches differ: on "
                                 f"{on[1]} {on[2]}, off {off[1]} {off[2]}")
        if [len(x) for x in on[3]] != [1] or [len(x) for x in off[3]] != [1]:
            raise AssertionError(f"(t) fused segment host syncs: on {on[3]}, "
                                 f"off {off[3]}")
        missing = [k for k in WIRE_KERNELS if on[2][k] == 0]
        if missing:
            raise AssertionError(f"(t) never launched {missing}")
        # the profile session against the static prediction
        sess = profiler.sessions()[-1]
        segs = [(s["index"], s["kind"], s["ops"]) for s in sess["segments"]]
        want = [(i, kind, [WIRE_PLAN[j]["op"] for j in idx]) for i, (kind, idx)
                in enumerate(plancheck.predict_segments(WIRE_PLAN))]
        if segs != want:
            raise AssertionError(f"(t) profile segments {segs} != {want}")
        for sg in sess["segments"]:
            parts = (sg["execute_s"] + sg["compile_s"] + sg["serde_s"]
                     + sg["stall_s"])
            if abs(parts - sg["wall_s"]) > 1e-9 * max(1.0, sg["wall_s"]):
                raise AssertionError(f"(t) segment {sg['index']}'s splits "
                                     f"{parts} != its wall {sg['wall_s']}")
        # the flight ring: the plan's span pairs under one trace id
        evs = tracing.assign_trace_ids(flight.tail_records())
        pairs = {nm: [e["ph"] for e in evs if e["name"] == nm]
                 for nm in ("plan", "plan/plan.segment")}
        ids = {e.get("trace_id") for e in evs
               if e["name"] in pairs and e["ph"] in "BE"}
        if (pairs["plan"] != ["B", "E"]
                or pairs["plan/plan.segment"] != ["B", "E"] * len(segs)
                or ids != {trace.trace_id}):
            raise AssertionError(f"(t) flight span pairs {pairs}, trace ids "
                                 f"{ids} (want {trace.trace_id})")
        # every span of the plan in the metrics snapshot (compile.jit is
        # the trace layer's own span, not a metrics one)
        spans = {e["name"].rsplit("/", 1)[-1] for e in evs
                 if e["ph"] == "B"} - {"compile.jit"}
        absent = sorted(spans - set(metrics.snapshot()["timers"]))
        if absent or not {"plan", "plan.segment"} <= spans:
            raise AssertionError(f"(t) spans missing from the snapshot: "
                                 f"{absent} (of {sorted(spans)})")
        # five calls' stats records and their drift report
        for _ in range(TELEMETRY_STATS_CALLS - 1):
            call()
        report = planstats.drift_report(path=stats_dir)
        findings = [f for g in report["groups"] for f in g["findings"]]
        if report["records"] != TELEMETRY_STATS_CALLS or any(
                f["type"] == "segmentation" for f in findings):
            raise AssertionError(f"(t) stats: {report['records']} records, "
                                 f"findings {findings}")
        # a Chrome trace of one call: its plan range holds kernels
        cap = os.path.join(tmp, "trace")
        with tracing.capture_trace(cap):
            call()
        files = [os.path.join(cap, f) for f in os.listdir(cap)]
        if len(files) != 1:
            raise AssertionError(f"(t) capture_trace left {files}")
        with open(files[0]) as f:
            chrome = json.load(f)
        windows, inside = chrome_kernels_in(chrome, "plan")
        if not windows or not inside:
            raise AssertionError(f"(t) Chrome trace: {windows} plan ranges, "
                                 f"{inside} kernels inside")
        log(f"(t) all telemetry on: equal bytes, counters {on[1]}, fused "
            f"segment syncs {on[3]}; segments {segs}; "
            f"{len(evs)} flight events, one trace id; "
            f"{report['records']} stats records, findings "
            f"{sorted({f['type'] for f in findings})}; Chrome trace "
            f"{os.path.getsize(files[0])} bytes, {inside} kernels in "
            f"{windows} plan ranges")
        res.update(counters=on[1], segment_syncs=on[3], segments=segs,
                   flight_events=len(evs), stats_records=report["records"],
                   drift_findings=sorted({f["type"] for f in findings}),
                   trace_kernels_in_plan=inside)
        # (m1)'s stream under LOCKCHECK and FLIGHT
        _telemetry(False, stats_dir)
        batches = ctx.get("batches") or [stream_batch(d, k) for k in
                                          range(TELEMETRY_STREAM)]
        ref = ctx.get("ref") or [tuple(rb.table_plan_wire(
            plan, *b, device=DEVICE)) for b in batches[:TELEMETRY_STREAM]]
        for flag, value in (("LOCKCHECK", "on"), ("FLIGHT", "on"),
                            ("PIPELINE", "2")):
            config.set_flag(flag, value)
        lockcheck.reset()
        got = rb.table_stream_wire(plan, batches[:TELEMETRY_STREAM],
                                   device=DEVICE)
        torch.cuda.synchronize()
        config.clear_flag("PIPELINE")
        if [tuple(g) for g in got] != ref[:TELEMETRY_STREAM]:
            raise AssertionError("(t) the stream under LOCKCHECK differs")
        lock = lockcheck.report()
        if lock["cycles"] or lock["order_violations"]:
            raise AssertionError(f"(t) lockcheck: cycles {lock['cycles']}, "
                                 f"inversions {lock['order_violations']}")
        held = [v for v in lock["held_across_blocking"]
                if v["kind"] == "device_dispatch"]
        log(f"(t) stream of {TELEMETRY_STREAM} at depth 2 with LOCKCHECK and "
            f"FLIGHT: equal bytes; {lock['acquisitions']} acquisitions, "
            f"{len(lock['edges'])} order edges, no cycle or inversion; "
            f"{len(held)} lock set(s) held across device_dispatch "
            f"{sorted({tuple(v['held']) for v in held})}")
        res.update(lock_acquisitions=lock["acquisitions"],
                   lock_edges=len(lock["edges"]),
                   held_across_dispatch=len(held))
        config.clear_flag("LOCKCHECK")
        config.clear_flag("FLIGHT")
        # the leak report: empty, then one kept table with its span stack
        if rb.leak_report():
            raise AssertionError(f"(t) leaks: {rb.leak_report()}")
        config.set_flag("REFCOUNT_DEBUG", "on")
        with metrics.span("t.keep"):
            kept = rb.table_upload_wire(*small, device=DEVICE)
        leaks = rb.leak_report()
        rb.table_free(kept)
        if ([(r["table_id"], r["allocated_under"]) for r in leaks]
                != [(kept, ["t.keep"])] or rb.leak_report()):
            raise AssertionError(f"(t) kept table's report: {leaks}")
        config.clear_flag("REFCOUNT_DEBUG")
        # the child's dumps at its exit
        _, child_err = child.communicate(timeout=300)
        if child.returncode != 0:
            raise AssertionError(f"(t) dump child exited {child.returncode}: "
                                 f"{child_err[-2000:]}")
        dumps = {}
        for k, path in paths.items():
            with open(path) as f:
                dumps[k] = json.load(f)
        sections = dumps["flight"].get("sections", {})
        sess_docs = profiler.extract_sessions(dumps["profile"])
        if (len(sections.get("resident_leaks") or []) != 1
                or not (sections.get("lockcheck") or {}).get("acquisitions")
                or len(sections.get("profile_sessions") or []) != 1
                or len(sess_docs) != 1
                or dumps["metrics"]["counters"].get("plan.calls") != 1):
            raise AssertionError(f"(t) child dumps: sections "
                                 f"{sorted(sections)}, sessions "
                                 f"{len(sess_docs)}, metrics counters "
                                 f"{dumps['metrics'].get('counters')}")
        log(f"(t) dump child: done {time.perf_counter() - t_child:.1f} s "
            f"after its start; flight dump "
            f"sections {sorted(sections)}, leak "
            f"{sections['resident_leaks'][0]['allocated_under']}, profile "
            f"session {sess_docs[0]['label']}, metrics plan.calls 1; "
            f"stderr tail: {child_err.strip().splitlines()[-1:]}")
        # (h)'s wall and device time, off against on, alternating
        walls = {"off": [], "on": []}
        device = {"off": [], "on": []}
        for _ in range(TELEMETRY_PAIRS):
            for mode in ("off", "on"):
                _telemetry(mode == "on", stats_dir)
                t0 = time.perf_counter()
                call()
                walls[mode].append((time.perf_counter() - t0) * 1e3)
                device[mode].append(device_window_ms(call, runs=1))
        med = {m: (statistics.median(walls[m]), statistics.median(device[m]))
               for m in walls}
        smi = nvidia_smi_line()
        log(f"(t) (h) wall / device ms, median of {TELEMETRY_PAIRS} "
            f"alternating pairs: off {med['off'][0]:.2f} / "
            f"{med['off'][1]:.3f}, on {med['on'][0]:.2f} / "
            f"{med['on'][1]:.3f} (walls off "
            f"{[round(x, 2) for x in walls['off']]}, on "
            f"{[round(x, 2) for x in walls['on']]}); {smi}")
        res.update(wall_ms=walls, device_ms=device,
                   median={m: {"wall_ms": v[0], "device_ms": v[1]}
                           for m, v in med.items()}, card=smi)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
        plan_mod._run_fused = real
        _telemetry(False, stats_dir)
        for flag in ("METRICS", "PIPELINE", "LOCKCHECK", "FLIGHT",
                     "REFCOUNT_DEBUG"):
            config.clear_flag(flag)
        for mod in (flight, profiler, planstats, lockcheck):
            mod.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# (u) the serving tier and (v) the native shim
# ---------------------------------------------------------------------------

SERVE_WORKERS = 2  # spark.rapids.sql.concurrentGpuTasks=2
SERVE_SESSIONS = 4  # spark.executor.cores=4: four tasks, one session each
SERVE_STREAM_BATCHES = 2  # (m1)'s batches each session streams
SERVE_SMALL_FRACTION = 0.005  # (u2): a session budget below one (a) batch
SERVE_SMALL_ROWS = 1 << 16  # (u2): a batch that fits that budget
SERVE_WAIT_S = 180.0  # the longest (u) waits for a child or a teardown
UPSTREAM_PLAN = PLAN[:2]  # (u3): the donating plan before the crash
DOWNSTREAM_PLAN = PLAN[2:]  # (u3): the rest of (a)'s plan after it
NATIVE_PLAN = [FROM_FACT_ROWS, {"op": "filter", "mask": 4},
               {"op": "to_rows"}]
NATIVE_KERNELS = ("unpack_rows", "pack_rows")
NATIVE_RUNS = 3
ROOT_DIR = os.path.dirname(os.path.abspath(__file__))  # the shim's SRT_PYTHONPATH


def fact_columns_wire(d: dict):
    """(a)'s batch as a columnar wire table: ss_item_sk, ss_customer_sk
    (nullable), ss_sold_date_sk, ss_quantity (INT32, nullable), keep."""
    return ([4, 4, 4, 3, 11], [0] * 5,
            [d["item_sk"].tobytes(), d["customer_sk"].tobytes(),
             d["date_sk"].tobytes(), d["quantity"].tobytes(),
             d["keep"].astype(np.uint8).tobytes()],
            [None, d["customer_ok"].astype(np.uint8).tobytes(), None,
             d["quantity_ok"].astype(np.uint8).tobytes(), None],
            d["item_sk"].shape[0])


def same_wire(got, want, what: str) -> None:
    """Two wire 5-tuples must be equal byte for byte."""
    def norm(w):
        t, s, ds, vs, n = w
        return ([int(x) for x in t], [int(x) for x in s],
                [None if x is None else bytes(x) for x in ds],
                [None if x is None else bytes(x) for x in vs], int(n))

    if norm(got) != norm(want):
        raise AssertionError(f"{what}: the 5-tuples differ")


def serve_session(serving, port: int, name: str, d: dict, batches) -> dict:
    """One tenant's work through the daemon: (a)'s batch and item
    uploaded, (a)'s plan with donate, the result downloaded, the tables
    freed; then ``batches`` streamed with (h)'s plan."""
    t0 = time.perf_counter()
    with serving.Client(port, name=name, timeout=SERVE_WAIT_S) as c:
        fid = c.upload(d["fact_wire"])
        iid = c.upload(d["item_wire"])
        out = c.plan(PLAN, [fid, iid], donate=True)
        got_a = c.download(out)
        c.free(out)
        c.free(iid)
        got_h = c.stream(WIRE_PLAN, batches)
        doc = [s for s in c.stats()["sessions"] if s["session"] == c.session]
    return {"a": got_a, "h": got_h,
            "wall_ms": (time.perf_counter() - t0) * 1e3,
            "p95_wait_ms": doc[0]["queue_wait"]["p95_ms"]}


def run_sessions(serving, port: int, d: dict, batches, n: int) -> list:
    """``n`` client threads, one session each, all at once."""
    import threading

    out, errs = [None] * n, []

    def one(i):
        try:
            out[i] = serve_session(serving, port, f"u1-{n}-{i}", d, batches)
        except BaseException as e:  # raised again on the caller's thread
            errs.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out


def phase_serving(rb, kernels, d: dict, ctx: dict) -> dict:
    """(u): the serving daemon on the card (the launch counts set to 0
    just before each part's first request and read just after it)."""
    from spark_rapids_jni_tpu_torch import serving

    if "batches" not in ctx:  # (m1) failed: make its first batches here
        ctx["batches"] = [stream_batch(d, k)
                          for k in range(SERVE_STREAM_BATCHES)]
        ctx["ref"] = [tuple(rb.table_plan_wire(json.dumps(WIRE_PLAN), *b,
                                               device=DEVICE))
                      for b in ctx["batches"]]
        ctx["want0"] = wire_plan_oracle(d, FACT_ROWS)
    batches = ctx["batches"][:SERVE_STREAM_BATCHES]
    ref_h = ctx["ref"][:SERVE_STREAM_BATCHES]
    for k, r in enumerate(ref_h):
        check_rows(r, stream_oracle(ctx["want0"], k))
    start = rb.resident_table_count()
    # the in-process bridge's answer to (a)'s plan with donate, on the card
    fid = rb.table_upload_wire(*d["fact_wire"], device=DEVICE)
    iid = rb.table_upload_wire(*d["item_wire"], device=DEVICE)
    oid = rb.table_plan_resident(json.dumps(PLAN), [fid, iid], True)
    ref_a = tuple(rb.table_download_wire(oid))
    rb.table_free(oid)
    rb.table_free(iid)
    out = {"groups": check_query_result(ref_a, query_oracle(d))}
    out["u1"] = serving_u1(kernels, serving, d, batches, ref_h, ref_a)
    out["u2"] = serving_u2(rb, serving, d)
    out["u3"] = serving_u3(rb, serving, d)
    out["u4"] = serving_u4(rb, kernels, serving, d)
    if rb.resident_table_count() != start:
        raise AssertionError(f"(u) left {rb.resident_table_count() - start} "
                             "resident tables behind")
    return out


def serving_u1(kernels, serving, d: dict, batches, ref_h, ref_a) -> dict:
    """(u1): one session alone, then four at once, each uploading (a)'s
    batch and item, running (a)'s plan with donate, downloading and
    freeing, then streaming two of (m1)'s batches with (h)'s plan, at
    PIPELINE 2; every result equal to the in-process bridge's bytes."""
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_jni_tpu_torch.utils import config

    config.set_flag("PIPELINE", "2")
    try:
        with serving.serve(device=DEVICE, port=0, workers=SERVE_WORKERS,
                           max_sessions=SERVE_SESSIONS) as srv:
            torch.cuda.synchronize()
            kernels.reset_launches()
            one = run_sessions(serving, srv.port, d, batches, 1)
            # the four at once under a trace of CUDA activity only (no
            # CPU events recorded), its wall taken as the run's
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                four = run_sessions(serving, srv.port, d, batches,
                                    SERVE_SESSIONS)
                torch.cuda.synchronize()
                wall4 = (time.perf_counter() - t0) * 1e3
            launches = stream_launches(kernels)
            device_ms = sum(e.self_device_time_total
                            for e in device_events(prof)) / 1e3
            for r in one + four:
                same_wire(r["a"], ref_a, "(u1) (a)'s plan through the daemon")
                for k, got in enumerate(r["h"]):
                    same_wire(got, ref_h[k], f"(u1) stream batch {k}")
            live = srv.stats()["sessions_live"]
    finally:
        clear_service_flags()
    missing = [k for k in QUERY_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"(u1) never launched {missing}: {launches}")
    if live:
        raise AssertionError(f"(u1) {live} sessions still live after bye")
    rec = {"wall_ms_1": one[0]["wall_ms"],
           "wall_ms_4": [r["wall_ms"] for r in four], "run_ms_4": wall4,
           "p95_wait_ms_1": one[0]["p95_wait_ms"],
           "p95_wait_ms_4": [r["p95_wait_ms"] for r in four],
           "device_ms_4": device_ms, "busy_share_4": device_ms / wall4,
           "launches": {k: launches[k] for k in QUERY_KERNELS}}
    log(f"(u1) daemon on {DEVICE}, {SERVE_WORKERS} workers: every session's "
        f"(a) result and {SERVE_STREAM_BATCHES} (h) stream results equal the "
        f"in-process bridge's bytes and the numpy oracles; wall a session "
        f"{rec['wall_ms_1']:.1f} ms alone, "
        f"{[round(w, 1) for w in rec['wall_ms_4']]} ms at "
        f"{SERVE_SESSIONS} at once ({wall4:.1f} ms for the four); p95 queue "
        f"wait {rec['p95_wait_ms_1']} ms alone, {rec['p95_wait_ms_4']} ms at "
        f"{SERVE_SESSIONS}; device busy {device_ms:.1f} ms = "
        f"{100 * rec['busy_share_4']:.1f} % of the four sessions' wall; "
        f"launches {rec['launches']}")
    return rec


def serving_u2(rb, serving, d: dict) -> dict:
    """(u2): an over-budget upload, BUSY at queue depth 1 and a fifth
    hello past four sessions each get their typed error, and the daemon
    serves after each; a client killed with a stream in flight leaves
    the registry at its start count and the card's allocated memory
    falls back by its tables' bytes."""
    import threading

    from spark_rapids_jni_tpu_torch.serving import frames

    small = prefix_wire(d, SERVE_SMALL_ROWS)
    refused = {}
    with serving.serve(device=DEVICE, port=0, workers=SERVE_WORKERS,
                       max_sessions=SERVE_SESSIONS, queue_depth=1,
                       session_hbm_fraction=SERVE_SMALL_FRACTION) as srv:
        with serving.Client(srv.port, name="u2", timeout=SERVE_WAIT_S) as c:
            try:
                c.upload(d["fact_wire"])
                raise AssertionError("(u2) an over-budget upload was admitted")
            except serving.ServingOverBudget as e:
                refused["over_budget"] = e.type
            c.free(c.upload(small))
            sess = srv._sessions[c.session]
            gate = threading.Event()
            # every worker blocked and the queue full: the next request
            held = [srv.scheduler.submit(sess, gate.wait, cost=1, shed=False)
                    for _ in range(SERVE_WORKERS + 1)]
            try:
                c.stream(WIRE_PLAN, [small])
                raise AssertionError("(u2) a request past the queue depth ran")
            except serving.ServingBusy as e:
                refused["busy"] = e.type
            finally:
                gate.set()
                for t in held:
                    t.result()
            c.stream(WIRE_PLAN, [small])
        clients = [serving.Client(srv.port, name=f"u2-{i}").connect()
                   for i in range(SERVE_SESSIONS)]
        try:
            try:
                serving.Client(srv.port, name="u2-fifth").connect()
                raise AssertionError("(u2) a fifth session was admitted")
            except serving.ServingSessionLimit as e:
                refused["session_limit"] = e.type
        finally:
            for c in clients:
                c.close()
        with serving.Client(srv.port, name="u2-after") as c:
            c.stream(WIRE_PLAN, [small])
        count0 = rb.resident_table_count()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        c = serving.Client(srv.port, name="u2-killed",
                           timeout=SERVE_WAIT_S).connect()
        c.upload(d["item_wire"])
        c.upload(small)
        table_bytes = c.stats()["sessions"][0]["resident_bytes"]
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        metas, bufs = frames.batches_to_parts([small] * 4)
        frames.send_frame(c._sock, {"cmd": "stream", "plan": WIRE_PLAN,
                                    "batches": metas}, bufs)
        c.kill()  # gone with the stream in flight
        t0 = time.perf_counter()
        while (rb.resident_table_count() != count0
               or srv.stats()["sessions_live"]):
            if time.perf_counter() - t0 > SERVE_WAIT_S:
                raise AssertionError("(u2) the killed client's session was "
                                     "not torn down")
            time.sleep(0.01)
        torch.cuda.synchronize()
        mem2 = torch.cuda.memory_allocated()
    if mem1 - mem2 < table_bytes:
        raise AssertionError(f"(u2) allocated memory fell by {mem1 - mem2} "
                             f"bytes, the tables held {table_bytes}")
    if refused != {"over_budget": "over_budget", "busy": "busy",
                   "session_limit": "session_limit"}:
        raise AssertionError(f"(u2) refusals {refused}")
    log(f"(u2) typed refusals {sorted(refused)}, each followed by a served "
        f"request; a client killed with a stream in flight: registry back "
        f"to {count0}, allocated memory {mem0} -> {mem1} -> {mem2} bytes "
        f"(its tables held {table_bytes})")
    return {"refused": refused, "mem": [mem0, mem1, mem2],
            "table_bytes": table_bytes}


def start_serve_child(tmp: str, env: dict):
    """A durable daemon in a child process (``--serve-child DIR``) and
    the JSON it prints once its listener is open."""
    import select

    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--serve-child", tmp],
        env=env, stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < SERVE_WAIT_S:
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if ready:
            line = proc.stdout.readline()
            if line.startswith("SERVE "):
                return proc, json.loads(line[len("SERVE "):])
            if not line and proc.poll() is not None:
                break
    proc.kill()
    proc.wait()
    raise AssertionError(f"(u3) the serve child did not come up "
                         f"(exit {proc.returncode})")


def child_launches(tmp: str) -> dict:
    """Ask a serve child for its kernel launch counts (a request file)."""
    req = os.path.join(tmp, "report")
    ans = os.path.join(tmp, "launches.json")
    with open(req, "w"):
        pass
    t0 = time.perf_counter()
    while not os.path.exists(ans):
        if time.perf_counter() - t0 > SERVE_WAIT_S:
            raise AssertionError("(u3) the serve child did not report")
        time.sleep(0.02)
    with open(ans) as f:
        got = json.load(f)
    os.unlink(ans)
    return got


def serve_child(tmp: str) -> int:
    """The body of (u3)'s daemon (``--serve-child DIR``): a durable
    server on the card (``DURABLE``/``CHECKPOINT_DIR`` from the
    environment) that prints its port, its restore and the launch
    counts of its warm start, then serves until it is killed, writing its
    launch counts whenever ``DIR/report`` appears."""
    from spark_rapids_jni_tpu_torch import kernels, serving

    kernels.build_all()
    srv = serving.Server(device=DEVICE, port=0, workers=SERVE_WORKERS).start()
    torch.cuda.synchronize()
    print("SERVE " + json.dumps({"port": srv.port,
                                 "restore": srv._restore_doc,
                                 "launches": stream_launches(kernels)}),
          flush=True)
    kernels.reset_launches()  # a report counts the requests after restore
    req = os.path.join(tmp, "report")
    while True:
        if os.path.exists(req):
            torch.cuda.synchronize()
            part = os.path.join(tmp, "launches.part")
            with open(part, "w") as f:
                json.dump(stream_launches(kernels), f)
            os.replace(part, os.path.join(tmp, "launches.json"))
            os.unlink(req)
        time.sleep(0.02)


def serving_u3(rb, serving, d: dict) -> dict:
    """(u3): a durable daemon in a child process takes (a)'s batch and
    item and a donating [from_rows, filter]; once that put is
    acknowledged the child is killed with SIGKILL; a second child
    restores, the client resumes with its token, downloads the same
    bytes and runs the rest of (a)'s plan on the restored tables."""
    import shutil
    import tempfile

    from spark_rapids_jni_tpu_torch.utils import spill

    tmp = tempfile.mkdtemp(prefix="srt-u3-")
    env = dict(os.environ, SPARK_RAPIDS_TPU_DURABLE="on",
               SPARK_RAPIDS_TPU_CHECKPOINT_DIR=os.path.join(tmp, "ckpt"))
    children = []
    try:
        # the checkpoint write alone: the serde the daemon runs, on the
        # same table, in this process
        fid = rb.table_upload_wire(*d["fact_wire"], device=DEVICE)
        t0 = time.perf_counter()
        nbytes = spill.save_table_npz(os.path.join(tmp, "write.npz"),
                                      rb._resident_get(fid))
        write_s = time.perf_counter() - t0
        rb.table_free(fid)
        os.unlink(os.path.join(tmp, "write.npz"))
        proc, info = start_serve_child(tmp, env)
        children.append(proc)
        c = serving.Client(info["port"], name="u3",
                           timeout=SERVE_WAIT_S).connect()
        fid = c.upload(d["fact_wire"])
        iid = c.upload(d["item_wire"])
        tid = c.plan(UPSTREAM_PLAN, [fid], donate=True)  # the put, acked
        want = c.download(tid)
        durability = c.stats()["durability"]
        sid, token = c.session, c.resume_token
        proc.kill()  # SIGKILL: no bye, no exit handler
        proc.wait()
        c.kill()
        t0 = time.perf_counter()
        proc, info = start_serve_child(tmp, env)
        children.append(proc)
        up_s = time.perf_counter() - t0
        restore = info["restore"]
        if (restore["sessions"] != 1 or restore["quarantined"]
                or restore["warm_compiles"] < 1):
            raise AssertionError(f"(u3) restore {restore}")
        with serving.Client(info["port"], session=sid, resume=token,
                            timeout=SERVE_WAIT_S) as c:
            same_wire(c.download(tid), want, "(u3) the restored table")
            out = c.plan(DOWNSTREAM_PLAN, [tid, iid], donate=True)
            groups = check_query_result(c.download(out), query_oracle(d))
            launches = child_launches(tmp)
            c.free(out)
            c.free(iid)
    finally:
        for p in children:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    missing = [k for k in QUERY_KERNELS[1:] if launches[k] == 0]
    if missing or info["launches"]["unpack_rows"] == 0:
        raise AssertionError(f"(u3) the restored plans never launched "
                             f"{missing}: warm start {info['launches']}, "
                             f"after {launches}")
    rec = {"write_bytes": nbytes, "write_s": write_s,
           "write_gb_s": nbytes / write_s / 1e9,
           "checkpoint_bytes": durability.get("checkpoint.bytes", 0),
           "restore": restore, "restart_s": up_s, "groups": groups,
           "warm_launches": info["launches"],
           "launches": {k: launches[k] for k in QUERY_KERNELS[1:]}}
    log(f"(u3) durable daemon killed with SIGKILL after the acknowledged "
        f"put ({rec['checkpoint_bytes']} checkpoint bytes); the second "
        f"child restored {restore['sessions']} session in "
        f"{restore['took_ms'] / 1e3:.2f} s ({restore['warm_compiles']} warm "
        f"replays; {up_s:.1f} s from its start to its listener), the "
        f"resumed client read the same bytes and ran the rest of (a)'s plan "
        f"({groups} groups, exact); checkpoint write {nbytes} bytes in "
        f"{write_s:.3f} s = {rec['write_gb_s']:.2f} GB/s (save_table_npz, "
        f"warm page cache); launches warm start {info['launches']}, after "
        f"{rec['launches']}")
    return rec


def serving_u4(rb, kernels, serving, d: dict) -> dict:
    """(u4): a session with ``mesh=4`` streams [filter, cast, partition
    hash 200] over (a)'s batch as columns: the same bytes as a
    single-device session's stream and the in-process bridge's, through
    the mesh path, with K5 launched."""
    from spark_rapids_jni_tpu_torch.kernels import hashing
    from spark_rapids_jni_tpu_torch.utils import config, metrics

    wire = fact_columns_wire(d)
    ref = rb.table_plan_wire(json.dumps(MESH_PLAN), *wire, device=DEVICE)
    config.set_flag("METRICS", True)
    try:
        with serving.serve(device=DEVICE, port=0,
                           workers=SERVE_WORKERS) as srv:
            with serving.Client(srv.port, name="u4-single",
                                timeout=SERVE_WAIT_S) as c:
                single = c.stream(MESH_PLAN, [wire])[0]
            metrics.reset()
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            with serving.Client(srv.port, name="u4-mesh", mesh=MESH_SHARDS,
                                timeout=SERVE_WAIT_S) as c:
                meshed = c.stream(MESH_PLAN, [wire])[0]
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            launches = kernels.KERNELS[hashing.MURMUR3.name].launches
            counters = metrics.snapshot()["counters"]
            mesh_docs = srv.stats()["mesh"]
    finally:
        config.clear_flag("METRICS")
    same_wire(single, ref, "(u4) the single-device session")
    same_wire(meshed, single, "(u4) the mesh-backed session")
    if counters.get("plan.mesh_segments", 0) < 1 or launches == 0:
        raise AssertionError(f"(u4) mesh segments "
                             f"{counters.get('plan.mesh_segments', 0)}, K5 "
                             f"launches {launches}")
    picked = {k: counters.get(k, 0) for k in MESH_COUNTERS}
    log(f"(u4) a mesh={MESH_SHARDS} session's stream equals the "
        f"single-device session's and the bridge's bytes ({wire[4]} rows); "
        f"{wall:.1f} ms with the hello; K5 launches {launches}; counters "
        f"{picked}; runner {mesh_docs}")
    return {"wall_ms": wall, "launches": launches, "counters": picked}


def shim_op(native, op: dict, wire):
    """One op through the shim's C ABI (JOIN mode), its output handles
    read back and released."""
    ids, scales, datas, valids, n = wire
    hd = [native.buffer_create(bytes(x)) for x in datas]
    hv = [None if v is None else native.buffer_create(bytes(v))
          for v in valids]
    try:
        oids, oscales, od, ov, on = native.jax_table_op(
            json.dumps(op), ids, scales, hd, hv, n)
    finally:
        for h in hd + [h for h in hv if h]:
            native.buffer_release(h)
    try:
        return (oids, oscales, [native.buffer_bytes(h) for h in od],
                [None if h is None else native.buffer_bytes(h) for h in ov],
                on)
    finally:
        for h in od + [h for h in ov if h]:
            native.buffer_release(h)


def shim_resident(native, ops, wire):
    """upload -> one resident op per step -> download -> free."""
    ids, scales, datas, valids, n = wire
    hd = [native.buffer_create(bytes(x)) for x in datas]
    hv = [None if v is None else native.buffer_create(bytes(v))
          for v in valids]
    try:
        tabs = [native.jax_table_upload(ids, scales, hd, hv, n)]
    finally:
        for h in hd + [h for h in hv if h]:
            native.buffer_release(h)
    try:
        for op in ops:
            tabs.append(native.jax_table_op_resident(json.dumps(op),
                                                     [tabs[-1]]))
        oids, oscales, od, ov, on = native.jax_table_download(tabs[-1])
        got = (oids, oscales, [native.buffer_bytes(h) for h in od],
               [None if h is None else native.buffer_bytes(h) for h in ov],
               on)
        for h in od + [h for h in ov if h]:
            native.buffer_release(h)
        return got
    finally:
        for t in tabs:
            native.jax_table_free(t)


def native_oracle(d: dict) -> np.ndarray:
    """(v)'s rows in numpy: the kept rows without the mask column, four
    columns (28 bytes) and their validity byte, 32 bytes a row."""
    m = d["keep"]
    rows = np.zeros((int(m.sum()), 32), np.uint8)
    rows[:, :28] = d["rows"][m][:, :28]
    rows[:, 28] = (1 | 4 | (d["customer_ok"][m].astype(np.uint8) << 1)
                   | (d["quantity_ok"][m].astype(np.uint8) << 3))
    return rows


def phase_native(rb, kernels, d: dict) -> dict:
    """(v): the native shim built with g++; ``native_demo_torch`` (HOST
    mode) and ``jni_harness_torch`` on the card; then, through
    ``utils/native.py`` (JOIN mode), (a)'s batch [from_rows, filter,
    to_rows] op by op and as a resident chain, each equal to
    ``table_op_wire`` on the card, K1b and K1a launched."""
    from spark_rapids_jni_tpu_torch.utils import native

    kind = torch.device(DEVICE).type  # the shim's device variable
    platform = "gpu" if kind == "cuda" else "cpu"
    built_now = not (native.build_dir() / native.LIB_NAME).exists()
    t0 = time.perf_counter()
    paths = native.build()
    build_s = time.perf_counter() - t0
    env = dict(os.environ, SPARK_RAPIDS_TPU_DEVICE=kind,
               SRT_PYTHONPATH=ROOT_DIR)
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([str(paths[name])], env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name in ("native_demo", "jni_harness")}
    outs = {}
    for name, p in procs.items():
        try:
            outs[name] = p.communicate(timeout=SERVE_WAIT_S)[0]
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        lines = outs[name].rstrip().splitlines()
        if (p.returncode != 0 or f"platform = {platform}" not in outs[name]
                or not lines[-1].endswith(": ok")):
            raise AssertionError(f"(v) {name}_torch exited {p.returncode}:\n"
                                 + outs[name][-4000:])
    programs_s = time.perf_counter() - t0
    os.environ["SPARK_RAPIDS_TPU_DEVICE"] = kind
    native.jax_init()
    if native.jax_platform() != platform or \
            native.runtime_package() != "spark_rapids_jni_tpu_torch":
        raise AssertionError("(v) the shim does not embed the port on the card")
    wire = d["fact_wire"]
    want = native_oracle(d)
    walls = {"bridge": [], "shim": []}
    for run in range(NATIVE_RUNS):
        t0 = time.perf_counter()
        ref = [wire]
        for op in NATIVE_PLAN:
            ref.append(rb.table_op_wire(json.dumps(op), *ref[-1],
                                        device=DEVICE))
        walls["bridge"].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        if run == 0:
            kernels.reset_launches()
        t0 = time.perf_counter()
        got = [wire]
        for op in NATIVE_PLAN:
            got.append(shim_op(native, op, got[-1]))
        walls["shim"].append((time.perf_counter() - t0) * 1e3)
        if run == 0:
            torch.cuda.synchronize()
            launches = stream_launches(kernels)
        for k in range(1, len(got)):
            same_wire(got[k], ref[k], f"(v) shim op {NATIVE_PLAN[k - 1]['op']}")
    check_rows(ref[-1], want)
    torch.cuda.synchronize()
    kernels.reset_launches()
    before = native.jax_resident_table_count()
    t0 = time.perf_counter()
    chain = shim_resident(native, NATIVE_PLAN, wire)
    chain_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    chain_launches = stream_launches(kernels)
    same_wire(chain, ref[-1], "(v) the shim's resident chain")
    if native.jax_resident_table_count() != before:
        raise AssertionError("(v) the resident chain left tables behind")
    if native.live_handle_count() != 0:
        raise AssertionError("(v) the shim's handle registry is not empty")
    missing = [k for k in NATIVE_KERNELS
               if launches[k] == 0 or chain_launches[k] == 0]
    if missing:
        raise AssertionError(f"(v) never launched {missing}: op by op "
                             f"{launches}, chain {chain_launches}")
    rec = {"build_s": build_s, "built_now": built_now,
           "programs_s": programs_s,
           "bridge_ms": statistics.median(walls["bridge"]),
           "shim_ms": statistics.median(walls["shim"]),
           "walls_ms": walls, "chain_ms": chain_ms,
           "launches": {k: launches[k] for k in NATIVE_KERNELS},
           "chain_launches": {k: chain_launches[k] for k in NATIVE_KERNELS}}
    log(f"(v) shim built in {build_s:.1f} s "
        f"({'built now' if rec['built_now'] else 'already built'}); "
        f"native_demo_torch and jni_harness_torch passed on the card "
        f"({programs_s:.1f} s, both at once); (a)'s batch [from_rows, "
        f"filter, to_rows] op by op through the shim equals table_op_wire's "
        f"bytes: {rec['shim_ms']:.1f} ms through the shim against "
        f"{rec['bridge_ms']:.1f} ms in process (medians of {NATIVE_RUNS}); "
        f"the resident chain {chain_ms:.1f} ms, equal; launches "
        f"{rec['launches']}, chain {rec['chain_launches']}")
    return rec


# ---------------------------------------------------------------------------
# (w) the TPC-DS query tier: q5/q23/q64 in memory and on a mesh, the
# Parquet streams against their pandas oracles
# ---------------------------------------------------------------------------

TPCDS_ROWS = 1 << 23  # (w1): one task's batch, as (a)
TPCDS_SCALE = 1.0  # (w2)/(w3): bench.py's SF1, 2,880,000 store_sales rows
TPCDS_PREFETCH = 2
TPCDS_RUNS = 3  # timed calls a query after the checked one
# (w1)'s queries: (name, group keys); q64's result is one table, the
# others' a sharded result to unpad
TPCDS_KEYS = {"q5": ["category_id"], "q23": ["customer_sk"],
              "q64": ["brand_id", "state_id", "year"]}


def tpcds_frame(t, keys):
    """A result table as a pandas DataFrame on the host (integers and
    decimals' unscaled values as int64, a null as NA), sorted by
    ``keys``."""
    import pandas as pd

    cols = {}
    for name, c in zip(t.names, t.columns):
        v = c.to_numpy()
        if v.dtype.kind in "iub":
            v = v.astype(np.int64)
        if c.validity is not None:
            v = pd.array(v, dtype="Int64" if v.dtype.kind == "i" else None)
            v[~c.validity.cpu().numpy()] = pd.NA
        cols[name] = v
    return (pd.DataFrame(cols).sort_values(keys, kind="stable")
            .reset_index(drop=True))


def same_frames(got, want, what: str) -> None:
    """Two integer results as DataFrames: the same columns, rows and
    values (nulls in the same places)."""
    if (list(got.columns) != list(want.columns) or len(got) != len(want)
            or not got.astype("Int64").equals(want.astype("Int64"))):
        raise AssertionError(f"{what}: {len(got)} rows {list(got.columns)} "
                             f"!= {len(want)} rows {list(want.columns)}\n"
                             f"{got.head()}\n{want.head()}")


def tpcds_host(tables: dict) -> dict:
    """Every table of (w1) as a host DataFrame of its values (decimals
    as unscaled cents)."""
    import pandas as pd

    return {name: pd.DataFrame({n: c.to_numpy()
                                for n, c in zip(t.names, t.columns)
                                if not c.dtype.is_string})
            for name, t in tables.items()}


def tpcds_oracles(h: dict) -> dict:
    """q5/q23/q64 of ``spark_rapids_jni_tpu_torch.tpcds.queries`` in
    pandas over (w1)'s host tables, exact in int64 (money in cents; the
    revenue quantity x cents), each sorted by its group keys."""
    import pandas as pd

    def window(df):
        return df[(df.date_sk >= 100) & (df.date_sk < 200)]

    sales = pd.concat([window(h["store_sales"]), window(h["web_sales"])])
    j = sales.merge(h["item"], on="item_sk")
    j = j.assign(revenue=j.quantity * j.sales_price)
    q5 = j.groupby("category_id").agg(
        sum_revenue=("revenue", "sum"), sum_net_profit=("net_profit", "sum"),
        count_revenue=("revenue", "count")).reset_index()
    ss = h["store_sales"]
    freq = ss.item_sk.value_counts()
    hot = ss[ss.item_sk.isin(freq[freq >= 4].index)]
    q23 = (hot.assign(spend=hot.quantity * hot.sales_price)
           .groupby("customer_sk").agg(sum_spend=("spend", "sum"))
           .reset_index())
    item = h["item"]
    cheap = item[item.current_price <= 15_000]
    j = (ss.merge(cheap, on="item_sk").merge(h["customer"], on="customer_sk")
         .merge(h["date_dim"], on="date_sk"))
    j = j.assign(revenue=j.quantity * j.sales_price)
    q64 = j.groupby(TPCDS_KEYS["q64"]).agg(
        sum_revenue=("revenue", "sum"),
        count_revenue=("revenue", "count")).reset_index()
    out = {}
    for name, df in (("q5", q5), ("q23", q23), ("q64", q64)):
        out[name] = (df.astype("int64").sort_values(TPCDS_KEYS[name])
                     .reset_index(drop=True))
    return out


def tpcds_measure(tag: str, run) -> dict:
    """Wall (the median of ``TPCDS_RUNS`` calls, each CUDA-synchronised),
    device time (profiler), busy share and host syncs of one call."""
    def once():
        run()
        torch.cuda.synchronize()

    walls = []
    for _ in range(TPCDS_RUNS):
        t0 = time.perf_counter()
        once()
        walls.append((time.perf_counter() - t0) * 1e3)
    dev_ms = device_window_ms(once, runs=1)
    syncs = count_syncs(once)
    wall = statistics.median(walls)
    out = {"wall_ms": wall, "walls_ms": walls, "device_ms": dev_ms,
           "busy": dev_ms / wall, "host_syncs": syncs}
    log(f"(w) {tag}: wall {wall:.2f} ms (median of "
        f"{[round(w, 2) for w in walls]}), device {dev_ms:.3f} ms, busy "
        f"{100 * dev_ms / wall:.1f} %, {syncs} host syncs")
    return out


def stream_verdicts(data_dir: str, q5, q23, q64) -> dict:
    """The oracle comparisons of the JAX runner (``benchmarks/tpcds.py``
    ``run_all``) on the port's three stream results: q5's categories,
    sales (float64) and counts (exact); q23's non-null customers' count
    and totals and its one null-key group's total; q64's group count and
    sales total."""
    from spark_rapids_jni_tpu_torch.tpcds import streams

    o5 = streams.oracle_q5(data_dir)
    order = np.argsort(np.asarray(q5["i_category_id"].to_numpy()))
    ok5 = (
        q5.row_count == len(o5)
        and np.allclose(
            streams._dec_to_float(q5["sales"])[order],
            o5.sort_values("i_category_id")["sales"].to_numpy(np.float64))
        and np.array_equal(
            np.asarray(q5["n"].to_numpy())[order],
            o5.sort_values("i_category_id")["n"].to_numpy(np.int64)))
    o23, null_sum = streams.oracle_q23(data_dir)
    kk = q23["customer_sk"]
    nonnull = (np.ones(q23.row_count, bool) if kk.validity is None
               else kk.validity.cpu().numpy())
    totals = streams._dec_to_float(q23["total"])
    ok23 = (
        int(nonnull.sum()) == len(o23)
        and int((~nonnull).sum()) <= 1
        and np.isclose(totals[nonnull].sum(), o23.sales_price.sum())
        and np.isclose(totals[~nonnull].sum(), null_sum))
    o64 = streams.oracle_q64(data_dir)
    ok64 = q64.row_count == len(o64) and np.isclose(
        streams._dec_to_float(q64["sales"]).sum(), o64.sales.sum())
    return {"q5": bool(ok5), "q23": bool(ok23), "q64": bool(ok64)}


def phase_tpcds(kernels, seed: int) -> dict:
    """(w): the TPC-DS query tier on the card. (w1) ``datagen.generate``
    at one task's 2^23 store_sales rows: q5, q23 and q64 on one device
    and on ``MESH_SHARDS`` logical shards, each exact against pandas over
    the same host arrays, the mesh's unpadded results equal to the
    single device's, K5 launched in the mesh runs. (w2)
    ``generate_parquet`` at SF1 and the three streams at prefetch 2, with
    every verdict of the JAX runner's oracle comparisons true. (w3)
    ``load_tables`` of the same files through the three mesh queries,
    equal to the single-device DAGs. Each query's wall, device time,
    busy share and host syncs; the host seconds of the generation and
    the oracles."""
    import shutil

    from spark_rapids_jni_tpu_torch import parallel
    from spark_rapids_jni_tpu_torch.tpcds import datagen, queries, streams

    res = {"w1": {}, "w2": {}, "w3": {}, "card": nvidia_smi_line()}
    log(f"(w) on {res['card']}")
    mesh = parallel.make_mesh(MESH_SHARDS, devices=mesh_pool(MESH_SHARDS))

    def unpadded(r):
        return r if not isinstance(r, tuple) else (
            queries.unpad_groupby(r[0], r[1]))

    def mesh_runs(calls, tag):
        """The single-device and mesh form of each query: checked equal,
        then measured; the mesh forms' launches."""
        out, got = {}, {}
        for name, (one, many) in calls.items():
            keys = TPCDS_KEYS[name]
            single = tpcds_frame(one(), keys)
            torch.cuda.synchronize()
            kernels.reset_launches()
            r = many()
            torch.cuda.synchronize()
            launches = {k: v.launches for k, v in kernels.KERNELS.items()}
            if isinstance(r, tuple) and int(r[2].max()) > 0:
                raise AssertionError(f"({tag}) {name} mesh overflow")
            same_frames(tpcds_frame(unpadded(r), keys), single,
                        f"({tag}) {name} mesh against one device")
            got[name] = single
            out[name] = {"rows": len(single), "launches": launches,
                         "single": tpcds_measure(f"({tag}) {name}, one "
                                                 "device", one),
                         "mesh": tpcds_measure(
                             f"({tag}) {name}, {MESH_SHARDS} shards", many)}
            if launches["murmur3_table_fused"] == 0:
                raise AssertionError(f"({tag}) {name}: the mesh run never "
                                     "launched K5")
            log(f"({tag}) {name}: {len(single)} groups, mesh equal to one "
                f"device; launches in the mesh run {launches}")
        return out, got

    # (w1) in memory, one task's batch
    t0 = time.perf_counter()
    tables = datagen.generate(TPCDS_ROWS, seed=seed, device=DEVICE)
    torch.cuda.synchronize()
    res["w1"]["datagen_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = tpcds_oracles(tpcds_host(tables))
    res["w1"]["oracle_s"] = time.perf_counter() - t0
    log(f"(w1) datagen.generate({TPCDS_ROWS}): "
        f"{res['w1']['datagen_s']:.1f} s; pandas oracles "
        f"{res['w1']['oracle_s']:.1f} s")
    calls = {
        "q5": (lambda: queries.q5(tables),
               lambda: queries.q5_distributed(tables, mesh)),
        "q23": (lambda: queries.q23(tables),
                lambda: queries.q23_distributed(tables, mesh)),
        "q64": (lambda: queries.q64(tables),
                lambda: queries.q64_distributed(tables, mesh)),
    }
    out, got = mesh_runs(calls, "w1")
    for name in calls:
        same_frames(got[name], want[name], f"(w1) {name} against pandas")
    res["w1"].update(out)
    res["k5_shard_rows"] = tables["store_sales"].row_count // MESH_SHARDS
    res["k5_launches"] = sum(
        out[q]["launches"]["murmur3_table_fused"] for q in out)
    del tables, calls

    # (w2) the Parquet star schema at SF1, streamed
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "tpcds_sf1")
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        manifest = streams.generate_parquet(root, scale=TPCDS_SCALE, seed=seed)
        res["w2"]["generate_s"] = time.perf_counter() - t0
        res["w2"]["manifest"] = {k: v for k, v in manifest.items()
                                 if k != "dir"}
        log(f"(w2) generate_parquet(scale={TPCDS_SCALE}): "
            f"{res['w2']['generate_s']:.1f} s, {res['w2']['manifest']}")
        runs = {"q5": lambda: streams.q5_stream(root, TPCDS_PREFETCH, DEVICE),
                "q23": lambda: streams.q23_stream(
                    root, prefetch=TPCDS_PREFETCH, device=DEVICE),
                "q64": lambda: streams.q64_stream(
                    root, prefetch=TPCDS_PREFETCH, device=DEVICE)}
        results = {name: fn() for name, fn in runs.items()}
        t0 = time.perf_counter()
        verdicts = stream_verdicts(root, results["q5"], results["q23"],
                                   results["q64"])
        res["w2"]["oracle_s"] = time.perf_counter() - t0
        res["w2"]["verdicts"] = verdicts
        log(f"(w2) oracle verdicts {verdicts} (pandas "
            f"{res['w2']['oracle_s']:.1f} s); groups "
            f"{ {k: v.row_count for k, v in results.items()} }")
        if not all(verdicts.values()):
            raise AssertionError(f"(w2) oracle verdicts {verdicts}")
        for name, fn in runs.items():
            res["w2"][name] = tpcds_measure(f"(w2) {name}_stream", fn)
            res["w2"][name]["groups"] = results[name].row_count
        del results

        # (w3) the same files through the mesh DAGs
        t0 = time.perf_counter()
        sf1 = streams.load_tables(root, device=DEVICE)
        torch.cuda.synchronize()
        res["w3"]["load_s"] = time.perf_counter() - t0
        lo, hi = streams._DATE_LO, streams._DATE_HI
        calls = {
            "q5": (lambda: queries.q5(sf1, lo, hi),
                   lambda: queries.q5_distributed(sf1, mesh, lo, hi)),
            "q23": (lambda: queries.q23(sf1, 50),
                    lambda: queries.q23_distributed(sf1, mesh, 50)),
            "q64": (lambda: queries.q64(sf1),
                    lambda: queries.q64_distributed(sf1, mesh)),
        }
        out, _ = mesh_runs(calls, "w3")
        res["w3"].update(out)
        log(f"(w3) load_tables: {res['w3']['load_s']:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


def tpcds_kernel_records(qw: dict) -> list:
    """K5 at (w)'s shape: one shard's store_sales customer_sk keys, as
    q23's exchanges hash a shard of (w1)'s batch, with (w)'s mesh
    launches."""
    from spark_rapids_jni_tpu_torch import dtype as dt
    from spark_rapids_jni_tpu_torch.column import Column
    from spark_rapids_jni_tpu_torch.kernels import hashing as kh

    n = qw["k5_shard_rows"]
    rng = np.random.default_rng(0)
    keys = [Column(torch.from_numpy(rng.integers(
        0, TPCDS_ROWS // 20, n, dtype=np.int64)).to(DEVICE), dt.INT64)]
    return [kernel_record(
        kh.MURMUR3, "tpcds", f"{n} rows x 1 INT64 key (one of "
        f"{MESH_SHARDS} shards)", qw["k5_launches"],
        lambda: [kh.murmur3_columns(keys)], lambda: [kh.murmur3_plain(keys)],
        n * (8 + 4), n * (2 * 11 + 10),
        note="(w1): the q5/q23/q64 mesh runs' launches")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # the script's own child processes ((k5)'s and (n)'s CPU references,
    # (t)'s dumps, (u)'s daemon)
    ap.add_argument("--k5-cpu-reference", nargs=2, metavar=("IN", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--oplib-cpu-reference", nargs=2, metavar=("IN", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--telemetry-dump-child", metavar="IN",
                    help=argparse.SUPPRESS)
    ap.add_argument("--serve-child", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.k5_cpu_reference:
        return k5_cpu_reference(*args.k5_cpu_reference)
    if args.oplib_cpu_reference:
        return oplib_cpu_reference(*args.oplib_cpu_reference)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if args.telemetry_dump_child:
        return telemetry_dump_child(args.telemetry_dump_child)
    if args.serve_child:
        return serve_child(args.serve_child)
    return run_all(args)


def run_all(args) -> int:
    """Every phase, then the kernel records and the result lines."""
    from spark_rapids_jni_tpu_torch import kernels
    from spark_rapids_jni_tpu_torch import runtime_bridge as rb
    from spark_rapids_jni_tpu_torch.kernels import (
        bitonic_sort, hash_table, hashing, row_transpose, scan16,
    )

    expected = {i.name for i in (row_transpose.PACK, row_transpose.UNPACK,
                                 hash_table.BUILD, hash_table.PROBE,
                                 hashing.MURMUR3, bitonic_sort.SORT,
                                 bitonic_sort.SORT_U64, bitonic_sort.SORT_U32,
                                 scan16.SCAN16)}
    if set(kernels.KERNELS) != expected:
        raise RuntimeError(f"kernel registry {set(kernels.KERNELS)} != {expected}")

    t0 = time.perf_counter()
    kernels.build_all()
    log(f"built {len(kernels.SOURCES)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in kernels.SOURCES:
        for line in ptxas_lines(kernels.ptxas_info(name)):
            log(f"ptxas {name}.cu: {line}")
    rng = np.random.default_rng(args.seed)
    failed = []
    t0 = time.perf_counter()
    d = make_query_data(rng, FACT_ROWS, ITEM_ROWS)
    rc_wire = make_rowconv_wire(rng, ROWCONV_ROWS)
    g = make_groupby_data(rng, GROUPBY_ROWS, GROUPBY_KEYS)
    q = make_query_step_data(rng, QS_ROWS, QS_ITEMS)
    dd = make_dispatch_data(rng, d)
    sd = make_string_data(rng, d)
    ld = make_lineitem_data(rng, DEC_ROWS)
    od = make_oplib_data(rng, d)
    log(f"data made in {time.perf_counter() - t0:.1f} s")
    phases = {
        "query": lambda: phase_query(rb, kernels, d),
        "rowconv": lambda: phase_rowconv(rb, kernels, rc_wire),
        "exchange": lambda: phase_rows_plan(
            rb, kernels, "(d) exchange:", EXCHANGE_PLAN, d["fact_wire"],
            exchange_oracle(d), [hashing.MURMUR3.name]),
        "sort": lambda: phase_rows_plan(
            rb, kernels, "(e) sort:", SORT_PLAN, d["fact_wire"],
            sort_oracle(d), [bitonic_sort.SORT.name]),
        "groupby": lambda: phase_groupby(kernels, g),
        "query_step": lambda: phase_query_step(kernels, q, args.seed),
        "wire_plan": lambda: phase_wire_plan(kernels, d),
        "dispatch": lambda: phase_dispatch(rb, kernels, d, dd),
        "remaining_ops": lambda: phase_remaining_ops(rb, d, args.seed),
        "strings": lambda: phase_strings(rb, kernels, d, sd),
        "string_ops": lambda: phase_string_ops(rb, sd, args.seed),
        "string_lib": lambda: phase_string_lib(rb, sd, args.seed),
        "decimal": lambda: phase_decimal(rb, kernels, ld),
        "decimal_ops": lambda: phase_decimal_ops(rb, args.seed),
        "stream": lambda: phase_stream(rb, kernels, d, mctx),
        "spill": lambda: phase_spill(rb, mctx),
        "faults": lambda: phase_faults(rb, mctx),
        "registry": lambda: phase_registry(rb, mctx),
        "oplib": lambda: phase_oplib(kernels, d, od),
        "buckets": lambda: phase_buckets(rb, kernels, d, dd),
        "formulations": lambda: phase_formulations(kernels, g, d, args.seed),
        "fusion": lambda: phase_fusion(rb, d, dd),
        "io": lambda: phase_io(kernels, d),
        "mesh": lambda: phase_mesh(kernels, d, dd),
        "telemetry": lambda: phase_telemetry(rb, kernels, d, mctx),
        "serving": lambda: phase_serving(rb, kernels, d, mctx),
        "native": lambda: phase_native(rb, kernels, d),
        "tpcds": lambda: phase_tpcds(kernels, args.seed),
    }
    mctx = {}  # (m1)'s batches and answers, for (m2)-(m4)
    res = {}
    for name, fn in phases.items():
        t0 = time.perf_counter()
        try:
            res[name] = fn()
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    recs = []
    if all(k in res for k in ("query", "rowconv", "exchange", "sort",
                              "groupby")):
        try:
            recs = phase_kernels(d, res["query"], res["rowconv"],
                                 res["exchange"], res["sort"], res["groupby"])
        except Exception:
            traceback.print_exc()
            failed.append("kernels")
    else:
        failed.append("kernels (skipped: an earlier phase failed)")
    checks = {"transpose_cases": lambda: phase_transpose_cases(args.seed),
              "scan16_cases": lambda: phase_scan16_cases(args.seed),
              "float_groupby": lambda: phase_float_groupby(args.seed),
              "key_classes": lambda: phase_key_classes(args.seed),
              "u32_rows": lambda: phase_u32_rows(args.seed),
              "build_cases": lambda: phase_build_cases(d, args.seed, tables),
              "probe_cases": lambda: phase_probe_cases(d, args.seed, tables)}
    hard, tables = {}, {}
    for name, fn in checks.items():
        try:
            hard[name] = fn()
        except Exception:
            traceback.print_exc()
            failed.append(name)
    try:
        smi = nvidia_smi_line()
    except (OSError, subprocess.SubprocessError):
        traceback.print_exc()
        failed.append("nvidia-smi")
    if "query_step" in res:
        recs.append(res["query_step"]["step0"]["record"])
    if "dispatch" in res:
        try:
            recs += dispatch_kernel_records(d, dd, res["dispatch"])
        except Exception:
            traceback.print_exc()
            failed.append("dispatch kernels")
    if "strings" in res:
        try:
            recs += string_kernel_records(d, sd, res["strings"])
        except Exception:
            traceback.print_exc()
            failed.append("string kernels")
    if "stream" in res:
        try:
            recs += stream_kernel_records(d, res["stream"])
        except Exception:
            traceback.print_exc()
            failed.append("stream kernels")
    if "oplib" in res:
        try:
            recs += oplib_kernel_records(d, od, res["oplib"])
        except Exception:
            traceback.print_exc()
            failed.append("oplib kernels")
    if "mesh" in res:
        try:
            recs += mesh_kernel_records(d, res["mesh"])
        except Exception:
            traceback.print_exc()
            failed.append("mesh kernels")
    if "tpcds" in res:
        try:
            recs += tpcds_kernel_records(res["tpcds"])
        except Exception:
            traceback.print_exc()
            failed.append("tpcds kernels")
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({
        "kernels": recs, "query_plan_ms": res["query"]["plan_ms"],
        "query_profile": res["query"]["profile"],
        "rowconv_plan_ms": res["rowconv"]["plan_ms"],
        "rowconv_profile": res["rowconv"]["profile"],
        "exchange_plan_ms": res["exchange"]["plan_ms"],
        "exchange_profile": res["exchange"]["profile"],
        "sort_plan_ms": res["sort"]["plan_ms"],
        "sort_profile": res["sort"]["profile"],
        "groupby_ms": res["groupby"]["plan_ms"],
        "groupby_profile": res["groupby"]["profile"],
        "query_step": res["query_step"], "wire_plan": res["wire_plan"],
        "dispatch": res["dispatch"], "remaining_ops": res["remaining_ops"],
        "strings": res["strings"], "string_ops": res["string_ops"],
        "string_lib": res["string_lib"],
        "decimal": res["decimal"], "decimal_ops": res["decimal_ops"],
        "stream": res["stream"], "spill": res["spill"],
        "faults": res["faults"], "registry": res["registry"],
        "oplib": res["oplib"], "buckets": res["buckets"],
        "formulations": res["formulations"], "fusion": res["fusion"],
        "io": res["io"], "mesh": res["mesh"],
        "telemetry": res["telemetry"], "serving": res["serving"],
        "native": res["native"], "tpcds": res["tpcds"], **hard}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
