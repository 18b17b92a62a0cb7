"""The execution services on the card: the pipelined stream against the
synchronous loop, the allocator's stream bookkeeping under a donation,
a spill round trip, and CUDA's out-of-memory error on the fault plane's
taxonomy.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports only the port, so the card's machine runs it without the
JAX package: ``python3 -m pytest --noconftest -m cuda
tests/test_torch_services_cuda.py``.
"""

import json
import threading

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu_torch import kernels
from spark_rapids_jni_tpu_torch import pipeline
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.utils import config, faults, metrics, spill

FACT_TYPES = [4, 4, 4, 3, 11]
QTY_BY_DATE = [
    {"op": "from_rows", "type_ids": FACT_TYPES, "scales": [0] * 5},
    {"op": "filter", "mask": 4},
    {"op": "cast", "column": 3, "type_id": 4},
    {"op": "groupby", "by": [2],
     "aggs": [{"column": 3, "agg": a} for a in ("sum", "count", "min", "max")]},
    {"op": "sort_by", "keys": [{"column": 0}]},
    {"op": "to_rows"},
]
FLAGS = ("PIPELINE", "SPILL", "SPILL_DIR", "HOST_SPILL_BUDGET_GB",
         "HBM_BUDGET_GB", "FAULTS", "RETRY_BASE_MS", "METRICS", "BUCKETS")
WAIT_S = 300


@pytest.fixture(autouse=True)
def _cuda_and_flags():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = rb.resident_table_count()
    yield
    pipeline.drain()
    for name in FLAGS:
        config.clear_flag(name)
    pipeline.depth()
    pipeline.drain_io()
    assert spill.spill_file_count() == 0
    assert rb.resident_table_count() == before
    spill.reset()


def _bounded(fn, timeout=WAIT_S):
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # handed to the caller below
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"{fn} did not finish in {timeout} s"
    if "error" in box:
        raise box["error"]
    return box.get("value")


def _fact_wire(n: int, seed: int):
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, 32), np.uint8)
    cols = ((0, (rng.zipf(1.3, n) % 500).astype(np.int64)),
            (8, rng.integers(0, 10_000, n).astype(np.int64)),
            (16, rng.integers(2_450_816, 2_450_876, n).astype(np.int64) + seed),
            (24, rng.integers(1, 101, n).astype(np.int32)))
    for off, a in cols:
        rows[:, off:off + a.itemsize] = a.view(np.uint8).reshape(n, a.itemsize)
    rows[:, 28] = rng.random(n) < 0.5
    rows[:, 29] = (1 | ((rng.random(n) > 0.03) << 1) | 4
                   | ((rng.random(n) > 0.03) << 3) | 16)
    offs = (np.arange(n + 1) * 32).astype(np.int32)
    return ([24], [5], [offs.tobytes() + rows.tobytes()], [None], n)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", ("1", "2", "4"))
def test_stream_equals_the_synchronous_loop(depth):
    batches = [_fact_wire(1 << 16, k) for k in range(6)]
    want = [tuple(rb.table_plan_wire(json.dumps(QTY_BY_DATE), *b))
            for b in batches]
    assert len({w[2][0] for w in want}) == len(want)
    config.set_flag("PIPELINE", depth)
    kernels.reset_launches()
    got = _bounded(lambda: rb.table_stream_wire(json.dumps(QTY_BY_DATE),
                                                batches))
    torch.cuda.synchronize()
    assert [tuple(g) for g in got] == want
    for name in ("unpack_rows", "pack_rows"):
        assert kernels.KERNELS[name].launches >= len(batches)
    # the groupby closes the fused [filter, cast, groupby]: no tier there
    assert kernels.KERNELS["build_table"].launches == 0


@pytest.mark.cuda
def test_donated_input_read_on_another_stream_is_not_reused_early():
    """A tensor made on a side stream and handed to the plan's stream:
    once its storage is freed (a donation), an allocation on the side
    stream must not overwrite it while the plan's stream still reads
    it: ``hand_over``'s ``record_stream`` keeps the block."""
    dev = torch.device("cuda", torch.cuda.current_device())
    side = torch.cuda.Stream(dev)
    n = 1 << 24
    src = torch.arange(n, dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        x = src.clone()
        ready = pipeline.mark(dev)
    pipeline.hand_over(ready, [x], dev)
    torch.cuda._sleep(100_000_000)  # hold the plan's stream busy
    y = x * 2  # queued behind the sleep: reads x
    spill.free_storage(x)
    with torch.cuda.stream(side):
        z = torch.full((n,), -1, dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    assert torch.equal(y, src * 2)
    assert int(z[0]) == -1


@pytest.mark.cuda
def test_spill_round_trip(tmp_path):
    """Eviction to the host and disk tiers and the repage: the bytes
    come back, the device storage goes at eviction, and the host tier's
    copies are pinned."""
    assert all(h.is_pinned() for h in spill._host_copies(
        [torch.arange(5, device="cuda"), torch.ones(3, device="cuda")]))
    wires = [_fact_wire(1 << 16, s) for s in range(3)]
    want = []
    for w in wires:
        t = rb.table_upload_wire(*w)
        want.append(tuple(rb.table_download_wire(t)))
        rb.table_free(t)
    config.set_flag("SPILL", "on")
    config.set_flag("HOST_SPILL_BUDGET_GB", 1e-3)
    config.set_flag("SPILL_DIR", str(tmp_path))
    ids = [rb.table_upload_wire(*w) for w in wires]
    try:
        torch.cuda.synchronize()
        held = rb._resident_get(ids[0])
        before = torch.cuda.memory_allocated()
        assert spill.request_headroom(1 << 40) > 0
        assert torch.cuda.memory_allocated() < before
        assert spill.storage_freed(held.columns[0].data)
        del held
        assert spill.stats_doc()["disk_bytes"] > 0
        assert [tuple(rb.table_download_wire(t)) for t in ids] == want
    finally:
        for t in ids:
            rb.table_free(t)


@pytest.mark.cuda
def test_injected_kernel_fault_retries_the_kernel():
    """A fault injected at the ``kernel`` site retries the same runner:
    every kernel of the plan still launches, and the exact path never
    stands in for one. Op by op, so that the groupby meets the tier."""
    config.set_flag("BUCKETS", "off")
    w = _fact_wire(1 << 16, 3)
    plan = json.dumps(QTY_BY_DATE)
    want = tuple(rb.table_plan_wire(plan, *w))
    config.set_flag("METRICS", "1")
    metrics.reset()
    kernels.reset_launches()
    config.set_flag("FAULTS", "kernel:transient:1")
    assert tuple(rb.table_plan_wire(plan, *w)) == want
    c = metrics.counter_values(
        ["kernel.retries", "kernel.launches", "kernel.fallbacks"])
    injected = faults.injection_stats()["kernel:transient"]["injected"]
    assert c == {"kernel.retries": injected, "kernel.launches": injected,
                 "kernel.fallbacks": 0}
    assert injected >= 3
    for name in ("unpack_rows", "build_table", "pack_rows"):
        assert kernels.KERNELS[name].launches >= 1


@pytest.mark.cuda
def test_out_of_memory_is_resource_exhausted():
    config.set_flag("RETRY_BASE_MS", "1")
    total = torch.cuda.get_device_properties(0).total_memory
    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        torch.empty(2 * total, dtype=torch.uint8, device="cuda")
    assert faults.classify(ei.value) is faults.ResourceExhausted
    calls = {"n": 0}

    def alloc():
        calls["n"] += 1
        return torch.empty(2 * total, dtype=torch.uint8, device="cuda")

    with pytest.raises(faults.ResourceExhausted, match="retries exhausted"):
        faults.run_with_retry(alloc, "oom")
    assert calls["n"] == faults.retry_max() + 1
    x = torch.arange(8, device="cuda")  # the context survives
    assert int(x.sum()) == 28


@pytest.mark.cuda
def test_reclaim_frees_device_memory():
    tid = rb.table_upload_wire(*_fact_wire(1 << 18, 1))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    nbytes = rb.table_reclaim(tid)
    torch.cuda.synchronize()
    drop = before - torch.cuda.memory_allocated()
    assert nbytes == (1 << 18) * 36 and 0 <= drop - nbytes < (1 << 20)
