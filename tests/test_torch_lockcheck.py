"""The port's lock-order checker (``utils/lockcheck.py``) against the JAX
package's, on the CPU.

The sanctioned order is the same data, and the same acquisition scripts
(threads run one after another, each taking and releasing named locks
and reaching blocking points) give the same order graph, cycles,
inversions and held-across-blocking findings in both packages. With the
flag off an acquisition stays under 5 us, as the JAX tests bound it; the
port's own locks are tracked and its blocking sites report.
"""

import threading
import time

import pytest

from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu.utils import lockcheck as jlockcheck
from spark_rapids_jni_tpu_torch.utils import config, flight, lockcheck


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.delenv("SPARK_RAPIDS_TPU_LOCKCHECK", raising=False)
    lockcheck.reset()
    jlockcheck.reset()
    yield
    config.clear_flag("LOCKCHECK")
    jconfig.clear_flag("LOCKCHECK")
    config.clear_flag("FLIGHT")
    lockcheck.reset()
    jlockcheck.reset()
    flight.reset()


def test_lock_order_is_the_jax_data():
    assert lockcheck.LOCK_ORDER == jlockcheck.LOCK_ORDER
    assert lockcheck._RANK == jlockcheck._RANK


# a script: one program a thread, run in turn; a program is a list of
# ("take", name) (nested in what the thread already holds), ("drop",)
# (releases the innermost) and ("block", kind) steps
SCRIPTS = {
    "opposite_orders_cycle": [
        [("take", "alpha.a"), ("take", "beta.b"), ("drop",), ("drop",)],
        [("take", "beta.b"), ("take", "alpha.a"), ("drop",), ("drop",)]],
    "three_lock_cycle": [
        [("take", "a.x"), ("take", "b.x"), ("drop",), ("drop",)],
        [("take", "b.x"), ("take", "c.x"), ("drop",), ("drop",)],
        [("take", "c.x"), ("take", "a.x"), ("drop",), ("drop",)]],
    "consistent_order": [
        [("take", "alpha.a"), ("take", "beta.b"), ("drop",), ("drop",)]] * 3,
    "sanctioned_direction": [
        [("take", "registry.resident"), ("take", "session.state"),
         ("take", "spill.events"), ("drop",), ("drop",), ("drop",)]],
    "inversion": [
        [("take", "session.state"), ("take", "registry.resident"),
         ("drop",), ("drop",)]],
    "inversion_skipping_a_rank": [
        [("take", "spill.events"), ("take", "scheduler.q"),
         ("take", "registry.resident"), ("drop",), ("drop",), ("drop",)]],
    "unranked_names": [
        [("take", "pipeline.pool"), ("take", "buckets.cache"),
         ("drop",), ("drop",)],
        [("take", "spill.events"), ("take", "hbm.donated"),
         ("drop",), ("drop",)]],
    "held_across_dispatch": [
        [("take", "registry.resident"), ("block", "device_dispatch"),
         ("take", "pipeline.pending"), ("block", "spill_disk_read"),
         ("drop",), ("drop",), ("block", "device_dispatch")]],
    "nothing_held_at_blocking": [[("block", "device_dispatch")]],
    "rlock_reentry": [
        [("take", "registry.resident"), ("take", "registry.resident"),
         ("take", "spill.events"), ("drop",), ("drop",), ("drop",)]],
}


def _run(mod, program_set, locks):
    def lock(name):
        if name not in locks:
            locks[name] = (mod.make_rlock(name) if name == "registry.resident"
                           else mod.make_lock(name))
        return locks[name]

    for prog in program_set:
        def body(prog=prog):
            held = []
            for step in prog:
                if step[0] == "take":
                    lk = lock(step[1])
                    lk.acquire()
                    held.append(lk)
                elif step[0] == "drop":
                    held.pop().release()
                else:
                    mod.note_blocking(step[1])

        th = threading.Thread(target=body)
        th.start()
        th.join(30)
    return mod.report()


def _project(doc: dict) -> dict:
    return {
        "edges": {k: v["count"] for k, v in doc["edges"].items()},
        "cycles": doc["cycles"],
        "order_violations": [(v["held"], v["acquiring"], v["order"])
                             for v in doc["order_violations"]],
        "held_across_blocking": [(v["kind"], v["held"])
                                 for v in doc["held_across_blocking"]],
        "acquisitions": doc["acquisitions"],
        "order": doc["order"],
        "enabled": doc["enabled"],
    }


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scripts_give_the_jax_reports(name):
    config.set_flag("LOCKCHECK", "on")
    jconfig.set_flag("LOCKCHECK", "1")
    got = _project(_run(lockcheck, SCRIPTS[name], {}))
    want = _project(_run(jlockcheck, SCRIPTS[name], {}))
    assert got == want
    if "cycle" in name:
        assert got["cycles"]
    if "inversion" in name:
        assert got["order_violations"]
    if name == "held_across_dispatch":
        assert got["held_across_blocking"] == [
            ("device_dispatch", ["registry.resident"]),
            ("spill_disk_read", ["registry.resident", "pipeline.pending"])]


def test_condition_wait_is_not_held_across_the_block():
    config.set_flag("LOCKCHECK", "on")
    lk = lockcheck.make_lock("session.state")
    cv = lockcheck.make_condition(lk)
    box = []

    def waiter():
        with cv:
            cv.wait_for(lambda: box, timeout=10)
            lockcheck.note_blocking("device_dispatch")

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.05)
    with cv:
        box.append(1)
        cv.notify_all()
    th.join(10)
    doc = lockcheck.report()
    assert [v["held"] for v in doc["held_across_blocking"]] == [
        ["session.state"]]
    assert lockcheck._held() == []


def test_make_condition_rejects_raw_locks():
    with pytest.raises(TypeError):
        lockcheck.make_condition(threading.Lock())


def test_disabled_acquisition_under_5us():
    lk = lockcheck.make_lock("registry.probe")
    assert not lockcheck.enabled()
    n = 50_000
    t0 = time.perf_counter()
    for _ in range(n):
        with lk:
            pass
    per = (time.perf_counter() - t0) / n
    assert per < 5e-6, f"disabled acquisition costs {per * 1e6:.2f} us"
    assert lockcheck.report()["acquisitions"] == 0


def test_the_ports_locks_and_blocking_sites_report():
    """A blocking point reached with the registry lock held (the spill
    tier's disk read under it, by design) shows in the report, in the
    ``lockcheck`` flight section, and folds ``lock.*`` counters."""
    from spark_rapids_jni_tpu_torch import runtime_bridge as rb
    from spark_rapids_jni_tpu_torch.utils import metrics

    config.set_flag("LOCKCHECK", "on")
    config.set_flag("FLIGHT", "on")
    config.set_flag("METRICS", "on")
    try:
        assert isinstance(rb._RESIDENT_LOCK, lockcheck.TrackedRLock)
        with rb._RESIDENT_LOCK:
            lockcheck.note_blocking("spill_disk_read")
        doc = lockcheck.assert_clean()
        assert doc["held_across_blocking"][0]["held"] == ["registry.resident"]
        assert flight.snapshot()["sections"]["lockcheck"]["acquisitions"] >= 1
        # each report folds its findings in again (the JAX semantics)
        assert metrics.snapshot()["counters"]["lock.held_across_blocking"] >= 1
        assert "1 held-across-blocking" in lockcheck.summary_line()
    finally:
        config.clear_flag("METRICS")
        metrics.reset()
