"""The port's serving tier (``serving/``) against the JAX package's, on
the CPU: the port's server runs with ``device="cpu"``, the JAX server on
its CPU backend, each on ``port=0``.

* Both ``frames`` modules give equal bytes for equal headers and wire
  5-tuples, and each decodes the other's.
* Crossed clients: the JAX ``Client`` against the port's ``Server`` and
  the port's ``Client`` against the JAX ``Server`` run one script (hello,
  uploads at 1023/1024/1025 rows with nulls and a STRING column, the
  ``CHAIN`` plan of ``tests/test_serving.py`` with ``donate``, a ragged
  stream, download, free, stats) and give equal downloaded 5-tuples and
  equal response headers, apart from the fields ``_VOLATILE`` names.
* A seeded sequence of submits gives the same pick order from both
  ``FairScheduler._next``; ``estimate_request_bytes`` and a session's
  admit/release/donation-credit stats are equal.
* Each typed error's ``type`` is equal under the same trigger.
* Both resident registries are unchanged after each test.
"""

import json
import socket
import threading

import numpy as np
import pytest

from spark_rapids_jni_tpu import pipeline as jpipeline
from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu import serving as jserving
from spark_rapids_jni_tpu.serving import frames as jframes
from spark_rapids_jni_tpu.serving import scheduler as jscheduler
from spark_rapids_jni_tpu.serving import session as jsession
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu.utils import faults as jfaults
from spark_rapids_jni_tpu_torch import pipeline
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch import serving
from spark_rapids_jni_tpu_torch.serving import frames, scheduler, session
from spark_rapids_jni_tpu_torch.utils import config, faults

I64, F64, B8, STR = 4, 10, 11, 23

CHAIN = [
    {"op": "filter", "mask": 2},
    {"op": "cast", "column": 1, "type_id": F64},
    {"op": "sort_by", "keys": [{"column": 0}]},
]

# response fields that name a session or a port, or time something
_VOLATILE = ("session", "port", "queue_wait", "latency", "created",
             "breaker", "planstats", "spill", "resident_tables",
             "sessions_served")

FLAGS = ("HBM_BUDGET_GB", "SERVE_QUEUE_DEPTH", "SERVE_MAX_SESSIONS",
         "SERVE_SESSION_HBM_FRACTION", "SERVE_PORT", "DEADLINE_DEFAULT_S")


def _string_wire(strings):
    payload = b"".join(s.encode() for s in strings)
    offs = np.zeros(len(strings) + 1, np.int32)
    np.cumsum([len(s.encode()) for s in strings], out=offs[1:])
    return offs.tobytes() + payload


def _batch(n: int, seed: int = 0):
    """int64 key, int64 value with nulls, BOOL8 mask, STRING payload."""
    rng = np.random.default_rng(n + 7919 * seed)
    k = rng.integers(0, 9, n, dtype=np.int64)
    v = rng.integers(-100, 100, n, dtype=np.int64)
    valid = (np.arange(n) % 5 != 0).astype(np.uint8)
    m = (v > 0).astype(np.uint8)
    strs = [("s" * (int(x) % 3 + 1)) for x in k]
    return ([I64, I64, B8, STR], [0, 0, 0, 0],
            [k.tobytes(), v.tobytes(), m.tobytes(), _string_wire(strs)],
            [None, valid.tobytes(), None, None], n)


def _norm(w):
    t, s, d, v, n = w
    return ([int(x) for x in t], [int(x) for x in s],
            [None if x is None else bytes(x) for x in d],
            [None if x is None else bytes(x) for x in v], int(n))


def _live():
    return len(rb._RESIDENT), jrb.resident_table_count()


@pytest.fixture(autouse=True)
def _registries_unchanged():
    before = _live()
    yield
    pipeline.drain()
    jpipeline.drain()
    for f in FLAGS:
        config.clear_flag(f)
        jconfig.clear_flag(f)
    assert _live() == before


@pytest.fixture(scope="module")
def servers():
    """One server of each package for the tests that need no fresh one."""
    with serving.serve(device="cpu", port=0) as port_srv, \
            jserving.serve(port=0) as jax_srv:
        yield {"port": port_srv, "jax": jax_srv}


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


class _Capture:
    def __init__(self):
        self.buf = bytearray()

    def sendall(self, b):
        self.buf += b


class _Replay:
    """A socket that replays ``data`` (both modules' reads: ``recv`` and
    ``recv_into``)."""

    def __init__(self, data):
        self.data = bytes(data)

    def recv(self, n):
        out, self.data = self.data[:n], self.data[n:]
        return out

    def recv_into(self, view, n):
        out = self.recv(n)
        view[:len(out)] = out
        return len(out)


_HEADERS = [
    {"cmd": "hello", "name": "a", "weight": 2.0, "deadline_s": 1.5},
    {"cmd": "plan", "plan": CHAIN, "tables": [1, 2], "donate": True,
     "traceparent": "00-" + "1" * 32 + "-" + "2" * 16 + "-01"},
    {"ok": False, "error": {"type": "busy", "message": "ünïcode"}},
]


@pytest.mark.parametrize("n", [0, 1, 1023, 1025])
def test_frames_bytes_are_equal(n):
    batches = [_batch(n), _batch(n + 3, seed=1)]
    for header in _HEADERS:
        metas, bufs = frames.batches_to_parts(batches)
        jmetas, jbufs = jframes.batches_to_parts(batches)
        assert metas == jmetas and bufs == jbufs
        hdr = dict(header, batches=metas)
        mine, theirs = _Capture(), _Capture()
        frames.send_frame(mine, hdr, bufs)
        jframes.send_frame(theirs, hdr, jbufs)
        assert bytes(mine.buf) == bytes(theirs.buf)
        for mod in (frames, jframes):
            got_hdr, payload = mod.recv_frame(_Replay(mine.buf))
            assert got_hdr == hdr
            got = [_norm(b) for b in mod.batches_from_parts(
                got_hdr["batches"], payload)]
            assert got == [_norm(b) for b in batches]


def test_frames_refuse_the_same_malformed_input():
    for blob in (b"\x00\x00\x00\x02ab", b"\x00\x00\x00\x08\x00\x00\x00\x09"
                 b"abcd", b"\x00\x00\x00\x06\x00\x00\x00\x02[]"):
        errs = []
        for mod in (frames, jframes):
            with pytest.raises((mod.ProtocolError, ConnectionError)) as ei:
                mod.recv_frame(_Replay(blob))
            errs.append((type(ei.value).__name__, str(ei.value)))
        assert errs[0] == errs[1]


# ---------------------------------------------------------------------------
# crossed clients
# ---------------------------------------------------------------------------


def _strip(resp):
    if isinstance(resp, dict):
        return {k: _strip(v) for k, v in resp.items()
                if k not in _VOLATILE and k != "_payload"}
    if isinstance(resp, list):
        return [_strip(v) for v in resp]
    return resp


def _script(client_cls, port):
    """Hello, uploads, a donating plan, downloads, a ragged stream, free
    and stats -> (response headers, downloaded 5-tuples)."""
    headers = []
    c = client_cls(port, name="tenant")
    rpc = c._rpc

    def recording(header, buffers=()):
        resp = rpc(header, buffers)
        headers.append(_strip(resp))
        return resp

    c._rpc = recording
    got = []
    with c:
        headers.append({"hello": {"name": c.name,
                                  "budget": c.budget_bytes,
                                  "depth": c.queue_depth}})
        ids = [c.upload(_batch(n)) for n in (1023, 1024, 1025)]
        outs = [c.plan(CHAIN, [t], donate=True) for t in ids]
        got += [_norm(c.download(t)) for t in outs]
        got += [_norm(b) for b in c.stream(
            CHAIN, [_batch(n, seed=2) for n in (1, 700, 1025, 3000)])]
        for t in outs:
            c.free(t)
        stats = c.stats()
        assert stats["sessions"][0]["tables"] == 0
    return headers, got


def test_crossed_clients_give_equal_bytes_and_headers(servers):
    want_bytes = [_norm(jrb.table_plan_wire(json.dumps(CHAIN), *_batch(n)))
                  for n in (1023, 1024, 1025)]
    runs = {
        "jax client, port server": _script(jserving.Client,
                                           servers["port"].port),
        "port client, jax server": _script(serving.Client,
                                           servers["jax"].port),
        "port client, port server": _script(serving.Client,
                                            servers["port"].port),
    }
    (h0, g0), *rest = runs.values()
    assert g0[:3] == want_bytes
    for headers, got in rest:
        assert got == g0
        assert headers == h0


# ---------------------------------------------------------------------------
# scheduler and session
# ---------------------------------------------------------------------------


def _pick_order(sched_mod, sess_mod, seed):
    sched = sched_mod.FairScheduler(workers=1, queue_depth=64,
                                    quantum_rows=1000)
    sessions = [sess_mod.Session(f"s{i}", f"s{i}", w, 1 << 30)
                for i, w in enumerate((1.0, 2.0, 0.5))]
    for s in sessions:
        sched.register(s)
    rng = np.random.default_rng(seed)
    n = 60
    for j in range(n):
        i = int(rng.integers(0, 3))
        sched.submit(sessions[i], lambda: None,
                     cost=int(rng.integers(1, 5000)), label=f"r{j}",
                     shed=False)
    order = []
    for _ in range(n):
        t = sched._next()
        order.append((t.session.id, t.label, t.cost))
    return order


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fair_scheduler_picks_in_the_same_order(seed):
    assert _pick_order(scheduler, session, seed) == _pick_order(
        jscheduler, jsession, seed)


@pytest.mark.parametrize("buckets", ["", "off"])
def test_session_budget_arithmetic_is_equal(buckets):
    config.set_flag("BUCKETS", buckets)
    jconfig.set_flag("BUCKETS", buckets)
    try:
        docs = []
        for mod in (session, jsession):
            ests = [mod.estimate_request_bytes(_batch(n))
                    for n in (1, 1023, 1025, 5000)]
            s = mod.Session("sid", "tenant", 1.5, sum(ests) + 100)
            charges = [s.admit(e, wait=False) for e in ests]
            credited = s.note_donation(ests[-1] // 3)

            class _T:
                charge = ests[1]

            t = _T()
            credited2 = s.note_donation(10 * ests[1], t)
            s.release(charges[0])
            with pytest.raises(mod.OverBudget) as ei:
                s.admit(sum(ests) * 4, wait=False)
            doc = s.to_doc()
            doc.pop("created", None)
            docs.append((ests, charges, credited, credited2, t.charge, doc,
                         str(ei.value)))
        assert docs[0] == docs[1]
    finally:
        config.clear_flag("BUCKETS")
        jconfig.clear_flag("BUCKETS")


# ---------------------------------------------------------------------------
# typed errors
# ---------------------------------------------------------------------------


def _trigger(kind, pkg, servers, monkeypatch):
    """Provoke ``kind`` against ``pkg``'s server; the raised error's
    wire ``type``."""
    srv_mod, conf = (serving, config) if pkg == "port" else (jserving,
                                                            jconfig)
    kw = {"device": "cpu"} if pkg == "port" else {}
    client = srv_mod.Client
    try:
        if kind == "busy":
            with srv_mod.serve(port=0, queue_depth=2, workers=1, **kw) as srv:
                with client(srv.port, name="shed") as c:
                    sess = srv._sessions[c.session]
                    gate = threading.Event()
                    held = [srv.scheduler.submit(sess, gate.wait, cost=1,
                                                 shed=False)]
                    held += [srv.scheduler.submit(sess, lambda: None, cost=1,
                                                  shed=False)
                             for _ in range(2)]
                    try:
                        c.stream(CHAIN, [_batch(64)])
                    finally:
                        gate.set()
                        for t in held:
                            t.result()
        elif kind == "over_budget":
            conf.set_flag("HBM_BUDGET_GB", 1e-6)
            with srv_mod.serve(port=0, **kw) as srv:
                with client(srv.port, name="greedy") as c:
                    c.stream(CHAIN, [_batch(4096)])
        elif kind == "session_limit":
            with srv_mod.serve(port=0, max_sessions=1, **kw) as srv:
                with client(srv.port, name="only"):
                    client(srv.port, name="extra").connect()
        elif kind == "draining":
            with srv_mod.serve(port=0, **kw) as srv:
                with client(srv.port, name="late") as c:
                    srv._draining = True
                    try:
                        c.stream(CHAIN, [_batch(8)])
                    finally:
                        srv._draining = False
        else:
            srv = servers[pkg]
            with client(srv.port, name=kind) as c:
                if kind == "unknown_table":
                    c.download(999)
                elif kind == "deadline_exceeded":
                    c.stream(CHAIN, [_batch(64)], deadline_s=1e-9)
                elif kind == "cancelled":
                    mod = faults if pkg == "port" else jfaults
                    tok = mod.CancelToken()
                    tok.cancel("cancelled by the test")
                    monkeypatch.setattr(srv, "_request_token",
                                        lambda header, sess: tok)
                    c.stream(CHAIN, [_batch(64)])
    except srv_mod.ServingError as e:
        return e.type, type(e).__name__
    finally:
        conf.clear_flag("HBM_BUDGET_GB")
    return None


@pytest.mark.parametrize("kind", ["busy", "over_budget", "session_limit",
                                  "unknown_table", "deadline_exceeded",
                                  "cancelled", "draining"])
def test_typed_errors_are_equal(kind, servers, monkeypatch):
    got = _trigger(kind, "port", servers, monkeypatch)
    monkeypatch.undo()
    want = _trigger(kind, "jax", servers, monkeypatch)
    monkeypatch.undo()
    assert got == want
    assert got[0] == kind
    # the shared servers keep serving after a refusal
    for pkg, mod in (("port", serving), ("jax", jserving)):
        with mod.Client(servers[pkg].port, name="after") as c:
            assert len(c.stream(CHAIN, [_batch(16)])) == 1


def test_socket_is_refused_after_stop():
    srv = serving.Server(device="cpu", port=0).start()
    port = srv.port
    srv.stop()
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2).close()
