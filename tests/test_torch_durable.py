"""The port's durable serving (``serving/durable.py``) and the spill
tier's checkpoint prefix against the JAX package's, on the CPU.

* Each package's ``read_journal`` reads the other's journal, equal
  records for equal appends, a torn tail at every cut and a corrupted
  record included.
* A checkpoint directory written by the JAX server restores in the
  port's server (``device="cpu"``) to the same downloaded bytes, and the
  reverse; the restored session resumes with its token.
* A corrupt payload quarantines the session in both.
* ``Manifest`` records are equal for the same served plans.
* A file under ``CHECKPOINT_DIR`` survives ``spill.reset()`` in both
  packages.
"""

import json
import os

import numpy as np
import pytest

from spark_rapids_jni_tpu import pipeline as jpipeline
from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu import serving as jserving
from spark_rapids_jni_tpu.serving import durable as jdurable
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu.utils import spill as jspill
from spark_rapids_jni_tpu_torch import pipeline
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch import serving
from spark_rapids_jni_tpu_torch.serving import durable
from spark_rapids_jni_tpu_torch.utils import config, spill

from test_torch_serving import CHAIN, _batch, _norm

FLAGS = ("DURABLE", "CHECKPOINT_DIR", "BUCKETS")
PKGS = {"port": (serving, durable, config, {"device": "cpu"}),
        "jax": (jserving, jdurable, jconfig, {})}


@pytest.fixture(autouse=True)
def _durable_env(tmp_path):
    before = (len(rb._RESIDENT), jrb.resident_table_count())
    for conf in (config, jconfig):
        conf.set_flag("DURABLE", "on")
        conf.set_flag("CHECKPOINT_DIR", str(tmp_path / "ckpt"))
    durable.reset()
    jdurable.reset()
    yield
    pipeline.drain()
    jpipeline.drain()
    for conf in (config, jconfig):
        for f in FLAGS:
            conf.clear_flag(f)
    assert (len(rb._RESIDENT), jrb.resident_table_count()) == before


_RECORDS = [
    {"t": "open", "name": "s", "weight": 1.5, "budget": 9, "token": "x"},
    {"t": "put", "local": 1, "bytes": 10, "file": "s-t1.npz"},
    {"t": "put", "local": 2, "bytes": 30, "file": "s-t2.npz", "drop": 1,
     "req": "r1", "resp": {"table": 2}},
    {"t": "free", "local": 2, "bytes": 30},
]


def _journal(mod, path):
    j = mod.Journal(str(path))
    for r in _RECORDS:
        j.append(r)
    j.close()
    return open(path, "rb").read()


def _read(mod, path):
    try:
        return mod.read_journal(str(path))
    except mod.CheckpointCorrupt as e:
        return ("corrupt", str(e))


def test_journals_are_equal_and_read_across(tmp_path):
    mine = _journal(durable, tmp_path / "port.wal")
    theirs = _journal(jdurable, tmp_path / "jax.wal")
    assert mine == theirs
    for path in (tmp_path / "port.wal", tmp_path / "jax.wal"):
        got = _read(durable, path)
        assert got == _read(jdurable, path)
        assert got[0] == _RECORDS and got[1] == 0


def test_torn_tails_and_corruption_read_the_same(tmp_path):
    blob = _journal(durable, tmp_path / "a.wal")
    cut_path = tmp_path / "cut.wal"
    for cut in range(len(blob)):
        cut_path.write_bytes(blob[:cut])
        assert _read(durable, cut_path) == _read(jdurable, cut_path), cut
    for at in (len(blob) // 3, len(blob) - 3):
        bad = bytearray(blob)
        bad[at] ^= 0x5A
        cut_path.write_bytes(bytes(bad))
        got = _read(durable, cut_path)
        assert got == _read(jdurable, cut_path)
    assert got[0] != "corrupt"  # a corrupt final record is a torn tail
    bad = bytearray(blob)
    bad[20] ^= 0x5A  # the first record's payload, more records after it
    cut_path.write_bytes(bytes(bad))
    got = _read(durable, cut_path)
    assert got[0] == "corrupt" and got == _read(jdurable, cut_path)


def _write_checkpoint(pkg):
    """A durable session of ``pkg``'s server: two uploads, a donating
    plan, one table freed; the client dies, then the server stops. ->
    (session, token, {local id: downloaded 5-tuple})."""
    srv_mod, _, _, kw = PKGS[pkg]
    with srv_mod.serve(port=0, **kw) as srv:
        c = srv_mod.Client(srv.port, name="durable").connect()
        ids = [c.upload(_batch(n, seed=3)) for n in (1023, 1025, 40)]
        out = c.plan(CHAIN, [ids[0]], donate=True)
        c.free(ids[2])
        want = {t: _norm(c.download(t)) for t in (ids[1], out)}
        sid, token = c.session, c.resume_token
        c.kill()
    return sid, token, want


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_checkpoint_restores_in_the_other_package(writer, reader):
    sid, token, want = _write_checkpoint(writer)
    srv_mod, dmod, _, kw = PKGS[reader]
    with srv_mod.serve(port=0, **kw) as srv:
        restore = srv.stats()["durability"]["restore"]
        assert restore["sessions"] == 1 and not restore["quarantined"]
        assert restore["warm_compiles"] >= 1
        with srv_mod.Client(srv.port, session=sid, resume=token) as c:
            got = {t: _norm(c.download(t)) for t in want}
            assert got == want
            fresh = c.upload(_batch(8))
            assert fresh not in want  # ids continue past the journal's
            for t in list(want) + [fresh]:
                c.free(t)
    assert dmod.stats_doc()["restore.tables"] == 2


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_corrupt_payload_quarantines_the_session(pkg, tmp_path):
    sid, token, want = _write_checkpoint(pkg)
    ckpt = tmp_path / "ckpt"
    payloads = sorted(p for p in os.listdir(ckpt) if p.endswith(".npz"))
    assert len(payloads) == 2
    (ckpt / payloads[0]).write_bytes(b"not a zip file")
    srv_mod, dmod, _, kw = PKGS[pkg]
    with srv_mod.serve(port=0, **kw) as srv:
        dur = srv.stats()["durability"]
        assert dur["quarantined_sessions"] == 1
        with pytest.raises(srv_mod.ServingQuarantined) as ei:
            srv_mod.Client(srv.port, session=sid, resume=token).connect()
        assert ei.value.type == "session_quarantined"
    assert os.path.exists(ckpt / f"{sid}.wal.quarantined")
    assert dmod.stats_doc()["restore.quarantined"] == 1


@pytest.mark.parametrize("buckets", ["", "off"])
def test_manifest_records_are_equal(buckets, tmp_path):
    config.set_flag("BUCKETS", buckets)
    jconfig.set_flag("BUCKETS", buckets)
    records = []
    for pkg, bridge, args in (("port", rb, ("cpu",)), ("jax", jrb, ())):
        (tmp_path / pkg).mkdir()
        man = PKGS[pkg][1].Manifest(str(tmp_path / pkg))
        for n in (1023, 1025):
            b = _batch(n)
            pad = bridge._plan_pad_to(CHAIN, n)
            t = bridge._table_from_wire(*b, *args, pad)
            man.note(CHAIN, [t], True)
            man.note(CHAIN, [t], True)  # deduped
        f64 = bridge._table_from_wire(
            [10], [0], [np.arange(5, dtype=np.float64).tobytes()], [None], 5,
            *args, None)
        man.note([{"op": "sort_by", "keys": [{"column": 0}]}], [f64], False)
        records.append(man.records())
        man.close()
    assert records[0] == records[1]
    assert len(records[0]) == 3
    assert json.dumps(records[0], sort_keys=True) == json.dumps(
        records[1], sort_keys=True)


@pytest.mark.parametrize("mod", [spill, jspill], ids=["port", "jax"])
def test_checkpoint_files_survive_a_spill_reset(mod, tmp_path):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir(exist_ok=True)
    keep = ckpt / "s-t1.npz"
    keep.write_bytes(b"checkpoint")
    scratch = tmp_path / "spill-file.npz"
    scratch.write_bytes(b"spill")
    mod._FILES.update({str(keep), str(scratch)})
    assert mod._checkpoint_prefix() == str(ckpt) + os.sep
    mod.reset()
    assert keep.exists() and not scratch.exists()
    assert str(keep) not in mod._FILES
