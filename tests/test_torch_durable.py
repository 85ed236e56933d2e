"""A database directory in the port: ``connect(path=d)`` creates or reopens
a cluster directory in the JAX package's on-disk format.

  * Cross-format, both ways: a directory the JAX package wrote (DDL and
    ``load_table``, TPC-H SF 0.01, 4 segments) opens in the port and
    returns the JAX package's rows for Q1, Q3 and Q6; a directory the port
    wrote opens in the JAX package and returns the same rows.
  * A reopen keeps the card's cost calibration (calibration.json), the
    feedback store's corrections (feedback.json), the resource groups
    (catalog.json) and a TCP user (the users file), and DROP TABLE.
  * A process killed (SIGKILL) between ``prepare_delta`` and
    ``commit_delta`` of a ``load_table`` leaves the reopened table wholly
    without that load; killed after the commit, with all of it — the
    shape of tests/test_crash_recovery.py's kill -9 tests, driven by
    ``load_table`` (INSERT waits for ROADMAP Queue 1 item 1b). The child
    parks on the ``dtx_after_prepare`` / ``dtx_after_commit`` fault
    points the store's commit passes.
  * A flipped byte in a segfile raises ``CorruptionError`` with the JAX
    package's cause for the same flip (the frame checksum), quarantines
    the file with its sidecar, and never returns rows.
"""

import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu.storage.corruption import CorruptionError as JCorruption
from greengage_tpu.utils import tpch as jtpch
from greengage_tpu_torch.planner import cost as C
from greengage_tpu_torch.runtime import auth
from greengage_tpu_torch.runtime.server import SqlClient, SqlServer
from greengage_tpu_torch.storage.corruption import CorruptionError
from greengage_tpu_torch.storage.manifest import Manifest
from greengage_tpu_torch.utils import tpch as ttpch
from greengage_tpu_torch.utils.plancorpus import TPCH22

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SF = 0.01
QUERIES = ("q1", "q3", "q6")


def _rows(db):
    return {q: db.sql(TPCH22[q]).rows() for q in QUERIES}


# ---- cross-format ---------------------------------------------------------

def test_a_jax_written_directory_opens_in_the_port(tmp_path, devices8):
    path = str(tmp_path / "jax")
    j = greengage_tpu.connect(path=path, numsegments=4)
    jtpch.load(j, SF)
    j.sql("analyze")
    want = _rows(j)
    j.close()
    t = greengage_tpu_torch.connect(path=path, device="cpu")
    try:
        assert t.numsegments == 4
        got = _rows(t)
        assert all(got[q] for q in QUERIES)
        assert got == want
        # and the port appends to it through its own delta commit
        n = t.sql("select count(*) from region").rows()[0][0]
        t.load_table("region", {"r_regionkey": np.array([99], np.int32),
                                "r_name": ["MOON"], "r_comment": ["x"]})
        assert t.sql("select count(*) from region").rows()[0][0] == n + 1
    finally:
        t.close()
    j = greengage_tpu.connect(path=path)
    assert j.sql("select r_name from region where r_regionkey = 99"
                 ).rows() == [("MOON",)]
    j.close()


def test_a_port_written_directory_opens_in_jax(tmp_path, devices8):
    path = str(tmp_path / "port")
    t = greengage_tpu_torch.connect(path=path, numsegments=4, device="cpu")
    ttpch.load(t, SF)
    t.sql("analyze")
    want = _rows(t)
    t.close()
    j = greengage_tpu.connect(path=path)
    try:
        assert j.numsegments == 4
        got = _rows(j)
        assert all(got[q] for q in QUERIES)
        assert got == want
    finally:
        j.close()


# ---- what a reopen keeps ---------------------------------------------------

def test_a_reopen_keeps_calibration_feedback_groups_and_users(tmp_path):
    path = str(tmp_path / "c")
    d = greengage_tpu_torch.connect(path=path, numsegments=4, device="cpu")
    try:
        d.sql("create table fb (i int, b int) distributed by (i)")
        d.load_table("fb", {"i": np.arange(500), "b": np.arange(500) % 7})
        d.sql("create table gone (a int) distributed by (a)")
        d.load_table("gone", {"a": np.arange(10)})
        d.sql("drop table gone")
        # the 3x-wrong filter: one run promotes its correction
        assert "rows=165" in d.sql("explain select count(*) from fb "
                                   "where b >= 0").plan_text
        d.sql("select count(*) from fb where b >= 0")
        assert d.feedback.gen == 1
        digests = json.loads(json.dumps(d.feedback.digests))
        d.sql("create resource group g1 with (concurrency=2, "
              "memory_limit_mb=64)")
        d.sql("alter resource group default_group set concurrency 7")
        cal = dict(C.CALIBRATION_DEFAULTS, ns_gather_row=0.0135)
        d.set_calibration(cal)
        auth.add_user(d.path, "alice", "s3cret")
    finally:
        d.close()
    C.set_calibration(None)
    assert C.NS_GATHER_ROW == C.CALIBRATION_DEFAULTS["ns_gather_row"]
    d = greengage_tpu_torch.connect(path=path, device="cpu")
    srv = None
    try:
        assert C.NS_GATHER_ROW == pytest.approx(0.0135)
        assert d.feedback.gen == 1
        assert d.feedback.digests == digests
        assert "rows=500" in d.sql("explain select count(*) from fb "
                                   "where b >= 0").plan_text
        groups = {g["name"]: g for g in d.resgroup_status()}
        assert groups["g1"]["concurrency"] == 2
        assert groups["default_group"]["concurrency"] == 7
        assert "gone" not in d.catalog
        with pytest.raises(Exception, match="gone"):
            d.sql("select * from gone")
        srv = SqlServer(d, str(tmp_path / "s.sock"), host="127.0.0.1",
                        port=0)
        srv.start()
        c = SqlClient(host="127.0.0.1", port=srv.port, user="alice",
                      password="s3cret")
        assert c.sql("select count(*) from fb")["rows"] == [[500]]
        c.close()
        d.set_calibration(None)
    finally:
        if srv is not None:
            srv.stop()
        d.close()
    assert not os.path.exists(os.path.join(path, "calibration.json"))
    assert os.path.isdir(path)   # close keeps a directory


def test_open_checks_width_and_refuses_mirrors(tmp_path):
    path = str(tmp_path / "w")
    greengage_tpu_torch.connect(path=path, numsegments=4,
                                device="cpu").close()
    with pytest.raises(ValueError, match="width mismatch"):
        greengage_tpu_torch.connect(path=path, numsegments=2, device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        greengage_tpu_torch.connect(path=str(tmp_path / "m"), mirrors=True,
                                    device="cpu")


# ---- kill -9 around a load's commit ----------------------------------------

CHILD = r"""
import os, sys
sys.path.insert(0, sys.argv[2])
import numpy as np
import greengage_tpu_torch
from greengage_tpu_torch.runtime.faultinject import faults
db = greengage_tpu_torch.connect(sys.argv[1], device="cpu")
faults.inject(sys.argv[3], "sleep", sleep_s=120)
print("LOADING", flush=True)
db.load_table("t", {"k": np.arange(1000, 1050), "v": np.arange(50)})
print("LOADED", flush=True)
"""


def _staged_uncommitted(path):
    m = Manifest(path)
    committed = m._compose()["seqs"]
    out = []
    for fn in os.listdir(os.path.join(path, "deltas")) \
            if os.path.isdir(os.path.join(path, "deltas")) else []:
        if fn.endswith(".delta"):
            stem, seq = fn[:-len(".delta")].rsplit(".", 1)
            if int(seq) > int(committed.get(stem, 0)):
                out.append(fn)
    return out


def _committed_lines(path):
    try:
        with open(os.path.join(path, "commits.log")) as f:
            return [json.loads(x) for x in f if x.strip()]
    except OSError:
        return []


def _kill_child_when(path, fault, ready):
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.Popen([sys.executable, "-c", CHILD, path, REPO, fault],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         env=env)
    try:
        deadline = time.monotonic() + 120
        while not ready():
            assert p.poll() is None, p.communicate()
            assert time.monotonic() < deadline, "child never reached it"
            time.sleep(0.05)
        time.sleep(0.2)     # parked on the fault point's sleep
        assert p.poll() is None
    finally:
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=30)
    assert p.returncode == -signal.SIGKILL


def _setup(path):
    d = greengage_tpu_torch.connect(path=path, numsegments=4, device="cpu")
    d.sql("create table t (k int, v int) distributed by (k)")
    d.load_table("t", {"k": np.arange(100), "v": np.arange(100)})
    d.close()


def test_kill9_between_prepare_and_commit_leaves_no_part_of_the_load(
        tmp_path):
    path = str(tmp_path / "c")
    _setup(path)
    _kill_child_when(path, "dtx_after_prepare",
                     lambda: bool(_staged_uncommitted(path)))
    assert _staged_uncommitted(path)        # the claim is in doubt
    segfiles = glob.glob(os.path.join(path, "data", "t", "seg*", "*.ggb"))
    assert len(segfiles) > 8                # the load's files were staged
    d = greengage_tpu_torch.connect(path=path, device="cpu")
    try:
        assert not _staged_uncommitted(path)     # recover() rolled it back
        assert d.sql("select count(*), sum(v) from t").rows() == [
            (100, sum(range(100)))]
        # the released claim admits the next load
        d.load_table("t", {"k": np.arange(200, 210), "v": np.arange(10)})
        assert d.sql("select count(*) from t").rows() == [(110,)]
    finally:
        d.close()


def test_kill9_after_the_commit_keeps_the_whole_load(tmp_path):
    path = str(tmp_path / "c")
    _setup(path)
    # the setup's own commit line is in the log until the child's open
    # folds it: wait for a line past its sequence
    base = int(Manifest(path)._compose()["seqs"]["t"])
    _kill_child_when(path, "dtx_after_commit",
                     lambda: any(int((ln.get("t") or {}).get("t", 0)) > base
                                 for ln in _committed_lines(path)))
    d = greengage_tpu_torch.connect(path=path, device="cpu")
    try:
        assert d.sql("select count(*), sum(v) from t").rows() == [
            (150, sum(range(100)) + sum(range(50)))]
        assert d.sql("select count(*) from t where k >= 1000").rows() == [
            (50,)]
    finally:
        d.close()


# ---- a flipped byte ---------------------------------------------------------

def _flip(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(40)          # inside the first frame's payload
        b = f.read(1)
        f.seek(40)
        f.write(bytes([b[0] ^ 0xFF]))
    return size


def test_a_flipped_segfile_byte_raises_the_references_cause(tmp_path,
                                                          devices8):
    path = str(tmp_path / "c")
    d = greengage_tpu_torch.connect(path=path, numsegments=4, device="cpu")
    d.sql("create table t (k bigint, v bigint) distributed by (k)")
    d.load_table("t", {"k": np.arange(5000), "v": np.arange(5000) * 3})
    d.close()
    jpath = str(tmp_path / "jcopy")
    shutil.copytree(path, jpath)
    rel = sorted(glob.glob(os.path.join(path, "data", "t", "seg1",
                                        "v.*.ggb")))[0]
    _flip(rel)
    _flip(os.path.join(jpath, os.path.relpath(rel, path)))

    d = greengage_tpu_torch.connect(path=path, device="cpu")
    try:
        with pytest.raises(CorruptionError) as ei:
            d.sql("select sum(v) from t")
        cause = ei.value.cause
        assert ei.value.table == "t" and ei.value.content == 1
        qdir = os.path.join(path, ".quarantine")
        sidecars = glob.glob(os.path.join(qdir, "*.json"))
        assert len(sidecars) == 1
        with open(sidecars[0]) as f:
            assert json.load(f)["cause"] == cause
        assert not os.path.exists(rel)
        assert not d.store.storage_ok(1)
        # the file is gone now: the next read names it missing, never rows
        with pytest.raises(CorruptionError) as ei2:
            d.sql("select sum(v) from t")
        assert ei2.value.cause == "missing"
    finally:
        d.close()
    j = greengage_tpu.connect(path=jpath)
    try:
        with pytest.raises(JCorruption) as je:
            j.sql("select sum(v) from t")
        assert je.value.cause == cause == "crc_mismatch"
    finally:
        j.close()
