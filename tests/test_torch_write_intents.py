"""Write-intent commits in the port against the JAX package:
tests/test_write_intents.py replayed.

Same-table appenders (INSERT) stage per-writer intent records and resolve
into one fsynced merge line each, with zero per-table claim retries;
readers see monotone committed snapshots; a DELETE racing the appends is
fenced by the intent sequence and retried on the fresh snapshot, so no
appended row is lost; a stale bitmap transaction meets ``IntentConflict``;
an in-doubt intent is invisible and swept by ``recover()``; the fold keeps
intent merges. The storms run at 4 appenders x 6 rows (the JAX file's 8 x
8, cut so each test finishes in seconds on the CPU), and each test's final
rows are held to the JAX package's after the same statements. Beside the
replay, a process killed (SIGKILL) after staging its intent leaves the
reopened table without the append, and one killed after the merge line is
durable keeps it. Every thread is joined with a timeout in a ``finally``;
counters are read as deltas.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import pytest

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu_torch.runtime.logger import counters
from greengage_tpu_torch.storage.manifest import IntentConflict, Manifest
from torch_breadth import assert_rows_match

APPENDERS = 4
ROWS_EACH = 6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def db(tmp_path):
    d = greengage_tpu_torch.connect(str(tmp_path / "c"), numsegments=4,
                                    device="cpu")
    d.sql("create table hot (k int, v double precision) distributed by (k)")
    yield d
    d.close()


def _storm(db, nthreads=APPENDERS, rows=ROWS_EACH, base=0):
    errs = []

    def appender(w):
        try:
            for i in range(rows):
                db.sql(f"insert into hot values ({base + w * 1000 + i}, "
                       f"{w}.5)")
        except Exception as e:   # reported by the caller
            errs.append(e)

    ts = [threading.Thread(target=appender, args=(w,))
          for w in range(nthreads)]
    try:
        for t in ts:
            t.start()
    finally:
        for t in ts:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    return errs


def _jax_rows(tmp_path, statements):
    """The JAX package's rows of ``hot`` after the same statements."""
    j = greengage_tpu.connect(str(tmp_path / "j"), numsegments=4)
    j.sql("create table hot (k int, v double precision) distributed by (k)")
    for text in statements:
        j.sql(text)
    return j.sql("select k, v from hot order by k").rows()


def _storm_statements(nthreads=APPENDERS, rows=ROWS_EACH, base=0):
    return [f"insert into hot values ({base + w * 1000 + i}, {w}.5)"
            for w in range(nthreads) for i in range(rows)]


def test_appenders_one_table_zero_retries(db, tmp_path, devices8):
    base = counters.snapshot()
    errs = _storm(db)
    assert not errs, errs
    d = counters.since(base)
    assert d.get("manifest_cas_retry_total", 0) == 0
    assert d.get("manifest_intent_conflict_total", 0) == 0
    assert d.get("manifest_intent_commits", 0) == APPENDERS * ROWS_EACH
    assert db.sql("select count(distinct k) from hot").rows()[0][0] \
        == APPENDERS * ROWS_EACH
    assert_rows_match(db.sql("select k, v from hot order by k").rows(),
                      _jax_rows(tmp_path, _storm_statements()))


def test_readers_see_consistent_snapshots_during_storm(db):
    stop = threading.Event()
    seen, errs = [], []

    def reader():
        try:
            while not stop.is_set():
                seen.append(int(
                    db.sql("select count(*) from hot").rows()[0][0]))
        except Exception as e:   # reported below
            errs.append(e)

    rt = threading.Thread(target=reader)
    try:
        rt.start()
        werrs = _storm(db)
    finally:
        stop.set()
        rt.join(timeout=120)
    assert not rt.is_alive()
    assert not errs and not werrs, (errs, werrs)
    assert seen == sorted(seen)          # snapshots never move backwards
    assert seen[-1] <= APPENDERS * ROWS_EACH


def test_delete_arbitrates_against_concurrent_appends(db, tmp_path,
                                                      devices8):
    first = ("insert into hot values "
             + ",".join(f"({i}, 0.0)" for i in range(20)))
    db.sql(first)
    errs = []

    def deleter():
        try:
            db.sql("delete from hot where k < 20")
        except Exception as e:   # reported below
            errs.append(e)

    dt = threading.Thread(target=deleter)
    try:
        dt.start()
        werrs = _storm(db, base=100000)
    finally:
        dt.join(timeout=120)
    assert not dt.is_alive()
    assert not errs and not werrs, (errs, werrs)
    assert db.sql("select count(*) from hot").rows()[0][0] \
        == APPENDERS * ROWS_EACH
    assert db.sql("select count(*) from hot where k < 20").rows()[0][0] == 0
    assert_rows_match(
        db.sql("select k, v from hot order by k").rows(),
        _jax_rows(tmp_path, [first, "delete from hot where k < 20"]
                  + _storm_statements(base=100000)))


def test_stale_delmask_base_gets_typed_conflict(db):
    db.sql("insert into hot values (1, 1.0), (2, 2.0)")
    m = db.store.manifest
    tx = m.begin()                        # the snapshot BEFORE the append
    db.sql("insert into hot values (3, 3.0)")     # an intent merge lands
    tx["tables"]["hot"] = dict(tx["tables"]["hot"])
    base = counters.snapshot()
    with pytest.raises(IntentConflict):
        m.prepare_delta(tx, ["hot"])
    assert counters.since(base).get("manifest_intent_conflict_total") == 1


def test_in_doubt_intent_rolls_back_and_sweeps(db, tmp_path):
    db.sql("insert into hot values (1, 1.0)")
    m = db.store.manifest
    handle = m.stage_intent("hot", [(0, ["seg0/ghost.ggb"], 5)])
    idir = os.path.join(str(tmp_path / "c"), "intents")
    assert any(f.endswith(".intent") for f in os.listdir(idir))
    assert db.sql("select count(*) from hot").rows()[0][0] == 1
    base = counters.snapshot()
    db.sql("insert into hot values (2, 2.0)")
    assert counters.since(base).get("manifest_cas_retry_total", 0) == 0
    assert m.recover() == []
    assert counters.since(base).get("manifest_intent_swept_total", 0) >= 1
    assert not any(f.endswith(".intent") for f in os.listdir(idir))
    with pytest.raises(IntentConflict):
        m.commit_intent(handle)


def test_fold_preserves_intent_merges(db, tmp_path, devices8):
    errs = _storm(db, nthreads=4, rows=4)
    assert not errs
    v_before = db.store.manifest.version()
    db.store.manifest.fold(min_deltas=0)
    m2 = Manifest(db.path)               # fresh object: no memo, no cache
    assert m2.version() == db.store.manifest.version() >= v_before
    assert db.sql("select count(*) from hot").rows()[0][0] == 16
    db.sql("delete from hot where v > 100")      # the fence after the fold
    assert db.sql("select count(*) from hot").rows()[0][0] == 16
    assert_rows_match(db.sql("select k, v from hot order by k").rows(),
                      _jax_rows(tmp_path, _storm_statements(4, 4)))


def test_the_jax_package_reads_the_ports_merge_lines(db, tmp_path,
                                                     devices8):
    """A directory whose rows arrived through the port's intent merges
    (before any fold) opens in the JAX package with the same rows."""
    errs = _storm(db, nthreads=2, rows=3)
    assert not errs
    lines = open(os.path.join(db.path, "commits.log")).read()
    assert '"w"' in lines
    got = db.sql("select k, v from hot order by k").rows()
    db.close()
    j = greengage_tpu.connect(path=str(tmp_path / "c"))
    assert_rows_match(got, j.sql("select k, v from hot order by k").rows())


CHILD = r"""
import sys
sys.path.insert(0, sys.argv[2])
import greengage_tpu_torch
from greengage_tpu_torch.runtime.faultinject import faults
db = greengage_tpu_torch.connect(sys.argv[1], device="cpu")
faults.inject(sys.argv[3], "sleep", sleep_s=120,
              start_after=int(sys.argv[4]))
print("LOADING", flush=True)
db.sql("insert into hot values (900, 9.5), (901, 9.5), (902, 9.5)")
print("LOADED", flush=True)
"""


def _kill_child_when(path, fault, start_after, ready):
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.Popen([sys.executable, "-c", CHILD, path, REPO, fault,
                          str(start_after)],
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


def _intents(path):
    d = os.path.join(path, "intents")
    return [f for f in os.listdir(d) if f.endswith(".intent")] \
        if os.path.isdir(d) else []


def _merge_lines(log):
    try:
        with open(log) as f:
            return f.read().count('"w"')
    except OSError:
        return 0


@pytest.mark.parametrize("window", ["staged", "merged"])
def test_kill9_around_an_intent_commit(tmp_path, window):
    """Killed with its intent staged (``intent_stage``): the reopened
    table has none of the append and the intent is swept. Killed after
    its merge line is durable (the second ``intent_resolve``): all of
    it."""
    path = str(tmp_path / "c")
    d = greengage_tpu_torch.connect(path=path, numsegments=4, device="cpu")
    d.sql("create table hot (k int, v double precision) distributed by (k)")
    d.sql("insert into hot values (1, 1.0), (2, 2.0)")
    d.close()
    # compacted: the setup's merge line folds into the root, so the log's
    # next merge line is the child's
    Manifest(path).recover()
    log = os.path.join(path, "commits.log")
    assert _merge_lines(log) == 0
    if window == "staged":
        _kill_child_when(path, "intent_stage", 0,
                         lambda: bool(_intents(path)))
        assert _intents(path)            # in doubt
    else:
        _kill_child_when(path, "intent_resolve", 1,
                         lambda: _merge_lines(log) > 0)
    t = greengage_tpu_torch.connect(path=path, device="cpu")
    try:
        assert not _intents(path)        # recover() swept it
        want = 2 if window == "staged" else 5
        assert t.sql("select count(*) from hot").rows()[0][0] == want
        t.sql("insert into hot values (3, 3.0)")
        assert t.sql("select count(*) from hot").rows()[0][0] == want + 1
    finally:
        t.close()
