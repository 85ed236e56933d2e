"""Overload armor in the port: tests/test_overload.py replayed on
greengage_tpu_torch (runtime/server.py, runtime/overload.py,
runtime/resqueue.py): the bounded front end (connection cap, auth
deadline, frame cap), typed admission load shedding, the brownout state
machine, watcher reuse and transient-error classification, and graceful
drain; the storm keeps the JAX file's ``slow`` mark.

A port Database on the CPU (``device="cpu"``) with the JAX test's table,
loaded with ``load_table`` where the JAX test INSERTs. What differs from
the JAX file: the port has no block cache (ROADMAP Queue 1 item 1a), so
the brownout test reads ``cache_factor()`` where the JAX test reads the
cache's budget, and the ``gg ps`` banner (the CLI, item 11) is not
checked. Every test resets the controller and the faults; counters are
read as deltas.
"""

import errno
import json
import socket
import threading
import time

import numpy as np
import pytest

import greengage_tpu_torch
from greengage_tpu_torch.runtime import overload
from greengage_tpu_torch.runtime import server as server_mod
from greengage_tpu_torch.runtime.faultinject import faults
from greengage_tpu_torch.runtime.logger import counters
from greengage_tpu_torch.runtime.resqueue import AdmissionShed
from greengage_tpu_torch.runtime.server import (SqlClient, SqlServer,
                                                _watch_tick)


@pytest.fixture()
def db():
    d = greengage_tpu_torch.connect(numsegments=2, device="cpu")
    d.sql("create table t (a int, v int) distributed by (a)")
    d.load_table("t", {"a": np.array([1, 2, 3], dtype=np.int32),
                       "v": np.array([10, 20, 30], dtype=np.int32)})
    yield d
    faults.reset()
    overload.CONTROLLER.reset()
    d.close()


@pytest.fixture()
def served(db, tmp_path):
    sock = str(tmp_path / "s.sock")
    srv = SqlServer(db, sock, host="127.0.0.1", port=0)
    srv.start()
    yield db, srv, sock
    faults.reset()
    overload.CONTROLLER.reset()
    srv.stop()


def _raw_unix(sock_path):
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.connect(sock_path)
    return s, s.makefile("rwb")


# ---------------------------------------------------------------------
# layer 1: the bounded front end
# ---------------------------------------------------------------------

def test_connection_cap_typed_rejection(served):
    d, srv, sock = served
    d.sql("set max_connections = 1")
    c0 = counters.get("connections_shed_total")
    c1 = SqlClient(sock)                      # holds the only slot
    assert c1.sql("select count(*) from t")["rows"] == [[3]]
    s, f = _raw_unix(sock)                    # over cap: typed fast-fail
    resp = json.loads(f.readline())
    assert resp["ok"] is False
    assert resp["code"] == "too_many_connections"
    assert resp["sqlstate"] == "53300"
    assert resp["retryable"] is True
    assert f.readline() == b""                # and the socket closes
    s.close()
    assert counters.get("connections_shed_total") == c0 + 1
    c1.close()
    # released slot admits again
    time.sleep(0.1)
    c2 = SqlClient(sock)
    assert c2.sql("select 1")["rows"] == [[1]]
    c2.close()


def test_overload_accept_fault_forces_shed(served):
    _, _, sock = served
    faults.inject("overload_accept", "skip", occurrences=1)
    s, f = _raw_unix(sock)
    resp = json.loads(f.readline())
    assert resp["code"] == "too_many_connections"
    s.close()
    # the next connect (fault spent) admits normally
    c = SqlClient(sock)
    assert c.sql("select 1")["rows"] == [[1]]
    c.close()


def test_frame_too_large_typed_close(served):
    d, _, sock = served
    d.sql("set max_frame_bytes = 4096")
    s, f = _raw_unix(sock)
    f.write(b'{"sql": "' + b"x" * 8192 + b'"}\n')
    f.flush()
    resp = json.loads(f.readline())
    assert resp["ok"] is False and resp["code"] == "frame_too_large"
    # cannot resync: the server closes (EOF, or a reset when our unread
    # tail was still in its buffer — both mean "connection over")
    try:
        rest = f.readline()
    except OSError:
        rest = b""
    assert rest == b""
    s.close()
    assert counters.get("frames_rejected_total") >= 1


def test_auth_deadline_closes_silent_peer(served):
    d, srv, _ = served
    d.sql("set client_auth_deadline_s = 0.3")
    t0 = time.monotonic()
    s = socket.create_connection(("127.0.0.1", srv.port))
    f = s.makefile("rwb")
    # send NOTHING: the handshake read must time out server-side
    assert f.readline() == b""                # EOF, not a hang
    assert time.monotonic() - t0 < 3.0
    s.close()


def test_idle_timeout_typed_close(served):
    d, _, sock = served
    d.sql("set client_idle_timeout_s = 0.3")
    s, f = _raw_unix(sock)
    f.write(b'{"sql": "select 1"}\n')
    f.flush()
    assert json.loads(f.readline())["ok"] is True
    t0 = time.monotonic()
    resp = json.loads(f.readline())           # idle: server speaks first
    assert resp["code"] == "idle_timeout"
    assert f.readline() == b""
    assert time.monotonic() - t0 < 3.0
    s.close()


# ---------------------------------------------------------------------
# watcher: one thread per connection; transient errors never cancel
# ---------------------------------------------------------------------

def test_watcher_reused_across_pipelined_statements(served):
    _, _, sock = served
    c = SqlClient(sock)
    c.sql("select 1")
    watchers = [t for t in threading.enumerate()
                if t.name == "gg-client-watch"]
    assert len(watchers) == 1
    first = watchers[0]
    for _ in range(30):
        c.sql("select 1")
    watchers = [t for t in threading.enumerate()
                if t.name == "gg-client-watch"]
    assert watchers == [first]                # same thread, not 30 new ones
    c.close()
    time.sleep(0.3)
    assert not first.is_alive()               # shut down with its connection


def test_watch_tick_classifies_oserrors():
    class _Boom:
        def __init__(self, err):
            self._err = err

        def fileno(self):
            raise self._err

        def recv(self, *a):
            raise self._err

    # transient poll failures (ENOMEM, EINTR-ish) must NOT read as EOF
    assert _watch_tick(_Boom(OSError(errno.ENOMEM, "boom"))) == "transient"
    # errnos proving the peer/fd is gone DO read as EOF
    assert _watch_tick(_Boom(OSError(errno.EBADF, "gone"))) == "eof"
    assert _watch_tick(_Boom(OSError(errno.ECONNRESET, "rst"))) == "eof"
    # a closed-socket ValueError (fileno == -1 after close) is EOF too
    sp_a, sp_b = socket.socketpair()
    sp_a.close()
    assert _watch_tick(sp_a) == "eof"
    sp_b.close()


def test_transient_select_failure_does_not_cancel(served, monkeypatch):
    """Regression (satellite): the old _watch_client treated ANY OSError
    from select as a client EOF and cancelled a live client's statement.
    With select failing transiently for the whole statement, the
    statement must complete."""
    _, _, sock = served

    class _FlakySelect:
        @staticmethod
        def select(*a, **kw):
            raise OSError(errno.ENOMEM, "spurious poll failure")

    monkeypatch.setattr(server_mod, "select", _FlakySelect)
    # slow the statement so the watcher polls (and fails) several times
    faults.inject("cancel_before_dispatch", "sleep", sleep_s=0.5,
                  occurrences=1)
    c = SqlClient(sock)
    resp = c.op({"sql": "select count(*) from t"})
    assert resp["ok"] is True and resp["rows"] == [[3]]
    assert "cancelled" not in resp
    c.close()


def test_watcher_still_cancels_real_disconnect(served):
    """The transient-classification fix must not break the real thing:
    a client that vanishes mid-statement still flags client_gone."""
    d, _, sock = served
    faults.inject("cancel_before_dispatch", "sleep", sleep_s=0.6,
                  occurrences=1)
    s, f = _raw_unix(sock)
    f.write(b'{"sql": "select count(*) from t"}\n')
    f.flush()
    time.sleep(0.2)
    f.close()                                 # vanish mid-statement (the
    s.close()                                 # makefile dup holds the fd)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if counters.get("statements_cancelled_client_gone") >= 1:
            break
        time.sleep(0.05)
    assert counters.get("statements_cancelled_client_gone") >= 1


# ---------------------------------------------------------------------
# layer 2: admission load shedding
# ---------------------------------------------------------------------

def test_admission_queue_shed_typed_error(db):
    db.sql("set resource_queue_active = 1")
    db.sql("set admission_queue_limit = 1")
    c0 = counters.get("admission_shed_total")
    # holder occupies the single slot, parked at the pre-dispatch fault
    faults.inject("cancel_before_dispatch", "sleep", sleep_s=1.2,
                  occurrences=1)
    errs = []

    def run(i):
        try:
            db.sql("select count(*) from t")
        except Exception as e:
            errs.append((i, e))

    t1 = threading.Thread(target=run, args=(1,))   # holder (admitted)
    t1.start()
    time.sleep(0.3)
    t2 = threading.Thread(target=run, args=(2,))   # waiter (depth 1)
    t2.start()
    time.sleep(0.3)
    with pytest.raises(AdmissionShed) as ei:       # depth at cap: shed
        db.sql("select count(*) from t")
    assert ei.value.retryable is True
    assert ei.value.sqlstate == "53300"
    t1.join(timeout=30)
    t2.join(timeout=30)
    assert not errs, errs                          # holder+waiter succeed
    assert counters.get("admission_shed_total") == c0 + 1
    db.sql("set resource_queue_active = 0")
    db.sql("set admission_queue_limit = 0")


def test_server_maps_shed_to_retryable_frame(served):
    d, _, sock = served
    d.sql("set resource_queue_active = 1")
    d.sql("set admission_queue_limit = 1")
    faults.inject("cancel_before_dispatch", "sleep", sleep_s=1.2,
                  occurrences=1)
    holder = SqlClient(sock)
    waiter = SqlClient(sock)
    shed = SqlClient(sock)
    results = {}

    def go(name, cli):
        results[name] = cli.op({"sql": "select count(*) from t"})

    ts = [threading.Thread(target=go, args=(n, c))
          for n, c in (("holder", holder),)]
    ts[0].start()
    time.sleep(0.3)
    ts.append(threading.Thread(target=go, args=("waiter", waiter)))
    ts[1].start()
    time.sleep(0.3)
    go("shed", shed)                          # depth at cap: typed frame
    for t in ts:
        t.join(timeout=30)
    assert results["holder"]["ok"] and results["waiter"]["ok"]
    assert results["shed"]["ok"] is False
    assert results["shed"]["code"] == "admission_shed"
    assert results["shed"]["sqlstate"] == "53300"
    assert results["shed"]["retryable"] is True
    for c in (holder, waiter, shed):
        c.close()
    d.sql("set resource_queue_active = 0")
    d.sql("set admission_queue_limit = 0")


def test_resgroup_path_sheds_too(db):
    db.sql("set resource_group_global_active = 1")
    db.sql("set admission_queue_limit = 1")
    faults.inject("cancel_before_dispatch", "sleep", sleep_s=1.0,
                  occurrences=1)
    errs = []

    def run():
        try:
            db.sql("select count(*) from t")
        except Exception as e:
            errs.append(e)

    t1 = threading.Thread(target=run)
    t1.start()
    time.sleep(0.3)
    t2 = threading.Thread(target=run)
    t2.start()
    time.sleep(0.3)
    with pytest.raises(AdmissionShed):
        db.sql("select count(*) from t")
    t1.join(timeout=30)
    t2.join(timeout=30)
    assert not errs, errs
    db.sql("set resource_group_global_active = 0")
    db.sql("set admission_queue_limit = 0")


# ---------------------------------------------------------------------
# layer 3: the brownout state machine
# ---------------------------------------------------------------------

def test_brownout_enter_effects_and_hysteresis(db):
    ctl = overload.CONTROLLER
    e0 = counters.get("brownout_entered_total")
    x0 = counters.get("brownout_exited_total")
    faults.inject("brownout_force", "skip", occurrences=-1)
    assert ctl.evaluate(db.settings, force=True) is True
    # gauge + counters
    assert counters.get("brownout") == 1
    assert counters.get("brownout_entered_total") == e0 + 1
    # the block-cache budget factor (brownout_cache_factor, 0.5 default;
    # the JAX test reads the cache's budget, item 1a here)
    assert ctl.cache_factor() == 0.5
    # batch serving disabled while browned out
    db.sql("set batch_serving_enabled = on")
    assert db._batch_eligible({"@params@": [1]}) is False
    # admission ceiling scaled (spill-tier preference)
    assert ctl.scaled_vmem(1 << 30) == (1 << 30) // 2
    # statements still execute (degraded, not dead)
    assert db.sql("select count(*) from t").rows() == [(3,)]
    # HYSTERESIS: pressure cleared but the dwell has not elapsed — the
    # state must hold
    faults.reset("brownout_force")
    db.sql("set brownout_exit_s = 30")
    assert ctl.evaluate(db.settings, force=True) is True
    assert counters.get("brownout") == 1
    # dwell satisfied (exit_s = 0): clean exit restores everything
    db.sql("set brownout_exit_s = 0")
    assert ctl.evaluate(db.settings, force=True) is False
    assert counters.get("brownout") == 0
    assert counters.get("brownout_exited_total") == x0 + 1
    assert ctl.cache_factor() == 1.0
    assert ctl.scaled_vmem(1 << 30) == 1 << 30
    assert db._batch_eligible({"@params@": [1]}) is True
    db.sql("set batch_serving_enabled = off")


def test_brownout_oom_streak_trigger(db):
    ctl = overload.CONTROLLER
    db.sql("set brownout_oom_events = 2")
    db.sql("set brownout_window_s = 30")
    assert ctl.evaluate(db.settings, force=True) is False
    counters.inc("oom_events", 2)             # two classified OOMs
    assert ctl.evaluate(db.settings, force=True) is True
    snap = ctl.snapshot()
    assert snap["brownout"] and "OOM" in snap["reason"]
    db.sql("set brownout_exit_s = 0")
    db.sql("set brownout_oom_events = 1000")  # clear the signal
    assert ctl.evaluate(db.settings, force=True) is False


def test_brownout_disabled_guc_wins(db):
    db.sql("set brownout_enabled = off")
    faults.inject("brownout_force", "skip", occurrences=-1)
    assert overload.CONTROLLER.evaluate(db.settings, force=True) is False
    db.sql("set brownout_enabled = on")


def test_brownout_visible_in_status_and_ps(served):
    d, srv, sock = served
    d.sql("set brownout_exit_s = 0")
    faults.inject("brownout_force", "skip", occurrences=-1)
    c = SqlClient(sock)
    st = c.op({"op": "status"})               # status evaluates fresh
    assert st["overload"]["brownout"] is True
    assert st["overload"]["batch_serving_disabled"] is True
    assert st["cluster"]["counters"].get("brownout") == 1
    ps = c.op({"op": "ps"})
    assert ps["overload"]["brownout"] is True
    c.close()
    faults.reset("brownout_force")


# ---------------------------------------------------------------------
# batch-pipeline member cap
# ---------------------------------------------------------------------

def test_batch_queue_limit_sheds_to_serial(db):
    db.sql("set batch_serving_enabled = on")
    db.sql("set batch_queue_limit = 1")
    db.sql("select count(*) from t where a > 1")   # create the pipeline
    bs = db._batch_server
    assert bs is not None
    c0 = counters.get("batch_members_shed_total")
    # hold the dispatcher so a window would accumulate, then exceed the
    # member cap: submit must return None (classic path) not enqueue
    faults.inject("batch_dispatch", "sleep", sleep_s=0.3, occurrences=1)
    res = {}

    def q(i):
        res[i] = db.sql(f"select count(*) from t where a > {i}").rows()

    ts = [threading.Thread(target=q, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert len(res) == 3                       # every statement answered
    assert counters.get("batch_members_shed_total") >= c0
    db.sql("set batch_serving_enabled = off")
    db.sql("set batch_queue_limit = 512")


# ---------------------------------------------------------------------
# graceful drain
# ---------------------------------------------------------------------

def test_graceful_drain_cancels_and_joins(db, tmp_path):
    sock = str(tmp_path / "d.sock")
    srv = SqlServer(db, sock)
    srv.start()
    c = SqlClient(sock)
    faults.inject("cancel_before_dispatch", "sleep", sleep_s=1.0,
                  occurrences=1)
    out = {}

    def go():
        out["resp"] = c.op({"sql": "select count(*) from t"})

    t = threading.Thread(target=go)
    t.start()
    time.sleep(0.3)                            # statement in flight
    t0 = time.monotonic()
    srv.stop()
    drained = time.monotonic() - t0
    assert drained < float(db.settings.server_drain_s) + 2.0
    t.join(timeout=5)
    # the in-flight statement surfaced the typed shutdown cause
    assert out["resp"]["ok"] is False
    assert out["resp"].get("cancelled") == "shutdown"
    assert counters.get("statements_cancelled_shutdown") >= 1
    # no stray serving threads survive the drain
    time.sleep(0.3)
    stray = [th.name for th in threading.enumerate()
             if th.name in ("gg-server", "gg-server-tcp",
                            "gg-client-watch")]
    assert not stray, stray
    assert counters.get("server_active_connections") == 0
    c.close()


def test_drain_rejects_new_connects_typed(db, tmp_path):
    sock = str(tmp_path / "d2.sock")
    srv = SqlServer(db, sock)
    srv.start()
    srv.stop()
    # post-stop: the listener is gone entirely
    with pytest.raises(OSError):
        SqlClient(sock)


# ---------------------------------------------------------------------
# the storm (slow tier)
# ---------------------------------------------------------------------

@pytest.mark.slow
def test_overload_storm_bounded_and_recovers(served):
    d, srv, sock = served
    d.sql("set max_connections = 8")
    d.sql("set resource_queue_active = 2")
    d.sql("set admission_queue_limit = 4")
    d.sql("set resource_queue_timeout_s = 60")
    q = "select count(*), sum(v) from t"
    oracle = [list(r) for r in d.sql(q).rows()]   # wire rows are lists
    warm = _best_of(d, q)
    base_threads = threading.active_count()
    outcomes = []
    mu = threading.Lock()

    def client(i):
        try:
            c = SqlClient(sock)
        except OSError as e:
            with mu:
                outcomes.append(("connect_error", repr(e)))
            return
        try:
            resp = c.op({"sql": q})
            if resp.get("ok"):
                kind = "ok" if resp["rows"] == oracle else "wrong"
            else:
                kind = (resp.get("code")
                        or ("timeout" if "timed out" in resp["error"]
                            else "error"))
            with mu:
                outcomes.append((kind, resp.get("error")))
        finally:
            c.close()

    ts = [threading.Thread(target=client, args=(i,)) for i in range(64)]
    for t in ts:
        t.start()
        # thread count stays bounded DURING the storm: 8 admitted
        # handlers + 8 watchers + the listeners + the 64 test clients
        assert threading.active_count() < base_threads + 64 + 8 * 2 + 8
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts), "hung storm client"
    kinds = {}
    for k, _ in outcomes:
        kinds[k] = kinds.get(k, 0) + 1
    # every request ended in a result or a TYPED outcome
    assert len(outcomes) == 64, kinds
    assert kinds.get("wrong", 0) == 0, kinds
    assert kinds.get("error", 0) == 0, kinds
    assert kinds.get("connect_error", 0) == 0, kinds
    allowed = {"ok", "too_many_connections", "admission_shed", "timeout"}
    assert set(kinds) <= allowed, kinds
    assert kinds.get("ok", 0) >= 1
    assert kinds.get("too_many_connections", 0) >= 1
    # post-storm: population drains, service recovers
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline \
            and counters.get("server_active_connections") > 0:
        time.sleep(0.05)
    assert counters.get("server_active_connections") == 0
    assert threading.active_count() <= base_threads + 4
    post = _best_of(d, q)
    # acceptance target is 5%; the in-test bound is looser because
    # wall-clock ratios on shared CI jitter — a real regression (a leaked
    # queue slot, a stuck brownout) shows up as multiples, not percents
    assert post <= warm * 1.25 + 0.005, (post, warm)
    assert [list(r) for r in d.sql(q).rows()] == oracle


def _best_of(d, q, runs=10):
    d.sql(q)
    best = 1e9
    for _ in range(runs):
        t0 = time.perf_counter()
        d.sql(q)
        best = min(best, time.perf_counter() - t0)
    return best
