"""Statement lifecycle in the port (runtime/interrupt.py): cooperative
cancellation at every wait state, statement timeouts and the unified
counter family — tests/test_interrupt.py's tests, but the three that need
the SQL server (runtime/server.py, ROADMAP Queue 1), held against the JAX
package.

The pure-host primitives run on both packages' modules with the same
calls and must behave alike. The engine tests drive a port Database
(``device="cpu"``) with the JAX tests' faults, settings and statements and
expect the JAX tests' causes, counters and rows, the rows also read from
a JAX Database over the same numpy columns; every test leaves the
registry clean. Counters are read as deltas.
"""

import threading
import time

import numpy as np
import pytest

import greengage_tpu
import greengage_tpu.runtime.interrupt as jint
import greengage_tpu_torch
import greengage_tpu_torch.runtime.interrupt as tint
from greengage_tpu_torch.runtime.faultinject import faults
from greengage_tpu_torch.runtime.interrupt import (REGISTRY,
                                                   StatementCancelled)
from greengage_tpu_torch.runtime.logger import counters

MODS = pytest.mark.parametrize("m", [jint, tint], ids=["jax", "torch"])


# ---------------------------------------------------------------------------
# pure-host primitives (no devices), on both packages
# ---------------------------------------------------------------------------

@MODS
def test_context_check_raises_typed_cause(m):
    ctx = m.StatementContext(1, "select 1")
    ctx.check()                      # unflagged: no-op
    ctx.cancel("user")
    with pytest.raises(m.StatementCancelled) as ei:
        ctx.check()
    assert ei.value.cause == "user"
    assert "user request" in str(ei.value)
    ctx.cancel("timeout")            # first cause wins
    assert ctx.cause == "user"


@MODS
def test_context_timeout_trips_flag(m):
    ctx = m.StatementContext(2, "select 1", timeout_s=0.05)
    assert ctx.remaining() <= 0.05
    time.sleep(0.08)
    assert ctx.cancelled
    with pytest.raises(m.StatementCancelled) as ei:
        ctx.check()
    assert ei.value.cause == "timeout"
    assert "statement timeout" in str(ei.value)


@MODS
def test_context_listener_fires_on_cancel_and_immediately_when_late(m):
    ctx = m.StatementContext(3, "x")
    hits = []
    ctx.add_listener(lambda: hits.append("a"))
    ctx.cancel("user")
    assert hits == ["a"]
    ctx.add_listener(lambda: hits.append("b"))   # late: fires at once
    assert hits == ["a", "b"]


@MODS
def test_registry_nesting_and_cancel_by_id(m):
    reg = m.REGISTRY
    ctx, outer = reg.enter("select 1")
    try:
        assert outer
        inner, inner_outer = reg.enter("nested")
        assert inner is ctx and not inner_outer   # shared outermost ctx
        reg.exit(inner)
        assert reg.current() is ctx
        rows = reg.snapshot()
        assert any(r["id"] == ctx.statement_id for r in rows)
        assert reg.cancel(ctx.statement_id, "user")
        assert ctx.cancelled
        assert not reg.cancel(999999)             # unknown id: False
    finally:
        reg.exit(ctx)
    assert reg.current() is None


@MODS
def test_registry_cancel_all_flags_everything(m):
    ctx, _ = m.REGISTRY.enter("select 1")
    try:
        assert m.REGISTRY.cancel_all("shutdown") >= 1
        assert ctx.cause == "shutdown"
    finally:
        m.REGISTRY.exit(ctx)


@MODS
def test_runaway_cause_raises_the_typed_subclass(m):
    ctx = m.StatementContext(4, "x")
    ctx.cancel("runaway")
    with pytest.raises(m.StatementCancelled) as ei:
        ctx.check()
    assert type(ei.value).__name__ == "RunawayCancelled"
    assert ei.value.cause == "runaway"


# ---------------------------------------------------------------------------
# engine-level cancellation at each wait state
# ---------------------------------------------------------------------------

N = 50_000


def _cols():
    return {"k": np.arange(N), "g": (np.arange(N) % 11),
            "v": (np.arange(N) % 7)}


@pytest.fixture(scope="module")
def db():
    d = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    d.sql("create table li (k int, g int, v int) distributed by (k)")
    d.load_table("li", _cols())
    d.sql("analyze")
    yield d
    d.close()


@pytest.fixture(scope="module")
def jrows(devices8):
    """The JAX package's rows for the statements that answer here."""
    d = greengage_tpu.connect(numsegments=4)
    d.sql("create table li (k int, g int, v int) distributed by (k)")
    d.load_table("li", _cols())
    d.sql("analyze")
    return {q: d.sql(q).rows() for q in (
        "select count(*) from li", "select count(*) from li -- holder",
        "select g, count(*), sum(v) from li group by g order by g")}


def _cancel_sql(marker: str, cause: str = "user", timeout_s: float = 5.0):
    """Wait until a statement whose text carries ``marker`` shows in the
    registry, then cancel it; -> its id (None if never seen)."""
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        for row in REGISTRY.snapshot():
            if marker in row["sql"]:
                REGISTRY.cancel(row["id"], cause)
                return row["id"]
        time.sleep(0.01)
    return None


def test_statement_timeout_cancels_in_staging(db, jrows):
    """statement_timeout_s arms at statement start and the statement dies
    at a staging-unit cancellation point (scan_threads=1: units run
    serially on the statement thread, so the per-unit sleep fault makes
    the deadline trip deterministic)."""
    db.sql("set scan_threads = 1")
    db.sql("set statement_timeout_s = 0.3")
    faults.inject("cancel_in_staging", "sleep", sleep_s=0.2, occurrences=-1)
    base = counters.get("statements_cancelled_timeout")
    try:
        with pytest.raises(StatementCancelled) as ei:
            db.sql("select count(*) from li where v = 3 -- timeout-victim")
        assert ei.value.cause == "timeout"
        assert counters.get("statements_cancelled_timeout") == base + 1
    finally:
        faults.reset("cancel_in_staging")
        db.sql("set statement_timeout_s = 0")
        db.sql("set scan_threads = 0")
    # the registry is clean and the session still serves
    assert REGISTRY.current() is None
    q = "select count(*) from li"
    assert db.sql(q).rows() == jrows[q] == [(N,)]


def test_user_cancel_lands_mid_staging(db):
    """A statement parked in cold staging reads is cancelled mid-flight
    (between read units), within a bounded time."""
    db.sql("set scan_threads = 1")
    faults.inject("cancel_in_staging", "sleep", sleep_s=0.25, occurrences=-1)
    err = {}

    def victim():
        try:
            db.sql("select sum(v) from li -- staging-victim")
            err["e"] = None
        except Exception as e:
            err["e"] = e

    base = counters.get("statements_cancelled_user")
    t = threading.Thread(target=victim)
    t0 = time.monotonic()
    t.start()
    try:
        assert _cancel_sql("staging-victim") is not None
        t.join(timeout=10)
        assert not t.is_alive()
        assert isinstance(err["e"], StatementCancelled), err["e"]
        assert err["e"].cause == "user"
        # one boundary interval: a couple of 0.25s units, never a hang
        assert time.monotonic() - t0 < 5.0
        assert counters.get("statements_cancelled_user") == base + 1
    finally:
        faults.reset("cancel_in_staging")
        db.sql("set scan_threads = 0")
    assert REGISTRY.snapshot() == []


def test_cancel_statement_parked_in_resource_queue(db, jrows):
    """A queued statement observes cancellation IMMEDIATELY (listener
    wakeup, not the next timeout slice), re-notifies so the racing
    release is never lost, and counts in queue_cancelled_total."""
    db.sql("set resource_queue_active = 1")
    # the slot holder sleeps at the pre-dispatch fault, keeping the queue
    # full while the victim parks in admit()
    faults.inject("cancel_before_dispatch", "sleep", sleep_s=1.5,
                  occurrences=1)
    res = {}

    def holder():
        try:
            res["holder"] = db.sql("select count(*) from li -- holder")
        except Exception as e:       # pragma: no cover
            res["holder"] = e

    def victim():
        try:
            db.sql("select sum(v) from li -- queue-victim")
            res["victim"] = None
        except Exception as e:
            res["victim"] = e

    qbase = counters.get("queue_cancelled_total")
    th = threading.Thread(target=holder)
    th.start()
    time.sleep(0.3)                  # holder admitted, now sleeping
    tv = threading.Thread(target=victim)
    t0 = time.monotonic()
    tv.start()
    try:
        assert _cancel_sql("queue-victim") is not None
        tv.join(timeout=10)
        assert not tv.is_alive(), "cancelled waiter never left the queue"
        waited = time.monotonic() - t0
        assert isinstance(res["victim"], StatementCancelled), res["victim"]
        assert res["victim"].cause == "user"
        assert waited < 1.4, f"queue exit took {waited:.2f}s (not immediate)"
        assert counters.get("queue_cancelled_total") == qbase + 1
        th.join(timeout=30)
        assert hasattr(res["holder"], "rows"), res["holder"]
        q = "select count(*) from li -- holder"
        assert res["holder"].rows() == jrows[q]
        # the re-notify preserved the slot: a later statement admits fine
        assert db.sql("select count(*) from li").rows()[0][0] == N
        assert db.resqueue.stats()["active"] == 0
    finally:
        faults.reset("cancel_before_dispatch")
        db.sql("set resource_queue_active = 0")
    assert REGISTRY.snapshot() == []


def test_cancel_between_spill_passes(db, jrows):
    """A spilling statement (pass-partitioned execution) is cancelled at
    a spill-pass boundary — the runaway cleaner's documented cancellation
    point, shared by user cancels."""
    q = "select g, count(*), sum(v) from li group by g order by g"
    db.sql("set vmem_protect_limit_mb = 1")     # force the spill regime
    # slow each pass down at its pre-dispatch point so the cancel lands
    # while passes remain
    faults.inject("cancel_before_dispatch", "sleep", sleep_s=0.3,
                  occurrences=-1)
    err = {}

    def victim():
        try:
            db.sql("select g, count(*), sum(v) from li group by g"
                   " -- spill-victim")
            err["e"] = None
        except Exception as e:
            err["e"] = e

    t = threading.Thread(target=victim)
    t.start()
    try:
        assert _cancel_sql("spill-victim") is not None
        t.join(timeout=60)
        assert not t.is_alive()
        assert isinstance(err["e"], StatementCancelled), err["e"]
        assert err["e"].cause == "user"
    finally:
        faults.reset("cancel_before_dispatch")
        db.sql("set vmem_protect_limit_mb = 12288")
    assert db.sql("select count(*) from li").rows()[0][0] == N
    assert db.sql(q).rows() == jrows[q]
    assert REGISTRY.snapshot() == []


def test_cancel_lands_at_a_spill_pass_boundary():
    """The same cancel where the statement really spills (at 50,000 rows
    the one above fits under 1 MB in both packages, so its cancel lands
    at the launch's cancellation point): at 200,000 rows and
    vmem_protect_limit_mb = 1 the grouping runs in passes, and a cancel
    set while a pass waits ends the statement at the next pass boundary,
    before the remaining passes."""
    from greengage_tpu_torch.runtime.trace import TRACES

    n = 200_000
    d = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    try:
        d.sql("create table big (k int, g int, v int) distributed by (k)")
        d.load_table("big", {"k": np.arange(n), "g": np.arange(n) % 11,
                             "v": np.arange(n) % 7})
        d.sql("analyze")
        d.sql("set vmem_protect_limit_mb = 1")
        q = "select g, count(*), sum(v) from big group by g"
        passes = d.sql(q).stats["spill_passes"]
        assert passes >= 3
        # the first pass's launch waits 0.5 s; the cancel lands meanwhile
        faults.inject("cancel_before_dispatch", "sleep", sleep_s=0.5,
                      occurrences=1)
        err = {}

        def victim():
            try:
                d.sql(q + " -- pass-victim")
                err["e"] = None
            except Exception as e:
                err["e"] = e

        t = threading.Thread(target=victim)
        t.start()
        try:
            time.sleep(0.2)
            assert _cancel_sql("pass-victim") is not None
            t.join(timeout=60)
        finally:
            faults.reset("cancel_before_dispatch")
        assert isinstance(err["e"], StatementCancelled), err["e"]
        assert err["e"].cause == "user"
        done = TRACES.last().find_spans("spill-pass")
        assert "pass-victim" in TRACES.last().sql
        assert 1 <= len(done) < passes
    finally:
        d.close()
    assert REGISTRY.snapshot() == []


def test_statement_timeout_zero_disables(db):
    db.sql("set statement_timeout_s = 0")
    assert db.sql("select count(*) from li").rows()[0][0] == N


def test_trace_records_the_statement_phases(db):
    """The statement's trace (runtime/trace.py) carries the phases the
    JAX session records, under one ``statement`` root, with the
    statement's id; a disabled trace records nothing."""
    from greengage_tpu_torch.runtime.trace import TRACES, to_chrome

    r = db.sql("select g, count(*) from li group by g -- traced")
    tr = TRACES.last()
    assert "-- traced" in tr.sql
    names = [s["name"] for s in tr.export()]
    for phase in ("statement", "parse", "plan", "admission", "compile",
                  "stage", "dispatch", "fetch"):
        assert phase in names, (phase, names)
    root = tr.find_spans("statement")[0]
    assert root["parent"] is None and root["dur"] >= 0
    assert len(r) == 11
    chrome = to_chrome(tr)
    assert chrome["otherData"]["trace_id"] == tr.trace_id
    assert {e["name"] for e in chrome["traceEvents"]} >= set(names)
    db.sql("set trace_enabled = off")
    try:
        db.sql("select count(*) from li -- untraced")
        assert "untraced" not in TRACES.last().sql
    finally:
        db.sql("set trace_enabled = on")
