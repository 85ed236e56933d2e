"""Batched serving in the port (exec/batchserve.py, compile.py
``batch_width``): tests/test_batch_serving.py's tests on a port Database
(``device="cpu"``), with the JAX package's rows for every statement as the
oracle beside the port's serial rows.

The contract:
  (a) demux correctness — every member of a batch gets the rows a serial
      run of its statement returns, and the JAX package's: integers and
      DECIMAL exactly, float64 within the JAX test's tolerance;
  (b) one program per batch — the port keeps no program cache: each
      ``run_batch`` builds one program (``Compiler.compile`` counted,
      where the JAX test counts ``jax.jit``) at the width's power-of-two
      bucket (3 and 4 -> 4, 5 -> 8; ``stats["batch_bucket"]``);
  (c) cancellation isolation — a cancelled member raises its typed
      StatementCancelled and its batch-mates' results are untouched;
  (d) window behavior — full windows flush on batch_max_width, partial
      windows flush on the batch_window_ms timer;
  (e) pipelining — stage(k+1) overlaps dispatch(k), read from the batch
      traces' spans (a sleep fault pins the overlap);
  (f) the disabled path spawns no pipeline and serves classically; a
      fallback routes members to the classic path; ``stop()`` releases
      parked members; a member's trace holds the batch's spans.

Then the operators rewritten for ``torch.func.vmap``: batched programs
over joins (hash and direct), sort-based grouping, windows and the dense
aggregate (fused gate off) give each member the classic program's rows,
and each rewritten operator gives its in-place form's values bit for bit.
The ``cuda``-marked twins run (a) and (c) on the card.
"""

import threading
import time

import numpy as np
import pytest
import torch

import greengage_tpu
import greengage_tpu_torch
import greengage_tpu_torch.exec.compile as C
from greengage_tpu_torch.exec.executor import BatchFallback
from greengage_tpu_torch.runtime.faultinject import faults
from greengage_tpu_torch.runtime.interrupt import (REGISTRY,
                                                   StatementCancelled)
from greengage_tpu_torch.runtime.logger import counters
from greengage_tpu_torch.sql.parser import parse
from greengage_tpu_torch.sql.paramize import ParamVector

N = 3000
DDL = ("create table t (k int, a int, v double precision, g int) "
       "distributed by (k)")


def _cols():
    return {"k": np.arange(N, dtype=np.int32),
            "a": np.arange(N, dtype=np.int32),
            "v": np.arange(N) * 0.5,
            "g": np.arange(N, dtype=np.int32) % 7}


@pytest.fixture(scope="module")
def jax_rows(devices8):
    """The JAX package's rows of a statement (cached per text)."""
    d = greengage_tpu.connect(numsegments=4)
    d.sql(DDL)
    d.load_table("t", _cols())
    memo = {}

    def rows(sql):
        if sql not in memo:
            memo[sql] = d.sql(sql).rows()
        return memo[sql]

    return rows


def _connect(device="cpu"):
    d = greengage_tpu_torch.connect(numsegments=4, device=device)
    d.sql(DDL)
    d.load_table("t", _cols())
    return d


@pytest.fixture()
def db():
    d = _connect()
    yield d
    faults.reset("batch_dispatch")
    d.close()


@pytest.fixture()
def compiles(monkeypatch):
    """Counts built programs: every program of the port is one
    ``Compiler.compile`` call (the JAX test counts ``jax.jit``)."""
    calls = {"n": 0}
    real = C.Compiler.compile

    def counting(self, plan):
        calls["n"] += 1
        return real(self, plan)

    monkeypatch.setattr(C.Compiler, "compile", counting)
    return calls


def _q(i: int) -> str:
    return f"select count(*), sum(v) from t where a > {i}"


def _rows_match(got, want) -> bool:
    """Row-sequence equality with the JAX test's float tolerance: a
    vmapped reduction may add in another order than the classic one."""
    if len(got) != len(want):
        return False
    for rg, rw in zip(got, want):
        if len(rg) != len(rw):
            return False
        for a, b in zip(rg, rw):
            if isinstance(a, float) or isinstance(b, float):
                if b != pytest.approx(a, rel=1e-9, abs=1e-12):
                    return False
            elif a != b:
                return False
    return True


def _oracle(db, jax_rows, sqls):
    """-> {key: rows}: the port's serial rows, each equal to the JAX
    package's."""
    out = {}
    for k, s in sqls.items():
        out[k] = db.sql(s).rows()
        assert _rows_match(out[k], jax_rows(s)), s
    return out


def _serve(db, sqls: dict, timeout=60.0):
    """Run each sql on its own thread (one connection per thread); ->
    ({key: rows}, {key: exception})."""
    results, errors = {}, {}

    def worker(key, sql):
        try:
            results[key] = db.sql(sql).rows()
        except Exception as e:   # noqa: BLE001 — the assertion surface
            errors[key] = e

    ts = [threading.Thread(target=worker, args=(k, s))
          for k, s in sqls.items()]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in ts), "serving threads hung"
    return results, errors


MIXED = {
    # int literal spread
    **{f"i{i}": _q(100 + i) for i in range(6)},
    # float literal + projection arithmetic
    "f1": "select k, v * 2.5 from t where v < 10.0 and a >= 3",
    "f2": "select k, v * 7.5 from t where v < 4.0 and a >= 1",
    # ORDER BY exercises per-member merge keys on the host
    "o1": "select k, v from t where a > 2990 order by v desc",
    "o2": "select k, v from t where a > 2980 order by v desc",
}


# ---------------------------------------------------------------------
# (a) demux correctness vs the serial oracle
# ---------------------------------------------------------------------
def _demux_matches_serial_oracle(db, jax_rows):
    oracle = _oracle(db, jax_rows, MIXED)
    db.sql("set batch_serving_enabled = on")
    db.sql("set batch_window_ms = 150")
    for s in MIXED.values():
        db.sql(s)   # warm the plan cache and the cap hints, serially
    # hold the first dispatch so a real multi-member window accumulates
    faults.inject("batch_dispatch", "sleep", sleep_s=0.4, occurrences=1)
    c0 = counters.snapshot()
    results, errors = _serve(db, MIXED)
    d = counters.since(c0)
    assert not errors, errors
    for k in MIXED:
        assert _rows_match(results[k], oracle[k]), k
        assert _rows_match(results[k], jax_rows(MIXED[k])), k
    # amortization really happened: fewer dispatches than members
    assert d.get("batch_members_total", 0) > d.get("batch_dispatch_total", 0)
    assert d.get("batch_fallback_total", 0) == 0, d


def test_demux_matches_serial_oracle(db, jax_rows):
    _demux_matches_serial_oracle(db, jax_rows)


@pytest.fixture()
def card_db():
    """A port Database on the card (the GPU); skips where none is
    visible."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = _connect(device=None)
    yield d
    faults.reset("batch_dispatch")
    d.close()


@pytest.mark.cuda
def test_demux_matches_serial_oracle_on_the_card(card_db, jax_rows):
    _demux_matches_serial_oracle(card_db, jax_rows)
    assert card_db.device.type == "cuda"




# ---------------------------------------------------------------------
# (b) one program per batch, at the width's pow2 bucket
# ---------------------------------------------------------------------
def test_compile_once_per_width_bucket(db, jax_rows, compiles):
    stmt = parse(_q(100))[0]
    planned, consts, _outs, ek = db._cached_plan(stmt)
    pv = consts["@params@"]

    def rows(vals):
        return [ParamVector((v,), pv.types) for v in vals]

    oracle = _oracle(db, jax_rows,
                     {v: _q(v) for v in (100, 7, 9, 1, 2, 3, 4, 5, 6)})
    n0 = compiles["n"]
    res = db.executor.run_batch(planned, consts, ek, rows([100, 7, 9]))
    assert compiles["n"] == n0 + 1          # one program, bucket 4
    assert [r.stats["batch_bucket"] for r in res] == [4, 4, 4]
    for v, r in zip((100, 7, 9), res):
        assert r.rows() == oracle[v]
    res = db.executor.run_batch(planned, consts, ek, rows([1, 2, 3, 4]))
    assert compiles["n"] == n0 + 2          # no program cache: one more
    assert [r.stats["batch_bucket"] for r in res] == [4] * 4
    for v, r in zip((1, 2, 3, 4), res):
        assert r.rows() == oracle[v]
    res = db.executor.run_batch(planned, consts, ek, rows([5] * 5))
    assert compiles["n"] == n0 + 3
    assert {r.stats["batch_bucket"] for r in res} == {8}
    assert all(r.rows() == oracle[5] for r in res)
    for w, b in ((1, 1), (2, 2), (16, 16)):
        res = db.executor.run_batch(planned, consts, ek, rows([6] * w))
        assert {r.stats["batch_bucket"] for r in res} == {b}
        assert all(r.rows() == oracle[6] for r in res)

    # 16 concurrent same-shape statements through the real pipeline: one
    # program per dispatched batch, and no classic program at all
    db.sql("set batch_serving_enabled = on")
    db.sql("set batch_window_ms = 100")
    db.sql(_q(600))   # warm: the pipeline's threads start
    c0 = counters.snapshot()
    n1 = compiles["n"]
    faults.inject("batch_dispatch", "sleep", sleep_s=0.3, occurrences=1)
    results, errors = _serve(db, {i: _q(600 + i) for i in range(16)})
    assert not errors, errors
    d = counters.since(c0)
    assert d.get("batch_members_total", 0) == 16
    assert compiles["n"] - n1 == d.get("batch_dispatch_total", 0)
    for i in range(16):
        assert results[i] == jax_rows(_q(600 + i))


# ---------------------------------------------------------------------
# (c) per-member cancellation isolation
# ---------------------------------------------------------------------
def _member_cancel_leaves_mates_intact(db, jax_rows):
    oracle = _oracle(db, jax_rows, {i: _q(i) for i in (300, 301, 302, 303)})
    db.sql("set batch_serving_enabled = on")
    db.sql("set batch_window_ms = 200")
    db.sql(_q(300))   # warm
    # plug: one statement rides a dispatch held on the device by the
    # fault, so the three real members accumulate in the next window
    faults.inject("batch_dispatch", "sleep", sleep_s=0.6, occurrences=1)
    results, errors = {}, {}
    base = counters.get("statements_cancelled_user")

    def worker(i):
        try:
            results[i] = db.sql(_q(i)).rows()
        except StatementCancelled as e:
            errors[i] = e.cause

    plug = threading.Thread(target=worker, args=(300,))
    plug.start()
    time.sleep(0.1)
    ts = [threading.Thread(target=worker, args=(i,))
          for i in (301, 302, 303)]
    for t in ts:
        t.start()
    time.sleep(0.15)   # members parked in the window / staged batch
    target = [r for r in REGISTRY.snapshot() if "> 302" in r["sql"]]
    assert target, "member 302 should be in flight"
    assert REGISTRY.cancel(target[0]["id"], "user")
    for t in ts:
        t.join(timeout=30)
    plug.join(timeout=30)
    # the cancelled member died with its typed cause; its batch-mates'
    # results match the serial oracle exactly
    assert errors == {302: "user"}
    for i in (300, 301, 303):
        assert results[i] == oracle[i], i
    assert counters.get("statements_cancelled_user") == base + 1
    assert REGISTRY.snapshot() == []


def test_member_cancel_leaves_mates_intact(db, jax_rows):
    _member_cancel_leaves_mates_intact(db, jax_rows)


@pytest.mark.cuda
def test_member_cancel_leaves_mates_intact_on_the_card(card_db, jax_rows):
    _member_cancel_leaves_mates_intact(card_db, jax_rows)
    assert card_db.device.type == "cuda"


# ---------------------------------------------------------------------
# (d) window flush reasons: full vs timer
# ---------------------------------------------------------------------
def test_window_flush_full_vs_timer(db, jax_rows):
    db.sql("set batch_serving_enabled = on")
    db.sql("set batch_max_width = 4")
    # a wide window for the FULL-flush phase: the flush must come from
    # the width cap, and a straggling thread start must not let the
    # timer fire first and split the members across two partial windows
    db.sql("set batch_window_ms = 800")
    db.sql(_q(42))   # warm width-1
    try:
        # hold the pipeline so windows accumulate rather than flush idle
        faults.inject("batch_dispatch", "sleep", sleep_s=1.0, occurrences=1)
        plug = threading.Thread(target=db.sql, args=(_q(42),))
        plug.start()
        time.sleep(0.1)
        c0 = counters.snapshot()
        # exactly max_width members: the window must flush FULL (well
        # before its 800 ms deadline — the sleep holds the device)
        results, errors = _serve(db, {i: _q(700 + i) for i in range(4)})
        assert not errors, errors
        d = counters.since(c0)
        assert d.get("batch_window_flush_full", 0) >= 1, d
        plug.join(timeout=30)
        for i in range(4):
            assert results[i] == jax_rows(_q(700 + i))

        # a partial window behind a busy pipeline flushes on the TIMER
        db.sql("set batch_window_ms = 120")
        faults.inject("batch_dispatch", "sleep", sleep_s=0.5, occurrences=1)
        plug = threading.Thread(target=db.sql, args=(_q(43),))
        plug.start()
        time.sleep(0.1)
        c0 = counters.snapshot()
        results, errors = _serve(db, {i: _q(800 + i) for i in range(2)})
        assert not errors, errors
        d = counters.since(c0)
        assert d.get("batch_window_flush_timer", 0) >= 1, d
        assert d.get("batch_window_flush_full", 0) == 0, d
        plug.join(timeout=30)
        for i in range(2):
            assert results[i] == jax_rows(_q(800 + i))
    finally:
        db.sql("set batch_max_width = 16")


# ---------------------------------------------------------------------
# (e) pipelining: stage(k+1) overlaps dispatch(k)
# ---------------------------------------------------------------------
def test_pipeline_stage_overlaps_dispatch(db):
    db.sql("set batch_serving_enabled = on")
    db.sql("set batch_max_width = 4")
    db.sql("set batch_window_ms = 60")
    db.sql(_q(0))   # warm
    try:
        # every dispatch sleeps 0.4 s on the "device": while batch k
        # sleeps there, the stager must stage batch k+1
        faults.inject("batch_dispatch", "sleep", sleep_s=0.4,
                      occurrences=-1)
        results, errors = _serve(db, {i: _q(900 + i) for i in range(8)})
        assert not errors, errors
        faults.reset("batch_dispatch")
        batches = [b for b in db._batch_server.recent
                   if b.find_spans("dispatch")]
        assert len(batches) >= 2, "expected at least two flushed batches"

        def absolute(tr, name):
            spans = tr.find_spans(name)
            assert spans, (name, [s["name"] for s in tr.export()])
            s = spans[0]
            start = tr.wall0 + s["ts"] / 1e3
            return start, start + (s["dur"] or 0.0) / 1e3

        # batch k+1's STAGE begins before batch k's DISPATCH ends (each
        # dispatch holds the device >= 0.4 s through the fault, so a
        # serial stage-after-dispatch pipeline could never order them so)
        batches.sort(key=lambda tr: absolute(tr, "dispatch")[0])
        pipelined = False
        for prev, nxt in zip(batches, batches[1:]):
            _d0, d1 = absolute(prev, "dispatch")
            s0, _s1 = absolute(nxt, "stage")
            if s0 < d1:
                pipelined = True
        assert pipelined, \
            "every stage serialized behind the previous dispatch"
    finally:
        faults.reset("batch_dispatch")
        db.sql("set batch_max_width = 16")


# ---------------------------------------------------------------------
# (f) the disabled path, fallback, stop, stats and trace graft
# ---------------------------------------------------------------------
def test_disabled_path_spawns_nothing(db, jax_rows):
    before = {t.name for t in threading.enumerate()}
    r = db.sql(_q(100))
    assert db._batch_server is None, \
        "batching off must not create the serving pipeline"
    assert "batched" not in (r.stats or {})
    assert r.rows()[0][0] == 2899
    assert r.rows() == jax_rows(_q(100))
    assert not {t.name for t in threading.enumerate()} - before


def test_fallback_routes_members_to_serial_path(db, jax_rows, monkeypatch):
    """Any overflow flag (value-dependent capacity need, duplicate join
    keys) sends the WHOLE window down the classic serial path: members
    still get correct results, the fallback is counted, and nothing
    surfaces to the client."""
    oracle = _oracle(db, jax_rows, {i: _q(i) for i in (400, 401, 402)})
    db.sql("set batch_serving_enabled = on")
    db.sql("set batch_window_ms = 150")
    db.sql(_q(400))   # warm
    monkeypatch.setattr(db.executor, "batch_overflowed",
                        lambda comp, host: ["join_expand_overflow_0"])
    faults.inject("batch_dispatch", "sleep", sleep_s=0.3, occurrences=1)
    c0 = counters.snapshot()
    results, errors = _serve(db, {i: _q(i) for i in (400, 401, 402)})
    d = counters.since(c0)
    assert not errors, errors
    for i in (400, 401, 402):
        assert results[i] == oracle[i], i
    assert d.get("batch_fallback_total", 0) >= 1, d
    assert d.get("batch_members_total", 0) == 0, d


def test_stop_releases_waiting_members(db, jax_rows):
    """BatchServer.stop() (Database.close) releases members parked in
    open windows — each degrades to the classic serial path on its own
    thread instead of waiting out the wedge timeout against a dead
    pipeline — and statements issued after stop still serve
    classically."""
    oracle = _oracle(db, jax_rows, {i: _q(i) for i in (500, 501, 502)})
    db.sql("set batch_serving_enabled = on")
    db.sql("set batch_window_ms = 800")
    db.sql(_q(500))   # warm + spawn the pipeline
    faults.inject("batch_dispatch", "sleep", sleep_s=1.0, occurrences=1)
    plug = threading.Thread(target=db.sql, args=(_q(500),))
    plug.start()
    time.sleep(0.1)
    results, errors = {}, {}

    def worker(i):
        try:
            results[i] = db.sql(_q(i)).rows()
        except Exception as e:   # noqa: BLE001
            errors[i] = e

    ts = [threading.Thread(target=worker, args=(i,)) for i in (501, 502)]
    t0 = time.monotonic()
    for t in ts:
        t.start()
    time.sleep(0.2)   # members parked in the open window
    db._batch_server.stop()
    for t in ts:
        t.join(timeout=30)
    plug.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert not errors, errors
    # released promptly (classic re-run), nowhere near the wedge timeout
    assert time.monotonic() - t0 < 20
    for i in (501, 502):
        assert results[i] == oracle[i], i
    # post-stop statements still serve (classic path, dead pipeline)
    assert db.sql(_q(502)).rows() == oracle[502]
    assert not [t for t in threading.enumerate()
                if t.name.startswith("gg-batch")]


def test_batched_stats_and_trace_graft(db):
    """A batched member's Result carries the batch stats block and its
    statement trace contains the grafted batch-dispatch subtree."""
    from greengage_tpu_torch.runtime.trace import TRACES

    db.sql("set batch_serving_enabled = on")
    db.sql(_q(55))   # warm; idle pipeline -> immediate width-1 flush
    r = db.sql(_q(56))
    assert r.stats and r.stats.get("batched") is True
    assert r.stats.get("batch_width") == 1
    assert r.stats.get("batch_bucket") == 1
    assert r.stats["plan_cache"]["hit"] is True
    tr = TRACES.last()
    names = {s["name"] for s in tr.export()}
    assert "batch-wait" in names, names
    assert "batch-dispatch" in names, names
    assert "batch-member" in names, names


# ---------------------------------------------------------------------
# the operators rewritten for vmap: batched rows equal classic rows
# ---------------------------------------------------------------------
OPS = {
    # the direct-addressed join (its build side's scatter-max slot
    # table) under the grouping, and a left join with a residual (the
    # multi-match join's per-probe "any kept" flags); co-located on the
    # distribution key: a Redistribute's tier-0 overflow would send any
    # batch to the classic path (test_unrunnable_batch_falls_back)
    "join": ("select t1.g, count(*), sum(t2.v) from t t1 join t t2 on "
             "t1.k = t2.k where t1.v > {0}.5 group by t1.g order by t1.g"),
    "left_join": ("select t1.k, t2.v from t t1 left join t t2 on "
                  "t1.k = t2.k and t2.v > {0}.0 where t1.a < 40 "
                  "order by t1.k"),
    # a join on a duplicate key: the hash table's build and probe walk
    # (which runs its full hop bound for a batched value) and the
    # multi-match expansion
    "join_multi": ("select t1.g, count(*) from t t1 join t t2 on "
                   "t1.g = t2.g where t2.a < {0} and t1.a < 50 "
                   "group by t1.g order by t1.g"),
    # sort-based grouping (run starts, the group table's scatters, the
    # float64 scatter-add and the min/max scatter)
    "sort_group": ("select a % 97 as b, count(*), sum(v), min(v), max(a) "
                   "from t where a > {0} group by a % 97 order by b"),
    # the dense aggregate through the plain reducers (index_add and the
    # min/max scatter), the fused gate off as every batched program has it
    "dense": ("select g, count(*), sum(a), min(v), max(v) from t where "
              "a > {0} group by g order by g"),
    # windows: partition starts (_spans), peer equality (_eq_prev), the
    # ordered-global lookups (the positions' scatter) and the float scans
    "window": ("select k, rank() over (partition by g order by v desc), "
               "sum(v) over (partition by g order by k) from t where "
               "a > {0} order by k limit 40"),
    "window_global": ("select k, row_number() over (order by v), "
                      "lag(v, 2) over (order by v) from t where a < {0} "
                      "order by k"),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_batched_rows_equal_classic_rows(db, jax_rows, name):
    db.sql("set fused_dense_min_rows = 1")   # the dense gate would pass
    db.sql("analyze")
    text = OPS[name]
    vals = (20, 700, 1500)
    texts = [text.format(v) for v in vals]
    classic = []
    for q in texts:
        classic.append(db.sql(q).rows())   # also records the cap hints
        assert _rows_match(classic[-1], jax_rows(q)), q
    planned, consts, _outs, ek = db._cached_plan(parse(texts[0])[0])
    rows = [db._cached_plan(parse(q)[0])[1]["@params@"] for q in texts]
    res = db.executor.run_batch(planned, consts, ek, rows)
    assert [r.stats["batch_bucket"] for r in res] == [4, 4, 4]
    for r, want in zip(res, classic):
        assert _rows_match(r.rows(), want), name


def test_unrunnable_batch_falls_back(db):
    """A window the batched program cannot serve raises BatchFallback
    (the serving pipeline then runs every member classically)."""
    q = "select a, count(*) from t where a > {} group by a order by a"
    planned, consts, _outs, ek = db._cached_plan(parse(q.format(5))[0])
    pv = consts["@params@"]
    with pytest.raises(BatchFallback):
        # a Redistribute whose bucket overflows at tier 0 reports no
        # exact count (ROADMAP Queue 3 item 5): no batch can hold it
        db.executor.run_batch(planned, consts, ek,
                              [ParamVector((v,), pv.types)
                               for v in (5, 6)])


# ---- each rewritten operator against its in-place form ----------------

def _gen(seed):
    g = torch.Generator().manual_seed(seed)
    S, n, D = 3, 257, 9
    return (g, S, n, D,
            torch.randint(0, D, (S, n), generator=g),
            torch.randint(-50, 50, (S, n), generator=g),
            torch.rand((S, n), generator=g, dtype=torch.float64))


def test_rewritten_operators_equal_their_in_place_forms():
    from greengage_tpu_torch.ops import agg, join, sort, window

    g, S, n, D, gid, ival, fval = _gen(3)
    flat = (torch.arange(S)[:, None] * D + gid).reshape(-1)
    ref = torch.zeros(S * D, dtype=torch.int64).index_add_(
        0, flat, ival.reshape(-1)).reshape(S, D)
    assert torch.equal(agg.segment_sum(gid, D, ival), ref)
    ref = torch.full((S * D,), 10 ** 6, dtype=torch.int64).scatter_reduce_(
        0, flat, ival.reshape(-1), "amin", include_self=True).reshape(S, D)
    assert torch.equal(agg.segment_minmax(gid, D, ival, "min", 10 ** 6),
                       ref)
    # run starts of sorted operands
    ops = [torch.sort(gid, dim=1).values]
    ref = torch.ones((S, n), dtype=torch.bool)
    ref[:, 1:] = ops[0][:, 1:] != ops[0][:, :-1]
    assert torch.equal(agg._run_starts(ops, n), ref)
    # a sorted grouping's table: every reducer kind
    sel = torch.rand((S, n), generator=g) < 0.8
    boundary = agg._run_starts(ops, n) & sel
    specs = [agg.AggSpec("c", "count_star", None, None),
             agg.AggSpec("s", "sum", ival, None),
             agg.AggSpec("f", "sum", fval, None),
             agg.AggSpec("m", "min", ival, None)]
    vals, _valids, _pos, _tot = agg.sorted_group_aggregate(
        boundary, sel, specs, 16)
    csb = torch.cumsum(boundary.to(torch.int64), 1)
    tgt = torch.where((csb - 1 >= 0) & (csb - 1 < 16), csb - 1, 16)
    fref = torch.zeros((S, 17), dtype=torch.float64).scatter_add_(
        1, tgt, torch.where(sel, fval, 0.0))[:, :16]
    assert torch.equal(vals["f"], fref)
    mref = torch.full((S, 17), torch.iinfo(torch.int64).max).scatter_reduce_(
        1, tgt, torch.where(sel, ival, torch.iinfo(torch.int64).max),
        "amin")[:, :16]
    assert torch.equal(vals["m"], mref)
    # window partition spans
    is_first = torch.rand((S, n), generator=g) < 0.1
    starts, ends = window._spans(is_first)
    idx = torch.arange(n).expand(S, n)
    gg = torch.cumsum(is_first.to(torch.int64), 1)
    firsts = torch.full((S, n + 2), n, dtype=torch.int64)
    firsts.scatter_(1, torch.where(is_first, gg - 1, n + 1), idx)
    firsts = firsts[:, :n + 1]
    assert torch.equal(ends, firsts.gather(1, gg) - 1)
    assert torch.equal(starts, torch.where(
        gg > 0, firsts.gather(1, torch.clamp(gg - 1, min=0)), 0))
    # the float scan's blocks
    blocks, nb = sort._blocks(fval, 0.0, 64)
    ref = torch.full((S, nb * 64), 0.0, dtype=torch.float64)
    ref[:, :n] = fval
    assert torch.equal(blocks, ref.reshape(S * nb, 64))
    # the direct join's slot table
    tbl = join.build_direct(join.KeySpec(gid, None, None), sel, 0, D)
    rows = torch.arange(n).expand(S, n)
    in_dom = sel & (gid >= 0) & (gid < D)
    slot = torch.full((S, D), -1, dtype=torch.int32).scatter_reduce_(
        1, torch.where(in_dom, gid, rows % D),
        torch.where(in_dom, rows.to(torch.int32), -1), "amax")
    assert torch.equal(tbl.slot_row, slot)
