"""The port's cost-feedback loop (greengage_tpu_torch/planner/feedback.py,
exec/session.py ``_feedback_reconcile``), the Filter row counters that
feed it, the cost calibration, the checkperf surfaces and the FTS probe,
against the JAX package on the same data:

  * the two repairs of the main path: a Filter's ``stats["node_rows"]``
    equals the JAX package's, and a 3x-wrong estimate re-plans on its
    second execution in both packages, with the same ``rows=`` before and
    after and ``feedback.gen == 1`` after five runs;
  * tests/test_feedback.py's tests, with ``load_table`` where they
    INSERT; its restart and measured-admission-after-restart tests reopen
    a database directory, as the JAX ones do (the standby-promotion test
    waits for ROADMAP Queue 1 item 10);
  * tests/test_cost_calibration.py's round trip and broadcast flip, the
    port's plan flipping as the JAX package's does;
  * mgmt/cli's device measurements on the CPU, the checkperf frame equal
    to the JAX server's, and tests/test_runtime.py::test_fts_probe_all_up.

Every test restores ``set_calibration(None)`` and the fault registries,
and reads counters as deltas."""

import os
import re
import threading

import numpy as np
import pytest
import torch

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu.planner import cost as JC
from greengage_tpu.runtime.faultinject import faults as jfaults
from greengage_tpu.runtime.server import SqlClient as JClient
from greengage_tpu.runtime.server import SqlServer as JServer
from greengage_tpu.sql.parser import parse as jparse
from greengage_tpu_torch.mgmt import cli
from greengage_tpu_torch.planner import cost as C
from greengage_tpu_torch.planner.logical import describe
from greengage_tpu_torch.runtime.faultinject import faults
from greengage_tpu_torch.runtime.logger import counters
from greengage_tpu_torch.runtime.server import SqlClient, SqlServer
from greengage_tpu_torch.sql.parser import parse


@pytest.fixture(autouse=True)
def _restore():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()
    C.set_calibration(None)
    JC.set_calibration(None)


def _line(text, tag):
    for ln in text.splitlines():
        if tag in ln:
            return ln.strip()
    return ""


def _explain(d, q):
    return d.sql("explain " + q).plan_text


FILTER_ROWS = {"a": np.arange(500), "b": np.arange(500) % 7}
FQ = "select count(*) from t where b >= 0"


def _filter_db(pkg, device="cpu"):
    """500 rows, b = i % 7: `where b >= 0` passes ALL rows but the default
    selectivity prices it at ~1/3 — a 3x underestimate."""
    kw = {"device": device} if pkg is greengage_tpu_torch else {}
    d = pkg.connect(numsegments=4, **kw)
    d.sql("create table t (a int, b int) distributed by (a)")
    d.load_table("t", FILTER_ROWS)
    return d


@pytest.fixture()
def pair(devices8):
    j = _filter_db(greengage_tpu)
    t = _filter_db(greengage_tpu_torch)
    yield j, t
    t.close()


# ---------------------------------------------------------------------------
# the two repairs: Filter counters, and the loop re-planning
# ---------------------------------------------------------------------------

def _preorder_rows(db, q, res, parse_fn):
    """The run's node_rows by preorder position of the cached plan."""
    planned = db._cached_plan(parse_fn(q)[0])[0]
    out, stack = [], [planned]
    while stack:
        p = stack.pop()
        out.append((type(p).__name__, res.stats["node_rows"].get(id(p))))
        stack.extend(reversed(p.children))
    return out


@pytest.mark.parametrize("q", [
    FQ,
    "select b, count(*) from t where a < 123 and b <> 3 group by b",
    "select count(*) from t x join t y on x.a = y.a where x.b > 2 "
    "and y.a % 5 = 1",
])
def test_filter_node_rows_equal_jax(pair, q):
    j, t = pair
    for d in (j, t):
        d.sql("set cost_feedback = off")   # one plan for both runs below
    jr, tr = j.sql(q), t.sql(q)
    assert tr.rows() == jr.rows()
    want = _preorder_rows(j, q, jr, jparse)
    got = _preorder_rows(t, q, tr, parse)
    assert got == want
    assert any(n == "Filter" and v is not None for n, v in got)


def test_3x_wrong_estimate_replans_second_execution_as_jax(pair):
    j, t = pair
    lines = {}
    for name, d in (("jax", j), ("torch", t)):
        cold = _line(_explain(d, FQ), "Filter")
        base = counters.snapshot()
        assert d.sql(FQ).rows()[0][0] == 500
        if name == "torch":
            assert counters.since(base).get("feedback_applied_total",
                                            0) >= 1
        warm = _line(_explain(d, FQ), "Filter")
        for _ in range(4):
            assert d.sql(FQ).rows()[0][0] == 500
        lines[name] = (cold, warm, d.feedback.gen)
    assert "rows=165" in lines["torch"][0]
    assert "rows=500" in lines["torch"][1]
    assert lines["torch"] == lines["jax"]
    assert lines["torch"][2] == 1


def test_3x_wrong_filter_estimate_replans_second_execution(pair):
    _j, d = pair
    cold = _line(_explain(d, FQ), "Filter")
    assert "rows=165" in cold
    base = counters.snapshot()
    r1 = d.sql(FQ)
    assert r1.rows()[0][0] == 500
    assert counters.since(base).get("feedback_applied_total", 0) >= 1
    assert d.feedback.gen >= 1
    assert "rows=500" in _line(_explain(d, FQ), "Filter")
    r2 = d.sql(FQ)
    assert r2.rows()[0][0] == 500
    assert r2.stats["plan_cache"]["hit"] is False   # the re-planned shape
    assert d.sql(FQ).stats["plan_cache"]["hit"] is True


def test_calibration_settles_without_oscillation(pair):
    _j, d = pair
    for _ in range(5):
        assert d.sql(FQ).rows()[0][0] == 500
    assert d.feedback.gen == 1
    assert d.feedback.report()["pending"] == 0


def test_cost_feedback_guc_disables_the_loop(pair):
    _j, d = pair
    d.sql("set cost_feedback = off")
    d.sql(FQ)
    d.sql(FQ)
    assert d.feedback.gen == 0
    assert "rows=165" in _line(_explain(d, FQ), "Filter")


AQ = "select a, count(*) from t group by a"


@pytest.fixture()
def group_db():
    """500 distinct group keys vs the un-analyzed ~4*sqrt(n)=89 default
    group estimate — a >5x cardinality underestimate at the root."""
    d = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    d.sql("create table t (a int, b int) distributed by (a)")
    d.load_table("t", {"a": np.arange(500), "b": np.arange(500)})
    yield d
    d.close()


def test_admission_error_collapses_on_second_execution(group_db):
    d = group_db
    assert "rows=89" in _line(_explain(d, AQ), "Aggregate")
    r1 = d.sql(AQ)
    assert len(r1.rows()) == 500
    r2 = d.sql(AQ)
    # run 2's program was measured against run 1's measurement of the
    # shape: the est-vs-actual gauge collapses toward zero
    assert abs(counters.get("mem_est_error_pct")) <= 5
    assert r2.stats["mem"]["est_bytes"] > 0
    assert "rows=499" in _line(_explain(d, AQ), "Aggregate")


def test_estimate_only_admission_without_device_stats(group_db):
    r = group_db.sql(AQ)
    assert r.stats["mem"]["admitted_by"] == "estimate"


def test_feedback_apply_fault_holds_correction_pending(pair):
    _j, d = pair
    faults.inject("feedback_apply", "skip", occurrences=-1)
    d.sql(FQ)
    assert d.feedback.gen == 0         # promotion skipped...
    rep = d.feedback.report()
    assert rep["pending"] >= 1         # ...but the candidate is parked
    assert "rows=165" in _line(_explain(d, FQ), "Filter")
    faults.reset("feedback_apply")
    assert d.feedback.apply_pending() >= 1   # the checkperf apply path
    assert d.feedback.gen == 1
    assert "rows=500" in _line(_explain(d, FQ), "Filter")


def test_checkperf_report_carries_est_vs_actual(pair, capsys):
    _j, d = pair
    d.sql(FQ)
    d.sql(FQ)
    rep = d.feedback.report()
    assert rep["gen"] >= 1
    assert rep["shapes"], "report must list observed plan shapes"
    row = rep["shapes"][0]
    for k in ("sql", "runs", "rows_est", "rows_actual", "rows_err_pct",
              "est_bytes", "measured_bytes"):
        assert k in row
    assert row["runs"] >= 2
    assert rep["scales"], "promoted scale must be visible in the report"
    assert cli.cmd_checkperf_feedback(d) == 0
    out = capsys.readouterr().out
    assert "calibration generation" in out and "rows err%" in out


def test_reset_drops_calibration_state(pair):
    _j, d = pair
    d.sql(FQ)
    assert d.feedback.gen == 1
    g = d.feedback.gen
    assert cli.cmd_checkperf_feedback(d, reset=True) == 0
    assert d.feedback.gen > g          # gen bump invalidates cached plans
    assert d.feedback.report()["shapes"] == []
    assert "rows=165" in _line(_explain(d, FQ), "Filter")


def test_batched_members_feed_no_correction():
    """Batched members share one program: the loop skips them, as in the
    JAX session (the classic runs of the shape feed it)."""
    d = _filter_db(greengage_tpu_torch)
    try:
        d.sql("set batch_serving_enabled = on")
        d.sql("set batch_window_ms = 50")
        planned, consts, _o, ek = d._cached_plan(parse(FQ)[0])
        from greengage_tpu_torch.sql.paramize import ParamVector

        pv = consts["@params@"]
        res = d.executor.run_batch(planned, consts, ek, [
            ParamVector((v,), pv.types) for v in (0, 1)])
        for r in res:
            d._feedback_reconcile(planned, ek, r)
        assert d.feedback.gen == 0
        # the shape is registered by its planning, never run; the width
        # bucket's first launch is measured under the bucket's own key
        # (f"{exec key}@w2"), as the JAX executor's dispatch_batch notes it,
        # and runs nothing either
        shapes = d.feedback.report()["shapes"]
        assert [s["runs"] for s in shapes] == [0, 0]
        assert d.feedback.measured_bytes(f"{ek}@w2") > 0
        assert d.feedback.measured_bytes(ek) is None
    finally:
        d.close()


def test_a_promoted_shape_keeps_its_multi_match_plan():
    """A shape whose unique-key join met duplicate build keys re-plans
    with multi-match joins; when a feedback promotion re-plans it, the
    port plans the multi-match joins at once (remembered per shape and
    store version) instead of running the failing plan again, as the JAX
    session does, with the same rows."""
    d = greengage_tpu_torch.connect(numsegments=8, device="cpu")
    try:
        d.sql("create table dup_b (k int, v int) distributed by (k)")
        d.load_table("dup_b", {"k": np.array([1, 1, 2, 3, 4, 5, 6, 7]),
                               "v": np.arange(1, 9)})
        q = ("select a.v av, b.v bv from dup_b a join dup_b b on a.k = b.k "
             "where a.v > 0 order by av, bv")
        runs = [d.sql(q) for _ in range(4)]
        assert d.feedback.gen >= 1
        assert any(not r.stats["plan_cache"]["hit"] for r in runs[1:])
        assert [r.stats["multi_join_replan"] for r in runs] == \
            [True, False, False, False]
        assert all(r.rows() == runs[0].rows() for r in runs)
        assert len(runs[0]) == 10
    finally:
        d.close()


# ---------------------------------------------------------------------------
# cost calibration (tests/test_cost_calibration.py)
# ---------------------------------------------------------------------------

def test_set_calibration_roundtrip():
    base = C.current_calibration()
    assert base == JC.current_calibration()
    assert base["ns_sort_row"] == 40.0
    C.set_calibration({"ns_sort_row": 1.5, "ns_ici_byte": 0.5})
    assert C.NS_SORT_ROW == 1.5
    assert C.NS_ICI_BYTE == 0.5
    assert C.NS_GATHER_ROW == 10.7        # unmentioned keys keep defaults
    C.set_calibration({"ns_sort_row": -3, "ns_ici_byte": "junk"})
    assert C.NS_SORT_ROW == 40.0          # invalid values fall back
    C.set_calibration(None)
    assert C.current_calibration() == base


def _motion_above_dim(text):
    lines = text.splitlines()
    for i, ln in enumerate(lines):
        if "Scan dim" in ln:
            for k in range(i - 1, -1, -1):
                if "Motion" in lines[k] or "Join" in lines[k]:
                    return lines[k]
    return ""


def test_calibration_flips_broadcast_choice_as_jax(devices8):
    """On hardware whose measured sort is 100x cheaper, the same query
    flips from Redistribute to Broadcast — in both packages."""
    from greengage_tpu.planner.logical import describe as jdescribe

    rng = np.random.default_rng(3)
    nf = 200_000
    fact = {"k": np.arange(nf), "fk": rng.integers(0, 4000, nf),
            "v": rng.integers(0, 1000, nf)}
    dim = {"pk": np.arange(4000), "m": np.arange(4000),
           "w": np.arange(4000)}
    q = "select sum(f.v) from fact f, dim d where f.fk = d.pk"
    got = {}
    for name, pkg, kw, cmod, parse_fn, desc in (
            ("jax", greengage_tpu, {}, JC, jparse, jdescribe),
            ("torch", greengage_tpu_torch, {"device": "cpu"}, C, parse,
             describe)):
        d = pkg.connect(numsegments=8, **kw)
        d.sql("create table fact (k int, fk int, v int) distributed by (k)")
        d.load_table("fact", fact)
        d.sql("create table dim (pk int, m int, w int) distributed by (m)")
        d.load_table("dim", dim)
        d.sql("analyze")
        planned, _, _ = d._plan(parse_fn(q)[0])
        before = _motion_above_dim(desc(planned))
        cmod.set_calibration({"ns_sort_row": 0.4, "ns_scatter_row": 0.9})
        planned, _, _ = d._plan(parse_fn(q)[0])
        after = _motion_above_dim(desc(planned))
        cmod.set_calibration(None)
        planned, _, _ = d._plan(parse_fn(q)[0])
        restored = _motion_above_dim(desc(planned))
        got[name] = [re.sub(r"#\d+", "#N", x)
                     for x in (before, after, restored)]
    assert "Motion Redistribute" in got["torch"][0]
    assert "Motion Broadcast" in got["torch"][1]
    assert got["torch"][2] == got["torch"][0]
    assert got["torch"] == got["jax"]


def test_measure_device_primitives_on_the_cpu():
    cal = cli._measure_device_primitives(n=1 << 14, device="cpu")
    assert sorted(cal) == sorted(k for k in C.CALIBRATION_DEFAULTS
                                 if k != "ns_ici_byte")
    for k, v in cal.items():
        assert v > 0, (k, cal)
    # installable as the JAX command's calibration.json would be
    C.set_calibration(cal)
    assert C.NS_GATHER_ROW == pytest.approx(cal["ns_gather_row"])
    assert C.NS_ICI_BYTE == C.CALIBRATION_DEFAULTS["ns_ici_byte"]


def test_checkperf_device_half_on_the_cpu(capsys):
    out = cli.cmd_checkperf(size_mb=4, device="cpu", calibrate=True)
    assert out["device_hbm_MBps"] > 0
    assert "item 8" in out["collective_allreduce_MBps"]
    assert out["cal_ns_sort_row"] > 0
    text = capsys.readouterr().out
    assert "device_hbm_MBps" in text and "cal_ns_host_call" in text
    with pytest.raises(NotImplementedError, match="item 1a"):
        cli.cmd_checkperf(size_mb=4, device="cpu", apply=True)


# ---------------------------------------------------------------------------
# the checkperf op over the server, frame against the JAX server's
# ---------------------------------------------------------------------------

def _checkperf_frames(d, server_cls, client_cls, sock):
    srv = server_cls(d, sock)
    srv.start()
    try:
        c = client_cls(sock)
        for q in (FQ, FQ, "select b, count(*) from t where a < 300 "
                          "group by b order by b"):
            c.sql(q)
        frames = [c.op({"op": "checkperf"}),
                  c.op({"op": "checkperf", "apply": True})]
        frames.append(c.op({"op": "checkperf", "reset": True}))
        frames.append(c.op({"op": "checkperf"}))
        c.close()
    finally:
        srv.stop()
        # both servers name their threads alike: let none outlive the
        # test (a later file counts the watchers of its own server)
        for th in threading.enumerate():
            if th.name.startswith(("gg-client-watch", "gg-server")):
                th.join(timeout=10)
    assert not [th for th in threading.enumerate()
                if th.name.startswith(("gg-client-watch", "gg-server"))]
    return frames


# the bytes of a shape are each package's own measurement (XLA's memory
# analysis, the port's measured launch) and scale: left out of the equality
_BYTES = ("est_bytes", "measured_bytes", "bytes_err_pct")


def _comparable(frame):
    out = dict(frame)
    if "feedback" in out:
        fb = dict(out["feedback"])
        fb["shapes"] = sorted(
            ({k: v for k, v in s.items() if k not in _BYTES}
             for s in fb["shapes"]), key=lambda s: s["shape"])
        out["feedback"] = fb
    return out


def test_checkperf_frame_equals_jax(pair, tmp_path):
    j, t = pair
    want = _checkperf_frames(j, JServer, JClient, str(tmp_path / "j.sock"))
    got = _checkperf_frames(t, SqlServer, SqlClient,
                            str(tmp_path / "t.sock"))
    assert [_comparable(f) for f in got] == [_comparable(f) for f in want]
    assert got[0]["ok"] and got[0]["feedback"]["gen"] >= 1
    assert got[2] == {"ok": True, "reset": True}


# ---------------------------------------------------------------------------
# FTS (tests/test_runtime.py::test_fts_probe_all_up)
# ---------------------------------------------------------------------------

def test_fts_probe_all_up():
    d = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    try:
        assert d.fts.probe_once() == {0: True, 1: True, 2: True, 3: True}
        assert d.catalog.segments.all_up()
    finally:
        d.close()


@pytest.mark.parametrize("mirrors", [False, True])
def test_fts_probe_fault_as_jax(mirrors):
    """The fts_probe fault point forces a failed probe: the segment is
    marked down (its in-sync mirror promoted where there is one) and the
    FTS version bumps, exactly as the JAX prober does on the same
    topology."""
    from greengage_tpu.catalog.segments import SegmentConfig as JConfig
    from greengage_tpu.runtime.fts import FtsProber as JProber
    from greengage_tpu.runtime.fts import cluster_state as jstate
    from greengage_tpu_torch.catalog.segments import SegmentConfig
    from greengage_tpu_torch.runtime.fts import FtsProber, cluster_state

    out = {}
    for name, cfg_cls, prober_cls, state, reg in (
            ("jax", JConfig, JProber, jstate, jfaults),
            ("torch", SegmentConfig, FtsProber, cluster_state, faults)):
        cfg = cfg_cls.create(4, with_mirrors=mirrors)
        prober = prober_cls(cfg)
        reg.inject("fts_probe", "error", segment=2, occurrences=1)
        first = prober.probe_once()
        second = prober.probe_once()
        out[name] = (first, second, cfg.version, state(cfg))
    assert out["torch"] == out["jax"]
    assert out["torch"][0][2] is False


# ---------------------------------------------------------------------------
# the card's twin
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_3x_wrong_estimate_replans_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lines = {}
    for dev in ("cpu", "cuda"):
        d = _filter_db(greengage_tpu_torch, dev)
        try:
            cold = _line(_explain(d, FQ), "Filter")
            for _ in range(5):
                assert d.sql(FQ).rows()[0][0] == 500
            lines[dev] = (cold, _line(_explain(d, FQ), "Filter"),
                          d.feedback.gen)
        finally:
            d.close()
    assert lines["cuda"] == lines["cpu"]
    assert "rows=500" in lines["cuda"][1] and lines["cuda"][2] == 1
    cal = cli._measure_device_primitives()
    assert all(v > 0 for v in cal.values())


# ---------------------------------------------------------------------------
# tests/test_feedback.py's restart tests, on a database directory
# ---------------------------------------------------------------------------

def _dir_db(path, rows):
    d = greengage_tpu_torch.connect(path, numsegments=4, device="cpu")
    d.sql("create table t (a int, b int) distributed by (a)")
    d.load_table("t", rows)
    return d


def test_calibration_survives_process_restart(tmp_path):
    path = str(tmp_path / "c")
    d = _dir_db(path, FILTER_ROWS)
    d.sql(FQ)
    assert d.feedback.gen == 1
    d.close()
    d2 = greengage_tpu_torch.connect(path, numsegments=4, device="cpu")
    try:
        assert d2.feedback.gen == 1
        assert "rows=500" in _line(_explain(d2, FQ), "Filter")
        assert d2.sql(FQ).rows()[0][0] == 500
        assert os.path.exists(os.path.join(path, "feedback.json"))
    finally:
        d2.close()


def test_measured_admission_prices_cold_program_after_restart(
        tmp_path, monkeypatch):
    """The store keeps each shape's measured bytes in feedback.json: a
    reopened directory admits a cold program by them. The port measures a
    launch through the card's allocator, stood in for on the CPU (as
    tests/test_torch_memaccount.py's ``card_standin`` does)."""
    from greengage_tpu_torch.runtime import memaccount

    monkeypatch.setattr(memaccount, "device_memory_stats",
                        lambda: {"bytes_in_use": 1 << 30,
                                 "peak_bytes_in_use": 2 << 30,
                                 "bytes_limit": 80 << 30})
    monkeypatch.setattr(memaccount, "peak_begin", lambda device: 1 << 30)
    monkeypatch.setattr(memaccount, "peak_read",
                        lambda device: (1 << 30) + (8 << 20))
    path = str(tmp_path / "c")
    d = _dir_db(path, {"a": np.arange(500), "b": np.arange(500)})
    d.sql(AQ)
    d.sql(AQ)
    d.close()
    d2 = greengage_tpu_torch.connect(path, numsegments=4, device="cpu")
    try:
        base = counters.snapshot()
        r = d2.sql(AQ)
        assert len(r.rows()) == 500
        assert r.stats["mem"]["admitted_by"] == "measured"
        assert r.stats["mem"]["admitted_bytes"] != \
            r.stats["mem"]["est_bytes"]
        delta = counters.since(base, prefix="admission_")
        assert delta.get("admission_measured_feedback_total", 0) >= 1
    finally:
        d2.close()
