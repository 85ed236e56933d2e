"""Measured memory accounting and mid-flight enforcement in the port
(runtime/memaccount.py, runtime/runaway.py, the executor's measured
admission): tests/test_memaccount.py and tests/test_runaway.py replayed on
greengage_tpu_torch, plus measured admission driven on the CPU.

Replayed from tests/test_memaccount.py: the first launch's measurement
attached once and reused warm, the estimate-error gauge and the
executable histogram, the OOM demotion, the typed OOM with its
accounting and the ``mem-<id>.json`` dump, the classifier, the CPU's
None device stats, the process and owner gauges, the runaway ledger's
measured flag, and the report with the ``mem``/``metrics`` ops. Left out:
``test_explain_analyze_prints_measured_memory_on_warm_statement`` (EXPLAIN
ANALYZE, ROADMAP Queue 1 item 1c); the block-cache owner of
``test_owner_tree_charges_staging_blockcache_device`` and the report's
``block_cache`` key (the block cache, item 1a) — the staging and device
owners are checked here.

Measured admission on the CPU: the CPU has no allocator to read, so the
estimate governs there; stand-ins for the device stats and the peak
reading (as the JAX self-tuning drive monkeypatches
``memaccount.device_memory_stats``) drive the card's path: a warm run is
admitted by its measured bytes, adds no ``mem_analysis_runs``, and spills
by them under a ceiling its estimate would pass. The ``cuda`` twin
measures on the card.
"""

import glob
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import greengage_tpu_torch
from greengage_tpu_torch.exec.executor import OutOfDeviceMemory
from greengage_tpu_torch.runtime import memaccount, overload
from greengage_tpu_torch.runtime.faultinject import faults
from greengage_tpu_torch.runtime.logger import counters, prometheus_text
from greengage_tpu_torch.runtime.runaway import TRACKER, RunawayCancelled
from greengage_tpu_torch.runtime.trace import TRACES
from torch_witness import port_witness_armed  # noqa: F401

N = 20_000
Q = "select g, count(*), sum(v) from mt group by g order by g"


def _mt(device="cpu"):
    d = greengage_tpu_torch.connect(numsegments=4, device=device)
    d.sql("create table mt (k int, g int, v int) distributed by (k)")
    d.load_table("mt", {"k": np.arange(N), "g": np.arange(N) % 7,
                        "v": np.arange(N) % 11})
    d.sql("analyze")
    return d


@pytest.fixture(scope="module")
def db():
    d = _mt()
    yield d
    d.close()


@pytest.fixture(autouse=True)
def _clean_faults():
    """Faults off, and the brownout controller reset: the OOM tests count
    device OOMs, three of which within brownout_window_s would leave the
    process in a brownout."""
    yield
    faults.reset()
    overload.CONTROLLER.reset()


def _check_rows(res):
    rows = {int(g): (int(c), int(s)) for g, c, s in res.rows()}
    g = np.arange(N) % 7
    v = np.arange(N) % 11
    for k in range(7):
        m = g == k
        assert rows[k] == (int(m.sum()), int(v[m].sum()))


# ---------------------------------------------------------------------------
# the first launch's measurement, attached once and reused warm
# ---------------------------------------------------------------------------

def test_measured_bytes_attached_and_zero_reanalysis_on_warm_hit(db):
    db.sql(Q)   # first launch: the measurement attaches here
    r = db.sql(Q)
    mem = (r.stats or {}).get("mem")
    assert mem, r.stats
    meas = mem["measured"]
    assert meas is not None, mem
    assert meas["argument_bytes"] > 0 and meas["output_bytes"] > 0, meas
    assert mem["est_bytes"] > 0
    c0 = counters.get("mem_analysis_runs")
    j0 = counters.get("program_cache_hit")
    r2 = db.sql(Q)
    assert counters.get("mem_analysis_runs") - c0 == 0
    assert counters.get("program_cache_hit") > j0
    assert (r2.stats["mem"]["measured"] or {}) == (meas or {})


def test_owner_tree_charges_staging_and_device(db):
    db.executor._stage_cache.clear()   # a cold stage: fresh staging
    r = db.sql(Q)
    owners = r.stats["mem"]["owners"]
    assert owners.get("staging", 0) > 0, owners
    assert owners.get("device", 0) > 0, owners
    ring = memaccount.ACCOUNTS.ring()
    assert ring, "completed account did not land in the ring"
    snap = ring[-1]
    assert snap["owners"]["staging"]["items"], snap
    assert snap["total_bytes"] > 0


def test_estimate_error_gauge_and_mem_histogram(db):
    db.sql(Q)
    assert counters.kind("mem_est_error_pct") == "gauge"
    text = prometheus_text()
    assert "# TYPE ggtpu_executable_mem_mb histogram" in text
    assert 'ggtpu_executable_mem_mb_bucket{le="1"}' in text


# ---------------------------------------------------------------------------
# OOM forensics: classification, spill demotion, typed error + dump
# ---------------------------------------------------------------------------

def test_oom_demotes_to_spill_once(db):
    e0 = counters.get("oom_events")
    s0 = counters.get("oom_spill_retries")
    faults.inject("device_oom", "skip", occurrences=1)
    r = db.sql(Q)
    assert r.stats.get("oom_demoted") is True, r.stats
    assert r.stats.get("spill_passes", 0) >= 1
    assert counters.get("oom_events") == e0 + 1
    assert counters.get("oom_spill_retries") == s0 + 1
    _check_rows(r)


def test_oom_typed_error_carries_accounting_and_dumps_json(db):
    db.sql("set oom_spill_retry = off")
    db.executor._stage_cache.clear()   # guarantee a staging owner charge
    faults.inject("device_oom", "skip", occurrences=1)
    try:
        with pytest.raises(OutOfDeviceMemory) as ei:
            db.sql(Q)
    finally:
        db.sql("set oom_spill_retry = on")
    e = ei.value
    assert "out of device memory" in str(e).lower()
    owners = e.snapshot.get("owners") or {}
    assert "device" in owners and "staging" in owners, e.snapshot
    dumps = sorted(glob.glob(os.path.join(db.path, "log", "mem-*.json")),
                   key=os.path.getmtime)
    assert dumps, "mem-<id>.json forensics dump missing"
    with open(dumps[-1]) as f:
        payload = json.load(f)
    assert payload["error"]
    assert payload["accounting"]["owners"]["device"]["bytes"] > 0
    assert payload["accounting"]["owners"]["staging"]["bytes"] > 0
    assert payload["statement_id"] == e.snapshot.get("statement_id")


def test_oom_classifier_shapes():
    assert memaccount.is_oom_error(
        RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to "
                     "allocate 123 bytes"))
    assert memaccount.is_oom_error(RuntimeError("Out of memory"))
    assert not memaccount.is_oom_error(RuntimeError("bloom filter failed"))
    assert not memaccount.is_oom_error(ValueError("shape mismatch"))
    # torch's allocator refusal, by type and by message
    msg = ("CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a "
           "total capacity of 79.19 GiB of which 1.12 GiB is free.")
    assert memaccount.is_oom_error(torch.OutOfMemoryError(msg))
    assert memaccount.is_oom_error(RuntimeError(msg))


# ---------------------------------------------------------------------------
# CPU: device_memory_stats() is None, everything stays graceful
# ---------------------------------------------------------------------------

def test_cpu_memory_stats_none_is_graceful(db):
    stats = memaccount.device_memory_stats()
    if stats is not None:
        pytest.skip("a card is visible (not the CPU path)")
    assert memaccount.sample_watermark() is None
    assert memaccount.sample_watermark() is None   # repeat: stays None
    db.sql(Q)
    tr = TRACES.last()
    assert all("hbm_bytes" not in s["args"] for s in tr.export())
    # no allocator: the estimate governs admission
    assert db.sql(Q).stats["mem"]["admitted_by"] == "estimate"


# ---------------------------------------------------------------------------
# process gauges, runaway ledger, report + server surfaces
# ---------------------------------------------------------------------------

def test_process_gauges_rss_fds_pool_depth(db):
    out = memaccount.update_process_gauges()
    assert out.get("host_rss_bytes", 0) > 0
    assert out.get("host_open_fds", 0) > 0
    assert out.get("staging_pool_queue_depth", -1) >= 0
    text = prometheus_text()
    assert "# TYPE ggtpu_host_rss_bytes gauge" in text
    assert "# TYPE ggtpu_staging_pool_queue_depth gauge" in text


def test_owner_gauges_exported_during_statement(db):
    db.executor._stage_cache.clear()
    db.sql(Q)
    memaccount.update_process_gauges()
    snap = counters.snapshot()
    for name in ("mem_owner_bytes_staging", "mem_owner_bytes_device"):
        assert snap.get(name, 0) >= 0


def test_runaway_ledger_measured_flag():
    TRACKER.enter()
    try:
        TRACKER.reprice(1 << 20, 0, 0.9, measured=True)
        snap = [e for e in TRACKER.snapshot() if e["bytes"] == 1 << 20]
        assert snap and snap[0]["measured"] is True
        assert "statement_id" in snap[0]
    finally:
        TRACKER.release()


def test_mem_report_and_server_op(db, tmp_path):
    from greengage_tpu_torch.runtime.server import SqlClient, SqlServer

    db.sql(Q)
    rep = memaccount.report(db)
    assert "process" in rep and "vmem_tracker" in rep
    assert any(x["measured"] for x in rep["executables"]), \
        rep["executables"]
    srv = SqlServer(db, str(tmp_path / "mem.sock"))
    srv.start()
    try:
        c = SqlClient(str(tmp_path / "mem.sock"))
        c.sql("select count(*) from mt")
        m = c.op({"op": "mem"})
        assert m["ok"], m
        assert m["mem"]["device"] is None \
            or "bytes_in_use" in m["mem"]["device"]
        t = c.op({"op": "metrics"})
        assert "ggtpu_host_rss_bytes" in t["text"]
        c.close()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# measured admission on the CPU, through stand-ins for the card's allocator
# ---------------------------------------------------------------------------

# what the stand-in allocator "allocates" during a launch: more than the
# statement's estimate, so the measured bytes are the larger charge
GROWTH = 64 << 20


@pytest.fixture()
def card_standin(monkeypatch):
    """Stand-ins for the allocator's counters: device stats present, every
    launch grows the allocator by GROWTH above its base."""
    monkeypatch.setattr(memaccount, "device_memory_stats",
                        lambda: {"bytes_in_use": 1 << 30,
                                 "peak_bytes_in_use": 2 << 30,
                                 "bytes_limit": 80 << 30})
    monkeypatch.setattr(memaccount, "peak_begin", lambda device: 1 << 30)
    monkeypatch.setattr(memaccount, "peak_read",
                        lambda device: (1 << 30) + GROWTH)
    d = _mt()
    yield d
    d.close()


def test_measured_admission_through_the_allocator_standin(card_standin):
    d = card_standin
    c0 = counters.get("mem_analysis_runs")
    f0 = counters.get("admission_measured_feedback_total")
    # the first run's program (default capacities) and the second's (sized
    # by the first run's cap hints) are each measured at their first
    # launch. The first is admitted by its estimate (nothing measured
    # yet); the second, not yet measured itself, by the feedback store's
    # measurement of the shape (the first program's)
    first = d.sql(Q)
    _check_rows(first)
    assert first.stats["mem"]["admitted_by"] == "estimate"
    first_total = sum(first.stats["mem"]["measured"].values())
    cold = d.sql(Q)
    _check_rows(cold)
    assert cold.stats["mem"]["admitted_by"] == "measured"
    assert cold.stats["mem"]["admitted_bytes"] == first_total // 4
    assert counters.get("admission_measured_feedback_total") == f0 + 1
    assert counters.get("mem_analysis_runs") == c0 + 2
    meas = cold.stats["mem"]["measured"]
    assert meas["temp_bytes"] == GROWTH - meas["output_bytes"]
    warm = d.sql(Q)
    _check_rows(warm)
    mem = warm.stats["mem"]
    assert mem["admitted_by"] == "measured"
    assert mem["measured"] == meas
    assert mem["admitted_bytes"] == sum(meas.values()) // 4
    assert mem["admitted_bytes"] > mem["est_bytes"]
    assert counters.get("mem_analysis_runs") == c0 + 2   # warm: none
    # a ceiling the estimate passes but the measured bytes do not: the
    # statement spills by its measured bytes
    limit_mb = -(-mem["est_bytes"] // (1 << 20)) + 1
    assert mem["est_bytes"] < (limit_mb << 20) < mem["admitted_bytes"]
    d.sql(f"set vmem_protect_limit_mb = {limit_mb}")
    spilled = d.sql(Q)
    assert spilled.stats.get("spill_passes", 0) >= 1, spilled.stats
    _check_rows(spilled)
    # the runaway ledger priced the statement by its measured bytes
    d.sql("set vmem_protect_limit_mb = 12288")
    seen = []
    real = TRACKER.reprice

    def spy(nbytes, limit, zone, measured=False):
        seen.append((nbytes, measured))
        return real(nbytes, limit, zone, measured=measured)

    TRACKER.reprice = spy
    try:
        d.sql(Q)
    finally:
        TRACKER.reprice = real
    assert seen == [(mem["admitted_bytes"], True)]


def test_promoted_shape_admitted_by_measured_bytes(card_standin):
    """A feedback promotion re-plans a shape into a program not yet
    measured: it is admitted by the store's measured bytes of the shape,
    not by its estimate, as in the JAX executor."""
    d = card_standin
    d.sql("create table fbm (k int, b int) distributed by (k)")
    d.load_table("fbm", {"k": np.arange(N), "b": np.arange(N) % 7})
    q = "select count(*) from fbm where b >= 0"   # un-analyzed: 1/3 of N
    c0 = counters.get("admission_measured_feedback_total")
    cold = d.sql(q)
    assert cold.rows() == [(N,)]
    assert cold.stats["mem"]["admitted_by"] == "estimate"
    assert d.feedback.gen == 1         # the 3x-wrong estimate promoted
    replanned = d.sql(q)
    assert replanned.rows() == [(N,)]
    assert not replanned.stats["plan_cache"]["hit"]
    mem = replanned.stats["mem"]
    assert mem["admitted_by"] == "measured"
    assert mem["admitted_bytes"] == \
        sum(cold.stats["mem"]["measured"].values()) // 4
    assert counters.get("admission_measured_feedback_total") == c0 + 1


def test_measurement_waits_for_a_lone_launch(card_standin):
    """The peak counter is process-wide: a first launch beside another
    statement's device work stays unmeasured, and a later lone run
    measures it."""
    d = card_standin
    c0 = counters.get("mem_analysis_runs")
    hold, release = threading.Event(), threading.Event()

    def other():
        with memaccount.device_work():
            hold.set()
            release.wait(10)

    t = threading.Thread(target=other)
    t.start()
    hold.wait(5)
    try:
        r = d.sql(Q)
    finally:
        release.set()
        t.join()
    assert r.stats["mem"]["measured"] is None
    assert counters.get("mem_analysis_runs") == c0
    # alone: the program (sized by the first run's cap hints) is measured
    r = d.sql(Q)
    assert r.stats["mem"]["measured"] is not None
    assert counters.get("mem_analysis_runs") == c0 + 1
    assert d.sql(Q).stats["mem"]["admitted_by"] == "measured"


def test_no_peak_reading_keeps_the_estimate(monkeypatch):
    """Device stats without a peak above the launch's inputs and outputs
    (temp_bytes 0, as on a CPU device): the estimate governs."""
    monkeypatch.setattr(memaccount, "device_memory_stats",
                        lambda: {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                                 "bytes_limit": 80 << 30})
    d = _mt()
    try:
        d.sql(Q)
        mem = d.sql(Q).stats["mem"]
        assert mem["measured"]["temp_bytes"] == 0
        assert mem["admitted_by"] == "estimate"
        assert mem["admitted_bytes"] == mem["est_bytes"]
    finally:
        d.close()


@pytest.mark.cuda
def test_measured_admission_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = _mt(None)
    try:
        assert d.device.type == "cuda"
        for _ in range(2):   # the cold and the hinted program measured
            _check_rows(d.sql(Q))
        c0 = counters.get("mem_analysis_runs")
        warm = d.sql(Q)
        _check_rows(warm)
        mem = warm.stats["mem"]
        assert mem["measured"]["temp_bytes"] > 0, mem
        assert mem["admitted_by"] == "measured"
        assert mem["admitted_bytes"] == sum(mem["measured"].values()) // 4
        assert mem["device_bytes_in_use"] > 0
        assert counters.get("mem_analysis_runs") == c0
    finally:
        d.close()


# ---------------------------------------------------------------------------
# tests/test_runaway.py: the red zone flags the heaviest statement
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rdb():
    d = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    n = 1_200_000
    rng = np.random.default_rng(4)
    d.sql("create table heavy (k int, g int, v int) distributed by (k)")
    d.load_table("heavy", {"k": np.arange(n),
                           "g": (np.arange(n) % 23).astype(np.int32),
                           "v": rng.integers(0, 100, n)})
    d.sql("create table light (a int, v int) distributed by (a)")
    d.load_table("light", {"a": np.arange(100_000, dtype=np.int32),
                           "v": rng.integers(0, 9, 100_000).astype(np.int32)})
    d.sql("analyze")
    yield d
    d.close()


def test_tracker_red_zone_picks_heaviest():
    done = threading.Event()
    picked = {}

    def heavy():
        TRACKER.enter()
        try:
            TRACKER.reprice(100 << 20, 64 << 20, 0.9)
            done.wait(5)
            try:
                TRACKER.check()
                picked["heavy"] = False
            except RunawayCancelled:
                picked["heavy"] = True
        finally:
            TRACKER.release()

    t = threading.Thread(target=heavy)
    t.start()
    time.sleep(0.2)
    TRACKER.enter()
    try:
        # 100MB + 10MB > 0.9 * 64MB: the 100MB statement is the runaway
        TRACKER.reprice(10 << 20, 64 << 20, 0.9)
        TRACKER.check()          # the light statement survives
    finally:
        TRACKER.release()
        done.set()
        t.join()
    assert picked["heavy"] is True


def test_runaway_spill_query_canceled_while_small_completes(rdb):
    """The port's spill passes take a few ms each on the CPU, far fewer
    than the JAX package's, and the heavy statement would end before the
    small ones arrive: a 50 ms sleep before every launch keeps it in its
    pass loop, as the JAX passes' own time does."""
    rdb.sql("set vmem_protect_limit_mb = 1")     # heavy query must spill
    rdb.sql("set vmem_global_limit_mb = 1")
    rdb.sql("set runaway_red_zone = 0.6")        # red zone: 0.6 MB total
    faults.inject("cancel_before_dispatch", "sleep", sleep_s=0.05,
                  occurrences=-1)
    err: dict = {}

    def heavy():
        try:
            rdb.sql("select g, count(*), sum(v) from heavy group by g")
            err["heavy"] = None
        except Exception as e:
            err["heavy"] = str(e)

    t = threading.Thread(target=heavy)
    try:
        t.start()
        time.sleep(0.5)          # let it enter the spill pass loop
        for _ in range(200):     # small statements keep being admitted
            r = rdb.sql("select sum(v) from light")
            assert len(r.rows()) == 1
            if not t.is_alive():
                break
            time.sleep(0.05)
        t.join(timeout=120)
        assert not t.is_alive()
        assert err["heavy"] is not None, "heavy statement should be canceled"
        assert "runaway cleaner" in err["heavy"], err["heavy"]
    finally:
        rdb.sql("set vmem_global_limit_mb = 0")
        rdb.sql("set runaway_red_zone = 0.9")
        rdb.sql("set vmem_protect_limit_mb = 12288")


def test_no_global_limit_means_no_enforcement(rdb):
    rdb.sql("set vmem_protect_limit_mb = 1")
    try:
        r = rdb.sql("select g, count(*) from heavy group by g")
        assert r.stats.get("spill_passes", 0) >= 2
        assert len(r.rows()) == 23
    finally:
        rdb.sql("set vmem_protect_limit_mb = 12288")


def test_warm_batch_bucket_admitted_by_its_measured_bytes(monkeypatch):
    """ROADMAP Queue 3 item 10: a batched program is keyed by its width
    bucket (``f"{cache_key}@w{bucket}"``), measured at its first launch and
    admitted by the measured bytes once warm, as the JAX executor does
    (greengage_tpu/exec/executor.py prepare_batch). At a ceiling between
    the measured and the estimated bytes a warm bucket batches; a cold one
    falls back on its estimate."""
    from greengage_tpu_torch.exec.batchserve import BatchFallback
    from greengage_tpu_torch.sql.paramize import ParamVector
    from greengage_tpu_torch.sql.parser import parse

    growth = 1 << 20
    monkeypatch.setattr(memaccount, "device_memory_stats",
                        lambda: {"bytes_in_use": 1 << 30,
                                 "peak_bytes_in_use": 2 << 30,
                                 "bytes_limit": 80 << 30})
    monkeypatch.setattr(memaccount, "peak_begin", lambda device: 1 << 30)
    monkeypatch.setattr(memaccount, "peak_read",
                        lambda device: (1 << 30) + growth)
    n = 400_000
    d = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    try:
        d.sql("create table wb (k int, g int, v int) distributed by (k)")
        d.load_table("wb", {"k": np.arange(n), "g": np.arange(n) % 7,
                            "v": np.arange(n) % 11})
        d.sql("analyze")
        q = "select count(*), sum(v) from wb where g < 3"
        planned, consts, _o, ek = d._cached_plan(parse(q)[0])
        pv = consts["@params@"]
        rows = [ParamVector((v,), pv.types) for v in (1, 2, 3, 4)]
        want = [[(int(np.sum(np.arange(n) % 7 < v)),
                  int(np.sum((np.arange(n) % 11)[np.arange(n) % 7 < v])))]
                for v in (1, 2, 3, 4)]
        m0 = counters.get("mem_analysis_runs")
        cold = d.executor.run_batch(planned, consts, ek, rows)
        assert [r.rows() for r in cold] == want
        assert counters.get("mem_analysis_runs") == m0 + 1
        prog = d.executor._programs[next(
            k for k in d.executor._programs if k[0] == f"{ek}@w4")]
        measured = sum(prog.mem_analysis.values()) // 4
        est = int(prog.est_bytes)
        assert measured < est
        # a ceiling between the two: the warm bucket batches, admitted by
        # its measured bytes, and is not measured again
        limit_mb = -(-measured // (1 << 20))
        assert measured <= limit_mb << 20 < est
        d.sql(f"set vmem_protect_limit_mb = {limit_mb}")
        a0 = counters.get("admission_measured_total")
        warm = d.executor.run_batch(planned, consts, ek, rows)
        assert [r.rows() for r in warm] == want
        assert counters.get("admission_measured_total") == a0 + 1
        assert counters.get("mem_analysis_runs") == m0 + 1
        # another bucket is not measured yet: its estimate keeps it serial
        with pytest.raises(BatchFallback, match="ceiling"):
            d.executor.run_batch(planned, consts, ek, rows + rows[:1])
    finally:
        d.close()


def test_a_larger_sibling_program_is_charged_the_scaled_measurement(
        monkeypatch):
    """A program not yet measured is admitted on a card by the store's
    measurement of its shape; when it is estimated larger than the program
    that measurement came from (a retry tier's x4 capacities, a
    multi-match re-plan), the measurement is scaled up by the two
    estimates, so it spills instead of running out of the card's memory
    (TPC-H Q18 at SF10 and Q21 at SF 1 did, chip_smoke.py's tpch22 phase).
    A program estimated no larger keeps the measurement as it is."""
    import types

    monkeypatch.setattr(memaccount, "device_memory_stats",
                        lambda: {"bytes_in_use": 1 << 30,
                                 "peak_bytes_in_use": 2 << 30,
                                 "bytes_limit": 80 << 30})
    d = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    try:
        ex = d.executor
        key = "shape-of-a-statement"
        # the first program: estimated 100 MB a segment (400 MB on the
        # device), measured 200 MB in all
        d.feedback.note_measured(key, 200 << 20, 400 << 20, admits=True)
        per_seg = (200 << 20) // 4
        same = types.SimpleNamespace(est_bytes=100 << 20)
        smaller = types.SimpleNamespace(est_bytes=60 << 20)
        tier1 = types.SimpleNamespace(est_bytes=400 << 20)
        assert ex._admission_bytes(same, None, key) == (per_seg, True)
        assert ex._admission_bytes(smaller, None, key) == (per_seg, True)
        assert ex._admission_bytes(tier1, None, key) == (4 * per_seg, True)
    finally:
        d.close()
