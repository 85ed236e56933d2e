"""Admission, spill passes and the OOM demotion in the port against the
JAX package on the same numpy inputs.

(a) Every statement of tests/test_spill.py and tests/test_window_spill.py
    that needs no DML, at the same lowered ``vmem_protect_limit_mb`` over
    the same data (loaded into both packages with ``load_table``): equal
    rows, ``spill_passes``, ``spill_kind`` and bucket counts, and the same
    ``QueryError`` for the shapes neither package can spill.
(b) The OOM demotion: a program that raises ``torch.OutOfMemoryError``
    once demotes to the spill passes and answers exactly, as the JAX
    package does under its ``device_oom`` fault; twice (the first pass
    fails too), or with ``oom_spill_retry`` off, it raises
    ``OutOfDeviceMemory``. The port's own ``device_oom`` fault point gives
    the same outcomes.
(c) The RAM-then-disk workfile tier under a tiny ``spill_host_limit_mb``:
    passes demote to files in the statement's spill directory and promote
    back; the directory is empty after. The frame format's corruption
    check, and ``sweep_orphans`` (dead owners only, only the directory it
    is given).
(d) The byte estimate (``est_bytes``) of the corpus's plans equals the
    JAX compiler's, and admission leaves a statement under the ceiling
    alone.

Left out: test_window_spill.py's EXPLAIN ANALYZE and trace statements
(ROADMAP Queue 1 item 1c and item 7) and its ``slow`` acceptance test.
Counters are read as deltas; every spill directory is the test's own.
"""

import os
import threading

import numpy as np
import pandas as pd
import pytest
import torch

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu.analysis.plancorpus import TPCH_QUERIES
from greengage_tpu.exec.compile import Compiler as JCompiler
from greengage_tpu.exec.executor import QueryError as JQueryError
from greengage_tpu.runtime.faultinject import faults
from greengage_tpu.sql.parser import parse as jparse
from greengage_tpu.utils import tpch as jtpch
from greengage_tpu_torch.exec import workfile
from greengage_tpu_torch.exec.compile import Compiler
from greengage_tpu_torch.exec.executor import OutOfDeviceMemory, QueryError
from greengage_tpu_torch.runtime.logger import counters
from greengage_tpu_torch.sql.parser import parse as tparse
from greengage_tpu_torch.utils import tpch as ttpch

PKGS = (("jax", greengage_tpu, {}),
        ("torch", greengage_tpu_torch, {"device": "cpu"}))


def _pair(nseg, ddl, tables):
    """A JAX and a port Database with the same tables loaded."""
    out = {}
    for name, pkg, kw in PKGS:
        d = pkg.connect(numsegments=nseg, **kw)
        if name == "jax":
            d.sql("set cost_feedback = off")
        for stmt in ddl:
            d.sql(stmt)
        for t, cols in tables.items():
            d.load_table(t, cols)
        d.sql("analyze")
        out[name] = d
    return out


@pytest.fixture(scope="module")
def big(devices8):
    n = 400_000
    rng = np.random.default_rng(6)
    dbs = _pair(4, ["create table dim (pk int, grp int) distributed by (pk)",
                    "create table big (k int, fk int, v int) "
                    "distributed by (k)"],
                {"dim": {"pk": np.arange(1, 501),
                         "grp": np.arange(1, 501) % 11},
                 "big": {"k": np.arange(n), "fk": rng.integers(1, 501, n),
                         "v": rng.integers(0, 100, n)}})
    yield dbs
    dbs["torch"].close()


@pytest.fixture(scope="module")
def win(devices8):
    n = 200_000
    rng = np.random.default_rng(11)
    df = pd.DataFrame({"k": np.arange(n), "g": rng.integers(0, 400, n),
                       "v": rng.integers(0, 1000, n)})
    dbs = _pair(4, ["create table w (k int, g int, v int) distributed by (k)"],
                {"w": {c: df[c].values for c in ("k", "g", "v")}})
    yield dbs
    dbs["torch"].close()


def _run(db, q, mb):
    db.sql(f"set vmem_protect_limit_mb = {mb}")
    try:
        return db.sql(q)
    finally:
        db.sql("set vmem_protect_limit_mb = 12288")


SPILL_KEYS = ("spill_passes", "spill_kind", "spill_merge_buckets",
              "spill_window_buckets")


def _assert_same(j, t, ordered=True):
    jr, tr = j.rows(), t.rows()
    if not ordered:
        jr, tr = sorted(jr), sorted(tr)
    assert tr == jr
    assert {k: t.stats.get(k) for k in SPILL_KEYS} \
        == {k: j.stats.get(k) for k in SPILL_KEYS}


# ---- (a) tests/test_spill.py -------------------------------------------------

# name -> (statement, limit MB, whether rows come ordered, least passes)
BIG = {
    "matches_in_memory": (
        "select grp, count(*), sum(v) from big join dim on big.fk = dim.pk "
        "group by grp order by grp", 4, True, 2),
    "scalar_aggregate": (
        "select count(*), sum(v) from big join dim on big.fk = dim.pk",
        4, True, 2),
    "window_partition": (
        "select k, sum(v) over (partition by fk) s from big", 4, False, 2),
    "sort": ("select k, v from big where v >= 50 order by v desc, k",
             1, True, 2),
    "sort_limit_offset": ("select k, v from big order by v, k limit 7 "
                          "offset 3", 1, True, 2),
    "distinct_agg": ("select count(distinct v) from big join dim "
                     "on big.fk = dim.pk", 4, True, 2),
    "distinct_unique_key": ("select count(distinct k) from big", 1, True, 2),
    "grouped_distinct": (
        "select grp, count(distinct big.v) from big join dim "
        "on big.fk = dim.pk group by grp order by grp", 4, True, 2),
    "semi_join_probe": (
        "select count(*) from big where big.fk in "
        "(select pk from dim where pk <= 200)", 4, True, 2),
}


@pytest.mark.parametrize("name", sorted(BIG))
def test_spill_statement_equals_jax(big, name):
    q, mb, ordered, least = BIG[name]
    want = big["torch"].sql(q).rows()
    res = {k: _run(d, q, mb) for k, d in big.items()}
    _assert_same(res["jax"], res["torch"], ordered)
    assert res["torch"].stats["spill_passes"] >= least
    got = res["torch"].rows()
    assert (got if ordered else sorted(got)) \
        == (want if ordered else sorted(want))


def test_unspillable_shape_raises_as_jax(big):
    q = ("select k, sum(v) over (order by v, k rows between 1 preceding "
         "and current row) from big")
    with pytest.raises(JQueryError, match="not spillable"):
        _run(big["jax"], q, 1)
    with pytest.raises(QueryError, match="not spillable"):
        _run(big["torch"], q, 1)


def test_admission_leaves_small_statements_alone(big):
    res = big["torch"].sql("select count(*) from dim")
    assert "spill_passes" not in res.stats
    mem = res.stats["mem"]
    assert 0 < mem["est_bytes"] == mem["admitted_bytes"] <= 12288 << 20


def test_distinct_colocated_dedupe_spills_as_jax(devices8):
    n = 400_000
    dbs = _pair(4, ["create table cg (g int, v int) distributed by (g)"],
                {"cg": {"g": (np.arange(n) % 2000).astype(np.int64),
                        "v": np.arange(n)}})
    res = {k: _run(d, "select count(distinct g) from cg", 1)
           for k, d in dbs.items()}
    assert res["torch"].rows() == [(2000,)]
    _assert_same(res["jax"], res["torch"])
    assert res["torch"].stats["spill_passes"] >= 2


def test_grace_join_build_side_partitioned_as_jax(devices8):
    n = 300_000
    rng = np.random.default_rng(9)
    dbs = _pair(4, ["create table probe (k int, fk int, v int) "
                    "distributed by (k)",
                    "create table build (pk int, m int, w int) "
                    "distributed by (m)"],
                {"probe": {"k": np.arange(n), "fk": rng.permutation(n),
                           "v": rng.integers(0, 100, n)},
                 "build": {"pk": np.arange(n), "m": rng.permutation(n),
                           "w": rng.integers(0, 50, n)}})
    q = ("select count(*), sum(probe.v + build.w) from probe "
         "join build on probe.fk = build.pk")
    res = {k: _run(d, q, 6) for k, d in dbs.items()}
    assert res["torch"].rows()[0][0] == n
    _assert_same(res["jax"], res["torch"])
    assert res["torch"].stats["spill_passes"] >= 2


# ---- (a) tests/test_window_spill.py ------------------------------------------

WIN = {
    "matches_in_memory": (
        "select k, g, v, sum(v) over (partition by g order by v, k) rs, "
        "row_number() over (partition by g order by v, k) rn from w",
        False),
    "ntile_lag": ("select k, ntile(3) over (partition by g order by v, k) "
                  "nt, lag(v) over (partition by g order by v, k) lg from w",
                  False),
    "sort_limit_on_host": (
        "select k, g, rank() over (partition by g order by v desc) rk "
        "from w order by g, rk, k limit 23 offset 5", True),
    "filter_above": ("select k, s from (select k, sum(v) over "
                     "(partition by g) s from w) t where s > 100000", False),
    "max_over_partition": ("select k, max(v) over (partition by g) m "
                           "from w", False),
}


@pytest.mark.parametrize("name", sorted(WIN))
def test_window_spill_equals_jax(win, name):
    q, ordered = WIN[name]
    res = {k: _run(d, q, 4) for k, d in win.items()}
    assert res["torch"].stats["spill_kind"] == "window"
    assert res["torch"].stats["spill_passes"] >= 2
    _assert_same(res["jax"], res["torch"], ordered)


def test_window_spill_disabled_rejects_as_jax(win):
    q = "select k, sum(v) over (partition by g) s from w"
    for name, d in win.items():
        d.sql("set window_spill_enabled = off")
        try:
            err = JQueryError if name == "jax" else QueryError
            with pytest.raises(err, match="not spillable"):
                _run(d, q, 4)
        finally:
            d.sql("set window_spill_enabled = on")


# ---- (b) the OOM demotion ------------------------------------------------------

@pytest.fixture()
def oom_after(monkeypatch):
    """Make the next ``n`` program runs raise torch.OutOfMemoryError, as
    the caching allocator raises it on the host."""
    state = {"left": 0}
    real = Compiler.compile

    def compile(self, plan):
        comp = real(self, plan)
        program = comp.program

        def failing(tables):
            if state["left"] > 0:
                state["left"] -= 1
                raise torch.OutOfMemoryError(
                    "CUDA out of memory. Tried to allocate 2.00 GiB")
            return program(tables)

        comp.program = failing
        return comp

    monkeypatch.setattr(Compiler, "compile", compile)

    def arm(n):
        state["left"] = n
    return arm


OOM_Q = "select g, count(*) over (partition by g) c from w where k < 5000"


def test_oom_once_demotes_to_the_window_spill_as_jax(win, oom_after):
    want = sorted(win["torch"].sql(OOM_Q).rows())
    faults.inject("device_oom", "skip", occurrences=1)
    try:
        j = win["jax"].sql(OOM_Q)
    finally:
        faults.reset()
    c0 = counters.snapshot()
    oom_after(1)
    t = win["torch"].sql(OOM_Q)
    d = counters.since(c0)
    assert t.stats["oom_demoted"] is True is j.stats["oom_demoted"]
    _assert_same(j, t, ordered=False)
    assert sorted(t.rows()) == want
    assert d.get("oom_events") == 1
    assert d.get("oom_spill_retries") == 1
    assert d.get("window_spill_runs") == 1


def test_oom_twice_raises_out_of_device_memory_as_jax(win, oom_after):
    from greengage_tpu.exec.executor import OutOfDeviceMemory as JOOM

    faults.inject("device_oom", "skip", occurrences=2)
    try:
        with pytest.raises(JOOM):
            win["jax"].sql(OOM_Q)
    finally:
        faults.reset()
    oom_after(2)
    with pytest.raises(OutOfDeviceMemory, match="out of device memory"):
        win["torch"].sql(OOM_Q)
    # the statement after answers: nothing of the failed one is left behind
    assert sorted(win["torch"].sql(OOM_Q).rows()) \
        == sorted(win["jax"].sql(OOM_Q).rows())


def test_oom_with_the_retry_off_raises(win, oom_after):
    d = win["torch"]
    d.sql("set oom_spill_retry = off")
    try:
        oom_after(1)
        with pytest.raises(OutOfDeviceMemory) as e:
            d.sql(OOM_Q)
        assert e.value.est_bytes > 0
    finally:
        d.sql("set oom_spill_retry = on")


@pytest.mark.parametrize("occurrences", [1, 2])
def test_device_oom_fault_demotes_as_jax(win, occurrences):
    """The same demotion through the port's own ``device_oom`` fault point
    (runtime/faultinject.py, checked where the program launches), the
    JAX package under the same fault: once demotes with equal rows; twice
    raises the typed OutOfDeviceMemory in both."""
    from greengage_tpu.exec.executor import OutOfDeviceMemory as JOOM
    from greengage_tpu_torch.runtime.faultinject import faults as tfaults

    outcome = {}
    for name, fl in (("jax", faults), ("torch", tfaults)):
        fl.inject("device_oom", "skip", occurrences=occurrences)
        try:
            outcome[name] = win[name].sql(OOM_Q)
        except (JOOM, OutOfDeviceMemory) as e:
            outcome[name] = e
        finally:
            fl.reset()
    j, t = outcome["jax"], outcome["torch"]
    if occurrences == 1:
        assert t.stats["oom_demoted"] is True is j.stats["oom_demoted"]
        _assert_same(j, t, ordered=False)
    else:
        assert isinstance(j, JOOM) and isinstance(t, OutOfDeviceMemory)
        assert "device_oom" in str(t)


# ---- (c) the workfile's disk tier ----------------------------------------------

def _spill_files(directory):
    return [n for n in os.listdir(directory) if workfile._FILE_RE.match(n)]


def test_disk_tier_demotes_and_promotes_under_a_tiny_host_limit(big,
                                                                tmp_path):
    d = big["torch"]
    q = "select k, v from big order by v, k"
    want = d.sql(q).rows()
    d.sql(f"set spill_dir to '{tmp_path}'")
    d.sql("set spill_host_limit_mb = 1")
    c0 = counters.snapshot()
    try:
        res = _run(d, q, 1)
    finally:
        d.sql("set spill_host_limit_mb = 512")
        d.sql("set spill_dir to ''")
    delta = counters.since(c0)
    assert res.stats["spill_kind"] == "sort"
    assert res.rows() == want
    assert delta.get("spill_demote_total", 0) >= 1
    assert delta.get("spill_promote_total", 0) >= 1
    assert _spill_files(tmp_path) == []
    j = _run(big["jax"], q, 1)
    assert res.stats["spill_passes"] == j.stats["spill_passes"]


def test_ram_only_workfile_never_touches_disk(big, tmp_path):
    d = big["torch"]
    d.sql(f"set spill_dir to '{tmp_path}'")
    d.sql("set spill_host_limit_mb = 0")
    c0 = counters.snapshot()
    try:
        res = _run(d, "select k, v from big order by v, k limit 5", 1)
    finally:
        d.sql("set spill_host_limit_mb = 512")
        d.sql("set spill_dir to ''")
    assert res.stats["spill_kind"] == "sort"
    assert counters.since(c0).get("spill_demote_total", 0) == 0
    assert os.listdir(tmp_path) == []


def test_each_database_spills_into_a_directory_of_its_own(devices8):
    a = greengage_tpu_torch.connect(numsegments=2, device="cpu")
    b = greengage_tpu_torch.connect(numsegments=2, device="cpu")
    da, db_ = a.executor.default_spill_dir(), b.executor.default_spill_dir()
    assert da != db_ and os.path.isdir(da) and os.path.isdir(db_)
    a.close()
    assert not os.path.exists(da) and os.path.isdir(db_)
    b.close()


@pytest.mark.parametrize("flip", ["header", "payload", "truncate"])
def test_workfile_frame_detects_corruption(flip):
    raw = np.arange(1000, dtype=np.int64).tobytes()
    frame = bytearray(workfile.encode_frame(raw))
    assert workfile.decode_frame(bytes(frame)) == (raw, len(frame))
    if flip == "header":
        frame[5] ^= 0xFF
    elif flip == "payload":
        frame[-3] ^= 0xFF
    else:
        frame = frame[:-7]
    with pytest.raises(workfile.WorkfileCorrupt):
        workfile.decode_frame(bytes(frame))


def test_sweep_orphans_removes_dead_owners_only_in_its_directory(tmp_path):
    import subprocess
    import sys

    dead = subprocess.run([sys.executable, "-c",
                           "import os; print(os.getpid())"],
                          capture_output=True, text=True).stdout.strip()
    mine = f"gg-spill-{os.getpid()}-1-feedface.wf"
    orphan = f"gg-spill-{dead}-9-feedface.wf"
    other = "notes.txt"
    for n in (mine, orphan, other):
        (tmp_path / n).write_bytes(b"x")
    elsewhere = tmp_path / "sub"
    elsewhere.mkdir()
    (elsewhere / orphan).write_bytes(b"x")
    c0 = counters.snapshot()
    assert workfile.sweep_orphans(str(tmp_path)) == 1
    assert sorted(os.listdir(tmp_path)) == sorted([mine, other, "sub"])
    assert os.listdir(elsewhere) == [orphan]
    assert counters.since(c0)["spill_orphan_sweep_total"] == 1


def test_set_spill_dir_sweeps_orphans_there(devices8, tmp_path):
    import subprocess
    import sys

    dead = subprocess.run([sys.executable, "-c",
                           "import os; print(os.getpid())"],
                          capture_output=True, text=True).stdout.strip()
    (tmp_path / f"gg-spill-{dead}-3-0badf00d.wf").write_bytes(b"x")
    d = greengage_tpu_torch.connect(numsegments=2, device="cpu")
    d.sql(f"set spill_dir to '{tmp_path}'")
    assert os.listdir(tmp_path) == []
    d.close()


def test_no_thread_outlives_a_spilling_statement(big):
    before = {t.ident for t in threading.enumerate()}
    _run(big["torch"], "select k, sum(v) over (partition by fk) s from big",
         4)
    _run(big["torch"], "select count(distinct k) from big", 1)
    left = [t.name for t in threading.enumerate()
            if t.ident not in before and t.is_alive()]
    assert left == []


# ---- (d) the estimate ---------------------------------------------------------

@pytest.fixture(scope="module")
def tpch_pair(devices8):
    out = {}
    for name, pkg, kw in PKGS:
        d = pkg.connect(numsegments=8, **kw)
        if name == "jax":
            d.sql("set cost_feedback = off")
            jtpch.load(d, sf=0.01)
        else:
            ttpch.load(d, sf=0.01)
        d.sql("analyze")
        out[name] = d
    return out


@pytest.mark.parametrize("name", sorted(TPCH_QUERIES))
def test_est_bytes_equals_the_jax_compilers(tpch_pair, name):
    q = TPCH_QUERIES[name]
    j = tpch_pair["jax"]
    planned, consts, _ = j._plan(jparse(q)[0])
    want = JCompiler(j.catalog, j.store, j.mesh, j.numsegments, consts,
                     j.settings).compile(planned)
    t = tpch_pair["torch"]
    planned, consts, _ = t._plan(tparse(q)[0])
    got = t.executor.compile(planned, consts, no_direct=False)
    assert got.est_bytes == want.est_bytes
    assert sorted(got.node_est_bytes.values()) \
        == sorted(want.node_est_bytes.values())


STATS_EST = ["q1_pricing_summary", "q3_shipping_priority", "q12_shipmode",
             "distinct_group", "partitioned_window", "union_all_branches"]


@pytest.mark.parametrize("name", STATS_EST)
def test_stats_mem_block_equals_jax(tpch_pair, name):
    q = TPCH_QUERIES[name]
    j, t = tpch_pair["jax"].sql(q), tpch_pair["torch"].sql(q)
    assert t.stats["mem"]["est_bytes"] == j.stats["mem"]["est_bytes"]
    assert t.stats["mem"]["admitted_bytes"] \
        == j.stats["mem"]["admitted_bytes"]
    assert t.stats["tiers_used"] == j.stats["tiers_used"]
