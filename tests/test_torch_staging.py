"""Host staging in the port against the JAX package's exec/staging.py cases
(tests/test_staging.py), on the same numpy inputs.

(a) ``fill_buffer`` equals the JAX function on seeded parts (padding,
    empty segments, the one-segment no-copy path) and fills a given
    buffer in place.
(b) ``scan_threads`` 1, 2 and auto stage the same rows, equal to the JAX
    package's; a repeat statement reads nothing from the store (the stage
    cache), and a new store version restages.
(c) ``PassPrefetcher`` builds the buffers the executor would, hands them
    over once, and joins its thread; no staging or prefetch thread
    outlives a statement.

tests/test_staging.py's block-cache cases (the registry, file reads and
their counters, corruption under parallel readers, the budget) are
replayed in tests/test_torch_blockcache.py; its mirror repair (ROADMAP
Queue 1 item 10) and its microbench (bench.py) are left out. Here, a
whole-table stage and a pruned stage of one table are held to the JAX
package's rows and both stay cached.
"""

import threading

import numpy as np
import pytest

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu.exec import staging as jstaging
from greengage_tpu_torch.exec import staging
from greengage_tpu_torch.sql.parser import parse as tparse

FILL_CASES = {
    "padded_segments": (4, 16, np.int64, [(0, 16), (1, 3), (3, 0)], 0),
    "missing_segments": (3, 8, np.int32, [(2, 5)], 0),
    "bool_fill_false": (2, 5, np.bool_, [(0, 5), (1, 2)], False),
    "float_fill": (2, 7, np.float64, [(1, 7), (0, 1)], 0),
    "one_segment_exact": (1, 6, np.int64, [(0, 6)], 0),
    "one_segment_short": (1, 6, np.int64, [(0, 4)], 0),
}


def _parts(dtype, spec, seed):
    rng = np.random.default_rng(seed)
    return [(seg, rng.integers(-50, 50, n).astype(dtype)) for seg, n in spec]


@pytest.mark.parametrize("name", sorted(FILL_CASES))
def test_fill_buffer_equals_jax(name):
    nseg, cap, dt, spec, fill = FILL_CASES[name]
    want = jstaging.fill_buffer(nseg, cap, np.dtype(dt),
                                _parts(dt, spec, 3), fill)
    got = staging.fill_buffer(nseg, cap, np.dtype(dt), _parts(dt, spec, 3),
                              fill)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)
    out = staging.host_buffer(nseg * cap, np.dtype(dt), "cpu").numpy()
    back = staging.fill_buffer(nseg, cap, np.dtype(dt), _parts(dt, spec, 3),
                               fill, out=out)
    assert back is out and np.array_equal(out, want)


def test_host_buffer_is_pinned_only_for_a_card():
    t = staging.host_buffer(10, np.int32, "cpu")
    assert t.dtype.is_floating_point is False and t.numel() == 10
    assert not t.is_pinned()


def test_scan_thread_count_follows_the_setting():
    class S:
        scan_threads = 0

    assert staging.scan_thread_count(S) \
        == jstaging.scan_thread_count(S) >= 1
    S.scan_threads = 3
    assert staging.scan_thread_count(S) == 3


ROWS = 256


@pytest.fixture()
def dbs(devices8):
    cols = {"k": np.arange(ROWS), "v": np.arange(ROWS) * 10,
            "w": np.arange(ROWS) * 100}
    out = {}
    for name, pkg, kw in (("jax", greengage_tpu, {}),
                          ("torch", greengage_tpu_torch, {"device": "cpu"})):
        d = pkg.connect(numsegments=8, **kw)
        d.sql("create table t (k int, v bigint, w bigint) "
              "distributed by (k)")
        d.load_table("t", cols)
        out[name] = d
    yield out
    out["torch"].close()


def test_scan_threads_serial_matches_parallel(dbs):
    want = sorted(dbs["jax"].sql("select k, v from t").rows())
    assert want == sorted((i, i * 10) for i in range(ROWS))
    d = dbs["torch"]
    for n in (1, 2, 0):
        d.sql(f"set scan_threads = {n}")
        d.executor._stage_cache.clear()
        assert sorted(d.sql("select k, v from t").rows()) == want
    assert str(d.sql("show scan_threads")) == "0"


def _count_reads(monkeypatch, store):
    calls = []
    real = store.read_segment

    def read(table, seg, *a, **k):
        calls.append((table, seg))
        return real(table, seg, *a, **k)

    monkeypatch.setattr(store, "read_segment", read)
    return calls


def test_repeat_statement_reads_nothing(dbs, monkeypatch):
    d = dbs["torch"]
    calls = _count_reads(monkeypatch, d.store)
    r = d.sql("select sum(v) from t")
    assert r.rows()[0][0] == sum(i * 10 for i in range(ROWS))
    assert len(calls) == 8                       # every segment once
    d.sql("select sum(v) from t")
    assert len(calls) == 8                       # the stage cache served it
    d.load_table("t", {"k": np.array([9999]), "v": np.array([5]),
                       "w": np.array([7])})
    r = d.sql("select count(*), sum(v) from t")
    assert r.rows()[0] == (ROWS + 1, sum(i * 10 for i in range(ROWS)) + 5)
    assert len(calls) == 16                      # a new version restages


def test_prefetcher_hands_over_the_next_pass(dbs):
    d = dbs["torch"]
    ex = d.executor
    planned, _, _ = d._plan(tparse("select sum(v) from t")[0])
    snap = d.store.manifest.snapshot()
    caps = {"t": 16}
    pf = staging.PassPrefetcher(ex, planned, snap, caps)
    assert pf.enabled and pf.units[0][0] == "t"
    cap = ex.table_shapes(planned, snap, caps)["t"].capacity
    pf.next_ranges = {"t": (16, 32)}
    pf.kick()
    assert pf.next_ranges is None
    got = pf.take("t", (16, 32))
    want = ex.host_buffers("t", ["v"], cap, snap, (16, 32))
    assert sorted(got) == sorted(want) == ["@present", "v"]
    for c in want:
        assert np.array_equal(got[c].numpy(), want[c].numpy())
    assert pf.take("t", (16, 32)) is None        # handed over once
    pf.close()
    assert not [t for t in threading.enumerate()
                if t.name == "gg-spill-prefetch" and t.is_alive()]


def test_no_staging_thread_outlives_the_statement(dbs):
    d = dbs["torch"]
    d.sql("set scan_threads = 4")
    before = {t.ident for t in threading.enumerate()}
    d.executor._stage_cache.clear()
    d.sql("select sum(w) from t")
    assert not [t.name for t in threading.enumerate()
                if t.ident not in before and t.is_alive()]


def test_pruned_and_whole_stagings_coexist(dbs):
    """A scan with pushed predicates is staged under its own key (its
    predicates and capacity) beside the whole table's: the two stay cached
    side by side and each repeat reads nothing."""
    j, d = dbs["jax"], dbs["torch"]
    q_all = "select count(*), sum(v) from t"
    q_cut = "select count(*), sum(v) from t where k < 40"
    for q in (q_all, q_cut, q_all, q_cut):
        assert d.sql(q).rows() == j.sql(q).rows()
    keys = [k for k in d.executor._stage_cache if k[0] == "t"]
    assert {k[5] for k in keys} == {None, (("k", "<", 40),)}
    before = len(keys)
    for q in (q_all, q_cut):
        d.sql(q)
    assert len([k for k in d.executor._stage_cache if k[0] == "t"]) \
        == before
