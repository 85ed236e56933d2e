"""Block zone maps and scan pruning in the port against the JAX package:
tests/test_zonemaps.py and tests/test_visimap.py's pruned range scan after
a DELETE replayed, in memory and in a database directory.

A directory's block files carry per-block [min, max] in their footers
(storage/blockfile.py, the port's copy); the in-memory store computes the
same zone maps per chunk at append time, in blocks of DEFAULT_BLOCK_ROWS.
So a pruned scan keeps the same (kept, total) blocks as the JAX package's
store in both modes, and ``stats["zone_prune"]`` is held equal to it, with
the rows. The module fixture is read-only; the cases that write build
their own databases.
"""

import numpy as np
import pytest

import greengage_tpu
import greengage_tpu.types as JT
import greengage_tpu_torch
from greengage_tpu.storage import blockfile as jblockfile
from greengage_tpu_torch.storage import table_store
from greengage_tpu_torch.storage.blockfile import (read_footer,
                                                   write_column_file)
from torch_breadth import assert_rows_match

MODES = ("memory", "directory")
N = 600_000   # ~5 blocks of 65,536 rows per segment at 2 segments


def _pair(path, mode, nseg):
    if mode == "memory":
        return (greengage_tpu.connect(numsegments=nseg),
                greengage_tpu_torch.connect(numsegments=nseg, device="cpu"))
    return (greengage_tpu.connect(str(path / "j"), numsegments=nseg),
            greengage_tpu_torch.connect(str(path / "t"), numsegments=nseg,
                                        device="cpu"))


@pytest.fixture(scope="module", params=MODES)
def dbs(request, devices8, tmp_path_factory):
    j, t = _pair(tmp_path_factory.mktemp("zm"), request.param, 2)
    # loaded in day order: consecutive blocks hold tight day ranges (the
    # time-series ingest zone maps exist for)
    days = np.sort(np.random.default_rng(0).integers(8000, 9000, N)) \
        .astype(np.int32)
    cols = {"id": np.arange(N), "day": days, "amount": np.arange(N) % 1000}
    for db in (j, t):
        db.sql("create table events (id bigint, day date, amount int) "
               "distributed by (id)")
        db.load_table("events", dict(cols))
    yield j, t
    t.close()


def _both(j, t, text):
    want, got = j.sql(text), t.sql(text)
    assert_rows_match(got.rows(), want.rows(), text)
    assert got.stats.get("zone_prune", {}) == want.stats.get("zone_prune",
                                                             {}), text
    return got


def test_footer_carries_zone_maps(tmp_path):
    p, jp = str(tmp_path / "z.ggb"), str(tmp_path / "jz.ggb")
    write_column_file(p, np.arange(200_000, dtype=np.int64), "zlib", 1)
    jblockfile.write_column_file(jp, np.arange(200_000, dtype=np.int64),
                                 "zlib", 1)
    f = read_footer(p)
    assert len(f["blocks"]) == 4
    assert f["blocks"][0]["zmin"] == 0 and f["blocks"][0]["zmax"] == 65535
    assert f["blocks"][3]["zmin"] == 196608
    assert f["blocks"] == jblockfile.read_footer(jp)["blocks"]


@pytest.mark.parametrize("dtype", ["int64", "int32", "float64", "bool",
                                   "float_nan"])
def test_chunk_zone_maps_equal_the_footers(tmp_path, dtype):
    """The in-memory store's per-chunk zone maps are a block file's."""
    rng = np.random.default_rng(4)
    if dtype == "bool":
        a = rng.integers(0, 2, 150_000).astype(bool)
    elif dtype == "float_nan":
        a = rng.normal(size=150_000)
        a[70_000:140_000] = np.nan    # one all-NaN block: no zone
    else:
        a = rng.integers(-10**6, 10**6, 150_000).astype(dtype)
    p = str(tmp_path / "c.ggb")
    write_column_file(p, a, "zlib", 1)
    want = [{k: v for k, v in b.items() if k in ("nrows", "zmin", "zmax")}
            for b in read_footer(p)["blocks"]]
    assert table_store.zone_blocks(a) == want


def test_range_scan_prunes_blocks(dbs):
    j, t = dbs
    assert _both(j, t, "select count(*) from events").rows() == [(N,)]
    r = _both(j, t, "select count(*) from events where day >= "
                    "date '1994-08-15' and day < date '1994-08-30'")
    lo, hi = JT.date_to_days("1994-08-15"), JT.date_to_days("1994-08-30")
    snap = t.store.manifest.snapshot()
    want = 0
    for seg in range(2):
        cols, _, _ = t.store.read_segment("events", seg, ["day"], snap)
        want += int(((cols["day"] >= lo) & (cols["day"] < hi)).sum())
    assert r.rows()[0][0] == want
    kept, tot = r.stats["zone_prune"]["events"]
    assert tot >= 8 and kept < tot, r.stats["zone_prune"]
    # the pruned scan staged only the kept blocks' rows
    assert r.stats["zone_prune"] == {"events": (kept, tot)}


def test_equality_prune_and_point_correctness(dbs):
    j, t = dbs
    r = _both(j, t, "select count(*) from events where amount = 7 and "
                    "day = date '1994-01-20'")
    assert "events" in r.stats["zone_prune"]
    d0 = JT.date_to_days("1994-01-20")
    snap = t.store.manifest.snapshot()
    want = 0
    for seg in range(2):
        cols, _, _ = t.store.read_segment("events", seg, ["day", "amount"],
                                          snap)
        want += int(((cols["day"] == d0) & (cols["amount"] == 7)).sum())
    assert r.rows()[0][0] == want


def test_pruned_and_unpruned_stagings_coexist(dbs):
    """A pruned scan stages under its own capacity and key beside the
    whole table's: neither evicts the other, and a repeat of each reads
    nothing from the store."""
    j, t = dbs
    q_all = "select count(*), sum(amount) from events"
    q_cut = ("select count(*), sum(amount) from events where "
             "day < date '1992-01-10'")
    for q in (q_all, q_cut, q_all, q_cut):
        _both(j, t, q)
    cut = (("day", "<", JT.date_to_days("1992-01-10")),)
    caps = {k[5]: k[2] for k in t.executor._stage_cache
            if k[0] == "events" and k[5] in (None, cut)}
    assert len(caps) == 2 and caps[cut] < caps[None], caps
    from greengage_tpu_torch.runtime.logger import counters
    base = counters.snapshot()
    for q in (q_all, q_cut):
        t.sql(q)
    assert counters.since(base, "scan_").get("scan_files_read", 0) == 0


@pytest.mark.parametrize("mode", MODES)
def test_prune_never_loses_matches_random_data(tmp_path, devices8, mode):
    """An unsorted column: the zones span everything, nothing prunes and
    the rows stay exact."""
    j, t = _pair(tmp_path, mode, 2)
    try:
        v = np.random.default_rng(2).integers(0, 1_000_000, 200_000)
        for db in (j, t):
            db.sql("create table rnd (k int, v int) distributed by (k)")
            db.load_table("rnd", {"k": np.arange(200_000), "v": v})
        r = _both(j, t, "select count(*) from rnd where v < 500000")
        assert r.rows()[0][0] == int((v < 500000).sum())
        kept, tot = r.stats["zone_prune"]["rnd"]
        assert kept == tot
    finally:
        t.close()


@pytest.mark.parametrize("mode", MODES)
def test_pruned_range_scan_exact_after_delete(tmp_path, devices8, mode):
    """tests/test_visimap.py: a segment with a deletion bitmap is read
    whole (pruning would desync the bitmap's row numbering); after VACUUM
    the pruned scan returns."""
    j, t = _pair(tmp_path, mode, 8)
    try:
        n = 20_000
        cols = {"k": np.arange(n), "g": (np.arange(n) % 97).astype(np.int64),
                "v": np.arange(n, dtype=np.int64)}
        for db in (j, t):
            db.sql("create table t (k int, g int, v int) distributed by (k)")
            db.load_table("t", dict(cols))
            db.sql("analyze t")
        q = "select count(*) from t where k < 1000"
        assert "t" in _both(j, t, q).stats["zone_prune"]
        for db in (j, t):
            db.sql("delete from t where k >= 100 and k < 200")
        r = _both(j, t, q)
        assert r.rows()[0][0] == 900
        assert "t" not in r.stats["zone_prune"]
        assert j.vacuum("t") == t.vacuum("t")
        r = _both(j, t, q)
        assert r.rows()[0][0] == 900 and "t" in r.stats["zone_prune"]
    finally:
        t.close()


def test_spill_and_batch_over_a_pruned_partitioned_table(devices8):
    """A partitioned, pruned scan under the spill passes and in a batch,
    as the JAX package runs them: the spilled GROUP BY gives the JAX
    package's rows in as many passes; a batch drops its parameter-valued
    zone-map predicates (one member's value must not starve another's
    blocks) and every member equals its classic run."""
    from greengage_tpu_torch.sql.paramize import ParamVector
    from greengage_tpu_torch.sql.parser import parse as tparse

    j = greengage_tpu.connect(numsegments=4)
    t = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    try:
        n = 200_000
        rng = np.random.default_rng(1)
        d = np.sort(rng.integers(0, 1100, n))
        cols = {"k": np.arange(n), "d": d, "e": d.copy(),
                "g": rng.integers(0, 50, n), "v": rng.integers(0, 100, n)}
        for db in (j, t):
            db.sql("create table f (k int, d int, e int, g int, v bigint) "
                   "distributed by (k) partition by range (d) (partition a "
                   "start (0) end (500), partition b start (500) end "
                   "(1000), default partition r)")
            db.load_table("f", dict(cols))
            db.sql("analyze")
        q = "select g, count(*), sum(v) from f where d < 700 group by g " \
            "order by g"
        want = j.sql(q).rows()
        for db in (j, t):
            db.sql("set vmem_protect_limit_mb = 1")
        rj, rt = j.sql(q), t.sql(q)
        assert_rows_match(rt.rows(), rj.rows(), q)
        assert rt.rows() == want
        assert rt.stats["spill_passes"] == rj.stats["spill_passes"] > 1
        for db in (j, t):
            db.sql("set vmem_protect_limit_mb = 0")
        qb = "select count(*), sum(v) from f where e < {}"
        planned, consts, _, ek = t._cached_plan(tparse(qb.format(100))[0])
        pv = consts["@params@"]
        vals = (100, 650, 1050)
        res = t.executor.run_batch(planned, consts, ek,
                                   [ParamVector((x,), pv.types)
                                    for x in vals])
        for x, r in zip(vals, res):
            classic = _both(j, t, qb.format(x))
            assert "f" in classic.stats["zone_prune"]
            assert r.rows() == classic.rows()
    finally:
        t.close()
