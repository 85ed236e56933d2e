"""The byte-budgeted LRU block cache in the port against the JAX package:
tests/test_staging.py's registry and cache cases (from its block-cache
section on) replayed, and the brownout's shrunken budget.

  * the registry itself (storage/blockcache.py): recency eviction, one
    budget over every member, version invalidation — the same operations
    on the JAX package's ``CacheRegistry`` and the port's give the same
    residency, and ``nbytes_of`` counts a torch tensor's bytes; the
    port's own: entries on a card keep a budget of their own, the
    version index that lets a statement skip the invalidation scan, and a
    block decoded into a staging slot cached as its own copy;
  * the counters of a directory's scans (``scan_files_read``,
    ``scan_bytes_decoded``, ``scan_cache_hit``), never wall clocks: a cold
    scan reads each file once, a repeat reads nothing (the stage cache),
    and with the staged inputs dropped the scan re-assembles from the
    ``blocks`` member; each package's counters, deltas held equal;
  * the per-statement ``scan_io`` stats and EXPLAIN ANALYZE's Scan I/O
    line, ``scan_threads``, a write's new version, CREATE INDEX dropping
    the staged inputs, a corrupt file quarantined once by six readers,
    and ``scan_cache_limit_mb`` bounding the resident bytes;
  * on a brownout's entry the session evicts to the shrunken budget: the
    registry's total is within it at once (the staged tensors go).

Left out: the mirror-repair cases (replication, ROADMAP Queue 1 item 10)
and the staging microbench (bench.py is the JAX package's). Each case
builds its own databases in its own ``tmp_path``.
"""

import os
import threading

import numpy as np
import pytest
import torch

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu.runtime.logger import counters as jcounters
from greengage_tpu.storage.blockcache import CacheRegistry as JRegistry
from greengage_tpu_torch.runtime import overload
from greengage_tpu_torch.runtime.faultinject import faults
from greengage_tpu_torch.runtime.logger import counters
from greengage_tpu_torch.storage.blockcache import (CacheRegistry,
                                                    nbytes_of)
from greengage_tpu_torch.storage.corruption import CorruptionError

REGISTRIES = {"jax": (JRegistry, jcounters), "torch": (CacheRegistry,
                                                       counters)}


@pytest.fixture(autouse=True)
def _clean():
    faults.reset()
    yield
    faults.reset()
    overload.CONTROLLER.reset()


def _pair(tmp_path, nseg=8):
    j = greengage_tpu.connect(str(tmp_path / "j"), numsegments=nseg)
    t = greengage_tpu_torch.connect(str(tmp_path / "t"), numsegments=nseg,
                                    device="cpu")
    for db in (j, t):
        db.sql("create table t (k int, v bigint, w bigint) "
               "distributed by (k)")
        db.sql("insert into t values "
               + ",".join(f"({i},{i * 10},{i * 100})" for i in range(256)))
    return j, t


def _data_files(db, table, cols):
    """Manifest-referenced data files a scan of ``cols`` reads."""
    snap = db.store.manifest.snapshot()
    n = 0
    for files in snap["tables"][table]["segfiles"].values():
        for rel in files:
            fn = os.path.basename(rel)
            if fn.endswith(".ggb") and not fn.endswith(".valid.ggb") \
                    and fn.split(".")[0] in cols:
                n += 1
    return n


# ---- the registry itself ----------------------------------------------------

@pytest.mark.parametrize("impl", sorted(REGISTRIES))
def test_lru_evicts_recency_not_insertion_order(impl):
    reg = REGISTRIES[impl][0](limit_mb=1)   # 1 MB budget
    c = reg.cache("x")
    a = np.zeros(300_000, np.uint8)         # ~0.3 MB each
    c.put("k0", a.copy())
    c.put("k1", a.copy())
    c.put("k2", a.copy())
    assert c.get("k0") is not None          # touch the OLDEST -> now MRU
    c.put("k3", a.copy())                   # over budget: k1 goes, not k0
    assert "k0" in c
    assert "k1" not in c


@pytest.mark.parametrize("impl", sorted(REGISTRIES))
def test_byte_budget_spans_caches_and_counts_evictions(impl):
    cls, ctr = REGISTRIES[impl]
    reg = cls(limit_mb=1)
    a, b = reg.cache("a"), reg.cache("b")
    big = np.zeros(600_000, np.uint8)
    before = ctr.get("scan_cache_evict")
    a.put("ka", big.copy())
    b.put("kb", big.copy())                 # pushes the registry over 1 MB
    assert "ka" not in a                    # global LRU: a's entry first
    assert "kb" in b
    assert reg.total_bytes <= reg.limit_bytes()
    assert ctr.get("scan_cache_evict") > before


@pytest.mark.parametrize("impl", sorted(REGISTRIES))
def test_version_invalidation_spares_untagged_entries(impl):
    reg = REGISTRIES[impl][0](limit_mb=64)
    c = reg.cache("x")
    c.put("immutable", 1)                   # no version: a committed file
    c.put("v1", 2, version=1)
    c.put("v2", 3, version=2)
    assert reg.invalidate_versions(2) == 1
    assert "immutable" in c and "v2" in c and "v1" not in c


def test_torch_tensors_count_their_bytes():
    reg = CacheRegistry(limit_mb=1)
    c = reg.cache("stage")
    x = torch.zeros(120_000, dtype=torch.int64)      # 960,000 bytes
    assert nbytes_of(x) == 960_000 + 64
    c.put("a", x)
    assert reg.total_bytes == 960_064
    c.put("b", torch.zeros(50_000, dtype=torch.int32))
    assert "a" not in c and reg.total_bytes == 200_064   # LRU went
    assert nbytes_of(np.zeros(10, np.int16)) == 20 + 64


class _OnCard:
    """What the registry reads of a CUDA tensor (``is_cuda``, its bytes):
    a stand-in for one on the CPU."""
    is_cuda = True

    def __init__(self, n):
        self.n = n

    def element_size(self):
        return 1

    def numel(self):
        return self.n


def test_card_entries_keep_a_budget_of_their_own():
    """Staged tensors on a card are held to the card's budget (half its
    memory), host entries to ``scan_cache_limit_mb``: neither pool evicts
    the other's entries."""
    reg = CacheRegistry(limit_mb=1)
    assert reg.card_limit_bytes() == reg.limit_bytes()   # no card wired
    reg.card_bytes = 8 << 20
    assert reg.card_limit_bytes() == 4 << 20
    blocks, stage = reg.cache("blocks"), reg.cache("stage")
    blocks.put("b0", np.zeros(600_000, np.uint8))
    for i in range(2):
        stage.put(f"s{i}", _OnCard(1_500_000))
    assert "b0" in blocks and len(stage) == 2            # 3.6 MB resident
    assert reg.card_total_bytes == 2 * (1_500_000 + 64)
    blocks.put("b1", np.zeros(600_000, np.uint8))        # the host pool
    assert "b0" not in blocks and len(stage) == 2
    stage.put("s2", _OnCard(1_500_000))                  # the card pool
    assert "s0" not in stage and "b1" in blocks
    st = reg.stats()
    assert st["card_total_bytes"] <= st["card_limit_bytes"] == 4 << 20
    assert st["total_bytes"] - st["card_total_bytes"] <= st["limit_bytes"]
    stage.put("huge", _OnCard(5 << 20))                  # over the budget
    assert "huge" not in stage and len(stage) == 2
    reg.card_bytes = 4 << 20                             # a smaller card
    reg.evict_to_fit()
    assert reg.card_limit_bytes() == 2 << 20
    assert list(stage) == ["s2"] and "b1" in blocks
    assert reg.card_total_bytes == 1_500_064


def test_version_index_follows_replacements_and_evictions():
    """The registry counts the entries of each version tag, so a
    statement whose version every tagged entry carries skips the scan:
    the count follows a replaced key, an eviction and a drop."""
    reg = CacheRegistry(limit_mb=1)
    c = reg.cache("x")
    c.put("a", np.zeros(10), version=1)
    c.put("a", np.zeros(10), version=2)                  # replaced
    assert reg.invalidate_versions(2) == 0 and "a" in c
    c.put("big", np.zeros(100_000, np.uint8), version=1)
    c.put("big2", np.zeros(1_000_000, np.uint8), version=3)  # evicts
    assert "a" not in c and "big" not in c and "big2" in c
    c.put("b", 5, version=4)
    c.drop(lambda k: k == "b")
    assert reg.invalidate_versions(3) == 0 and "big2" in c
    assert reg.invalidate_versions(4) == 1 and len(c) == 0
    assert reg.invalidate_versions(4) == 0


def test_block_decoded_into_a_slot_is_cached_as_its_own_copy(tmp_path):
    """A cold read decodes a block file straight into a staging buffer's
    slot; the cache keeps a copy of its own, charged at its own bytes. So
    evicting part of a buffer's entries leaves the accounted bytes equal
    to what is held, and the cache keeps no staging buffer alive."""
    import gc
    import weakref

    db = greengage_tpu_torch.connect(str(tmp_path / "t"), numsegments=2,
                                     device="cpu")
    try:
        db.sql("create table t (k int, v bigint) distributed by (k)")
        db.load_table("t", {"k": np.arange(4000), "v": np.arange(4000) * 7})
        snap = db.store.manifest.snapshot()
        rels = [next(r for r in snap["tables"]["t"]["segfiles"][str(s)]
                     if os.path.basename(r).startswith("v."))
                for s in range(2)]
        cap = 4000
        buf = torch.empty(2 * cap, dtype=torch.int64)
        view = buf.numpy()
        blocks = db.store.blockcache.cache("blocks")
        blocks.clear()
        for s, rel in enumerate(rels):
            arr = db.store.read_file("t", rel, out=view[s * cap:])
            assert np.shares_memory(arr, view)           # decoded in place
        held = [blocks.peek(("t", rel, None)) for rel in rels]
        assert not any(np.shares_memory(h, view) for h in held)
        assert np.array_equal(np.sort(np.concatenate(held)),
                              np.arange(4000) * 7)
        blocks.pop(("t", rels[0], None))
        assert blocks.bytes == held[1].nbytes + 64
        gone = weakref.ref(buf)
        del buf, view, arr
        gc.collect()
        assert gone() is None
        assert np.array_equal(blocks.peek(("t", rels[1], None)), held[1])
    finally:
        db.close()


# ---- the counters of a directory's scans -----------------------------------

def _io(ctr, base):
    return ctr.since(base, "scan_")


def test_cold_scan_reads_each_file_once_and_repeat_reads_nothing(
        tmp_path, devices8):
    j, t = _pair(tmp_path)
    try:
        expect = _data_files(t, "t", {"v"})
        assert expect == _data_files(j, "t", {"v"}) > 0
        for db, ctr in ((j, jcounters), (t, counters)):
            base = ctr.snapshot()
            r = db.sql("select sum(v) from t")
            assert r.rows()[0][0] == sum(i * 10 for i in range(256))
            io = _io(ctr, base)
            assert io.get("scan_files_read") == expect
            assert io.get("scan_bytes_decoded", 0) >= expect
            # the repeat: served from the staged inputs, no file read
            base = ctr.snapshot()
            db.sql("select sum(v) from t")
            io = _io(ctr, base)
            assert io.get("scan_files_read", 0) == 0
            assert io.get("scan_bytes_decoded", 0) == 0
            # only the staged inputs dropped: the scan re-assembles from
            # the BLOCK cache, no file read and real hits
            db.executor._stage_cache.clear()
            base = ctr.snapshot()
            r = db.sql("select sum(v) from t")
            assert r.rows()[0][0] == sum(i * 10 for i in range(256))
            io = _io(ctr, base)
            assert io.get("scan_files_read", 0) == 0
            assert io.get("scan_cache_hit", 0) > 0
    finally:
        t.close()


def test_per_statement_scan_io_stats_and_explain(tmp_path, devices8):
    j, t = _pair(tmp_path)
    try:
        for db in (j, t):
            db.executor._stage_cache.clear()
            db.store.blockcache.clear()
        r, jr = (db.sql("select sum(v), sum(w) from t") for db in (t, j))
        assert r.stats["scan_io"]["scan_files_read"] \
            == jr.stats["scan_io"]["scan_files_read"] \
            == _data_files(t, "t", {"v", "w"})
        assert r.stats["stage_ms"] >= 0 and r.stats["fetch_ms"] >= 0
        t.executor._stage_cache.clear()
        t.store.blockcache.clear()
        plan = t.sql("explain analyze select sum(v) from t").plan_text
        assert "Host data path: staging" in plan
        assert "Scan I/O:" in plan and "files read" in plan
    finally:
        t.close()


def test_scan_threads_serial_matches_parallel(tmp_path, devices8):
    j, t = _pair(tmp_path)
    try:
        want = sorted(j.sql("select k, v from t").rows())
        assert want == sorted((i, i * 10) for i in range(256))
        for n in (1, 2, 0):
            t.sql(f"set scan_threads = {n}")
            t.executor._stage_cache.clear()
            t.store.blockcache.clear()
            assert sorted(t.sql("select k, v from t").rows()) == want
        assert str(t.settings.show("scan_threads")) == "0"
    finally:
        t.close()


def test_dml_bumps_version_and_scan_sees_new_rows(tmp_path, devices8):
    j, t = _pair(tmp_path)
    try:
        for q in ("select count(*) from t",
                  "insert into t values (9999, 5, 7)",
                  "select count(*), sum(v) from t",
                  "delete from t where k = 9999",
                  "select count(*), sum(v) from t"):
            want, got = j.sql(q), t.sql(q)
            if isinstance(want, str):
                assert got == want
            else:
                assert got.rows() == want.rows()
        assert t.sql("select count(*) from t").rows() == [(256,)]
        assert {k[3] for k in t.executor._stage_cache} \
            == {t.store.manifest.version()}
    finally:
        t.close()


def test_index_build_drops_staged_inputs_so_scans_prune(tmp_path, devices8):
    t = greengage_tpu_torch.connect(str(tmp_path / "idx"), numsegments=8,
                                    device="cpu")
    j = greengage_tpu.connect(str(tmp_path / "jidx"), numsegments=8)
    try:
        for d in (j, t):
            d.sql("create table u (k int, v bigint) distributed by (k)")
            for lo in range(0, 4096, 1024):   # several files a segment
                d.sql("insert into u values "
                      + ",".join(f"({i},{i})" for i in range(lo, lo + 1024)))
            assert d.sql("select sum(v) from u where k = 77").rows()[0][0] \
                == 77
            d.sql("create index u_k on u (k)")
            assert len(d.executor._stage_cache) == 0   # staged inputs gone
        r, jr = (d.sql("select sum(v) from u where k = 77") for d in (t, j))
        assert r.rows() == jr.rows() == [(77,)]
        assert r.stats["zone_prune"] == jr.stats["zone_prune"]
        kept, total = r.stats["zone_prune"]["u"]
        assert kept < total
    finally:
        t.close()


def _first_data_rel(db, table="t"):
    snap = db.store.manifest.snapshot()
    for _seg, rels in sorted(snap["tables"][table]["segfiles"].items(),
                             key=lambda kv: int(kv[0])):
        for rel in rels:
            if rel.endswith(".ggb"):
                return rel
    raise AssertionError("no files")


def test_parallel_readers_quarantine_exactly_once_without_mirror(
        tmp_path, devices8):
    d = greengage_tpu_torch.connect(str(tmp_path / "bare"), numsegments=8,
                                    device="cpu")
    try:
        d.sql("create table t (k int, v bigint) distributed by (k)")
        d.sql("insert into t values "
              + ",".join(f"({i},{i * 10})" for i in range(128)))
        rel = _first_data_rel(d)
        path = os.path.join(str(tmp_path / "bare"), "data", "t", rel)
        with open(path, "r+b") as f:
            f.seek(40)
            b = f.read(1)
            f.seek(40)
            f.write(bytes([b[0] ^ 0xFF]))
        d.store.blockcache.clear()
        before = counters.get("storage_quarantine")
        errors = []

        def read():
            try:
                d.store.read_file("t", rel)
            except (CorruptionError, IOError) as e:
                errors.append(e)

        threads = [threading.Thread(target=read) for _ in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert len(errors) == 6                   # nobody got bad data
        assert counters.get("storage_quarantine") == before + 1
    finally:
        d.close()


def test_scan_cache_limit_mb_bounds_resident_bytes(tmp_path, devices8):
    j, t = _pair(tmp_path)
    try:
        t.sql("set scan_cache_limit_mb = 1")
        t.executor._stage_cache.clear()
        t.store.blockcache.clear()
        t.sql("select sum(v), sum(w), sum(k) from t")
        assert t.store.blockcache.total_bytes <= 1 << 20
        t.sql("set scan_cache_limit_mb = 1024")
    finally:
        t.close()


# ---- the brownout's shrunken budget -----------------------------------------

def test_brownout_entry_evicts_to_the_shrunken_budget(devices8):
    """On entry the session evicts at once: the registry's total is within
    the shrunken limit, the staged tensors are gone from it, and the next
    statement still answers exactly."""
    t = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    try:
        n = 400_000
        t.sql("create table big (k bigint, v bigint) distributed by (k)")
        t.load_table("big", {"k": np.arange(n), "v": np.arange(n) * 3})
        q = "select sum(v), sum(k) from big"
        want = [(3 * n * (n - 1) // 2, n * (n - 1) // 2)]
        assert t.sql(q).rows() == want
        reg = t.store.blockcache
        held = reg.total_bytes
        assert held > 6 << 20               # the staged k, v and @present
        t.sql(f"set scan_cache_limit_mb = {(held >> 20) + 1}")
        assert reg.total_bytes == held       # still fits
        faults.inject("brownout_force", "skip", occurrences=-1)
        assert overload.CONTROLLER.evaluate(t.settings, force=True)
        assert reg.total_bytes == held       # nothing evicted yet
        t.sql("select 1")                    # the tick applies the entry
        assert reg.limit_bytes() <= ((held >> 20) + 1 << 20) // 2
        assert reg.total_bytes <= reg.limit_bytes() < held
        assert len(t.executor._stage_cache) < 3
        assert t.sql(q).rows() == want
    finally:
        faults.reset()
        overload.CONTROLLER.reset()
        t.close()
