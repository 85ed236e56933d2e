"""One port ``Database`` under many threads, as the JAX session is served
(one thread per connection).

The JAX session keeps each statement's plan-cache outcome per thread and
its caches under locks; the port does the same: ``_plan_cache_info`` is a
``threading.local``, the bound-plan LRU and the executor's stage cache and
cap hints are locked. Here 12 threads run warm and cold statement shapes
in 3 rounds on one Database with a small LRU (evictions race lookups);
every statement's rows equal the JAX package's serial rows for the same
text, and its ``stats["plan_cache"]`` is its own: the hoisted-parameter
count of its shape, and plan-cache counter deltas equal to the misses and
hits the statements report. Afterwards the LRU and the cap hints hold
their bound, and the warmed shapes hit serially.
``Database._plan`` is slowed by a millisecond so a statement's
plan-and-report window spans other threads' statements (the GIL alone
hides the races these locks close).
"""

import threading
import time

import numpy as np
import pytest

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu_torch.exec.session import Database
from greengage_tpu_torch.runtime.logger import counters

N = 3000


def _cols():
    rng = np.random.default_rng(11)
    return {"k": np.arange(N, dtype=np.int32),
            "a": rng.permutation(N).astype(np.int32),
            "v": rng.integers(0, 100, N).astype(np.int32),
            "g": (np.arange(N) % 7).astype(np.int32),
            "p": np.round(rng.uniform(0, 500, N), 2)}


DDL = ("create table t (k int, a int, v int, g int, p decimal(12,2)) "
       "distributed by (k)")

# shape -> (statement for a value i, hoisted parameters of the shape)
SHAPES = {
    "count": (lambda i: f"select count(*), sum(v) from t where a > {i}", 1),
    "groups": (lambda i: f"select g, count(*), sum(p) from t where a "
                         f"between {i} and {i + 900} group by g order by g",
               2),
    "three": (lambda i: f"select sum(v), min(p) from t where a > {i} and "
                        f"v < {i % 90 + 5} and g <> {i % 7}", 3),
    "top": (lambda i: f"select k, p from t where a < {i} order by p desc, "
                      "k limit 5", 1),
    # equality on the distribution key stays pinned in the plan key
    "pinned": (lambda i: f"select a, v from t where k = {i % 4}", 0),
}
WARM = ("count", "three")


def _statements(thread: int, rnd: int):
    out = []
    for j, (name, (fn, _n)) in enumerate(sorted(SHAPES.items())):
        out.append((name, fn(37 * thread + 101 * rnd + 13 * j + 50)))
    return out[thread % len(out):] + out[:thread % len(out)]


@pytest.fixture(scope="module")
def oracle(devices8):
    """The JAX package's serial rows for every statement text."""
    d = greengage_tpu.connect(numsegments=4)
    d.sql(DDL)
    d.load_table("t", _cols())
    d.sql("analyze")
    texts = {q for th in range(12) for r in range(3)
             for _n, q in _statements(th, r)}
    texts |= {fn(7) for fn, _n in SHAPES.values()}
    return {q: d.sql(q).rows() for q in sorted(texts)}


def test_many_threads_get_their_own_rows_and_plan_cache_stats(
        oracle, monkeypatch):
    db = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    try:
        db.sql(DDL)
        db.load_table("t", _cols())
        db.sql("analyze")
        db.sql("set plan_cache_size = 4")
        for name in WARM:
            db.sql(SHAPES[name][0](7))
        real_plan = Database._plan

        def slow_plan(self, *a, **kw):
            time.sleep(0.001)
            return real_plan(self, *a, **kw)

        monkeypatch.setattr(Database, "_plan", slow_plan)
        base = counters.snapshot()
        got, errors = [], []
        mu = threading.Lock()
        start = threading.Barrier(12)

        def worker(th):
            try:
                start.wait()
                for rnd in range(3):
                    for name, q in _statements(th, rnd):
                        r = db.sql(q)
                        with mu:
                            got.append((name, q, r.rows(),
                                        dict(r.stats["plan_cache"])))
            except Exception as e:   # noqa: BLE001 — the assertion surface
                errors.append(e)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(12)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in ts)
        assert not errors, errors
        assert len(got) == 12 * 3 * len(SHAPES)
        delta = counters.since(base, "plan_cache_")
        for name, q, rows, pc in got:
            assert rows == oracle[q], q
            assert pc["params"] == SHAPES[name][1], (q, pc)
            assert pc["fallback"] is False, (q, pc)
        hits = sum(pc["hit"] for _n, _q, _r, pc in got)
        assert delta.get("plan_cache_hit", 0) == hits
        assert delta.get("plan_cache_miss", 0) == len(got) - hits
        # the LRU and the cap hints hold their bound (a statement whose
        # plan another thread evicted while it ran records its hints after
        # the eviction, in both packages: the hints' own LRU bounds them)
        assert len(db._select_cache) <= 4
        assert len(db.executor._cap_hints) <= 4
        # with more live shapes than the LRU holds, a warmed shape may miss
        # again under the threads: the serial replay pins the hit flag
        monkeypatch.undo()
        db.sql("set plan_cache_size = 256")
        for name in WARM:
            db.sql(SHAPES[name][0](7))
            r = db.sql(SHAPES[name][0](8))
            assert r.stats["plan_cache"] == {
                "hit": True, "params": SHAPES[name][1], "fallback": False}
    finally:
        db.close()
