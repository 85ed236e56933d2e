"""The port's hash join (greengage_tpu_torch/ops/join.py) against the JAX
package's (greengage_tpu/ops/join.py), segment by segment, and the join
retry rules of the port's executor against the JAX executor's.

The same numpy inputs (from a seed) go through both; the port runs every
segment as one row of an ``[nseg, n]`` tensor, the JAX side one segment at
a time. Every output must be equal: build tables (sorted keys, build rows,
hop pointers, bucket offsets, run heads), probe matches and build rows,
expansions, flags and totals. Packed words compare through their unsigned
value (the port carries the signed image of the JAX package's uint32 or
uint64 word).

Tolerances: none; joins move rows and integers only."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu.ops import agg as jagg
from greengage_tpu.ops import join as jjoin
from greengage_tpu_torch import types as TT
from greengage_tpu_torch.exec.executor import QueryError
from greengage_tpu_torch.ops import agg as tagg
from greengage_tpu_torch.ops import join as tjoin
from greengage_tpu_torch.sql.parser import parse as tparse

NSEG, N_BUILD, N_PROBE = 3, 400, 700


def _unsigned(word):
    """The port's signed image of a packed word -> the JAX word's value."""
    return (word.numpy().view(np.uint64) ^ np.uint64(1 << 63))


def _specs(cols, valids, types, s=None):
    """(port KeySpecs over every segment, JAX KeySpecs of segment s)."""
    if s is None:
        return [tagg.KeySpec(torch.from_numpy(c),
                             None if v is None else torch.from_numpy(v), t)
                for c, v, t in zip(cols, valids, types)]
    return [jagg.KeySpec(jnp.asarray(c[s]),
                         None if v is None else jnp.asarray(v[s]), None)
            for c, v in zip(cols, valids)]


def _eq(t, j, name):
    assert np.array_equal(np.asarray(t), np.asarray(j)), name


CASES = {
    # name: (key dtypes, nullable, key range, packed, num_probes)
    "int64 unique-ish": ([np.int64], True, (0, 2000), False, 32),
    "int64 duplicates": ([np.int64], True, (0, 60), False, 32),
    "int64 packed": ([np.int64], False, (5, 300), True, 32),
    "two keys, int32 + int64": ([np.int32, np.int64], True, (0, 20), False,
                                32),
    "two keys packed": ([np.int32, np.int64], False, (0, 20), True, 32),
    "float keys with -0.0": ([np.float64], True, (-3, 4), False, 32),
    "one hop: walk overflow": ([np.int64], False, (0, 40), False, 1),
}


def _key_columns(name, seed, n):
    dtypes, nullable, (lo, hi), _, _ = CASES[name]
    rng = np.random.default_rng(seed)
    cols, valids = [], []
    for dt in dtypes:
        c = rng.integers(lo, hi, (NSEG, n))
        if dt == np.float64:
            c = c.astype(np.float64) * 0.5
            c[c == 0] = np.where(rng.random((c == 0).sum()) < 0.5, -0.0, 0.0)
        cols.append(c.astype(dt))
        valids.append(rng.random((NSEG, n)) >= 0.1 if nullable else None)
    sel = rng.random((NSEG, n)) < 0.85
    types = [TT.FLOAT64 if dt == np.float64 else TT.INT64 for dt in dtypes]
    return cols, valids, sel, types


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_and_probe_match_jax(name):
    _, _, (lo, hi), packed, probes = CASES[name]
    bcols, bvalids, bsel, types = _key_columns(name, 1, N_BUILD)
    pcols, pvalids, psel, _ = _key_columns(name, 2, N_PROBE)
    bounds = [(lo, hi - 1)] * len(bcols) if packed else None
    M = 256
    tt = tjoin.build(_specs(bcols, bvalids, types), torch.from_numpy(bsel), M,
                     probes, bounds)
    tm, trow, tov = tjoin.probe(tt, _specs(pcols, pvalids, types),
                                torch.from_numpy(psel), probes)
    any_ov, dups = False, []
    for s in range(NSEG):
        jt = jjoin.build(_specs(bcols, bvalids, types, s), jnp.asarray(bsel[s]),
                         M, probes, bounds)
        for tk, jk in zip(tt.keys_sorted, jt.keys_sorted):
            got = _unsigned(tk[s]) if packed else tk[s].numpy()
            _eq(got, np.asarray(jk).astype(got.dtype), "keys_sorted")
        _eq(tt.rows_sorted[s], jt.rows_sorted, "rows_sorted")
        _eq(tt.next_head[s], jt.next_head, "next_head")
        _eq(tt.starts[s], jt.starts, "starts")
        _eq(tt.counts[s], jt.counts, "counts")
        assert int(tt.n_live[s]) == int(jt.n_live)
        jm, jrow, jov = jjoin.probe(jt, _specs(pcols, pvalids, types, s),
                                    jnp.asarray(psel[s]), probes)
        _eq(tm[s], jm, "matched")
        _eq(trow[s], jrow, "build_row")
        any_ov |= bool(jov)
        dups.append(bool(jt.dup))
        if packed:
            assert not bool(jt.pack_viol) and not bool(tt.pack_viol)
    assert bool(tov) == any_ov
    assert bool(tt.dup) == any(dups)
    if name == "one hop: walk overflow":
        assert any_ov
    if name == "int64 duplicates":
        assert bool(tt.dup)
    if name == "float keys with -0.0":
        assert bool(tm.any())


@pytest.mark.parametrize("left_outer", [False, True])
@pytest.mark.parametrize("out_cap", [64, 4096])
def test_probe_multi_matches_jax(left_outer, out_cap):
    name = "int64 duplicates"
    bcols, bvalids, bsel, types = _key_columns(name, 3, N_BUILD)
    pcols, pvalids, psel, _ = _key_columns(name, 4, N_PROBE)
    tt = tjoin.build_multi(_specs(bcols, bvalids, types),
                           torch.from_numpy(bsel), 256, 32)
    out = tjoin.probe_multi(tt, _specs(pcols, pvalids, types),
                            torch.from_numpy(psel), 32, out_cap, left_outer)
    jov = False
    for s in range(NSEG):
        jt = jjoin.build_multi(_specs(bcols, bvalids, types, s),
                               jnp.asarray(bsel[s]), 256, 32)
        jout = jjoin.probe_multi(jt, _specs(pcols, pvalids, types, s),
                                 jnp.asarray(psel[s]), 32, out_cap,
                                 left_outer)
        for i, nm in enumerate(["present", "probe_row", "build_row",
                                "matched"]):
            _eq(out[i][s], jout[i], nm)
        assert int(out[6][s]) == int(jout[6])        # total
        jov |= bool(jout[4])
        assert not bool(jout[5])
    assert bool(out[4]) == jov                       # expansion overflow
    assert jov == (out_cap == 64)
    assert not bool(out[5])


def test_build_pack_violation_matches_jax():
    """Build keys past the advertised bounds: the port raises pack_viol
    where the JAX package does, and drops those rows from the table."""
    bcols, bvalids, bsel, types = _key_columns("int64 packed", 5, N_BUILD)
    bounds = [(5, 200)]     # the data reaches 299
    tt = tjoin.build(_specs(bcols, bvalids, types), torch.from_numpy(bsel),
                     256, 32, bounds)
    assert bool(tt.pack_viol)
    for s in range(NSEG):
        jt = jjoin.build(_specs(bcols, bvalids, types, s),
                         jnp.asarray(bsel[s]), 256, 32, bounds)
        assert bool(jt.pack_viol)
        _eq(tt.rows_sorted[s], jt.rows_sorted, "rows_sorted")
        assert int(tt.n_live[s]) == int(jt.n_live)


@pytest.mark.parametrize("case", ["unique", "duplicates", "out of domain"])
def test_direct_build_and_probe_match_jax(case):
    rng = np.random.default_rng(6)
    lo, domain = 10, 500
    if case == "unique":
        bk = np.stack([rng.permutation(domain)[:N_BUILD] + lo
                       for _ in range(NSEG)])
    elif case == "duplicates":
        bk = rng.integers(lo, lo + domain, (NSEG, N_BUILD))
    else:
        bk = rng.integers(lo - 20, lo + domain + 20, (NSEG, N_BUILD))
    bv = rng.random((NSEG, N_BUILD)) >= 0.05
    bsel = rng.random((NSEG, N_BUILD)) < 0.9
    pk = rng.integers(lo - 5, lo + domain + 5, (NSEG, N_PROBE))
    psel = rng.random((NSEG, N_PROBE)) < 0.9
    tkey = tagg.KeySpec(torch.from_numpy(bk), torch.from_numpy(bv), TT.INT64)
    table = tjoin.build_direct(tkey, torch.from_numpy(bsel), lo, domain)
    tm, trow = tjoin.probe_direct(
        table, tagg.KeySpec(torch.from_numpy(pk), None, TT.INT64),
        torch.from_numpy(psel), lo)
    dup = ov = False
    for s in range(NSEG):
        jt = jjoin.build_direct(
            jagg.KeySpec(jnp.asarray(bk[s]), jnp.asarray(bv[s]), None),
            jnp.asarray(bsel[s]), lo, domain)
        _eq(table.slot_row[s], jt.slot_row, "slot_row")
        _eq(table.used[s], jt.used, "used")
        jm, jrow = jjoin.probe_direct(
            jt, jagg.KeySpec(jnp.asarray(pk[s]), None, None),
            jnp.asarray(psel[s]), lo)
        _eq(tm[s], jm, "matched")
        _eq(trow[s], jrow, "build_row")
        dup |= bool(jt.dup)
        ov |= bool(jt.overflow)
    assert bool(table.dup) == dup == (case != "unique")
    assert bool(table.overflow) == ov == (case == "out of domain")


def test_gather_build_columns_null_extends_unmatched():
    vals = torch.arange(12).reshape(2, 6)
    valid = torch.tensor([[True, False] * 3] * 2)
    row = torch.tensor([[0, 1, 5, 2], [3, 3, 0, 4]])
    matched = torch.tensor([[True, True, False, True], [True, False, True,
                                                        True]])
    cols, valids = tjoin.gather_build_columns({"a": vals, "b": vals},
                                              {"a": valid, "b": None}, row,
                                              matched)
    assert cols["a"].tolist() == [[0, 1, 5, 2], [9, 9, 6, 10]]
    assert valids["a"].tolist() == [[True, False, False, True],
                                    [False, False, True, True]]
    assert valids["b"].tolist() == matched.tolist()


def test_walk_reads_the_host_once_for_a_short_walk(monkeypatch):
    """The probe walk asks the host whether a probe is still active only
    after hops 2, 4, 8, ...: a table with no chains longer than two hops
    costs one read."""
    reads = []
    real_bool = torch.Tensor.__bool__

    def counting_bool(self):
        reads.append(1)
        return real_bool(self)

    bcols, bvalids, bsel, types = _key_columns("int64 unique-ish", 7,
                                               N_BUILD)
    pcols, pvalids, psel, _ = _key_columns("int64 unique-ish", 8, N_PROBE)
    table = tjoin.build(_specs(bcols, bvalids, types), torch.from_numpy(bsel),
                        1 << 14, 32)
    monkeypatch.setattr(torch.Tensor, "__bool__", counting_bool)
    tjoin.probe(table, _specs(pcols, pvalids, types), torch.from_numpy(psel),
                32)
    monkeypatch.undo()
    assert len(reads) == 1


# ---- the executor's retry rules, against the JAX executor ----------------

def _pair_dbs(nseg, ddl, tables, settings=()):
    jdb = greengage_tpu.connect(numsegments=nseg)
    jdb.sql("set cost_feedback = off")
    tdb = greengage_tpu_torch.connect(numsegments=nseg, device="cpu")
    for db in (jdb, tdb):
        db.sql(ddl)
        for name, (cols, valids) in tables.items():
            db.load_table(name, cols, valids)
        db.sql("analyze")
        for k, v in settings:
            db.sql(f"set {k} = {v}")
    return jdb, tdb


def _fact_dim(n_fact=6000, n_dim=1500, seed=9):
    rng = np.random.default_rng(seed)
    dim = {"d_id": np.arange(1, n_dim + 1),
           "d_v": rng.integers(0, 1000, n_dim)}
    fact = {"f_id": np.arange(n_fact),
            "f_d": rng.integers(1, n_dim + 1, n_fact),
            "f_v": rng.integers(-500, 500, n_fact)}
    return fact, dim


FD_DDL = ("create table dim (d_id bigint, d_v bigint) distributed by (d_id);"
          "create table fact (f_id bigint, f_d bigint, f_v bigint) "
          "distributed by (f_id)")


def test_walk_overflow_retries_at_the_next_tier():
    """hash_num_probes = 1 leaves chained probes active after the first
    hop: the join flags a walk overflow and the retry (twice the hops, a
    4x table) answers. The direct-addressed join is not taken past tier 0,
    so the hash table is what runs."""
    fact, dim = _fact_dim()
    jdb, tdb = _pair_dbs(4, FD_DDL, {"fact": (fact, None), "dim": (dim, None)},
                         [("hash_num_probes", 1)])
    q = ("select f_d, count(*), sum(d_v) from fact join dim on f_d = d_id "
         "where d_v < 990 group by f_d order by f_d")
    planned, consts, _ = tdb._plan(tparse(q)[0])
    got = tdb.executor.run(planned, consts, no_direct=True)
    assert got.stats["tiers_used"] > 1
    assert got.rows() == jdb.sql(q).rows()


def test_expansion_overflow_retries_at_its_exact_total():
    """A multi-match join whose pair estimate (|L||R|/NDV from ANALYZE)
    falls far short after rows of one key are appended: the expansion
    flags its overflow with the exact pair count and the retry sizes its
    output from it."""
    rng = np.random.default_rng(10)
    a = {"k": rng.integers(0, 300, 3000), "v": np.arange(3000)}
    b = {"k": rng.integers(0, 300, 200), "w": np.arange(200)}
    ddl = ("create table ja (k bigint, v bigint) distributed randomly;"
           "create table jb (k bigint, w bigint) distributed randomly")
    jdb, tdb = _pair_dbs(2, ddl, {"ja": (a, None), "jb": (b, None)})
    for db in (jdb, tdb):
        db.load_table("ja", {"k": np.zeros(3000, np.int64),
                             "v": np.arange(3000)})
        db.load_table("jb", {"k": np.zeros(200, np.int64),
                             "w": np.arange(200)})
    q = "select count(*), sum(v), sum(w) from ja join jb on ja.k = jb.k"
    got = tdb.sql(q)
    assert got.stats["tiers_used"] > 1
    assert got.rows() == jdb.sql(q).rows()
    ka = np.concatenate([a["k"], np.zeros(3000, np.int64)])
    kb = np.concatenate([b["k"], np.zeros(200, np.int64)])
    assert got.rows()[0][0] == int(
        (ka[:, None] == kb[None, :]).sum())


def test_pack_violation_after_an_append_reruns_unpacked():
    """Rows appended after ANALYZE fall outside the build key's analyzed
    bounds: the packed hash join flags the violation and the retry runs
    unpacked at the same tier."""
    fact, dim = _fact_dim()
    jdb, tdb = _pair_dbs(4, FD_DDL, {"fact": (fact, None), "dim": (dim, None)})
    more_dim = {"d_id": np.arange(5000, 5100), "d_v": np.arange(100)}
    more_fact = {"f_id": np.arange(6000, 6100), "f_d": np.arange(5000, 5100),
                 "f_v": np.ones(100, np.int64)}
    for db in (jdb, tdb):
        db.load_table("dim", more_dim)
        db.load_table("fact", more_fact)
    q = ("select count(*), sum(f_v), sum(d_v) from fact join dim "
         "on f_d = d_id")
    planned, consts, _ = tdb._plan(tparse(q)[0])
    got = tdb.executor.run(planned, consts, no_direct=True)
    assert got.stats["attempts"] == 2 and got.stats["tiers_used"] == 1
    assert got.rows() == jdb.sql(q).rows()


def test_duplicate_build_keys_replan_as_multi_match():
    """tests/test_sql.py's self-join on a duplicated distribution key: the
    unique-key plan meets duplicate build keys, the executor raises
    QueryError (join_dup) and the session re-plans with multi-match joins,
    then remembers that for the statement."""
    dup = {"k": np.array([1, 1, 2, 3, 4, 5, 6, 7]), "v": np.arange(1, 9)}
    ddl = "create table dup_b (k int, v int) distributed by (k)"
    jdb, tdb = _pair_dbs(8, ddl, {"dup_b": (dup, None)})
    q = ("select a.v av, b.v bv from dup_b a join dup_b b on a.k = b.k "
         "order by av, bv")
    planned, consts, _ = tdb._plan(tparse(q)[0])
    with pytest.raises(QueryError, match="duplicate keys"):
        tdb.executor.run(planned, consts)
    first = tdb.sql(q)
    assert first.stats["multi_join_replan"] is True
    assert len(first) == 10      # k=1 expands 2x2, six other keys 1x1
    assert first.rows() == jdb.sql(q).rows()
    again = tdb.sql(q)
    assert again.stats["multi_join_replan"] is False
    assert again.rows() == first.rows()
