"""TPC-H Q1 through the port (greengage_tpu_torch/entry.py) against the JAX
package's SQL engine on the same generated data, at 1 and 8 segments, with
and without the fused aggregation path; the port's entry points; and the
port's independence from JAX.

Tolerances: group keys, sums (DECIMAL, presented as scaled int64 / 10^s)
and counts must be equal. avg may differ by an ulp (relative 1e-12): XLA
compiles the JAX side's division by 10^scale into a multiplication by the
reciprocal, the port divides truly."""

import ast
import os

import numpy as np
import pytest

import torch

import greengage_tpu
from greengage_tpu.utils import tpch as jtpch
from greengage_tpu_torch import entry
from greengage_tpu_torch.config import Settings
from greengage_tpu_torch.ops import fused_agg
from greengage_tpu_torch.types import Coded
from greengage_tpu_torch.utils import tpch as ttpch

SF = 0.002
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

Q1 = """
  select l_returnflag, l_linestatus,
         sum(l_quantity) as sum_qty,
         sum(l_extendedprice) as sum_base_price,
         sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
         sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
         avg(l_quantity) as avg_qty,
         avg(l_extendedprice) as avg_price,
         avg(l_discount) as avg_disc,
         count(*) as count_order
  from lineitem
  where l_shipdate <= date '1998-12-01' - interval '90' day
  group by l_returnflag, l_linestatus
  order by l_returnflag, l_linestatus
"""

AVG_COLS = (6, 7, 8)


@pytest.fixture(scope="module")
def jax_rows(devices8):
    db = greengage_tpu.connect(numsegments=8)
    jtpch.load(db, sf=SF)
    return db.sql(Q1).rows()


@pytest.fixture(scope="module")
def data():
    return ttpch.generate(SF)


def _assert_rows_match(got, want):
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert len(g) == len(w) == 10
        for i, (a, b) in enumerate(zip(g, w)):
            if i in AVG_COLS:
                assert a == pytest.approx(b, rel=1e-12, abs=0), (i, a, b)
            else:
                assert a == b, (i, a, b)
                assert type(a) is type(b), (i, type(a), type(b))


def test_generator_copy_equals_jax_generator(data):
    want = jtpch.generate(SF)["lineitem"]
    for name, v in data["lineitem"].items():
        w = want[name]
        if isinstance(v, Coded):
            assert v.vocab == w.vocab
            assert np.array_equal(v.codes, w.codes)
        else:
            assert np.array_equal(v, w) and v.dtype == w.dtype, name


@pytest.mark.parametrize("nseg", [1, 8])
def test_q1_matches_jax_sql(jax_rows, data, nseg):
    _assert_rows_match(entry.run_q1(data, nseg=nseg, device="cpu"), jax_rows)


def test_q1_fused_path_matches_jax_sql(jax_rows, data, monkeypatch):
    calls = []
    plain = fused_agg._segment_reduce_plain

    def spy(table):
        calls.append((tuple(table.gid.shape), table.D, len(table.slots),
                      len(table.jobs)))
        return plain(table)

    monkeypatch.setattr(fused_agg, "_segment_reduce_plain", spy)
    rows = entry.run_q1(data, nseg=8, device="cpu",
                        settings=Settings(fused_dense_min_rows=1))
    _assert_rows_match(rows, jax_rows)
    # the partial and the final Aggregate both take the fused path here;
    # the partial records 8 jobs (1 live count, 4 sums, 3 avg sums), of
    # which 6 are distinct: avg(l_quantity) and avg(l_extendedprice) sum
    # the same columns as sum_qty and sum_base_price
    assert len(calls) == 2 and calls[0][1:] == (12, 8, 6)
    # at the default gate this tiny lineitem stays on the unfused path
    calls.clear()
    entry.run_q1(data, nseg=8, device="cpu")
    assert calls == []


def test_q1_plan_matches_golden_shape():
    from greengage_tpu_torch.planner.logical import describe

    # describe() is the JAX package's: Filter and Project print their
    # expressions
    assert describe(entry.q1_plan(8)) == """\
Motion Gather  [Entry]
  Sort  [Hashed(l_returnflag#33, l_linestatus#34) x8]
    Project [l_returnflag=g#16, l_linestatus=g#17, sum_qty=sum#19, \
sum_base_price=sum#21, sum_disc_price=sum#23, sum_charge=sum#25]  \
[Hashed(l_returnflag#33, l_linestatus#34) x8]
      Aggregate final keys=(l_returnflag, l_linestatus)  [Hashed(g#16, g#17) x8]
        Motion Redistribute by (g#16, g#17)  [Hashed(g#16, g#17) x8]
          Aggregate partial keys=(l_returnflag, l_linestatus)  [Strewn x8]
            Project [l_returnflag=l_returnflag#8, l_linestatus=l_linestatus#9, \
arg=l_quantity#4, arg=l_extendedprice#5, \
arg=(l_extendedprice#5 * (1 - l_discount#6)), \
arg=((l_extendedprice#5 * (1 - l_discount#6)) * (1 + l_tax#7))]  [Strewn x8]
              Filter (l_shipdate#10 <= 10471)  [Strewn x8]
                Scan lineitem  [Strewn x8]"""


def test_load_lineitem_places_rows_like_storage(data):
    from greengage_tpu.storage import native

    li = data["lineitem"]
    t = entry.load_lineitem(li, 8, "cpu")
    seg = native.hash_i64(li["l_orderkey"]) % np.uint32(8)
    present = t.present.numpy()
    for s in range(8):
        idx = np.nonzero(seg == s)[0]
        assert present[s].sum() == len(idx)
        got = t.cols["l_extendedprice"][s].numpy()[present[s]]
        assert np.array_equal(got, li["l_extendedprice"][idx])


def test_entry_step_matches_jax_entry():
    import __graft_entry__ as jentry

    jfn, jargs = jentry.entry()
    want = jfn(*jargs)
    fn, args = entry.entry("cpu")
    got = fn(*args)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k][0].numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, err_msg=k)
        else:
            assert np.array_equal(g, w), k


def test_dryrun_step_exact_sum():
    assert entry.dryrun_step(8, "cpu") == 983


def test_entry_points_default_to_the_gpu(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.run_q1(data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()


def _port_sources():
    pkg = os.path.join(REPO, "greengage_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 15
    # the walk covers every subpackage, the SQL front end's included
    rel = {os.path.relpath(p, REPO) for p in sources}
    for sub, module in [("sql", "parser.py"), ("sql", "binder.py"),
                        ("catalog", "catalog.py"), ("storage", "table_store.py"),
                        ("runtime", "logger.py"), ("planner", "planner.py"),
                        ("exec", "session.py"), ("ops", "scalar.py"),
                        ("ops", "join.py"), ("ops", "window.py"),
                        ("utils", "tpcds.py"), ("exec", "spill.py"),
                        ("exec", "workfile.py"), ("exec", "staging.py"),
                        ("exec", "motionpipe.py"), ("sql", "paramize.py"),
                        ("exec", "batchserve.py"),
                        ("runtime", "faultinject.py"),
                        ("runtime", "interrupt.py"), ("runtime", "trace.py"),
                        ("runtime", "runaway.py"), ("runtime", "resqueue.py"),
                        ("runtime", "resgroup.py"), ("runtime", "server.py"),
                        ("runtime", "overload.py"), ("runtime", "auth.py"),
                        ("runtime", "memaccount.py"),
                        ("runtime", "retry.py"), ("runtime", "lockdebug.py"),
                        ("runtime", "fts.py"), ("planner", "feedback.py"),
                        ("mgmt", "cli.py"), ("contrib", "geo.py"),
                        ("utils", "plancorpus.py"),
                        ("analysis", "plancheck.py"),
                        ("storage", "corruption.py"),
                        ("storage", "native.py"), ("storage", "blockfile.py"),
                        ("storage", "manifest.py"),
                        ("storage", "blockcache.py")]:
        assert os.path.join("greengage_tpu_torch", sub, module) in rel
    assert "chip_smoke.py" in rel
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "greengage_tpu"), \
                    f"{os.path.relpath(path, REPO)} imports {name}"
