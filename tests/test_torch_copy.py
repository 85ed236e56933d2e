"""COPY in the port against the JAX package: the file-COPY and SREH cases
of tests/test_ingest.py (lines 62-90) replayed, a COPY TO round trip, and
the native reader held to the quoting-aware one.

Each case COPYs the same file into a table of ``greengage_tpu.connect``
and of ``greengage_tpu_torch.connect(..., device="cpu")`` (each in its own
directory under the test's ``tmp_path``) and holds the command tag, the
rejected-row log and the rows equal. A gpfdist:// source is the ingest
plane's (ROADMAP Queue 1 item 10) and raises naming it.
"""

import numpy as np
import pytest

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu_torch import types as T
from greengage_tpu_torch.catalog import (Column, DistPolicy, PolicyKind,
                                         TableSchema)
from greengage_tpu_torch.sql.parser import SqlError
from greengage_tpu_torch.storage import csv_native, native
from torch_breadth import assert_rows_match

DDL = ("create table ld (id int, qty decimal(10,2), tag text) "
       "distributed by (id)")
ROWS = "select id, qty, tag from ld order by id"


@pytest.fixture()
def pair(tmp_path, devices8):
    j = greengage_tpu.connect(str(tmp_path / "j"), numsegments=4)
    t = greengage_tpu_torch.connect(str(tmp_path / "t"), numsegments=4,
                                    device="cpu")
    for db in (j, t):
        db.sql(DDL)
    yield j, t
    t.close()


def _write_csv(path, nrows=5000, bad_lines=()):
    with open(path, "w") as f:
        f.write("id,qty,tag\n")
        for i in range(nrows):
            if i in bad_lines:
                f.write(f"{i},not-a-number,t{i % 7}\n")
            else:
                f.write(f"{i},{i}.25,t{i % 7}\n")


def _both(pair, text):
    j, t = pair
    want, got = j.sql(text), t.sql(text)
    if isinstance(want, str):
        assert got == want
        return got
    assert_rows_match(got.rows(), want.rows(), text)
    return got


def test_copy_a_file(pair, tmp_path):
    p = str(tmp_path / "ld.csv")
    _write_csv(p, nrows=4000)
    assert _both(pair, f"copy ld from '{p}' with (header true)") \
        == "COPY 4000"
    _both(pair, "select count(*), min(id), max(id), sum(qty) from ld")
    _both(pair, ROWS)


def test_sreh_reject_limit_holds(pair, tmp_path):
    p = str(tmp_path / "bad.csv")
    _write_csv(p, nrows=1000, bad_lines=(10, 500, 900))
    tag = _both(pair, f"copy ld from '{p}' with (header true, "
                      "segment_reject_limit 5)")
    assert tag.startswith("COPY 997") and "rejected 3" in tag
    j, t = pair
    log, jlog = t.error_log("ld"), j.error_log("ld")
    assert len(log) == 3
    assert [(e["line"], e["row"], e["error"]) for e in log] \
        == [(e["line"], e["row"], e["error"]) for e in jlog]
    assert any(e["line"] == 12 for e in log)   # 1-based, header included
    _both(pair, ROWS)


def test_sreh_reject_limit_exceeded_aborts(pair, tmp_path):
    p = str(tmp_path / "vbad.csv")
    _write_csv(p, nrows=100, bad_lines=tuple(range(0, 60)))
    for db in pair:
        with pytest.raises(Exception, match="REJECT LIMIT"):
            db.sql(f"copy ld from '{p}' with (header true, "
                   "segment_reject_limit 10)")
    _both(pair, "select count(*) from ld")


def test_no_reject_limit_aborts_on_first_bad_row(pair, tmp_path):
    p = str(tmp_path / "one.csv")
    _write_csv(p, nrows=50, bad_lines=(25,))
    j, t = pair
    with pytest.raises(Exception, match="COPY line 27"):
        j.sql(f"copy ld from '{p}' with (header true)")
    with pytest.raises(SqlError, match="COPY line 27"):
        t.sql(f"copy ld from '{p}' with (header true)")
    _both(pair, "select count(*) from ld")


def test_quoted_fields_delimiter_and_null_marker(pair, tmp_path):
    """Quoted fields and a NULL marker take the quoting-aware reader in
    both packages; a custom delimiter the native one."""
    p = str(tmp_path / "q.csv")
    with open(p, "w") as f:
        f.write('1,1.50,"a, b"\n2,NA,"say ""hi"""\n3,3.00,NA\n')
    assert _both(pair, f"copy ld from '{p}' with (null 'NA')") == "COPY 3"
    p2 = str(tmp_path / "d.csv")
    with open(p2, "w") as f:
        f.write("4|4.75|x\n5||y\n")
    assert _both(pair, f"copy ld from '{p2}' with (delimiter '|')") \
        == "COPY 2"
    _both(pair, ROWS)


def test_copy_to_round_trip(pair, tmp_path):
    """COPY ld TO a file (the port's; the JAX package has no COPY TO),
    then COPY that file FROM into a fresh table of both packages: the
    rows come back whole, NULLs and quoted text included."""
    j, t = pair
    p = str(tmp_path / "ld.csv")
    _write_csv(p, nrows=300)
    _both(pair, f"copy ld from '{p}' with (header true)")
    _both(pair, "insert into ld values (1000, null, 'a, \"quoted\" b'), "
                "(1001, 2.50, null)")
    out = str(tmp_path / "out.csv")
    assert t.sql(f"copy ld to '{out}' with (header true)") == "COPY 302"
    for db in pair:
        db.sql(DDL.replace("ld", "ld2"))
    _both(pair, f"copy ld2 from '{out}' with (header true)")
    want = j.sql(ROWS).rows()
    assert_rows_match(t.sql(ROWS.replace("ld", "ld2")).rows(), want)
    assert_rows_match(j.sql(ROWS.replace("ld", "ld2")).rows(), want)


def test_gpfdist_source_raises_naming_its_item(pair):
    with pytest.raises(SqlError, match="item 10"):
        pair[1].sql("copy ld from 'gpfdist://localhost:1/ld.csv'")


def test_native_reader_equals_the_quoting_aware_one(tmp_path):
    """parse_file (the codec's field index and parsers, where the codec
    library is built) against parse_csv_rows on one file of every type the
    fast path takes."""
    schema = TableSchema("x", [
        Column("a", T.INT64, True), Column("b", T.FLOAT64, True),
        Column("c", T.DATE, True), Column("d", T.decimal(2), True),
        Column("e", T.TEXT, True)], DistPolicy(PolicyKind.RANDOM, (), 1))
    rng = np.random.default_rng(3)
    p = str(tmp_path / "x.csv")
    with open(p, "w") as f:
        for i in range(500):
            a = "" if i % 17 == 0 else str(int(rng.integers(-10**12, 10**12)))
            f.write(f"{a},{rng.normal():.6f},1995-{1 + i % 12:02d}-"
                    f"{1 + i % 28:02d},{rng.integers(-99999, 99999) / 100},"
                    f"w{i % 9}\n")
    text = open(p).read()
    cols, valids, rejects = csv_native.parse_csv_rows(text, schema, ",",
                                                      False, "")
    assert not rejects
    if native.route() != "native":
        with pytest.raises(csv_native.CsvFallback):
            csv_native.parse_file(p, schema)
        return
    ncols, nvalids = csv_native.parse_file(p, schema)
    for c in schema.columns:
        if c.type.kind is T.Kind.TEXT:
            assert ncols[c.name] == cols[c.name]
        else:
            np.testing.assert_array_equal(
                ncols[c.name], np.array(cols[c.name], c.type.np_dtype))
        want_v = np.array(valids[c.name], bool)
        got_v = nvalids.get(c.name, np.ones(len(want_v), bool))
        np.testing.assert_array_equal(got_v, want_v)
