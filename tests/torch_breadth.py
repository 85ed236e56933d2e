"""Shared helpers of the tests/test_torch_sql_breadth_*.py files: the
read-only statements of a JAX test file, the JAX fixture's tables copied
into the port, and the row comparison.

``statements(path)`` reads a JAX test file with ``ast`` and returns every
constant SELECT or WITH text passed to ``.sql(...)`` inside a test
function, as (test name, ordinal, text), so the breadth tests replay the
statements the JAX suite holds without importing it.

``mirror(jdb, tdb)`` builds the port's copy of a database a JAX fixture
made with INSERTs or loads: each table's DDL from its catalog entry, its
committed rows read segment by segment from the JAX store and loaded into
the port through ``load_table``, TEXT as ``Coded`` over the JAX
dictionary. Hash-distributed rows land on the same segments in the same
order in the port (the placement hash is bit-identical); a replicated
table is loaded from its first segment.

``assert_rows_match``: integers, DECIMAL (presented from scaled int64),
dates, text and NULLs equal exactly and in type; float64 values within
1e-12 relative, the reordered-summation ulps of a different reduction
order. A DECIMAL value differs from another by at least one unit of its
scale, far above that bound at these values.
"""

from __future__ import annotations

import ast

import numpy as np

FLOAT_RTOL = 1e-12


def _text(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _text(node.left), _text(node.right)
        if a is not None and b is not None:
            return a + b
    return None


def statements(path: str, tests=None,
               receiver: str | None = None) -> list[tuple[str, int, str]]:
    """(test function, ordinal within it, text) of every constant SELECT /
    WITH statement the file's test functions send through ``.sql`` (of
    the fixture named ``receiver`` alone, when given)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []
    for node in tree.body:
        if not isinstance(node, ast.FunctionDef) \
                or not node.name.startswith("test_"):
            continue
        if tests is not None and node.name not in tests:
            continue
        calls = sorted((c for c in ast.walk(node)
                        if isinstance(c, ast.Call)
                        and isinstance(c.func, ast.Attribute)
                        and c.func.attr == "sql" and c.args
                        and (receiver is None
                             or getattr(c.func.value, "id", None)
                             == receiver)),
                       key=lambda c: (c.lineno, c.col_offset))
        k = 0
        for c in calls:
            text = _text(c.args[0])
            if text is None:
                continue
            head = text.lstrip().lower()
            if head.startswith(("select", "with")):
                out.append((node.name, k, text))
                k += 1
    return out


def mirror(jdb, tdb, tables=None) -> None:
    """Copy the JAX Database's tables into the port's (see the module
    docstring)."""
    from greengage_tpu_torch import types as TT
    from greengage_tpu_torch.catalog import TableSchema

    jsnap = jdb.store.manifest.snapshot()
    for name in (tables or list(jdb.catalog.tables)):
        js = jdb.catalog.get(name)
        d = js.to_dict()
        schema = TableSchema.from_dict(d)
        tdb.catalog.create_table(schema)
        kind = d["policy"]["kind"] if isinstance(d.get("policy"), dict) \
            else None
        segs = range(js.policy.numsegments)
        if str(kind).lower().startswith("rep") \
                or js.policy.kind.name == "REPLICATED":
            segs = range(1)
        parts, vparts = [], []
        for s in segs:
            cols, valids, _n = jdb.store.read_segment(
                name, s, js.column_names, jsnap)
            parts.append(cols)
            vparts.append(valids)
        cols, valids = {}, {}
        for c in js.columns:
            arr = (np.concatenate([p[c.name] for p in parts]) if parts
                   else np.empty(0, c.type.np_dtype))
            if any(v.get(c.name) is not None for v in vparts):
                valids[c.name] = np.concatenate(
                    [v[c.name] if v.get(c.name) is not None
                     else np.ones(len(p[c.name]), bool)
                     for p, v in zip(parts, vparts)])
            if c.type.kind.name == "TEXT":
                vocab = list(jdb.store.dictionary(name, c.name).values)
                arr = TT.Coded(vocab, np.asarray(arr, np.int32))
            cols[c.name] = arr
        tdb.load_table(name, cols, valids or None)


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, (float, np.floating)) and isinstance(
            b, (float, np.floating)):
        if a == b or (np.isnan(a) and np.isnan(b)):
            return True
        return abs(a - b) <= FLOAT_RTOL * max(abs(a), abs(b))
    return a == b


def assert_rows_match(got, want, label="") -> None:
    """Port rows against JAX rows (see the module docstring)."""
    assert len(got) == len(want), (label, len(got), len(want))
    for r, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), (label, r)
        for i, (a, b) in enumerate(zip(g, w)):
            assert _same(a, b), (label, r, i, a, b)
            if a is not None and b is not None:
                assert type(a) is type(b), (label, r, i, type(a), type(b))


def assert_same_answer(jdb, tdb, text: str, label: str = "") -> None:
    """Run ``text`` in both packages: equal rows (assert_rows_match), or
    an error in both where the JAX package refuses the statement."""
    try:
        want = jdb.sql(text)
    except Exception as e:   # the JAX package's refusal is the answer
        jerr = e
    else:
        jerr = None
    if jerr is not None:
        try:
            tdb.sql(text)
        except Exception:
            return
        raise AssertionError(f"{label}: the JAX package raises "
                             f"{type(jerr).__name__}: {jerr}; the port "
                             "answers")
    assert_rows_match(tdb.sql(text).rows(), want.rows(), label)
