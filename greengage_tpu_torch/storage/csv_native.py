"""COPY's CSV readers — the port's counterpart of
greengage_tpu/storage/csv_native.py, with the quoting-aware reader and the
rejected-row log of greengage_tpu/runtime/ingest.py (``parse_csv_rows``,
``append_error_log``, ``read_error_log``) that COPY uses.

``parse_file`` is the fast path (the fstream parsing analog): the field
index and the integer, DECIMAL, float64 and date parsers of the codec the
port builds from ``native/ggcodec.cpp`` into ``_build/``
(storage/native.py), bound with ctypes. It raises ``CsvFallback`` where it
cannot answer: quoted fields, a NULL marker other than the empty field, a
bool column, or no codec library (native.route() == "numpy", no g++); the
session then reads the file with ``parse_csv_rows`` (Python's csv module,
one row at a time, rejecting malformed rows for SEGMENT REJECT LIMIT), as
the JAX session does. Both readers give the same columns.
"""

from __future__ import annotations

import csv as _csv
import ctypes
import io
import json
import os
import time

import numpy as np

from greengage_tpu_torch import types as T
from greengage_tpu_torch.storage import native


class CsvFallback(Exception):
    """Raised when the fast path can't handle the input (quotes, etc.)."""


def _lib():
    lib = native._load()
    if not lib:
        raise CsvFallback("native library unavailable")
    if not hasattr(lib, "_csv_ready"):
        lib.gg_csv_index.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint8, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.gg_csv_index.restype = ctypes.c_int64
        for fn in (lib.gg_parse_i64, lib.gg_parse_f64, lib.gg_parse_date):
            fn.restype = ctypes.c_int64
        lib.gg_parse_i64.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.gg_parse_f64.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        lib.gg_parse_date.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        lib._csv_ready = True
    return lib


def parse_file(path: str, schema, delimiter: str = ",", header: bool = False,
               null_marker: str = ""):
    """Parse a CSV file natively into storage-representation columns.

    -> (cols {name: np.ndarray | list[str]}, valids {name: bool array}).
    Raises CsvFallback when the file needs the quoting-aware reader. TEXT
    columns come back as Python strings (dictionary encoding happens in
    the store); a non-empty null_marker also falls back (the fast path's
    NULL is the empty field, PG's CSV default). Bad data raises
    ValueError."""
    if len(delimiter) != 1 or null_marker not in ("",):
        raise CsvFallback("options need the python reader")
    lib = _lib()
    with open(path, "rb") as f:
        buf = np.frombuffer(f.read(), dtype=np.uint8)
    if buf.size == 0:
        return ({c.name: np.empty(0, dtype=c.type.np_dtype) if c.type.kind
                 is not T.Kind.TEXT else [] for c in schema.columns}, {})
    ncols = len(schema.columns)
    cap = int(buf.size // 2) + ncols + 16
    starts = np.empty(cap, dtype=np.int64)
    lens = np.empty(cap, dtype=np.int32)
    nf = lib.gg_csv_index(buf.ctypes.data, buf.size, ord(delimiter), cap,
                          starts.ctypes.data, lens.ctypes.data)
    if nf == -2:
        raise CsvFallback("quoted fields")
    if nf < 0:
        raise CsvFallback("field capacity")
    if nf % ncols != 0:
        raise ValueError(f"CSV arity mismatch: {nf} fields is not a "
                         f"multiple of {ncols} columns")
    nrows = nf // ncols
    if header:
        starts = starts[ncols:]
        lens = lens[ncols:]
        nrows -= 1
    cols: dict = {}
    valids: dict = {}
    raw = buf.tobytes()   # one copy, shared by all TEXT columns
    for i, c in enumerate(schema.columns):
        k = c.type.kind
        if k is T.Kind.TEXT:
            s = starts[i::ncols][:nrows]
            ln = lens[i::ncols][:nrows]
            cols[c.name] = [raw[a:a + b].decode("utf-8")
                            for a, b in zip(s, ln)]
            va = ln > 0   # empty field = NULL (the Python reader's too)
            if not va.all():
                valids[c.name] = np.asarray(va, dtype=bool)
            continue
        if k is T.Kind.BOOL:
            raise CsvFallback("bool literals need the python reader")
        valid = np.empty(nrows, dtype=np.uint8)
        if k in (T.Kind.INT32, T.Kind.INT64, T.Kind.DECIMAL):
            out = np.empty(nrows, dtype=np.int64)
            scale = c.type.scale if k is T.Kind.DECIMAL else 0
            rc = lib.gg_parse_i64(buf.ctypes.data, starts.ctypes.data,
                                  lens.ctypes.data, nrows, ncols, i, scale,
                                  out.ctypes.data, valid.ctypes.data)
        elif k is T.Kind.FLOAT64:
            out = np.empty(nrows, dtype=np.float64)
            rc = lib.gg_parse_f64(buf.ctypes.data, starts.ctypes.data,
                                  lens.ctypes.data, nrows, ncols, i,
                                  out.ctypes.data, valid.ctypes.data)
        elif k is T.Kind.DATE:
            out = np.empty(nrows, dtype=np.int32)
            rc = lib.gg_parse_date(buf.ctypes.data, starts.ctypes.data,
                                   lens.ctypes.data, nrows, ncols, i,
                                   out.ctypes.data, valid.ctypes.data)
        else:
            raise CsvFallback(f"type {c.type}")
        if rc < 0:
            raise ValueError(
                f'COPY: invalid value for column "{c.name}" at row {-rc}')
        if k is T.Kind.INT32:
            bad = (out < -(2**31)) | (out >= 2**31)
            if bad.any():
                row = int(np.argmax(bad)) + 1
                raise ValueError(
                    f'COPY: value out of range for int column "{c.name}" '
                    f"at row {row}")
        cols[c.name] = out.astype(c.type.np_dtype, copy=False)
        va = valid.astype(bool)
        if not va.all():
            valids[c.name] = va
    return cols, valids


# ---------------------------------------------------------------------------
# the quoting-aware reader and the rejected-row log (runtime/ingest.py's)
# ---------------------------------------------------------------------------

def parse_csv_rows(text: str, schema, delim: str, header: bool, null_s: str,
                   line_base: int = 0):
    """-> (cols {name: list}, valids {name: list}, rejects [(line, raw,
    error)]). Malformed rows are REJECTED, not fatal (cdbsreh.c role):
    the caller enforces the reject limit."""
    cols = {c.name: [] for c in schema.columns}
    valids = {c.name: [] for c in schema.columns}
    rejects = []
    rd = _csv.reader(io.StringIO(text), delimiter=delim)
    for i, row in enumerate(rd):
        if header and i == 0:
            continue
        if not row:
            continue
        if len(row) != len(schema.columns):
            rejects.append((line_base + i + 1, delim.join(row),
                            f"expected {len(schema.columns)} columns, "
                            f"got {len(row)}"))
            continue
        parsed_vals = []
        parsed_valid = []
        err = None
        for c, v in zip(schema.columns, row):
            if v == null_s:
                parsed_vals.append(_zero_for(c.type))
                parsed_valid.append(False)
                continue
            try:
                parsed_vals.append(T.from_string(v, c.type))
                parsed_valid.append(True)
            except (ValueError, TypeError, ArithmeticError) as e:
                err = f'column "{c.name}": {e}'
                break
        if err is not None:
            rejects.append((line_base + i + 1, delim.join(row), err))
            continue
        for c, v, ok in zip(schema.columns, parsed_vals, parsed_valid):
            cols[c.name].append(v)
            valids[c.name].append(ok)
    return cols, valids, rejects


def _zero_for(t):
    if t.kind is T.Kind.TEXT:
        return ""
    if t.kind is T.Kind.FLOAT64:
        return 0.0
    if t.kind is T.Kind.BOOL:
        return False
    return 0


def append_error_log(root: str, table: str, rejects: list) -> None:
    """Append rejected rows to ``<root>/errlog/<table>.jsonl``, the JAX
    package's file (gp_read_error_log analog)."""
    d = os.path.join(root, "errlog")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{table}.jsonl"), "a") as f:
        for line, raw, err in rejects:
            f.write(json.dumps({"ts": time.time(), "line": line,
                                "row": raw, "error": err}) + "\n")


def read_error_log(root: str, table: str) -> list[dict]:
    p = os.path.join(root, "errlog", f"{table}.jsonl")
    if not os.path.exists(p):
        return []
    out = []
    with open(p) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def write_file(path: str, rows, delimiter: str = ",", header=None,
               null_marker: str = "") -> int:
    """COPY TO: presented rows (``Result.rows()``: text, numbers, dates as
    ``datetime64``, None for NULL) written as CSV, quoted where a field
    needs it. -> rows written."""
    n = 0
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = _csv.writer(f, delimiter=delimiter, lineterminator="\n")
        if header is not None:
            w.writerow(header)
        for row in rows:
            w.writerow([null_marker if v is None else v for v in row])
            n += 1
    return n
