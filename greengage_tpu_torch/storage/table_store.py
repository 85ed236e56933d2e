"""Table stores — the port's counterpart of greengage_tpu/storage/
table_store.py, behind one interface that the binder, planner, ANALYZE and
staging read.

Rows go to segments exactly as the JAX store places them: the hash of the
distribution keys modulo the table's width (``row_hashes``, bit-identical
to the JAX store's host hashing), round-robin for RANDOM, every segment for
REPLICATED, load order kept within a segment. TEXT is dictionary-encoded
per table in first-seen order. ``manifest.snapshot()`` returns the
committed state: a version, bumped by every write, and per table each
segment's files and row count; a snapshot taken before a write keeps
reading the rows it saw.

  - ``TableStore(root, catalog)``: the JAX package's on-disk format, so a
    directory either package wrote opens in the other. Every
    ``load_table`` writes per-segment, per-column block files
    (storage/blockfile.py: checksummed frames, a footer with per-block
    zone maps) under ``<root>/data/<table>/seg<k>/`` with a write-unique
    file number, then publishes them with one per-table delta commit
    (storage/manifest.py ``prepare_delta``/``commit_delta``); TEXT
    dictionaries live in ``data/<table>/dict_<col>.json``. Reads decode
    the files (straight into a staging buffer's slot where the caller
    gives one). A file that fails verification is renamed into
    ``<root>/.quarantine/`` with a sidecar and the typed
    ``CorruptionError`` is raised: repair from a mirror waits for ROADMAP
    Queue 1 item 10, the block cache and zone-map pruning for item 1a-ii.
    Appends (INSERT, COPY) commit through the manifest's write-intent path
    where no dictionary grew (``write_intents_enabled``), else through the
    per-table delta claim. DELETE and UPDATE never rewrite a data file:
    they publish a per-segment deletion bitmap (``@del.<fileno>.ggb``, the
    visimap analog, in the table's ``delmask`` and ``segfiles``) and UPDATE
    appends the new row versions; VACUUM (``rewrite_table``) compacts the
    bitmaps away. The keep masks and visible row counts are cached per
    manifest version in a small cache of the store's own (the JAX store
    keeps them in its block cache, item 1a-ii).
  - ``MemoryTableStore(catalog)``: ``connect(path=None)``. Each write is a
    host numpy chunk per segment; nothing reaches a disk. (The JAX package
    gives a Database without a path a temporary directory instead.) Its
    deletion bitmaps are immutable arrays per (table, segment) in its
    manifest, replaced whole by each DELETE or UPDATE; every write bumps
    the version, so the same statements give the same rows and tags.

Raw-encoded TEXT (high-NDV strings kept as bytes) waits for item 1e: a
column that would store raw raises NotImplementedError naming it.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import os
import shutil
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from greengage_tpu_torch import types as T
from greengage_tpu_torch.catalog import PolicyKind, TableSchema
from greengage_tpu_torch.runtime.faultinject import faults
from greengage_tpu_torch.runtime.logger import counters
from greengage_tpu_torch.storage import native
from greengage_tpu_torch.storage.blockfile import (read_column_file,
                                                   read_footer,
                                                   write_column_file)
from greengage_tpu_torch.storage.corruption import CorruptionError
from greengage_tpu_torch.storage.dictionary import Dictionary
from greengage_tpu_torch.storage.manifest import IntentConflict, Manifest

# byte windows of raw TEXT the binder reads as constants; raw TEXT itself is
# not ported (every raw_* method raises)
RAW_PREFIX_BYTES = 32
RAW_PREFIX_WORDS = RAW_PREFIX_BYTES // 8
RAW_WIDE_BYTES = 128
RAW_WIDE_WORDS = RAW_WIDE_BYTES // 8

# committed delta lines folded into the manifest's root at once (the
# checkpoint; the JAX package's manifest_delta_fold_threshold default)
FOLD_THRESHOLD = 64
# keep masks and visible row counts cached per store and manifest version
DELMASK_CACHE_ENTRIES = 256

_RAW_LATER = ("raw-encoded TEXT is not ported yet (ROADMAP Queue 1 item 1e, "
              "raw TEXT)")


def _as_i64(arr: np.ndarray) -> np.ndarray:
    """Hash input for a non-TEXT column: int64 representation; float64 by
    bit pattern with -0.0 -> 0.0 and every NaN one pattern (hashfloat8)."""
    a = np.asarray(arr)
    if a.dtype.kind == "f":
        f = a.astype(np.float64)
        f = np.where(f == 0.0, 0.0, f)
        bits = f.view(np.int64)
        return np.where(np.isnan(f), np.int64(0x7FF8000000000000), bits)
    return a.astype(np.int64)


class _StoreBase:
    """What both stores share: dictionaries, placement and the encoding of
    a load's host arrays."""

    def __init__(self, catalog):
        self.catalog = catalog
        self._dicts: dict[tuple[str, str], Dictionary] = {}
        self._derived: dict[tuple[str, str], Dictionary] = {}
        self._dict_lock = threading.RLock()
        # deletion-bitmap keep masks, (table, segment, manifest version) ->
        # bool[rows] or None, and visible row counts, (table, version) ->
        # [rows per segment]: at most DELMASK_CACHE_ENTRIES each (the JAX
        # store's "delmask" block cache, ROADMAP Queue 1 item 1a-ii)
        self._delmask_mu = threading.Lock()
        self._delmask_cache: dict = {}
        self._live_cache: dict = {}

    # ---- dictionaries --------------------------------------------------
    def _load_dictionary(self, table: str, col: str) -> Dictionary:
        return Dictionary()

    def dictionary(self, table: str, col: str) -> Dictionary:
        if table == "@expr":
            with self._dict_lock:
                return self._derived[(table, col)]
        if table == "@rawdict":
            raise NotImplementedError(_RAW_LATER)
        key = (table.split("#", 1)[0], col)
        with self._dict_lock:
            d = self._dicts.get(key)
            if d is None:
                d = self._dicts[key] = self._load_dictionary(*key)
        return d

    def derived_dictionary(self, values: list[str]) -> tuple[str, str]:
        """Register (or reuse) an in-memory dictionary for a string-function
        result; -> ("@expr", sha1) ref usable wherever a (table, col)
        dict_ref is."""
        h = hashlib.sha1("\x00".join(values).encode()).hexdigest()[:16]
        ref = ("@expr", h)
        with self._dict_lock:
            if ref not in self._derived:
                self._derived[ref] = Dictionary(list(values))
        return ref

    def _invalidate_dicts(self, table: str) -> None:
        table = table.split("#", 1)[0]
        with self._dict_lock:
            for key in [k for k in self._dicts if k[0] == table]:
                del self._dicts[key]

    # ---- raw TEXT (not ported) ------------------------------------------
    def raw_dictionary(self, table, col, snapshot=None):
        raise NotImplementedError(_RAW_LATER)

    def raw_max_len(self, table, col, snapshot=None):
        raise NotImplementedError(_RAW_LATER)

    def raw_is_ascii(self, table, col, snapshot=None):
        raise NotImplementedError(_RAW_LATER)

    @staticmethod
    def host_pred_name(col, payload):
        raise NotImplementedError(_RAW_LATER)

    def fetch_raw(self, table, col, surrogates, snapshot=None):
        raise NotImplementedError(_RAW_LATER)

    def raw_column_names(self, table: str) -> set:
        return {c.name for c in self.catalog.get(table).columns
                if c.type.kind is T.Kind.TEXT and c.encoding == "raw"}

    # ---- placement -----------------------------------------------------
    def row_hashes(self, schema: TableSchema, cols: dict, valids: dict,
                   keys: tuple[str, ...]) -> np.ndarray:
        acc = None
        for k in keys:
            c = schema.column(k)
            arr = cols[k]
            if c.type.kind is T.Kind.TEXT:
                lut = self.dictionary(schema.name, k).hashes()
                h = lut[arr] if len(lut) else np.zeros(len(arr), np.uint32)
            else:
                h = native.hash_i64(_as_i64(arr))
            v = valids.get(k)
            if v is not None:
                h = np.where(v, h, np.uint32(0))
            acc = h if acc is None else native.hash_combine(acc, h)
        return acc

    def segment_for_values(self, schema: TableSchema, values: dict) -> int:
        """The one segment owning rows whose distribution keys equal
        ``values`` (storage representation; an absent string is code -1,
        which hits the sentinel hash row) — direct dispatch's hash,
        bit-identical to placement."""
        cols, valids = {}, {}
        for k in schema.policy.keys:
            v = values[k]
            c = schema.column(k)
            if v is None:
                cols[k] = np.zeros(1, dtype=np.int64)
                valids[k] = np.zeros(1, dtype=bool)
            elif c.type.kind is T.Kind.TEXT:
                cols[k] = np.array([v], dtype=np.int32)
            else:
                cols[k] = np.array([v], dtype=c.type.np_dtype)
        rh = self.row_hashes(schema, cols, valids, schema.policy.keys)
        return int(rh[0] % np.uint32(schema.policy.numsegments))

    def _placement(self, schema, cols, valids, nrows: int,
                   row_offset: int) -> np.ndarray:
        pol = schema.policy
        nseg = pol.numsegments
        if pol.kind is PolicyKind.HASH:
            rh = self.row_hashes(schema, cols, valids, pol.keys)
            return (rh % np.uint32(nseg)).astype(np.int32)
        if pol.kind is PolicyKind.RANDOM:
            return ((np.arange(nrows, dtype=np.int64) + row_offset)
                    % nseg).astype(np.int32)
        raise AssertionError("REPLICATED handled by caller")

    def _seg_rows(self, schema, enc, valids, nrows: int, existing: int):
        """Each segment's row indices of an append (every row on every
        segment of a REPLICATED table). A rewrite places from offset 0, as
        the JAX store's rewrite and republish do."""
        nseg = schema.policy.numsegments
        if schema.policy.kind is PolicyKind.REPLICATED:
            return [np.arange(nrows)] * nseg
        seg_of = self._placement(schema, enc, valids, nrows, existing)
        return [np.nonzero(seg_of == s)[0] for s in range(nseg)]

    @staticmethod
    def _check_not_null(schema, valids) -> None:
        for c in schema.columns:
            v = (valids or {}).get(c.name)
            if not c.nullable and v is not None and not np.all(v):
                raise ValueError(f'null value in column "{c.name}" violates '
                                 "not-null constraint")

    # ---- the write path both stores share --------------------------------
    def live_rowcounts(self, table: str,
                       snapshot: dict | None = None) -> list[int]:
        """Per-segment VISIBLE row counts (manifest rows less the deletion
        bitmap): what read_segment returns. Cached per manifest version:
        every statement's staging asks."""
        snap = snapshot or self.manifest.snapshot()
        key = (table, snap.get("version", 0))
        with self._delmask_mu:
            hit = self._live_cache.get(key)
        if hit is not None:
            return list(hit)
        out = []
        for seg, n in enumerate(self.segment_rowcounts(table, snap)):
            keep = self.delmask_keep(table, seg, snap)
            out.append(int(keep.sum()) if keep is not None else n)
        with self._delmask_mu:
            if len(self._live_cache) >= DELMASK_CACHE_ENTRIES:
                self._live_cache.clear()
            self._live_cache[key] = out
        return list(out)

    def delmask_keep(self, table: str, seg: int,
                     snapshot: dict | None = None):
        """-> bool[rows] keep mask (True = live) or None when the segment
        has no deletions; cached per manifest version. A mask covers the
        first len(mask) rows; rows appended after it are live."""
        snap = snapshot or self.manifest.snapshot()
        key = (table, seg, snap.get("version", 0))
        with self._delmask_mu:
            if key in self._delmask_cache:
                return self._delmask_cache[key]
        tmeta = snap["tables"].get(table, {})
        ref = tmeta.get("delmask", {}).get(str(seg))
        keep = None
        if ref is not None:
            deleted = self._read_bitmap(table, ref)
            nrows = int(tmeta.get("nrows", {}).get(str(seg), 0))
            keep = np.ones(nrows, dtype=bool)
            keep[: len(deleted)] = ~deleted.astype(bool)
            if keep.all():
                keep = None
        with self._delmask_mu:
            if len(self._delmask_cache) >= DELMASK_CACHE_ENTRIES:
                self._delmask_cache.clear()
            self._delmask_cache[key] = keep
        return keep

    def _live_rows(self, table: str, snap: dict):
        """-> (enc, valids) of every visible row of the table in segment
        order (one copy of a REPLICATED table): a rewrite's input."""
        schema = self.catalog.get(table)
        nseg = (1 if schema.policy.kind is PolicyKind.REPLICATED
                else schema.policy.numsegments)
        # one segment a unit on a pool of threads, as staging reads them
        # (the codec releases the GIL)
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                                thread_name_prefix="gg-rewrite") as pool:
            reads = [f.result() for f in
                     [pool.submit(self.read_segment, table, seg, None, snap)
                      for seg in range(nseg)]]
        parts = [r[0] for r in reads]
        vparts = [r[1] for r in reads]
        ns = [r[2] for r in reads]
        enc, valids = {}, {}
        for c in schema.columns:
            enc[c.name] = (np.concatenate([p[c.name] for p in parts])
                           if parts else np.empty(0, c.type.np_dtype))
            if any(v.get(c.name) is not None for v in vparts):
                valids[c.name] = np.concatenate(
                    [v[c.name] if v.get(c.name) is not None
                     else np.ones(n, bool) for v, n in zip(vparts, ns)])
        return enc, valids

    # ---- encoding a load -----------------------------------------------
    def _encode(self, table: str, columns: dict, valids: dict):
        """-> (schema, {column: storage array}, row count): TEXT through
        the table's dictionaries, DECIMAL to scaled int64, DATE to days."""
        schema = self.catalog.get(table)
        for c in schema.columns:
            v = valids.get(c.name)
            if not c.nullable and v is not None and not np.all(v):
                raise ValueError(f'null value in column "{c.name}" violates '
                                 "not-null constraint")
        nrows = None
        enc: dict[str, np.ndarray] = {}
        for c in schema.columns:
            if c.name not in columns:
                raise ValueError(f"missing column {c.name}")
            raw = columns[c.name]
            if c.type.kind is T.Kind.TEXT:
                c = self._resolve_text_encoding(schema, c, raw)
                if c.encoding == "raw":
                    raise NotImplementedError(
                        f"{table}.{c.name}: {_RAW_LATER}")
                d = self.dictionary(table, c.name)
                vmask = valids.get(c.name)
                if isinstance(raw, T.Coded):
                    arr = d.encode_coded(list(raw.vocab), raw.codes)
                    if vmask is not None:
                        arr = np.where(vmask, arr, d.encode([""])[0])
                elif vmask is None:
                    arr = d.encode(list(raw))
                else:
                    arr = d.encode(["" if not ok else s
                                    for s, ok in zip(raw, vmask)])
            elif c.type.kind is T.Kind.DECIMAL \
                    and not isinstance(raw, np.ndarray):
                arr = np.array([T.decimal_to_int(v, c.type.scale)
                                for v in raw], dtype=np.int64)
            elif c.type.kind is T.Kind.DATE \
                    and not isinstance(raw, np.ndarray):
                arr = np.array([T.date_to_days(v) for v in raw],
                               dtype=np.int32)
            else:
                arr = np.asarray(raw, dtype=c.type.np_dtype)
            enc[c.name] = arr
            nrows = len(arr) if nrows is None else nrows
            if len(arr) != nrows:
                raise ValueError("ragged insert")
        return schema, enc, nrows or 0

    def _resolve_text_encoding(self, schema, col, raw_values):
        """First-insert decision for TEXT encoding "auto", as the JAX store
        makes it: high-NDV columns go raw, low-NDV go dict; distribution
        keys and bulk-coded columns are always dict. The decision is kept
        in the catalog (catalog.json for a directory)."""
        if col.encoding != "auto":
            return col
        from greengage_tpu_torch.catalog.schema import Column

        if col.name in schema.policy.keys or isinstance(raw_values, T.Coded):
            mode = "dict"
        else:
            sample = list(raw_values[:100_000])
            mode = ("raw" if len(sample) >= 4096
                    and len(set(sample)) > 0.5 * len(sample) else "dict")
        new = Column(col.name, col.type, col.nullable, mode)
        schema.columns[[c.name for c in schema.columns].index(col.name)] = new
        self.catalog._save()
        return new


# ---------------------------------------------------------------------------
# in memory: connect(path=None)
# ---------------------------------------------------------------------------

class _MemoryManifest:
    """The committed state's version, per-(table, segment) chunk lists and
    deletion bitmaps (names of immutable bitmaps). Every write takes
    ``lock`` and bumps the version; ``snapshot`` takes it too, so a reader
    never sees half of a write."""

    def __init__(self):
        self._version = 0
        self.tables: dict[str, dict[int, list[int]]] = {}
        self.nrows: dict[str, dict[int, int]] = {}
        self.delmask: dict[str, dict[int, str]] = {}
        self.lock = threading.RLock()

    def version(self) -> int:
        return self._version

    def snapshot(self) -> dict:
        with self.lock:
            out = {}
            for t, segs in self.tables.items():
                out[t] = {"segfiles": {str(s): list(ids)
                                       for s, ids in segs.items()},
                          "nrows": {str(s): n for s, n in
                                    self.nrows[t].items()}}
                dm = self.delmask.get(t)
                if dm:
                    out[t]["delmask"] = {str(s): m for s, m in dm.items()}
            return {"version": self._version, "tables": out}

    def recover(self) -> list:
        return []


class MemoryTableStore(_StoreBase):
    def __init__(self, catalog):
        super().__init__(catalog)
        self.manifest = _MemoryManifest()
        # chunk id -> (cols {name: array}, valids {name: bool array}, nrows)
        self._chunks: dict[int, tuple[dict, dict, int]] = {}
        self._next_chunk = 0
        # bitmap name -> uint8[segment rows] (1 = deleted), never mutated
        self._masks: dict[str, np.ndarray] = {}
        self._next_mask = 0
        self._lock = self.manifest.lock
        # chunks and masks a write replaced: a snapshot taken before it may
        # still read them, so they go GC_GRACE_S later (reap_gc), as the
        # JAX store defers the files a commit made unreachable
        self._pending_gc: list = []

    GC_GRACE_S = 30.0   # snapshot readers finish well within this

    def drop_table(self, table: str) -> None:
        """Forget a dropped table's rows and dictionaries (a new write
        version, so cached staging of the old table is never reused)."""
        with self._lock:
            self._forget_table(table)
            self._invalidate_dicts(table)
            self.manifest._version += 1

    def _forget_table(self, table: str) -> None:
        cids = [cid for seg_ids in self.manifest.tables.pop(table,
                                                            {}).values()
                for cid in seg_ids]
        mids = list(self.manifest.delmask.pop(table, {}).values())
        self.manifest.nrows.pop(table, None)
        self._pending_gc.append((time.monotonic(), cids, mids))
        self.reap_gc()

    def flush_dicts(self, table: str) -> None:
        """Nothing to persist: the dictionaries live in memory."""

    def insert(self, table: str, columns: dict,
               valids: dict | None = None) -> int:
        """Append rows; returns the row count. Encodes TEXT, places rows
        onto segments and commits them as one new version."""
        valids = dict(valids or {})
        schema, enc, nrows = self._encode(table, columns, valids)
        with self._lock:
            self._append(table, schema, enc, valids, nrows)
            self.manifest._version += 1
        return nrows

    def insert_encoded(self, table: str, enc: dict, valids: dict) -> int:
        """Append rows already in storage representation (TEXT codes,
        scaled decimals, days): UPDATE's new row versions."""
        schema = self.catalog.get(table)
        self._check_not_null(schema, valids)
        nrows = len(next(iter(enc.values()))) if enc else 0
        with self._lock:
            self._append(table, schema, enc, dict(valids or {}), nrows)
            self.manifest._version += 1
        return nrows

    def _append(self, table, schema, enc, valids, nrows: int,
                replace: bool = False) -> None:
        """One write's chunks (a new table state with ``replace``), under
        the lock; the caller bumps the version."""
        nseg = schema.policy.numsegments
        if replace:
            self._forget_table(table)
        counts = self.manifest.nrows.setdefault(table, {})
        seg_rows = self._seg_rows(schema, enc, valids, nrows,
                                  sum(counts.get(s, 0) for s in range(nseg)))
        segs = self.manifest.tables.setdefault(table, {})
        for s in range(nseg):
            idx = seg_rows[s]
            if not len(idx) and not replace:
                continue
            cols = {k: a[idx] for k, a in enc.items()}
            vals = {k: np.asarray(v, dtype=bool)[idx]
                    for k, v in valids.items() if v is not None}
            cid = self._next_chunk
            self._next_chunk += 1
            self._chunks[cid] = (cols, vals, len(idx))
            segs.setdefault(s, []).append(cid)
            counts[s] = counts.get(s, 0) + len(idx)

    # ---- deletion bitmaps --------------------------------------------------
    def _read_bitmap(self, table: str, name: str) -> np.ndarray:
        return self._masks[name]

    def set_delmask(self, table: str, masks: dict) -> None:
        """Publish deletion bitmaps ({segment: uint8[rows], 1 = deleted}),
        one new version."""
        with self._lock:
            self._stage_delmask(table, masks)
            self.manifest._version += 1

    def _stage_delmask(self, table: str, masks: dict) -> None:
        dm = self.manifest.delmask.setdefault(table, {})
        for seg, mask in masks.items():
            mid = f"@del.{self._next_mask}"   # the bitmap's name
            self._next_mask += 1
            self._masks[mid] = np.asarray(mask, dtype=np.uint8)
            old = dm.get(int(seg))
            if old is not None:
                self._pending_gc.append((time.monotonic(), [], [old]))
            dm[int(seg)] = mid
        self.reap_gc()

    def update_split(self, table: str, masks: dict, enc: dict,
                     valids: dict) -> None:
        """UPDATE's autocommit: the old versions' bitmaps and the new
        versions' append in one version (the JAX session's one
        transaction)."""
        schema = self.catalog.get(table)
        self._check_not_null(schema, valids)
        nrows = len(next(iter(enc.values()))) if enc else 0
        with self._lock:
            if masks:
                self._stage_delmask(table, masks)
            if nrows:
                self._append(table, schema, enc, dict(valids or {}), nrows)
            self.manifest._version += 1

    def replace_contents(self, table: str, enc: dict, valids: dict) -> None:
        """Republish a table whole (a DELETE without WHERE, an UPDATE
        without WHERE): placement is recomputed, bitmaps go."""
        schema = self.catalog.get(table)
        self._check_not_null(schema, valids)
        nrows = len(next(iter(enc.values()))) if enc else 0
        with self._lock:
            self._append(table, schema, enc, dict(valids or {}), nrows,
                         replace=True)
            self.manifest._version += 1

    def rewrite_table(self, table: str, new_numsegments: int) -> int:
        """VACUUM's compaction: every live row re-placed at the table's
        width, without bitmaps. -> rows kept."""
        schema = self.catalog.get(table)
        if new_numsegments != schema.policy.numsegments:
            raise NotImplementedError(
                "changing a table's width (expand): ROADMAP Queue 1 item "
                "1a-ii")
        with self._lock:
            enc, valids = self._live_rows(table, self.manifest.snapshot())
            nrows = len(next(iter(enc.values()))) if enc else 0
            self._append(table, schema, enc, valids, nrows, replace=True)
            self.manifest._version += 1
        return nrows

    def reap_gc(self) -> int:
        """Free the replaced chunks and masks older than GC_GRACE_S. ->
        how many went."""
        with self._lock:
            now = time.monotonic()
            keep, removed = [], 0
            for ts, cids, mids in self._pending_gc:
                if now - ts < self.GC_GRACE_S:
                    keep.append((ts, cids, mids))
                    continue
                for cid in cids:
                    self._chunks.pop(cid, None)
                for mid in mids:
                    self._masks.pop(mid, None)
                removed += len(cids) + len(mids)
            self._pending_gc = keep
        return removed

    def _seg_chunks(self, table: str, seg: int, snapshot) -> list:
        snap = snapshot or self.manifest.snapshot()
        tmeta = snap["tables"].get(table, {"segfiles": {}})
        return [self._chunks[cid] for cid in tmeta["segfiles"].get(str(seg),
                                                                   [])]

    def read_segment(self, table: str, seg: int, columns=None,
                     snapshot: dict | None = None, prune=None, dest=None):
        """-> (cols {name: array}, valids {name: bool array | None},
        nrows) of one segment's visible rows under ``snapshot`` (rows its
        deletion bitmap marks are dropped). Zone-map pruning is not
        applied (every row is returned, which is what a scan without
        pruning reads); ``dest`` is accepted and unused."""
        schema = self.catalog.get(table)
        snap = snapshot or self.manifest.snapshot()
        chunks = self._seg_chunks(table, seg, snap)
        keep = self.delmask_keep(table, seg, snap)
        want = columns if columns is not None else schema.column_names
        nrows = sum(n for _, _, n in chunks)
        cols, valids = {}, {}
        for name in want:
            if name.startswith("@"):
                raise NotImplementedError(f"{name}: {_RAW_LATER}")
            c = schema.column(name)
            parts = [cc[name] for cc, _, _ in chunks]
            if len(parts) == 1:
                cols[name] = parts[0]
            elif parts:
                cols[name] = np.concatenate(parts)
            else:
                cols[name] = np.empty(0, dtype=c.type.np_dtype)
            if any(name in vv for _, vv, _ in chunks):
                valids[name] = np.concatenate(
                    [vv.get(name, np.ones(n, dtype=bool))
                     for _, vv, n in chunks])
            else:
                valids[name] = None
            if keep is not None:
                cols[name] = cols[name][keep]
                if valids[name] is not None:
                    valids[name] = valids[name][keep]
        if keep is not None:
            nrows = int(keep.sum())
        return cols, valids, nrows

    def has_nulls(self, table: str, col: str,
                  snapshot: dict | None = None) -> bool:
        """True when any committed write of the column carried a validity
        mask (the JAX store's .valid file)."""
        schema = self.catalog.get(table)
        return any(col in vv for s in range(schema.policy.numsegments)
                   for _, vv, _ in self._seg_chunks(table, s, snapshot))

    def column_bounds(self, table: str, col: str,
                      snapshot: dict | None = None):
        """Global [min, max] over every committed write of a stored column
        (values at NULL positions included, as the JAX store's block zone
        maps include them); None for columns without zones (bool) or when a
        write holds only NaN, or no rows."""
        schema = self.catalog.get(table)
        lo = hi = None
        for s in range(schema.policy.numsegments):
            for cc, _, n in self._seg_chunks(table, s, snapshot):
                if not n:
                    continue
                a = cc[col]
                if a.dtype.itemsize <= 1:
                    return None
                if a.dtype.kind == "f":
                    if np.isnan(a).all():
                        return None
                    a_lo, a_hi = float(np.nanmin(a)), float(np.nanmax(a))
                else:
                    a_lo, a_hi = int(a.min()), int(a.max())
                lo = a_lo if lo is None else min(lo, a_lo)
                hi = a_hi if hi is None else max(hi, a_hi)
        return None if lo is None else (lo, hi)

    def segment_rowcounts(self, table: str,
                          snapshot: dict | None = None) -> list[int]:
        schema = self.catalog.get(table)
        snap = snapshot or self.manifest.snapshot()
        tmeta = snap["tables"].get(table, {"nrows": {}})
        return [tmeta["nrows"].get(str(s), 0)
                for s in range(schema.policy.numsegments)]


# ---------------------------------------------------------------------------
# on disk: connect(path=d)
# ---------------------------------------------------------------------------

def merge_segfile_records(tx: dict, table: str, records: list) -> None:
    """Merge staged-file records [(seg, [rel files], nrows)] into a
    manifest transaction (the re-merge of an optimistic write retry)."""
    tmeta = tx["tables"].setdefault(table, {"segfiles": {}, "nrows": {}})
    for seg, rels, n in records:
        tmeta["segfiles"].setdefault(str(seg), []).extend(rels)
        tmeta["nrows"][str(seg)] = tmeta["nrows"].get(str(seg), 0) + n


class TableStore(_StoreBase):
    """The block-file store of a database directory (module docstring)."""

    def __init__(self, root: str, catalog):
        super().__init__(catalog)
        self.root = root
        self.manifest = Manifest(root)
        # wired by the session after construction (the settings registry,
        # the cluster log for quarantine events); optional for bare use
        self.settings = None
        self.log = None
        # parsed, verified footers: (table, rel) -> footer. Committed block
        # files are immutable; a quarantine drops its entry
        self._footers: dict = {}
        # per-(table, rel) locks and generations: parallel staging units
        # tripping the same bad file quarantine it once
        self._repair_mu = threading.Lock()
        self._repair_locks: dict = {}
        self._repair_gen: dict = {}
        # files a commit made unreachable, deleted GC_GRACE_S later:
        # [(monotonic time, table, [rels])]
        self._gc_mu = threading.Lock()
        self._pending_gc: list = []

    # ---- paths ---------------------------------------------------------
    def data_root(self, content: int) -> str:
        return os.path.join(self.root, "data")

    @staticmethod
    def rel_content(rel: str) -> int:
        """Content id encoded in a manifest relpath ('seg<k>/<file>')."""
        return int(rel.split(os.sep, 1)[0][3:])

    def seg_file_path(self, table: str, rel: str) -> str:
        return os.path.join(self.data_root(self.rel_content(rel)), table, rel)

    def _dict_path(self, table: str, col: str) -> str:
        table = table.split("#", 1)[0]
        return os.path.join(self.root, "data", table, f"dict_{col}.json")

    def _load_dictionary(self, table: str, col: str) -> Dictionary:
        return Dictionary.load(self._dict_path(table, col))

    def flush_dicts(self, table: str) -> None:
        """Persist the table's TEXT dictionaries (fsynced: committed blocks
        reference their codes)."""
        schema = self.catalog.get(table)
        table = table.split("#", 1)[0]
        for c in schema.columns:
            if c.type.kind is not T.Kind.TEXT:
                continue
            with self._dict_lock:
                d = self._dicts.get((table, c.name))
            if d is not None:
                os.makedirs(os.path.join(self.root, "data", table),
                            exist_ok=True)
                d.save(self._dict_path(table, c.name))

    def storage_ok(self, content: int) -> bool:
        """Every manifest-referenced file of this content is present (the
        FTS storage-health probe; a quarantined file fails it)."""
        snap = self.manifest.snapshot()
        root = self.data_root(content)
        for tname, tmeta in snap.get("tables", {}).items():
            for rel in tmeta.get("segfiles", {}).get(str(content), []):
                if not os.path.exists(os.path.join(root, tname, rel)):
                    return False
        return True

    # ---- corruption: quarantine and checked reads ----------------------
    def _log_event(self, severity: str, message: str) -> None:
        if self.log is not None:
            try:
                self.log.log(severity, "storage", message)
            except Exception:
                pass   # observability must never fail the read

    def quarantine_file(self, path: str, err: CorruptionError) -> str | None:
        """Rename a bad file into <root>/.quarantine/ with a JSON sidecar
        recording the cause, as the JAX store does; its absence fails
        ``storage_ok``."""
        qdir = os.path.join(self.root, ".quarantine")
        os.makedirs(qdir, exist_ok=True)
        qname = f"{uuid.uuid4().hex[:8]}.{os.path.basename(path)}"
        qpath: str | None = os.path.join(qdir, qname)
        try:
            os.replace(path, qpath)
        except OSError:
            qpath = None   # cannot move (already gone?): sidecar only
        sidecar = dict(err.to_dict(), quarantined_from=path,
                       quarantined_to=qpath,
                       time=datetime.datetime.now(datetime.timezone.utc)
                       .isoformat(timespec="seconds"))
        try:
            with open(os.path.join(qdir, qname + ".json"), "w") as f:
                json.dump(sidecar, f, indent=1)
        except OSError:
            pass
        counters.inc("storage_quarantine")
        self._log_event("ERROR", f"quarantined {path} -> {qpath}: "
                        f"{err.cause} ({err.message})")
        return qpath

    def handle_corruption(self, table: str, content: int, rel: str,
                          path: str, err: CorruptionError) -> None:
        """Quarantine the located bad file (a missing one has nothing to
        move) and re-raise the typed error. The JAX store first repairs
        from the mirror's copy; the port has no mirrors yet (ROADMAP Queue
        1 item 10)."""
        if err.cause != "missing":
            self.quarantine_file(path, err)
            self._mark_rel_changed(table, rel)
        raise err

    def _repair_lock_for(self, table: str, rel: str) -> threading.Lock:
        with self._repair_mu:
            lk = self._repair_locks.get((table, rel))
            if lk is None:
                lk = self._repair_locks[(table, rel)] = threading.Lock()
            return lk

    def _mark_rel_changed(self, table: str, rel: str) -> None:
        with self._repair_mu:
            self._repair_gen[(table, rel)] = \
                self._repair_gen.get((table, rel), 0) + 1
            self._footers.pop((table, rel), None)

    def _read_checked(self, table: str, rel: str, reader):
        """Run ``reader(path, content)``; corruption (or a vanished
        manifest-referenced file) is located and handled once per file
        however many staging threads trip it: a thread that waited out
        another's quarantine surfaces 'missing' instead of quarantining
        again."""
        content = self.rel_content(rel)
        path = self.seg_file_path(table, rel)
        with self._repair_mu:
            gen0 = self._repair_gen.get((table, rel), 0)
        try:
            return reader(path, content)
        except FileNotFoundError:
            err = CorruptionError(
                "missing", "manifest-referenced file is missing", path=path)
        except CorruptionError as e:
            err = e
        with self._repair_lock_for(table, rel):
            with self._repair_mu:
                changed = self._repair_gen.get((table, rel), 0) != gen0
            if changed:
                try:
                    return reader(path, content)
                except FileNotFoundError:
                    err = CorruptionError(
                        "missing", "manifest-referenced file is missing",
                        path=path)
                except CorruptionError as e:
                    err = e
            err.locate(table=table, content=content, relpath=rel)
            self.handle_corruption(table, content, rel, path, err)

    def read_file(self, table: str, rel: str, out: np.ndarray | None = None
                  ) -> np.ndarray:
        """Checked read of one manifest-referenced block file; ``out`` is a
        destination its frames decode straight into when it fits (the
        result is then a view of it)."""
        arr = self._read_checked(
            table, rel,
            lambda p, c: read_column_file(p, segment=c, out=out))
        counters.inc("scan_files_read")
        counters.inc("scan_bytes_decoded", int(arr.nbytes))
        return arr

    def read_footer_checked(self, table: str, rel: str) -> dict:
        with self._repair_mu:
            hit = self._footers.get((table, rel))
        if hit is not None:
            return hit
        footer = self._read_checked(table, rel, lambda p, c: read_footer(p))
        with self._repair_mu:
            self._footers[(table, rel)] = footer
        return footer

    # ---- write path ----------------------------------------------------
    def insert(self, table: str, columns: dict,
               valids: dict | None = None) -> int:
        """Append rows (``load_table``, INSERT, COPY): encode, place, write
        each segment's column files, then commit them (_append_encoded)."""
        valids = dict(valids or {})
        dict_sizes = {c.name: len(self.dictionary(table, c.name))
                      for c in self.catalog.get(table).columns
                      if c.type.kind is T.Kind.TEXT}
        schema, enc, nrows = self._encode(table, columns, valids)
        return self._append_encoded(table, schema, enc, valids, None,
                                    dict_sizes)

    def insert_encoded(self, table: str, enc: dict, valids: dict,
                       tx: dict | None = None) -> int:
        """Append rows already in storage representation (TEXT codes,
        scaled decimals, days): UPDATE's new row versions. ``tx``: stage
        into that manifest transaction instead of committing."""
        schema = self.catalog.get(table)
        self._check_not_null(schema, valids)
        return self._append_encoded(table, schema, enc, dict(valids or {}),
                                    tx, {})

    def _append_encoded(self, table, schema, enc, valids, tx,
                        dict_sizes) -> int:
        """The append tail of insert and insert_encoded: placement, the
        segment files, then the commit, as the JAX store orders it. Where
        the append assigned no new dictionary code and
        ``write_intents_enabled`` is on, it commits through a write intent
        (one merge line, no per-table claim: same-table appenders never
        retry). Otherwise: stage the files -> ``prepare_delta`` (the
        per-table claim) -> persist the dictionaries -> ``commit_delta``.
        A process killed before the line is durable leaves the table
        without any of the append (recover() rolls the claim or the intent
        back, the files are unreferenced); killed after, with all of it. A
        same-table claim conflict retries on a fresh snapshot (the staged
        files are write-unique) unless the append grew a dictionary. With
        ``tx`` the files are staged into it and the caller commits."""
        nrows = len(next(iter(enc.values()))) if enc else 0
        own_tx = tx is None
        if own_tx:
            tx = self.manifest.begin()
        tmeta = tx["tables"].setdefault(table, {"segfiles": {}, "nrows": {}})
        # a write-unique file number: concurrent writers never clobber each
        # other's staged files; a loser's files are unreferenced orphans
        fileno = uuid.uuid4().hex[:12]
        nseg = schema.policy.numsegments
        seg_rows = self._seg_rows(
            schema, enc, valids, nrows,
            sum(tmeta["nrows"].get(str(s), 0) for s in range(nseg)))
        records = self._write_segfiles(schema, table, tmeta, enc, valids,
                                       seg_rows, fileno)
        if not own_tx:
            return nrows
        dict_grew = any(len(self.dictionary(table, n)) != sz
                        for n, sz in dict_sizes.items())
        if not dict_grew and self._use_write_intents():
            # the write-intent path: an insert that assigned new dictionary
            # codes keeps the per-table claim, whose conflict is the only
            # cross-process signal that another writer holds the same codes
            self.flush_dicts(table)
            ihandle = self.manifest.stage_intent(table, records)
            try:
                self.manifest.commit_intent(ihandle)
            except BaseException:
                self.manifest.abort_intent(ihandle)
                raise
            self.maybe_fold_manifest()
            return nrows
        last = None
        for attempt in range(20):
            try:
                handle = self.manifest.prepare_delta(tx, [table])
                break
            except RuntimeError as e:
                last = e
                if dict_grew:
                    self._invalidate_dicts(table)
                    raise
                counters.inc("manifest_cas_retry_total")
                time.sleep(0.01 * (attempt + 1))
                tx = self.manifest.begin()
                merge_segfile_records(tx, table, records)
        else:
            self._invalidate_dicts(table)
            raise RuntimeError(
                f"write-write conflict persisted after retries: {last}")
        self.flush_dicts(table)
        try:
            # the crash points between the two phases and after the
            # commit (tests/test_torch_durable.py kills a process here)
            faults.check("dtx_after_prepare")
            self.manifest.commit_delta(handle)
        except BaseException:
            self.manifest.abort_delta(handle)
            raise
        faults.check("dtx_after_commit")
        self.maybe_fold_manifest()
        return nrows

    def _use_write_intents(self) -> bool:
        """The ``write_intents_enabled`` setting (on without settings, for
        a bare store)."""
        return bool(getattr(self.settings, "write_intents_enabled", True))

    def _write_segfiles(self, schema, table, tmeta, enc, valids, seg_rows,
                        fileno) -> list:
        """Write per-segment column files (and .valid files for masked
        columns), record them in ``tmeta`` in the JAX store's order and
        return the records. The files are independent: they are written
        on a pool of threads (the codec and the file writes release the
        GIL), each one whole before the commit that names it."""
        compresstype = schema.options.get("compresstype", "zlib")
        complevel = int(schema.options.get("compresslevel", 1))
        records: list = []
        units: list = []        # (path, segment, column, validity?)
        for s, idx in enumerate(seg_rows):
            if len(idx) == 0:
                continue
            segdir = os.path.join(self.data_root(s), table, f"seg{s}")
            os.makedirs(segdir, exist_ok=True)
            files = tmeta["segfiles"].setdefault(str(s), [])
            files_before = len(files)
            for c in schema.columns:
                fn = f"{c.name}.{fileno}.ggb"
                units.append((os.path.join(segdir, fn), s, c.name, False))
                files.append(os.path.join(f"seg{s}", fn))
                if valids.get(c.name) is not None:
                    vfn = f"{c.name}.{fileno}.valid.ggb"
                    units.append((os.path.join(segdir, vfn), s, c.name,
                                  True))
                    files.append(os.path.join(f"seg{s}", vfn))
            tmeta["nrows"][str(s)] = (tmeta["nrows"].get(str(s), 0)
                                      + int(len(idx)))
            records.append((s, list(files[files_before:]), int(len(idx))))

        def write(unit):
            path, s, name, is_valid = unit
            src = (np.asarray(valids[name], dtype=np.uint8) if is_valid
                   else enc[name])
            write_column_file(path, src[seg_rows[s]], compresstype,
                              complevel)

        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                                thread_name_prefix="gg-segfile") as pool:
            for f in [pool.submit(write, u) for u in units]:
                f.result()
        return records

    def maybe_fold_manifest(self) -> bool:
        """Checkpoint the delta backlog into the root once it reaches
        FOLD_THRESHOLD commits (the JAX store's default)."""
        if self.manifest.delta_backlog() < FOLD_THRESHOLD:
            return False
        return self.manifest.fold(min_deltas=FOLD_THRESHOLD)

    # ---- DELETE, UPDATE, VACUUM ----------------------------------------
    # DELETE/UPDATE never rewrite data files: they publish a per-segment
    # deletion bitmap ('@del.<fileno>.ggb': '@' never begins a column
    # name) recorded in BOTH tmeta["delmask"] (lookup) and segfiles (every
    # walk of a table's files sees it). The bitmap covers the first
    # len(mask) rows of the segment in manifest file order; rows appended
    # later are live. Full rewrites (replace_contents, rewrite_table) drop
    # it. Reference: src/backend/access/appendonly/appendonly_visimap.c.

    def _read_bitmap(self, table: str, rel: str) -> np.ndarray:
        return self.read_file(table, rel)

    def stage_delmask(self, tx: dict, table: str, masks: dict) -> list:
        """Stage new deletion bitmaps ({segment: uint8[rows], 1 = deleted})
        into a manifest transaction; -> the replaced bitmaps' rels."""
        schema = self.catalog.get(table)
        tmeta = tx["tables"].setdefault(table, {"segfiles": {}, "nrows": {}})
        dm = tmeta.setdefault("delmask", {})
        compresstype = schema.options.get("compresstype", "zlib")
        complevel = int(schema.options.get("compresslevel", 1))
        fileno = uuid.uuid4().hex[:12]
        old_rels = []
        for seg, mask in masks.items():
            mask = np.asarray(mask, dtype=np.uint8)
            segdir = os.path.join(self.data_root(seg), table, f"seg{seg}")
            os.makedirs(segdir, exist_ok=True)
            fn = f"@del.{fileno}.ggb"
            write_column_file(os.path.join(segdir, fn), mask, compresstype,
                              complevel)
            rel = os.path.join(f"seg{seg}", fn)
            old = dm.get(str(seg))
            files = tmeta["segfiles"].setdefault(str(seg), [])
            if old is not None:
                old_rels.append(old)
                if old in files:
                    files.remove(old)
            files.append(rel)
            dm[str(seg)] = rel
        return old_rels

    def set_delmask(self, table: str, masks: dict) -> None:
        """Autocommit bitmap publish (one per-table delta commit). Retried
        when fenced off by a concurrent write-intent merge: the same
        bitmaps restaged on the fresh snapshot are right, since each
        covers a prefix of the row order and rows merged after this
        DELETE's snapshot are live. Other conflicts surface."""
        last = None
        for attempt in range(10):
            tx = self.manifest.begin()
            old = self.stage_delmask(tx, table, masks)
            try:
                self.manifest.commit_tables_tx(tx, [table])
            except IntentConflict as e:
                last = e
                staged = [tx["tables"][table]["delmask"][str(s)]
                          for s in masks]
                self.gc_files(table, staged, defer=False)
                counters.inc("manifest_cas_retry_total")
                time.sleep(0.01 * (attempt + 1))
                continue
            self.gc_files(table, old)
            self.maybe_fold_manifest()
            return
        raise RuntimeError(
            f"write-write conflict persisted after retries: {last}")

    def update_split(self, table: str, masks: dict, enc: dict,
                     valids: dict) -> None:
        """UPDATE's autocommit (nodeSplitUpdate.c): the old versions'
        bitmaps and the new versions' files in one per-table delta commit,
        as the JAX session's transaction publishes them."""
        tx = self.manifest.begin()

        def rels():
            tmeta = tx["tables"].get(table, {})
            return {r for f in tmeta.get("segfiles", {}).values() for r in f}

        before = rels()
        old = self.stage_delmask(tx, table, masks) if masks else []
        if enc and len(next(iter(enc.values()))):
            self.insert_encoded(table, enc, valids, tx=tx)
        staged = sorted(rels() - before)
        try:
            self.flush_dicts(table)
            self.manifest.commit_tables_tx(tx, [table])
        except BaseException:
            self.gc_files(table, staged, defer=False)
            raise
        self.gc_files(table, old)
        self.maybe_fold_manifest()

    def replace_contents(self, table: str, enc: dict, valids: dict) -> None:
        """Autocommit full-table replacement (a DELETE or UPDATE without
        WHERE): placement recomputed, so an updated distribution key moves
        its rows; the bitmaps and the old files go."""
        schema = self.catalog.get(table)
        self._check_not_null(schema, valids)
        tx = self.manifest.begin()
        old_files = [rel for files in tx["tables"].get(
            table, {"segfiles": {}})["segfiles"].values() for rel in files]
        nrows = len(next(iter(enc.values()))) if enc else 0
        nseg = schema.policy.numsegments
        tx["tables"][table] = {"segfiles": {}, "nrows": {},
                               "numsegments": nseg}
        self._write_segfiles(schema, table, tx["tables"][table], enc,
                             valids, self._seg_rows(schema, enc, valids,
                                                    nrows, 0),
                             uuid.uuid4().hex[:12])
        self.manifest.commit_tables_tx(tx, [table])
        self.gc_files(table, old_files)
        self.maybe_fold_manifest()

    def rewrite_table(self, table: str, new_numsegments: int) -> int:
        """VACUUM's compaction: every live row re-placed and published in
        one root commit without bitmaps; the old files go GC_GRACE_S
        later (the JAX store deletes them at once). A different
        width is gpexpand's (ROADMAP Queue 1 item 1a-ii). -> rows kept."""
        schema = self.catalog.get(table)
        if new_numsegments != schema.policy.numsegments:
            raise NotImplementedError(
                "changing a table's width (expand): ROADMAP Queue 1 item "
                "1a-ii")
        snap = self.manifest.snapshot()
        enc, valids = self._live_rows(table, snap)
        old_files = [rel for files in snap["tables"].get(
            table, {"segfiles": {}})["segfiles"].values() for rel in files]
        tx = self.manifest.begin()
        # the manifest carries the width, as the JAX store's rewrite does
        tx["tables"][table] = {"segfiles": {}, "nrows": {},
                               "numsegments": new_numsegments}
        nrows = len(next(iter(enc.values()))) if enc else 0
        self._write_segfiles(schema, table, tx["tables"][table], enc,
                             valids, self._seg_rows(schema, enc, valids,
                                                    nrows, 0),
                             uuid.uuid4().hex[:12])
        v = self.manifest.prepare(tx)
        try:
            self.manifest.commit(v)
        except BaseException:
            self.manifest.abort(v)
            raise
        self.gc_files(table, old_files)
        return nrows

    GC_GRACE_S = 30.0   # snapshot readers finish well within this

    def gc_files(self, table: str, rels: list, defer: bool = True) -> None:
        """Reclaim files a commit made unreachable, GC_GRACE_S later (a
        reader may still scan them from an older snapshot); ``defer``
        False deletes now (files nobody ever saw)."""
        if defer:
            with self._gc_mu:
                self._pending_gc.append((time.monotonic(), table,
                                         list(rels)))
            self.reap_gc()
            return
        for rel in rels:
            try:
                os.remove(self.seg_file_path(table, rel))
            except OSError:
                pass

    def reap_gc(self) -> int:
        """Delete deferred files older than GC_GRACE_S. -> how many."""
        now = time.monotonic()
        with self._gc_mu:
            due = [e for e in self._pending_gc if now - e[0] >= self.GC_GRACE_S]
            self._pending_gc = [e for e in self._pending_gc
                                if now - e[0] < self.GC_GRACE_S]
        for _ts, table, rels in due:
            self.gc_files(table, rels, defer=False)
        return sum(len(r) for _t, _tb, r in due)

    def drop_table(self, table: str) -> None:
        """DROP TABLE's storage half, as the JAX session does it: one root
        commit without the table, its delta chain removed, its
        dictionaries forgotten and its directory deleted."""
        tx = self.manifest.begin()
        if table in tx["tables"]:
            del tx["tables"][table]
            self.manifest.commit_tx(tx)
            self.manifest.drop_table_deltas(table)
        self._invalidate_dicts(table)
        with self._repair_mu:
            self._footers = {k: v for k, v in self._footers.items()
                             if k[0] != table}
        shutil.rmtree(os.path.join(self.root, "data", table),
                      ignore_errors=True)

    # ---- read path -----------------------------------------------------
    def read_segment(self, table: str, seg: int, columns=None,
                     snapshot: dict | None = None, prune=None, dest=None):
        """-> (cols {name: array}, valids {name: bool array | None},
        nrows) of one segment's visible rows under ``snapshot``, decoded
        from its block files: the rows its deletion bitmap marks are
        dropped, as the JAX store drops them. ``dest`` ({column:
        preallocated slot}): a column lands straight in its slot (the
        returned array is then a view of it): a column held in one file
        of a segment without deletions decodes into it, any other is
        assembled into it. Zone-map pruning waits for ROADMAP Queue 1
        item 1a-ii: every visible row is returned."""
        schema = self.catalog.get(table)
        snap = snapshot or self.manifest.snapshot()
        tmeta = snap["tables"].get(table, {"segfiles": {}, "nrows": {}})
        files = tmeta["segfiles"].get(str(seg), [])
        want = columns if columns is not None else schema.column_names
        nrows = int(tmeta["nrows"].get(str(seg), 0))
        keep = self.delmask_keep(table, seg, snap)
        cols: dict[str, np.ndarray] = {}
        valids: dict[str, np.ndarray | None] = {}
        for name in want:
            if name.startswith("@"):
                raise NotImplementedError(f"{name}: {_RAW_LATER}")
            c = schema.column(name)
            data_rels, valid_rels = [], []
            for rel in files:
                fn = os.path.basename(rel)
                if fn.startswith(name + ".") and fn.endswith(".ggb"):
                    if fn.endswith(".valid.ggb"):
                        valid_rels.append(rel)
                    elif fn.endswith(".rawoffs.ggb") \
                            or fn.endswith(".rawbytes.ggb"):
                        raise NotImplementedError(
                            f"{table}.{name}: {_RAW_LATER}")
                    else:
                        data_rels.append(rel)
            d = dest.get(name) if dest is not None else None
            whole = d is not None and keep is None and len(data_rels) == 1
            parts = [self.read_file(table, rel, out=d if whole else None)
                     for rel in data_rels]
            got = sum(len(a) for a in parts)
            if got != nrows:
                raise IOError(f"{table}.{name} seg{seg}: {got} rows, "
                              f"manifest says {nrows}")
            if valid_rels:
                # files without a .valid sibling are all-valid
                vmap = {r.replace(".valid.ggb", ".ggb"):
                        self.read_file(table, r) for r in valid_rels}
                v = np.concatenate(
                    [vmap.get(r, np.ones(len(a), dtype=np.uint8))
                     for r, a in zip(data_rels, parts)]).astype(bool)
                valids[name] = v if keep is None else v[keep]
            else:
                valids[name] = None
            cols[name] = self._assemble(parts, keep, d, c.type.np_dtype)
        if keep is not None:
            nrows = int(keep.sum())
        return cols, valids, nrows

    @staticmethod
    def _assemble(parts: list, keep, d, dtype) -> np.ndarray:
        """One column of a segment from its files' arrays, the rows a
        bitmap marks dropped: written straight into the caller's slot
        ``d`` where one is given and fits (no concatenated copy), else a
        new array."""
        n = sum(len(a) for a in parts)
        live = n if keep is None else int(keep.sum())
        if not parts:
            return np.empty(0, dtype=dtype)
        if len(parts) == 1 and keep is None:
            return parts[0]
        if d is None or len(d) < live:
            full = parts[0] if len(parts) == 1 else np.concatenate(parts)
            return full if keep is None else full[keep]
        out = d[:live]
        if keep is None:
            np.concatenate(parts, out=out)
            return out
        pos = off = 0
        for a in parts:
            kept = a[keep[off: off + len(a)]]
            out[pos: pos + len(kept)] = kept
            pos += len(kept)
            off += len(a)
        return out

    def has_nulls(self, table: str, col: str,
                  snapshot: dict | None = None) -> bool:
        """True if any committed segfile of this column has a validity
        file."""
        snap = snapshot or self.manifest.snapshot()
        marker = f"{col}."
        tmeta = snap["tables"].get(table, {"segfiles": {}})
        return any(os.path.basename(rel).startswith(marker)
                   and rel.endswith(".valid.ggb")
                   for files in tmeta["segfiles"].values() for rel in files)

    def column_bounds(self, table: str, col: str,
                      snapshot: dict | None = None):
        """Exact global [min, max] over every committed block of a stored
        column, from the blocks' zone maps in the footers (values at NULL
        positions are fillers inside the same zones: never an
        underestimate). None when a block has no zone (TEXT codes are
        zoned; bool and all-NaN blocks are not) or there are no rows."""
        snap = snapshot or self.manifest.snapshot()
        tmeta = snap["tables"].get(table, {"segfiles": {}})
        lo = hi = None
        for files in tmeta["segfiles"].values():
            for rel in files:
                fn = os.path.basename(rel)
                parts = fn.split(".")
                if len(parts) != 3 or not fn.endswith(".ggb") \
                        or parts[0] != col:
                    continue
                for b in self.read_footer_checked(table, rel)["blocks"]:
                    if not b["nrows"]:
                        continue
                    if "zmin" not in b:
                        return None
                    lo = b["zmin"] if lo is None else min(lo, b["zmin"])
                    hi = b["zmax"] if hi is None else max(hi, b["zmax"])
        return None if lo is None else (lo, hi)

    def segment_rowcounts(self, table: str,
                          snapshot: dict | None = None) -> list[int]:
        schema = self.catalog.get(table)
        snap = snapshot or self.manifest.snapshot()
        tmeta = snap["tables"].get(table, {"nrows": {}})
        return [int(tmeta["nrows"].get(str(s), 0))
                for s in range(schema.policy.numsegments)]
