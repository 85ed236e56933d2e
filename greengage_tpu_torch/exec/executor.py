"""Stage, run and present a planned statement — the port's counterpart of
greengage_tpu/exec/executor.py.

``Executor.run`` follows the JAX executor's path for one statement:

  stage     every scanned table's needed columns, read per segment from the
            store, assembled into ``[nseg, cap]`` host buffers and copied
            to the device from pinned memory; staged columns stay in a
            cache keyed by (table, column, capacity, store version), so a
            warm statement sends nothing over PCIe
  tiers     compile at tier 0 and run; the overflow flags (motion buckets,
            join tables and expansions, group tables, key packing, the
            pre-Gather compaction) come back in ONE host copy with the
            Gather's live count and the metrics; an overflow re-runs at the
            next tier (capacities x4), at its exact reported size, or
            unpacked, up to ``motion_retry_tiers``
  gather    the Gather Motion on the device: every segment's live rows (one
            segment's for a replicated child), compacted, merge-ordered
            when the plan asks, and a Limit's OFFSET/LIMIT trimmed
  present   one copy to the host and the decode (TEXT via its dictionary,
            DECIMAL descaled to float64, DATE to datetime64)

``run_tiers`` is the part after staging; the hand-built Q1 plan
(entry.q1_result) runs through it over tables it staged itself.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from greengage_tpu_torch import to_device
from greengage_tpu_torch import types as T
from greengage_tpu_torch.exec.compile import (
    VALID_PREFIX, CompileResult, Compiler, ProgramOutput, TableData,
)
from greengage_tpu_torch.ops import sort as sort_ops
from greengage_tpu_torch.ops.batch import Batch
from greengage_tpu_torch.planner.logical import Plan, Scan


class QueryError(RuntimeError):
    """A statement the executor cannot finish (capacity tiers exhausted,
    duplicate keys on a unique join's build side)."""


@dataclass
class Result:
    columns: list[str]
    cols: dict[str, np.ndarray]
    valids: dict[str, np.ndarray | None]
    _order: list[str]
    # storage-representation values (scaled int64 DECIMAL, TEXT codes)
    raw: dict[str, np.ndarray] = field(default_factory=dict)
    flags: dict[str, bool] = field(default_factory=dict)
    metrics: dict[str, np.ndarray] = field(default_factory=dict)
    wall_ms: float = 0.0
    # per-statement instrumentation: tiers_used, wall_ms, stage/compute ms
    stats: dict = field(default_factory=dict)

    def __len__(self):
        for c in self._order:
            return len(self.cols[c])
        return 0

    def rows(self) -> list[tuple]:
        out = []
        for i in range(len(self)):
            row = []
            for cid in self._order:
                v = self.valids.get(cid)
                row.append(None if v is not None and not v[i]
                           else self.cols[cid][i])
            out.append(tuple(row))
        return out

    def to_pandas(self):
        import pandas as pd

        data = {}
        names = []
        seen: dict = {}
        for name in self.columns:   # dedupe: two count() outputs must not
            k = seen.get(name, 0)   # collapse into one DataFrame column
            seen[name] = k + 1
            names.append(name if k == 0 else f"{name}_{k}")
        for name, cid in zip(names, self._order):
            col = self.cols[cid]
            v = self.valids.get(cid)
            if v is not None:
                col = np.asarray(col, dtype=object).copy()
                col[~v] = None
            data[name] = col
        return pd.DataFrame(data)


# ---------------------------------------------------------------------------
# run a compiled program: the tier loop, the Gather, the presentation
# ---------------------------------------------------------------------------

def _flag_tensor(out: ProgramOutput, comp: CompileResult, live):
    """Every flag, the Gather's live count and every metric in one int64
    vector, so the host reads them with one copy."""
    parts = [out.flags[n].reshape(1).to(torch.int64) for n in comp.flag_names]
    parts.append(live.reshape(1).to(torch.int64))
    parts += [out.metrics[n].reshape(-1).to(torch.int64)
              for n in comp.metric_names]
    return torch.cat(parts)


def _gather_rows(comp: CompileResult, out: ProgramOutput):
    """-> (cols, valids, sel) of the rows the Gather reads, flattened to
    [1, segments x cap]: segment 0's for a replicated child."""
    take = slice(0, 1) if comp.replicated else slice(None)
    sel = out.sel[take].reshape(1, -1)
    cols = {c.id: out.cols[c.id][take].reshape(1, -1) for c in comp.out_cols}
    valids = {c.id: out.valids[c.id][take].reshape(1, -1)
              for c in comp.out_cols if c.id in out.valids}
    return cols, valids, sel


def gather(comp: CompileResult, out: ProgramOutput, compiler,
           live: int) -> dict:
    """The Gather Motion on the device: -> {col id: (values, valid)} of the
    live rows, merge-ordered when the plan asks for it, then the host
    Limit's OFFSET/LIMIT. ``live`` is the count the host already read."""
    cols, valids, sel = _gather_rows(comp, out)
    cols, valids, sel = sort_ops.compact(cols, valids, sel, live)
    if comp.merge_keys:
        keys = compiler.sort_keys(Batch(cols, valids, sel), comp.merge_keys)
        perm, _, _ = sort_ops.sort_batch(keys, sel, live)
        cols, valids = sort_ops.apply_perm(cols, valids, perm)
    lo, hi = 0, live
    if comp.host_limit is not None:
        limit, offset = comp.host_limit
        lo = min(offset, live)
        hi = live if limit is None else min(live, offset + limit)
    return {c.id: (cols[c.id][0, lo:hi],
                   valids[c.id][0, lo:hi] if c.id in valids else None)
            for c in comp.out_cols}


def _to_host(tensors: dict) -> dict:
    """Every tensor as a numpy array, with one wait for the card: each CUDA
    tensor is copied to pinned memory non_blocking but the last, whose
    blocking copy waits for the stream and so for every copy before it."""
    on_card = [k for k, t in tensors.items() if t.device.type == "cuda"]
    out = {}
    for k, t in tensors.items():
        if t.device.type == "cuda":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            t = h.copy_(t, non_blocking=k != on_card[-1])
        out[k] = t.numpy()
    return out


def present(comp: CompileResult, rows: dict, flags: dict, metrics: dict,
            compiler) -> Result:
    """Host-side presentation: TEXT/decimal/date decode, Result assembly."""
    tensors = {}
    for cid, (data_t, valid_t) in rows.items():
        tensors[cid] = data_t
        if valid_t is not None:
            tensors[("@v", cid)] = valid_t
    host = _to_host(tensors)
    out_cols, out_valids, raw = {}, {}, {}
    for c in comp.out_cols:
        data = host[c.id]
        valid = host.get(("@v", c.id))
        if valid is None:
            valid = np.ones(len(data), bool)
        raw[c.id] = data
        if c.hidden:
            out_cols[c.id] = data
        elif c.type.kind is T.Kind.TEXT and c.dict_ref is not None:
            d = compiler.dictionary(c.dict_ref)
            out_cols[c.id] = np.array(
                [d[x] if 0 <= x < len(d) else None for x in data],
                dtype=object)
        elif c.type.kind is T.Kind.DECIMAL:
            out_cols[c.id] = data / (10.0 ** c.type.scale)
        elif c.type.kind is T.Kind.DATE:
            out_cols[c.id] = (np.datetime64("1970-01-01", "D")
                              + data.astype("timedelta64[D]"))
        else:
            out_cols[c.id] = data
        out_valids[c.id] = None if valid.all() else valid
    visible = [c for c in comp.out_cols if not c.hidden]
    return Result(columns=[c.name for c in visible], cols=out_cols,
                  valids=out_valids, _order=[c.id for c in visible],
                  raw=raw, flags=flags, metrics=metrics)


def run_tiers(plan, tables: dict[str, TableData], layout, settings,
              consts: dict | None = None, dictionary=None,
              no_direct: bool = False) -> Result:
    """Compile ``plan`` over staged ``tables`` and run it, retrying on
    overflow as the JAX executor's _run_tiers does: a capacity overflow
    re-runs at the next tier (capacities x4), sized from the exact count
    where the device reported one; a key-packing bounds violation re-runs
    the same tier with that node unpacked; duplicate keys on a unique
    join's build side raise QueryError (the session re-plans with the
    multi-match join). ``no_direct`` builds every join's hash table."""
    t0 = time.perf_counter()
    tier = 0
    attempts = 0
    cap_overrides: dict = {}
    pack_disabled: set = set()
    last_err = None
    # tiers grow capacities; a packing violation re-runs the SAME tier, so
    # the attempt bound covers both kinds of retry
    while tier < settings.motion_retry_tiers \
            and attempts < settings.motion_retry_tiers + 4:
        attempts += 1
        compiler = Compiler(layout, tables, settings, consts, dictionary,
                            tier=tier, cap_overrides=cap_overrides,
                            pack_disabled=pack_disabled, no_direct=no_direct)
        comp = compiler.compile(plan)
        out = comp.program(tables)
        _, _, sel = _gather_rows(comp, out)
        host = _flag_tensor(out, comp, sel.sum()).cpu().numpy()
        nflags = len(comp.flag_names)
        flags = {n: bool(v) for n, v in zip(comp.flag_names, host[:nflags])}
        live = int(host[nflags])
        metrics, i = {}, nflags + 1
        for n in comp.metric_names:
            k = out.metrics[n].numel()
            metrics[n] = host[i:i + k]
            i += k
        if any(v for n, v in flags.items() if n.startswith("join_dup")):
            raise QueryError(
                "hash join build side has duplicate keys; only unique-key "
                "(PK-FK) hash joins are supported in this version")
        overflow = [n for n, v in flags.items() if v]
        if not overflow:
            res = present(comp, gather(comp, out, compiler, live), flags,
                          metrics, compiler)
            res.wall_ms = (time.perf_counter() - t0) * 1e3
            res.stats = {"tiers_used": tier + 1, "attempts": attempts,
                         "wall_ms": res.wall_ms,
                         "fused_gate": comp.uses_fused,
                         "segments": layout.nseg,
                         "metrics": {k: int(v.sum()) if k.startswith("nrows_")
                                     else int(v.max())
                                     for k, v in metrics.items()}}
            return res
        # a packing violation re-runs the SAME tier with that node
        # unpacked; an overflow that reports its exact need sizes the retry
        # from it; an overflowed compaction re-runs the SAME tier, and any
        # other capacity overflow grows every capacity 4x
        capacity_over = []
        for name in overflow:
            if name.startswith("pack_overflow"):
                pack_disabled.add(comp.flag_packs[name])
                continue
            capacity_over.append(name)
            hint = comp.flag_caps.get(name)
            if hint is not None:
                nid, metric = hint
                need = int(metrics[metric].max())
                cap_overrides[nid] = need + max(need // 16, 64)
        if [n for n in capacity_over
                if not n.startswith("gather_compact_overflow")]:
            tier += 1
        last_err = f"capacity overflow in {overflow} at tier {tier}"
    raise QueryError(f"query exceeded capacity tiers: {last_err}")


# ---------------------------------------------------------------------------
# the session's executor: staging from the store, its cache
# ---------------------------------------------------------------------------

def _scans(plan: Plan, out: dict) -> dict:
    """table -> the storage columns its Scans read (every scan's union)."""
    if isinstance(plan, Scan):
        out.setdefault(plan.table, set()).update(c.name for c in plan.cols)
    for c in plan.children:
        _scans(c, out)
    return out


class Executor:
    def __init__(self, catalog, store, layout, settings):
        self.catalog = catalog
        self.store = store
        self.layout = layout
        self.nseg = layout.nseg
        self.settings = settings
        # (table, column, capacity, version) -> staged [nseg, cap] tensor;
        # (table, "@present", capacity, version) -> the live-slot mask
        self._stage_cache: dict = {}

    def invalidate_table(self, table: str) -> None:
        for k in [k for k in self._stage_cache if k[0] == table]:
            del self._stage_cache[k]

    def run(self, plan, consts: dict, no_direct: bool = False) -> Result:
        t0 = time.perf_counter()
        snapshot = self.store.manifest.snapshot()
        tables = self._stage(plan, snapshot)
        t1 = time.perf_counter()
        res = run_tiers(plan, tables, self.layout, self.settings, consts,
                        lambda ref: self.store.dictionary(*ref).values,
                        no_direct=no_direct)
        res.wall_ms = (time.perf_counter() - t0) * 1e3
        res.stats["stage_ms"] = (t1 - t0) * 1e3
        res.stats["wall_ms"] = res.wall_ms
        return res

    def _stage(self, plan, snapshot) -> dict[str, TableData]:
        """Every scanned table's needed columns on the device in segment
        layout, from the stage cache or staged now."""
        version = snapshot.get("version", 0)
        # staged copies of older versions are unreachable: free them
        for k in [k for k in self._stage_cache if k[3] != version]:
            del self._stage_cache[k]
        out = {}
        for table, names in sorted(_scans(plan, {}).items()):
            schema = self.catalog.get(table)
            counts = self.store.segment_rowcounts(table, snapshot)
            cap = max(max(counts, default=0), 1)
            want = []
            for c in sorted(names):
                want.append(c)
                if self.store.has_nulls(table, c, snapshot):
                    want.append(VALID_PREFIX + c)
            missing = [c for c in want + ["@present"]
                       if (table, c, cap, version) not in self._stage_cache]
            if missing:
                self._stage_cache.update(
                    {(table, c, cap, version): t for c, t in self._put(
                        schema, table, missing, cap, counts,
                        snapshot).items()})
            cols = {c: self._stage_cache[(table, c, cap, version)]
                    for c in want}
            present = self._stage_cache[(table, "@present", cap, version)]
            out[table] = TableData(table, cols, present)
        return out

    def _put(self, schema, table, names, cap, counts, snapshot) -> dict:
        """Read ``names`` of every segment from the store, assemble each
        into a [nseg, cap] host buffer and copy it to the device from
        pinned memory (non_blocking)."""
        dev = self.layout.device
        storage = sorted({c[len(VALID_PREFIX):] if c.startswith(VALID_PREFIX)
                          else c for c in names if c != "@present"})
        bufs = {}
        for c in names:
            if c == "@present" or c.startswith(VALID_PREFIX):
                bufs[c] = np.zeros((self.nseg, cap), dtype=bool)
            else:
                col = schema.column(c)
                bufs[c] = np.zeros((self.nseg, cap),
                                   dtype=col.type.np_dtype)
        for seg in range(self.nseg):
            cols, valids, n = self.store.read_segment(table, seg, storage,
                                                      snapshot)
            for c, buf in bufs.items():
                if c == "@present":
                    buf[seg, :n] = True
                elif c.startswith(VALID_PREFIX):
                    v = valids.get(c[len(VALID_PREFIX):])
                    buf[seg, :n] = True if v is None else v
                else:
                    buf[seg, :n] = cols[c]
        return {c: to_device(buf, dev) for c, buf in bufs.items()}
