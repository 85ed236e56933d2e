"""Host-offload spill: pass-partitioned execution past the device's memory
— the port's counterpart of greengage_tpu/exec/spill.py.

Host RAM plays the workfile (exec/workfile.py), and the unit of spilling
is a whole EXECUTION PASS. Three shapes spill, tried in this order by
``Executor._spill_fallback``:

  - ``spill_run``: a plan whose spine reaches a reduction point —
    FinalAggregate(Motion(PartialAggregate(probe-linear subtree))) or a
    keys-only dedupe — runs the subtree and the partial aggregate per
    chunk of its biggest table's rows, captures the partial states on the
    host, and runs the final plan once over them (a dedupe merge that
    still does not fit re-merges in key-hash buckets,
    ``_bucketed_dedupe_merge``);
  - ``spill_window_run``: a partitioned window captures its input in
    chunked passes, then runs per disjoint PARTITION BY hash bucket;
  - ``spill_sort_run``: an ORDER BY runs per chunk, each pass sorted on
    the device, and the host merges the sorted runs.

The pass schedule is a pure function of the compiled estimates and the
settings, as in the JAX package, so both packages spill the same
statements in the same number of passes at the same
``vmem_protect_limit_mb``. The sort and window passes capture storage
values (the merge orders scaled DECIMALs and day numbers exactly) and
decode once at the end. Every pass boundary is a cancellation point and a
``spill-pass`` span of the statement's trace. Under EXPLAIN ANALYZE
(``instrument``) every pass's and the merge's per-node row counts sum
onto the original plan's nodes. Multi-host schedule checks wait for
ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import copy
import itertools

import numpy as np

from greengage_tpu_torch import expr as E
from greengage_tpu_torch import types as T
from greengage_tpu_torch.analysis.plancheck import validate_plan
from greengage_tpu_torch.planner.locus import Locus
from greengage_tpu_torch.planner.logical import (Aggregate, ColInfo, Filter,
                                                 Join, Limit, Motion,
                                                 MotionKind, PartialState,
                                                 Plan, Project, Scan, Sort,
                                                 Window)
from greengage_tpu_torch.runtime import interrupt, memaccount
from greengage_tpu_torch.runtime import trace as _trace
from greengage_tpu_torch.runtime.logger import counters
from greengage_tpu_torch.storage import native

MAX_PASSES = 256
CHUNK_FLOOR = 1 << 12


class NotSpillable(ValueError):
    """The plan's shape cannot be pass-partitioned soundly."""


def partial_state_cols(partial: Aggregate) -> list:
    """ColInfos for a partial Aggregate's actual output: group keys plus
    the @c/@s/@m state columns the final phase merges."""
    # keys re-exposed with name == id: the host-input staging maps columns
    # by storage NAME, and the ephemeral table's storage names are the ids
    out = [ColInfo(ci.id, ci.type, ci.id, ci.dict_ref)
           for ci, _ in partial.group_keys]
    for ci, a in partial.aggs:
        if a.func in ("count", "count_star"):
            out.append(ColInfo(ci.id + "@c", T.INT64, ci.id + "@c"))
        elif a.func == "sum":
            out.append(ColInfo(ci.id + "@s", a.type, ci.id + "@s"))
        elif a.func == "avg":
            stype = E.agg_result_type("sum", a.arg.type)
            out.append(ColInfo(ci.id + "@s", stype, ci.id + "@s"))
            out.append(ColInfo(ci.id + "@c", T.INT64, ci.id + "@c"))
        elif a.func in ("min", "max"):
            out.append(ColInfo(ci.id + "@m", a.arg.type, ci.id + "@m",
                               dict_ref=getattr(a.arg, "_dict_ref", None)))
    return out


_WRAPPERS = (Sort, Limit, Project, Filter)


def find_spill_split(plan: Motion):
    """-> (capture_agg, replace_target, add_motion) of the DEEPEST
    reduction point on the plan's spine, or None.

    A reduction point is an Aggregate whose output rows merge exactly
    across disjoint input partitions:
      - a partial aggregate (sums/counts/min/max states are additive) —
        capture its STATE columns, swap the partial itself in the merge;
      - a keys-only "dedupe" aggregate (dedupe(U dedupe(chunk)) =
        dedupe(U)) — capture its key rows, swap the subtree BELOW its
        redistribute Motion so the merge re-hashes the union first.
    The walk descends through wrappers, motions and single-phase
    aggregates, so a DISTINCT dedupe under the outer aggregate's own
    phases is still found."""
    node = plan.child
    best = None
    while True:
        while isinstance(node, _WRAPPERS):
            node = node.child
        if (isinstance(node, Aggregate) and node.phase == "final"
                and isinstance(node.child, Motion)
                and isinstance(node.child.child, Aggregate)
                and node.child.child.phase == "partial"):
            partial = node.child.child
            best = (partial, partial, False)
            node = partial.child
            continue
        if (isinstance(node, Aggregate) and node.phase == "single"
                and not node.aggs and node.group_keys
                # the merge re-runs this dedupe over host-staged rows
                # carrying the OUTPUT ids, so every key must be a plain
                # pass-through column
                and all(isinstance(e, E.ColRef) and e.name == ci.id
                        for ci, e in node.group_keys)):
            if (isinstance(node.child, Motion)
                    and node.child.kind is MotionKind.REDISTRIBUTE):
                # the existing motion re-hashes the merge's union rows
                best = (node, node.child.child, False)
                node = node.child.child
            else:
                # colocated dedupe: a key can recur across PASSES and the
                # contiguous host staging scatters it across segments, so
                # the merge inserts a redistribute of its own
                best = (node, node.child, True)
                node = node.child
            continue
        if isinstance(node, Aggregate) and node.phase == "single":
            node = node.child
            continue
        if isinstance(node, Motion) and node.kind is MotionKind.REDISTRIBUTE:
            node = node.child
            continue
        break
    return best


def spill_candidate_tables(plan: Plan) -> list[str]:
    """Tables over whose row-partitions the subtree's OUTPUT is a disjoint
    union. Probe-side descent is always sound; build-side descent only
    through INNER (and cross) joins: a chunked build partitions each probe
    row's matches across passes, which unions exactly for inner joins but
    double-counts semi joins and null-extends left joins per pass."""
    out = []

    def walk(node):
        if isinstance(node, Scan):
            out.append(node.table)
            return
        if isinstance(node, Join):
            walk(node.left)
            if node.kind in ("inner", "cross") and not node.null_aware:
                walk(node.right)
            return
        if isinstance(node, (Project, Filter, Motion)):
            walk(node.child)

    walk(plan)
    return out


def count_scans(plan: Plan, table: str) -> int:
    n = 0
    stack = [plan]
    while stack:
        p = stack.pop()
        if isinstance(p, Scan) and p.table == table:
            n += 1
        stack.extend(p.children)
    return n


def _charge_spill(cols: dict, valids: dict, item: str) -> None:
    """Account the host-resident merged rows to the statement's 'spill'
    owner (runtime/memaccount.py)."""
    nb = sum(int(getattr(a, "nbytes", 0)) for a in cols.values())
    nb += sum(int(getattr(a, "nbytes", 0)) for a in valids.values()
              if a is not None)
    memaccount.charge("spill", nb, item=item)


def _collect_passes(cols_spec, results):
    """Merge per-pass Result columns on the host into preallocated
    buffers: -> (cols, valids) where valids[c] is None when every pass
    reported the column all-valid."""
    per_pass = []                      # (rows, {id: (arr, valids|None)})
    any_invalid = {c.id: False for c in cols_spec}
    total = 0
    for res in results:
        data = {}
        rows = 0
        for c in cols_spec:
            a = np.asarray(res.cols[c.id])
            rows = len(a)
            v = res.valids.get(c.id)
            if v is not None:
                v = np.asarray(v, bool)
                any_invalid[c.id] = True
            data[c.id] = (a, v)
        per_pass.append((rows, data))
        total += rows
    dtypes = {}
    for _rows, data in per_pass:
        for cid, (a, _v) in data.items():
            dtypes[cid] = (a.dtype if cid not in dtypes
                           else np.result_type(dtypes[cid], a.dtype))
    cols = {c.id: np.empty(total, dtype=dtypes.get(c.id, np.int64))
            for c in cols_spec}
    valids = {c.id: (np.ones(total, dtype=bool)
                     if any_invalid[c.id] else None) for c in cols_spec}
    off = 0
    for rows, data in per_pass:
        for c in cols_spec:
            a, v = data[c.id]
            cols[c.id][off:off + rows] = a
            if valids[c.id] is not None and v is not None:
                valids[c.id][off:off + rows] = v
        off += rows
    return cols, valids


def _size_chunk_passes(executor, consts, pass_plan, candidates,
                       limit_bytes):
    """Largest-first chunk-size search shared by the partial-aggregate and
    window spills: pick partition tables and per-pass chunk rows that
    bring the compiled pass program's est_bytes under the limit (several
    tables = the grace chunk grid). -> (chosen {table: chunk}, per_table
    [(table, chunk, n)], total passes); raises NotSpillable when no
    combination fits or the grid explodes."""
    store = executor.store
    candidates = sorted(
        candidates, key=lambda t: -max(store.segment_rowcounts(t),
                                       default=0))
    chosen: dict[str, int] = {}          # table -> chunk rows
    fits = False
    for cand in candidates:
        max_rows = max(store.segment_rowcounts(cand), default=0)
        if max_rows == 0:
            continue
        chunk = max_rows
        while True:
            chunk = max(chunk // 2, CHUNK_FLOOR)
            over = dict(chosen)
            over[cand] = chunk
            comp = executor.compile(pass_plan, consts, scan_cap_override=over)
            if comp.est_bytes <= limit_bytes * 0.7 or chunk == CHUNK_FLOOR:
                break
        chosen[cand] = chunk
        if comp.est_bytes <= limit_bytes:
            fits = True
            break
    if not fits:
        raise NotSpillable("per-pass working set still exceeds the limit "
                           "for every partitionable table combination")
    per_table = []                        # (table, chunk, npasses)
    npasses = 1
    for t, chunk in chosen.items():
        max_rows = max(store.segment_rowcounts(t), default=0)
        n = -(-max_rows // chunk)
        per_table.append((t, chunk, n))
        npasses *= n
    if npasses > MAX_PASSES:
        raise NotSpillable(
            f"spill would need {npasses} passes (> {MAX_PASSES})")
    return chosen, per_table, npasses


def _run_passes(executor, pass_plan, consts, cols_spec, per_table, item,
                instrument=False):
    """Every pass of a chunk grid, captured in a SpillWorkfile (the caller
    closes it). The prefetcher builds pass k+1's host buffers while pass k
    runs; it is joined on every path. Each pass boundary is a
    cancellation point (the JAX package's partial-aggregate, sorted-run
    and window-input pass loops, which the port's three spill kinds share
    here)."""
    from greengage_tpu_torch.exec import staging as _staging
    from greengage_tpu_torch.exec import workfile as _workfile

    grids = [[(t, (i * c, (i + 1) * c)) for i in range(n)]
             for t, c, n in per_table]
    caps = {t: c for t, c, _ in per_table}
    combos = list(itertools.product(*grids))
    wf = _workfile.SpillWorkfile(executor, cols_spec, item)
    prefetcher = _staging.PassPrefetcher(
        executor, pass_plan, executor.store.manifest.snapshot(), caps,
        (consts or {}).get("@params@"))
    try:
        for i, combo in enumerate(combos):
            interrupt.check_interrupts()   # spill pass boundary
            prefetcher.next_ranges = (dict(combos[i + 1])
                                      if i + 1 < len(combos) else None)
            with _trace.span("spill-pass", cat="spill", index=i,
                             total=len(combos), item=item):
                wf.add(executor.run_single(
                    pass_plan, consts, raw=True,
                    scan_cap_override=caps, row_ranges=dict(combo),
                    no_direct=True, prefetcher=prefetcher,
                    instrument=instrument))
    except BaseException:
        wf.close()
        raise
    finally:
        prefetcher.close()
    return wf


def spill_run(executor, plan: Motion, consts, raw: bool,
              instrument: bool = False):
    """Execute ``plan`` in partitioned passes below its reduction point.
    Raises NotSpillable when the plan shape is not spillable.
    ``instrument`` (EXPLAIN ANALYZE) sums per-node row counts from every
    pass and the merge program onto the ORIGINAL plan's nodes (the pass
    subtree shares node objects with the plan; the merge path's clones
    map back through _replace_child's node map)."""
    split = find_spill_split(plan)
    if split is None:
        raise NotSpillable("plan shape not spillable")
    capture_agg, replace_target, add_motion = split
    subtree = (capture_agg.child if capture_agg is replace_target
               else replace_target)
    candidates = [t for t in spill_candidate_tables(subtree)
                  if not t.startswith("@") and count_scans(plan, t) == 1]
    if not candidates:
        raise NotSpillable("no partitionable table below the reduction point")

    from greengage_tpu_torch.exec.executor import (AdmissionError,
                                                   effective_limit_bytes)

    limit_bytes = effective_limit_bytes(executor.settings, executor.layout)

    # pass program: gather the reduction point's output rows (partial
    # STATE columns / dedupe keys, in their storage form)
    state_cols = partial_state_cols(capture_agg)
    capture = PartialState(capture_agg, state_cols)
    capture.locus = capture_agg.locus
    capture.est_rows = capture_agg.est_rows
    pass_plan = Motion(MotionKind.GATHER, capture)
    pass_plan.locus = Locus.entry()

    # the partition tables (largest first — the probe side and/or inner
    # build sides, the grace-join regime) and the chunk sizes that bring
    # the pass program under the limit
    _chosen, per_table, npasses = _size_chunk_passes(
        executor, consts, pass_plan, candidates, limit_bytes)
    wf = _run_passes(executor, pass_plan, consts, state_cols, per_table,
                     "partials", instrument)
    try:
        aux_cols, aux_valids = wf.assemble()
        pass_stats = wf.stats
    finally:
        wf.close()

    # merge program: the original plan with the replace target swapped for
    # a host input of the merged captured rows. Partial case: the partial
    # itself is replaced (its states redistribute + final-merge above).
    # Dedupe case: the subtree BELOW the dedupe's redistribute is
    # replaced, so the union re-hashes before the dedupe re-runs
    aux_name = "@spill:partials"
    host_scan = Scan(aux_name, list(state_cols))
    host_scan.locus = (capture_agg.locus
                       if capture_agg is replace_target
                       else Locus.strewn(executor.nseg))
    host_scan.est_rows = float(len(next(iter(aux_cols.values()), [])))
    repl: Plan = host_scan
    if add_motion:
        key_cols = [ci for ci, _ in capture_agg.group_keys]
        m = Motion(MotionKind.REDISTRIBUTE, host_scan,
                   hash_exprs=[E.ColRef(ci.id, ci.type) for ci in key_cols])
        m.locus = Locus.hashed(tuple(ci.id for ci in key_cols),
                               executor.nseg)
        m.est_rows = host_scan.est_rows
        repl = m
    node_map: dict = {}
    merged = _replace_child(plan, replace_target, repl, node_map)
    try:
        res = executor.run_single(
            merged, consts, raw=raw,
            aux_tables={aux_name: (aux_cols, aux_valids)}, no_direct=True,
            instrument=instrument)
    except AdmissionError:
        if capture_agg.aggs:      # partial-state merges never regress
            raise
        # recursive merge: the dedupe working set (~the full key domain
        # for near-unique keys) still exceeds the limit. Partition the
        # captured keys BY KEY HASH into disjoint buckets — dedupe is exact
        # per bucket, and the additive partial states above the dedupe sum
        # exactly across buckets
        res, extra = _bucketed_dedupe_merge(
            executor, merged, capture_agg, host_scan, aux_name, aux_cols,
            aux_valids, consts, raw, limit_bytes)
        if instrument:
            _merge_node_rows(res, pass_stats, node_map)
        return res, npasses + extra
    if instrument:
        _merge_node_rows(res, pass_stats, node_map)
    return res, npasses


def _merge_node_rows(res, pass_stats, node_map) -> None:
    """EXPLAIN ANALYZE accounting across spill passes: per-node row
    counts from the pass programs' stats (their subtree nodes ARE the
    original plan's objects) sum with the merge program's (clone ids
    mapped to their originals), under the original plan-node identities
    the session's describe() walk uses."""
    agg: dict = {}
    for st in pass_stats:
        for nid, n in (((st or {}).get("node_rows")) or {}).items():
            agg[nid] = agg.get(nid, 0) + n
    res.stats = dict(res.stats or {})
    for nid, n in (res.stats.get("node_rows") or {}).items():
        nid = node_map.get(nid, nid)
        agg[nid] = agg.get(nid, 0) + n
    res.stats["node_rows"] = agg


def _find_partial_above(plan: Plan, target: Plan):
    """DEEPEST final->Motion->partial aggregate pattern whose partial
    subtree contains ``target``."""
    found = None

    def walk(node):
        nonlocal found
        if (isinstance(node, Aggregate) and node.phase == "final"
                and isinstance(node.child, Motion)
                and isinstance(node.child.child, Aggregate)
                and node.child.child.phase == "partial"
                and _contains(node.child.child, target)):
            found = node.child.child
        for c in node.children:
            walk(c)

    walk(plan)
    return found


def _bucket_hash(aux_cols, aux_valids, key_ids) -> np.ndarray:
    n = len(next(iter(aux_cols.values())))
    h = np.full(n, 0x9E3779B9, np.uint32)
    for kid in key_ids:
        a = np.asarray(aux_cols[kid])
        if a.dtype.kind == "f":
            # hashfloat8 parity: -0.0 -> 0.0 and all NaN payloads -> one
            # pattern, or equal keys split buckets
            a = a.astype(np.float64)
            a = np.where(np.isnan(a), np.float64("nan"), a + 0.0)
            a = a.view(np.int64)
        hk = native.hash_i64(a.astype(np.int64))
        v = aux_valids.get(kid)
        if v is not None:
            hk = np.where(np.asarray(v, bool), hk, np.uint32(0x27D4EB2F))
        h = native.hash_combine(h, hk)
    return h


def _subset(aux_cols, aux_valids, mask):
    return ({k: np.asarray(v)[mask] for k, v in aux_cols.items()},
            {k: (np.asarray(v, bool)[mask] if v is not None else None)
             for k, v in aux_valids.items()})


def _bucketed_dedupe_merge(executor, merged, dedupe, host_scan, aux_name,
                           aux_cols, aux_valids, consts, raw, limit_bytes):
    """Run the merge in key-hash buckets, capturing the outer partial
    aggregate's states per bucket; one small final pass merges them."""
    # anchor on the host scan: _replace_child shallow-copied every node on
    # the path, but the inserted host scan is in ``merged`` by reference
    outer_partial = _find_partial_above(merged, host_scan)
    if outer_partial is None:
        raise NotSpillable(
            "dedupe working set exceeds the limit and no additive "
            "aggregate sits above the distinct level to merge buckets")
    key_ids = [ci.id for ci, _ in dedupe.group_keys]
    h = _bucket_hash(aux_cols, aux_valids, key_ids)

    state_cols = partial_state_cols(outer_partial)
    capture = PartialState(outer_partial, state_cols)
    capture.locus = outer_partial.locus
    capture.est_rows = outer_partial.est_rows
    bucket_plan = Motion(MotionKind.GATHER, capture)
    bucket_plan.locus = Locus.entry()

    # size K against the COMPILED per-bucket estimate (bucket 0 as the
    # representative subset; the hash is uniform)
    K = 2
    while True:
        comp = executor.compile(
            bucket_plan, consts, aux_tables={aux_name: _subset(
                aux_cols, aux_valids, (h % np.uint32(K)) == 0)})
        if comp.est_bytes <= max(limit_bytes, 1) * 0.9 or K >= 64:
            break
        K *= 2
    if comp.est_bytes > limit_bytes:
        raise NotSpillable(
            "per-bucket dedupe working set still exceeds the limit at 64 "
            "merge buckets")
    bucket = h % np.uint32(K)

    # bucket k+1's host subset build overlaps bucket k's device program
    from greengage_tpu_torch.exec import motionpipe as _motionpipe

    run_bkts = [b for b in range(K) if (bucket == b).any()]

    def _bstage(bkt, _i):
        return _subset(aux_cols, aux_valids, bucket == bkt)

    def _bcompute(staged, _bkt, _i):
        return executor.run_single(bucket_plan, consts, raw=True,
                                   aux_tables={aux_name: staged},
                                   no_direct=True)

    bucket_results = _motionpipe.run_pipeline(run_bkts, _bstage, _bcompute,
                                               label="dedupe")
    s_cols, s_valids = _collect_passes(state_cols, bucket_results)
    _charge_spill(s_cols, s_valids, "merge-buckets")
    aux2 = "@spill:partials2"
    host_scan2 = Scan(aux2, list(state_cols))
    host_scan2.locus = outer_partial.locus
    host_scan2.est_rows = float(len(next(iter(s_cols.values()), [])))
    final_plan = _replace_child(merged, outer_partial, host_scan2)
    res = executor.run_single(
        final_plan, consts, raw=raw,
        aux_tables={aux2: (s_cols, s_valids)}, no_direct=True)
    res.stats = dict(res.stats or {})
    res.stats["spill_merge_buckets"] = K
    return res, K


def _sortable_host_key(arr: np.ndarray, valid, desc: bool,
                       nulls_first: bool):
    """-> [enc, null class] (minor->major within this key) whose ascending
    np.lexsort order equals the engine's order for this key; None when
    the host representation does not order."""
    a = np.asarray(arr)
    if a.dtype.kind in ("i", "u", "b"):
        enc = a.astype(np.int64)
        enc = (enc ^ np.int64(-0x8000000000000000)).astype(np.uint64)
        if desc:
            enc = ~enc
    elif a.dtype.kind == "f":
        bits = a.astype(np.float64).view(np.uint64)
        enc = np.where(bits >> np.uint64(63),
                       ~bits, bits | np.uint64(1 << 63))
        if desc:
            enc = ~enc
    else:
        return None
    nul = (np.zeros(len(a), np.uint8) if valid is None
           else (~np.asarray(valid, bool)).astype(np.uint8))
    if nulls_first:
        nul = 1 - nul
    # major key: null class; minor: encoded value (lexsort order)
    return [enc, nul]


def _host_sort_spec(sort: Sort, out_cols) -> list[tuple]:
    """Validate a Sort's keys as host-mergeable gathered output columns
    -> [(col id, desc, nulls_first)]; raises NotSpillable otherwise. The
    passes capture storage values: a TEXT key's codes do not sort as its
    strings, and the JAX package's host merge orders neither TEXT nor DATE
    keys (it merges presented values), so both stay unspillable here."""
    by_id = {c.id: c for c in out_cols}
    keyspec = []
    for e, desc, nf in sort.keys:
        if not isinstance(e, E.ColRef) or e.name not in by_id:
            raise NotSpillable("sort key is not a gathered output column")
        kc = by_id[e.name]
        if kc.type.kind in (T.Kind.TEXT, T.Kind.DATE) \
                or kc.raw_ref is not None or kc.raw_chain is not None:
            raise NotSpillable("sort key host representation does not "
                               "order")
        keyspec.append((e.name, bool(desc),
                        bool(desc) if nf is None else bool(nf)))
    return keyspec


def _host_lexsort(cols: dict, valids: dict, keyspec: list[tuple]):
    """One stable ascending lexsort over order-preserving key encodings
    (the k-way merge step); keys minor->major."""
    lex: list[np.ndarray] = []
    for name, desc, nf in reversed(keyspec):
        enc = _sortable_host_key(cols[name], valids[name], desc, nf)
        if enc is None:
            raise NotSpillable("sort key host representation does not order")
        lex.extend(enc)
    perm = np.lexsort(lex)
    cols = {k: v[perm] for k, v in cols.items()}
    valids = {k: (v[perm] if v is not None else None)
              for k, v in valids.items()}
    return cols, valids


def _limit(cols, valids, limit_node):
    lo = limit_node.offset
    hi = None if limit_node.limit is None else lo + limit_node.limit
    return ({k: v[lo:hi] for k, v in cols.items()},
            {k: (v[lo:hi] if v is not None else None)
             for k, v in valids.items()})


def _result(executor, out_cols, cols, valids, raw, stats):
    """A spill result from merged storage-form columns: decoded (unless
    the caller wants the storage form), with ``raw`` kept as the
    executor's results keep it."""
    from greengage_tpu_torch.exec.executor import Result, decode

    visible = [c for c in out_cols if not c.hidden]
    shown = {c.id: (cols[c.id] if raw else
                    decode(c, cols[c.id], executor._dictionary))
             for c in out_cols}
    out_valids = {k: (None if v is None or v.all() else v)
                  for k, v in valids.items()}
    return Result(columns=[c.name for c in visible], cols=shown,
                  valids=out_valids, _order=[c.id for c in visible],
                  raw=dict(cols), stats=dict(stats or {}))


def spill_sort_run(executor, plan: Motion, consts, raw: bool,
                   instrument: bool = False):
    """External-merge sort spill (the tuplesort role): an ORDER BY whose
    input exceeds the limit runs as partitioned passes of the ORIGINAL
    plan — each pass sorts its chunk on the device — then the host merges
    the sorted runs with one stable lexsort over order-preserving key
    encodings, and applies OFFSET/LIMIT once."""
    if not isinstance(plan, Motion) or plan.kind is not MotionKind.GATHER:
        raise NotSpillable("sort spill needs a gathered result")
    node = plan.child
    limit_node = None
    if isinstance(node, Limit):
        limit_node = node
        node = node.child
    if not isinstance(node, Sort):
        raise NotSpillable("no sort at the gather point")
    sort = node
    out_cols = plan.child.out_cols()
    keyspec = _host_sort_spec(sort, out_cols)
    candidates = [t for t in spill_candidate_tables(sort.child)
                  if not t.startswith("@") and count_scans(plan, t) == 1]
    if not candidates:
        raise NotSpillable("no partitionable table below the sort")
    # passes must NOT carry the Limit: its host re-limit would drop each
    # CHUNK's first `offset` rows; offset/limit apply once after the merge
    if limit_node is not None:
        pass_plan = copy.copy(plan)
        pass_plan.child = sort
    else:
        pass_plan = plan
    store = executor.store

    from greengage_tpu_torch.exec.executor import effective_limit_bytes

    limit_bytes = effective_limit_bytes(executor.settings, executor.layout)
    candidates.sort(key=lambda t: -max(store.segment_rowcounts(t), default=0))
    cand = candidates[0]
    max_rows = max(store.segment_rowcounts(cand), default=0)
    if max_rows == 0:
        raise NotSpillable("empty partition candidate")
    chunk = max_rows
    while True:
        chunk = max(chunk // 2, CHUNK_FLOOR)
        comp = executor.compile(pass_plan, consts,
                                scan_cap_override={cand: chunk})
        if comp.est_bytes <= limit_bytes * 0.7 or chunk == CHUNK_FLOOR:
            break
    if comp.est_bytes > limit_bytes:
        raise NotSpillable("per-pass working set still exceeds the limit")
    npasses = -(-max_rows // chunk)
    if npasses > MAX_PASSES:
        raise NotSpillable(
            f"sort spill would need {npasses} passes (> {MAX_PASSES})")
    wf = _run_passes(executor, pass_plan, consts, out_cols,
                     [(cand, chunk, npasses)], "sorted-runs", instrument)
    try:
        cols, valids = wf.assemble()
        base_stats = wf.base_stats
        pass_stats = wf.stats
    finally:
        wf.close()
    cols, valids = _host_lexsort(cols, valids, keyspec)
    if limit_node is not None:
        cols, valids = _limit(cols, valids, limit_node)
    res = _result(executor, out_cols, cols, valids, raw, base_stats)
    res.stats["spill_kind"] = "sort"
    if instrument:
        # per-node rows sum across the sorted-run passes, whose plan IS
        # the original plan's nodes (the Limit, dropped from the passes,
        # stays unannotated); pass 0's counts came in with base_stats
        res.stats.pop("node_rows", None)
        _merge_node_rows(res, pass_stats, {})
    return res, npasses


def _window_spill_point(plan: Motion):
    """-> (window, sort_node, limit_node) when the below-gather spine is
    [Limit?] [Sort?] [Project|Filter]* Window(partitioned); None
    otherwise. Sort/Limit lift to the host merge; Project/Filter are
    row-wise and run inside every bucket."""
    node = plan.child
    sort_node = limit_node = None
    while isinstance(node, _WRAPPERS):
        if isinstance(node, Limit):
            if limit_node is not None or sort_node is not None:
                return None    # a Limit BELOW a Sort truncates pre-order
            limit_node = node
        elif isinstance(node, Sort):
            if sort_node is not None:
                return None
            sort_node = node
        node = node.child
    if not isinstance(node, Window) or getattr(node, "global_mode", False) \
            or not node.partition_keys:
        return None
    return node, sort_node, limit_node


def spill_window_run(executor, plan: Motion, consts, raw: bool,
                     instrument: bool = False):
    """Window-partition spill: window functions depend only on rows of
    their own partition, and a hash of the PARTITION BY keys puts every
    row of a partition in one bucket, so the window per disjoint bucket
    unions exactly.

      1. capture — chunked passes over the biggest base table(s) gather
         the window's INPUT rows (the subtree below its Redistribute);
      2. window passes — captured rows bucket by hash(PARTITION BY) % K;
         each bucket restages as an aux table, redistributes by the
         partition keys and runs the window and its row-wise wrappers;
      3. finalize — a Sort above the window merges on the host, then
         LIMIT/OFFSET trims once."""
    settings = executor.settings
    if not bool(getattr(settings, "window_spill_enabled", True)):
        raise NotSpillable("window spill disabled (window_spill_enabled)")
    if not isinstance(plan, Motion) or plan.kind is not MotionKind.GATHER:
        raise NotSpillable("window spill needs a gathered result")
    point = _window_spill_point(plan)
    if point is None:
        raise NotSpillable("no partitioned window at the spill point")
    window, sort_node, limit_node = point
    if not all(isinstance(e, E.ColRef) for e in window.partition_keys):
        raise NotSpillable("window partition keys are not plain columns")
    out_cols = plan.child.out_cols()
    keyspec = (_host_sort_spec(sort_node, out_cols)
               if sort_node is not None else None)
    child = window.child
    subtree = (child.child if isinstance(child, Motion)
               and child.kind is MotionKind.REDISTRIBUTE else child)
    sub_cols = []
    for c in subtree.out_cols():
        if c.raw_ref is not None or c.raw_chain is not None:
            raise NotSpillable("window input carries raw-encoded text")
        # name == id: host staging maps aux columns by storage NAME
        sub_cols.append(ColInfo(c.id, c.type, c.id, c.dict_ref))
    sub_ids = {c.id for c in sub_cols}
    key_ids = [e.name for e in window.partition_keys]
    if not set(key_ids) <= sub_ids:
        raise NotSpillable("window partition keys are not captured "
                           "input columns")

    from greengage_tpu_torch.exec.executor import effective_limit_bytes

    limit_bytes = effective_limit_bytes(settings, executor.layout)

    # ---- phase 1: chunked capture of the window's input rows ---------
    capture = PartialState(subtree, sub_cols)
    capture.locus = subtree.locus
    capture.est_rows = subtree.est_rows
    pass_plan = Motion(MotionKind.GATHER, capture)
    pass_plan.locus = Locus.entry()
    candidates = [t for t in spill_candidate_tables(subtree)
                  if not t.startswith("@") and count_scans(plan, t) == 1]
    if not candidates:
        raise NotSpillable("no partitionable table below the window")
    _chosen, per_table, nchunks = _size_chunk_passes(
        executor, consts, pass_plan, candidates, limit_bytes)
    wf = _run_passes(executor, pass_plan, consts, sub_cols, per_table,
                     "window-input", instrument)
    try:
        aux_cols, aux_valids = wf.assemble()
        pass_stats = wf.stats
    finally:
        wf.close()

    # ---- phase 2: window over PARTITION BY hash buckets --------------
    aux_name = "@spill:window"
    host_scan = Scan(aux_name, list(sub_cols))
    host_scan.locus = Locus.strewn(executor.nseg)
    host_scan.est_rows = float(len(next(iter(aux_cols.values()), [])))
    key_cols = {c.id: c for c in sub_cols}
    m = Motion(MotionKind.REDISTRIBUTE, host_scan,
               hash_exprs=[E.ColRef(k, key_cols[k].type) for k in key_ids])
    m.locus = Locus.hashed(tuple(key_ids), executor.nseg)
    m.est_rows = host_scan.est_rows

    node_map: dict = {}    # id(clone) -> id(original), for node_rows

    def rebuild(nd):
        if nd is window:
            w = copy.copy(window)
            node_map[id(w)] = id(window)
            w.child = m
            w.locus = m.locus
            return w
        if nd is sort_node or nd is limit_node:
            return rebuild(nd.child)
        clone = copy.copy(nd)
        node_map[id(clone)] = id(nd)
        clone.child = rebuild(nd.child)
        return clone

    bucket_plan = Motion(MotionKind.GATHER, rebuild(plan.child))
    bucket_plan.locus = Locus.entry()
    if bool(executor.settings.plan_validate):
        # the bucket plan is a real plan: check its spill shape (a window
        # hashed on its partition keys, the Motion boundary) as any
        # statement's before paying K launches, as the JAX spill does
        validate_plan(bucket_plan, executor.catalog)

    h = _bucket_hash(aux_cols, aux_valids, key_ids)
    K = 1
    while True:
        bcomp = executor.compile(
            bucket_plan, consts, aux_tables={aux_name: _subset(
                aux_cols, aux_valids, (h % np.uint32(max(K, 1))) == 0)})
        if bcomp.est_bytes <= max(limit_bytes, 1) * 0.9 or K >= 64:
            break
        K *= 2
    if bcomp.est_bytes > limit_bytes:
        raise NotSpillable(
            "per-bucket window working set still exceeds the limit at 64 "
            "partition buckets")
    bucket = h % np.uint32(K)

    # bucket k+1's host subset build overlaps bucket k's device program;
    # bucket 0 always runs (the result's schema)
    from greengage_tpu_torch.exec import motionpipe as _motionpipe

    run_bkts = [b for b in range(K) if b == 0 or (bucket == b).any()]

    def _bstage(bkt, _i):
        return _subset(aux_cols, aux_valids, bucket == bkt)

    def _bcompute(staged, _bkt, _i):
        return executor.run_single(bucket_plan, consts, raw=True,
                                   aux_tables={aux_name: staged},
                                   no_direct=True, instrument=instrument)

    bucket_results = _motionpipe.run_pipeline(run_bkts, _bstage, _bcompute,
                                               label="window")
    cols, valids = _collect_passes(out_cols, bucket_results)
    _charge_spill(cols, valids, "window-output")

    # ---- phase 3: host ordering + limit ------------------------------
    if keyspec is not None:
        cols, valids = _host_lexsort(cols, valids, keyspec)
    if limit_node is not None:
        cols, valids = _limit(cols, valids, limit_node)
    res = _result(executor, out_cols, cols, valids, raw,
                  bucket_results[0].stats)
    res.stats["spill_kind"] = "window"
    res.stats["spill_window_buckets"] = K
    if instrument:
        # capture passes share the ORIGINAL subtree's nodes; bucket
        # programs run clones mapped through node_map. Bucket 0's counts
        # came in with its stats: drop them before summing
        res.stats.pop("node_rows", None)
        agg: dict = {}
        for st in pass_stats:
            for nid, nr in (((st or {}).get("node_rows")) or {}).items():
                agg[nid] = agg.get(nid, 0) + nr
        for r in bucket_results:
            for nid, nr in (((r.stats or {}).get("node_rows"))
                            or {}).items():
                nid = node_map.get(nid, nid)
                agg[nid] = agg.get(nid, 0) + nr
        res.stats["node_rows"] = agg
    counters.inc("window_spill_runs")
    counters.inc("window_spill_passes", nchunks + K)
    return res, nchunks + K


def _replace_child(plan: Plan, target: Plan, repl: Plan,
                   node_map: dict | None = None) -> Plan:
    """Shallow-rebuild the path from ``plan`` to ``target`` with the target
    swapped (the original tree stays untouched). ``node_map`` collects
    id(clone) -> id(original) for the cloned path nodes, so instrumented
    row counts of the merged plan land on the original tree's nodes."""
    if plan is target:
        return repl
    clone = copy.copy(plan)
    if node_map is not None:
        node_map[id(clone)] = id(plan)
    for attr in ("child", "left", "right"):
        c = getattr(plan, attr, None)
        if c is None:
            continue
        if c is target or _contains(c, target):
            setattr(clone, attr, _replace_child(c, target, repl, node_map))
    return clone


def _contains(plan: Plan, target: Plan) -> bool:
    if plan is target:
        return True
    return any(_contains(c, target) for c in plan.children)
