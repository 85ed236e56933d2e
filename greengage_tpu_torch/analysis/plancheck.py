"""Plan-tree invariant validation — the checkPlan-before-dispatch analog.

Reference parity: the reference walks every sliced plan and asserts its
Motion/slice/distribution structure before dispatch (cdbmutate.c's
checkPlan machinery); Theseus (PAPERS.md) credits validating
data-movement plans *before* execution for much of its reliability at
scale. ``validate_plan`` is that walk for our trees: it runs on every
planned statement when the ``plan_validate`` GUC is on (the default —
the walk is O(nodes) of pure-host attribute checks, noise against
planning cost) and over the whole TPC-H/TPC-DS corpus in
``tests/test_analysis.py``.

Invariants (each names its planner contract):

I1  every node carries a locus; partitioned/replicated loci carry a
    positive segment width; HASHED loci carry keys resolvable in the
    node's own or its children's output columns.
I2  Motions sit exactly at distribution boundaries: GATHER lands on
    ENTRY, BROADCAST turns a partitioned/SingleQE child replicated,
    REDISTRIBUTE carries hash exprs and lands HASHED (or SingleQE via
    the constant-key funnel the planner uses for buried LIMITs and
    exotic windows, or STREWN for computed keys); a range-spec
    REDISTRIBUTE (sampled-splitter window repartition) lands STREWN
    with exactly the leading order key.
I3  ENTRY exists only at the root, which is the single Gather Motion —
    an interior Gather is a hidden one-chip funnel in a plan that
    claims parallel execution; a global-mode Window above a SingleQE
    funnel is the same lie one node up.
I4  a Join whose two children are both partitioned must have them
    co-located on its join keys (cdbpath_motion_for_join's contract):
    HASHED sides correspond pairwise through the join-key equivalence,
    computed-key sides are the planner's own paired Redistributes.
I5  Aggregate/Window locality claims hold: a single-phase grouped agg
    over a HASHED child is hashed on its group keys; a grouped final
    agg sits above the state Redistribute; a scalar final sits above
    the partial-state Broadcast; a non-global Window owns whole
    partitions per segment; an ordered-global Window carries a
    packed/full64 gkey_spec inside the 64-bit budget; a range-mode
    Window sits directly above its range Redistribute (whole key
    ranges per segment).
I6  Scan annotations are well-formed: prune predicates reference only
    existing storage columns with sane ops and Param/host values,
    direct dispatch targets a real segment, index hits name real
    indexes.

Violations raise ``PlanInvariantError`` naming the node path from the
root, e.g. ``Motion(Gather)/Sort/Aggregate(final)``.

The port's copy of greengage_tpu/analysis/plancheck.py (invariants I1-I6,
imports rewritten to the port's modules; host only). The JAX module's
I7, ``validate_capacities``, walks the JAX Compiler's scan-capacity
internals and runs only under its ``gg check --plans``, not at either
call site of ``validate_plan``: it is not ported.
"""

from __future__ import annotations

import numpy as np

from greengage_tpu_torch import expr as E
from greengage_tpu_torch.planner.locus import LocusKind
from greengage_tpu_torch.planner.logical import (Aggregate, Join, Motion,
                                                 MotionKind, Plan, Scan,
                                                 Window)

_PRUNE_OPS = ("=", "<", "<=", ">", ">=")


class PlanInvariantError(AssertionError):
    """A planned tree violates a distribution/shape invariant. ``path``
    names the offending node from the root; ``invariant`` is the I-code
    above (stable for tests and triage)."""

    def __init__(self, invariant: str, path: str, message: str):
        super().__init__(f"{invariant} at {path}: {message}")
        self.invariant = invariant
        self.path = path


def _node_label(node: Plan) -> str:
    name = type(node).__name__
    if isinstance(node, Motion):
        return f"{name}({node.kind.value})"
    if isinstance(node, Aggregate):
        return f"{name}({node.phase})"
    if isinstance(node, Scan):
        return f"{name}({node.table})"
    if isinstance(node, Join):
        return f"{name}({node.kind})"
    return name


def _out_ids(node: Plan) -> set[str]:
    try:
        return {c.id for c in node.out_cols()}
    except NotImplementedError:
        return set()


def _is_const_expr(e) -> bool:
    return isinstance(e, E.Literal) or (
        isinstance(e, E.Cast) and _is_const_expr(e.arg))


def _is_param_value(v) -> bool:
    if isinstance(v, E.Param):
        return v.slot >= 0
    if isinstance(v, E.Cast):
        return _is_param_value(v.arg)
    return False


def _redistributed_by(child: Plan, keys: list) -> bool:
    """True when ``child`` is the planner's own Redistribute by exactly
    these join keys (the computed-key co-location path: both sides land
    STREWN but physically aligned because the SAME expressions hash)."""
    if not (isinstance(child, Motion)
            and child.kind is MotionKind.REDISTRIBUTE):
        return False
    he = child.hash_exprs
    if len(he) != len(keys):
        return False
    return all(a is b or repr(a) == repr(b) for a, b in zip(he, keys))


def _join_colocated(node: Join) -> bool:
    ll, rl = node.left.locus, node.right.locus
    pairs = [(lk.name if isinstance(lk, E.ColRef) else None,
              rk.name if isinstance(rk, E.ColRef) else None)
             for lk, rk in zip(node.left_keys, node.right_keys)]
    l2r = {a: b for a, b in pairs if a and b}
    if ll.kind is LocusKind.HASHED and rl.kind is LocusKind.HASHED:
        if ll.numsegments != rl.numsegments or len(ll.keys) != len(rl.keys):
            return False
        return all(l2r.get(a) == b for a, b in zip(ll.keys, rl.keys))
    # computed-key co-location: a STREWN side must be the planner's own
    # paired Redistribute; a HASHED side must cover its join keys
    ok_left = (_redistributed_by(node.left, list(node.left_keys))
               if ll.kind is LocusKind.STREWN
               else ll.kind is LocusKind.HASHED
               and all(k in {a for a, _ in pairs if a} for k in ll.keys))
    ok_right = (_redistributed_by(node.right, list(node.right_keys))
                if rl.kind is LocusKind.STREWN
                else rl.kind is LocusKind.HASHED
                and all(k in {b for _, b in pairs if b} for k in rl.keys))
    return ok_left and ok_right


def validate_plan(plan: Plan, catalog=None) -> None:
    """Walk a PLANNED tree and raise ``PlanInvariantError`` on the first
    violated invariant. ``catalog`` (optional) enables the schema-aware
    half of I6 (prune columns / indexes actually exist)."""
    root = plan
    gathers = [n for n in _walk(plan) if isinstance(n, Motion)
               and n.kind is MotionKind.GATHER]
    if len(gathers) > 1 or (gathers and gathers[0] is not root):
        bad = next(g for g in gathers if g is not root)
        raise PlanInvariantError(
            "I3", _path_to(root, bad),
            "interior Gather Motion: a funnel inside a plan that claims "
            "parallel execution (only the root gathers)")
    _validate(root, root, [], catalog)


def _walk(plan: Plan):
    stack = [plan]
    while stack:
        p = stack.pop()
        yield p
        stack.extend(p.children)


def _path_to(root: Plan, target: Plan) -> str:
    """Root-to-target label path (for error text)."""
    path: list[str] = []

    def rec(node: Plan, acc: list[str]) -> bool:
        acc.append(_node_label(node))
        if node is target:
            path.extend(acc)
            return True
        for c in node.children:
            if rec(c, acc):
                return True
        acc.pop()
        return False

    rec(root, [])
    return "/".join(path) or _node_label(target)


def _fail(invariant: str, trail: list[str], node: Plan, msg: str):
    path = "/".join(trail + [_node_label(node)])
    raise PlanInvariantError(invariant, path, msg)


def _validate(node: Plan, root: Plan, trail: list[str], catalog) -> None:
    locus = node.locus
    # ---- I1: locus well-formedness ---------------------------------
    if locus is None:
        _fail("I1", trail, node, "node has no locus (planner never "
              "visited it)")
    if locus.kind in (LocusKind.HASHED, LocusKind.STREWN,
                      LocusKind.SEGMENT_GENERAL, LocusKind.SINGLE_QE) \
            and locus.numsegments < 1:
        _fail("I1", trail, node,
              f"{locus.kind.value} locus with numsegments="
              f"{locus.numsegments}")
    if locus.kind is LocusKind.HASHED:
        if not locus.keys:
            _fail("I1", trail, node, "HASHED locus with no keys")
        visible = _out_ids(node)
        for c in node.children:
            visible |= _out_ids(c)
        missing = [k for k in locus.keys if k not in visible]
        if missing and visible:
            _fail("I1", trail, node,
                  f"HASHED locus keys {missing} resolve in neither this "
                  "node's nor its children's output columns")
    if node.est_rows < 0:
        _fail("I1", trail, node, f"negative est_rows {node.est_rows}")
    # ---- I3: ENTRY only at the root --------------------------------
    if locus.kind is LocusKind.ENTRY and node is not root:
        _fail("I3", trail, node,
              "interior ENTRY locus (coordinator-only rows below the "
              "top Gather)")
    # ---- I2: Motion boundary shapes --------------------------------
    if isinstance(node, Motion):
        child_locus = node.child.locus
        if child_locus is None:
            _fail("I1", trail, node, "Motion child has no locus")
        elif node.kind is MotionKind.GATHER:
            if locus.kind is not LocusKind.ENTRY:
                _fail("I2", trail, node,
                      f"Gather lands on {locus.kind.value}, not Entry")
            if child_locus.kind is LocusKind.ENTRY:
                _fail("I2", trail, node, "Gather above ENTRY rows moves "
                      "nothing")
        elif node.kind is MotionKind.BROADCAST:
            if locus.kind is not LocusKind.SEGMENT_GENERAL:
                _fail("I2", trail, node,
                      f"Broadcast lands on {locus.kind.value}, not "
                      "SegmentGeneral")
            if child_locus.kind not in (LocusKind.HASHED, LocusKind.STREWN,
                                        LocusKind.SINGLE_QE):
                _fail("I2", trail, node,
                      f"Broadcast of already-replicated "
                      f"{child_locus.kind.value} rows duplicates them")
        elif node.kind is MotionKind.REDISTRIBUTE:
            if locus.kind not in (LocusKind.HASHED, LocusKind.STREWN,
                                  LocusKind.SINGLE_QE):
                _fail("I2", trail, node,
                      f"Redistribute lands on {locus.kind.value}")
            if not node.hash_exprs:
                _fail("I2", trail, node, "Redistribute with no hash exprs")
            if locus.kind is LocusKind.SINGLE_QE \
                    and not all(_is_const_expr(e) for e in node.hash_exprs):
                _fail("I2", trail, node,
                      "SingleQE funnel must hash on constants")
            if getattr(node, "range_spec", None) is not None:
                # range repartition: rows route by key RANGES, not a
                # hash — claiming HASHED (or a funnel) would let a join
                # co-locate against a distribution that does not exist
                if locus.kind is not LocusKind.STREWN:
                    _fail("I2", trail, node,
                          f"range Redistribute lands {locus.kind.value}, "
                          "not Strewn")
                if len(node.hash_exprs) != 1:
                    _fail("I2", trail, node,
                          "range Redistribute must carry exactly the "
                          "leading order key")
            if locus.kind is LocusKind.HASHED \
                    and len(locus.keys) != len(node.hash_exprs):
                _fail("I2", trail, node,
                      f"{len(locus.keys)} locus keys for "
                      f"{len(node.hash_exprs)} hash exprs")
    # ---- I4: join co-location --------------------------------------
    if isinstance(node, Join):
        ll, rl = node.left.locus, node.right.locus
        if ll is not None and rl is not None \
                and ll.is_partitioned and rl.is_partitioned:
            if node.kind == "cross":
                _fail("I4", trail, node,
                      "cross join with BOTH sides partitioned (build side "
                      "must be replicated)")
            if not _join_colocated(node):
                _fail("I4", trail, node,
                      f"sides {ll.describe()} x {rl.describe()} are not "
                      "co-located on the join keys and neither moved")
    # ---- I5: aggregate / window locality ---------------------------
    if isinstance(node, Aggregate):
        child_locus = node.child.locus
        if child_locus is not None and node.phase == "single" \
                and node.group_keys and child_locus.is_partitioned:
            key_ids = tuple(e.name for _, e in node.group_keys
                            if isinstance(e, E.ColRef))
            if not child_locus.hashed_on(key_ids):
                _fail("I5", trail, node,
                      f"single-phase grouped aggregate over "
                      f"{child_locus.describe()} child not hashed on its "
                      f"group keys {key_ids}")
        if child_locus is not None and node.phase == "final":
            if node.group_keys:
                ids = tuple(c.id for c, _ in node.group_keys)
                if child_locus.is_partitioned \
                        and not child_locus.hashed_on(ids):
                    _fail("I5", trail, node,
                          "final grouped aggregate child is partitioned "
                          f"({child_locus.describe()}) but not hashed on "
                          "the group state keys")
            elif child_locus.kind not in (LocusKind.SEGMENT_GENERAL,
                                          LocusKind.ENTRY,
                                          LocusKind.SINGLE_QE):
                _fail("I5", trail, node,
                      "scalar final aggregate needs replicated partial "
                      f"states, child is {child_locus.describe()}")
    if isinstance(node, Window):
        child_locus = node.child.locus
        gm = getattr(node, "global_mode", False)
        is_global = bool(gm)
        if child_locus is not None and not is_global \
                and child_locus.is_partitioned:
            key_ids = tuple(e.name for e in node.partition_keys
                            if isinstance(e, E.ColRef))
            if not node.partition_keys:
                _fail("I5", trail, node,
                      "non-global whole-table window over partitioned "
                      f"rows ({child_locus.describe()}) — partitions "
                      "span segments")
            elif not child_locus.hashed_on(key_ids):
                _fail("I5", trail, node,
                      f"window partitions split across segments: child "
                      f"{child_locus.describe()} not hashed on "
                      f"PARTITION BY keys {key_ids}")
        if is_global:
            # gather-free global windows: the shape claims rows never
            # funnel, so the claim must be machine-checkable — a global
            # window above a SingleQE funnel is a hidden one-chip plan
            # wearing a distributed label (I3's spirit, node-local half)
            if node.partition_keys:
                _fail("I5", trail, node,
                      "global window carries PARTITION BY keys")
            if child_locus is not None \
                    and child_locus.kind is LocusKind.SINGLE_QE:
                _fail("I3", trail, node,
                      "global-mode window above a SingleQE funnel — the "
                      "gather-free claim is false")
            spec = getattr(node, "gkey_spec", None)
            if gm == "ordered":
                if not node.order_keys:
                    _fail("I5", trail, node,
                          "ordered-global window with no ORDER BY keys")
                if not isinstance(spec, dict) \
                        or spec.get("mode") not in ("packed", "full64"):
                    _fail("I5", trail, node,
                          "ordered-global window without a packed/full64 "
                          f"gkey_spec (got {spec!r})")
                if spec.get("mode") == "packed":
                    total = sum(int(f.get("bits", 0)) + 1
                                for f in spec.get("fields", ()))
                    if not spec.get("fields") or total > 64 or any(
                            int(f.get("bits", 0)) < 1
                            for f in spec["fields"]):
                        _fail("I5", trail, node,
                              f"packed gkey_spec fields exceed the 64-bit "
                              f"budget or carry zero-width fields "
                              f"({total} bits)")
            elif gm == "range":
                if not isinstance(spec, dict) or spec.get("mode") != "range":
                    _fail("I5", trail, node,
                          "range-mode window without a range gkey_spec")
                ch = node.child
                if not (isinstance(ch, Motion)
                        and ch.kind is MotionKind.REDISTRIBUTE
                        and getattr(ch, "range_spec", None) is not None):
                    _fail("I5", trail, node,
                          "range-mode window's child is not a range "
                          "Redistribute — segments would not own whole "
                          "key ranges")
            elif node.order_keys:
                _fail("I5", trail, node,
                      "unordered-global window carries ORDER BY keys")
    # ---- I6: scan annotations --------------------------------------
    if isinstance(node, Scan):
        _validate_scan(node, trail, catalog)
    trail.append(_node_label(node))
    for c in node.children:
        _validate(c, root, trail, catalog)
    trail.pop()


def _validate_scan(node: Scan, trail: list[str], catalog) -> None:
    schema = None
    if catalog is not None:
        try:
            schema = catalog.get(node.table)
        except Exception:
            schema = None   # aux/external relations live outside it
    col_names = ({c.name for c in schema.columns} if schema is not None
                 else {c.name for c in node.cols})
    for pred in node.prune_preds or ():
        if len(pred) != 3:
            _fail("I6", trail, node, f"malformed prune predicate {pred!r}")
        col, op, v = pred
        if op not in _PRUNE_OPS:
            _fail("I6", trail, node, f"prune predicate op {op!r}")
        # raw-TEXT device predicates prune on derived sidecar columns:
        # @rl:<col> (byte length) and @rp:<col>:<word> (prefix words) —
        # the BASE column must exist (binder _device_raw_pred)
        base = col
        if col.startswith("@rl:"):
            base = col[4:]
        elif col.startswith("@rp:"):
            base = col[4:].rsplit(":", 1)[0]
        if base not in col_names:
            _fail("I6", trail, node,
                  f"prune predicate references unknown column {col!r} "
                  f"of {node.table}")
        if isinstance(v, E.Expr):
            if not _is_param_value(v):
                _fail("I6", trail, node,
                      f"prune value for {col} is a non-Param expression "
                      f"{type(v).__name__} (must resolve at staging)")
        elif not isinstance(v, (int, float, np.integer, np.floating)):
            _fail("I6", trail, node,
                  f"prune value for {col} is {type(v).__name__}, not a "
                  "host scalar")
    if node.direct_seg is not None:
        nseg = node.locus.numsegments if node.locus is not None else 0
        if not (0 <= node.direct_seg < max(nseg, 1)):
            _fail("I6", trail, node,
                  f"direct dispatch to segment {node.direct_seg} of "
                  f"{nseg}")
    if node.index_hits and schema is not None:
        known = set(getattr(schema, "indexes", {}) or {})
        bad = [i for i in node.index_hits if i not in known]
        if bad:
            _fail("I6", trail, node, f"index hits {bad} name no index of "
                  f"{node.table}")
