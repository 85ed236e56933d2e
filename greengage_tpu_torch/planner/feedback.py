"""Feedback-driven cost calibration — the port's copy of
greengage_tpu/planner/feedback.py, the closed measurement loop.

The ground truth the planner can read back: per-node actual rows
(instrumented runs and the always-on Filter counters), the measured
program bytes (exec/executor.py ``_measure``) and the capacity hints the
device reports after every successful run. This module is the store
that feeds them back: on an accelerator a 3x-wrong cardinality is a
wrong motion plan, a wrong capacity and a wrong admission verdict at
once.

Three feedback surfaces, one store:

  * **row-scale corrections** keyed by a *structural node digest*
    (value-stable: same SQL -> same bind -> same digest): after each
    execution the session reconciles per-node actual rows against the
    planner's ``est_rows`` and keeps a bounded EWMA of the log-ratio per
    digest. A correction is only *applied* (promoted) when it drifts
    past the hysteresis band (``cost_feedback_hysteresis``), so estimate
    noise never re-plans a stable shape. Applied scales multiply
    ``est_rows`` during planning — which also supersedes a generic
    plan's ``Param`` estimate seed: the first bind's literals seed the
    selectivity, observed traffic corrects it.
  * **measured program bytes** keyed by statement shape.
  * **capacity hints** ({stable node ordinal -> pow2 capacity}).

Every promotion bumps the store generation; ``version_for`` joins the
bound-plan cache key (exec/session._cached_plan), so a re-calibrated
shape re-plans instead of serving the stale plan. The store lives in the
Database's scratch directory (``feedback.json``); keeping it across a
reopen waits for durable storage (ROADMAP Queue 1 item 1a), and the
multihost pair that ships the coordinator's scales to workers waits for
the multi-GPU lockstep (item 8).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import tempfile
import threading

from greengage_tpu_torch.runtime.faultinject import faults
from greengage_tpu_torch.runtime.logger import counters

# bounds on one digest's applied row-scale correction: a clamped scale
# still flips every motion/admission decision a 64x error could, while
# an unbounded one would let a single garbage observation poison a shape
SCALE_MIN, SCALE_MAX = 1.0 / 64.0, 64.0
# EWMA smoothing for the log-ratio; the FIRST observation initializes
# the average fully, so a cold 3x-wrong shape corrects after one run
EWMA_ALPHA = 0.5
MAX_DIGESTS = 1024      # LRU-ish prune bound on tracked node digests
MAX_SHAPES = 512        # and on tracked statement shapes


# ---- structural node digests -----------------------------------------
def node_digest(node) -> str:
    """Value-stable structural digest of an estimating plan node.
    Pass-through nodes (Motion/Project/Sort/Limit/Window) are
    transparent, so the same filter learns one correction whether or
    not a projection sits between it and its scan. Binder/paramize are
    deterministic, so the digest is identical across processes and
    restarts for the same statement shape — param placeholders carry no
    values (their ``est_value`` seed is repr-excluded), which is exactly
    what lets observed traffic supersede the seed."""
    d = getattr(node, "_fb_digest", None)
    if d is None:
        d = hashlib.sha1(_sig(node).encode()).hexdigest()[:16]
        try:
            node._fb_digest = d
        except Exception:
            pass
    return d


# value-placeholder normalization: the plan cache hoists literals into
# Param slots, so the SAME statement carries Literal(value=...) when
# planned directly (EXPLAIN, unparameterizable shapes) and Param(slot=N)
# when served generically. Both forms — and successive bind values — must
# learn ONE correction per shape, so every comparable value collapses to
# '?' in the digest signature (the ParamRef.est_value supersession rule:
# the first bind seeds the estimate, observed traffic corrects it)
_VALUE_RE = re.compile(
    r"(?:Literal\(value=.*?, type=SqlType\([^)]*\)\)"
    r"|Param\(slot=\d+, type=SqlType\([^)]*\)\))")


def _norm(r: str) -> str:
    return _VALUE_RE.sub("?", r)


def _sig(node) -> str:
    kind = type(node).__name__
    if kind == "Scan":
        return f"scan({node.table})"
    if kind == "Filter":
        return f"filter({_norm(repr(node.predicate))})<{_sig(node.child)}"
    if kind == "Join":
        keys = ",".join(f"{lk!r}={rk!r}" for lk, rk in
                        zip(node.left_keys, node.right_keys))
        return (f"join({node.kind};{keys};{_norm(repr(node.residual))})"
                f"<{_sig(node.left)}|{_sig(node.right)}")
    if kind == "Aggregate":
        keys = ",".join(repr(e) for _, e in node.group_keys)
        aggs = ",".join(_norm(repr(a)) for _, a in node.aggs)
        return f"agg({keys};{aggs})<{_sig(node.child)}"
    if kind == "Union":
        return "union<" + "|".join(_sig(c) for c in node.inputs)
    child = getattr(node, "child", None)
    if child is not None:
        return _sig(child)         # pass-through wrapper
    return kind.lower()


def shape_key(key_sig: str) -> str:
    return hashlib.sha1(key_sig.encode()).hexdigest()[:16]


class FeedbackStore:
    """Per-cluster feedback state. Thread-safe (server threads reconcile
    and plan concurrently); all mutation under one lock, reads of the
    applied-scale map take the same lock and copy out."""

    def __init__(self, path: str | None = None, settings=None):
        self.path = path
        self.settings = settings
        self._mu = threading.Lock()
        self.gen = 0              # bumped per promotion
        # digest -> {"scale": applied, "lr": ewma log-ratio, "n": obs,
        #            "est": last est, "actual": last actual}
        self.digests: dict[str, dict] = {}
        # shape key -> {"ver": gen at last promotion touching it,
        #   "digests": [...], "sql": label, "runs": n,
        #   "rows_est": float, "rows_actual": float,
        #   "est_bytes": int, "measured_bytes": int, "caps": {nid: cap}}
        self.shapes: dict[str, dict] = {}
        self._load()

    # ---- persistence (atomic, coordinator-only) ----------------------
    def _load(self) -> None:
        if not self.path or not os.path.exists(self.path):
            return
        try:
            with open(self.path) as f:
                raw = json.load(f)
            self.gen = int(raw.get("gen", 0))
            self.digests = {str(k): dict(v)
                            for k, v in (raw.get("digests") or {}).items()}
            self.shapes = {str(k): dict(v)
                           for k, v in (raw.get("shapes") or {}).items()}
            if self.gen:
                # a restarted process must expose the loaded calibration
                # generation, not 0, to scrapers
                counters.set("calibration_version", self.gen)
        except (OSError, ValueError, TypeError):
            # an unreadable store must never block startup: feedback is
            # an optimization layer, cold estimates still work
            self.gen, self.digests, self.shapes = 0, {}, {}

    def save(self) -> None:
        if not self.path:
            return
        with self._mu:
            payload = {"gen": self.gen, "digests": self.digests,
                       "shapes": self.shapes}
            try:
                d = os.path.dirname(self.path) or "."
                fd, tmp = tempfile.mkstemp(dir=d, prefix=".feedback-")
                with os.fdopen(fd, "w") as f:
                    json.dump(payload, f)
                os.replace(tmp, self.path)
            except OSError:
                pass              # best-effort; next promotion retries

    # ---- planner read path -------------------------------------------
    def scale_for(self, digest: str) -> float:
        with self._mu:
            rec = self.digests.get(digest)
            return float(rec["scale"]) if rec else 1.0

    def corrected_rows(self, node) -> float:
        s = self.scale_for(node_digest(node))
        if s == 1.0:
            return node.est_rows
        return max(float(node.est_rows) * s, 1e-6)

    def version_for(self, key_sig: str) -> int:
        """The calibration version joining the bound-plan cache key: a
        promotion touching any digest this shape uses bumps it, so the
        next execution re-plans with the corrected estimates."""
        with self._mu:
            sh = self.shapes.get(shape_key(key_sig))
            return int(sh["ver"]) if sh else 0

    def note_shape(self, key_sig: str, planned) -> None:
        """Register which digests a freshly planned shape depends on
        (the reverse index promotions walk to bump shape versions)."""
        ds: list[str] = []
        _walk_estimating(planned, lambda n: ds.append(node_digest(n)))
        with self._mu:
            sh = self.shapes.setdefault(
                shape_key(key_sig),
                {"ver": 0, "runs": 0, "sql": key_sig[:160]})
            sh["digests"] = ds
            self._prune_locked()

    # ---- execution-side write path -----------------------------------
    def reconcile(self, key_sig: str, planned, rows_out: int,
                  node_rows: dict | None,
                  measured_bytes: int | None = None,
                  est_bytes: int | None = None) -> int:
        """Reconcile one execution's actuals against the planned
        estimates; promote drifted corrections (hysteresis-gated) and
        bump the generation + every dependent shape's version. Returns
        the number of promotions. Deterministic: identical observations
        produce identical store states on every process."""
        obs: list[tuple[str, float, float]] = []    # (digest, est, actual)
        seen: set[str] = set()
        if node_rows:
            # per-node actuals: instrumented runs cover every node, the
            # always-on filter counters cover Filter nodes on every run
            def take(n):
                rows = node_rows.get(id(n))
                if rows is not None:
                    d = node_digest(n)
                    seen.add(d)
                    obs.append((d, float(n.est_rows), float(rows)))
            _walk_estimating(planned, take)
        # root attribution: rows_out is exact on every run; walk through
        # row-preserving nodes and credit the topmost estimating node
        # not already directly observed this run
        top = _root_estimating(planned)
        if top is not None and rows_out >= 0:
            d = node_digest(top)
            if d not in seen:
                obs.append((d, float(top.est_rows), float(rows_out)))
        hyst = max(float(getattr(self.settings, "cost_feedback_hysteresis",
                                 1.5) or 1.5), 1.0 + 1e-9)
        promoted = 0
        with self._mu:
            sk = shape_key(key_sig)
            sh = self.shapes.setdefault(
                sk, {"ver": 0, "runs": 0, "sql": key_sig[:160],
                     "digests": []})
            sh["runs"] = int(sh.get("runs", 0)) + 1
            sh["rows_est"] = float(getattr(planned, "est_rows", 0.0))
            sh["rows_actual"] = float(rows_out)
            if est_bytes is not None:
                sh["est_bytes"] = int(est_bytes)
            if measured_bytes is not None and measured_bytes > 0:
                sh["measured_bytes"] = int(measured_bytes)
            touched: set[str] = set()
            for d, est, actual in obs:
                rec = self.digests.setdefault(
                    d, {"scale": 1.0, "lr": 0.0, "n": 0})
                # the planned est already carries the APPLIED scale (a
                # promotion re-plans the shape), so the observation's
                # residual ratio composes onto it: the EWMA tracks the
                # implied TOTAL scale in log space. Steady state: actual
                # ~= est -> the ewma converges to log(scale) exactly and
                # the hysteresis gate never re-fires on a settled shape.
                ratio = max(actual, 1e-6) / max(est, 1e-6)
                lr = math.log(max(rec["scale"], SCALE_MIN)) \
                    + math.log(ratio)
                rec["lr"] = (lr if rec["n"] == 0
                             else (1 - EWMA_ALPHA) * rec["lr"]
                             + EWMA_ALPHA * lr)
                rec["n"] = int(rec["n"]) + 1
                rec["est"], rec["actual"] = est, actual
                cand = min(max(math.exp(rec["lr"]), SCALE_MIN), SCALE_MAX)
                # hysteresis: promote only when the candidate drifted
                # past the band around the APPLIED scale — noise inside
                # the band never invalidates cached plans
                if abs(math.log(cand / rec["scale"])) > math.log(hyst):
                    if faults.check("feedback_apply"):
                        continue      # injected skip: calibration stays
                        # pending (checkperf apply commits it)
                    rec["scale"] = cand
                    touched.add(d)
                    promoted += 1
            if promoted:
                self.gen += 1
                counters.inc("feedback_applied_total", promoted)
                counters.set("calibration_version", self.gen)
                for shp in self.shapes.values():
                    if touched.intersection(shp.get("digests") or ()):
                        shp["ver"] = self.gen
            self._prune_locked()
        if promoted:
            self.save()
        return promoted

    # ---- measured bytes / capacity hints ------------------------------
    def note_measured(self, exec_key: str, measured_total: int,
                      est_dev: int, admits: bool = True) -> None:
        """A program's measured bytes for its shape; ``admits`` False
        when the measurement had no peak reading (a CPU device), which
        calibrates the gauge but admits nothing."""
        with self._mu:
            sh = self.shapes.setdefault(
                shape_key(exec_key),
                {"ver": 0, "runs": 0, "sql": exec_key[:160],
                 "digests": []})
            sh["measured_bytes"] = int(measured_total)
            sh["est_dev_bytes"] = int(est_dev)
            sh["measured_admits"] = bool(admits)
            self._prune_locked()

    def measured_bytes(self, exec_key: str,
                       admitting: bool = False) -> int | None:
        """The shape's measured bytes; with ``admitting``, only a
        measurement that may admit a program."""
        with self._mu:
            sh = self.shapes.get(shape_key(exec_key))
            mb = sh.get("measured_bytes") if sh else None
            if admitting and not (sh or {}).get("measured_admits"):
                return None
            return int(mb) if mb else None

    def measured_est_bytes(self, exec_key: str) -> int | None:
        """The estimate (all segments of the device) of the program whose
        measurement ``measured_bytes`` holds for the shape."""
        with self._mu:
            sh = self.shapes.get(shape_key(exec_key))
            est = sh.get("est_dev_bytes") if sh else None
            return int(est) if est else None

    def note_caps(self, exec_key: str, caps: dict) -> None:
        if not caps:
            return
        with self._mu:
            sh = self.shapes.setdefault(
                shape_key(exec_key),
                {"ver": 0, "runs": 0, "sql": exec_key[:160],
                 "digests": []})
            sh["caps"] = {str(k): int(v) for k, v in caps.items()}
            self._prune_locked()

    def caps(self, exec_key: str) -> dict:
        with self._mu:
            sh = self.shapes.get(shape_key(exec_key))
            return ({int(k): int(v) for k, v in sh["caps"].items()}
                    if sh and sh.get("caps") else {})

    # ---- checkperf surface -------------------------------------------
    def report(self) -> dict:
        """Per-shape est-vs-actual error (rows + bytes) + the digest
        correction table — the checkperf report (server op, mgmt/cli.py)."""
        with self._mu:
            shapes = []
            for sk, sh in self.shapes.items():
                row = {"shape": sk, "sql": sh.get("sql", ""),
                       "runs": int(sh.get("runs", 0)),
                       "ver": int(sh.get("ver", 0))}
                re_, ra = sh.get("rows_est"), sh.get("rows_actual")
                if re_ is not None and ra is not None:
                    row["rows_est"] = re_
                    row["rows_actual"] = ra
                    row["rows_err_pct"] = round(
                        100.0 * (re_ - ra) / max(ra, 1e-9), 1)
                eb, mb = sh.get("est_dev_bytes") or sh.get("est_bytes"), \
                    sh.get("measured_bytes")
                if eb and mb:
                    row["est_bytes"] = int(eb)
                    row["measured_bytes"] = int(mb)
                    row["bytes_err_pct"] = round(
                        100.0 * (eb - mb) / max(mb, 1), 1)
                shapes.append(row)
            pending = sum(
                1 for r in self.digests.values()
                if abs(math.log(
                    min(max(math.exp(r.get("lr", 0.0)), SCALE_MIN),
                        SCALE_MAX) / r.get("scale", 1.0))) > 1e-9)
            return {"gen": self.gen, "digests": len(self.digests),
                    "pending": pending, "shapes": shapes,
                    "scales": {d: round(r["scale"], 4)
                               for d, r in self.digests.items()
                               if r.get("scale", 1.0) != 1.0}}

    def apply_pending(self) -> int:
        """checkperf apply: commit every candidate correction
        regardless of the hysteresis band."""
        applied = 0
        with self._mu:
            touched = set()
            for d, rec in self.digests.items():
                cand = min(max(math.exp(rec.get("lr", 0.0)), SCALE_MIN),
                           SCALE_MAX)
                if abs(math.log(cand / rec.get("scale", 1.0))) > 1e-9:
                    rec["scale"] = cand
                    touched.add(d)
                    applied += 1
            if applied:
                self.gen += 1
                counters.inc("feedback_applied_total", applied)
                counters.set("calibration_version", self.gen)
                for sh in self.shapes.values():
                    if touched.intersection(sh.get("digests") or ()):
                        sh["ver"] = self.gen
        if applied:
            self.save()
        return applied

    def reset(self) -> None:
        """checkperf reset: clear all learned corrections; the
        generation still bumps so cached corrected plans re-plan."""
        with self._mu:
            self.digests.clear()
            self.shapes.clear()
            self.gen += 1
            counters.set("calibration_version", self.gen)
        self.save()

    # ---- internal -----------------------------------------------------
    def _prune_locked(self) -> None:
        # bounded state: drop the least-run shapes / lowest-signal
        # digests (deterministic order so multihost stores stay equal)
        while len(self.shapes) > MAX_SHAPES:
            victim = min(self.shapes.items(),
                         key=lambda kv: (kv[1].get("runs", 0), kv[0]))[0]
            del self.shapes[victim]
        while len(self.digests) > MAX_DIGESTS:
            victim = min(self.digests.items(),
                         key=lambda kv: (kv[1].get("n", 0), kv[0]))[0]
            del self.digests[victim]


def _walk_estimating(node, fn) -> None:
    kind = type(node).__name__
    if kind in ("Filter", "Join", "Aggregate"):
        fn(node)
    for c in getattr(node, "children", ()) or ():
        _walk_estimating(c, fn)


def _root_estimating(node):
    """Topmost Filter/Join/Aggregate reachable from the root through
    row-preserving nodes — the node the exact ``rows_out`` observation
    can be attributed to. Limit truncates and Broadcast replicates, so
    both stop the walk."""
    while node is not None:
        kind = type(node).__name__
        if kind in ("Filter", "Join", "Aggregate"):
            return node
        if kind == "Motion":
            if getattr(getattr(node, "kind", None), "name", "") \
                    == "BROADCAST":
                return None
            node = node.child
            continue
        if kind in ("Project", "Sort", "Window"):
            node = node.child
            continue
        return None
    return None
