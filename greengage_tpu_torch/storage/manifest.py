"""Manifest-based MVCC commit — the distributed-visibility analog.

The reference achieves cluster-wide atomic visibility with 2PC + the
distributed log (src/backend/cdb/cdbtm.c, access/transam/distributedlog.c).
Our storage is append-only (no in-place update), so a transaction's writes
are invisible staged files until a commit record publishes them. Two commit
paths share one snapshot space:

ROOT path (structural: CREATE/DROP/width changes, and checkpoint folds):
  prepare(tx): durably stage the next root as manifest.<v>.prepared
  commit(v):   atomically replace manifest.json  (commit point)
  abort(v):    delete the staged root

DELTA path (table-state writes: INSERT/DELETE/UPDATE/delmask) — the
per-segment-WAL analog that keeps writers to DIFFERENT tables off one
global CAS:
  prepare_delta(tx, tables): stage one per-table delta file per written
      table under deltas/, claimed with an EXCLUSIVE hard link on the
      table's next sequence number — the CAS is PER TABLE, so concurrent
      appenders to different tables never conflict
  commit_delta(handle): append ONE fsynced line to commits.log (O_APPEND;
      the line is the atomic multi-table commit record, and the log's
      prefix order is the cluster-wide total order of delta commits)
  abort_delta(handle): unlink the staged delta files (release the claims)

WRITE-INTENT path (append-only commits: hot-table INSERT/COPY and the
streaming ingest plane) — the distributedlog + visimap analog that takes
same-table appenders off the per-table claim entirely:
  stage_intent(table, records): durably stage a per-writer intent record
      under intents/, named by the writer's txid — txid-unique names mean
      N same-table appenders stage concurrently with ZERO claim retries
      by construction
  commit_intent(handle): append ONE fsynced MERGE line ({"w": ...}) to
      commits.log carrying the new segfile records INLINE, then remove
      the intent file. Compose never reads intent files: a merge line
      extends the table's segfiles/nrows instead of replacing its state,
      so appenders commute with each other and overlapping DELETE/UPDATE
      is arbitrated by row visibility (the delmask covers a PREFIX of the
      manifest row order; rows appended after the mask was computed are
      implicitly live — the visimap discipline).
  State-REPLACING delta commits are fenced against in-flight merges by a
  per-table intent sequence (iseq): prepare_delta validates the writer's
  base iseq and commit_delta re-validates it under the commit-log flock,
  so a full-state line can never silently clobber a merge that landed
  after its snapshot (the loser gets a clean write-write conflict).

Readers snapshot the composed state (root + committed deltas in log
order) once per query, so concurrent loads never tear a scan (snapshot
isolation). The effective version = root version + applied delta count is
total-ordered by the log prefix, so equal versions always denote equal
states (cache keys stay sound). fold() — the checkpoint — rewrites the
root at the current effective state, advances the log offset, and GC's
the folded delta files; recover() additionally compacts the log itself.

Crash matrix (docs/ROBUSTNESS.md):
  * kill-9 after prepare_delta, before commit_delta: the staged delta
    files block the table's next sequence (same-table writers conflict,
    exactly like a stale root claim) until recover() rolls them back.
  * kill-9 after the commit line is durable: the commit survives; fold /
    recover() fold it into the root eventually.
  * kill-9 mid-fold: the root replace is atomic; a replayed line whose
    sequence is <= the root's folded sequence is skipped, so the fold is
    idempotent and no committed row is ever lost.
  * kill-9 after stage_intent, before the merge line is durable: the
    intent file is in-doubt evidence only (no reader depends on it) —
    recover() rolls it back exactly like a stale delta claim, and the
    appended rows' segfiles are unreferenced orphans for the sweep.
  * kill-9 after the merge line is durable, before the intent file is
    removed: the commit survives (the line carries the records); the
    leftover intent marker is plain garbage recover()/GC sweeps.

The port's copy of greengage_tpu/storage/manifest.py, on the same files
(manifest.json, deltas/, commits.log), so a directory either package wrote
opens in the other. Ported: the root (``_root``, ``_ensure_root``,
``snapshot``, ``version``), composing the root with committed lines (the
JAX package's write-intent MERGE lines included, so its directories read
here), the ROOT path (``prepare``/``commit``/``abort``, ``commit_tx``), the
DELTA path ``load_table`` commits through (``prepare_delta``/
``commit_delta``/``abort_delta``, ``commit_tables_tx``), the WRITE-INTENT
path INSERT and COPY append through (``stage_intent``/``commit_intent``/
``abort_intent``), ``fold``, ``recover`` and the delta and intent-marker
sweeps; a directory fenced by a promoted standby (item 10) refuses every
commit, as in the JAX package.
"""

from __future__ import annotations

import fcntl
import json
import os
import tempfile
import threading
import time
import uuid

from greengage_tpu_torch.runtime import lockdebug
from greengage_tpu_torch.runtime.faultinject import faults
from greengage_tpu_torch.runtime.logger import counters


class IntentConflict(RuntimeError):
    """A state-replacing commit lost to a write-intent merge that landed
    after its snapshot (or a parked intent expired before resolving).
    Subclasses RuntimeError so every existing write-write-conflict
    handler keeps working; callers that can safely re-stage against a
    fresh snapshot (delmask publishes — the bitmap covers a prefix of
    the row order, so merged appends stay implicitly live) catch THIS
    type to retry, while full-rewrite publishes must surface it."""


class ManifestError(RuntimeError):
    """FATAL: the cluster's commit record is unreadable. Nothing can be
    repaired from segment mirrors (the manifest IS the thing that says
    which files exist) — recover from the standby coordinator, a backup,
    or the archive (docs/ROBUSTNESS.md)."""


class CoordinatorFenced(RuntimeError):
    """This cluster directory has been FENCED by a promoting standby
    (runtime/standby.py write_fence): a paused-not-dead primary woke up
    after its standby took over. Every commit path re-verifies the fence
    at its atomic commit point, so the stale primary cannot fork the
    lineage — the statement dies typed and retryable (SQLSTATE 57P01
    analog: admin/failover shutdown; retry against the promoted
    coordinator's address)."""


class Manifest:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.path = os.path.join(root, "manifest.json")
        self.delta_dir = os.path.join(root, "deltas")
        self.intent_dir = os.path.join(root, "intents")
        self.log_path = os.path.join(root, "commits.log")
        # composed-snapshot memo: (root file sig, log file sig) -> the
        # composed state as a JSON string. snapshot() re-parses the string
        # per call so callers can mutate their copy freely (they do — the
        # DTM mutates tx["tables"] nested dicts in place).
        # lockdebug.named: order-asserting wrappers under GGTPU_LOCK_DEBUG
        # (docs/ANALYSIS.md) — the PR-6 chaos storm found its races on
        # exactly these locks; raw threading.Lock when disabled
        self._compose_lock = lockdebug.named(threading.Lock(),
                                             "manifest._compose_lock")
        self._compose_key = None
        self._compose_json = None
        self._compose_meta: dict = {"seqs": {}, "iseqs": {}, "applied": 0,
                                    "log_end": 0, "root_version": 0}
        # parsed delta-file contents; immutable once committed, keyed
        # (table, seq). Bounded: cleared whenever the root is replaced.
        # Own lock (never held across I/O): _read_delta runs OUTSIDE
        # _compose_lock by design (the compose loop re-stats between
        # attempts), and every snapshot-taking role — statements, the
        # serving pipeline, FTS, the spill prefetcher — reaches it
        # concurrently (gg check races).
        self._delta_lock = lockdebug.named(threading.Lock(),
                                           "manifest._delta_lock")
        self._delta_cache: dict = lockdebug.shared(
            {}, "manifest._delta_cache")
        self._log_lock = lockdebug.named(   # in-process append serializer
            threading.Lock(), "manifest._log_lock")
        # serializes the root version-guard check against the replace (two
        # in-process folds must not replace out of order; cross-process
        # ordering is upheld by the staged-claim CAS + guard re-check)
        self._root_commit_lock = lockdebug.named(
            threading.Lock(), "manifest._root_commit_lock")

    # ---- raw root ------------------------------------------------------
    def _root(self) -> dict:
        if not os.path.exists(self.path):
            return {"version": 0, "tables": {}}
        with open(self.path) as f:
            try:
                return json.load(f)
            except ValueError as e:
                # never let a bare JSONDecodeError escape: this is the
                # cluster's commit record, name it and say what to do
                raise ManifestError(
                    f"corrupt manifest at {self.path}: {e} — restore from "
                    "the standby coordinator, a backup, or the archive"
                ) from e

    def _ensure_root(self) -> None:
        """Materialize the empty root before the first delta commit: other
        subsystems (archive restore guard, standby seeding) treat the root
        file's presence as 'this directory is a cluster'."""
        if os.path.exists(self.path):
            return
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".manifest")
        with os.fdopen(fd, "w") as f:
            json.dump({"version": 0, "tables": {}}, f)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, self.path)     # lose the race quietly
        except FileExistsError:
            pass
        os.remove(tmp)

    @staticmethod
    def _sig(path: str):
        try:
            st = os.stat(path)
            return (st.st_ino, st.st_size, st.st_mtime_ns)
        except OSError:
            return None

    def _check_fence(self) -> None:
        """Refuse to commit into a fenced cluster dir. Called inside every
        locked/flocked commit point (atomic with the commit, like the
        intent-token re-check), so a standby promotion that lands between
        a writer's prepare and its commit turns the stale primary's
        commit into a clean typed failure instead of split-brain."""
        faults.check("coordinator_fence")
        fp = os.path.join(self.root, "coordinator.fence")
        if not os.path.exists(fp):
            return
        try:
            with open(fp) as f:
                owner = json.load(f).get("standby", "?")
        except (OSError, ValueError):
            owner = "?"
        raise CoordinatorFenced(
            f"cluster at {self.root} was fenced by promoted standby "
            f"{owner!r}: this coordinator is stale and must not commit — "
            "retry against the promoted coordinator")

    # ---- delta plumbing ------------------------------------------------
    def _delta_path(self, table: str, seq: int) -> str:
        # '#' (partition children) is filesystem-safe; '.' can't appear in
        # table names, so "<table>.<seq>.delta" parses unambiguously
        return os.path.join(self.delta_dir, f"{table}.{seq}.delta")

    def _read_delta(self, table: str, seq: int) -> dict | None:
        path = self._delta_path(table, seq)
        try:
            st = os.stat(path)
        except OSError:
            return None
        # the file's identity is part of the key: a cross-process DROP +
        # re-CREATE restarts the table at seq 1 with a NEW file, and the
        # recreated delta must never be served from the dropped table's
        # cached bytes (only same-process commits clear the cache)
        key = (table, seq, st.st_ino, st.st_mtime_ns)
        with self._delta_lock:
            hit = self._delta_cache.get(key)
        if hit is not None:
            return json.loads(hit)
        try:
            with open(path) as f:
                raw = f.read()
            parsed = json.loads(raw)
        except (OSError, ValueError):
            return None
        with self._delta_lock:
            if len(self._delta_cache) > 512:
                self._delta_cache.clear()   # bound a long-lived reader
            self._delta_cache[key] = raw
        return parsed

    def _log_lines(self, offset: int) -> tuple[list[dict], int]:
        """Complete committed lines from ``offset``; -> (lines, end_offset).
        A torn tail (crash mid-append) ends the committed prefix."""
        try:
            with open(self.log_path, "rb") as f:
                f.seek(offset)
                buf = f.read()
        except OSError:
            return [], offset
        lines: list[dict] = []
        end = offset
        for chunk in buf.split(b"\n"):
            take = end + len(chunk) + 1
            if take > offset + len(buf):
                break       # no trailing newline: torn/in-flight append
            try:
                lines.append(json.loads(chunk))
            except ValueError:
                break       # garbled line: treat as end of committed prefix
            end = take
        return lines, end

    # ---- snapshots -----------------------------------------------------
    def _compose(self) -> dict:
        """Compose root + committed deltas; memoized on file signatures.
        Returns the internal meta dict {json, seqs, applied, log_end,
        root_version, version} — callers must not mutate it."""
        key = (self._sig(self.path), self._sig(self.log_path))
        with self._compose_lock:
            if key == self._compose_key and self._compose_json is not None:
                return self._compose_meta
        last = None
        for _ in range(6):
            meta = self._compose_once()
            # the memo key must be the signatures read BEFORE composing —
            # the state the compose is actually based on. Re-stat'ing
            # after would stamp a concurrent commit's key onto this (now
            # stale) composition, and a later begin() served from the memo
            # would hand out stale base_seqs: a spurious same-table CAS
            # conflict for a writer that is in fact perfectly serialized.
            key2 = (self._sig(self.path), self._sig(self.log_path))
            if meta is not None:
                meta["json"] = meta.pop("_json")
                if key2 == key:
                    with self._compose_lock:
                        self._compose_key = key
                        self._compose_json = meta["json"]
                        self._compose_meta = meta
                    return meta
                last = meta   # consistent, but the base moved: recompose
            # meta None = a concurrent fold GC'd a delta mid-compose; the
            # root moved forward — re-read against the new base either way
            key = key2
        if last is not None:
            # perpetually-moving target (heavy concurrent commit traffic):
            # the last compose is a consistent snapshot initiated within
            # this call — serve it unmemoized
            return last
        raise ManifestError(
            f"manifest compose raced concurrent folds repeatedly under "
            f"{self.root} — delta files referenced by commits.log are "
            "missing")

    def _compose_once(self) -> dict | None:
        root = self._root()
        tables = root.get("tables", {})
        seqs = dict(root.get("delta_seqs", {}))
        iseqs = {t: int(s) for t, s in root.get("intent_seqs", {}).items()}
        log_pos = int(root.get("log_pos", 0))
        lines, log_end = self._log_lines(log_pos)
        applied = 0
        for line in lines:
            entries = line.get("t") or {}
            hit = False
            for table, seq in entries.items():
                seq = int(seq)
                if seq <= int(seqs.get(table, 0)):
                    continue    # folded into the root already (idempotence)
                delta = self._read_delta(table, seq)
                if delta is None:
                    return None     # racing fold GC: recompose
                state = delta.get("state")
                if state is None:
                    tables.pop(table, None)
                    seqs.pop(table, None)
                    iseqs.pop(table, None)
                else:
                    tables[table] = state
                    seqs[table] = seq
                hit = True
            # write-intent MERGE lines ("w"): the records are carried
            # INLINE, so no intent file is ever read here. The iseq bump
            # and `applied` count are UNCONDITIONAL per mentioned table —
            # a compose from an older root replays more merge lines but
            # starts from lower stored intent_seqs, so equal versions
            # keep denoting equal states (cache keys stay sound).
            wents = line.get("w") or {}
            sents = line.get("s") or {}
            for table, recs in wents.items():
                iseqs[table] = iseqs.get(table, 0) + 1
                # a first-ever append creates the table's storage state
                # (the delta path does the same via its staged snapshot);
                # a "w" line cannot resurrect a dropped table because
                # commit_intent's token re-check is atomic with the log
                # append and DROP removes tokens before its tombstone
                state = tables.setdefault(
                    table, {"segfiles": {}, "nrows": {}})
                segfiles = state.setdefault("segfiles", {})
                nrows = state.setdefault("nrows", {})
                for seg, rels, n in recs:
                    files = segfiles.setdefault(str(seg), [])
                    # rel-membership dedup keeps replay on an older root
                    # idempotent (segfile names embed a tx-unique fileno)
                    if rels and rels[0] in files:
                        continue
                    files.extend(rels)
                    nrows[str(seg)] = int(nrows.get(str(seg), 0)) + int(n)
                marks = sents.get(table) or {}
                if marks:
                    # ingest resume watermarks ride the merge line; max()
                    # keeps out-of-order replay and concurrent per-stream
                    # flushes idempotent
                    streams = state.setdefault("streams", {})
                    for sid, mseq in marks.items():
                        streams[sid] = max(int(streams.get(sid, 0)),
                                           int(mseq))
            if wents:
                hit = True
            if hit:
                applied += 1
        version = int(root.get("version", 0)) + applied
        snap = {"version": version, "tables": tables}
        return {"_json": json.dumps(snap), "seqs": seqs, "iseqs": iseqs,
                "applied": applied, "log_end": log_end,
                "root_version": int(root.get("version", 0)),
                "version": version}

    def snapshot(self) -> dict:
        """The committed state: root snapshot + committed per-table deltas
        applied in commit-log order. Fresh objects per call (callers
        mutate their copy)."""
        return json.loads(self._compose()["json"])

    def version(self) -> int:
        return self._compose()["version"]

    def delta_backlog(self) -> int:
        """Committed-but-unfolded delta commits (checkpoint pressure)."""
        return self._compose()["applied"]

    # ---- transactions --------------------------------------------------
    def begin(self) -> dict:
        """Start a write tx from the current snapshot; mutate tx['tables'].
        base_seqs carries the per-table delta sequence the snapshot
        reflects — the delta path's per-table CAS expectation."""
        meta = self._compose()
        snap = json.loads(meta["json"])
        return {"base_version": snap["version"], "tables": snap["tables"],
                "base_seqs": dict(meta["seqs"]),
                "base_iseqs": dict(meta["iseqs"])}

    # ---- ROOT path (structural commits; every root commit is a fold) ---
    def _staged_path(self, version: int) -> str:
        return os.path.join(self.root, f"manifest.{version}.prepared")

    def prepare(self, tx: dict) -> int:
        """Phase 1: durably stage the new root. Returns the new version.

        The staged file is claimed with an EXCLUSIVE hard link: two writers
        racing past the version check cannot both stage version v — the
        loser gets the same write-write conflict it would have gotten from
        the version check (the CAS is atomic, not just check-then-write).
        A root commit folds: its staged content embeds the current delta
        sequences and log offset, so committed deltas are incorporated and
        their files become GC-able at commit."""
        meta = self._compose()
        if meta["version"] != tx["base_version"]:
            counters.inc("manifest_cas_conflict_total")
            raise RuntimeError(
                f"write-write conflict: base v{tx['base_version']} != "
                f"current v{meta['version']}")
        version = tx["base_version"] + 1
        seqs = {t: s for t, s in meta["seqs"].items() if t in tx["tables"]}
        iseqs = {t: s for t, s in meta["iseqs"].items() if t in tx["tables"]}
        data = {"version": version, "tables": tx["tables"],
                "delta_seqs": seqs, "intent_seqs": iseqs,
                "log_pos": meta["log_end"]}
        staged = self._staged_path(version)
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".manifest")
        with os.fdopen(fd, "w") as f:
            json.dump(data, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, staged)
        except FileExistsError:
            os.remove(tmp)
            counters.inc("manifest_cas_conflict_total")
            raise RuntimeError(
                f"write-write conflict: version v{version} already prepared "
                "by a concurrent writer")
        os.remove(tmp)
        return version

    def commit(self, version: int) -> None:
        """Phase 2: the atomic commit point (copy + atomic replace).

        The staged file is KEPT as a permanent claim on its version
        number: a concurrent writer that read the manifest just before
        this commit still holds the old version and would otherwise
        re-prepare (and later clobber) this version — its exclusive link
        against the surviving claim turns that into the write-write
        conflict it is. Claims are tiny and GC'd far behind the head by
        recover()."""
        staged = self._staged_path(version)
        if not os.path.exists(staged):
            raise RuntimeError(f"no prepared manifest v{version}")
        with open(staged) as f:
            data = json.load(f)
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".manifest")
        with os.fdopen(fd, "wb") as f:
            with open(staged, "rb") as src:
                f.write(src.read())
            f.flush()
            os.fsync(f.fileno())
        with self._root_commit_lock:
            # Version guard: a staged root must never replace a NEWER one.
            # Effective versions advance through delta log lines, so two
            # folds can stage v and v' > v concurrently (the old root path
            # couldn't: version v' was only preparable after v committed);
            # replacing out of order would roll the root BACK and fork the
            # lineage — composes downstream of v' would reference deltas
            # the v'-commit's GC already aged out. The loser keeps its
            # staged claim (recover() sweeps claims behind the head) and
            # gets the conflict; fold() treats it as a lost claim and
            # yields.
            cur = int(self._root().get("version", 0))
            if cur >= version:
                os.remove(tmp)
                raise RuntimeError(
                    f"write-write conflict: root advanced to v{cur} before "
                    f"staged v{version} could commit")
            try:
                self._check_fence()
            except BaseException:
                os.remove(tmp)
                raise
            os.replace(tmp, self.path)
        with self._delta_lock:
            self._delta_cache.clear()
        # the new root folded every delta at or below its recorded
        # sequences: GC their files (best-effort; recover() is the backstop)
        self._gc_deltas(int(data.get("log_pos", 0)))
        # same ride-along for intent markers left by crashed writers
        self.sweep_intents()

    def abort(self, version: int) -> None:
        staged = self._staged_path(version)
        if os.path.exists(staged):
            os.remove(staged)

    # ---- DELTA path (per-table state commits) --------------------------
    def prepare_delta(self, tx: dict, tables: list[str]) -> dict:
        """Phase 1 of the per-table path: stage one delta file per written
        table, each claimed via an exclusive hard link on the table's next
        sequence. Tables are claimed in sorted order (deadlock-free);
        a lost claim releases everything already claimed and raises the
        write-write conflict. Returns the commit handle."""
        base_seqs = tx.get("base_seqs", {})
        # hand-built txs (fold, restores, tests) carry no base_iseqs and
        # opt out of the intent fence; begin()-issued txs always carry it
        base_iseqs = tx.get("base_iseqs")
        cur = self._compose()
        handle = {"txid": uuid.uuid4().hex[:12], "tables": {}, "iseq": {}}
        claimed: list[tuple[str, int]] = []
        try:
            os.makedirs(self.delta_dir, exist_ok=True)
            self._ensure_root()
            for table in sorted(tables):
                want = int(base_seqs.get(table, 0))
                have = int(cur["seqs"].get(table, 0))
                if have != want:
                    counters.inc("manifest_cas_conflict_total")
                    raise RuntimeError(
                        f"write-write conflict on table {table!r}: base "
                        f"seq {want} != current seq {have}")
                if base_iseqs is not None:
                    # intent fence: this full-state line would CLOBBER any
                    # merge that landed after the writer's snapshot
                    iwant = int(base_iseqs.get(table, 0))
                    ihave = int(cur["iseqs"].get(table, 0))
                    if ihave != iwant:
                        counters.inc("manifest_intent_conflict_total")
                        raise IntentConflict(
                            f"write-write conflict on table {table!r}: "
                            f"{ihave - iwant} intent merge(s) landed since "
                            "this transaction's snapshot")
                    handle["iseq"][table] = iwant
                seq = want + 1
                data = {"txid": handle["txid"], "table": table, "seq": seq,
                        "state": tx["tables"].get(table)}
                fd, tmp = tempfile.mkstemp(dir=self.delta_dir,
                                           prefix=".delta")
                with os.fdopen(fd, "w") as f:
                    json.dump(data, f)
                    f.flush()
                    os.fsync(f.fileno())
                try:
                    os.link(tmp, self._delta_path(table, seq))
                except FileExistsError:
                    os.remove(tmp)
                    counters.inc("manifest_cas_conflict_total")
                    raise RuntimeError(
                        f"write-write conflict: delta {table}.{seq} already "
                        "staged by a concurrent writer")
                os.remove(tmp)
                claimed.append((table, seq))
                handle["tables"][table] = seq
            # post-claim re-validation closes the check/claim window against
            # a concurrent commit+fold recycling our claimed sequence
            now = self._compose()
            for table, seq in claimed:
                if int(now["seqs"].get(table, 0)) >= seq:
                    counters.inc("manifest_cas_conflict_total")
                    raise RuntimeError(
                        f"write-write conflict: table {table!r} advanced to "
                        f"seq {now['seqs'].get(table)} during prepare")
                if base_iseqs is not None and \
                        int(now["iseqs"].get(table, 0)) \
                        != int(base_iseqs.get(table, 0)):
                    counters.inc("manifest_intent_conflict_total")
                    raise IntentConflict(
                        f"write-write conflict on table {table!r}: an "
                        "intent merge landed during prepare")
        except BaseException:
            for table, seq in claimed:
                try:
                    os.remove(self._delta_path(table, seq))
                except OSError:
                    pass
            raise
        return handle

    def commit_delta(self, handle: dict) -> int:
        """Phase 2: append the fsynced commit line — the atomic multi-table
        commit record. Returns the new effective version.

        The claims are re-validated first: a grace-expired GC (a 2PC
        parked > GC_GRACE_S between prepare and commit) or a concurrent
        process's recover() may have removed the staged files, and a
        commit record must never reference deltas that no longer exist —
        that would wedge every later compose. The expired committer gets
        a clean write-write conflict (tx aborts) instead."""
        for table, seq in handle.get("tables", {}).items():
            if not os.path.exists(self._delta_path(table, int(seq))):
                raise RuntimeError(
                    f"write-write conflict: staged delta {table}.{seq} "
                    "expired before commit (claim removed by GC or "
                    "recovery)")
        line = (json.dumps({"x": handle["txid"], "t": handle["tables"]})
                + "\n").encode()
        with self._log_lock:
            fd = os.open(self.log_path,
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            try:
                # cross-process exclusion against recover()'s compaction
                # truncate: an append can never land between its size
                # check and the truncate
                fcntl.flock(fd, fcntl.LOCK_EX)
                # final intent fence, atomic with the append: commit_intent
                # serializes through this same flock, so an iseq that still
                # matches HERE cannot be invalidated before our line lands.
                # Without this, a merge committing inside the prepare ->
                # commit window would be silently erased by this full-state
                # line (lost update on the appended rows).
                expect = handle.get("iseq") or {}
                if expect:
                    now = self._compose()
                    for table, iwant in expect.items():
                        if int(now["iseqs"].get(table, 0)) != int(iwant):
                            counters.inc("manifest_intent_conflict_total")
                            raise IntentConflict(
                                f"write-write conflict on table {table!r}: "
                                "an intent merge landed during this "
                                "transaction's commit window")
                # promotion fence, atomic with the append: a standby that
                # fenced this dir strictly before this point keeps the
                # line out of the log entirely (split-brain invariant)
                self._check_fence()
                os.write(fd, line)
                os.fsync(fd)
            finally:
                os.close(fd)
        counters.inc("manifest_delta_commits")
        return self.version()

    def abort_delta(self, handle: dict) -> None:
        """Release the staged per-table claims (rollback before commit)."""
        for table, seq in handle.get("tables", {}).items():
            try:
                os.remove(self._delta_path(table, int(seq)))
            except OSError:
                pass

    # ---- WRITE-INTENT path (concurrent same-table appends) -------------
    def _intent_path(self, table: str, txid: str) -> str:
        # txid-unique names: no exclusive-link CAS, hence no claim retry
        return os.path.join(self.intent_dir, f"{table}.{txid}.intent")

    def stage_intent(self, table: str, records: list,
                     streams: dict | None = None) -> dict:
        """Stage a per-writer write-intent for an APPEND-ONLY commit.

        ``records`` is the _write_segfiles output — [(seg, [rels], nrows)]
        per written segment. The durable intent file is in-doubt crash
        evidence plus the expiry token commit_intent re-checks; it is
        never read by compose (the merge line carries the records), so
        sweeping it can only abort an uncommitted writer, never corrupt a
        committed state. Returns the commit handle."""
        os.makedirs(self.intent_dir, exist_ok=True)
        self._ensure_root()
        txid = uuid.uuid4().hex[:12]
        recs = [(int(seg), list(rels), int(n)) for seg, rels, n in records]
        marks = {str(k): int(v) for k, v in (streams or {}).items()}
        data = {"txid": txid, "table": table, "records": recs,
                "streams": marks}
        path = self._intent_path(table, txid)
        fd, tmp = tempfile.mkstemp(dir=self.intent_dir, prefix=".intent")
        with os.fdopen(fd, "w") as f:
            json.dump(data, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # crash window: intent staged, merge line not durable — recover()
        # rolls this writer back exactly like a stale delta claim
        faults.check("intent_stage")
        return {"txid": txid, "table": table, "records": recs,
                "streams": marks, "path": path}

    def commit_intent(self, handle: dict) -> int:
        """Resolve a staged intent: append ONE fsynced merge line, then
        remove the intent file. Returns the new effective version.

        The intent file is re-checked first, mirroring commit_delta's
        claim re-validation: a writer parked past the GC grace (or raced
        by recover()/DROP) finds its token gone and gets a clean
        write-write conflict instead of publishing rows whose segfiles
        the orphan sweep may already have reclaimed."""
        path = handle["path"]
        if not os.path.exists(path):
            counters.inc("manifest_intent_conflict_total")
            raise IntentConflict(
                f"write-write conflict: staged intent {handle['table']}."
                f"{handle['txid']} expired before commit (removed by GC, "
                "recovery, or DROP TABLE)")
        rec: dict = {"x": handle["txid"],
                     "w": {handle["table"]: handle["records"]}}
        if handle.get("streams"):
            rec["s"] = {handle["table"]: handle["streams"]}
        line = (json.dumps(rec) + "\n").encode()
        # crash window A: resolve reached, line not appended — rollback
        faults.check("intent_resolve")
        with self._log_lock:
            fd = os.open(self.log_path,
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX)
                # token re-check ATOMIC with the append: a sweep or DROP
                # that removes the token strictly before this point keeps
                # the merge line out of the log entirely, so a "w" line
                # can never land after its table's drop tombstone
                if not os.path.exists(path):
                    counters.inc("manifest_intent_conflict_total")
                    raise IntentConflict(
                        f"write-write conflict: staged intent "
                        f"{handle['table']}.{handle['txid']} expired "
                        "before commit (removed by GC, recovery, or "
                        "DROP TABLE)")
                # promotion fence, atomic with the append (see commit_delta)
                self._check_fence()
                os.write(fd, line)
                os.fsync(fd)
            finally:
                os.close(fd)
        # crash window B: line durable, marker not yet removed — the
        # commit SURVIVES; the leftover marker is garbage for the sweep
        faults.check("intent_resolve")
        try:
            os.remove(path)
        except OSError:
            pass
        counters.inc("manifest_intent_commits")
        return self.version()

    def abort_intent(self, handle: dict) -> None:
        """Withdraw a staged intent (rollback before the merge line)."""
        try:
            os.remove(handle["path"])
        except OSError:
            pass

    def sweep_intents(self, grace_s: float | None = None) -> int:
        """Remove write-intent files older than the grace window — the
        delta-claim grace-GC discipline applied to intents. Safe at any
        time: compose never reads intent files, so a swept file either
        aborts a crashed/parked writer (which gets the clean conflict at
        commit_intent, like an expired delta claim) or clears a committed
        writer's leftover marker. Returns the number removed."""
        if grace_s is None:
            grace_s = self.GC_GRACE_S
        try:
            names = os.listdir(self.intent_dir)
        except OSError:
            return 0
        removed = 0
        now = time.time()
        for fn in names:
            if not fn.endswith(".intent"):
                continue
            path = os.path.join(self.intent_dir, fn)
            try:
                if now - os.stat(path).st_mtime < grace_s:
                    continue
                os.remove(path)
                removed += 1
            except OSError:
                continue
        if removed:
            counters.inc("manifest_intent_swept_total", removed)
        return removed

    # ---- checkpoint fold -----------------------------------------------
    def fold(self, min_deltas: int = 1) -> bool:
        """Fold committed deltas into the root snapshot (the checkpoint):
        stage a root at the current effective state (log offset advanced
        past every folded line), commit it, GC the folded delta files.
        Opportunistic — a lost root claim means another writer/folder is
        moving the root and this fold simply yields. Returns True when a
        fold committed."""
        meta = self._compose()
        if meta["applied"] < max(1, min_deltas):
            return False
        tx = {"base_version": meta["version"],
              "tables": json.loads(meta["json"])["tables"]}
        try:
            v = self.prepare(tx)
        except RuntimeError:
            return False        # concurrent fold/root writer owns the move
        # crash window A: staged but not committed — recover() rolls the
        # claim back; deltas + log intact, nothing lost
        faults.check("delta_fold")
        try:
            self.commit(v)
        except RuntimeError:
            # the root advanced past our staged version while we held the
            # claim (a concurrent fold from a later effective base): that
            # fold subsumed this one's work — yield, releasing the claim
            self.abort(v)
            return False
        except BaseException:
            self.abort(v)
            raise
        # crash window B: root committed, folded delta files not yet GC'd —
        # compose skips sequences at/below the root's, recover() sweeps
        faults.check("delta_fold")
        counters.inc("manifest_folds")
        return True

    # Delta files outlive their fold by a grace period (the
    # TableStore.gc_files GC_GRACE_S principle): a lock-free composer
    # that read the PREVIOUS root may still need them, and a folded delta
    # applied on that older root composes the identical state (the
    # sequence guard keeps replay idempotent). Without the grace, heavy
    # fold traffic (threshold 1) starves compose — every retry races a
    # fresh fold's unlink. recover() sweeps unconditionally at startup.
    GC_GRACE_S = 20.0

    def _gc_deltas(self, log_pos: int, grace_s: float | None = None) -> None:
        """Best-effort delta-file GC after a root commit. The committing
        fold's composed state is already stale the moment it lands (a
        table's first write, a commit, an in-flight claim may all have
        raced it), so classification against that state is unsound — the
        rules here use only ground truth observable NOW:

        * a (table, seq) referenced by a committed log line at/after the
          new root's offset is LIVE (committed but not yet folded): never
          touched;
        * everything else — folded files, dead chains of dropped tables,
          crashed claims — is removed once older than the grace window.
          Youth protects in-flight claims (prepare_delta -> commit_delta
          spans milliseconds) and composers holding the previous root;
          recover() and drop_table_deltas() handle the cases where the
          caller KNOWS there is no concurrency."""
        if grace_s is None:
            grace_s = self.GC_GRACE_S
        try:
            names = os.listdir(self.delta_dir)
        except OSError:
            return
        referenced: set = set()
        for line in self._log_lines(int(log_pos))[0]:
            for t, s in (line.get("t") or {}).items():
                referenced.add((t, int(s)))
        now = time.time()
        for fn in names:
            if not fn.endswith(".delta"):
                continue
            try:
                stem, seq_s = fn[:-len(".delta")].rsplit(".", 1)
                seq = int(seq_s)
            except ValueError:
                continue
            if (stem, seq) in referenced:
                continue
            path = os.path.join(self.delta_dir, fn)
            try:
                if now - os.stat(path).st_mtime < grace_s:
                    continue
                os.remove(path)
            except OSError:
                pass

    def drop_table_deltas(self, table: str) -> None:
        """Unlink a dropped table's whole delta chain NOW (no grace): a
        later CREATE of the same name restarts at seq 1 and must not
        collide with a stale claim. Only callers that hold the session's
        exclusive write mode (DROP TABLE does) may use this — under that
        lock no composer or claimant can be in flight for the table in
        this process, and a cross-process composer that loses the race
        simply recomposes against the new root (the table is gone from
        it)."""
        try:
            names = os.listdir(self.delta_dir)
        except OSError:
            return
        for fn in names:
            if fn.endswith(".delta") \
                    and fn[:-len(".delta")].rsplit(".", 1)[0] == table:
                try:
                    os.remove(os.path.join(self.delta_dir, fn))
                except OSError:
                    pass
        # the dropped table's staged intents go with it (no grace, same
        # contract): an in-flight appender finds its token gone and gets
        # the clean conflict at commit_intent
        swept = 0
        try:
            inames = os.listdir(self.intent_dir)
        except OSError:
            inames = []
        for fn in inames:
            if fn.endswith(".intent") \
                    and fn[:-len(".intent")].rsplit(".", 1)[0] == table:
                try:
                    os.remove(os.path.join(self.intent_dir, fn))
                    swept += 1
                except OSError:
                    pass
        if swept:
            counters.inc("manifest_intent_swept_total", swept)
        with self._compose_lock:
            self._compose_key = None
        with self._delta_lock:
            self._delta_cache.clear()

    # ---- recovery ------------------------------------------------------
    def recover(self) -> list[int]:
        """In-doubt resolution (cdbdtxrecovery.c analog), run on startup
        with no concurrent writers:

        1. roll back prepared-but-uncommitted ROOT stages above the
           committed head (claims at/below it are permanent markers,
           GC'd once far behind);
        2. roll back staged delta files whose (table, seq) no committed
           log line references — a crash between prepare_delta and
           commit_delta (their claims were blocking the table);
        3. compact: fold every committed delta into the root and truncate
           the commit log, so a freshly-opened cluster always starts from
           a plain root snapshot.

        A corrupt manifest.json SURFACES here as ManifestError (startup
        must refuse to open, not quietly roll back live versions against
        a half-read head).

        The no-concurrent-writers contract is fail-safe, not assumed: a
        live writer in another process whose staged claims this sweep
        removes gets a clean write-write conflict at commit_delta (which
        re-validates its claims), and the log compaction re-checks the
        log size under the cross-process append lock — a commit racing
        recovery is either fully kept or cleanly refused, never hidden."""
        meta = self._compose()
        current = meta["version"]
        rolled = []
        for fn in os.listdir(self.root):
            if fn.startswith("manifest.") and fn.endswith(".prepared"):
                v = int(fn.split(".")[1])
                if v > current:
                    os.remove(os.path.join(self.root, fn))
                    rolled.append(v)
                elif v < current - 64:
                    os.remove(os.path.join(self.root, fn))
        # in-doubt deltas: staged claims above the committed sequence
        committed = dict(meta["seqs"])
        root = self._root()
        folded = {t: int(s) for t, s in root.get("delta_seqs", {}).items()}
        try:
            names = os.listdir(self.delta_dir)
        except OSError:
            names = []
        for fn in names:
            if not fn.endswith(".delta"):
                continue
            try:
                stem, seq_s = fn[:-len(".delta")].rsplit(".", 1)
                seq = int(seq_s)
            except ValueError:
                continue
            if seq > int(committed.get(stem, 0)):
                # staged, never committed: the in-doubt tx rolls back
                os.remove(os.path.join(self.delta_dir, fn))
                rolled.append(-seq)
            elif seq <= folded.get(stem, 0):
                os.remove(os.path.join(self.delta_dir, fn))   # fold leftover
        # in-doubt write intents: at exclusive-open startup EVERY intent
        # file is removable — an uncommitted one rolls its writer back
        # (exactly like the staged delta claims above; its orphaned
        # segfiles fall to the store's sweep), a committed one is only
        # the leftover marker of a kill between the durable merge line
        # and the unlink. Counted (manifest_intent_swept_total), not
        # appended to `rolled` — callers assert recover() idempotence as
        # `recover() == []` and a marker sweep is not a rolled-back root.
        self.sweep_intents(grace_s=0.0)
        with self._compose_lock:
            self._compose_key = None    # delta files moved under us
        with self._delta_lock:
            self._delta_cache.clear()
        # compaction: fold everything, then reset the log (exclusive-open
        # startup is the one safe moment to shrink it)
        meta = self._compose()
        if meta["applied"] > 0:
            self.fold(min_deltas=1)
        meta = self._compose()
        if meta["applied"] == 0 and os.path.exists(self.log_path):
            root = self._root()
            if int(root.get("log_pos", 0)) >= meta["log_end"] \
                    and meta["log_end"] > 0:
                try:
                    # Ordering: root (log_pos=0) FIRST, truncate second —
                    # a failure in between is benign (replayed lines are
                    # sequence-guarded no-ops), while truncating first
                    # would leave log_pos pointing past a short log and
                    # silently hide every later commit. Both steps run
                    # under the cross-process append lock with a size
                    # re-check, so a commit landing after the compose is
                    # never erased.
                    root["log_pos"] = 0
                    fd, tmp = tempfile.mkstemp(dir=self.root,
                                               prefix=".manifest")
                    with os.fdopen(fd, "w") as f:
                        json.dump(root, f, indent=1)
                        f.flush()
                        os.fsync(f.fileno())
                    lf = os.open(self.log_path, os.O_RDWR)
                    try:
                        fcntl.flock(lf, fcntl.LOCK_EX)
                        if os.fstat(lf).st_size == meta["log_end"]:
                            os.replace(tmp, self.path)
                            os.ftruncate(lf, 0)
                        else:       # a commit landed since the compose
                            os.remove(tmp)
                    finally:
                        os.close(lf)
                except OSError:
                    pass
        # sweep grace-lingering folded files too (exclusive-open startup:
        # no composer can hold an older root, no claim can be in flight) —
        # a fresh open always starts from a clean deltas/ directory
        self._gc_deltas(int(self._root().get("log_pos", 0)), grace_s=0.0)
        with self._compose_lock:
            self._compose_key = None
        with self._delta_lock:
            self._delta_cache.clear()
        return rolled

    def commit_tx(self, tx: dict) -> int:
        """One-phase ROOT convenience (structural commits: DROP TABLE,
        width changes, restores — each is also a checkpoint fold)."""
        v = self.prepare(tx)
        try:
            self.commit(v)
        except BaseException:
            # a lost commit guard (cross-process fold raced us) releases
            # the claim and surfaces the conflict — the commit did NOT
            # apply, and the caller must not believe it did
            self.abort(v)
            raise
        return v

    def commit_tables_tx(self, tx: dict, tables: list[str]) -> int:
        """One-phase DELTA convenience: publish ``tables``' states from
        ``tx`` through the per-table path. Returns the effective version."""
        handle = self.prepare_delta(tx, tables)
        try:
            return self.commit_delta(handle)
        except BaseException:
            self.abort_delta(handle)
            raise
