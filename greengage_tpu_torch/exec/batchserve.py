"""Vectorized serving — batch concurrent same-shape statements into one
batched program behind an async executor pipeline; the port's counterpart
of greengage_tpu/exec/batchserve.py.

The QD/QE split amortizes planning across many executors; on the card the
analogous lever is amortizing *launches* (and their host work) across
many concurrent users. A serving workload is dominated by repeated
statement shapes with varying literals, and the plan cache already
reduces those to ONE bound plan keyed on the literal-stripped signature,
with the literals in one int64 parameter tensor per run. This module gives
that parameter tensor a member axis:

  * **admission window** — the session-side intake collects in-flight
    statements sharing one plan-cache key (statement signature — which
    pins the shape signature at a given manifest version) for up to
    ``batch_window_ms``, or until ``batch_max_width`` members arrive. An
    idle pipeline flushes immediately, so the window costs latency only
    while the device is busy — exactly when the wait is free.
  * **one dispatch** — members' parameter vectors stack along a leading
    member axis and a width-bucketed batched program (compile.py
    ``batch_width``: the member body under ``torch.func.vmap`` over the
    stacked parameters) runs ONCE over the shared staged tables. Widths
    bucket to a power of two (padded with the last member's values). The
    port keeps no program cache: every batch builds its program, which is
    a closure over the plan, not a compiled executable.
  * **pipelined stages** — a stager thread and a dispatcher thread
    connected by a queue: batch k+1 stages (host reads, the staging
    pool) while batch k runs on the device. Both use the device's default
    stream, so a batch's uploads precede its program; pinned host buffers
    are fresh per call, so no in-flight copy has its buffer reused.
    Neither thread carries a statement context, so no member's
    cancellation can abort the batch.
  * **per-member demux** — one flag read and one copy of every member's
    outputs to the host; each member's slice then finishes its Gather
    exactly like a classic statement's; a member cancelled mid-flight is
    masked out
    at demux (its thread raises the typed ``StatementCancelled``) and
    its batch-mates' results are untouched.
  * **observability** — every flush records a standalone trace (a
    ``batch-dispatch`` root with compile/stage/dispatch/fetch children
    plus one ``batch-member`` child per member) retired into the trace
    ring under a negative id AND grafted into every member's statement
    trace, so one flame graph shows the whole batch. Counters:
    ``batch_dispatch_total`` / ``batch_members_total`` /
    ``batch_window_flush_{full,timer}`` / ``batch_fallback_total``, the
    ``batch_width`` histogram, and the ``batch_queue_depth`` gauge.

Any batch that cannot run as one program — admission ceiling, overflow
flags, a shape whose operators the batched program cannot run — falls
back: every member re-runs serially through the classic executor path,
which owns retries and spill. The fallback is a routing decision, never a
client-visible error. The JAX package also broadcasts a window to a
multihost gang (``_mh_exchange``); the port has no multihost until ROADMAP
Queue 1 item 8.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import OrderedDict, deque

from greengage_tpu_torch.exec.executor import BatchFallback
from greengage_tpu_torch.runtime.interrupt import REGISTRY as _INTERRUPTS
from greengage_tpu_torch.runtime.logger import counters, histograms
from greengage_tpu_torch.runtime.trace import TRACES, Trace

# batch widths are small pow2s, not latencies: explicit buckets
WIDTH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)

# hard ceiling on a member's wait for its flush — a wedged pipeline must
# degrade to serial execution, never to a hung client connection
_WEDGE_TIMEOUT_S = 600.0


class _Member:
    """One waiting statement: its parameter vector, interrupt context,
    statement trace, and the event its connection thread parks on."""

    __slots__ = ("pvec", "ctx", "trace", "wait_sid", "event", "result",
                 "fallback", "masked", "t0")

    def __init__(self, pvec, ctx, trace):
        self.pvec = pvec
        self.ctx = ctx
        self.trace = trace
        self.wait_sid = None
        self.event = threading.Event()
        self.result = None
        self.fallback = False     # re-run serially on the member's thread
        self.masked = False       # cancelled: raise, never read the slice
        self.t0 = time.monotonic()


class _Batch:
    """One admission window: same plan-cache key, stacked at flush."""

    __slots__ = ("bid", "key", "plan", "consts", "members",
                 "deadline", "trace", "root_sid", "staged", "stage_error")

    def __init__(self, bid, key, plan, consts, deadline):
        self.bid = bid
        self.key = key
        self.plan = plan
        self.consts = consts
        self.members: list[_Member] = []
        self.deadline = deadline
        self.trace = None
        self.root_sid = None
        self.staged = None
        self.stage_error = None


class BatchServer:
    """The per-Database serving pipeline. Created lazily by the session
    on the first batch-eligible statement; its two worker threads are
    daemons that carry no statement context."""

    def __init__(self, db):
        self.db = db
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._open: OrderedDict[str, _Batch] = OrderedDict()
        # windows that FILLED before the stager collected them: moved
        # here by submit() when it opens a successor window for the same
        # key — a full window must never be orphaned by its replacement
        self._full: deque = deque()
        self._dq: queue.Queue = queue.Queue()
        self._bids = itertools.count(1)
        self._members: dict[int, int] = {}   # statement id -> batch id
        self._inflight = 0     # batches popped from the window, not demuxed
        self._started = False
        # Event, not a bare bool: stop() runs on a statement thread
        # while both pipeline threads poll it
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # finished per-flush traces, newest last (tests + introspection;
        # the same traces sit in the TRACES ring under their -bid ids)
        self.recent: deque = deque(maxlen=32)

    # ---- the statement-thread surface --------------------------------
    def submit(self, plan, consts, key: str, pvec):
        """Enroll the calling statement in the admission window for its
        plan-cache key and wait for the flush. Returns the member's
        Result, or None when the batch fell back (the caller re-runs the
        statement through the classic path). Raises StatementCancelled
        for a member cancelled while waiting or masked at demux."""
        ctx = _INTERRUPTS.current()
        mtr = TRACES.current()
        m = _Member(pvec, ctx, mtr)
        self._ensure_threads()
        window_s = max(float(getattr(self.db.settings,
                                     "batch_window_ms", 2.0)), 0.0) / 1e3
        maxw = max(int(getattr(self.db.settings, "batch_max_width", 16)), 1)
        # the window is keyed by the BOUND PLAN's identity, not just the
        # statement signature: a load bumps the store version and the
        # session re-binds (pinned string literals lower to dictionary
        # codes, estimates move), so a member planned after it must open
        # its own window rather than execute a batch-mate's stale
        # binding. Plan objects are alive for the
        # window's lifetime (_Batch.plan holds a reference), so id() is
        # unambiguous here.
        wkey = (key, id(plan))
        qcap = int(getattr(self.db.settings, "batch_queue_limit", 0))
        with self._cv:
            if qcap > 0:
                waiting = sum(len(x.members) for x in self._open.values()) \
                    + sum(len(x.members) for x in self._full)
                if waiting >= qcap:
                    # serving-pipeline shed: past the member cap this
                    # statement runs on the classic serial path — bounded
                    # by the admission queue — instead of growing the
                    # windows unboundedly while the device is the
                    # bottleneck
                    counters.inc("batch_members_shed_total")
                    return None
            b = self._open.get(wkey)
            if b is not None and len(b.members) >= maxw:
                # the window filled before the stager collected it: hand
                # it over explicitly (replacing it in _open would orphan
                # its members) and open a successor for this member
                del self._open[wkey]
                self._full.append(b)
                b = None
            if b is None:
                b = _Batch(next(self._bids), key, plan, consts,
                           time.monotonic() + window_s)
                self._open[wkey] = b
            b.members.append(m)
            if ctx is not None:
                self._members[ctx.statement_id] = b.bid
            depth = sum(len(x.members) for x in self._open.values()) \
                + sum(len(x.members) for x in self._full)
            self._cv.notify_all()
        counters.set("batch_queue_depth", depth)
        if mtr is not None:
            m.wait_sid = mtr.begin("batch-wait", cat="queue", batch=b.bid)
        try:
            # the member's wait is a cancellation point: poll the
            # statement context so a cancel or a timeout takes a queued
            # member out immediately — its batch-mates are
            # untouched (the dispatcher masks it at demux)
            hard = time.monotonic() + _WEDGE_TIMEOUT_S
            while not m.event.wait(0.02):
                if ctx is not None:
                    ctx.check()
                if self._stop.is_set():
                    # Database.close(): whatever this member's window
                    # was doing, degrade to the classic path rather
                    # than park the connection thread on a dead pipeline
                    self._abandon(wkey, b, m)
                    return None
                if time.monotonic() > hard:
                    if self._abandon(wkey, b, m):
                        return None   # window never flushed: run classic
                    # flushed but the pipeline is wedged mid-batch —
                    # degrade to serial rather than hang the connection
                    return None
        finally:
            if mtr is not None:
                mtr.end(m.wait_sid)
            if ctx is not None:
                with self._mu:
                    self._members.pop(ctx.statement_id, None)
        if m.masked and ctx is not None:
            ctx.check()   # raises the typed StatementCancelled
        if m.fallback or m.result is None:
            return None
        m.result.wall_ms = (time.monotonic() - m.t0) * 1e3
        return m.result

    def _abandon(self, wkey, b: _Batch, m: _Member) -> bool:
        """Remove a timed-out member from a still-open window (True) or
        report that its batch already flushed (False)."""
        with self._cv:
            if self._open.get(wkey) is b and m in b.members:
                b.members.remove(m)
                if not b.members:
                    del self._open[wkey]
                return True
        return False

    def member_of(self, statement_id: int) -> int | None:
        """Batch id a waiting statement belongs to (an activity listing's
        column)."""
        with self._mu:
            return self._members.get(statement_id)

    def queue_depths(self) -> dict:
        """Serving-pipeline depths (a status listing's columns)."""
        with self._mu:
            return {
                "batch_admission_depth": sum(
                    len(b.members) for b in self._open.values())
                + sum(len(b.members) for b in self._full),
                "batch_inflight": self._inflight,
            }

    def stop(self) -> None:
        """Stop the pipeline threads and wait for them briefly (a daemon
        thread still inside a device call at interpreter shutdown can
        abort the process), then release every member
        still parked in a window or staged batch — each degrades to the
        classic serial path on its own thread instead of waiting out the
        wedge timeout against a dead pipeline."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        for t in self._threads:
            if t is not threading.current_thread():
                # Database.close() teardown, not a statement path: the
                # pipeline threads exit on _stop within one poll tick and
                # the join is hard-bounded
                t.join(timeout=3.0)
        stranded: list[_Member] = []
        with self._cv:
            for b in list(self._open.values()):
                stranded.extend(b.members)
            self._open.clear()
            while self._full:
                stranded.extend(self._full.popleft().members)
        while True:
            try:
                stranded.extend(self._dq.get_nowait().members)
            except queue.Empty:
                break
        for m in stranded:
            m.fallback = True
            m.event.set()

    # ---- pipeline threads --------------------------------------------
    def _ensure_threads(self) -> None:
        if self._started:
            return
        with self._mu:
            if self._started:
                return
            self._threads = [
                threading.Thread(target=self._stage_loop, daemon=True,
                                 name="gg-batch-stage"),
                threading.Thread(target=self._dispatch_loop, daemon=True,
                                 name="gg-batch-dispatch"),
            ]
            for t in self._threads:
                t.start()
            self._started = True

    def _take_window(self) -> _Batch | None:
        """Block until a window is flushable. A window flushes when it is
        FULL (batch_max_width — whatever the pipeline is doing, staging
        it overlaps the in-flight dispatch), or when the pipeline can
        actually accept it (nothing already staged and waiting) and
        either the pipeline is idle (an extra wait would buy no
        batch-mates — flush immediately, so a lone statement pays ~zero
        window latency) or batch_window_ms has elapsed. While a staged
        batch is already queued behind the dispatcher, windows keep
        accumulating members — the wait is free exactly when the device
        is the bottleneck, and width grows to match the device's pace."""
        with self._cv:
            while not self._stop.is_set():
                now = time.monotonic()
                maxw = max(int(getattr(self.db.settings,
                                       "batch_max_width", 16)), 1)
                while self._full:
                    b = self._full.popleft()
                    if not b.members:
                        continue
                    self._inflight += 1
                    counters.inc("batch_window_flush_full")
                    return b
                idle = (self._inflight == 0 and self._dq.empty())
                can_take = self._dq.empty() and self._inflight <= 1
                for key, b in list(self._open.items()):
                    full = len(b.members) >= maxw
                    if full or (can_take and (idle or now >= b.deadline)):
                        del self._open[key]
                        if not b.members:
                            continue   # every member abandoned
                        self._inflight += 1
                        if full:
                            counters.inc("batch_window_flush_full")
                        else:
                            counters.inc("batch_window_flush_timer")
                        return b
                timeout = 0.25
                if self._open and can_take:
                    timeout = min(max(
                        min(x.deadline for x in self._open.values()) - now,
                        0.001), 0.25)
                # pipeline thread: no statement context to poll — members
                # poll their own contexts in submit()
                self._cv.wait(timeout)
        return None

    def _stage_loop(self) -> None:
        """Admission -> stage: pop flushable windows and stage them (the
        compile + admission + host data path), overlapping the
        dispatcher's device stage — batch k+1 stages while batch k runs
        on the device (the staging pool extended past a single
        statement)."""
        while not self._stop.is_set():
            try:
                b = self._take_window()
                if b is None:
                    return
                bt = Trace(-b.bid, f"batch {b.key[:300]}")
                b.trace = bt
                b.root_sid = bt.begin("batch-dispatch", cat="batch",
                                      batch=b.bid, width=len(b.members))
                TRACES.adopt(bt)
                try:
                    b.staged = self.db.executor.prepare_batch(
                        b.plan, b.consts, b.key, [m.pvec for m in b.members])
                except BaseException as e:
                    b.staged = None
                    b.stage_error = e
                finally:
                    TRACES.release(bt)
                self._dq.put(b)
                self._refresh_depth()
            except Exception:
                # the pipeline must survive anything — members time out
                # into the serial path rather than hang; no statement
                # runs on this thread, so there is nothing to poll
                time.sleep(0.01)

    def _dispatch_loop(self) -> None:
        """Dispatch -> fetch -> demux: run staged batches on the device
        one at a time and hand every member its slice."""
        while not self._stop.is_set():
            try:
                # pipeline thread: members poll their own contexts
                b = self._dq.get(timeout=0.25)
            except queue.Empty:
                continue
            # the staged queue just drained: wake the stager so the next
            # window flushes and stages WHILE this batch is on the device
            with self._cv:
                self._cv.notify_all()
            try:
                self._run_batch(b)
            except Exception:
                for m in b.members:
                    m.fallback = True
                    m.event.set()
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def _run_batch(self, b: _Batch) -> None:
        ex = self.db.executor
        bt = b.trace
        fell_back = False
        TRACES.adopt(bt)
        try:
            if b.staged is None:
                raise BatchFallback(f"stage failed: {b.stage_error!r}")
            comp, tables, compiler, compiled = b.staged
            mh_cm = self._mh_exchange(b)
            if mh_cm is not None:
                with mh_cm:
                    host = ex.dispatch_batch(comp, tables)
            else:
                host = ex.dispatch_batch(comp, tables)
            over = ex.batch_overflowed(comp, host)
            if over:
                # per-member capacity needs differ (value-dependent join
                # expansion / group counts): the serial path's tier
                # machinery owns the retry — never retry the whole batch
                raise BatchFallback(
                    f"overflow flags {over} at width {len(b.members)}")
            width = len(b.members)
            counters.inc("batch_dispatch_total")
            counters.inc("batch_members_total", width)
            histograms.observe("batch_width", float(width),
                               buckets=WIDTH_BUCKETS)
            for i, m in enumerate(b.members):
                cancelled = m.ctx is not None and m.ctx.cancelled
                with bt.span("batch-member", cat="batch", slot=i,
                             statement=(m.ctx.statement_id
                                        if m.ctx is not None else None),
                             cancelled=bool(cancelled)):
                    if cancelled:
                        # masked out at demux: the member's thread raises
                        # the typed cancellation; its batch-mates keep
                        # their results
                        m.masked = True
                        continue
                    try:
                        res = ex.demux_batch(comp, host, i, compiler)
                    except Exception:
                        m.fallback = True   # lone demux hiccup: serial
                        continue
                    res.stats.update(
                        batched=True, batch_id=b.bid, batch_width=width,
                        batch_bucket=comp.batch_width,
                        compiled=bool(compiled), segments=ex.nseg,
                        rows_out=len(res))
                    m.result = res
        except BatchFallback:
            counters.inc("batch_fallback_total")
            fell_back = True
        except BaseException:
            counters.inc("batch_fallback_total")
            fell_back = True
        finally:
            TRACES.release(bt)
            bt.end(b.root_sid)
            TRACES.retire(bt)
            self.recent.append(bt)
            if fell_back:
                for m in b.members:
                    m.fallback = True
            self._graft(b, bt)
            for m in b.members:
                m.event.set()
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()
            self._refresh_depth()

    def _mh_exchange(self, b: _Batch):
        """A context manager broadcasting this window to a multihost gang,
        or None on a single-host Database. The port has no multihost
        (ROADMAP Queue 1 item 8): always None."""
        return None

    # ---- bookkeeping --------------------------------------------------
    def _graft(self, b: _Batch, bt: Trace) -> None:
        """Copy the flush's span tree into every member's statement trace
        under its batch-wait span, re-based onto the member's clock — one
        flame graph shows the whole batch from any member's trace."""
        spans = bt.export()
        for m in b.members:
            if m.trace is None or m.wait_sid is None:
                continue
            try:
                base_ms = (bt.wall0 - m.trace.wall0) * 1e3
                m.trace.graft(spans, m.wait_sid, tid=f"batch-{b.bid}",
                              base_ms=base_ms)
            except Exception:
                pass   # a lost graft must never lose the statement

    def _refresh_depth(self) -> None:
        with self._mu:
            depth = sum(len(x.members) for x in self._open.values()) \
                + sum(len(x.members) for x in self._full)
        counters.set("batch_queue_depth", depth)
