"""Statement tracing — the port's copy of greengage_tpu/runtime/trace.py,
the span substrate of gpperfmon's query-detail role, packaged as Chrome
``trace_event`` JSON.

One ``Trace`` is opened per executing statement (keyed by thread, exactly
like the interrupt registry: one server connection = one thread = one
backend) and every host-side phase records a span into it:

    statement
      parse / paramize / plan
      admission                    (resource group and queue waits)
      compile                      (the plan lowered to a program)
      stage                        (host data path and the copies to the
                                    device)
      dispatch                     (the program, up to the host's read of
                                    its flags: a span around device work
                                    ends where the host waits for it)
      fetch                        (the Gather and the result's copy)
      spill-pass                   (spill passes, exec/spill.py)
      batch-wait                   (a batched-serving member's wait, with
                                    the batch's own trace grafted below)

Spans carry wall-clock-relative start/duration in ms plus a small args
payload (bytes, rows, tiers). Recording one span is two monotonic reads
and one dict append under a lock — cheap enough for every hot path (the
tests bound the overhead at <5% of a warm cached statement).

``graft`` adopts another trace's exported spans under a span of this one
(re-based onto its clock): the batch server grafts each flush's trace
into every member's statement trace. The JAX package also grafts
multihost workers' spans that way; the port has no multihost until
ROADMAP Queue 1 item 8.

Completed traces land in a bounded ring (``trace_ring_size`` GUC) indexed
by statement id; ``to_chrome()`` renders the ``trace_event`` JSON that
chrome://tracing and Perfetto load directly.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager

# runaway guards: a pathological statement (thousands of spill passes)
# must degrade to a truncated trace, never to unbounded memory
MAX_SPANS = 4096
MAX_GRAFT_SPANS = 1024

# live device-memory sampler (a Database on a card installs one reading
# the allocator's allocated bytes): called at the boundaries of the spans
# of MEM_CATS, so each carries the device's allocated bytes and their
# delta. None until installed, so spans on the CPU stay clean. A hook
# (not an import) so this substrate stays dependency-free.
MEM_SAMPLER = None


# the span categories whose spans move device memory: only these sample
# it, so a warm statement pays for a handful of reads, not one per span
MEM_CATS = frozenset({"statement", "stage", "device", "spill", "batch"})


def set_mem_sampler(fn) -> None:
    global MEM_SAMPLER
    MEM_SAMPLER = fn

_JSON_SCALARS = (bool, int, float, str, type(None))


def _safe_args(args: dict) -> dict:
    """Coerce a span payload to JSON-safe scalars (numpy ints etc. arrive
    from executor stats)."""
    out = {}
    for k, v in (args or {}).items():
        if isinstance(v, bool) or v is None or isinstance(v, str):
            out[k] = v
        elif isinstance(v, (int, float)):
            out[k] = v
        else:
            try:
                out[k] = v.item()   # numpy scalar
            except Exception:
                out[k] = str(v)
    return out


class Trace:
    """One statement's span tree. Thread-safe: the statement thread, the
    coordinator's ack-collection path, and (via explicit handles) pool
    threads may all record concurrently."""

    def __init__(self, trace_id: int, sql: str):
        self.trace_id = trace_id
        self.sql = (sql or "").strip()[:500]
        self.t0 = time.monotonic()
        self.wall0 = time.time()
        self.dur_ms: float | None = None   # set when the registry retires it
        self.depth = 1                     # nested sql() calls share it
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._spans: list[dict] = []
        self._by_id: dict[int, dict] = {}
        self._stacks: dict[int, list[int]] = {}   # thread ident -> open sids

    # ---- recording -----------------------------------------------------
    def begin(self, name: str, cat: str = "exec", **args) -> int:
        ts = (time.monotonic() - self.t0) * 1e3
        tid = threading.get_ident()
        if MEM_SAMPLER is not None and cat in MEM_CATS:
            hbm = MEM_SAMPLER()   # device watermark at span entry
            if hbm is not None:
                args["hbm_bytes"] = hbm
        with self._lock:
            if len(self._spans) >= MAX_SPANS:
                return -1
            sid = next(self._ids)
            stack = self._stacks.setdefault(tid, [])
            span = {
                "id": sid,
                "parent": stack[-1] if stack else None,
                "name": name,
                "cat": cat,
                "tid": threading.current_thread().name,
                "ts": round(ts, 3),
                "dur": None,
                "args": _safe_args(args),
            }
            self._spans.append(span)
            self._by_id[sid] = span
            stack.append(sid)
        return sid

    def end(self, sid: int, **args) -> None:
        if sid is None or sid < 0:
            return
        now = (time.monotonic() - self.t0) * 1e3
        opened = self._by_id.get(sid)   # one dict read: atomic
        hbm = (MEM_SAMPLER() if MEM_SAMPLER is not None and opened is not None
               and "hbm_bytes" in opened["args"] else None)
        with self._lock:
            span = self._by_id.get(sid)
            if span is None:
                return
            if hbm is not None:
                # device-memory delta across the span (which phase grew
                # or shrank device memory — the data-movement lens)
                span["args"]["hbm_end_bytes"] = hbm
                if "hbm_bytes" in span["args"]:
                    span["args"]["hbm_delta"] = hbm - span["args"]["hbm_bytes"]
            span["dur"] = round(now - span["ts"], 3)
            if args:
                span["args"].update(_safe_args(args))
            stack = self._stacks.get(threading.get_ident())
            if stack and sid in stack:
                del stack[stack.index(sid):]

    def annotate(self, sid: int, **args) -> None:
        """Attach payload to an open (or closed) span after the fact."""
        if sid is None or sid < 0:
            return
        with self._lock:
            span = self._by_id.get(sid)
            if span is not None:
                span["args"].update(_safe_args(args))

    @contextmanager
    def span(self, name: str, cat: str = "exec", **args):
        sid = self.begin(name, cat, **args)
        try:
            yield sid
        finally:
            self.end(sid)

    # ---- introspection -------------------------------------------------
    def open_span(self) -> tuple[str, float] | None:
        """(name, elapsed_ms) of the deepest still-open span — the
        per-statement phase column of an activity listing."""
        now = (time.monotonic() - self.t0) * 1e3
        with self._lock:
            for span in reversed(self._spans):
                if span["dur"] is None:
                    return span["name"], max(now - span["ts"], 0.0)
        return None

    def export(self, limit: int = MAX_SPANS) -> list[dict]:
        """Span records with ts relative to this trace's start (what a
        worker ships in its completion ack). Open spans export with their
        elapsed-so-far duration."""
        now = (time.monotonic() - self.t0) * 1e3
        with self._lock:
            out = []
            for span in self._spans[:limit]:
                s = dict(span)
                s["args"] = dict(span["args"])
                if s["dur"] is None:
                    s["dur"] = round(max(now - s["ts"], 0.0), 3)
                out.append(s)
            return out

    def graft(self, spans: list[dict], parent_sid: int, tid: str,
              base_ms: float | None = None) -> None:
        """Adopt another trace's exported spans as children of
        ``parent_sid`` (the dispatch span), re-based onto its clock —
        or onto an explicit ``base_ms`` offset from THIS trace's start
        (the batched-serving graft, whose donor trace started on its own
        clock rather than inside the parent span)."""
        if not spans:
            return
        with self._lock:
            base = 0.0
            if base_ms is not None:
                base = float(base_ms)
            else:
                pspan = self._by_id.get(parent_sid)
                if pspan is not None:
                    base = pspan["ts"]
            idmap: dict = {}
            for s in spans[:MAX_GRAFT_SPANS]:
                if len(self._spans) >= MAX_SPANS:
                    break
                try:
                    sid = next(self._ids)
                    rec = {
                        "id": sid,
                        "parent": idmap.get(s.get("parent"), parent_sid),
                        "name": str(s.get("name", "?")),
                        "cat": str(s.get("cat", "exec")),
                        "tid": tid,
                        "ts": round(base + float(s.get("ts", 0.0)), 3),
                        "dur": round(float(s.get("dur") or 0.0), 3),
                        "args": _safe_args(s.get("args") or {}),
                    }
                except (TypeError, ValueError):
                    continue   # a garbled span must not lose the trace
                idmap[s.get("id")] = sid
                self._spans.append(rec)
                self._by_id[sid] = rec

    def find_spans(self, name: str) -> list[dict]:
        with self._lock:
            return [dict(s) for s in self._spans if s["name"] == name]


class _NullSpan:
    """Absent-trace stand-in so hot paths can unconditionally `with`."""

    def __enter__(self):
        return -1

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class TraceRegistry:
    """Process-wide registry: in-flight traces keyed by thread (one
    statement per connection thread) plus the bounded completed ring."""

    def __init__(self, ring_size: int = 64):
        self._lock = threading.Lock()
        self._by_thread: dict[int, Trace] = {}
        self._ring: OrderedDict[int, Trace] = OrderedDict()
        self.ring_size = ring_size
        self._ids = itertools.count(1)

    def enter(self, trace_id: int | None, sql: str, enabled: bool = True,
              ring_size: int | None = None) -> tuple[Trace | None, bool]:
        """Open (or re-enter) the calling thread's trace. Nested sql()
        calls share the outermost trace. -> (trace | None, is_outermost);
        None when tracing is disabled and no outer trace exists."""
        if ring_size is not None and ring_size > 0:
            self.ring_size = int(ring_size)
        tid = threading.get_ident()
        with self._lock:
            cur = self._by_thread.get(tid)
            if cur is not None:
                cur.depth += 1
                return cur, False
            if not enabled:
                return None, True
            tr = Trace(trace_id if trace_id is not None else -next(self._ids),
                       sql)
            self._by_thread[tid] = tr
            return tr, True

    def exit(self, trace: Trace | None) -> None:
        if trace is None:
            return
        tid = threading.get_ident()
        with self._lock:
            cur = self._by_thread.get(tid)
            if cur is None:
                return
            cur.depth -= 1
            if cur.depth > 0:
                return
            del self._by_thread[tid]
            cur.dur_ms = (time.monotonic() - cur.t0) * 1e3
            self._ring[cur.trace_id] = cur
            while len(self._ring) > max(self.ring_size, 1):
                self._ring.popitem(last=False)

    def current(self) -> Trace | None:
        return self._by_thread.get(threading.get_ident())

    # ---- pipeline-thread adoption (exec/batchserve.py) ---------------
    # The batched-serving pipeline threads are not statement threads:
    # they carry a standalone per-flush Trace so the executor's span
    # calls (module-level span()) land in it while a batch stages or
    # dispatches, and the finished trace is grafted into every member's
    # statement trace + retired into the ring under its own (negative)
    # id, where ``get`` finds it directly.
    def adopt(self, trace: Trace) -> None:
        """Make ``trace`` the calling thread's current trace (no nesting
        bookkeeping — pipeline threads adopt exactly one at a time)."""
        with self._lock:
            self._by_thread[threading.get_ident()] = trace

    def release(self, trace: Trace) -> None:
        """Drop the calling thread's adopted trace (only if still it)."""
        tid = threading.get_ident()
        with self._lock:
            if self._by_thread.get(tid) is trace:
                del self._by_thread[tid]

    def retire(self, trace: Trace) -> None:
        """Park a finished standalone trace in the completed ring."""
        with self._lock:
            trace.dur_ms = (time.monotonic() - trace.t0) * 1e3
            self._ring[trace.trace_id] = trace
            while len(self._ring) > max(self.ring_size, 1):
                self._ring.popitem(last=False)

    def get(self, trace_id: int) -> Trace | None:
        """In-flight first (any thread), then the ring."""
        with self._lock:
            for tr in self._by_thread.values():
                if tr.trace_id == trace_id:
                    return tr
            return self._ring.get(trace_id)

    def last(self) -> Trace | None:
        with self._lock:
            if not self._ring:
                return None
            return next(reversed(self._ring.values()))

    def active_span(self, trace_id: int) -> tuple[str, float] | None:
        """(current span name, elapsed ms) of an IN-FLIGHT statement —
        the activity listing's phase column; None when idle or unknown."""
        with self._lock:
            trs = [t for t in self._by_thread.values()
                   if t.trace_id == trace_id]
        for tr in trs:
            sp = tr.open_span()
            if sp is not None:
                return sp
        return None


TRACES = TraceRegistry()   # process-wide (shmem gpperfmon agent analog)


@contextmanager
def span(name: str, cat: str = "exec", **args):
    """Record a span on the calling thread's current trace; a cheap no-op
    when no trace is open (tracing disabled, untraced worker threads)."""
    tr = TRACES.current()
    if tr is None:
        yield -1
        return
    sid = tr.begin(name, cat, **args)
    try:
        yield sid
    finally:
        tr.end(sid)


def annotate(sid: int, **args) -> None:
    tr = TRACES.current()
    if tr is not None:
        tr.annotate(sid, **args)


def to_chrome(trace: Trace) -> dict:
    """Chrome ``trace_event`` JSON (the object form: {"traceEvents": []}).
    Span ids/parents ride in each event's args so tests (and humans) can
    rebuild the tree without duration-containment heuristics."""
    events = []
    tid_ids: dict[str, int] = {}
    for s in trace.export():
        t = tid_ids.setdefault(s["tid"], len(tid_ids) + 1)
        events.append({
            "name": s["name"],
            "cat": s["cat"],
            "ph": "X",
            "ts": round(s["ts"] * 1000.0, 1),        # microseconds
            "dur": round((s["dur"] or 0.0) * 1000.0, 1),
            "pid": 1,
            "tid": t,
            "args": {**s["args"], "span_id": s["id"],
                     "parent": s["parent"]},
        })
    meta = [{"name": "thread_name", "ph": "M", "pid": 1, "tid": t,
             "args": {"name": name}} for name, t in tid_ids.items()]
    meta.append({"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
                 "args": {"name": "greengage_tpu_torch"}})
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "trace_id": trace.trace_id,
            "sql": trace.sql,
            "started_unix_s": round(trace.wall0, 3),
            "duration_ms": (None if trace.dur_ms is None
                            else round(trace.dur_ms, 3)),
        },
    }
