"""Measured memory accounting — the port's copy of
greengage_tpu/runtime/memaccount.py (the vmem_tracker.c + memaccounting.c
analog).

  * ``MemoryAccount`` — one per-statement owner tree (thread-keyed in
    ``ACCOUNTS``, like the interrupt and trace registries; the account id
    is the statement id). Owners are the fixed taxonomy in ``OWNERS``:
    host ``staging`` buffers, ``blockcache`` inserts (charged once the
    block cache arrives with durable storage, ROADMAP Queue 1 item 1a),
    ``spill`` captures and the program's ``device`` footprint. Charges
    from staging-pool threads ride an explicit ``bind()``.
  * measured programs — torch has no analysis of a program before it
    runs, so the executor measures the first launch of each cached
    program on the card (exec/executor.py ``_measure``): the staged
    inputs' bytes, the outputs' bytes and the allocator's peak above what
    was allocated before the launch. ``peak_begin`` / ``peak_read`` read
    the allocator; ``device_work`` marks every section of device work, so
    a measurement is kept only when no other statement's device work ran
    beside it (the peak counter is process-wide).
  * live device watermarks — ``device_memory_stats()`` reads the caching
    allocator's counters through the raw ``torch._C._cuda_memoryStats``
    (``torch.cuda.memory_stats`` flattens every statistic first: 182 us a
    call against 11.8 us on an H100, PERF.md section 5) and the card's
    total memory, read once; None when no
    card is visible, as on the JAX CPU backend. ``sample_watermark`` is
    the trace substrate's span sampler, so span args carry the allocated
    bytes and their delta.
  * OOM forensics — ``is_oom_error()`` classifies ``torch.OutOfMemoryError``
    ("CUDA out of memory. Tried to allocate ...") and the JAX package's
    RESOURCE_EXHAUSTED text; the executor raises a typed
    ``OutOfDeviceMemory`` carrying the statement's accounting snapshot.

Process-wide surfaces: per-owner live-byte gauges
(``mem_owner_bytes_<owner>``), device gauges (``device_bytes_in_use`` /
``device_peak_bytes_in_use``), host process gauges (RSS, open fds, the
staging pool's queue depth), all in the server's ``metrics`` op; its
``mem`` op serves ``report()``.
"""

from __future__ import annotations

import os
import resource
import sys
import threading
from collections import OrderedDict
from contextlib import contextmanager

import torch

from greengage_tpu_torch.runtime import trace as _trace
from greengage_tpu_torch.runtime.logger import counters

# fixed owner taxonomy: charges outside it would be invisible to the
# per-owner gauges, so charge() rejects them rather than lose bytes
OWNERS = ("staging", "blockcache", "spill", "device")

# a statement staging many tables degrades to a truncated item map
MAX_ITEMS_PER_OWNER = 64


class MemoryAccount:
    """One statement's per-owner memory tree. Thread-safe: the statement
    thread and its bound pool threads charge concurrently."""

    def __init__(self, statement_id: int, sql: str = ""):
        self.statement_id = statement_id
        self.sql = (sql or "").strip()[:200]
        self.depth = 1            # nested sql() calls share it
        self._lock = threading.Lock()
        # set when the registry retires the account: a straggler pool
        # thread's late charge must not add live bytes the exit already
        # subtracted
        self._closed = False
        # owner -> [current bytes, peak bytes, {item: bytes}]
        self._owners: dict[str, list] = {}

    def charge(self, owner: str, nbytes: int, item: str | None = None) -> None:
        if owner not in OWNERS:
            raise ValueError(f"unknown memory owner {owner!r} "
                             f"(taxonomy: {OWNERS})")
        nbytes = int(nbytes)
        with self._lock:
            if self._closed:
                return
            ent = self._owners.get(owner)
            if ent is None:
                ent = self._owners[owner] = [0, 0, {}]
            ent[0] += nbytes
            ent[1] = max(ent[1], ent[0])
            if item is not None:
                items = ent[2]
                if item in items or len(items) < MAX_ITEMS_PER_OWNER:
                    items[item] = items.get(item, 0) + nbytes
                else:
                    items["<other>"] = items.get("<other>", 0) + nbytes
            _owner_live_add(owner, nbytes)

    def set_device(self, analysis: dict | None, est_bytes: int = 0) -> None:
        """Record the program's device footprint: its measurement when one
        exists, the compiled estimate otherwise (items mark which)."""
        with self._lock:
            if self._closed:
                return
            ent = self._owners.get("device")
            if ent is None:
                ent = self._owners["device"] = [0, 0, {}]
            old = ent[0]
            if analysis:
                total = (analysis.get("argument_bytes", 0)
                         + analysis.get("temp_bytes", 0)
                         + analysis.get("output_bytes", 0))
                ent[2] = {"args": analysis.get("argument_bytes", 0),
                          "temp": analysis.get("temp_bytes", 0),
                          "output": analysis.get("output_bytes", 0)}
            else:
                total = int(est_bytes)
                ent[2] = {"estimate": total}
            ent[0] = total
            ent[1] = max(ent[1], total)
            _owner_live_add("device", ent[0] - old)

    def close(self) -> None:
        """Retire the account: refuse further charges and release its live
        bytes from the process-wide owner totals."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for owner, ent in self._owners.items():
                _owner_live_add(owner, -ent[0])

    def owner_totals(self) -> dict[str, int]:
        with self._lock:
            return {o: ent[0] for o, ent in self._owners.items()}

    def total_bytes(self) -> int:
        with self._lock:
            return sum(ent[0] for ent in self._owners.values())

    def snapshot(self) -> dict:
        """The full per-owner tree: what an OOM and the ``mem`` op carry."""
        with self._lock:
            owners = {o: {"bytes": ent[0], "peak_bytes": ent[1],
                          "items": dict(ent[2])}
                      for o, ent in self._owners.items()}
        return {"statement_id": self.statement_id, "sql": self.sql,
                "owners": owners,
                "total_bytes": sum(o["bytes"] for o in owners.values())}


class AccountRegistry:
    """Process-wide registry: in-flight accounts keyed by thread, plus a
    small ring of completed ones."""

    RING = 16

    def __init__(self):
        self._lock = threading.Lock()
        self._by_thread: dict[int, MemoryAccount] = {}
        self._ring: OrderedDict[int, dict] = OrderedDict()

    def enter(self, statement_id: int, sql: str = "",
              enabled: bool = True) -> tuple[MemoryAccount | None, bool]:
        """Open (or re-enter) the calling thread's account; nested sql()
        calls share the outermost one. -> (account | None, is_outermost)."""
        tid = threading.get_ident()
        with self._lock:
            cur = self._by_thread.get(tid)
            if cur is not None:
                cur.depth += 1
                return cur, False
            if not enabled:
                return None, True
            acct = MemoryAccount(statement_id, sql)
            self._by_thread[tid] = acct
            return acct, True

    def exit(self, acct: MemoryAccount | None) -> None:
        if acct is None:
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
            self._ring[cur.statement_id] = cur.snapshot()
            while len(self._ring) > self.RING:
                self._ring.popitem(last=False)
        cur.close()

    def current(self) -> MemoryAccount | None:
        with self._lock:
            return self._by_thread.get(threading.get_ident())

    @contextmanager
    def bind(self, acct: MemoryAccount | None):
        """Register a pool thread against a statement's account for one
        read unit, so its charges attribute to the statement."""
        if acct is None:
            yield
            return
        tid = threading.get_ident()
        with self._lock:
            prev = self._by_thread.get(tid)
            self._by_thread[tid] = acct
        try:
            yield
        finally:
            with self._lock:
                if prev is None:
                    self._by_thread.pop(tid, None)
                else:
                    self._by_thread[tid] = prev

    def snapshot(self) -> list[dict]:
        with self._lock:
            # one row per account: bound pool threads map to their
            # statement's account
            accts = list({id(a): a for a in self._by_thread.values()}
                         .values())
        return [a.snapshot() for a in accts]

    def ring(self) -> list[dict]:
        with self._lock:
            return list(self._ring.values())


ACCOUNTS = AccountRegistry()


def charge(owner: str, nbytes: int, item: str | None = None) -> None:
    """Charge the calling thread's current account; a no-op when
    accounting is off or the thread runs no statement."""
    acct = ACCOUNTS.current()
    if acct is not None:
        acct.charge(owner, nbytes, item)


# ---- process-wide per-owner live totals (the gauge source) -------------
_owner_mu = threading.Lock()
_OWNER_LIVE: dict[str, int] = {}


def _owner_live_add(owner: str, nbytes: int) -> None:
    with _owner_mu:
        _OWNER_LIVE[owner] = _OWNER_LIVE.get(owner, 0) + int(nbytes)


def owner_live_bytes() -> dict[str, int]:
    with _owner_mu:
        return {o: max(n, 0) for o, n in _OWNER_LIVE.items()}


# ---- the card's allocator ----------------------------------------------
_dev_mu = threading.Lock()
_card_info = None   # (index, total bytes), False when no card is visible


def _card() -> tuple[int, int] | None:
    """(index, total memory) of the process's current card, resolved once;
    None when no card is visible."""
    global _card_info
    with _dev_mu:
        if _card_info is None:
            if not torch.cuda.is_available():
                _card_info = False
            else:
                idx = torch.cuda.current_device()
                _card_info = (idx, int(torch.cuda.get_device_properties(
                    idx).total_memory))
        return _card_info or None


def _allocated(idx: int) -> dict:
    return torch._C._cuda_memoryStats(idx)["allocated_bytes"]["all"]


def device_memory_stats() -> dict | None:
    """The card's allocator counters: ``bytes_in_use`` (allocated bytes,
    not the cache the allocator keeps reserved), ``peak_bytes_in_use``
    and ``bytes_limit`` (the card's memory); None when no card is
    visible."""
    card = _card()
    if card is None:
        return None
    try:
        a = _allocated(card[0])
    except RuntimeError:
        return None
    return {"bytes_in_use": int(a["current"]),
            "peak_bytes_in_use": int(a["peak"]), "bytes_limit": card[1]}


def peak_begin(device) -> int | None:
    """Start a peak reading on ``device``: reset the allocator's peak
    counter. -> the bytes allocated now; None where no allocator is read
    (a CPU device)."""
    card = _card() if torch.device(device).type == "cuda" else None
    if card is None:
        return None
    torch._C._cuda_resetPeakMemoryStats(card[0])
    return int(_allocated(card[0])["current"])


def peak_read(device) -> int | None:
    """The allocator's peak since ``peak_begin(device)``."""
    card = _card() if torch.device(device).type == "cuda" else None
    if card is None:
        return None
    return int(_allocated(card[0])["peak"])


# device work in flight: a program's measured peak is its own only when no
# other statement's staging or program ran beside it
_work_mu = threading.Lock()
_work_active = 0      # sections of device work in flight
_work_epoch = 0       # sections started so far


@contextmanager
def device_work():
    """Mark a section of device work (a statement's staging and program, a
    batch's)."""
    global _work_active, _work_epoch
    with _work_mu:
        _work_active += 1
        _work_epoch += 1
    try:
        yield
    finally:
        with _work_mu:
            _work_active -= 1


def exclusive_epoch() -> int | None:
    """Inside a ``device_work`` section: the current epoch when this
    section is the only one in flight, else None."""
    with _work_mu:
        return _work_epoch if _work_active == 1 else None


def still_exclusive(epoch: int) -> bool:
    """No other section started or ran since ``exclusive_epoch()``."""
    with _work_mu:
        return _work_active == 1 and _work_epoch == epoch


def sample_watermark() -> int | None:
    """One live sample -> allocated bytes (None with no card). Updates the
    device gauges; installed as the trace substrate's span sampler."""
    stats = device_memory_stats()
    if stats is None:
        return None
    used = stats["bytes_in_use"]
    counters.set("device_bytes_in_use", used)
    counters.set("device_peak_bytes_in_use", stats["peak_bytes_in_use"])
    return used


_trace.set_mem_sampler(sample_watermark)


# ---- OOM classification ------------------------------------------------
# no bare "oom" marker: it substring-matches "bloom"
_OOM_MARKERS = ("resource_exhausted", "resource exhausted", "out of memory",
                "out_of_memory", "allocation failure")


def is_oom_error(e: BaseException) -> bool:
    """Does this exception look like a device allocation failure? torch
    raises ``torch.OutOfMemoryError`` ("CUDA out of memory. Tried to
    allocate ..."); the JAX package's backends say RESOURCE_EXHAUSTED."""
    if isinstance(e, torch.OutOfMemoryError):
        return True
    s = f"{type(e).__name__}: {e}".lower()
    return any(m in s for m in _OOM_MARKERS)


# ---- host process gauges -----------------------------------------------
def _current_rss_bytes() -> int:
    """Current resident set from /proc/self/statm; elsewhere getrusage's
    lifetime peak (KB on Linux, bytes on Darwin)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * (os.sysconf("SC_PAGE_SIZE") or 4096)
    except (OSError, ValueError, IndexError):
        ru = resource.getrusage(resource.RUSAGE_SELF)
        scale = 1 if sys.platform == "darwin" else 1024
        return int(ru.ru_maxrss) * scale


def update_process_gauges() -> dict:
    """Refresh the host gauges right before an exposition: RSS, open fds,
    the staging pool's queue depth, the per-owner live totals."""
    from greengage_tpu_torch.exec import staging as _staging

    out: dict = {}
    try:
        out["host_rss_bytes"] = _current_rss_bytes()
        counters.set("host_rss_bytes", out["host_rss_bytes"])
    except OSError:
        pass
    try:
        nfds = len(os.listdir("/proc/self/fd"))
        out["host_open_fds"] = nfds
        counters.set("host_open_fds", nfds)
    except OSError:
        pass
    depth = _staging.pool_queue_depth()
    out["staging_pool_queue_depth"] = depth
    counters.set("staging_pool_queue_depth", depth)
    for owner, n in owner_live_bytes().items():
        counters.set(f"mem_owner_bytes_{owner}", n)
        out[f"mem_owner_bytes_{owner}"] = n
    return out


# ---- the mem op's report -----------------------------------------------
def report(db=None) -> dict:
    """Live device stats, in-flight and recent accounting trees, the
    runaway tracker's ledger, host gauges and, for a Database, each
    cached program's estimate beside its measurement."""
    from greengage_tpu_torch.runtime.runaway import TRACKER

    out = {
        "device": device_memory_stats(),
        "process": update_process_gauges(),
        "in_flight": ACCOUNTS.snapshot(),
        "recent": ACCOUNTS.ring(),
        "vmem_tracker": TRACKER.snapshot(),
    }
    if db is not None:
        out["executables"] = executable_mem_summary(db.executor)
    return out


def executable_mem_summary(executor) -> list[dict]:
    """Per cached program: the statement key, the compiled estimate and
    the measurement (None until a launch was measured)."""
    with executor._cache_mu:
        progs = list(executor._programs.items())
    return [{"statement": str(key[0])[:120],
             "est_bytes": int(p.est_bytes),
             "measured": (dict(p.mem_analysis) if p.mem_analysis else None)}
            for key, p in progs]
