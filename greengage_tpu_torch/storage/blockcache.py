"""Byte-accounted LRU block-cache registry — the bufmgr analog; the port's
copy of greengage_tpu/storage/blockcache.py.

Reference parity: the shared buffer pool (src/backend/storage/buffer/
bufmgr.c) gives every read path one bounded, recency-evicting cache with
hit/miss/eviction accounting. Every read-path cache of the port lives in
one registry per table store:

  - ``CacheRegistry`` owns one global byte budget (the ``scan_cache_limit_mb``
    setting, read live from the wired settings) shared by every named
    cache, scaled down by the brownout's cache factor
    (runtime/overload.py). Entries that live on a card (staged CUDA
    tensors) are held to a budget of their own, half the card's memory
    (``CARD_SHARE``), also scaled by the brownout: host and device memory
    are different resources, and a budget sized for decoded host blocks
    would restage a large table's columns on every warm statement.
  - ``BlockCache`` is one named member: an OrderedDict in recency order
    (every hit moves the entry to MRU), so the registry's eviction scan
    finds the GLOBAL least-recently-used entry by comparing each cache's
    head tick. The store's members are ``blocks`` (decoded block files),
    ``footers``, ``bidx`` (block indexes), ``prune`` (kept-block lists)
    and ``delmask`` (deletion-bitmap keep masks); the executor's are
    ``stage`` (staged device tensors) and ``dyn`` (join-driven partition
    selections).
  - Entries carry their byte size (``nbytes_of`` counts numpy arrays and
    torch tensors on either device exactly) and an optional manifest
    version tag; ``invalidate_versions(keep)`` drops every tagged entry of
    another version (a write, an index build, an expansion).
  - ``scan_cache_hit`` / ``scan_cache_miss`` / ``scan_cache_evict``
    counters land in runtime/logger, so EXPLAIN ANALYZE and tests assert
    cache behaviour without wall clocks.

An evicted entry's value is dropped from the registry: a staged CUDA tensor
goes back to the allocator once the last statement holding it ends.

Thread safety: one registry RLock covers every operation — the staging
pool hits these caches from many threads at once.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from greengage_tpu_torch.runtime import lockdebug, memaccount, overload
from greengage_tpu_torch.runtime.logger import counters

MISS = object()   # sentinel distinguishing "absent" from a cached None

DEFAULT_LIMIT_MB = 1024
# the share of a card's memory its staged tensors may keep; the rest is the
# statements' working memory
CARD_SHARE = 0.5


def nbytes_of(value) -> int:
    """Byte estimate of a cached value: numpy arrays report ``nbytes``,
    torch tensors ``element_size() * numel()`` (on either device),
    containers sum their members, scalars cost a token."""
    if hasattr(value, "element_size") and hasattr(value, "numel"):
        try:
            return int(value.element_size()) * int(value.numel()) + 64
        except (TypeError, ValueError, RuntimeError):
            pass
    nb = getattr(value, "nbytes", None)
    if nb is not None:
        try:
            return int(nb) + 64
        except (TypeError, ValueError):
            pass
    if isinstance(value, (tuple, list)):
        return 64 + sum(nbytes_of(v) for v in value)
    if isinstance(value, dict):
        return 64 + sum(nbytes_of(v) for v in value.values())
    if isinstance(value, (str, bytes)):
        return 64 + len(value)
    return 64


def on_card(value) -> bool:
    """True for a value held in a card's memory (a CUDA tensor): it is
    held to the card's budget."""
    return bool(getattr(value, "is_cuda", False))


class BlockCache:
    """One named cache inside a registry. All mutation happens under the
    registry lock; entries are [value, nbytes, version, tick, on_card]."""

    def __init__(self, registry: "CacheRegistry", name: str):
        self.registry = registry
        self.name = name
        # access-witnessed under the race witness: every touch must hold
        # the registry lock
        self._d: OrderedDict = lockdebug.shared(OrderedDict(),
                                                f"blockcache.{name}._d")
        self.bytes = 0
        self.card_n = 0   # entries on a card

    # -- reads ----------------------------------------------------------
    def get(self, key, default=None):
        reg = self.registry
        with reg._lock:
            ent = self._d.get(key)
            if ent is None:
                counters.inc("scan_cache_miss")
                return default
            self._d.move_to_end(key)
            ent[3] = reg._next_tick()
            counters.inc("scan_cache_hit")
            return ent[0]

    def peek(self, key, default=None):
        """Read without touching recency or hit/miss counters."""
        with self.registry._lock:
            ent = self._d.get(key)
            return default if ent is None else ent[0]

    def __contains__(self, key) -> bool:
        with self.registry._lock:
            return key in self._d

    def __len__(self) -> int:
        with self.registry._lock:
            return len(self._d)

    def keys(self) -> list:
        with self.registry._lock:
            return list(self._d.keys())

    def __iter__(self):
        return iter(self.keys())

    # -- writes ---------------------------------------------------------
    def put(self, key, value, nbytes: int | None = None,
            version: int | None = None) -> None:
        nb = nbytes_of(value) if nbytes is None else int(nbytes) + 64
        card = on_card(value)
        reg = self.registry
        with reg._lock:
            old = self._d.pop(key, None)
            if old is not None:
                reg._unlink(self, old)
            if nb > (reg.card_limit_bytes() if card else reg.limit_bytes()):
                # an entry bigger than the WHOLE budget can never be
                # resident: refuse it rather than evicting every other
                # cache's warm state on its behalf and then evicting it
                return
            self._d[key] = [value, nb, version, reg._next_tick(), card]
            self.bytes += nb
            self.card_n += card
            reg._total += nb
            reg._card_total += nb if card else 0
            if version is not None:
                reg._versions[version] = reg._versions.get(version, 0) + 1
            reg._evict_to_fit()
        # memory accounting (runtime/memaccount.py): the bytes this
        # statement inserted into the shared cache go to its 'blockcache'
        # owner, charged OUTSIDE the registry lock so the account lock
        # never nests under it. Pool threads reach here bound to the
        # statement's account.
        memaccount.charge("blockcache", nb, item=self.name)

    def pop(self, key, default=None):
        with self.registry._lock:
            ent = self._d.pop(key, None)
            if ent is None:
                return default
            self.registry._unlink(self, ent)
            return ent[0]

    def clear(self) -> None:
        self.drop(lambda k: True)

    def drop(self, pred) -> int:
        """Remove entries whose KEY satisfies ``pred``; -> count removed."""
        with self.registry._lock:
            victims = [k for k in self._d if pred(k)]
            for k in victims:
                self.registry._unlink(self, self._d.pop(k))
            return len(victims)


class CacheRegistry:
    """Shared byte budget + global-LRU eviction over named BlockCaches."""

    def __init__(self, limit_mb: int | None = None):
        self._lock = lockdebug.named(threading.RLock(),
                                     "blockcache.registry._lock")
        self._caches: dict[str, BlockCache] = {}
        self._tick = 0
        self._total = 0
        self._card_total = 0          # the bytes of entries on a card
        self._versions: dict = {}     # version tag -> entries carrying it
        self._limit_mb = limit_mb
        # wired by the session (Database.__init__); read live so
        # SET scan_cache_limit_mb applies to the next eviction decision
        self.settings = None
        # the card's memory in bytes, wired by a session on a card: the
        # default budget of the entries held there
        self.card_bytes: int | None = None

    def cache(self, name: str) -> BlockCache:
        with self._lock:
            c = self._caches.get(name)
            if c is None:
                c = self._caches[name] = BlockCache(self, name)
            return c

    def limit_bytes(self) -> int:
        mb = None
        if self.settings is not None:
            mb = getattr(self.settings, "scan_cache_limit_mb", None)
        if mb is None:
            mb = self._limit_mb if self._limit_mb is not None \
                else DEFAULT_LIMIT_MB
        return self._scaled(max(int(mb), 1) << 20)

    def card_limit_bytes(self) -> int:
        """The budget of the entries on a card: ``CARD_SHARE`` of its
        memory (the host budget where no card was wired), scaled by the
        brownout like the host one."""
        if not self.card_bytes:
            return self.limit_bytes()
        return self._scaled(int(self.card_bytes * CARD_SHARE))

    @staticmethod
    def _scaled(base: int) -> int:
        # memory-pressure brownout (runtime/overload.py): under device
        # pressure the budgets shrink by the brownout cache factor, read
        # live like the settings themselves
        factor = overload.CONTROLLER.cache_factor()
        if factor >= 1.0:
            return base
        return max(int(base * factor), 1 << 20)

    def evict_to_fit(self) -> None:
        """Public eviction-to-budget pass: applied on a brownout
        transition edge so the shrunken budget frees bytes NOW instead of
        at the next insert."""
        with self._lock:
            self._evict_to_fit()

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._total

    @property
    def card_total_bytes(self) -> int:
        """The bytes of the entries on a card (within ``total_bytes``)."""
        with self._lock:
            return self._card_total

    def _unlink(self, cache: BlockCache, ent: list) -> None:
        """Account an entry just removed from ``cache``."""
        cache.bytes -= ent[1]
        cache.card_n -= ent[4]
        self._total -= ent[1]
        if ent[4]:
            self._card_total -= ent[1]
        if ent[2] is not None:
            left = self._versions[ent[2]] - 1
            if left:
                self._versions[ent[2]] = left
            else:
                del self._versions[ent[2]]

    def _next_tick(self) -> int:
        self._tick += 1
        return self._tick

    def _evict_to_fit(self) -> None:
        """Evict the GLOBALLY least-recent entry of a pool (the host's, the
        card's) until the pool is under its budget. Each cache's
        OrderedDict is in recency order, so a pool's global LRU is the
        minimum tick over each cache's oldest entry of that pool — a
        member holds one pool's entries, so that entry is its head."""
        for on_card, limit in ((False, self.limit_bytes()),
                               (True, self.card_limit_bytes())):
            while (self._card_total if on_card
                   else self._total - self._card_total) > limit:
                best = None
                for c in self._caches.values():
                    if (c.card_n if on_card else len(c._d) - c.card_n) == 0:
                        continue
                    for k, ent in c._d.items():
                        if ent[4] == on_card:
                            if best is None or ent[3] < best[2]:
                                best = (c, k, ent[3])
                            break
                if best is None:
                    break   # nothing left to evict
                c, k, _ = best
                self._unlink(c, c._d.pop(k))
                counters.inc("scan_cache_evict")

    def invalidate_versions(self, keep_version: int) -> int:
        """Drop every version-tagged entry of another manifest version;
        untagged entries (immutable committed files) stay. -> count
        removed. Every statement calls it: with no entry of another
        version it returns without a scan."""
        removed = 0
        with self._lock:
            if not any(v != keep_version for v in self._versions):
                return 0
            for c in self._caches.values():
                victims = [k for k, ent in c._d.items()
                           if ent[2] is not None and ent[2] != keep_version]
                for k in victims:
                    self._unlink(c, c._d.pop(k))
                removed += len(victims)
        return removed

    def clear(self) -> None:
        with self._lock:
            for c in self._caches.values():
                c.clear()

    def stats(self) -> dict:
        with self._lock:
            return {
                "total_bytes": self._total,
                "limit_bytes": self.limit_bytes(),
                "card_total_bytes": self._card_total,
                "card_limit_bytes": self.card_limit_bytes(),
                "caches": {n: {"entries": len(c._d), "bytes": c.bytes}
                           for n, c in self._caches.items()},
            }
