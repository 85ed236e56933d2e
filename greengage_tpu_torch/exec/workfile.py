"""Tiered spill workfile: host RAM, then compressed files — the port's
counterpart of greengage_tpu/exec/workfile.py.

  - every captured pass lands in the HOST-RAM tier, counted in the
    ``spill_tier_ram_bytes`` gauge and the statement's 'spill' owner
    (runtime/memaccount.py);
  - once a statement's retained passes exceed ``spill_host_limit_mb`` the
    COLDEST passes (earliest captured = last merged) demote to one
    compressed file each under the spill directory, their bytes moving to
    the ``spill_tier_disk_bytes`` gauge;
  - ``assemble()`` merges every pass into ONE preallocated buffer per
    column, promoting disk passes back on the motion pipeline
    (exec/motionpipe.py) so pass k+1's read and decode overlap pass k's
    fill.

A file holds one frame per column (and per NULL mask): a 24-byte header
(magic, CRC-32 of the raw bytes, raw and compressed lengths) and the
zlib-compressed bytes. The JAX package writes its native codec's frames;
the port keeps the format to the standard library, and a torn or flipped
frame raises ``WorkfileCorrupt`` on read.

Files are named ``gg-spill-<pid>-<seq>-<token>.wf`` and deleted as each
pass promotes (and unconditionally at ``close()``). The spill directory
is ``spill_dir`` when set, else a directory of the Database's own (made
with ``tempfile.mkdtemp`` on first use, removed when the Database
closes): the port has no store root, and two Databases, or two test
workers, never share a default directory. ``sweep_orphans`` removes only
files of dead processes, only in the directory it is given; the session
runs it when ``SET spill_dir`` names a directory.
"""

from __future__ import annotations

import errno
import itertools
import os
import re
import struct
import threading
import zlib

import numpy as np

from greengage_tpu_torch.runtime import memaccount
from greengage_tpu_torch.runtime.logger import counters

_FILE_RE = re.compile(r"^gg-spill-(\d+)-\d+-[0-9a-f]+\.wf$")
_seq = itertools.count(1)
_MAGIC = b"GGWF"
_HEADER = struct.Struct("<4sIQQ")   # magic, crc32(raw), raw len, zlib len
_LEVEL = 1                          # zlib level: captured rows are hot data

# process-wide tier totals behind the spill_tier_{ram,disk}_bytes gauges
# (several spilling statements share them)
_tier_mu = threading.Lock()
_tier_ram = 0
_tier_disk = 0


class WorkfileCorrupt(IOError):
    """A spill file's frame failed its magic, length or CRC check."""


def _tier_add(ram: int = 0, disk: int = 0) -> None:
    global _tier_ram, _tier_disk
    with _tier_mu:
        _tier_ram = max(_tier_ram + int(ram), 0)
        _tier_disk = max(_tier_disk + int(disk), 0)
        counters.set("spill_tier_ram_bytes", _tier_ram)
        counters.set("spill_tier_disk_bytes", _tier_disk)


def spill_dir_of(settings, executor) -> str:
    """``spill_dir`` when set, else the executor's own directory."""
    d = str(getattr(settings, "spill_dir", "") or "")
    return d if d else executor.default_spill_dir()


def sweep_orphans(directory: str) -> int:
    """Remove spill files owned by DEAD processes (a kill mid-pass leaves
    them behind; close() handles every live-process path). Returns the
    number removed; never raises."""
    removed = 0
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    for name in names:
        m = _FILE_RE.match(name)
        if m is None:
            continue
        pid = int(m.group(1))
        if pid == os.getpid():
            continue
        try:
            os.kill(pid, 0)          # signal 0: existence probe only
            continue                 # owner is alive — not an orphan
        except OSError as e:
            if e.errno != errno.ESRCH:
                continue             # EPERM: alive under another uid
        try:
            os.unlink(os.path.join(directory, name))
            removed += 1
        except OSError:
            pass
    if removed:
        counters.inc("spill_orphan_sweep_total", removed)
    return removed


def encode_frame(raw: bytes) -> bytes:
    comp = zlib.compress(raw, _LEVEL)
    return _HEADER.pack(_MAGIC, zlib.crc32(raw), len(raw), len(comp)) + comp


def decode_frame(buf: bytes, off: int = 0) -> tuple[bytes, int]:
    """-> (raw bytes, offset after the frame)."""
    if len(buf) - off < _HEADER.size:
        raise WorkfileCorrupt("truncated frame header")
    magic, crc, nraw, ncomp = _HEADER.unpack_from(buf, off)
    off += _HEADER.size
    if magic != _MAGIC or len(buf) - off < ncomp:
        raise WorkfileCorrupt("bad magic or truncated frame")
    try:
        raw = zlib.decompress(buf[off:off + ncomp])
    except zlib.error as e:
        raise WorkfileCorrupt(f"undecodable frame: {e}") from None
    if len(raw) != nraw or zlib.crc32(raw) != crc:
        raise WorkfileCorrupt("frame CRC mismatch")
    return raw, off + ncomp


class _Pass:
    __slots__ = ("rows", "data", "path", "index", "ram_bytes", "disk_bytes")
    # data: {col id: (array, valids | None)} while RAM-resident; None when
    # demoted. index: [(col id, dtype str, has_valids)] in frame order.


class SpillWorkfile:
    """One statement's captured passes for one spill phase. Single-owner:
    the statement thread adds, assembles and closes; only assemble()'s
    promotion stage callable runs off-thread (on disjoint passes)."""

    def __init__(self, executor, cols_spec, item: str):
        self.cols_spec = list(cols_spec)
        self.item = item
        self.settings = executor.settings
        self._executor = executor
        self.dir: str | None = None      # resolved at the first demotion
        limit_mb = int(getattr(executor.settings, "spill_host_limit_mb",
                               512) or 0)
        # 0 = RAM only: the workfile never touches disk
        self.limit_bytes = limit_mb << 20 if limit_mb > 0 else None
        self._passes: list[_Pass] = []
        self._ram_bytes = 0
        self.stats: list = []        # per-pass Result.stats
        # result-metadata donor fields from the FIRST captured pass
        self.columns = None
        self.order = None
        self.base_stats = None
        self._any_invalid = {c.id: False for c in self.cols_spec}
        self._closed = False

    # ---- capture -------------------------------------------------------
    def add(self, res) -> None:
        """Capture one pass Result (host arrays) in the RAM tier; the
        coldest passes demote once the tier exceeds its budget."""
        p = _Pass()
        p.data = {}
        p.path = None
        p.index = []
        p.disk_bytes = 0
        nb = 0
        rows = 0
        for c in self.cols_spec:
            a = np.asarray(res.cols[c.id])
            rows = len(a)
            v = res.valids.get(c.id)
            if v is not None:
                v = np.asarray(v, bool)
                self._any_invalid[c.id] = True
                nb += int(v.nbytes)
            nb += int(a.nbytes)
            p.data[c.id] = (a, v)
            p.index.append((c.id, a.dtype.str, v is not None))
        p.rows = rows
        p.ram_bytes = nb
        self._passes.append(p)
        self.stats.append(res.stats)
        if self.columns is None:
            self.columns = res.columns
            self.order = list(getattr(res, "_order", []) or [])
            self.base_stats = dict(res.stats or {})
        self._ram_bytes += nb
        memaccount.charge("spill", nb, item=self.item)
        _tier_add(ram=nb)
        if self.limit_bytes is not None:
            self._demote_over(self.limit_bytes)

    def _demote_over(self, limit: int) -> None:
        """Demote coldest-first (earliest captured) until the RAM tier
        fits; the pass being captured right now stays resident."""
        for p in self._passes[:-1]:
            if self._ram_bytes <= limit:
                return
            if p.data is not None:
                self._demote(p)
        # all older passes are on disk: demote the newest too if the tier
        # still overflows (one pass bigger than the whole budget)
        if self._ram_bytes > limit and self._passes \
                and self._passes[-1].data is not None:
            self._demote(self._passes[-1])

    def _demote(self, p: _Pass) -> None:
        if self.dir is None:
            self.dir = spill_dir_of(self.settings, self._executor)
        os.makedirs(self.dir, exist_ok=True)
        name = (f"gg-spill-{os.getpid()}-{next(_seq)}-"
                f"{os.urandom(4).hex()}.wf")
        path = os.path.join(self.dir, name)
        nbytes = 0
        with open(path, "wb") as f:
            for cid, _dt, has_v in p.index:
                a, v = p.data[cid]
                frame = encode_frame(np.ascontiguousarray(a).tobytes())
                f.write(frame)
                nbytes += len(frame)
                if has_v:
                    frame = encode_frame(
                        np.ascontiguousarray(v).view(np.uint8).tobytes())
                    f.write(frame)
                    nbytes += len(frame)
        p.path = path
        p.disk_bytes = nbytes
        p.data = None
        self._ram_bytes -= p.ram_bytes
        memaccount.charge("spill", -p.ram_bytes, item=self.item)
        _tier_add(ram=-p.ram_bytes, disk=nbytes)
        p.ram_bytes = 0
        counters.inc("spill_demote_total")

    def _promote(self, p: _Pass) -> dict:
        """Read one demoted pass back: -> {col id: (array, valids|None)}."""
        with open(p.path, "rb") as f:
            buf = f.read()
        out = {}
        off = 0
        for cid, dt, has_v in p.index:
            raw, off = decode_frame(buf, off)
            a = np.frombuffer(raw, dtype=np.dtype(dt))
            v = None
            if has_v:
                raw, off = decode_frame(buf, off)
                v = np.frombuffer(raw, dtype=np.uint8).astype(bool)
            out[cid] = (a, v)
        counters.inc("spill_promote_total")
        return out

    # ---- merge ---------------------------------------------------------
    def assemble(self):
        """Merge every pass into one preallocated buffer per column ->
        (cols, valids), valids[c] None when every pass was all-valid. Each
        pass's tier bytes release as its rows land in the merged buffer;
        disk passes promote on the motion pipeline."""
        from greengage_tpu_torch.exec import motionpipe

        total = sum(p.rows for p in self._passes)
        dtypes = {}
        for p in self._passes:
            for cid, dt, _hv in p.index:
                d = np.dtype(dt)
                dtypes[cid] = (d if cid not in dtypes
                               else np.result_type(dtypes[cid], d))
        cols = {c.id: np.empty(total, dtype=dtypes.get(c.id, np.int64))
                for c in self.cols_spec}
        valids = {c.id: (np.ones(total, dtype=bool)
                         if self._any_invalid[c.id] else None)
                  for c in self.cols_spec}
        offsets = []
        off = 0
        for p in self._passes:
            offsets.append(off)
            off += p.rows

        def stage(p, _i):
            return p.data if p.data is not None else self._promote(p)

        def fill(data, p, i):
            lo = offsets[i]
            hi = lo + p.rows
            for cid in cols:
                a, v = data[cid]
                cols[cid][lo:hi] = a
                if valids[cid] is not None and v is not None:
                    valids[cid][lo:hi] = v
            self._release(p)

        motionpipe.run_pipeline(self._passes, stage, fill, label="workfile")
        self._passes = []
        nb = sum(int(a.nbytes) for a in cols.values())
        nb += sum(int(v.nbytes) for v in valids.values() if v is not None)
        memaccount.charge("spill", nb, item=self.item)
        return cols, valids

    def _release(self, p: _Pass) -> None:
        if p.data is not None:
            p.data = None
            self._ram_bytes -= p.ram_bytes
            memaccount.charge("spill", -p.ram_bytes, item=self.item)
            _tier_add(ram=-p.ram_bytes)
            p.ram_bytes = 0
        if p.path is not None:
            try:
                os.unlink(p.path)
            except OSError:
                pass
            _tier_add(disk=-p.disk_bytes)
            p.path = None
            p.disk_bytes = 0

    def close(self) -> None:
        """Release every retained pass (idempotent): drop RAM-tier bytes,
        delete disk files. Runs in the spill paths' finally, so an error
        mid-schedule leaks nothing."""
        if self._closed:
            return
        self._closed = True
        for p in self._passes:
            self._release(p)
        self._passes = []
