"""Column block files (.ggb) — the AOCS datum-stream analog.

Reference parity: one segment file set per column with block-level
compression and checksummed headers (src/backend/access/aocs/aocsam.c,
src/backend/cdb/cdbappendonlystorageformat.c). Layout:

    [frame]* [footer-json] [u32 footer-crc] [u64 footer_len] [u32 magic "GGBF"]

Each frame is ggcodec's checksummed block (native.block_encode). The footer
records per-block (offset, nrows) so scans can do block-level skipping
(block directory analog) and projection reads only touch requested columns'
files. The footer JSON carries its own crc32 in the tail so footer damage
(including a bit flip inside a valid-JSON value) classifies as corruption
instead of silently mis-describing the frames.

All verification failures raise the typed ``CorruptionError``
(storage/corruption.py) carrying the path, block index, and cause — the
contract the read-path self-heal and the scrubber dispatch on.

The port's copy of greengage_tpu/storage/blockfile.py, imports rewritten to
the port's modules; the files are byte for byte the JAX package's.
"""

from __future__ import annotations

import json
import os
import warnings
import zlib

import numpy as np

from greengage_tpu_torch.storage import native
from greengage_tpu_torch.storage.corruption import CorruptionError

# bumped with the checksummed-footer format change ("GGBF" -> "GGF2") so
# files written by the 12-byte-tail layout fail with a CLEAR bad_footer
# classification, never a misparse of JSON bytes as a CRC
FOOTER_MAGIC = 0x32464747  # "GGF2"
FOOTER_TAIL = 16           # u32 crc + u64 footer_len + u32 magic
DEFAULT_BLOCK_ROWS = 1 << 16

_COMP_BY_NAME = {"none": native.COMP_NONE, "zlib": native.COMP_ZLIB, "zstd": native.COMP_ZSTD}


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so a just-renamed/created entry survives a crash
    (rename durability needs the parent's metadata flushed too)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_column_file(path: str, values: np.ndarray, compresstype: str = "zlib",
                      complevel: int = 1, block_rows: int = DEFAULT_BLOCK_ROWS) -> dict:
    """Write a 1-D numpy array as a block file; returns footer metadata."""
    comp = _COMP_BY_NAME[compresstype]
    values = np.ascontiguousarray(values)
    blocks = []
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        off = 0
        zonable = values.dtype.kind in ("i", "u", "f") and values.dtype.itemsize > 1
        for start in range(0, len(values), block_rows):
            chunk = values[start : start + block_rows]
            frame = native.block_encode(chunk.tobytes(), len(chunk), comp, complevel)
            f.write(frame)
            b = {"offset": off, "nrows": len(chunk), "bytes": len(frame)}
            if zonable and len(chunk):
                # zone map: per-block min/max for scan pruning (the
                # PartitionSelector/block-directory analog — blocks whose
                # range cannot satisfy a scan predicate are never staged).
                # Integer bounds stay EXACT python ints (floats above 2^53
                # would make strict-inequality pruning unsound); float
                # columns exclude NaNs (they match no range predicate), and
                # an all-NaN block gets no zone and is never pruned.
                if chunk.dtype.kind == "f":
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore", RuntimeWarning)
                        lo, hi = np.nanmin(chunk), np.nanmax(chunk)
                    if not np.isnan(lo):
                        b["zmin"] = float(lo)
                        b["zmax"] = float(hi)
                else:
                    b["zmin"] = int(np.min(chunk))
                    b["zmax"] = int(np.max(chunk))
            blocks.append(b)
            off += len(frame)
        footer = {
            "dtype": values.dtype.str,
            "nrows": int(len(values)),
            "blocks": blocks,
        }
        fj = json.dumps(footer).encode()
        f.write(fj)
        f.write((zlib.crc32(fj) & 0xFFFFFFFF).to_bytes(4, "little"))
        f.write(len(fj).to_bytes(8, "little"))
        f.write(FOOTER_MAGIC.to_bytes(4, "little"))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return footer


def read_footer(path: str) -> dict:
    """Parse + verify the footer. Short/truncated/garbage-tail/damaged
    footers classify as CorruptionError with the path and cause."""
    with open(path, "rb") as f:
        return _read_footer_fh(f, path)


def _read_footer_fh(f, path: str) -> dict:
    """read_footer against an already-open handle (single-open read path:
    the column read parses the footer and decodes frames from ONE open)."""
    f.seek(0, os.SEEK_END)
    size = f.tell()
    if size < FOOTER_TAIL:
        raise CorruptionError(
            "truncated",
            f"file is {size} bytes, smaller than the {FOOTER_TAIL}-byte "
            "footer tail", path=path)
    f.seek(size - FOOTER_TAIL)
    tail = f.read(FOOTER_TAIL)
    tail_magic = int.from_bytes(tail[12:16], "little")
    if tail_magic == 0x47474246:   # "GGBF": the pre-CRC 12-byte tail
        raise IOError(
            f"{path}: unsupported block-file format GGBF (written by an "
            "older, incompatible version) — re-ingest from original "
            "sources")
    if tail_magic != FOOTER_MAGIC:
        raise CorruptionError(
            "bad_footer", "bad footer magic (garbage tail or not a "
            "block file)", path=path)
    flen = int.from_bytes(tail[4:12], "little")
    if flen > size - FOOTER_TAIL:
        raise CorruptionError(
            "truncated",
            f"footer length {flen} exceeds file size {size}", path=path)
    f.seek(size - FOOTER_TAIL - flen)
    fj = f.read(flen)
    if (zlib.crc32(fj) & 0xFFFFFFFF) != int.from_bytes(tail[:4], "little"):
        raise CorruptionError(
            "bad_footer", "footer checksum mismatch", path=path)
    try:
        footer = json.loads(fj)
    except ValueError as e:
        raise CorruptionError(
            "bad_footer", f"footer is not valid JSON ({e})", path=path)
    if not isinstance(footer, dict) or not isinstance(
            footer.get("blocks"), list) or "dtype" not in footer:
        raise CorruptionError(
            "bad_footer", "footer missing dtype/blocks", path=path)
    try:
        np.dtype(footer["dtype"])
    except TypeError as e:
        raise CorruptionError(
            "bad_footer", f"footer dtype unparseable ({e})", path=path)
    return footer


def _maybe_inject_corruption(frame: bytes, segment: int | None) -> bytes:
    """The storage_corrupt_block fault point: a 'skip'-type fault flips one
    payload byte of the frame AT READ TIME (occurrence/start_after
    targeting picks which frame of which read) — the gp_inject_fault
    AppendOnlyStorageRead corruption analog."""
    from greengage_tpu_torch.runtime.faultinject import faults

    if not faults.check("storage_corrupt_block", segment=segment):
        return frame
    bad = bytearray(frame)
    if bad:
        pos = native.HDR_LEN + max(0, (len(bad) - native.HDR_LEN) // 2) \
            if len(bad) > native.HDR_LEN else len(bad) // 2
        bad[min(pos, len(bad) - 1)] ^= 0xFF
    return bytes(bad)


def read_column_file(path: str, block_indices: list[int] | None = None,
                     segment: int | None = None,
                     out: np.ndarray | None = None) -> np.ndarray:
    """Read all (or selected) blocks back into one numpy array. ``segment``
    only targets the storage_corrupt_block fault point.

    Frames decode IN PLACE into one preallocated output array sized from
    the footer (native.block_decode_into): no per-block bytes objects and
    no final concatenate — the copy count the pipelined staging path is
    built around. ``out`` lets the caller provide that destination (e.g.
    a slot of the executor's [nseg*cap] staging buffer, dtype- and
    capacity-compatible); the return value is then a view of it."""
    with open(path, "rb") as f:
        footer = _read_footer_fh(f, path)   # one open serves footer + frames
        dtype = np.dtype(footer["dtype"])
        blocks = list(enumerate(footer["blocks"]))
        if block_indices is not None:
            blocks = [blocks[i] for i in block_indices]
        total_rows = sum(b["nrows"] for _, b in blocks)
        if out is not None and (out.dtype != dtype or len(out) < total_rows
                                or not out.flags.c_contiguous):
            out = None   # incompatible destination: decode a fresh array
        if out is None:
            out = np.empty(total_rows, dtype=dtype)
        else:
            out = out[:total_rows]
        if not blocks:
            return out
        u8 = out.view(np.uint8)
        itemsize = dtype.itemsize
        row = 0
        for i, b in blocks:
            f.seek(b["offset"])
            frame = f.read(b["bytes"])
            frame = _maybe_inject_corruption(frame, segment)
            slot = u8[row * itemsize: (row + b["nrows"]) * itemsize]
            try:
                nbytes, nrows = native.block_decode_into(frame, slot)
            except CorruptionError as e:
                raise e.locate(path=path, block=i)
            if nrows != b["nrows"] or nbytes != nrows * itemsize:
                raise CorruptionError(
                    "rowcount_mismatch",
                    f"block decoded {nbytes} bytes / {nrows} rows, footer "
                    f"says {b['nrows']} rows of {itemsize} bytes",
                    path=path, block=i)
            row += nrows
    return out


def verify_column_file(path: str, segment: int | None = None,
                       inject: bool = True) -> dict:
    """Verify the footer and EVERY frame (checksums, decode, row counts)
    without materializing the column. Raises CorruptionError (with path +
    block) on the first failure; returns {bytes, blocks, nrows} scanned —
    the scrub/repair verification primitive. ``inject=False`` exempts the
    read from the storage_corrupt_block fault point: repair's own
    verification must judge the REAL bytes, or an armed fault would
    quarantine healthy files."""
    footer = read_footer(path)
    dtype = np.dtype(footer["dtype"])
    total_rows = 0
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        for i, b in enumerate(footer["blocks"]):
            f.seek(b["offset"])
            frame = f.read(b["bytes"])
            if inject:
                frame = _maybe_inject_corruption(frame, segment)
            try:
                raw, nrows, consumed = native.block_decode(frame)
            except CorruptionError as e:
                raise e.locate(path=path, block=i)
            if consumed != b["bytes"]:
                raise CorruptionError(
                    "truncated",
                    f"frame consumed {consumed} bytes, footer says "
                    f"{b['bytes']}", path=path, block=i)
            if nrows != b["nrows"] or len(raw) != nrows * dtype.itemsize:
                raise CorruptionError(
                    "rowcount_mismatch",
                    f"block holds {len(raw) // max(dtype.itemsize, 1)} rows, "
                    f"frame header says {nrows}, footer says {b['nrows']}",
                    path=path, block=i)
            total_rows += nrows
    if total_rows != footer["nrows"]:
        raise CorruptionError(
            "rowcount_mismatch",
            f"frames hold {total_rows} rows, footer says {footer['nrows']}",
            path=path)
    return {"bytes": size, "blocks": len(footer["blocks"]), "nrows": total_rows}
