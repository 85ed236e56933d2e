"""Host codec: distribution hashing and checksummed block frames — the
port's counterpart of greengage_tpu/storage/native.py.

Two routes compute the same bytes:

  - ``"native"``: the repo's C codec, ``native/ggcodec.cpp``, compiled at
    first use with ``g++ -O3 -fPIC -shared -lz`` into
    ``greengage_tpu_torch/_build/libggcodec-<digest>.so`` (the digest of the
    source names the library, as build.py names the CUDA kernel's, so an
    edited codec is rebuilt and a stale one never loads) and bound with
    ctypes. Nothing is written into ``native/``: the source is only read.
  - ``"numpy"``: numpy and ``zlib``, bit-identical to the C codec, for a
    host where the build fails (no compiler, no zlib headers).

``route()`` reports which one runs. Both are host code producing identical
bytes; neither touches a device. The hashes are the storage layer's one
definition: fmix32 over the two 32-bit halves of each int64, an FNV-style
combine across columns, strings as 8-byte little-endian chunks plus their
length. Row placement, the dictionaries' hash tables and the device side
(ops/hashing.py) agree with them bit for bit.

A block frame is a 32-byte header — magic "GGB2", rows, codec, raw and
stored lengths, and a CRC-32 over the header fields and the payload — then
the payload (zlib, stored raw when that is smaller, or zstd where the
optional ``zstandard`` module exists). Every failed check raises the typed
``CorruptionError`` (storage/corruption.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import zlib

import numpy as np

from greengage_tpu_torch.storage.corruption import CorruptionError

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "ggcodec.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")

HASH_INIT = np.uint32(0x9E3779B9)
COMBINE_MUL = np.uint32(0x01000193)
# "GGB2" (GG_BLOCK_MAGIC in native/ggcodec.cpp)
BLOCK_MAGIC = 0x47474232
HDR_LEN = 32
COMP_NONE, COMP_ZLIB, COMP_ZSTD = 0, 1, 2
_M32 = 0xFFFFFFFF

_lib = None          # None = not tried yet, False = the numpy route
_build_log = ""
_load_mu = threading.Lock()


def library_path() -> str | None:
    """The codec library's path under _build/, named by the source's
    digest; None when the source is not in the checkout."""
    try:
        with open(SOURCE, "rb") as f:
            digest = hashlib.sha1(f.read()).hexdigest()[:12]
    except OSError:
        return None
    return os.path.join(BUILD_DIR, f"libggcodec-{digest}.so")


def build() -> str | None:
    """Compile native/ggcodec.cpp into _build/ unless it is built. -> the
    library's path, or None when the build fails (the numpy route then
    runs; ``build_log()`` says why)."""
    global _build_log
    out = library_path()
    if out is None:
        _build_log = f"{SOURCE} not found"
        return None
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-std=c++17",
           "-shared", "-o", tmp, SOURCE, "-lz"]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        _build_log = f"{cmd[0]}: {e}"
        return None
    if p.returncode != 0:
        _build_log = p.stdout + p.stderr
        try:
            os.remove(tmp)
        except OSError:
            pass
        return None
    os.replace(tmp, out)
    _build_log = p.stdout + p.stderr
    return out


def _load():
    # serialized: staging threads racing the first call must not build
    # twice or publish a half-bound library
    global _lib
    with _load_mu:
        if _lib is not None:
            return _lib
        path = build()
        lib = False
        if path is not None:
            try:
                lib = ctypes.CDLL(path)
                lib.gg_hash_i64_batch.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                    ctypes.c_void_p]
                lib.gg_hash_combine_batch.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
                lib.gg_hash_bytes.argtypes = [
                    ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32]
                lib.gg_hash_bytes.restype = ctypes.c_uint32
                lib.gg_block_encode.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                    ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
                    ctypes.c_int64]
                lib.gg_block_encode.restype = ctypes.c_int64
                lib.gg_block_decode.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                    ctypes.c_int64, ctypes.c_void_p]
                lib.gg_block_decode.restype = ctypes.c_int64
            except (OSError, AttributeError):
                lib = False
        _lib = lib
        return lib


def route() -> str:
    """Which codec runs: "native" (the built C library) or "numpy"."""
    return "native" if _load() else "numpy"


def build_log() -> str:
    """The compiler's output of the last build attempt."""
    return _build_log


# ---------------------------------------------------------------------------
# Hashing
# ---------------------------------------------------------------------------

def _fmix32(h: np.ndarray) -> np.ndarray:
    h = h.astype(np.uint32, copy=True)
    with np.errstate(over="ignore"):
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h


def hash_i64(vals: np.ndarray, seed: int = 0) -> np.ndarray:
    """uint32 hash of an int64 array (fmix32 over lo then hi halves)."""
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    lib = _load()
    if lib:
        out = np.empty(len(vals), dtype=np.uint32)
        lib.gg_hash_i64_batch(vals.ctypes.data, len(vals),
                              ctypes.c_uint32(seed & _M32), out.ctypes.data)
        return out
    u = vals.view(np.uint64)
    lo = (u & np.uint64(_M32)).astype(np.uint32)
    hi = (u >> np.uint64(32)).astype(np.uint32)
    h = np.uint32(seed & _M32) ^ HASH_INIT
    h = _fmix32(h ^ lo)
    return _fmix32(h ^ hi)


def hash_combine(acc: np.ndarray, h: np.ndarray) -> np.ndarray:
    acc = np.ascontiguousarray(acc, dtype=np.uint32)
    h = np.ascontiguousarray(h, dtype=np.uint32)
    lib = _load()
    if lib:
        out = acc.copy()
        lib.gg_hash_combine_batch(out.ctypes.data, h.ctypes.data, len(acc))
        return out
    with np.errstate(over="ignore"):
        return _fmix32(acc * COMBINE_MUL ^ h)


def _fmix32_int(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def _hash_u64_int(u: int, seed: int = 0) -> int:
    h = (seed & _M32) ^ int(HASH_INIT)
    h = _fmix32_int(h ^ (u & _M32))
    return _fmix32_int(h ^ (u >> 32))


def hash_bytes(data: bytes, seed: int = 0) -> int:
    """uint32 hash of a byte string (8-byte LE chunk folding + length)."""
    lib = _load()
    if lib:
        return int(lib.gg_hash_bytes(data, len(data),
                                     ctypes.c_uint32(seed & _M32)))
    acc = (seed & _M32) ^ int(HASH_INIT)
    for i in range(0, len(data), 8):
        chunk = int.from_bytes(data[i:i + 8].ljust(8, b"\0"), "little")
        acc = _fmix32_int(((acc * int(COMBINE_MUL)) & _M32)
                          ^ _hash_u64_int(chunk))
    return _fmix32_int(((acc * int(COMBINE_MUL)) & _M32)
                       ^ _hash_u64_int(len(data)))


# ---------------------------------------------------------------------------
# Block frames
# ---------------------------------------------------------------------------

def block_encode(raw: bytes | np.ndarray, nrows: int,
                 compression: int = COMP_ZLIB, level: int = 1) -> bytes:
    raw = (np.frombuffer(raw, dtype=np.uint8)
           if isinstance(raw, (bytes, bytearray))
           else np.ascontiguousarray(raw).view(np.uint8).ravel())
    lib = _load()
    if lib and compression in (COMP_NONE, COMP_ZLIB):
        # zlib's worst case (compressBound ~ raw + raw/1000 + 64) plus the
        # header; the C side stores raw when compression does not pay
        cap = HDR_LEN + len(raw) + len(raw) // 1000 + 4096
        dst = np.empty(cap, dtype=np.uint8)
        n = lib.gg_block_encode(raw.ctypes.data, len(raw),
                                ctypes.c_uint32(nrows), compression, level,
                                dst.ctypes.data, cap)
        if n < 0:
            raise IOError("block encode failed")
        return dst[:n].tobytes()
    payload = raw.tobytes()
    comp = compression
    if compression == COMP_ZSTD:
        try:
            import zstandard
        except ModuleNotFoundError:
            # the optional codec: the frame records the codec used, so a
            # write degrades to zlib and readers never need the module
            compression = comp = COMP_ZLIB
            level = min(level, 9)
    if compression == COMP_ZLIB:
        c = zlib.compress(payload, level)
        if len(c) < len(payload):
            payload = c
        else:
            comp = COMP_NONE
    elif compression == COMP_ZSTD:
        c = zstandard.ZstdCompressor(level=level).compress(payload)
        if len(c) < len(payload):
            payload = c
        else:
            comp = COMP_NONE
    hdr = (BLOCK_MAGIC.to_bytes(4, "little") + int(nrows).to_bytes(4, "little")
           + bytes([comp, 0]) + b"\0\0" + len(raw).to_bytes(8, "little")
           + len(payload).to_bytes(8, "little"))
    crc = zlib.crc32(payload, zlib.crc32(hdr)) & _M32
    return hdr + crc.to_bytes(4, "little") + payload


def _check_frame_header(frame: bytes) -> tuple[int, int, int, int, int, int]:
    """Validate a frame's header without touching the payload.
    -> (nrows, comp, raw_len, comp_len, want_crc, total_len)."""
    if len(frame) < HDR_LEN:
        raise CorruptionError(
            "truncated", f"frame is {len(frame)} bytes, header needs {HDR_LEN}")
    magic = int.from_bytes(frame[:4], "little")
    if magic == 0x47474231:   # "GGB1": the layout before the header CRC
        # not corruption: refuse loudly, never quarantine valid old files
        raise IOError(
            "unsupported block format GGB1 (written by an older, "
            "incompatible version) — re-ingest from original sources")
    if magic != BLOCK_MAGIC:
        raise CorruptionError("bad_magic", "bad block magic")
    nrows = int.from_bytes(frame[4:8], "little")
    comp = frame[8]
    raw_len = int.from_bytes(frame[12:20], "little")
    comp_len = int.from_bytes(frame[20:28], "little")
    want_crc = int.from_bytes(frame[28:32], "little")
    total = HDR_LEN + comp_len
    if len(frame) < total:
        raise CorruptionError(
            "truncated",
            f"frame payload truncated ({len(frame)} bytes, header claims "
            f"{total})")
    # bound raw_len before any allocation: the C route allocates its
    # output ahead of the CRC check, so a flipped length must not drive a
    # huge allocation first (zlib expands at most ~1032:1)
    if raw_len < 0 or (comp == COMP_NONE and raw_len != comp_len) \
            or (comp == COMP_ZLIB and raw_len > comp_len * 1032 + 4096):
        raise CorruptionError(
            "decode_failed",
            f"implausible frame lengths (raw {raw_len}, stored {comp_len})")
    return nrows, comp, raw_len, comp_len, want_crc, total


def _native_decode(lib, frame, total, dst) -> tuple[int, int]:
    src = np.frombuffer(frame[:total], dtype=np.uint8)
    nrows_out = ctypes.c_uint32()
    n = lib.gg_block_decode(src.ctypes.data, len(src), dst.ctypes.data,
                            len(dst), ctypes.byref(nrows_out))
    if n == -2:
        raise CorruptionError("crc_mismatch", "block checksum mismatch")
    if n == -1:
        raise CorruptionError("bad_magic", "bad block magic")
    if n < 0:
        raise CorruptionError("decode_failed", f"block decode failed ({n})")
    return int(n), int(nrows_out.value)


def block_decode(frame: bytes) -> tuple[bytes, int, int]:
    """-> (raw bytes, nrows, frame length consumed). Verifies the frame's
    checksum (header and payload); every failure raises CorruptionError."""
    nrows, comp, raw_len, comp_len, want_crc, total = \
        _check_frame_header(frame)
    lib = _load()
    if lib and comp in (COMP_NONE, COMP_ZLIB):
        dst = np.empty(max(raw_len, 1), dtype=np.uint8)
        n, nrows = _native_decode(lib, frame, total, dst)
        return dst[:n].tobytes(), nrows, total
    payload = frame[HDR_LEN:total]
    crc = zlib.crc32(payload, zlib.crc32(frame[:HDR_LEN - 4])) & _M32
    if crc != want_crc:
        raise CorruptionError("crc_mismatch", "block checksum mismatch")
    if comp == COMP_ZLIB:
        try:
            raw = zlib.decompress(payload)
        except zlib.error as e:
            raise CorruptionError("decode_failed",
                                  f"zlib decompress failed: {e}")
    elif comp == COMP_ZSTD:
        try:
            import zstandard
        except ModuleNotFoundError:
            raise IOError(
                "block is zstd-compressed but the optional 'zstandard' "
                "module is not installed on this host")
        try:
            raw = zstandard.ZstdDecompressor().decompress(
                payload, max_output_size=raw_len)
        except zstandard.ZstdError as e:
            raise CorruptionError("decode_failed",
                                  f"zstd decompress failed: {e}")
    elif comp == COMP_NONE:
        raw = bytes(payload)
    else:
        raise CorruptionError("decode_failed", f"unknown compression {comp}")
    if len(raw) != raw_len:
        raise CorruptionError(
            "decode_failed",
            f"decoded {len(raw)} bytes, header claims {raw_len}")
    return raw, nrows, total


def block_decode_into(frame: bytes, dst: np.ndarray) -> tuple[int, int]:
    """Decode one frame's rows straight into ``dst`` (a contiguous uint8
    view of the destination slot): no intermediate bytes, no copy after
    decode. The same checks as block_decode. -> (bytes written, nrows)."""
    nrows, comp, raw_len, comp_len, want_crc, total = \
        _check_frame_header(frame)
    if raw_len > len(dst):
        raise CorruptionError(
            "rowcount_mismatch",
            f"frame holds {raw_len} bytes, destination slot is {len(dst)}")
    lib = _load()
    if lib and comp in (COMP_NONE, COMP_ZLIB):
        return _native_decode(lib, frame, total, dst)
    raw, nrows, _total = block_decode(frame)
    dst[:len(raw)] = np.frombuffer(raw, dtype=np.uint8)
    return len(raw), nrows
