"""Typed storage-corruption errors — the AO block-checksum failure model.

Reference parity: the reference classifies append-only storage damage at
the point of detection (``cdbappendonlystorageformat.c`` errors carry the
file, block and header kind; ``appendonly_verify_block_checksums``
distinguishes header vs content checksums). Ours is one exception type
with a ``cause`` taxonomy so the read path, the scrubber, and tests can
dispatch on WHAT failed, and a location (table / content / relpath /
block) attached as it propagates up through the layers that know it.

``CorruptionError`` subclasses ``IOError`` so pre-existing handlers of
storage read failures keep working unchanged.

The port's copy of greengage_tpu/storage/corruption.py (no imports of the
JAX package; the cause strings are the on-disk quarantine sidecars' and
stay identical).
"""

from __future__ import annotations

# cause taxonomy (stable strings: quarantine sidecars + tests use them)
BAD_MAGIC = "bad_magic"              # frame header magic mismatch
CRC_MISMATCH = "crc_mismatch"        # frame checksum mismatch
TRUNCATED = "truncated"              # file/frame shorter than its header claims
BAD_FOOTER = "bad_footer"            # footer magic/checksum/JSON/dtype damage
ROWCOUNT_MISMATCH = "rowcount_mismatch"  # decoded rows != header/footer rows
DECODE_FAILED = "decode_failed"      # decompression/layout failure past the CRC
MISSING = "missing"                  # manifest-referenced file is gone

CAUSES = (BAD_MAGIC, CRC_MISMATCH, TRUNCATED, BAD_FOOTER,
          ROWCOUNT_MISMATCH, DECODE_FAILED, MISSING)


class CorruptionError(IOError):
    """A block file (or one frame of it) failed verification.

    Raised typed from the codec (`storage/native.py`) and the file layer
    (`storage/blockfile.py`) with ``cause`` + ``path``; the store layer
    (`storage/table_store.py`) locates it (table, content, relpath) before
    deciding repair vs quarantine.
    """

    def __init__(self, cause: str, message: str | None = None, *,
                 path: str | None = None, table: str | None = None,
                 content: int | None = None, relpath: str | None = None,
                 block: int | None = None):
        assert cause in CAUSES, cause
        self.cause = cause
        self.message = message or cause.replace("_", " ")
        self.path = path
        self.table = table
        self.content = content
        self.relpath = relpath
        self.block = block
        super().__init__(self._render())

    def _render(self) -> str:
        where = (f"{self.table}/{self.relpath}"
                 if self.table and self.relpath
                 else (self.path or self.relpath or "<unknown file>"))
        blk = f" block {self.block}" if self.block is not None else ""
        seg = f" (content {self.content})" if self.content is not None else ""
        return f"corrupt storage {where}{blk}{seg}: {self.message} [{self.cause}]"

    def locate(self, **kw) -> "CorruptionError":
        """Fill in location fields the raising layer didn't know (never
        overwrites one already set) and refresh the rendered message."""
        for k, v in kw.items():
            if getattr(self, k, None) is None:
                setattr(self, k, v)
        self.args = (self._render(),)
        return self

    def to_dict(self) -> dict:
        """JSON-able record (the quarantine sidecar body)."""
        return {
            "cause": self.cause,
            "message": self.message,
            "path": self.path,
            "table": self.table,
            "content": self.content,
            "relpath": self.relpath,
            "block": self.block,
        }
