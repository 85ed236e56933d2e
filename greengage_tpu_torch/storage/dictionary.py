"""Append-only string dictionaries for TEXT columns.

Codes are assigned in first-seen order and never change, so a row's
distribution placement (which hashes the *string bytes*, not the code) and
any stored code remain stable across appends. Dictionaries are table-global
(shared by all segments) so equality joins/group-bys on a single table's
column can compare codes directly; cross-table text comparisons go through
host-built code translation tables (see ops/expr.py).
"""

from __future__ import annotations

import json
import os
import tempfile
import hashlib

import numpy as np

from greengage_tpu_torch.storage import native


class Dictionary:
    def __init__(self, values: list[str] | None = None):
        self.values: list[str] = list(values or [])
        self._index: dict[str, int] = {v: i for i, v in enumerate(self.values)}
        self._digest: str | None = None
        self._digest_len = -1

    def __len__(self) -> int:
        return len(self.values)

    def fingerprint(self) -> str:
        """Content digest for the executor's executable-cache shape
        signature: compiled programs bake this dictionary's hash/rank LUTs,
        so an executable is reusable only while the content is identical.
        Dictionaries are append-only, which makes the cached digest
        invalidatable by length alone."""
        if self._digest is None or self._digest_len != len(self.values):
            h = hashlib.sha1()
            for v in self.values:
                h.update(v.encode("utf-8", "surrogatepass"))
                h.update(b"\x00")
            self._digest = h.hexdigest()[:16]
            self._digest_len = len(self.values)
        return self._digest

    def encode(self, strings) -> np.ndarray:
        """Map strings -> int32 codes, appending unseen values."""
        out = np.empty(len(strings), dtype=np.int32)
        idx = self._index
        vals = self.values
        for i, s in enumerate(strings):
            code = idx.get(s)
            if code is None:
                code = len(vals)
                vals.append(s)
                idx[s] = code
            out[i] = code
        return out

    def decode(self, codes: np.ndarray) -> list[str]:
        return [self.values[c] for c in codes]

    def encode_coded(self, vocab: list[str], codes: np.ndarray) -> np.ndarray:
        """Bulk path: encode only the (small) vocabulary through the normal
        append path, then remap the per-row code array vectorized — O(|vocab|)
        Python work for any number of rows."""
        mapping = self.encode(vocab)
        return mapping.astype(np.int32)[codes]

    def lookup(self, s: str) -> int:
        """Code for s, or -1 if absent (absent ⇒ no row equals s)."""
        return self._index.get(s, -1)

    def hashes(self, seed: int = 0) -> np.ndarray:
        """Per-entry uint32 distribution hashes (device motion LUT), plus
        one sentinel row (hash 0) so translated code -1 (string absent from
        this dictionary) negative-indexes onto the sentinel instead of
        silently hashing as the last real entry."""
        return np.array(
            [native.hash_bytes(v.encode("utf-8"), seed) for v in self.values]
            + [0],
            dtype=np.uint32,
        )

    # ---- persistence ---------------------------------------------------
    def save(self, path: str) -> None:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", prefix=".dict")
        with os.fdopen(fd, "w") as f:
            json.dump(self.values, f)
            f.flush()
            os.fsync(f.fileno())  # commit-critical: codes referenced by committed blocks
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "Dictionary":
        if not os.path.exists(path):
            return Dictionary()
        with open(path) as f:
            return Dictionary(json.load(f))
