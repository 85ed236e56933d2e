"""Locus algebra — the port's own copy of greengage_tpu/planner/locus.py.

Reference parity: CdbPathLocus (src/backend/cdb/cdbpathlocus.h:29-49, .c) —
every plan node carries *where its rows live*:

  ENTRY           on the coordinator (QD) only
  SINGLE_QE       on exactly one segment
  GENERAL         logically everywhere (constants); safe to join anywhere
  SEGMENT_GENERAL replicated tables: full copy on every segment
  HASHED          partitioned by hash of key columns over numsegments
  STREWN          partitioned with no known key (DISTRIBUTED RANDOMLY,
                  or a projection that dropped its hash keys)

``numsegments`` travels with the locus (gp_policy.h:35) so plans remain
correct across mixed-width tables during expansion.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class LocusKind(enum.Enum):
    ENTRY = "Entry"
    SINGLE_QE = "SingleQE"
    GENERAL = "General"
    SEGMENT_GENERAL = "SegmentGeneral"
    HASHED = "Hashed"
    STREWN = "Strewn"


@dataclass(frozen=True)
class Locus:
    kind: LocusKind
    keys: tuple[str, ...] = ()   # hash key column ids (HASHED only)
    numsegments: int = 0

    @staticmethod
    def entry() -> "Locus":
        return Locus(LocusKind.ENTRY)

    @staticmethod
    def hashed(keys, nseg: int) -> "Locus":
        return Locus(LocusKind.HASHED, tuple(keys), nseg)

    @staticmethod
    def strewn(nseg: int) -> "Locus":
        return Locus(LocusKind.STREWN, (), nseg)

    @staticmethod
    def segment_general(nseg: int) -> "Locus":
        return Locus(LocusKind.SEGMENT_GENERAL, (), nseg)

    @property
    def is_partitioned(self) -> bool:
        return self.kind in (LocusKind.HASHED, LocusKind.STREWN)

    def hashed_on(self, cols: tuple[str, ...]) -> bool:
        """True if rows are partitioned by exactly these columns (order-
        insensitive subset rule: distribution keys ⊆ cols means co-location
        for grouping; joins need the full equality-key correspondence)."""
        return self.kind is LocusKind.HASHED and set(self.keys) <= set(cols) and bool(self.keys)

    def describe(self) -> str:
        if self.kind is LocusKind.HASHED:
            return f"Hashed({', '.join(self.keys)}) x{self.numsegments}"
        if self.is_partitioned or self.kind is LocusKind.SEGMENT_GENERAL:
            return f"{self.kind.value} x{self.numsegments}"
        return self.kind.value
