"""Segment layout — the port's counterpart of greengage_tpu/parallel/mesh.py.

The JAX package maps segments onto the devices of a 1-D ``Mesh`` over axis
"seg" and runs one program per device. The port keeps all ``nseg`` segments
on one device as the leading axis of every tensor, ``[nseg, cap]``: segment
``s`` owns row ``s``, exactly the concatenation ``PartitionSpec("seg")``
gives. Collectives become tensor ops over that axis (parallel/motion.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SegmentLayout:
    nseg: int
    device: torch.device


def make_layout(numsegments: int, device) -> SegmentLayout:
    if numsegments < 1:
        raise ValueError(f"cluster width {numsegments} must be at least 1")
    return SegmentLayout(int(numsegments), torch.device(device))
