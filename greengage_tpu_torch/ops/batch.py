"""Batch: the columnar unit flowing between operators (TupleTableSlot analog).

The port's counterpart of greengage_tpu/ops/batch.py. Every tensor is
``[nseg, cap]``: one row of capacity ``cap`` per segment.

- ``valids``: per-column NULL masks (absent = all valid)
- ``sel``: the selection mask — rows logically alive. Filters narrow ``sel``
  instead of compacting, keeping shapes static.

A plain dataclass: eager torch needs no pytree registration.

``member_batched(t)``: whether ``t`` carries a batched program's member
axis (exec/compile.py ``batch_width``, under ``torch.func.vmap``). The one
operator that reads the device to end a loop early (the hash join's probe
walk) runs its full bound instead for such a value, whose members may
stop at different hops.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass
class Batch:
    cols: dict[str, torch.Tensor]
    valids: dict[str, torch.Tensor] = field(default_factory=dict)
    sel: torch.Tensor | None = None   # bool[nseg, cap]; None = all rows live

    @property
    def shape(self) -> tuple:
        for a in self.cols.values():
            return tuple(a.shape)
        if self.sel is not None:
            return tuple(self.sel.shape)
        return (0, 0)

    @property
    def device(self) -> torch.device:
        for a in self.cols.values():
            return a.device
        return self.sel.device

    def selection(self) -> torch.Tensor:
        if self.sel is None:
            return torch.ones(self.shape, dtype=torch.bool, device=self.device)
        return self.sel

    def with_sel(self, sel: torch.Tensor) -> "Batch":
        return Batch(dict(self.cols), dict(self.valids), sel)


def member_batched(t: torch.Tensor) -> bool:
    """Whether ``t`` is a ``torch.func.vmap`` batched value (a batched
    program's per-member tensor): its value cannot be read on the host."""
    return torch._C._functorch.is_batchedtensor(t)
