"""Run a compiled program and present its Gather — the port's counterpart of
the dispatch/fetch/present half of greengage_tpu/exec/executor.py.

The Gather Motion: every segment's live rows, segment after segment, are
compacted on the device; a Gather with merge keys (the Merge Receive) orders
them with the same sort the segments used; then one copy to the host and
the presentation decode (TEXT via its dictionary, DECIMAL descaled to
float64, DATE to datetime64), as ``Result.rows()`` gives it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from greengage_tpu_torch import types as T
from greengage_tpu_torch.exec.compile import CompileResult, ProgramOutput
from greengage_tpu_torch.ops import sort as sort_ops
from greengage_tpu_torch.ops.batch import Batch


class MotionOverflow(RuntimeError):
    """A capacity-bounded exchange dropped rows. The JAX executor retries
    at a larger capacity tier; the port raises until its executor does
    (ROADMAP Queue 1 item 1)."""


@dataclass
class Result:
    columns: list[str]
    cols: dict[str, np.ndarray]
    valids: dict[str, np.ndarray | None]
    _order: list[str]
    # storage-representation values (scaled int64 DECIMAL, TEXT codes)
    raw: dict[str, np.ndarray] = field(default_factory=dict)
    flags: dict[str, bool] = field(default_factory=dict)
    metrics: dict[str, np.ndarray] = field(default_factory=dict)

    def __len__(self):
        for c in self._order:
            return len(self.cols[c])
        return 0

    def rows(self) -> list[tuple]:
        out = []
        for i in range(len(self)):
            row = []
            for cid in self._order:
                v = self.valids.get(cid)
                row.append(None if v is not None and not v[i]
                           else self.cols[cid][i])
            out.append(tuple(row))
        return out


def gather(comp: CompileResult, out: ProgramOutput, compiler) -> dict:
    """The Gather Motion on the device: -> {col id: (values, valid)} of the
    live rows, merge-ordered when the plan asks for it."""
    sel = out.sel.reshape(1, -1)
    live = int(sel.sum())
    cols = {c.id: out.cols[c.id].reshape(1, -1) for c in comp.out_cols}
    valids = {c.id: out.valids[c.id].reshape(1, -1)
              for c in comp.out_cols if c.id in out.valids}
    cols, valids, sel = sort_ops.compact(cols, valids, sel, live)
    if comp.merge_keys:
        keys = compiler.sort_keys(Batch(cols, valids, sel),
                                   comp.merge_keys)
        perm, _, _ = sort_ops.sort_batch(keys, sel, live)
        cols, valids = sort_ops.apply_perm(cols, valids, perm)
    return {c.id: (cols[c.id][0], valids[c.id][0] if c.id in valids
                   else None) for c in comp.out_cols}


def execute(comp: CompileResult, tables: dict, compiler) -> Result:
    out = comp.program(tables)
    flags = {k: bool(v) for k, v in out.flags.items()}
    bad = [k for k, v in flags.items() if v]
    if bad:
        raise MotionOverflow(f"capacity overflow: {', '.join(bad)}")
    rows = gather(comp, out, compiler)
    return present(comp, rows, flags,
                   {k: v.cpu().numpy() for k, v in out.metrics.items()},
                   compiler)


def present(comp: CompileResult, rows: dict, flags: dict, metrics: dict,
            compiler) -> Result:
    """Host-side presentation: TEXT/decimal/date decode, Result assembly."""
    out_cols, out_valids, raw = {}, {}, {}
    for c in comp.out_cols:
        data_t, valid_t = rows[c.id]
        data = data_t.cpu().numpy()
        valid = (np.ones(len(data), bool) if valid_t is None
                 else valid_t.cpu().numpy())
        raw[c.id] = data
        if c.hidden:
            out_cols[c.id] = data
        elif c.type.kind is T.Kind.TEXT and c.dict_ref is not None:
            d = compiler.dictionary(c.dict_ref)
            out_cols[c.id] = np.array(
                [d[x] if 0 <= x < len(d) else None for x in data],
                dtype=object)
        elif c.type.kind is T.Kind.DECIMAL:
            out_cols[c.id] = data / (10.0 ** c.type.scale)
        elif c.type.kind is T.Kind.DATE:
            out_cols[c.id] = (np.datetime64("1970-01-01", "D")
                              + data.astype("timedelta64[D]"))
        else:
            out_cols[c.id] = data
        out_valids[c.id] = None if valid.all() else valid
    visible = [c for c in comp.out_cols if not c.hidden]
    return Result(columns=[c.name for c in visible], cols=out_cols,
                  valids=out_valids, _order=[c.id for c in visible],
                  raw=raw, flags=flags, metrics=metrics)
