"""Motion — exchange operators over the segment axis (the data plane).

The port's counterpart of greengage_tpu/parallel/motion.py, row-order
identical to it. The JAX functions run inside ``shard_map`` on one
segment's shard; these take every segment at once as ``[nseg, n]`` tensors
on one device, so the collectives become tensor ops:

  Redistribute Motion  -> lax.all_to_all   -> [src, dst, cap] -> [dst, src, cap]
                                              block transpose
  Broadcast Motion     -> lax.all_gather   -> tiled expand of the flat rows
  overflow flag        -> lax.pmax         -> any over segments
"""

from __future__ import annotations

import torch


def _bucketize(arrs: dict, present, dest, nseg: int, capacity: int):
    """Pack each source segment's rows into per-destination buckets
    ``[S, nseg * capacity]``.

    Rows are ranked within their destination via a stable sort by dest;
    bucket index = dest * capacity + rank. Returns (buckets dict,
    present_buckets, overflow flag of each source segment [S]).
    """
    S, n = present.shape
    dev = present.device
    dest = torch.where(present, dest.to(torch.int64), nseg)  # dead -> sink
    counts = torch.zeros((S, nseg + 1), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, dest, torch.ones_like(dest))
    overflow = (counts[:, :nseg] > capacity).any(dim=1)
    start = torch.cumsum(counts, dim=1) - counts
    order = torch.argsort(dest, dim=1, stable=True)
    dsorted = dest.gather(1, order)
    rank = torch.arange(n, device=dev) - start.gather(1, dsorted)
    # clamp ranks so skewed rows drop instead of corrupting other buckets:
    # every dropped row lands on the one sink slot past the buckets, which
    # is sliced off — the only position written more than once
    size = nseg * capacity
    pos = torch.where((dsorted < nseg) & (rank < capacity),
                      dsorted * capacity + rank, size)
    out = {}
    for name, a in arrs.items():
        buf = torch.zeros((S, size + 1), dtype=a.dtype, device=dev)
        out[name] = buf.scatter_(1, pos, a.gather(1, order))[:, :size]
    pbuf = torch.zeros((S, size + 1), dtype=torch.bool, device=dev)
    pbuf = pbuf.scatter_(1, pos, dsorted < nseg)[:, :size]
    return out, pbuf, overflow


def _exchange(a, capacity: int, nbuckets: int):
    """The all_to_all: source segment s's bucket for destination d becomes
    destination d's chunk s. ``nbuckets`` sub-exchanges carry rows
    [j*sub, (j+1)*sub) of every bucket and land them at the same received
    positions as one exchange does, so on one device the split is the same
    block transpose (it exists to pipeline transfers between devices)."""
    S = a.shape[0]
    nseg = a.shape[1] // capacity
    sub = capacity // nbuckets
    blocks = a.reshape(S, nseg, nbuckets, sub)
    return blocks.transpose(0, 1).reshape(nseg, S * capacity)


def redistribute(arrs: dict, present, dest, nseg: int, capacity: int,
                 nbuckets: int = 1):
    """All-to-all exchange by per-row destination segment.

    -> (received arrs [nseg, nseg*capacity], received present, overflow
    scalar). Row d of the result holds destination segment d's receipts;
    its chunk s holds the rows sent by segment s.
    """
    if nbuckets > 1 and capacity % nbuckets:
        nbuckets = 1               # guard: only even splits preserve slots
    buckets, pbuf, overflow = _bucketize(arrs, present, dest, nseg, capacity)
    recv = {name: _exchange(a, capacity, max(nbuckets, 1))
            for name, a in buckets.items()}
    precv = _exchange(pbuf, capacity, max(nbuckets, 1))
    # surface every segment's overflow everywhere (dispatcher error check)
    return recv, precv, overflow.any()


def broadcast(arrs: dict, present):
    """Broadcast Motion: every segment receives every row (tiled gather)."""
    S = present.shape[0]
    recv = {n: a.reshape(1, -1).expand(S, -1) for n, a in arrs.items()}
    return recv, present.reshape(1, -1).expand(S, -1)
