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
    bucket slot dest * capacity + rank holds the row of that rank, and
    ranks past the capacity drop (the overflow flag reports them). Returns
    (buckets dict, present_buckets, overflow flag of each source segment
    [S]).

    Each bucket slot gathers its row from the sorted order: each
    destination's first sorted position comes from a binary search, so no
    scatter runs. (Scattering the rows instead sends every dead row to one
    sink slot, and a scatter-add of per-destination counters puts every
    row on nseg + 1 addresses: both serialise on the card.)
    """
    S, n = present.shape
    dev = present.device
    dest = torch.where(present, dest.to(torch.int64), nseg)  # dead -> sink
    order = torch.argsort(dest, dim=1, stable=True)
    dsorted = dest.gather(1, order)
    dests = torch.arange(nseg + 1, device=dev).expand(S, nseg + 1)
    start = torch.searchsorted(dsorted, dests.contiguous())
    counts = start[:, 1:] - start[:, :-1]
    overflow = (counts > capacity).any(dim=1)
    size = nseg * capacity
    slot = torch.arange(size, device=dev)
    bucket, rank = slot // capacity, slot % capacity
    live = rank < counts[:, bucket]
    src = order.gather(1, torch.clamp(start[:, bucket] + rank,
                                      max=max(n - 1, 0)))
    out = {}
    for name, a in arrs.items():
        out[name] = torch.where(live, a.gather(1, src),
                                torch.zeros((), dtype=a.dtype, device=dev))
    return out, live, overflow


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
