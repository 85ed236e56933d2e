"""Engine configuration — the port's copy of greengage_tpu/config.py.

Only the settings the ported operators read are kept, under the same names
and defaults as the JAX package's ``Settings``; the rest arrive with the
modules that read them.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Settings:
    # dense group-by path: used when the product of group-key domains
    # (dictionary sizes / bool) is at most this (scatter-free aggregation)
    dense_group_limit: int = 512
    # fused single-pass dense aggregation (ops/fused_agg.py kernel): one
    # pass over the rows for every aggregate of a small-domain GROUP BY.
    # The gates are the JAX package's, so both packages take the kernel on
    # the same plans
    fused_dense_agg: bool = True
    fused_dense_min_rows: int = 1 << 16
    fused_dense_max_domain: int = 64
    fused_dense_max_scratch_mb: int = 4
    # motion (gp_interconnect_queue_depth analog)
    motion_capacity_slack: float = 1.6  # per-destination bucket headroom
    # split each redistribute into this many sub-exchanges along the
    # capacity axis (row-order identical to one exchange)
    motion_pipeline_buckets: int = 1
