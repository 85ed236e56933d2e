"""Engine configuration — the port's copy of greengage_tpu/config.py.

Only the settings the ported modules read are kept, under the same names
and defaults as the JAX package's ``Settings``; the rest arrive with the
modules that read them. ``set``/``show`` are the SET/SHOW registry: a name
the port does not hold raises, as an unknown GUC does.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Settings:
    # join probe-chain BOUND: the probe walk runs only as deep as the worst
    # real chain (2-4 at load 1/3); the bound only caps pathological
    # chains, flagging overflow for the bigger-table retry tier
    hash_num_probes: int = 32
    hash_table_min: int = 256
    hash_table_max: int = 1 << 25
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
    motion_retry_tiers: int = 3         # capacity x4 per retry on overflow
    # split each redistribute into this many sub-exchanges along the
    # capacity axis (row-order identical to one exchange); the planner's
    # redistribute overlap credit follows it (exec/session.py)
    motion_pipeline_buckets: int = 1
    # range-repartition window (exec/compile.py _c_motion_range): leading
    # key samples per segment for the splitter pick
    window_range_sample: int = 64

    def set(self, name: str, value) -> None:
        if not hasattr(self, name) or name.startswith("_"):
            raise ValueError(f'unrecognized configuration parameter "{name}"')
        cur = getattr(self, name)
        if isinstance(cur, bool):
            value = str(value).lower() in ("1", "true", "on", "yes")
        elif isinstance(cur, int):
            value = int(value)
        elif isinstance(cur, float):
            value = float(value)
        setattr(self, name, value)

    def show(self, name: str):
        if not hasattr(self, name) or name.startswith("_"):
            raise ValueError(f'unrecognized configuration parameter "{name}"')
        return getattr(self, name)
