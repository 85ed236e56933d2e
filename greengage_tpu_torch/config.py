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
    # memory protection (gp_vmem_protect_limit analog): estimated device
    # bytes one segment of a statement may allocate; past it the statement
    # runs in spill passes (exec/spill.py). 0 disables the check. On a
    # card every segment shares, the executor also caps it at the card's
    # memory over the segments it holds (exec/executor.py)
    vmem_protect_limit_mb: int = 12288
    # on a device out-of-memory error the statement demotes to the spill
    # path once before surfacing the typed OutOfDeviceMemory
    oom_spill_retry: bool = True
    # staging read pool (exec/staging.py): 0 = auto (min(8, cpu count)),
    # 1 = read on the statement's thread
    scan_threads: int = 0
    # tiered spill workfile (exec/workfile.py): captured passes stay in
    # host RAM up to spill_host_limit_mb per statement, then the coldest
    # demote to compressed files under spill_dir (empty = a directory of
    # the Database's own, made on first use). 0 = RAM only
    spill_dir: str = ""
    spill_host_limit_mb: int = 512
    # window-partition spill (exec/spill.py spill_window_run); off = the
    # admission rejection
    window_spill_enabled: bool = True
    # plan cache (exec/session.py _cached_plan): plan_cache_params hoists
    # plan-safe literals into a parameter vector (sql/paramize.py) so one
    # bound plan serves every value of a statement shape; plan_cache_size
    # bounds the bound-plan LRU and the executor's per-statement cap hints
    plan_cache_params: bool = True
    plan_cache_size: int = 256
    # statement lifecycle (runtime/interrupt.py): statement_timeout_s arms
    # a deadline at statement start; the statement dies at its next
    # cancellation point (boundary-granular — a launched program runs to
    # its end). 0 disables
    statement_timeout_s: float = 0.0
    # statement traces (runtime/trace.py): per-phase spans for every
    # statement, the newest trace_ring_size kept
    trace_enabled: bool = True
    trace_ring_size: int = 64
    # resource queue (runtime/resqueue.py, the ResLockPortal analog):
    # concurrent statements (0 = unlimited), a per-query estimated device
    # memory ceiling (tightens effective_limit_bytes, so a capped query
    # spills) and how long a statement may queue
    resource_queue_active: int = 0
    resource_queue_memory_mb: int = 0
    resource_queue_timeout_s: float = 30.0
    # resource groups (runtime/resgroup.py): a cap on concurrent statements
    # over every group; when it binds, the group with the least weighted
    # device time goes next
    resource_group_global_active: int = 0
    # batched serving (exec/batchserve.py): same-shape SELECTs that differ
    # only in hoisted literals run as ONE batched program over their
    # stacked parameter vectors. batch_window_ms bounds how long a member
    # waits for batch-mates while the pipeline is busy (an idle pipeline
    # flushes at once), batch_max_width flushes a full window and bounds
    # the width (programs are built per pow2 width bucket), and past
    # batch_queue_limit waiting members new statements run serially
    batch_serving_enabled: bool = False
    batch_window_ms: float = 2.0
    batch_max_width: int = 16
    batch_queue_limit: int = 512

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
