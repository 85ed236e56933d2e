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
    # plan validation (analysis/plancheck.py, checkPlan before dispatch):
    # every planned tree and every spill bucket plan is walked for its
    # Motion, locality and prune invariants; O(plan nodes) of host checks,
    # so on by default, as in the JAX package
    plan_validate: bool = True
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
    # mid-flight enforcement (runtime/runaway.py, the vmem tracker and
    # runaway cleaner): a ceiling on the SUM of in-flight statements'
    # admitted bytes; crossing runaway_red_zone x this flags the heaviest
    # statement, which dies at its next cancellation point. 0 = off
    vmem_global_limit_mb: int = 0
    runaway_red_zone: float = 0.9
    # measured memory accounting (runtime/memaccount.py): per-statement
    # owner trees, the first launch of each cached program measured on the
    # card, and admission by the measured bytes once they exist (the
    # estimate governs on the CPU, which has no allocator to read)
    mem_accounting_enabled: bool = True
    # feedback-driven cost calibration (planner/feedback.py): reconcile
    # per-node actual rows and measured program bytes against the
    # planner's estimates after every execution, and apply the learned
    # per-digest row-scale corrections at plan time (bounded EWMA; a
    # promotion bumps the calibration version so the shape re-plans).
    # Off = estimates stay static
    cost_feedback: bool = True
    # hysteresis band around an applied correction: the EWMA candidate
    # must drift by more than this FACTOR before it re-applies (and
    # re-plans the shapes using it)
    cost_feedback_hysteresis: float = 1.5
    # ---- overload protection (runtime/server.py, runtime/overload.py) --
    # concurrent client connections (0 = unlimited): an excess connect
    # gets one typed too_many_connections frame and the socket closes
    max_connections: int = 100
    # the TCP auth handshake's deadline (0 = off)
    client_auth_deadline_s: float = 10.0
    # idle read deadline between statements (0 = off)
    client_idle_timeout_s: float = 0.0
    # one request frame's bound: past it, frame_too_large and a close
    max_frame_bytes: int = 64 << 20
    # SqlServer.stop(): how long in-flight statements get to end after
    # they are flagged shutdown, before their sockets are force-closed
    server_drain_s: float = 5.0
    # load shedding (runtime/resqueue.shed_check, for the resource queue
    # and the groups): statements WAITING for a slot; at the cap a new
    # one is refused with the typed, retryable AdmissionShed, from
    # admission_shed_ramp x cap on with rising probability. 0 = queue
    admission_queue_limit: int = 0
    admission_shed_ramp: float = 0.75
    # the memory-pressure brownout (runtime/overload.py): the card's
    # allocated bytes at brownout_enter_pct of its memory (or
    # brownout_oom_events OOMs within brownout_window_s) enter it; batch
    # serving stops and the admission ceiling scales by
    # brownout_vmem_factor (brownout_cache_factor scales the block cache,
    # which comes with durable storage, ROADMAP Queue 1 item 1a). It
    # clears once every signal stays below brownout_exit_pct for
    # brownout_exit_s
    brownout_enabled: bool = True
    brownout_enter_pct: float = 0.92
    brownout_exit_pct: float = 0.80
    brownout_oom_events: int = 3
    brownout_window_s: float = 30.0
    brownout_exit_s: float = 5.0
    brownout_cache_factor: float = 0.5
    brownout_vmem_factor: float = 0.5

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
