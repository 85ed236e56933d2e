"""Resource queues and resource groups in the port (runtime/resqueue.py,
runtime/resgroup.py): tests/test_resqueue.py's and tests/test_resgroup.py's
statements on a port Database (``device="cpu"``), with the JAX package's
rows beside the port's where a statement answers.

``test_groups_persist_across_reopen`` opens a database directory, as the
JAX test does; the other tests run in memory. The JAX tests fill their tables with
INSERT, which waits for ROADMAP Queue 1 item 1b: here ``load_table`` loads
the same rows.
"""

import threading
import time

import numpy as np
import pytest

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu_torch.exec.executor import effective_limit_bytes
from greengage_tpu_torch.runtime.resgroup import GroupTimeout
from greengage_tpu_torch.runtime.resqueue import QueueTimeout
from greengage_tpu_torch.sql.parser import SqlError
from torch_witness import port_witness_armed  # noqa: F401

NQ = 1_000_000


def _queue_tables(d):
    d.sql("create table t (k int, v int) distributed by (k)")
    d.load_table("t", {"k": np.arange(NQ), "v": np.arange(NQ) % 7})
    d.sql("create table d2 (pk int, g int) distributed by (pk)")
    d.load_table("d2", {"pk": np.arange(1, 200), "g": np.arange(1, 200) % 5})
    d.sql("analyze")


SPILL_Q = ("select g, count(*) from t join d2 on t.v + 1 = d2.pk "
           "group by g order by g")


@pytest.fixture(scope="module")
def jrows(devices8):
    d = greengage_tpu.connect(numsegments=4)
    _queue_tables(d)
    return {q: d.sql(q).rows()
            for q in (SPILL_Q, "select count(*) from t")}


@pytest.fixture()
def qdb():
    d = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    _queue_tables(d)
    yield d
    d.close()


# ---- tests/test_resqueue.py ---------------------------------------------

def test_concurrency_gate_queues_then_runs(qdb, jrows):
    qdb.sql("set resource_queue_active = 1")
    order = []
    lock = threading.Lock()

    def q(name):
        r = qdb.sql("select count(*) from t")
        with lock:
            order.append((name, r.rows()))

    ts = [threading.Thread(target=q, args=(f"c{i}",)) for i in range(4)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    want = jrows["select count(*) from t"]
    assert len(order) == 4 and all(r == want for _, r in order)
    st = qdb.resqueue.stats()
    assert st["admitted"] >= 4 and st["active"] == 0 and st["waiting"] == 0


def test_queue_timeout(qdb):
    qdb.sql("set resource_queue_active = 1")
    qdb.sql("set resource_queue_timeout_s = 0.2")
    slot = qdb.resqueue.admit()        # occupy the only slot
    try:
        with pytest.raises(QueueTimeout, match="resource queue slot"):
            qdb.sql("select count(*) from t")
    finally:
        slot.release()
    qdb.sql("set resource_queue_timeout_s = 30")
    assert qdb.sql("select count(*) from t").rows()[0][0] == NQ


def test_queue_memory_cap_spills(qdb, jrows):
    want = qdb.sql(SPILL_Q).rows()
    assert want == jrows[SPILL_Q]
    qdb.sql("set resource_queue_memory_mb = 2")
    try:
        assert effective_limit_bytes(qdb.settings) == 2 << 20
        r = qdb.sql(SPILL_Q)
        assert r.rows() == want
        assert r.stats.get("spill_passes", 0) >= 2
    finally:
        qdb.sql("set resource_queue_memory_mb = 0")
    assert effective_limit_bytes(qdb.settings) \
        == qdb.settings.vmem_protect_limit_mb << 20


# ---- tests/test_resgroup.py ---------------------------------------------

@pytest.fixture()
def gdb():
    d = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    d.sql("create table t (k int, v int) distributed by (k)")
    d.load_table("t", {"k": np.arange(50), "v": np.arange(50)})
    yield d
    d.close()


def test_groups_persist_across_reopen(tmp_path):
    d = greengage_tpu_torch.connect(str(tmp_path / "c"), numsegments=4,
                                    device="cpu")
    d.sql("create resource group rpt with (concurrency=1, cpu_weight=10)")
    d2 = greengage_tpu_torch.connect(str(tmp_path / "c"), device="cpu")
    try:
        st = {g["name"]: g for g in d2.resgroup_status()}
        assert st["rpt"]["concurrency"] == 1 and st["rpt"]["cpu_weight"] == 10
    finally:
        d2.close()
        d.close()


def test_ddl_and_status(gdb):
    db = gdb
    assert db.sql("create resource group etl with (concurrency=2, "
                  "memory_limit_mb=512, cpu_weight=50)") \
        == "CREATE RESOURCE GROUP"
    st = {g["name"]: g for g in db.resgroup_status()}
    assert st["etl"]["concurrency"] == 2
    assert st["etl"]["memory_limit_mb"] == 512
    assert st["default_group"]["cpu_weight"] == 100
    db.sql("alter resource group etl set concurrency 3")
    st = {g["name"]: g for g in db.resgroup_status()}
    assert st["etl"]["concurrency"] == 3
    db.sql("drop resource group etl")
    assert "etl" not in {g["name"] for g in db.resgroup_status()}
    with pytest.raises(ValueError, match="built-in"):
        db.sql("drop resource group default_group")
    with pytest.raises(SqlError, match="unknown resource group option"):
        db.sql("create resource group x with (nope=1)")


def test_status_rows_equal_jax(gdb, devices8):
    """The same DDL gives the JAX package's gp_resgroup_status rows."""
    j = greengage_tpu.connect(numsegments=4)
    ddl = ["create resource group etl with (concurrency=2, "
           "memory_limit_mb=512, cpu_weight=50)",
           "alter resource group etl set cpu_weight 70",
           "create resource group rpt with (concurrency=1)",
           "drop resource group rpt"]
    for q in ddl:
        assert gdb.sql(q) == j.sql(q)
    assert gdb.resgroup_status() == j.resgroup_status()


def test_set_group_and_chip_accounting(gdb):
    db = gdb
    db.sql("create resource group rpt with (concurrency=2)")
    db.sql("set resource_group = rpt")
    assert db.sql("show resource_group") == "rpt"
    assert db.sql("select count(*) from t").rows() == [(50,)]
    st = {g["name"]: g for g in db.resgroup_status()}
    assert st["rpt"]["admitted"] >= 1
    assert st["rpt"]["chip_seconds"] > 0
    db.sql("set resource_group = default_group")
    with pytest.raises(ValueError, match="does not exist"):
        db.sql("set resource_group = nosuch")


def test_concurrency_slots_queue_and_timeout(gdb):
    db = gdb
    db.sql("create resource group one with (concurrency=1)")
    db.sql("set resource_queue_timeout_s = 1")
    slot = db.resgroups.admit("one")
    slot.__enter__()
    try:
        with pytest.raises(GroupTimeout, match="no slot"):
            with db.resgroups.admit("one"):
                pass
    finally:
        slot.__exit__(None, None, None)
    # slot freed: admission works again
    with db.resgroups.admit("one"):
        pass
    st = {g["name"]: g for g in db.resgroup_status()}
    assert st["one"]["timed_out"] == 1 and st["one"]["active"] == 0


def test_group_memory_cap_triggers_spill_or_error(gdb):
    """A tiny per-group memory share forces the spill path (or a clean
    rejection) instead of running uncapped — effective_limit_bytes takes
    the thread's group ceiling."""
    db = gdb
    db.sql("create resource group tiny with (concurrency=1, "
           "memory_limit_mb=1)")
    with db.resgroups.admit("tiny"):
        assert effective_limit_bytes(db.settings) == 1 << 20
    assert effective_limit_bytes(db.settings) in (
        0, db.settings.vmem_protect_limit_mb << 20)


def test_group_memory_cap_makes_a_statement_spill(qdb, jrows):
    """A statement run under a group whose memory share is below its
    estimate answers in spill passes, with the JAX package's rows."""
    qdb.sql("create resource group tiny with (memory_limit_mb=2)")
    qdb.sql("set resource_group = tiny")
    try:
        r = qdb.sql(SPILL_Q)
        assert r.rows() == jrows[SPILL_Q]
        assert r.stats.get("spill_passes", 0) >= 2
    finally:
        qdb.sql("set resource_group = default_group")
    assert "spill_passes" not in qdb.sql(SPILL_Q).stats


def test_backoff_prefers_higher_weight(gdb):
    """With the global cap binding, the waiter from the higher-weight
    (less consumed, weighted) group is admitted first."""
    db = gdb
    db.sql("create resource group fast with (cpu_weight=1000)")
    db.sql("create resource group slow with (cpu_weight=10)")
    db.sql("set resource_group_global_active = 1")
    db.sql("set resource_queue_timeout_s = 20")
    # charge both groups with identical raw chip time: weighted consumed
    # = t/1000 vs t/10 -> "fast" should win the next free slot
    for g in ("fast", "slow"):
        db.resgroups.groups[g].consumed_s = 5.0
    hold = db.resgroups.admit("default_group")
    hold.__enter__()
    order = []

    def worker(g):
        with db.resgroups.admit(g):
            order.append(g)

    ts = [threading.Thread(target=worker, args=("slow",)),
          threading.Thread(target=worker, args=("fast",))]
    ts[0].start()
    time.sleep(0.2)   # slow is first in line FIFO-wise
    ts[1].start()
    time.sleep(0.2)
    hold.__exit__(None, None, None)   # one slot frees -> scheduler picks
    [t.join(10) for t in ts]
    assert order[0] == "fast", order
    db.sql("set resource_group_global_active = 0")
