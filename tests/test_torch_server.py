"""The port's SQL server (greengage_tpu_torch/runtime/server.py) against the
JAX package's, and the JAX server tests replayed on the port.

- Frame for frame: the same statement over the same numpy data (TPC-H at
  SF 0.01, 8 segments, both analyzed) gives the JAX server's frame
  exactly: TPC-H Q1, Q3 and Q6, a statement with NULLs, DECIMAL, dates
  and TEXT, an error frame and a SET frame. The ``cuda`` twin serves a
  port Database on the card.
- tests/test_interrupt.py's three server tests (a cancel frame from a
  second connection, a client gone mid-statement, a client gone
  mid-exchange).
- tests/test_observability.py's exposition, gauge-tagging and server
  metrics/trace tests.
- tests/test_concurrency.py's concurrent clients, with reads in place of
  the JAX test's INSERT and UPDATE (DML is ROADMAP Queue 1 item 1b).
- tests/test_remote_auth.py but ``test_useradd_cli`` (the ``gg`` CLI is
  item 11); ``test_tcp_auth_roundtrip`` without its INSERT (item 1b).

Counters are read as deltas; every test stops its server.
"""

import json
import re
import socket
import threading
import time

import numpy as np
import pytest
import torch

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu.analysis.plancorpus import TPCH_QUERIES
from greengage_tpu.runtime import server as jserver
from greengage_tpu.utils import tpch as jtpch
from greengage_tpu_torch.runtime import auth
from greengage_tpu_torch.runtime.faultinject import faults
from greengage_tpu_torch.runtime.interrupt import REGISTRY
from greengage_tpu_torch.runtime.logger import counters, prometheus_text
from greengage_tpu_torch.runtime.server import SqlClient, SqlServer
from greengage_tpu_torch.utils import tpch as ttpch

SF = 0.01

FRAMES = {
    "q1": TPCH_QUERIES["q1_pricing_summary"],
    "q3": TPCH_QUERIES["q3_shipping_priority"],
    "q6": TPCH_QUERIES["q6_forecast_revenue"],
    "nulls_decimal_dates_text": (
        "select o_orderkey, o_orderdate, o_totalprice, o_orderpriority, "
        "case when o_orderkey % 3 = 0 then null else o_totalprice end "
        "as maybe from orders order by o_orderkey limit 7"),
    "error": "select * from nosuch",
    "set": "set statement_timeout_s = 0",
}


def _tpch_db(device):
    d = greengage_tpu_torch.connect(numsegments=8, device=device)
    ttpch.load(d, SF)
    d.sql("analyze")
    return d


@pytest.fixture(scope="module")
def jax_frames(devices8, tmp_path_factory):
    """The JAX server's frame for each statement of FRAMES."""
    d = greengage_tpu.connect(numsegments=8)
    d.settings.cost_feedback = False
    jtpch.load(d, SF)
    d.sql("analyze")
    sock = str(tmp_path_factory.mktemp("jax") / "j.sock")
    srv = jserver.SqlServer(d, sock)
    srv.start()
    try:
        c = jserver.SqlClient(sock)
        out = {k: c.op({"sql": q}) for k, q in FRAMES.items()}
        c.close()
    finally:
        srv.stop()
        d.close()
    return out


def _port_frames(db, path) -> dict:
    srv = SqlServer(db, str(path / "t.sock"))
    srv.start()
    try:
        c = SqlClient(str(path / "t.sock"))
        out = {k: c.op({"sql": q}) for k, q in FRAMES.items()}
        c.close()
    finally:
        srv.stop()
    return out


@pytest.fixture(scope="module")
def port_frames(tmp_path_factory):
    d = _tpch_db("cpu")
    try:
        return _port_frames(d, tmp_path_factory.mktemp("port"))
    finally:
        d.close()


@pytest.mark.parametrize("name", list(FRAMES))
def test_frames_match_jax_server(name, jax_frames, port_frames):
    assert port_frames[name] == jax_frames[name]
    if name == "error":
        assert port_frames[name]["ok"] is False
    elif name == "set":
        assert port_frames[name]["tag"] == "SET"
    else:
        assert port_frames[name]["rows"]


@pytest.mark.cuda
def test_frames_match_jax_server_on_the_card(jax_frames, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = _tpch_db(None)
    try:
        assert d.device.type == "cuda"
        assert _port_frames(d, tmp_path) == jax_frames
    finally:
        d.close()


# ---------------------------------------------------------------------------
# tests/test_interrupt.py: the cancel protocol and client_gone
# ---------------------------------------------------------------------------

N = 50_000


@pytest.fixture(scope="module")
def db():
    d = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    d.sql("create table li (k int, g int, v int) distributed by (k)")
    d.load_table("li", {"k": np.arange(N), "g": np.arange(N) % 11,
                        "v": np.arange(N) % 7})
    d.sql("create table acc (id int, bal int) distributed by (id)")
    d.load_table("acc", {"id": np.arange(40, dtype=np.int32),
                         "bal": np.full(40, 100, dtype=np.int32)})
    d.sql("analyze")
    yield d
    faults.reset()
    d.close()


def test_server_cancel_frame_and_typed_error(db, tmp_path):
    sock = str(tmp_path / "gg.sock")
    srv = SqlServer(db, sock)
    srv.start()
    faults.inject("cancel_before_dispatch", "sleep", sleep_s=2.0,
                  occurrences=1)
    try:
        err = {}

        def client_victim():
            c = SqlClient(sock)
            try:
                c.sql("select sum(v) from li -- wire-victim")
                err["e"] = None
            except Exception as e:
                err["e"] = e
            finally:
                c.close()

        t = threading.Thread(target=client_victim)
        t.start()
        # a SECOND connection finds and cancels it
        c2 = SqlClient(sock)
        end = time.monotonic() + 5
        sid = None
        while time.monotonic() < end and sid is None:
            for row in c2.op({"op": "ps"}).get("rows", []):
                if "wire-victim" in row["sql"]:
                    sid = row["id"]
            time.sleep(0.02)
        assert sid is not None, "ps never showed the in-flight statement"
        assert c2.op({"op": "cancel", "id": sid}) == {"ok": True}
        assert c2.op({"op": "cancel", "id": 999999})["ok"] is False
        assert c2.op({"op": "bogus"})["ok"] is False
        c2.close()
        t.join(timeout=15)
        assert not t.is_alive()
        assert err["e"] is not None
        assert "cancel" in str(err["e"]).lower()
    finally:
        faults.reset("cancel_before_dispatch")
        srv.stop()


def test_client_disconnect_cancels_in_flight_statement(db, tmp_path):
    sock = str(tmp_path / "gg.sock")
    srv = SqlServer(db, sock)
    srv.start()
    faults.inject("cancel_before_dispatch", "sleep", sleep_s=3.0,
                  occurrences=1)
    base = counters.get("statements_cancelled_client_gone")
    try:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(sock)
        s.sendall((json.dumps(
            {"sql": "select sum(v) from li -- gone-victim"}) + "\n")
            .encode())
        time.sleep(0.5)           # statement parked at the fault sleep
        s.close()                 # client vanishes mid-statement
        end = time.monotonic() + 15
        while counters.get("statements_cancelled_client_gone") == base \
                and time.monotonic() < end:
            time.sleep(0.05)
        assert counters.get("statements_cancelled_client_gone") == base + 1
        end = time.monotonic() + 5
        while any("gone-victim" in r["sql"] for r in REGISTRY.snapshot()) \
                and time.monotonic() < end:
            time.sleep(0.05)
        assert not any("gone-victim" in r["sql"]
                       for r in REGISTRY.snapshot())
        c = SqlClient(sock)
        assert c.sql("select count(*) from li")["rows"][0][0] == N
        c.close()
    finally:
        faults.reset("cancel_before_dispatch")
        srv.stop()


def test_server_survives_client_disconnect_mid_exchange(db, tmp_path):
    sock = str(tmp_path / "gg.sock")
    srv = SqlServer(db, sock)
    srv.start()
    try:
        for _ in range(3):
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.connect(sock)
            s.sendall((json.dumps(
                {"sql": "select count(*) from li"}) + "\n").encode())
            s.close()                       # gone before reading the rows
        time.sleep(0.3)
        c = SqlClient(sock)                 # the server still serves
        assert c.sql("select count(*) from li")["rows"][0][0] == N
        c.close()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# tests/test_observability.py: the exposition and the server's ops
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{le="([^"\\]+)"\})? '
    r'(-?[0-9.]+(?:[eE][+-]?[0-9]+)?|\+Inf|NaN)$')
_TYPE_RE = re.compile(r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) "
                      r"(counter|gauge|histogram|summary|untyped)$")


def _parse_exposition(text):
    """prometheus_client-style text parser: every line is a sample, a
    # TYPE comment, or blank; TYPE precedes its family's samples."""
    types, samples = {}, {}
    for ln in text.splitlines():
        if not ln.strip():
            continue
        m = _TYPE_RE.match(ln)
        if m:
            assert m.group(1) not in types, f"duplicate TYPE: {ln}"
            types[m.group(1)] = m.group(2)
            continue
        assert not ln.startswith("#"), f"unknown comment: {ln}"
        m = _SAMPLE_RE.match(ln)
        assert m, f"unparseable sample line: {ln!r}"
        name, _, le, val = m.groups()
        fam = re.sub(r"_(bucket|sum|count)$", "", name) \
            if name.endswith(("_bucket", "_sum", "_count")) else name
        assert fam in types or name in types, f"sample before TYPE: {ln}"
        samples.setdefault(name, []).append(
            (le, float(val.replace("+Inf", "inf"))))
    return types, samples


def test_metrics_exposition_parses(db):
    db.sql("select count(*) from li")
    text = prometheus_text()
    types, samples = _parse_exposition(text)
    # counter vs gauge typing: the JAX test reads mh_topology_version,
    # multihost state (ROADMAP Queue 1 item 8); a gauge the port writes
    # takes its place
    assert types.get("ggtpu_mem_est_error_pct") == "gauge"
    assert types.get("ggtpu_plan_cache_hit", "counter") == "counter"
    assert types.get("ggtpu_statement_ms") == "histogram"
    buckets = samples["ggtpu_statement_ms_bucket"]
    vals = [v for _le, v in buckets]
    assert vals == sorted(vals), "buckets must be cumulative"
    inf = [v for le, v in buckets if le == "+Inf"]
    count = samples["ggtpu_statement_ms_count"][0][1]
    assert inf and inf[0] == count
    assert count >= 1
    assert samples["ggtpu_statement_ms_sum"][0][1] >= 0
    for fam in ("ggtpu_stage_ms", "ggtpu_dispatch_ms", "ggtpu_fetch_ms",
                "ggtpu_queue_wait_ms"):
        assert types.get(fam) == "histogram", sorted(types)


def test_gauge_tagging_on_counters():
    counters.set("mh_topology_version", 7)
    counters.inc("some_test_counter_obs")
    assert "mh_topology_version" in counters.gauges()
    assert counters.kind("mh_topology_version") == "gauge"
    assert counters.kind("some_test_counter_obs") == "counter"


def test_server_metrics_and_trace_ops(db, tmp_path):
    srv = SqlServer(db, str(tmp_path / "obs.sock"))
    srv.start()
    try:
        c = SqlClient(str(tmp_path / "obs.sock"))
        c.sql("select count(*) from li")
        m = c.op({"op": "metrics"})
        assert m["ok"] and "# TYPE ggtpu_statement_ms histogram" in m["text"]
        _parse_exposition(m["text"])
        t = c.op({"op": "trace"})
        assert t["ok"], t
        evs = t["trace"]["traceEvents"]
        assert any(e.get("name") == "statement" for e in evs)
        ps = c.op({"op": "ps"})
        assert ps["ok"]
        bad = c.op({"op": "trace", "id": 99999999})
        assert not bad["ok"]
        # what waits for a later slice answers typed, naming its item
        for op, item in (("checkperf", "1g"), ("stream_begin", "10")):
            r = c.op({"op": op})
            assert r["ok"] is False and r["code"] == "not_ported"
            assert f"item {item}" in r["error"]
        assert "item 10" in ps["ingest"]["error"]
        st = c.op({"op": "status"})
        assert st["cluster"]["state"] == "local"
        c.close()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# tests/test_concurrency.py: concurrent clients on one Database
# ---------------------------------------------------------------------------

def test_server_concurrent_clients(db, tmp_path):
    sock = str(tmp_path / "gg.sock")
    srv = SqlServer(db, sock)
    srv.start()
    try:
        results = {}
        errs = []

        def client(name, stmts):
            try:
                c = SqlClient(sock)
                out = [c.sql(s) for s in stmts]
                results[name] = out
                c.close()
            except Exception as e:
                errs.append(e)

        # the JAX test's writer INSERTs and UPDATEs (ROADMAP Queue 1 item
        # 1b): here it SETs and reads its own row
        ts = [
            threading.Thread(target=client, args=("r1", [
                "select count(*) from acc"] * 5)),
            threading.Thread(target=client, args=("w", [
                "set statement_timeout_s = 0",
                "select count(*) from acc where id >= 20",
                "select bal from acc where id = 8"])),
            threading.Thread(target=client, args=("r2", [
                "select sum(bal) from acc"] * 5)),
        ]
        [t.start() for t in ts]
        [t.join() for t in ts]
        assert not errs, errs
        assert results["w"][0]["tag"] == "SET"
        assert results["w"][2]["rows"] == [[100]]
        assert all(r["rows"] == [[40]] for r in results["r1"])
        assert all(r["rows"] == [[4000]] for r in results["r2"])
        # errors are per-statement: the connection stays usable
        c = SqlClient(sock)
        with pytest.raises(RuntimeError):
            c.sql("select * from nosuch")
        assert c.sql("select count(*) from acc")["rows"][0][0] == 40
        c.close()
        assert srv.connections_served >= 4
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# tests/test_remote_auth.py: TCP with challenge-response authentication
# ---------------------------------------------------------------------------

@pytest.fixture()
def served(tmp_path):
    d = greengage_tpu_torch.connect(numsegments=2, device="cpu")
    d.sql("create table t (a int) distributed by (a)")
    d.load_table("t", {"a": np.array([1, 2, 3], dtype=np.int32)})
    auth.add_user(d.path, "alice", "s3cret")
    srv = SqlServer(d, str(tmp_path / "s.sock"), host="127.0.0.1", port=0)
    srv.start()
    yield d, srv, str(tmp_path / "s.sock")
    srv.stop()
    d.close()


def test_tcp_auth_roundtrip(served):
    _, srv, _ = served
    c = SqlClient(host="127.0.0.1", port=srv.port,
                  user="alice", password="s3cret")
    r = c.sql("select count(*), sum(a) from t")
    assert r["rows"] == [[3, 6]]
    # the JAX test INSERTs a row here (ROADMAP Queue 1 item 1b)
    assert c.sql("select count(*) from t where a > 1")["rows"] == [[2]]
    c.close()


def test_wrong_password_rejected(served):
    _, srv, _ = served
    with pytest.raises(PermissionError, match="authentication failed"):
        SqlClient(host="127.0.0.1", port=srv.port,
                  user="alice", password="nope")


def test_unknown_user_rejected_without_leaking(served):
    _, srv, _ = served
    s = socket.create_connection(("127.0.0.1", srv.port))
    f = s.makefile("rwb")
    f.write((json.dumps({"user": "mallory"}) + "\n").encode())
    f.flush()
    ch = json.loads(f.readline())
    assert set(ch) == {"auth", "salt", "nonce"}
    f.write((json.dumps({"proof": "0" * 64}) + "\n").encode())
    f.flush()
    assert json.loads(f.readline())["ok"] is False
    s.close()


def test_password_never_on_wire(served):
    _, srv, _ = served
    s = socket.create_connection(("127.0.0.1", srv.port))
    f = s.makefile("rwb")
    f.write((json.dumps({"user": "alice"}) + "\n").encode())
    f.flush()
    ch = json.loads(f.readline())
    proof = auth.prove(ch["salt"], ch["nonce"], "s3cret")
    assert "s3cret" not in proof
    f.write((json.dumps({"proof": proof}) + "\n").encode())
    f.flush()
    assert json.loads(f.readline())["ok"] is True
    s.close()


def test_unix_socket_stays_trusted(served):
    _, _, sock = served
    c = SqlClient(sock)
    assert c.sql("select 1 + 1")["rows"] == [[2]]
    c.close()


def test_unknown_user_salt_is_stable(served):
    _, srv, _ = served
    salts = []
    for _ in range(2):
        s = socket.create_connection(("127.0.0.1", srv.port))
        f = s.makefile("rwb")
        f.write((json.dumps({"user": "ghost"}) + "\n").encode())
        f.flush()
        salts.append(json.loads(f.readline())["salt"])
        s.close()
    assert salts[0] == salts[1]


def test_dropped_handshake_no_traceback(served):
    _, srv, _ = served
    s = socket.create_connection(("127.0.0.1", srv.port))
    s.close()          # drop before the hello; server must not traceback
    c = SqlClient(host="127.0.0.1", port=srv.port,
                  user="alice", password="s3cret")
    assert c.sql("select 1")["rows"] == [[1]]
    c.close()


def test_users_file_is_private_and_beside_the_log(served):
    """add_user writes gg_hba.json 0600 into the Database's scratch
    directory, which close() removes with the cluster log."""
    import os

    d, _, _ = served
    path = os.path.join(d.path, "gg_hba.json")
    assert (os.stat(path).st_mode & 0o777) == 0o600
    assert "alice" in auth.load_users(d.path)
    assert auth.load_users(d.path)["alice"]["hash"] != "s3cret"
