"""Line-protocol SQL server — the port's copy of
greengage_tpu/runtime/server.py (the postmaster/libpq listener analog).

A thin concurrent front end over one Database: clients connect to a unix
socket (or a TCP port) and exchange newline-delimited JSON:

    -> {"sql": "select ..."}
    <- {"ok": true, "columns": [...], "rows": [[...], ...], "tag": null}
    <- {"ok": false, "error": "..."}

Control frames ride the same protocol, served from another connection
since the executing one is blocked in its statement:

    -> {"op": "ps"}               <- {"ok": true, "rows": [activity...]}
    -> {"op": "cancel", "id": N}  <- {"ok": true/false}
    -> {"op": "trace"[, "id": N]} <- {"ok": true, "trace": {chrome json}}
    -> {"op": "metrics"}          <- {"ok": true, "text": "<prometheus>"}
    -> {"op": "mem"}              <- {"ok": true, "mem": {device/accounts}}
    -> {"op": "status"}           <- {"ok": true, "cluster": ..., "overload"}

Each connection gets a thread calling ``db.sql`` (one Database serves
many threads: exec/session.py); a disconnect observed mid-statement
cancels the connection's in-flight statement with cause ``client_gone``
instead of letting the broken pipe escape into socketserver. Unix-socket
peers are trusted; TCP peers authenticate by challenge-response against
the Database's ``gg_hba.json`` (runtime/auth.py).

Overload armor (the JAX package's docs/ROBUSTNESS.md "Overload
protection") — the front end is bounded in every dimension a hostile or
overloaded client could grow it:

  * ``max_connections`` caps concurrent handler threads; an excess
    connect receives one typed, retryable ``too_many_connections`` frame
    (the SQLSTATE 53300 fast-fail) and the socket closes.
    ``connections_shed_total`` counts the sheds and the
    ``server_active_connections`` gauge the live population; the
    ``overload_accept`` fault point forces the shed path in tests.
  * ``client_auth_deadline_s`` bounds the TCP auth handshake and
    ``client_idle_timeout_s`` (optional) bounds idle reads between
    statements.
  * ``max_frame_bytes`` bounds one request frame; an oversized line gets
    a typed ``frame_too_large`` error and the connection closes.
  * load-shed errors from admission (``AdmissionShed``,
    runtime/resqueue.py) map to a typed retryable ``admission_shed``
    frame with ``"sqlstate": "53300"``.
  * ``stop()`` drains gracefully: stop accepting, flag in-flight
    statements with cause ``shutdown``, a bounded join
    (``server_drain_s``), then force-close stragglers.

Disconnect watching is one ``_ConnWatcher`` thread per connection, armed
around each statement and parked between them.

What waits for later slices of the port: the ``checkperf`` op (the
feedback store, ROADMAP Queue 1 item 1g) and the ``stream_*`` ops and the
``ingest`` keys of ``ps`` and ``status`` (the streaming ingest plane, item
10) answer with a typed error naming their item; the coordinator-failover
frame (57P01) waits for multi-GPU (item 8), since no statement of a
single-card Database can fail over; and a dropped connection has no
transaction to roll back nor cursors to close until durable storage and
cursors arrive (items 1a and 1h). The ``gg`` CLI over this server is item
11. The server's locks are plain ``threading.Lock`` objects: the JAX
package's lock-order debugging wrapper comes with item 10.
"""

from __future__ import annotations

import errno
import json
import os
import socket
import socketserver
import threading
import time
import select

from greengage_tpu_torch.runtime import overload as _overload
from greengage_tpu_torch.runtime.faultinject import FaultError, faults
from greengage_tpu_torch.runtime.interrupt import REGISTRY, StatementCancelled
from greengage_tpu_torch.runtime.logger import counters
from greengage_tpu_torch.runtime.resqueue import AdmissionShed

# select/recv errnos that genuinely prove the peer (or our own fd) is
# gone; anything else is a TRANSIENT poll hiccup that must NOT cancel a
# live client's statement (the old behavior treated every OSError as an
# EOF and killed healthy statements on a spurious select failure)
_WATCH_FATAL_ERRNOS = frozenset({
    errno.EBADF, errno.ENOTCONN, errno.ECONNRESET, errno.EPIPE,
    errno.ESHUTDOWN, errno.ECONNABORTED,
})

# consecutive transient poll failures before the watcher gives up on the
# CURRENT statement (without cancelling — losing disconnect detection is
# the lesser harm vs cancelling a live client's work)
_WATCH_TRANSIENT_LIMIT = 5


# ops a later slice of the port brings -> what they wait for
_INGEST = "the streaming ingest plane: ROADMAP Queue 1 item 10"
_LATER_OPS = {"checkperf": "the feedback store: ROADMAP Queue 1 item 1g",
              "stream_begin": _INGEST, "stream_rows": _INGEST,
              "stream_end": _INGEST}


def _later(what: str, item: str) -> dict:
    """The typed answer of a part that waits for a later slice."""
    return {"ok": False, "code": "not_ported",
            "error": f"{what} is not ported yet ({item})"}


def _watch_tick(sock) -> str:
    """One disconnect-watch poll of the client socket. Returns:
    ``eof``   — the peer closed (or our fd is gone): the statement has
                nobody to read it;
    ``data``  — a pipelined request is buffered (client alive; the byte
                is PEEKed, never consumed);
    ``idle``  — nothing readable;
    ``transient`` — the poll itself failed for a reason that does not
                prove the peer is gone (spurious select error)."""
    try:
        r, _, _ = select.select([sock], [], [], 0)
        if not r:
            return "idle"
        if sock.recv(1, socket.MSG_PEEK | socket.MSG_DONTWAIT) == b"":
            return "eof"
        return "data"
    except (BlockingIOError, InterruptedError):
        return "idle"
    except ValueError:
        return "eof"       # fd already closed on our side (drain/teardown)
    except OSError as e:
        if e.errno in _WATCH_FATAL_ERRNOS:
            return "eof"
        return "transient"


class _ConnWatcher:
    """One client-disconnect watcher per CONNECTION: while the handler
    thread is blocked inside db.sql(), only a peeker can observe the
    client's EOF and flag the statement ``client_gone`` so it dies at
    its next cancellation point instead of running to completion for
    nobody. The handler arms the watcher around each statement; between
    statements (and after observing pipelined DATA, which means the
    client is alive) it parks on its condition instead of exiting, so
    one thread serves the whole connection's statement stream."""

    POLL_S = 0.1

    def __init__(self, sock, thread_ident: int):
        self._sock = sock
        self._ident = thread_ident
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._armed = False
        self._stopping = False
        # arm/disarm epoch: a self-disarm (pipelined data / transient
        # streak) must not erase an arm() the handler issued for the
        # NEXT statement in the meantime
        self._gen = 0
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="gg-client-watch")
        self._thread.start()

    def arm(self) -> None:
        with self._cv:
            self._gen += 1
            self._armed = True
            self._cv.notify_all()

    def disarm(self) -> None:
        with self._cv:
            self._gen += 1
            self._armed = False

    def shutdown(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        self._thread.join(timeout=1.0)

    def _loop(self) -> None:
        transient = 0
        while True:
            with self._cv:
                while not self._armed and not self._stopping:
                    self._cv.wait(0.5)
                if self._stopping:
                    return
                gen = self._gen
            state = _watch_tick(self._sock)
            if state == "eof":
                REGISTRY.cancel_thread(self._ident, "client_gone")
                return
            if state == "data":
                # buffered pipelined request: client alive — stop
                # watching THIS statement (never consume the byte)
                transient = 0
                self._self_disarm(gen)
                continue
            if state == "transient":
                transient += 1
                if transient >= _WATCH_TRANSIENT_LIMIT:
                    # a persistent poll failure proves nothing about the
                    # peer: give up on this statement WITHOUT cancelling
                    transient = 0
                    self._self_disarm(gen)
                    continue
            else:
                transient = 0
            time.sleep(self.POLL_S)

    def _self_disarm(self, gen: int) -> None:
        with self._cv:
            if self._gen == gen:   # handler has not re-armed since
                self._armed = False


def _pipeline_depths(db) -> dict:
    """Serving-pipeline queue depths for the ps/status frames: members
    waiting in batched-serving admission windows, batches staged but not
    demuxed, and the staging pools' read-unit backlog."""
    from greengage_tpu_torch.exec import staging

    out = {"staging_pool_queue_depth": staging.pool_queue_depth()}
    bs = getattr(db, "_batch_server", None)
    if bs is not None:
        try:
            out.update(bs.queue_depths())
        except Exception:
            pass
    return out


def _cluster_status(db) -> dict:
    """Topology state for the ps/status control frames: a single-card
    Database answers as the JAX package's single-host one does (multi-GPU
    topologies are ROADMAP Queue 1 item 8)."""
    try:
        return {"state": "local",
                "topology_version": db.catalog.segments.version}
    except AttributeError:
        return {"state": "unknown", "topology_version": None}


def _encode_value(v):
    import numpy as np

    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return str(v)


class SqlServer:
    def __init__(self, db, socket_path: str, host: str | None = None,
                 port: int | None = None):
        self.db = db
        self.socket_path = socket_path
        self.host, self.port = host, port
        self._server = None
        self._tcp_server = None
        self._thread = None
        self._tcp_thread = None
        # connection admission/drain state, shared with every handler
        # thread (all mutation under _conn_mu)
        self._conn_mu = threading.Lock()
        self._active_conns = 0
        self._served = 0
        self._draining = False
        self._conns: dict = {}      # thread ident -> client socket
        self._handlers: dict = {}   # thread ident -> handler Thread

    @property
    def connections_served(self) -> int:
        with self._conn_mu:
            return self._served

    # ---- bounded front end (admission / drain) -----------------------
    def _admit_connection(self, sock) -> tuple | None:
        """Admit the calling handler thread, or return the typed shed
        ``(code, message)``. The cap check and the bookkeeping are one
        atomic step under _conn_mu — two racing connects cannot both
        claim the last slot (the connections_served data race this
        replaces was exactly that shape)."""
        limit = int(getattr(self.db.settings, "max_connections", 0))
        try:
            forced = faults.check("overload_accept")
        except FaultError:
            forced = True
        me = threading.current_thread()
        with self._conn_mu:
            if self._draining:
                shed = ("shutting_down", "server is shutting down")
            elif forced or (limit > 0 and self._active_conns >= limit):
                shed = ("too_many_connections",
                        f"too many connections (max_connections={limit}, "
                        f"active={self._active_conns})")
            else:
                shed = None
                self._active_conns += 1
                self._served += 1
                self._conns[me.ident] = sock
                self._handlers[me.ident] = me
                # gauge set INSIDE the lock: a set outside with a
                # captured count can land out of order against a racing
                # release and leave the gauge wrong forever
                counters.set("server_active_connections",
                             self._active_conns)
        if shed is not None:
            counters.inc("connections_shed_total")
            self.db.log.log("WARNING", "overload",
                            f"connection shed: {shed[1]}")
            return shed
        counters.inc("server_connections_total")
        return None

    def _release_connection(self) -> None:
        me = threading.get_ident()
        with self._conn_mu:
            if self._conns.pop(me, None) is not None:
                self._active_conns -= 1
            self._handlers.pop(me, None)
            counters.set("server_active_connections",
                         self._active_conns)   # under the lock: ordered

    def _draining_now(self) -> bool:
        with self._conn_mu:
            return self._draining

    # ------------------------------------------------------------------
    def start(self) -> None:
        if os.path.exists(self.socket_path):
            os.remove(self.socket_path)
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            REMOTE = False   # TCP subclass flips this: remote => auth

            def handle(self):
                shed = outer._admit_connection(self.connection)
                if shed is not None:
                    # typed fast-fail (SQLSTATE 53300 analog): one frame,
                    # then the socket closes — the client can back off
                    # and retry instead of hanging on a dead connection
                    self._send({"ok": False, "error": shed[1],
                                "code": shed[0], "sqlstate": "53300",
                                "retryable": True})
                    return
                try:
                    if self.REMOTE and not self._authenticate():
                        return
                    self._serve()
                finally:
                    # the JAX server also rolls back an open transaction
                    # and closes the connection's cursors here; the port
                    # has neither (ROADMAP Queue 1 items 1a and 1h)
                    outer._release_connection()

            def _send(self, obj: dict) -> None:
                """Best-effort frame write: a peer that vanished before
                reading its typed error is not an event worth a
                traceback."""
                try:
                    self.wfile.write((json.dumps(obj) + "\n").encode())
                    self.wfile.flush()
                except (OSError, ValueError):
                    pass

            def _authenticate(self) -> bool:
                """Challenge-response over TCP (auth.c role): unix-socket
                peers are trusted, remote peers must prove a gg_hba.json
                password without sending it (runtime/auth.py). The whole
                handshake is bounded by client_auth_deadline_s — a peer
                that connects and goes silent cannot pin this handler."""
                from greengage_tpu_torch.runtime import auth

                deadline = float(getattr(outer.db.settings,
                                         "client_auth_deadline_s", 10.0))
                old_timeout = self.connection.gettimeout()
                if deadline > 0:
                    self.connection.settimeout(deadline)
                users = auth.load_users(outer.db.path)
                ok = False
                timed_out = False
                try:
                    hello = json.loads(self.rfile.readline() or b"{}")
                    user = str(hello.get("user", ""))
                    ch = auth.challenge(users, user, outer.db.path)
                    self.wfile.write((json.dumps(ch) + "\n").encode())
                    self.wfile.flush()
                    resp = json.loads(self.rfile.readline() or b"{}")
                    ok = auth.verify(users, user, ch["nonce"],
                                     str(resp.get("proof", "")))
                    self.wfile.write((json.dumps(
                        {"ok": ok, "error": None if ok
                         else "authentication failed"}) + "\n").encode())
                    self.wfile.flush()
                except (socket.timeout, TimeoutError):
                    # silent peer past the deadline: shed the handler
                    ok = False
                    timed_out = True
                except Exception:
                    # dropped peers and malformed handshakes must not
                    # traceback per port-scan probe
                    ok = False
                finally:
                    try:
                        self.connection.settimeout(old_timeout)
                    except OSError:
                        pass
                if timed_out:
                    counters.inc("connections_shed_total")
                    outer.db.log.log(
                        "WARNING", "overload",
                        f"auth handshake exceeded client_auth_deadline_s"
                        f"={deadline:g}; connection closed")
                elif not ok:
                    outer.db.log.log("WARNING", "auth",
                                     "remote authentication failed")
                return ok

            def _serve(self):
                me = threading.get_ident()
                watcher = None
                settings = outer.db.settings
                idle_s = float(getattr(settings,
                                       "client_idle_timeout_s", 0.0))
                max_frame = int(getattr(settings,
                                        "max_frame_bytes", 64 << 20))
                if idle_s > 0:
                    try:
                        self.connection.settimeout(idle_s)
                    except OSError:
                        return
                try:
                    while True:
                        try:
                            line = self.rfile.readline(max_frame + 1)
                        except (socket.timeout, TimeoutError):
                            # idle past the deadline: typed goodbye
                            self._send({
                                "ok": False, "code": "idle_timeout",
                                "error": "connection idle beyond client_"
                                         f"idle_timeout_s={idle_s:g}; "
                                         "closing"})
                            return
                        if not line:
                            return      # EOF: client closed cleanly
                        if len(line) > max_frame:
                            # the stream cannot be resynced past a
                            # partially-read oversized line: reject AND
                            # close, so a multi-GB frame costs the host
                            # max_frame_bytes, not its full length
                            counters.inc("frames_rejected_total")
                            self._send({
                                "ok": False, "code": "frame_too_large",
                                "error": "request frame exceeds "
                                         f"max_frame_bytes={max_frame}; "
                                         "closing connection"})
                            return
                        line = line.strip()
                        if not line:
                            continue
                        if outer._draining_now():
                            self._send({
                                "ok": False, "code": "shutting_down",
                                "sqlstate": "53300", "retryable": True,
                                "error": "server is shutting down"})
                            return
                        try:
                            req = json.loads(line)
                            if "op" in req and "sql" not in req:
                                resp = self._control(req)
                            else:
                                # watch for a mid-statement disconnect:
                                # this thread is blocked in db.sql(), so
                                # only a peeker can observe the EOF and
                                # flag the statement client_gone. ONE
                                # watcher per connection, armed per
                                # statement (satellite: no thread per
                                # pipelined statement)
                                if watcher is None:
                                    watcher = _ConnWatcher(
                                        self.connection, me)
                                watcher.arm()
                                try:
                                    out = outer.db.sql(req["sql"])
                                finally:
                                    watcher.disarm()
                                if isinstance(out, str) or out is None:
                                    resp = {"ok": True, "columns": None,
                                            "rows": None, "tag": out}
                                else:
                                    resp = {
                                        "ok": True,
                                        "columns": list(out.columns),
                                        "rows": [[_encode_value(v)
                                                  for v in row]
                                                 for row in out.rows()],
                                        "tag": None,
                                    }
                        except StatementCancelled as e:
                            # surface the typed cause to the client (the
                            # '57014 query_canceled' SQLSTATE analog)
                            resp = {"ok": False, "error": f"{e}",
                                    "cancelled": e.cause}
                        except AdmissionShed as e:
                            # load shed (the JAX package's "Overload
                            # protection"): typed + retryable, the
                            # SQLSTATE 53300 queue-rejection analog
                            resp = {"ok": False, "error": f"{e}",
                                    "code": "admission_shed",
                                    "sqlstate": "53300",
                                    "retryable": True}
                        except Exception as e:  # per-statement isolation
                            resp = {"ok": False, "error": f"{e}"}
                        try:
                            self.wfile.write(
                                (json.dumps(resp) + "\n").encode())
                            self.wfile.flush()
                        except (socket.timeout, TimeoutError):
                            # client_idle_timeout_s also deadlines WRITES
                            # (settimeout covers both directions): a
                            # reader too slow to drain its result within
                            # the idle budget is the same overload class
                            # as a silent peer — close, never traceback
                            outer.db.log.log(
                                "WARNING", "overload",
                                "response write exceeded client_idle_"
                                "timeout_s; closing connection")
                            return
                except (BrokenPipeError, ConnectionResetError):
                    # the client vanished mid-exchange: flag whatever this
                    # connection still has in flight as client_gone and
                    # end the handler cleanly — a disconnect must never
                    # traceback into socketserver (the statement dies at
                    # its next cancellation point and nobody reads the
                    # error)
                    REGISTRY.cancel_thread(me, "client_gone")
                    outer.db.log.log("WARNING", "connection",
                                     "client disconnected mid-exchange")
                finally:
                    if watcher is not None:
                        watcher.shutdown()

            def _control(self, req: dict) -> dict:
                """Protocol control ops (never parsed as SQL): 'ps' lists
                in-flight statements, 'cancel' flags one by id, 'metrics'
                serves the Prometheus text exposition, 'trace' exports one
                statement's Chrome trace_event JSON from the trace ring."""
                op = req.get("op")
                if op == "ps":
                    from greengage_tpu_torch.runtime.trace import TRACES

                    rows = REGISTRY.snapshot()
                    bs = getattr(outer.db, "_batch_server", None)
                    for r in rows:
                        # current execution phase from the trace registry:
                        # the deepest open span and its elapsed ms, when
                        # the statement is traced
                        sp = TRACES.active_span(r["id"])
                        if sp is not None:
                            r["span"], r["span_ms"] = sp[0], round(sp[1], 1)
                        # batched-serving membership: which flush window
                        # this statement is riding, when it is riding one
                        if bs is not None:
                            bid = bs.member_of(r["id"])
                            if bid is not None:
                                r["batch"] = bid
                    return {"ok": True, "rows": rows,
                            "cluster": _cluster_status(outer.db),
                            "pipeline": _pipeline_depths(outer.db),
                            "overload": _overload.CONTROLLER.snapshot(),
                            "ingest": _later("ingest", _INGEST)}
                if op == "metrics":
                    # Prometheus text exposition over the process-wide
                    # counters/gauges/histograms; host
                    # process gauges (RSS, fds, staging-pool depth,
                    # per-owner live bytes) refresh at scrape time
                    from greengage_tpu_torch.runtime import memaccount
                    from greengage_tpu_torch.runtime.logger import \
                        prometheus_text

                    memaccount.update_process_gauges()
                    return {"ok": True, "text": prometheus_text()}
                if op == "mem":
                    # the measured-memory surface: the card's
                    # allocator stats, per-statement accounting trees,
                    # the runaway ledger and per-program measured
                    # footprints
                    from greengage_tpu_torch.runtime import memaccount

                    return {"ok": True, "mem": memaccount.report(outer.db)}
                if op in _LATER_OPS:
                    return _later(f"the {op} op", _LATER_OPS[op])
                if op == "trace":
                    from greengage_tpu_torch.runtime.trace import (TRACES,
                                                                   to_chrome)

                    tid = req.get("id")
                    if tid is None:
                        tr = TRACES.last()
                    else:
                        try:
                            tr = TRACES.get(int(tid))
                        except (TypeError, ValueError):
                            return {"ok": False,
                                    "error": "trace needs a numeric id"}
                    if tr is None:
                        return {"ok": False,
                                "error": f"no trace for statement {tid!r} "
                                         "(evicted from the ring, or "
                                         "tracing is disabled)"}
                    return {"ok": True, "trace": to_chrome(tr)}
                if op == "status":
                    # the server status frame: dispatch topology state
                    # (full / n-1 / degraded), FTS topology version, the
                    # reform/commit-path counter family, and the overload
                    # state (fresh evaluation: operators polling status
                    # must see current pressure, not the rate-limited
                    # statement-path sample)
                    from greengage_tpu_torch.runtime.logger import \
                        counters as _c

                    _overload.CONTROLLER.evaluate(outer.db.settings,
                                                  force=True)
                    st = _cluster_status(outer.db)
                    st["counters"] = {
                        k: v for k, v in _c.snapshot().items()
                        if k.startswith(("mh_", "manifest_", "batch_",
                                         "server_", "connections_",
                                         "admission_", "brownout",
                                         "frames_", "standby_"))}
                    return {"ok": True, "cluster": st,
                            "pipeline": _pipeline_depths(outer.db),
                            "overload": _overload.CONTROLLER.snapshot(),
                            "ingest": _later("ingest", _INGEST)}
                if op == "cancel":
                    try:
                        sid = int(req.get("id"))
                    except (TypeError, ValueError):
                        return {"ok": False,
                                "error": "cancel needs a numeric id"}
                    if REGISTRY.cancel(sid, "user"):
                        outer.db.log.info(
                            "cancel", f"statement {sid} cancelled by "
                            "operator request")
                        return {"ok": True}
                    return {"ok": False,
                            "error": f"no in-flight statement {sid}"}
                return {"ok": False, "error": f"unknown op {op!r}"}

        class Server(socketserver.ThreadingUnixStreamServer):
            daemon_threads = True
            allow_reuse_address = True
            # a connect storm must reach the TYPED shed path, not the
            # kernel's tiny default backlog (refused connects can't be
            # told to back off); sheds are one frame + close, so a deep
            # accept queue drains in microseconds
            request_queue_size = 128

        self._server = Server(self.socket_path, Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="gg-server", daemon=True)
        self._thread.start()

        if self.host is not None and self.port is not None:
            class TcpHandler(Handler):
                REMOTE = True

            class TcpServer(socketserver.ThreadingTCPServer):
                daemon_threads = True
                allow_reuse_address = True
                request_queue_size = 128   # accept-then-shed, as above

            self._tcp_server = TcpServer((self.host, self.port), TcpHandler)
            self.port = self._tcp_server.server_address[1]  # resolve port 0
            self._tcp_thread = threading.Thread(
                target=self._tcp_server.serve_forever, name="gg-server-tcp",
                daemon=True)
            self._tcp_thread.start()

    def stop(self) -> None:
        """Graceful drain:

        1. flag draining and stop accepting (new connects shed typed);
        2. flag every in-flight statement ``shutdown`` via the interrupt
           registry and SHUT_RD the client sockets — idle readers wake
           with EOF immediately, in-flight statements die at their next
           cancellation point and still flush their typed error (writes
           stay open);
        3. join every handler thread, bounded by ``server_drain_s``;
        4. force-close straggler sockets and join once more — no daemon
           thread is left parked on a socket the process is abandoning
           (a thread still inside a launched program finishes it
           and exits at the next cancellation point)."""
        drain_s = max(float(getattr(self.db.settings,
                                    "server_drain_s", 5.0)), 0.0)
        with self._conn_mu:
            self._draining = True
            conns = dict(self._conns)
            handlers = dict(self._handlers)
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            self._thread.join()
        if self._tcp_server is not None:
            self._tcp_server.shutdown()
            self._tcp_server.server_close()
            self._tcp_server = None
            self._tcp_thread.join()
        for ident, sock in conns.items():
            REGISTRY.cancel_thread(ident, "shutdown")
            try:
                sock.shutdown(socket.SHUT_RD)
            except OSError:
                pass
        deadline = time.monotonic() + drain_s
        for t in handlers.values():
            t.join(timeout=max(deadline - time.monotonic(), 0.0))
        leftover = [t for t in handlers.values() if t.is_alive()]
        if leftover:
            with self._conn_mu:
                socks = [self._conns[t.ident] for t in leftover
                         if t.ident in self._conns]
            for s in socks:
                try:
                    s.close()
                except OSError:
                    pass
            for t in leftover:
                t.join(timeout=1.0)
            still = sum(1 for t in leftover if t.is_alive())
            if still:
                self.db.log.log(
                    "WARNING", "overload",
                    f"drain deadline ({drain_s:g}s) expired with {still} "
                    "connection(s) still closing")
        # _draining stays set: a straggler handler past the deadline must
        # not serve another statement on a server that no longer accepts
        if os.path.exists(self.socket_path):
            os.remove(self.socket_path)


def _unix_connect(path: str, retry_s: float = 5.0) -> socket.socket:
    """Connect to a unix socket, retrying while the listener's backlog is
    full (many clients connecting at once get EAGAIN there)."""
    deadline = time.monotonic() + retry_s
    while True:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            s.connect(path)
            return s
        except BlockingIOError:
            s.close()
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.01)
        except OSError:
            s.close()
            raise


class SqlClient:
    """Tiny client for the line protocol (the psql/libpq stand-in).
    Local: SqlClient(path). Remote: SqlClient(host=..., port=...,
    user=..., password=...) — challenge-response, password never sent."""

    def __init__(self, socket_path: str | None = None, *,
                 host: str | None = None, port: int | None = None,
                 user: str = "", password: str = ""):
        if socket_path is not None:
            self._sock = _unix_connect(socket_path)
            self._f = self._sock.makefile("rwb")
        else:
            from greengage_tpu_torch.runtime import auth

            self._sock = socket.create_connection((host, port))
            self._f = self._sock.makefile("rwb")
            self._f.write((json.dumps({"user": user}) + "\n").encode())
            self._f.flush()
            ch = json.loads(self._f.readline())
            if not ch.get("ok", True) and ch.get("code"):
                # typed connection shed (too_many_connections /
                # shutting_down) arrived instead of the auth challenge
                self._sock.close()
                raise ConnectionRefusedError(ch.get("error", "shed"))
            proof = auth.prove(ch["salt"], ch["nonce"], password)
            self._f.write((json.dumps({"proof": proof}) + "\n").encode())
            self._f.flush()
            resp = json.loads(self._f.readline())
            if not resp.get("ok"):
                self._sock.close()
                raise PermissionError(resp.get("error", "auth failed"))

    def sql(self, text: str):
        self._f.write((json.dumps({"sql": text}) + "\n").encode())
        self._f.flush()
        resp = json.loads(self._f.readline())
        if not resp.get("ok"):
            raise RuntimeError(resp.get("error", "server error"))
        return resp

    def op(self, payload: dict) -> dict:
        """Send a control frame (ps/cancel) and return the raw response
        (not raising on ok=false — 'no such statement' is an answer)."""
        self._f.write((json.dumps(payload) + "\n").encode())
        self._f.flush()
        return json.loads(self._f.readline())

    def close(self):
        self._f.close()
        self._sock.close()
