"""HTTP/SSE front door over the serving fleet
(``pytorch_distributed_tpu/gateway/server.py`` ``Gateway``:154).

Stdlib only (``http.server.ThreadingHTTPServer``):

- ``POST /v1/generate``: a JSON body ``{"prompt": [token ids],
  "max_new_tokens": N, "session": S?}`` streamed back as server-sent
  events, one ``event: token`` a token (``{"i": index, "token": id}``)
  then one ``event: done`` with the request's outcome and usage;
- ``GET /v1/health``: the router's per-replica health records;
- ``GET /metrics``: Prometheus text of the router's rollup (a snapshot the
  driver thread takes, so a scrape never races the host loop) and the
  gateway's own ``gateway_*`` gauges.

The ingress maps onto the fleet's control planes:

- ``X-Deadline-Ms`` becomes the admission deadline (``deadline_s``): a
  lapsed one sheds at the gate with reason ``deadline-expired``;
- a gate shed is HTTP 429 with ``Retry-After`` and the gate's reason in a
  JSON body; a malformed body, header or prompt is a 400 with a JSON
  ``error`` (never a stack trace), a prompt the scheduler refuses too;
- a client that disconnects (a write that fails, or a peer found gone
  between token waits) is detached and its request cancelled through
  ``FleetRouter.cancel``, which frees its blocks.

Threads: one driver thread owns the router (``submit``, ``cancel``,
``step``) and fans the tokens out to per-request queues; the HTTP
handler threads talk to it only through queues under ``_lock`` and wait
on ``_wake``. A request whose queue fills (a consumer slower than the
decode tick for ``stream_queue_cap`` tokens) is cancelled. The router's
``on_retire`` hook closes each stream with its outcome.

    router = FleetRouter(cfg, params, async_host=True, retain_results=False)
    with Gateway(router, port=8000) as gw:
        ...  # curl -N -X POST :8000/v1/generate -d '{"prompt": [1, 2]}'

``port=0`` binds an ephemeral port; ``.port`` reports it. The JSONL
records of each connection (``kind="http"``) and the census
declarations of the JAX package's gateway are not ported.
"""

from __future__ import annotations

import json
import select
import socket
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np

from pytorch_distributed_tpu_torch.fleet.router import ROUTABLE
from pytorch_distributed_tpu_torch.telemetry import LatencySeries, prometheus_text

_SSE_HEADERS = (
    ("Content-Type", "text/event-stream"),
    ("Cache-Control", "no-cache"),
    ("Connection", "close"),
)


class _Submit:
    """One admission a handler hands the driver; the handler waits on
    ``event`` until the gate has decided."""

    __slots__ = ("prompt", "max_new", "session", "deadline_s", "event", "rid",
                 "shed_reason", "error", "stream")

    def __init__(self, prompt, max_new, session, deadline_s):
        self.prompt = prompt
        self.max_new = max_new
        self.session = session
        self.deadline_s = deadline_s
        self.event = threading.Event()
        self.rid = -1
        self.shed_reason: Optional[str] = None
        self.error: Optional[str] = None
        self.stream: Optional["_Stream"] = None


class _Stream:
    """The driver's token channel to one admitted rid's handler; every
    field is guarded by the gateway's ``_lock``."""

    __slots__ = ("rid", "prompt_len", "buf", "done", "outcome", "detached", "detach_t",
                 "done_t", "finished")

    def __init__(self, rid: int, prompt_len: int):
        self.rid = rid
        self.prompt_len = prompt_len
        self.buf: deque = deque()
        self.done = False
        self.outcome: Optional[str] = None
        self.detached = False
        self.detach_t: Optional[float] = None
        self.done_t: Optional[float] = None
        self.finished = False  # closed and counted, once


def _client_gone(conn) -> bool:
    """True when the peer closed the connection: readable with zero bytes
    on a peek (a streaming client sends nothing after its body)."""
    try:
        r, _, _ = select.select([conn], [], [], 0)
        if not r:
            return False
        return conn.recv(1, socket.MSG_PEEK) == b""
    except (OSError, ValueError):
        return True


class Gateway:
    """Serve a ``fleet.FleetRouter`` over HTTP with SSE token streaming."""

    def __init__(self, router, port: int = 0, host: str = "127.0.0.1", *,
                 stream_queue_cap: int = 512, max_pending: int = 4096,
                 max_body_bytes: int = 1 << 20, stream_timeout_s: float = 600.0,
                 poll_s: float = 0.05, idle_sleep_s: float = 0.002, prefix: str = "pdt"):
        self.router = router
        self.stream_queue_cap = int(stream_queue_cap)
        self.max_pending = int(max_pending)
        self.max_body_bytes = int(max_body_bytes)
        self.stream_timeout_s = float(stream_timeout_s)
        self.poll_s = float(poll_s)
        self.idle_sleep_s = float(idle_sleep_s)
        self.prefix = prefix
        self._host = host
        self._requested_port = int(port)
        self.port: Optional[int] = None
        self._server: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._driver: Optional[threading.Thread] = None
        # ---- shared between the driver and the handlers, under _lock ----
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._ingress: deque = deque()  # _Submit, handler → driver
        self._cancels: deque = deque()  # rids, handler → driver
        self._streams: Dict[int, _Stream] = {}
        self._retire_events: deque = deque()  # (rid, outcome, t)
        self._metrics_cache: Dict[str, float] = {}
        self._stop = False
        self._driver_error: Optional[str] = None
        self._conns = 0
        self._http_400 = 0
        self._http_429 = 0
        self._cancelled_total = 0
        self._completed = 0
        self._bytes_out = 0
        self._worst_gap_s = 0.0
        self.ttft_wire = LatencySeries("ttft_wire")
        self.gap = LatencySeries("gap")
        self.cancel_free = LatencySeries("cancel_free")

    # ---- lifecycle ----

    def start(self) -> "Gateway":
        if self._server is not None:
            return self
        self._refresh_metrics()
        self.router.on_retire = self._on_retire
        gw = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 (the stdlib's name)
                if self.path == "/v1/generate":
                    gw._handle_generate(self)
                else:
                    gw._send_json(self, 404, {"error": "not-found"})

            def do_GET(self):  # noqa: N802
                if self.path == "/v1/health":
                    gw._handle_health(self)
                elif self.path in ("/metrics", "/"):
                    gw._handle_metrics(self)
                elif self.path == "/healthz":
                    gw._send_json(self, 200, {"ok": True})
                else:
                    gw._send_json(self, 404, {"error": "not-found"})

            def log_message(self, *args):  # no stderr line a request
                pass

        self._server = ThreadingHTTPServer((self._host, self._requested_port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._http_thread = threading.Thread(target=self._server.serve_forever,
                                             name="pdt-gateway-http", daemon=True)
        self._http_thread.start()
        self._driver = threading.Thread(target=self._drive, name="pdt-gateway-driver",
                                        daemon=True)
        self._driver.start()
        return self

    def stop(self) -> None:
        """Close the listener, fail queued admissions, end every open stream
        with outcome ``shutdown`` and join the driver. The router is handed
        back as it is: the caller drains it."""
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=5.0)
        with self._lock:
            self._stop = True
            for st in self._streams.values():
                if not st.done:
                    st.done = True
                    st.outcome = st.outcome or "shutdown"
                    st.done_t = time.perf_counter()
            self._wake.notify_all()
        if self._driver is not None:
            self._driver.join(timeout=30.0)
        self.router.on_retire = None
        self._server = None
        self._http_thread = None
        self._driver = None

    def __enter__(self) -> "Gateway":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- the driver thread, the router's only user ----

    def _drive(self) -> None:
        try:
            self._drive_loop()
        except Exception as e:  # noqa: BLE001 (fail every stream loudly, wedge no handler)
            with self._lock:
                self._driver_error = repr(e)
                for st in self._streams.values():
                    if not st.done:
                        st.done = True
                        st.outcome = "error"
                        st.done_t = time.perf_counter()
                for sub in self._ingress:
                    sub.error = f"gateway driver failed: {e!r}"
                    sub.event.set()
                self._ingress.clear()
                self._wake.notify_all()

    def _drive_loop(self) -> None:
        n = 0
        while True:
            with self._lock:
                subs = list(self._ingress)
                self._ingress.clear()
                cancels = list(self._cancels)
                self._cancels.clear()
                stopping = self._stop
            for rid in cancels:
                # frees the blocks and fires the retire hook before it
                # returns; False: already gone
                self.router.cancel(rid)
            for sub in subs:
                if stopping:
                    sub.error = "gateway shutting down"
                    sub.event.set()
                else:
                    self._admit(sub)
            busy = not self.router.idle
            out = self.router.step() if busy and not stopping else []
            self._deliver(out)
            if stopping and not subs and not cancels:
                break
            n += 1
            if n % 64 == 0:
                self._refresh_metrics()
            if not busy and not subs:
                time.sleep(self.idle_sleep_s)

    def _admit(self, sub: _Submit) -> None:
        """Route one admission through the gate (a shed rid is in
        ``router.rejected`` when ``submit`` returns)."""
        try:
            rid = self.router.submit(np.asarray(sub.prompt, dtype=np.int32), sub.max_new,
                                     session=sub.session, deadline_s=sub.deadline_s)
        except ValueError as e:
            # the scheduler's validation (a prompt past max_seq_len, ...)
            sub.error = str(e)
            sub.event.set()
            return
        reason = self.router.rejected.get(rid)
        if reason is not None:
            sub.rid = rid
            sub.shed_reason = reason
            sub.event.set()
            return
        st = _Stream(rid, prompt_len=len(sub.prompt))
        with self._lock:
            self._streams[rid] = st
        sub.rid = rid
        sub.stream = st
        sub.event.set()

    def _on_retire(self, rid: int, outcome: str) -> None:
        """The router's retire hook: the driver thread, mid-step."""
        with self._lock:
            self._retire_events.append((rid, outcome, time.perf_counter()))

    def _deliver(self, out: List[Tuple[int, int]]) -> None:
        """Fan this step's tokens out, then apply its retirements (the hook
        fires before the final token reaches ``out``)."""
        overflowed: List[int] = []
        with self._lock:
            for rid, tok in out:
                st = self._streams.get(rid)
                if st is None or st.done:
                    continue
                if len(st.buf) >= self.stream_queue_cap:
                    if rid not in overflowed:
                        overflowed.append(rid)
                    continue
                st.buf.append(int(tok))
            retired = False
            while self._retire_events:
                rid, outcome, t = self._retire_events.popleft()
                st = self._streams.get(rid)
                if st is None:
                    continue
                retired = True
                if not st.done or (st.detached and st.outcome == "shutdown"):
                    st.done = True
                    st.outcome = outcome
                    st.done_t = t
                if st.detached:
                    # no handler writes its end: close it here
                    self._finish_detached_locked(st)
            if out or overflowed or retired:
                self._wake.notify_all()
        for rid in overflowed:
            # a consumer this slow is cancelled: neither host memory nor
            # blocks wait on a stuck socket
            self.router.cancel(rid)

    def _refresh_metrics(self) -> None:
        """Snapshot the fleet's rollup on the driver thread."""
        try:
            snap = self.router.metrics()
        except Exception:  # noqa: BLE001 (a refresh never stops the driver)
            return
        flat = {k: v for k, v in snap.items() if isinstance(v, (int, float, bool))}
        with self._lock:
            self._metrics_cache = flat

    # ---- stream bookkeeping ----

    def _finish_detached_locked(self, st: _Stream) -> None:
        if st.finished:
            return
        st.finished = True
        self._streams.pop(st.rid, None)
        self._conns += 1
        if st.outcome == "cancelled":
            self._cancelled_total += 1
            if st.detach_t is not None and st.done_t is not None:
                self.cancel_free.observe(max(st.done_t - st.detach_t, 0.0))

    def _finish_conn(self, st: _Stream, *, nbytes: int, ttft: Optional[float],
                     gaps: List[float]) -> None:
        """A handler wrote the end event."""
        with self._lock:
            if st.finished:
                return
            st.finished = True
            self._streams.pop(st.rid, None)
            self._conns += 1
            self._completed += 1
            self._bytes_out += nbytes
            if ttft is not None:
                self.ttft_wire.observe(ttft)
            for g in gaps:
                self.gap.observe(g)
            self._worst_gap_s = max([self._worst_gap_s, *gaps])

    def _detach(self, st: _Stream, *, nbytes: int, ttft: Optional[float]) -> None:
        """A handler lost its client: hand the rid to the driver to cancel
        and stop touching the socket."""
        with self._lock:
            if st.finished:
                return
            self._bytes_out += nbytes
            if ttft is not None:
                self.ttft_wire.observe(ttft)
            if st.done:  # retired meanwhile: nothing to cancel
                st.finished = True
                self._streams.pop(st.rid, None)
                self._conns += 1
                return
            st.detached = True
            st.detach_t = time.perf_counter()
            self._cancels.append(st.rid)

    # ---- the HTTP handlers (the server's threads) ----

    def _send_json(self, h, status: int, body: dict,
                   headers: Tuple[Tuple[str, str], ...] = ()) -> None:
        payload = json.dumps(body).encode()
        try:
            h.send_response(status)
            h.send_header("Content-Type", "application/json")
            h.send_header("Content-Length", str(len(payload)))
            for k, v in headers:
                h.send_header(k, v)
            h.end_headers()
            h.wfile.write(payload)
        except OSError:
            pass  # the peer left before the error body: nothing owed

    def _reject(self, h, status: int, body: dict,
                headers: Tuple[Tuple[str, str], ...] = ()) -> None:
        with self._lock:
            self._conns += 1
            if status == 400:
                self._http_400 += 1
            elif status == 429:
                self._http_429 += 1
        self._send_json(h, status, body, headers)

    def _read_request(self, h):
        """``(parsed, deadline_ms, error)``: ``parsed`` is ``(prompt,
        max_new, session)``, ``error`` a ``(status, body)`` pair for a
        malformed request."""
        try:
            length = int(h.headers.get("Content-Length", ""))
        except ValueError:
            return None, None, (400, {"error": "missing-length"})
        if length > self.max_body_bytes:
            return None, None, (413, {"error": "body-too-large",
                                      "limit": self.max_body_bytes})
        try:
            payload = json.loads(h.rfile.read(length))
        except (ValueError, OSError):
            return None, None, (400, {"error": "bad-json"})
        if not isinstance(payload, dict):
            return None, None, (400, {"error": "bad-json"})
        deadline_ms = None
        header = h.headers.get("X-Deadline-Ms")
        if header is not None:
            try:
                deadline_ms = float(header)
            except ValueError:
                return None, None, (400, {"error": "bad-deadline",
                                          "detail": "X-Deadline-Ms must be numeric"})
        prompt = payload.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) and not isinstance(t, bool) for t in prompt)):
            return None, None, (400, {"error": "bad-prompt",
                                      "detail": "prompt must be a non-empty list of token ids"})
        max_new = payload.get("max_new_tokens", 16)
        if not isinstance(max_new, int) or isinstance(max_new, bool) or max_new < 1:
            return None, None, (400, {"error": "bad-max-new-tokens",
                                      "detail": "max_new_tokens must be a positive int"})
        session = payload.get("session")
        if session is not None and not isinstance(session, int):
            return None, None, (400, {"error": "bad-session",
                                      "detail": "session must be an int"})
        return (prompt, max_new, session), deadline_ms, None

    def _handle_generate(self, h) -> None:
        t0 = time.perf_counter()
        parsed, deadline_ms, err = self._read_request(h)
        if err is not None:
            self._reject(h, *err)
            return
        prompt, max_new, session = parsed
        sub = _Submit(prompt, max_new, session,
                      deadline_ms / 1e3 if deadline_ms is not None else None)
        with self._lock:
            if self._stop or self._driver_error is not None:
                err = (503, {"error": "unavailable",
                             "detail": self._driver_error or "shutting down"})
            elif len(self._ingress) >= self.max_pending:
                err = (503, {"error": "overloaded"})
            else:
                self._ingress.append(sub)
        if err is not None:
            self._reject(h, *err)
            return
        if not sub.event.wait(timeout=30.0):
            self._reject(h, 503, {"error": "admission-timeout"})
            return
        if sub.error is not None:
            self._reject(h, 400, {"error": "invalid-request", "detail": sub.error})
            return
        if sub.shed_reason is not None:
            # the gate's shed: explicit, with the gate's own reason
            self._reject(h, 429, {"error": "shed", "reason": sub.shed_reason, "rid": sub.rid},
                         headers=(("Retry-After", "1"),))
            return
        self._stream_sse(h, sub.stream, t0)

    def _stream_sse(self, h, st: _Stream, t0: float) -> None:
        ttft: Optional[float] = None
        nbytes = ntok = 0
        last_t: Optional[float] = None
        gaps: List[float] = []
        give_up = t0 + self.stream_timeout_s
        try:
            h.send_response(200)
            for k, v in _SSE_HEADERS:
                h.send_header(k, v)
            h.end_headers()
            while True:
                with self._lock:
                    if not st.buf and not st.done:
                        self._wake.wait(timeout=self.poll_s)
                    toks = list(st.buf)
                    st.buf.clear()
                    done, outcome = st.done, st.outcome
                if toks:
                    now = time.perf_counter()
                    if ttft is None:
                        ttft = now - t0
                    elif last_t is not None:
                        gaps.append(now - last_t)
                    last_t = now
                    for tok in toks:
                        chunk = (f"event: token\ndata: "
                                 f"{json.dumps({'i': ntok, 'token': tok})}\n\n").encode()
                        h.wfile.write(chunk)
                        nbytes += len(chunk)
                        ntok += 1
                    h.wfile.flush()
                if done and not st.buf:
                    data = json.dumps({"rid": st.rid, "outcome": outcome,
                                       "usage": {"prompt_tokens": st.prompt_len,
                                                 "completion_tokens": ntok}})
                    chunk = f"event: done\ndata: {data}\n\n".encode()
                    h.wfile.write(chunk)
                    h.wfile.flush()
                    nbytes += len(chunk)
                    self._finish_conn(st, nbytes=nbytes, ttft=ttft, gaps=gaps)
                    return
                if (not toks and _client_gone(h.connection)) or time.perf_counter() > give_up:
                    self._detach(st, nbytes=nbytes, ttft=ttft)
                    return
        except OSError:
            # a write to a peer that is gone: its blocks wait for no reader
            self._detach(st, nbytes=nbytes, ttft=ttft)
        except Exception:  # noqa: BLE001 (no stack trace down the socket, no leaked stream)
            self._detach(st, nbytes=nbytes, ttft=ttft)

    def _handle_health(self, h) -> None:
        replicas = [dict(rec, replica=i) for i, rec in enumerate(self.router.health)]
        self._send_json(h, 200, {
            "replicas": replicas, "total": len(replicas),
            "routable": sum(1 for r in replicas if r["state"] in ROUTABLE)})

    def _handle_metrics(self, h) -> None:
        body = prometheus_text(self.metrics(), prefix=self.prefix).encode()
        try:
            h.send_response(200)
            h.send_header("Content-Type", "text/plain; version=0.0.4")
            h.send_header("Content-Length", str(len(body)))
            h.end_headers()
            h.wfile.write(body)
        except OSError:
            pass

    def metrics(self) -> dict:
        """The fleet's rollup (the driver's snapshot) and ``gateway_*``
        gauges."""
        with self._lock:
            out = dict(self._metrics_cache)
            out.update({
                "gateway_open_streams": len(self._streams),
                "gateway_queued": len(self._ingress),
                "gateway_connections": self._conns,
                "gateway_completed": self._completed,
                "gateway_http_400": self._http_400,
                "gateway_http_429": self._http_429,
                "gateway_cancels": self._cancelled_total,
                "gateway_bytes_out": self._bytes_out,
                "gateway_worst_gap_ms": round(self._worst_gap_s * 1e3, 3),
            })
            out.update(self.ttft_wire.summary("gateway_ttft_wire"))
            out.update(self.gap.summary("gateway_gap"))
            out.update(self.cancel_free.summary("gateway_cancel_free"))
        return out
