"""Stdlib SSE client for the gateway
(``pytorch_distributed_tpu/gateway/client.py``, a copy).

- ``open_stream`` POSTs ``/v1/generate`` and returns an ``SSEStream``:
  iterate ``events()`` for ``("token", {...})`` and ``("done", {...})``,
  or ``close()`` it mid-stream (the server then cancels the request). A
  4xx or 5xx raises ``GatewayError`` with the JSON body and any
  ``Retry-After``.
- ``generate`` drains a stream into one dict (``status``, ``tokens``,
  ``outcome``, ``usage``, ``rid``); an HTTP error comes back as data
  (``status``, the error body, ``retry_after``).
- ``health`` and ``metrics_text`` GET ``/v1/health`` and ``/metrics``.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Iterator, Optional, Tuple


class GatewayError(Exception):
    """Non-200 response: ``status``, parsed JSON ``body`` (or raw text
    under ``{"error": "non-json", ...}``), and ``retry_after``."""

    def __init__(self, status: int, body, retry_after: Optional[str] = None):
        super().__init__(f"HTTP {status}: {body}")
        self.status = status
        self.body = body
        self.retry_after = retry_after


class SSEStream:
    """One live SSE response; context manager closes the socket."""

    def __init__(self, resp):
        self._resp = resp

    def events(self) -> Iterator[Tuple[str, dict]]:
        """Yield ``(event_name, data)`` per SSE event until EOF."""
        name, data_lines = None, []
        for raw in self._resp:
            line = raw.decode("utf-8", "replace").rstrip("\r\n")
            if not line:
                if name is not None or data_lines:
                    data = json.loads("".join(data_lines)) \
                        if data_lines else None
                    yield (name or "message", data)
                name, data_lines = None, []
                continue
            if line.startswith("event:"):
                name = line[len("event:"):].strip()
            elif line.startswith("data:"):
                data_lines.append(line[len("data:"):].strip())

    def close(self) -> None:
        try:
            self._resp.close()
        except OSError:
            pass

    def __enter__(self) -> "SSEStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _post(base: str, path: str, payload: dict, headers: dict,
          timeout: float):
    req = urllib.request.Request(
        base.rstrip("/") + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **headers},
        method="POST",
    )
    return urllib.request.urlopen(req, timeout=timeout)


def open_stream(base: str, prompt, max_new_tokens: int = 16, *,
                session: Optional[int] = None, deadline_ms=None,
                timeout: float = 30.0) -> SSEStream:
    """POST ``/v1/generate`` and return the live token stream.

    ``deadline_ms`` rides the ``X-Deadline-Ms`` header verbatim
    (``str()``-ed — pass garbage to exercise the server's 400 path).
    Raises ``GatewayError`` on any non-200 status.
    """
    payload = {"prompt": [int(t) for t in prompt],
               "max_new_tokens": int(max_new_tokens)}
    if session is not None:
        payload["session"] = int(session)
    headers = {}
    if deadline_ms is not None:
        headers["X-Deadline-Ms"] = str(deadline_ms)
    try:
        resp = _post(base, "/v1/generate", payload, headers, timeout)
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            body = json.loads(raw)
        except ValueError:
            body = {"error": "non-json", "raw": raw.decode("utf-8",
                                                           "replace")}
        raise GatewayError(e.code, body, e.headers.get("Retry-After")) \
            from None
    return SSEStream(resp)


def generate(base: str, prompt, max_new_tokens: int = 16, *,
             session: Optional[int] = None, deadline_ms=None,
             timeout: float = 30.0) -> dict:
    """Blocking generate: drain the stream, return one flat dict.

    200 → ``{"status": 200, "rid", "tokens", "outcome", "usage"}``;
    4xx/5xx → ``{"status", **error_body, "retry_after"}``.
    """
    try:
        stream = open_stream(base, prompt, max_new_tokens,
                             session=session, deadline_ms=deadline_ms,
                             timeout=timeout)
    except GatewayError as e:
        out = {"status": e.status, "retry_after": e.retry_after}
        if isinstance(e.body, dict):
            out.update(e.body)
        return out
    tokens, outcome, usage, rid = [], None, None, None
    with stream:
        for name, data in stream.events():
            if name == "token":
                tokens.append(int(data["token"]))
            elif name == "done":
                outcome = data.get("outcome")
                usage = data.get("usage")
                rid = data.get("rid")
                break
    return {"status": 200, "rid": rid, "tokens": tokens,
            "outcome": outcome, "usage": usage}


def health(base: str, timeout: float = 10.0) -> dict:
    """GET ``/v1/health`` → the per-replica health-plane snapshot."""
    with urllib.request.urlopen(base.rstrip("/") + "/v1/health",
                                timeout=timeout) as resp:
        return json.loads(resp.read())


def metrics_text(base: str, timeout: float = 10.0) -> str:
    """GET ``/metrics`` → Prometheus text exposition."""
    with urllib.request.urlopen(base.rstrip("/") + "/metrics",
                                timeout=timeout) as resp:
        return resp.read().decode()
