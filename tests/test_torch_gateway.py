"""The port's HTTP/SSE gateway over a lagged 2-replica fleet on the CPU
(cf. the JAX package's ``tests/test_gateway.py``): the streamed tokens
equal the in-process fleet's and the JAX fleet's, events are ordered and
indexed, a lapsed deadline is a 429 with ``Retry-After``, malformed
requests are 400s with a JSON body and no stack trace, a mid-stream
disconnect cancels its request and leaks no block, ``/v1/health`` and
``/metrics`` answer, and ``serve_lm --http-port 0`` serves on the CPU."""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.fleet import FleetRouter as JaxRouter
from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.telemetry import prometheus_text as jax_prometheus_text
from pytorch_distributed_tpu_torch.fleet import FleetRouter
from pytorch_distributed_tpu_torch.gateway import (
    Gateway,
    GatewayError,
    generate,
    health,
    metrics_text,
    open_stream,
)
from pytorch_distributed_tpu_torch.models import params_from_jax, tiny_config
from pytorch_distributed_tpu_torch.telemetry import prometheus_text

REPO = Path(__file__).resolve().parent.parent
MAX_SEQ = 96
SERVE = dict(n_slots=3, block_len=8, prefill_chunk=8)


def prompts(n=3):
    rng = np.random.default_rng(0)
    return [rng.integers(1, 128, (9 + 3 * i,)).astype(np.int32) for i in range(n)]


def in_process(router):
    """Each prompt's stream from ``step()``'s pairs (the gateway's driver
    reads them the same way)."""
    rids = [router.submit(p, 6) for p in prompts()]
    streams = {rid: [] for rid in rids}
    while not router.idle:
        for rid, tok in router.step():
            streams[rid].append(int(tok))
    return [streams[rid] for rid in rids]


@pytest.fixture(scope="module")
def gw_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jcfg = jax_tiny_config(attention="dense", max_seq_len=MAX_SEQ)
    params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    state = params_from_jax(jax.tree.map(np.asarray, params))
    cfg = tiny_config(max_seq_len=MAX_SEQ)
    jax_ref = in_process(JaxRouter(jcfg, params, n_replicas=1, gather_impl="dense", **SERVE))
    ref = in_process(FleetRouter(cfg, state, n_replicas=1, device="cpu", **SERVE))
    router = FleetRouter(cfg, state, n_replicas=2, device="cpu", async_host=True,
                         retain_results=False, **SERVE)
    gw = Gateway(router, port=0).start()
    yield {"base": f"http://127.0.0.1:{gw.port}", "gw": gw, "router": router, "ref": ref,
           "jax_ref": jax_ref}
    gw.stop()
    router.drain()
    router.close()
    torch.set_num_threads(threads)


def wait(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def test_sse_tokens_equal_the_in_process_fleet_and_jax(gw_env):
    assert all(len(t) == 6 for t in gw_env["ref"]) and gw_env["ref"] == gw_env["jax_ref"]
    for p, want in zip(prompts(), gw_env["ref"]):
        out = generate(gw_env["base"], p, 6)
        assert out["status"] == 200 and out["outcome"] == "complete", out
        assert out["tokens"] == want
        assert out["usage"] == {"prompt_tokens": len(p), "completion_tokens": 6}


def test_events_are_ordered_and_indexed(gw_env):
    with open_stream(gw_env["base"], prompts()[0], 5, session=3) as stream:
        events = list(stream.events())
    names = [name for name, _ in events]
    assert names == ["token"] * 5 + ["done"]
    assert [data["i"] for _, data in events[:-1]] == list(range(5))
    assert events[-1][1]["outcome"] == "complete"


def test_a_lapsed_deadline_is_a_429_with_retry_after(gw_env):
    out = generate(gw_env["base"], prompts()[0], 4, deadline_ms=0)
    assert out["status"] == 429 and out["retry_after"] == "1"
    assert out["error"] == "shed" and out["reason"] == "deadline-expired"
    with pytest.raises(GatewayError) as exc:
        open_stream(gw_env["base"], prompts()[0], 4, deadline_ms=-5)
    assert exc.value.status == 429 and exc.value.retry_after == "1"
    assert generate(gw_env["base"], prompts()[1], 3, deadline_ms=60_000)["outcome"] == "complete"


def _raw_post(base, body: bytes, headers=None):
    req = urllib.request.Request(base + "/v1/generate", data=body, method="POST",
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=15.0) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        raw = e.read().decode("utf-8", "replace")
        assert "Traceback" not in raw, raw
        return e.code, json.loads(raw)


@pytest.mark.parametrize("body,headers,err", [
    (b'{"prompt": [1, 2', None, "bad-json"),
    (b"[1, 2]", None, "bad-json"),
    (json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 4}).encode(),
     {"X-Deadline-Ms": "soon"}, "bad-deadline"),
    (json.dumps({"prompt": list(range(1, 201)), "max_new_tokens": 4}).encode(), None,
     "invalid-request"),
    (json.dumps({"max_new_tokens": 4}).encode(), None, "bad-prompt"),
    (json.dumps({"prompt": [], "max_new_tokens": 4}).encode(), None, "bad-prompt"),
    (json.dumps({"prompt": [1, "a"], "max_new_tokens": 4}).encode(), None, "bad-prompt"),
    (json.dumps({"prompt": [1, True], "max_new_tokens": 4}).encode(), None, "bad-prompt"),
    (json.dumps({"prompt": [1, 2], "max_new_tokens": 0}).encode(), None,
     "bad-max-new-tokens"),
    (json.dumps({"prompt": [1, 2], "max_new_tokens": 4, "session": "x"}).encode(), None,
     "bad-session"),
])
def test_malformed_requests_are_400s(gw_env, body, headers, err):
    status, out = _raw_post(gw_env["base"], body, headers)
    assert status == 400 and out["error"] == err, out


def test_a_disconnect_cancels_its_request_and_leaks_no_block(gw_env):
    gw, router = gw_env["gw"], gw_env["router"]
    before = gw.metrics()["gateway_cancels"]
    stream = open_stream(gw_env["base"], prompts()[2], 80)
    assert next(stream.events())[0] == "token"
    stream.close()
    assert wait(lambda: gw.metrics()["gateway_cancels"] > before)
    assert wait(lambda: router.idle)
    assert all(s.engine.allocator.in_use == 0 for s in router.replicas)
    assert router.metrics()["cancelled"] >= 1
    # and the gateway still serves
    assert generate(gw_env["base"], prompts()[1], 3)["outcome"] == "complete"


def test_health_and_metrics_answer(gw_env):
    h = health(gw_env["base"])
    assert h["total"] == 2 and h["routable"] == 2
    assert [r["state"] for r in h["replicas"]] == ["healthy", "healthy"]
    assert [r["replica"] for r in h["replicas"]] == [0, 1]
    text = metrics_text(gw_env["base"])
    assert "# TYPE pdt_gateway_open_streams gauge" in text
    assert "pdt_replicas 2" in text and "pdt_gateway_http_400" in text
    with urllib.request.urlopen(gw_env["base"] + "/healthz", timeout=5) as resp:
        assert json.loads(resp.read()) == {"ok": True}
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(gw_env["base"] + "/nowhere", timeout=5)
    assert exc.value.code == 404
    flat = {"a.b": 1, "ok": True, "2x": 2.5, "s": "text", "n": float("nan"),
            "i": float("inf")}
    assert prometheus_text(flat) == jax_prometheus_text(flat)
    assert prometheus_text(flat, prefix="x").count("gauge") == 3


def test_serve_lm_http_port_serves_on_the_cpu():
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_distributed_tpu_torch.recipes.serve_lm", "--device",
         "cpu", "--tiny", "--replicas", "2", "--http-port", "0", "--http-duration", "4"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)
    try:
        answered = None
        for line in proc.stdout:
            if line.startswith("gateway: "):
                answered = generate(line.split()[1].rsplit("/v1/", 1)[0], [5, 6, 7, 8], 3)
                break
        text, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, text
    assert answered["status"] == 200 and answered["outcome"] == "complete"
    metrics = json.loads(text[text.index("{\n"):])
    assert metrics["layout"] == "fleet" and metrics["completed"] == 1
    assert metrics["async_host"] is True
