"""The port's HTTP gateway on the dry-run backend: the flows of
``tests/test_api.py`` run against ``vgate_tpu_torch.server.app``, plus
embeddings, the Idempotency-Key replay and the graceful drain.  The
drain waits on a threading event and the app's in-flight counter, never
on sleeps."""

import asyncio
import json
import threading

import pytest
from aiohttp.test_utils import TestClient, TestServer

from vgate_tpu_torch import config as config_mod
from vgate_tpu_torch import faults, tracing
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.errors import ServerDrainingError
from vgate_tpu_torch.server.app import create_app


@pytest.fixture(autouse=True)
def _reset_port_globals():
    config_mod.reset_config()
    tracing.reset_tracing()
    faults.reset()
    yield
    config_mod.reset_config()
    tracing.reset_tracing()
    faults.reset()


async def _client(**overrides):
    overrides.setdefault("model", {"engine_type": "dry_run"})
    overrides.setdefault(
        "batch", {"max_batch_size": 4, "max_wait_time_ms": 5.0}
    )
    overrides.setdefault("logging", {"level": "WARNING"})
    client = TestClient(TestServer(create_app(load_config(**overrides))))
    await client.start_server()
    return client


def _chat(content="hi", **extra):
    return {"messages": [{"role": "user", "content": content}], **extra}


def _sse_chunks(body: str):
    return [
        json.loads(line[len("data: "):])
        for line in body.splitlines()
        if line.startswith("data: ") and line != "data: [DONE]"
    ]


async def test_health():
    client = await _client()
    try:
        resp = await client.get("/health")
        assert resp.status == 200
        body = await resp.json()
        assert body["status"] == "ok"
        assert body["engine_type"] == "DryRunBackend"
        for path in ("/health/live", "/health/ready"):
            assert (await client.get(path)).status == 200
    finally:
        await client.close()


async def test_chat_completion_roundtrip():
    client = await _client()
    try:
        resp = await client.post(
            "/v1/chat/completions",
            json={
                "messages": [
                    {"role": "system", "content": "You are helpful."},
                    {"role": "user", "content": "Say hi"},
                ],
                "max_tokens": 16,
            },
        )
        assert resp.status == 200
        body = await resp.json()
        assert body["object"] == "chat.completion"
        content = body["choices"][0]["message"]["content"]
        assert "[dry-run] echo:" in content
        assert "System: You are helpful." in content
        assert body["usage"]["completion_tokens"] == 8
        assert "X-Request-ID" in resp.headers
    finally:
        await client.close()


@pytest.mark.parametrize("body", [{"messages": []}, {"wrong": "shape"}])
async def test_chat_completion_validation_error(body):
    client = await _client()
    try:
        resp = await client.post("/v1/chat/completions", json=body)
        assert resp.status == 422
        assert (await resp.json())["error"]["type"] == "invalid_request_error"
    finally:
        await client.close()


async def test_chat_completion_caching_visible():
    client = await _client()
    try:
        req = _chat("cache me", temperature=0.5)
        first = await (await client.post("/v1/chat/completions", json=req)).json()
        second = await (await client.post("/v1/chat/completions", json=req)).json()
        assert first["cached"] is False
        assert second["cached"] is True
    finally:
        await client.close()


@pytest.mark.parametrize("inputs", [["one", "two"], "solo"])
async def test_embeddings_on_dry_run(inputs):
    client = await _client()
    try:
        resp = await client.post("/v1/embeddings", json={"input": inputs})
        assert resp.status == 200
        body = await resp.json()
        n = 1 if isinstance(inputs, str) else len(inputs)
        assert body["object"] == "list"
        assert len(body["data"]) == n
        assert len(body["data"][0]["embedding"]) == 768
        assert body["usage"]["prompt_tokens"] >= n
    finally:
        await client.close()


async def test_models_endpoint():
    client = await _client()
    try:
        body = await (await client.get("/v1/models")).json()
        ids = [m["id"] for m in body["data"]]
        assert any("Qwen" in i for i in ids)
        assert "BAAI/bge-base-en-v1.5" in ids
    finally:
        await client.close()


async def test_metrics_endpoint():
    client = await _client()
    try:
        await client.post("/v1/chat/completions", json=_chat("m"))
        resp = await client.get("/metrics")
        assert resp.status == 200
        text = await resp.text()
        assert "vgt_requests" in text
        assert "vgt_time_to_first_token_seconds" in text
    finally:
        await client.close()


async def test_stats_endpoint():
    client = await _client()
    try:
        await client.post("/v1/chat/completions", json=_chat("s"))
        body = await (await client.get("/stats")).json()
        assert body["batcher"]["total_requests"] >= 1
        assert "cache" in body and "config" in body
        assert body["config"]["engine_type"] == "dry_run"
        assert "torch" in body["build"]
    finally:
        await client.close()


async def test_benchmark_endpoint():
    client = await _client()
    try:
        resp = await client.post(
            "/v1/benchmark",
            json={"prompts": ["bench one", "bench two"], "rounds": 2,
                  "max_tokens": 8},
        )
        assert resp.status == 200
        body = await resp.json()
        assert body["rounds"] == 2
        assert body["latency_ms"]["p50"] > 0
        assert body["tokens_per_second"] > 0
    finally:
        await client.close()


async def test_streaming_chat():
    client = await _client()
    try:
        resp = await client.post(
            "/v1/chat/completions", json=_chat("stream me", stream=True)
        )
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        raw = await resp.text()
        assert "data: [DONE]" in raw
        chunks = _sse_chunks(raw)
        assert all(c["object"] == "chat.completion.chunk" for c in chunks)
        text = "".join(
            c["choices"][0]["delta"].get("content", "") for c in chunks
        )
        assert text.startswith("[dry-run] echo:")
        assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
    finally:
        await client.close()


async def test_secured_gateway_end_to_end():
    client = await _client(
        security={"enabled": True, "api_keys": ["sk-test"]},
        rate_limit={"enabled": True, "requests_per_minute": 100},
    )
    try:
        resp = await client.post("/v1/chat/completions", json=_chat("x"))
        assert resp.status == 401
        resp = await client.post(
            "/v1/chat/completions", json=_chat("x"),
            headers={"Authorization": "Bearer sk-test"},
        )
        assert resp.status == 200
        assert (await client.get("/health")).status == 200
    finally:
        await client.close()


@pytest.mark.parametrize(
    "extra", [{"stop": "\n"}, {"stop": ["\n", "User:"]}, {"seed": 42}]
)
async def test_chat_completion_accepts_stop_and_seed(extra):
    """``stop`` and ``seed`` are part of the cache identity: they never
    hit the plain request's entry, and a repeat of the same request
    does."""
    client = await _client()
    try:
        base = _chat("stop/seed probe", max_tokens=8)
        assert (await client.post("/v1/chat/completions", json=base)).status == 200
        for expect_cached in (False, True):
            resp = await client.post(
                "/v1/chat/completions", json={**base, **extra}
            )
            assert resp.status == 200
            assert (await resp.json())["cached"] is expect_cached
    finally:
        await client.close()


async def test_request_timeout_returns_504():
    client = await _client(
        server={"request_timeout_s": 0.05},
        batch={"max_batch_size": 64, "max_wait_time_ms": 60_000.0},
    )
    try:
        resp = await client.post(
            "/v1/chat/completions", json=_chat("too slow", max_tokens=4)
        )
        assert resp.status == 504
        assert (await resp.json())["error"]["type"] == "timeout_error"
    finally:
        await client.close()


async def test_max_completion_tokens_alias():
    client = await _client()
    try:
        resp = await client.post(
            "/v1/chat/completions",
            json=_chat("alias", max_tokens=99, max_completion_tokens=4),
        )
        assert resp.status == 200
        assert (await resp.json())["choices"][0]["message"]["content"]
    finally:
        await client.close()


@pytest.mark.parametrize(
    "bias,status",
    [({"42": 50.0, "7": -100.0}, 200), ({"not-a-token": 1.0}, 422)],
)
async def test_chat_logit_bias_accepted_and_validated(bias, status):
    client = await _client()
    try:
        resp = await client.post(
            "/v1/chat/completions",
            json=_chat("hi", max_tokens=4, logit_bias=bias),
        )
        assert resp.status == status
        if status == 422:
            assert "logit_bias" in (await resp.json())["error"]["message"]
    finally:
        await client.close()


async def test_stream_options_include_usage():
    client = await _client()
    try:
        req = _chat("usage probe", max_tokens=6, stream=True)
        resp = await client.post(
            "/v1/chat/completions",
            json={**req, "stream_options": {"include_usage": True}},
        )
        assert resp.status == 200
        usage_chunks = [
            c for c in _sse_chunks((await resp.read()).decode())
            if c.get("usage")
        ]
        assert len(usage_chunks) == 1
        u = usage_chunks[0]
        assert u["choices"] == []
        assert u["usage"]["completion_tokens"] >= 1
        assert u["usage"]["total_tokens"] == (
            u["usage"]["prompt_tokens"] + u["usage"]["completion_tokens"]
        )
        resp2 = await client.post("/v1/chat/completions", json=req)
        assert '"usage"' not in (await resp2.read()).decode()
    finally:
        await client.close()


async def test_idempotency_key_replays_identical_body():
    client = await _client()
    try:
        headers = {"Idempotency-Key": "k-1"}
        req = _chat("Say hi", max_tokens=8)
        r1 = await client.post("/v1/chat/completions", json=req, headers=headers)
        assert r1.status == 200
        body1 = await r1.json()
        assert "replayed" not in body1
        r2 = await client.post("/v1/chat/completions", json=req, headers=headers)
        assert r2.status == 200
        body2 = await r2.json()
        assert body2.pop("replayed") is True
        assert body2 == body1
        stats = await (await client.get("/stats")).json()
        assert stats["batcher"]["total_requests"] == 1
    finally:
        await client.close()


async def test_unregistered_routes_are_404():
    """Without a worker pod, the pod's and the replicas' reads answer
    the reference's single-engine bodies, a replica drain its 409, and
    the pod-only add and DELETE stay unregistered; the engine's
    self-observation routes are registered and answer the dry-run
    backend's "no recorder" bodies, and /v1/profile its 400."""
    client = await _client()
    try:
        pod = await client.get("/debug/pod")
        assert pod.status == 200
        assert (await pod.json())["enabled"] is False
        replicas = await client.get("/admin/replicas")
        assert replicas.status == 200
        assert (await replicas.json())["replicas"] == []
        assert (await client.post("/admin/replicas/0/drain")).status == 409
        assert (await client.post("/admin/replicas")).status in (404, 405)
        assert (await client.delete("/admin/replicas/0")).status in (404,
                                                                     405)
        for path in ("/debug/flight", "/debug/perf", "/debug/spans",
                     "/debug/requests", "/debug/faults"):
            assert (await client.get(path)).status == 200, path
        assert (await client.get("/debug/requests/x")).status == 404
        assert (await client.post("/v1/profile", json={})).status == 400
    finally:
        await client.close()


async def test_drain_completes_inflight_and_sheds_new_work():
    """SIGTERM's drain in-process: readiness flips to 503 "draining",
    new POSTs shed 503 with Retry-After, the in-flight batch completes,
    and the drain ends with no straggler.  The backend holds the batch
    on an event until the drain has begun."""
    client = await _client(
        batch={"max_batch_size": 4, "max_wait_time_ms": 60_000.0},
    )
    app = client.server.app
    backend = app["engine"].backend
    entered, release = threading.Event(), threading.Event()
    plain_generate = backend.generate

    def held_generate(prompts, params):
        entered.set()
        assert release.wait(30)
        return plain_generate(prompts, params)

    backend.generate = held_generate
    loop = asyncio.get_running_loop()
    try:
        completed = asyncio.Event()
        app["drain"].on_complete = completed.set
        inflight = [
            asyncio.ensure_future(
                client.post("/v1/chat/completions", json=_chat(f"drain {i}"))
            )
            for i in range(4)
        ]
        # the fourth request fills the batch, which fires into the held
        # backend: all four are in flight once it is entered
        assert await loop.run_in_executor(None, entered.wait, 30)
        assert app["drain"].inflight() == 4
        app["drain"].begin()
        resp = await client.get("/health/ready")
        assert resp.status == 503
        assert (await resp.json())["engine"]["state"] == "draining"
        assert (await client.get("/health/live")).status == 200
        shed = await client.post("/v1/chat/completions", json=_chat("late"))
        assert shed.status == 503
        assert "Retry-After" in shed.headers
        assert (await shed.json())["error"]["reason"] == "draining"
        with pytest.raises(ServerDrainingError):
            await app["batcher"].submit("direct")
        release.set()
        responses = await asyncio.gather(*inflight)
        assert [r.status for r in responses] == [200] * 4
        assert await app["drain"].wait_drained(10.0)
        await asyncio.wait_for(completed.wait(), 10.0)
        assert app["drain"].aborted_stragglers == 0
    finally:
        release.set()
        await client.close()


# ---------------------------------------------------- dp replicas (10b)


def _dp_sections(**migration):
    return dict(
        model={"model_id": "tiny-dense", "dtype": "float32",
               "max_model_len": 64, "engine_type": "torch_cuda"},
        device={"device": "cpu", "dp": 2, "kv_num_pages": 32,
                "kv_page_size": 4, "max_batch_slots": 2,
                "prefill_buckets": [8, 16]},
        migration={"rebalance_enabled": False, **migration},
    )


async def test_dp_replica_routes_add_remove_drain_and_signal(monkeypatch):
    """A dp=2 engine behind the gateway: GET shows both replicas, DELETE
    removes one (its slice banked), POST adds it back, a drain and an
    undrain answer, an unknown index is 404, and SIGUSR1 drains the
    replica named by $VGT_DRAIN_REPLICA."""
    import os
    import signal

    client = await _client(**_dp_sections())
    try:
        app = client.server.app
        body = await (await client.get("/admin/replicas")).json()
        assert body["dp"] == 2 and body["state"] == "serving"
        resp = await client.delete("/admin/replicas/1")
        assert resp.status == 200, await resp.text()
        assert (await resp.json())["dp"] == 1
        stats = await (await client.get("/stats")).json()
        assert stats["engine"]["migration"]["free_slices"] == 1
        resp = await client.post("/admin/replicas")
        assert resp.status == 200, await resp.text()
        assert (await resp.json())["dp"] == 2
        drained = await (await client.post("/admin/replicas/0/drain")).json()
        assert drained["draining"] is True and drained["lost"] == 0
        body = await (await client.get("/admin/replicas")).json()
        assert body["draining"] == [0] and body["state"] == "degraded"
        resp = await client.post("/admin/replicas/0/undrain")
        assert (await resp.json())["draining"] is False
        assert (await client.post("/admin/replicas/7/drain")).status == 404
        assert (await client.delete("/admin/replicas/7")).status == 404
        assert app["replica_drain_signal_installed"] is True
        monkeypatch.setenv("VGT_DRAIN_REPLICA", "1")
        os.kill(os.getpid(), signal.SIGUSR1)
        for _ in range(500):
            body = await (await client.get("/admin/replicas")).json()
            if body["draining"] == [1]:
                break
            await asyncio.sleep(0.02)
        assert body["draining"] == [1]
        resp = await client.post(
            "/v1/chat/completions", json=_chat(max_tokens=3))
        assert resp.status == 200, await resp.text()
    finally:
        await client.close()


async def test_dp_replica_ops_answer_409_while_migration_is_disabled():
    client = await _client(**_dp_sections(enabled=False))
    try:
        assert not client.server.app.get("replica_drain_signal_installed")
        for resp in (await client.post("/admin/replicas/0/drain"),
                     await client.post("/admin/replicas/0/undrain"),
                     await client.post("/admin/replicas"),
                     await client.delete("/admin/replicas/0")):
            assert resp.status == 409
            assert "migration.enabled=false" in (
                await resp.json())["error"]["message"]
        body = await (await client.get("/admin/replicas")).json()
        assert body["dp"] == 2
    finally:
        await client.close()

