"""Key cases of the reference's host-module tests (``test_admission.py``,
``test_lifecycle.py``, ``test_security.py``, ``test_cache.py`` and
``test_config.py``'s layering) run against the port's copies:
``vgate_tpu_torch.admission``, ``lifecycle``, ``security``, ``cache``
and the env/YAML layers of ``vgate_tpu_torch.config``."""

import asyncio
import pathlib
from collections import deque

import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from vgate_tpu_torch import config as config_mod
from vgate_tpu_torch.admission import (
    AdmissionController,
    PressureController,
    TierQueue,
    estimate_prompt_tokens,
    tier_rank,
)
from vgate_tpu_torch.cache import ResultCache
from vgate_tpu_torch.config import (
    AdmissionConfig,
    NotPortedError,
    _env_overrides,
    get_config,
    load_config,
    reset_config,
    set_config,
)
from vgate_tpu_torch.errors import (
    ClientQuotaExceededError,
    ServerOverloadedError,
)
from vgate_tpu_torch.lifecycle import CancelToken, DrainController, all_of
from vgate_tpu_torch.security import RateLimiter, build_security_middleware


@pytest.fixture(autouse=True)
def _reset_port_config():
    reset_config()
    yield
    reset_config()


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


FLAT = {"interactive": 1.0, "standard": 1.0, "batch": 1.0}


def make_controller(signals=None, clock=None, **overrides):
    return AdmissionController(
        AdmissionConfig(**overrides), signals=signals,
        clock=clock or FakeClock(),
    )


# ------------------------------------------------------------ admission


def test_backlog_token_boundary():
    ctl = make_controller(max_queued_tokens=100, max_queued_requests=0,
                          tier_fractions=FLAT)
    ctl.admit(60)
    with pytest.raises(ServerOverloadedError) as exc:
        ctl.admit(50)
    assert exc.value.shed_reason == "backlog_tokens"
    assert exc.value.reason == "overloaded"
    ctl.admit(40)  # exactly at the limit is still admitted
    ctl.release(60)
    ctl.admit(50)


def test_backlog_request_boundary():
    ctl = make_controller(max_queued_tokens=0, max_queued_requests=2,
                          tier_fractions=FLAT)
    ctl.admit(1)
    ctl.admit(1)
    with pytest.raises(ServerOverloadedError) as exc:
        ctl.admit(1)
    assert exc.value.shed_reason == "backlog_requests"
    ctl.release(1)
    ctl.admit(1)


def test_would_miss_slo_rejected_at_the_door():
    ctl = make_controller(max_queued_tokens=0, max_queued_requests=0,
                          throughput_init_tps=100.0)
    ctl.admit(1000)  # predicted wait is now 10 s
    with pytest.raises(ServerOverloadedError) as exc:
        ctl.admit(10, deadline_s=5.0)
    assert exc.value.shed_reason == "would_miss_slo"
    assert exc.value.retry_after >= 1.0
    ctl.admit(10, deadline_s=20.0)
    ctl.admit(10)


def test_kv_watermark_sheds_batch_before_interactive():
    """Fed by the torch engine's ``pressure_signals`` key."""
    sig = {"kv_free_ratio": 0.07}
    ctl = make_controller(signals=lambda: sig, max_queued_tokens=0,
                          max_queued_requests=0, kv_free_watermark=0.05)
    with pytest.raises(ServerOverloadedError) as exc:
        ctl.admit(10, tier="batch")
    assert exc.value.shed_reason == "kv_pressure"
    ctl.admit(10, tier="standard")
    ctl.admit(10, tier="interactive")
    sig["kv_free_ratio"] = 0.02
    with pytest.raises(ServerOverloadedError):
        ctl.admit(10, tier="interactive")


def test_per_key_inflight_cap_and_idempotent_release():
    ctl = make_controller(per_key_max_inflight=1, max_queued_tokens=0,
                          max_queued_requests=0)
    rel1 = ctl.acquire_inflight("k1")
    with pytest.raises(ClientQuotaExceededError):
        ctl.acquire_inflight("k1")
    rel2 = ctl.acquire_inflight("k2")
    ctl.acquire_inflight(None)  # keyless traffic is never capped
    rel1()
    rel1()  # a double release must not go negative
    ctl.acquire_inflight("k1")
    rel2()
    assert "k2" not in ctl._inflight_by_key


@pytest.mark.parametrize(
    "claim,key,tier",
    [(None, None, "standard"), ("interactive", None, "interactive"),
     (None, "kb", "batch"), ("interactive", "kb", "batch"),
     ("batch", "ki", "batch"), (None, "unmapped", "standard")],
)
def test_resolve_tier_field_key_and_cap(claim, key, tier):
    ctl = make_controller(key_tiers={"kb": "batch", "ki": "interactive"})
    assert ctl.resolve_tier(claim, key) == tier


def test_throughput_ewma_follows_completions():
    clock = FakeClock()
    ctl = make_controller(clock=clock, throughput_init_tps=100.0,
                          throughput_alpha=0.5)
    clock.advance(2.0)
    ctl.observe_completion(1000)
    assert ctl.get_stats()["throughput_tps"] == pytest.approx(300.0)


def test_estimate_prompt_tokens():
    assert estimate_prompt_tokens("") == 1
    assert estimate_prompt_tokens("x" * 400) == 100


class _Req:
    def __init__(self, tier, i):
        self.tier_rank = tier_rank(tier)
        self.i = i


def test_tier_queue_weighted_take():
    q = TierQueue(weights={"interactive": 2, "standard": 1, "batch": 1})
    for tier, n in (("interactive", 4), ("standard", 2), ("batch", 2)):
        for i in range(n):
            q.append(_Req(tier, i))
    assert [r.tier_rank for r in q.take(4)] == [0, 0, 1, 2]
    assert [r.tier_rank for r in q.take(4)] == [0, 0, 1, 2]
    assert not q


def test_tier_queue_list_protocol_and_drain_order():
    q = TierQueue()
    a, b, c = _Req("batch", 0), _Req("interactive", 1), _Req("standard", 2)
    for r in (a, b, c):
        q.append(r)
    assert a in q and len(q) == 3
    assert q.depths() == {"interactive": 1, "standard": 1, "batch": 1}
    q.remove(a)
    assert a not in q
    q.append(a)
    assert [r.i for r in q.drain()] == [1, 2, 0]


def _pressure(sig, clock, seen=None, **overrides):
    overrides.setdefault("brownout_update_interval_s", 0.0)
    cfg = AdmissionConfig(**overrides)
    adm = AdmissionController(cfg, signals=lambda: sig, clock=clock)
    return PressureController(
        cfg, adm, signals=lambda: sig, clock=clock,
        on_transition=(lambda **kw: seen.append(kw)) if seen is not None
        else None,
    )


def test_brownout_engages_at_once_and_releases_with_hysteresis():
    clock = FakeClock()
    sig = {"kv_free_ratio": 1.0}
    seen = []
    pc = _pressure(sig, clock, seen)
    pc.maybe_update()
    assert pc.level == 0
    sig["kv_free_ratio"] = 0.0
    clock.advance(1.0)
    pc.maybe_update()
    assert pc.level == 4
    assert pc.active_steps()[-1] == "bypass_cache_writes"
    assert seen[-1]["level"] == 4 and seen[-1]["prev"] == 0
    assert pc.clamp_max_tokens(512) == 128
    assert pc.cache_write_bypass
    sig["kv_free_ratio"] = 1.0
    clock.advance(1.0)
    pc.maybe_update()  # the hold starts at the first calm reading
    clock.advance(5.0)
    pc.maybe_update()
    assert pc.level == 4  # held: 10 s below the release threshold first
    clock.advance(6.0)
    pc.maybe_update()
    assert pc.level == 3


# ------------------------------------------------------------ lifecycle


def test_cancel_token_runs_callbacks_once_and_late():
    token = CancelToken()
    fired = []
    token.add_callback(lambda: fired.append("early"))
    assert token.cancel("client_disconnect") is True
    assert token.cancel("client_disconnect") is False
    token.add_callback(lambda: fired.append("late"))
    assert fired == ["early", "late"]
    assert token.cancelled and token.reason == "client_disconnect"


def test_all_of_fires_only_when_every_member_cancelled():
    t1, t2 = CancelToken(), CancelToken()
    combined = all_of([t1, t2])
    t1.cancel("client_disconnect")
    assert not combined.cancelled
    t2.cancel("drain")
    assert combined.cancelled and combined.reason == "drain"
    assert all_of([CancelToken(), None]) is None
    assert all_of([]) is None
    t3 = CancelToken()
    assert all_of([t3]) is t3


@pytest.mark.parametrize("stragglers", [0, 1])
async def test_drain_controller_sweeps_stragglers_past_its_timeout(
    stragglers
):
    """With nothing in flight the drain completes at once; a request
    still in flight at the timeout is swept (``abort_stragglers``)."""
    inflight = {"n": stragglers}
    calls, done = [], asyncio.Event()

    def sweep():
        calls.append("sweep")
        inflight["n"] = 0

    drain = DrainController(
        drain_timeout_s=0.05, poll_s=0.005,
        stop_admission=lambda: calls.append("stop"),
        inflight=lambda: inflight["n"],
        abort_stragglers=sweep, on_complete=done.set,
    )
    drain.begin()
    assert drain.draining
    assert await drain.wait_drained(5.0)
    await asyncio.wait_for(done.wait(), 5.0)
    assert calls == ["stop"] + ["sweep"] * stragglers
    assert drain.aborted_stragglers == stragglers


# ------------------------------------------------------------- security


def test_rate_limiter_window():
    rl = RateLimiter(requests_per_minute=2)
    assert rl.check("k", now=100.0)[0]
    assert rl.check("k", now=101.0)[0]
    allowed, headers = rl.check("k", now=102.0)
    assert not allowed
    assert headers["X-RateLimit-Remaining"] == "0"
    assert int(headers["Retry-After"]) >= 1
    assert rl.check("k", now=161.0)[0]  # the first stamp expired
    assert rl.check("other", now=161.0)[0]  # keys are independent
    assert isinstance(rl._windows["k"], deque)


def test_rate_limiter_per_key_limits_and_sweep():
    rl = RateLimiter(requests_per_minute=1, per_key_limits={"vip": 100})
    assert rl.limit_for("vip") == 100 and rl.limit_for("other") == 1
    for i in range(50):
        rl.check(f"rotating-{i}", now=100.0)
    rl.check("steady", now=100.0)
    rl.check("steady", now=161.0)
    assert set(rl._windows) == {"steady"}


SEC = dict(
    security={"enabled": True, "api_keys": ["sk-good"]},
    rate_limit={"enabled": True, "requests_per_minute": 2},
)


@pytest.mark.parametrize(
    "path,headers,status",
    [("/v1/thing", {}, 401),
     ("/v1/thing", {"Authorization": "Bearer sk-bad"}, 401),
     ("/v1/thing", {"Authorization": "Bearer sk-good"}, 200),
     ("/health", {}, 200)],
)
async def test_security_middleware(path, headers, status):
    async def ok(request):
        return web.json_response({"ok": True})

    app = web.Application(
        middlewares=[build_security_middleware(load_config(**SEC))]
    )
    app.router.add_get("/v1/thing", ok)
    app.router.add_get("/health", ok)
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        resp = await client.get(path, headers=headers)
        assert resp.status == status
        if status == 401:
            body = await resp.json()
            assert body["error"]["type"] == "authentication_error"
        if headers.get("Authorization") == "Bearer sk-good":
            assert resp.headers["X-RateLimit-Limit"] == "2"
            await client.get(path, headers=headers)
            limited = await client.get(path, headers=headers)
            assert limited.status == 429
            assert "Retry-After" in limited.headers
    finally:
        await client.close()


# ---------------------------------------------------------------- cache


def test_cache_key_stability_and_sensitivity():
    base = ResultCache.make_key("hello", 0.7, 0.95, 100)
    assert base == ResultCache.make_key("hello", 0.7, 0.95, 100)
    assert len(base) == 16
    for other in (
        ResultCache.make_key("hello!", 0.7, 0.95, 100),
        ResultCache.make_key("hello", 0.8, 0.95, 100),
        ResultCache.make_key("hello", 0.7, 0.9, 100),
        ResultCache.make_key("hello", 0.7, 0.95, 101),
        ResultCache.make_key("hello", 0.7, 0.95, 100, top_k=5),
    ):
        assert other != base


async def test_cache_lru_eviction_and_stats():
    cache = ResultCache(max_size=2)
    await cache.put("a", 1)
    await cache.put("b", 2)
    assert await cache.get("a") == 1  # b is now least recent
    await cache.put("c", 3)
    assert await cache.get("b") is None
    stats = cache.get_stats()
    assert stats["hits"] == 1 and stats["misses"] == 1
    assert stats["evictions"] == 1 and stats["size"] == 2
    await cache.clear()
    assert await cache.get("a") is None


async def test_disabled_cache():
    cache = ResultCache(max_size=4, enabled=False)
    await cache.put("k", 1)
    assert await cache.get("k") is None
    assert cache.get_stats()["enabled"] is False


# --------------------------------------------------------------- config


def test_gateway_section_defaults():
    cfg = load_config()
    assert cfg.server.port == 8000
    assert cfg.model.engine_type == "torch_cuda"
    assert cfg.batch.max_batch_size == 8
    assert cfg.batch.max_wait_time_ms == 50.0
    assert cfg.cache.enabled is True and cfg.cache.max_size == 1024
    assert cfg.lifecycle.drain_timeout_s == 30.0
    assert cfg.admission.brownout_engage == [0.5, 0.7, 0.85, 0.95]
    assert cfg.security.enabled is False
    assert cfg.gateway.journal_path == ""


def test_env_override_parsing():
    env = {
        "VGT_SERVER__PORT": "9002",
        "VGT_CACHE__ENABLED": "false",
        "VGT_DEVICE__PREFILL_BUCKETS": "[64, 128]",
        "VGT_DEVICE__PREFIX_CACHE__ENABLED": "off",
        "VGT_MODEL__MODEL_ID": "tiny-dense",
        "VGT_DRY_RUN": "1",  # flat flags are read where they apply
        "VGT_CONFIG_PATH": "/x.yaml",
        "OTHER__KEY": "1",
    }
    assert _env_overrides(env) == {
        "server": {"port": 9002},
        "cache": {"enabled": False},
        "device": {"prefill_buckets": [64, 128],
                   "prefix_cache": {"enabled": False}},
        "model": {"model_id": "tiny-dense"},
    }


def test_layers_caller_over_env_over_yaml(tmp_path, monkeypatch):
    path = tmp_path / "port.yaml"
    path.write_text(
        "server:\n  port: 9001\n  host: 127.0.0.1\n"
        "batch:\n  max_batch_size: 16\n"
    )
    monkeypatch.setenv("VGT_CONFIG_PATH", str(path))
    monkeypatch.setenv("VGT_SERVER__PORT", "9002")
    monkeypatch.setenv("VGT_DEVICE__DEVICE", "cpu")
    cfg = load_config(batch={"max_batch_size": 4})
    assert cfg.server.port == 9002  # env beats YAML
    assert cfg.server.host == "127.0.0.1"  # YAML beats defaults
    assert cfg.batch.max_batch_size == 4  # the caller beats both
    assert cfg.device.device == "cpu"
    assert cfg.cache.max_size == 1024


def test_the_reference_config_yaml_is_refused(monkeypatch):
    """The repo's config.yaml is the reference's (a ``tpu`` section): the
    port refuses it instead of ignoring what it cannot serve."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    monkeypatch.setenv("VGT_CONFIG_PATH", str(repo / "config.yaml"))
    with pytest.raises(TypeError, match="tpu"):
        load_config()


@pytest.mark.parametrize(
    "sections,err",
    [({"admission": {"default_tier": "gold"}}, ValueError),
     ({"admission": {"key_tiers": {"k": "gold"}}}, ValueError),
     ({"admission": {"prefix_discount": 1.5}}, ValueError),
     ({"admission": {"brownout_engage": [0.5, 0.4, 0.85, 0.95]}},
      ValueError),
     ({"gateway": {"journal_max_bytes": 0}}, ValueError),
     ({"logging": {"format": "xml"}}, ValueError),
     ({"server": {"workers": 2}}, TypeError),
     ({"recovery": {"max_restart": 3}}, TypeError)],
)
def test_gateway_validators(sections, err):
    with pytest.raises(err):
        load_config(**sections)


def test_singleton_and_reset():
    a = get_config()
    assert get_config() is a
    reset_config()
    assert get_config() is not a
    set_config(load_config(server={"port": 1234}))
    assert get_config().server.port == 1234
    assert config_mod.get_config().server.port == 1234


def test_not_ported_switches_still_refuse():
    # tp=2 serves since item 10a and dp=2 since item 10b; a dp replica
    # that is itself a mesh is item 10b's rest
    with pytest.raises(NotPortedError, match="queue 1, item 10b \\(rest\\)"):
        load_config(device={"dp": 2, "tp": 2})
