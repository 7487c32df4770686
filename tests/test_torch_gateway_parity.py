"""The reference gateway against the port's, on one weight tree.

The reference app serves ``tiny-dense`` through ``engine_type: jax_tpu``
(float32, the jnp twins); the port's app serves it through
``engine_type: torch_cuda`` on the CPU, with the JAX ``init_params`` tree
carried over by ``params_from_jax`` (the test swaps the
``load_or_init_params`` name the port's engine core uses).  Both get the
same requests; their bodies, stripped of ids, ``created`` and timings,
must be equal, logprobs within 1e-4.  ``/v1/embeddings`` serves
``tiny-encoder`` on both (the port's encoder gets the JAX seed-0 tree
too); its vectors agree within 1e-5."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from vgate_tpu.config import load_config as j_load_config
from vgate_tpu.models.encoder import init_encoder_params as j_init_encoder
from vgate_tpu.models.specs import TINY_ENCODER as J_TINY_ENCODER
from vgate_tpu.runtime.weights import load_or_init_params as j_init
from vgate_tpu.server.app import create_app as j_create_app
from vgate_tpu_torch import config as config_mod
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.models import encoder as port_encoder
from vgate_tpu_torch.models.specs import TINY_DENSE, TINY_ENCODER
from vgate_tpu_torch.runtime import engine_core as port_engine_core
from vgate_tpu_torch.runtime.weights import params_from_jax
from vgate_tpu_torch.server.app import create_app

MODEL = {"model_id": "tiny-dense", "dtype": "float32", "max_model_len": 64,
         "embedding_model_id": "tiny-encoder"}
SHAPES = {
    "kv_num_pages": 64,
    "kv_page_size": 4,
    "max_batch_slots": 4,
    "prefill_buckets": [8, 16, 32],
    "prefix_cache": False,
}
COMMON = dict(
    batch={"max_batch_size": 4, "max_wait_time_ms": 5.0},
    scheduler={"max_queue_size": 16},
    logging={"level": "WARNING"},
)
LP_TOL = 1e-4
EMBED_TOL = 1e-5
# per-response envelope and timing fields, not content
VOLATILE = {"id", "created", "metrics", "request_id"}


@pytest.fixture(autouse=True)
def _reset_port_config():
    config_mod.reset_config()
    yield
    config_mod.reset_config()


@pytest.fixture
def port_params(monkeypatch):
    """The port's engine core builds the JAX seed-0 tree, as the
    reference engine does."""
    def load(spec, checkpoint_path, device, dtype, seed=0,
             log_digests=False, quantization=None):
        assert spec.name == TINY_DENSE.name and seed == 0
        tree = j_init(TINY_DENSE, None, np.float32)
        return params_from_jax(jax.tree.map(np.asarray, tree), TINY_DENSE)

    monkeypatch.setattr(port_engine_core, "load_or_init_params", load)

    def init_encoder(spec, generator, dtype, device):
        assert spec.name == TINY_ENCODER.name
        tree = j_init_encoder(J_TINY_ENCODER, jax.random.PRNGKey(0),
                              jnp.float32)
        return params_from_jax(jax.tree.map(np.asarray, tree), spec)

    monkeypatch.setattr(port_encoder, "init_encoder_params", init_encoder)


async def _clients():
    ref = j_create_app(j_load_config(
        model={**MODEL, "engine_type": "jax_tpu"},
        tpu={"dp": 1, "tp": 1, "ep": 1, "sp": 1, "num_devices": 1,
             "use_pallas": False, **SHAPES},
        integrity={"enabled": False},
        **COMMON,
    ))
    port = create_app(load_config(
        model={**MODEL, "engine_type": "torch_cuda"},
        device={"device": "cpu", **SHAPES},
        **COMMON,
    ))
    clients = [TestClient(TestServer(app)) for app in (ref, port)]
    for c in clients:
        await c.start_server()
    return clients


def _strip(body):
    if isinstance(body, dict):
        return {k: _strip(v) for k, v in body.items() if k not in VOLATILE}
    if isinstance(body, list):
        return [_strip(v) for v in body]
    return body


def _assert_same(ref, port, path="body"):
    """Equal structures; a ``logprob`` value within LP_TOL."""
    assert type(ref) is type(port), (path, ref, port)
    if isinstance(ref, dict):
        assert ref.keys() == port.keys(), (path, ref.keys(), port.keys())
        for k in ref:
            if k in ("logprob", "token_logprobs"):
                np.testing.assert_allclose(
                    np.asarray(port[k], np.float64),
                    np.asarray(ref[k], np.float64), atol=LP_TOL,
                    err_msg=f"{path}.{k}",
                )
            elif k == "top_logprobs" and isinstance(ref[k], list) and ref[k] \
                    and isinstance(ref[k][0], dict) and "token" not in ref[k][0]:
                # legacy completions: [{token: logprob}] per position
                for i, (r, p) in enumerate(zip(ref[k], port[k])):
                    assert r.keys() == p.keys(), (path, i)
                    for t in r:
                        assert abs(r[t] - p[t]) <= LP_TOL, (path, i, t)
            else:
                _assert_same(ref[k], port[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(ref) == len(port), (path, ref, port)
        for i, (r, p) in enumerate(zip(ref, port)):
            _assert_same(r, p, f"{path}[{i}]")
    else:
        assert ref == port, (path, ref, port)


def _sse(raw: str):
    return [
        json.loads(line[len("data: "):])
        for line in raw.splitlines()
        if line.startswith("data: ") and line != "data: [DONE]"
    ]


def _stream_digest(chunks):
    """What a client reads from an SSE chat stream: the envelope, the
    joined deltas, the logprob entries in order, the finish reason and
    the usage chunk.  The chunk boundaries are not compared: the port
    holds back a trailing incomplete character the reference emits at
    once (ROADMAP, deliberate differences)."""
    choices = [c["choices"][0] for c in chunks if c["choices"]]
    usage = [c["usage"] for c in chunks if c.get("usage")]
    return {
        "object": sorted({c["object"] for c in chunks}),
        "model": sorted({c["model"] for c in chunks}),
        "role": choices[0]["delta"],
        "text": "".join(c["delta"].get("content", "") for c in choices),
        "logprobs": [e for c in choices
                     for e in (c.get("logprobs") or {}).get("content", [])],
        "finish": choices[-1]["finish_reason"],
        "usage": usage,
    }


def _chat(content, **extra):
    return {"messages": [{"role": "user", "content": content}],
            "temperature": 0.0, **extra}


def _stop_string(text):
    """A printable ASCII character past the start of ``text`` (random
    weights decode to mostly other bytes)."""
    for ch in text[1:]:
        if ch.isascii() and ch.isprintable():
            return ch
    raise AssertionError(f"no printable ASCII in {text!r}")


async def test_gateway_bodies_match_the_reference(port_params):
    ref, port = await _clients()
    try:
        async def both(path, body):
            out = []
            for c in (ref, port):
                resp = await c.post(path, json=body)
                assert resp.status == 200, (c, await resp.text())
                out.append(resp)
            return out

        async def same_json(path, body):
            r, p = [await x.json() for x in await both(path, body)]
            _assert_same(_strip(r), _strip(p))
            return r, p

        async def same_sse(body):
            r, p = [_stream_digest(_sse(await x.text())) for x in
                    await both("/v1/chat/completions", body)]
            _assert_same(_strip(r), _strip(p))
            return r

        # greedy chat, plain and streamed (the joined deltas too)
        chat, _ = await same_json(
            "/v1/chat/completions", _chat("alpha beta", max_tokens=10))
        text = chat["choices"][0]["message"]["content"]
        streamed = await same_sse(_chat("alpha beta", max_tokens=10,
                                        stream=True))
        assert streamed["text"] == text
        assert streamed["finish"] == chat["choices"][0]["finish_reason"]
        # a text completion, with legacy logprobs
        comp, _ = await same_json(
            "/v1/completions",
            {"prompt": "gamma delta", "max_tokens": 10, "temperature": 0.0,
             "logprobs": 2})
        assert len(comp["choices"][0]["logprobs"]["tokens"]) == (
            comp["usage"]["completion_tokens"])
        # n: 2 with a stop string from the free output
        free, _ = await same_json(
            "/v1/chat/completions", _chat("epsilon zeta", max_tokens=12))
        stop = _stop_string(free["choices"][0]["message"]["content"])
        stopped, _ = await same_json(
            "/v1/chat/completions",
            _chat("epsilon zeta", max_tokens=12, n=2, stop=[stop]))
        assert len(stopped["choices"]) == 2
        assert stopped["choices"][0]["finish_reason"] == "stop"
        # logprobs with top_logprobs 3: ids equal, values within 1e-4
        lp, _ = await same_json(
            "/v1/chat/completions",
            _chat("eta theta", max_tokens=8, logprobs=True, top_logprobs=3))
        entries = lp["choices"][0]["logprobs"]["content"]
        assert len(entries) == lp["usage"]["completion_tokens"]
        assert all(len(e["top_logprobs"]) == 3 for e in entries)
        lp_stream = await same_sse(_chat(
            "eta theta", max_tokens=8, logprobs=True, top_logprobs=3,
            stream=True))
        _assert_same(lp_stream["logprobs"], entries)
        # stream_options.include_usage
        usage = await same_sse(_chat(
            "iota kappa", max_tokens=8, stream=True,
            stream_options={"include_usage": True}))
        assert len(usage["usage"]) == 1
        assert usage["usage"][0]["completion_tokens"] >= 1

        stats = await (await port.get("/stats")).json()
        assert stats["engine"]["running"] == 0
        assert stats["engine"]["used_pages"] == 0
        # the encoder: the same body, vectors within EMBED_TOL
        r, p = [await x.json() for x in await both("/v1/embeddings", {
            "input": ["x", "hello world", "a longer input " * 6]})]
        vecs = [[d.pop("embedding") for d in b["data"]] for b in (r, p)]
        _assert_same(_strip(r), _strip(p))
        np.testing.assert_allclose(np.asarray(vecs[1]), np.asarray(vecs[0]),
                                   atol=EMBED_TOL)
        assert p["model"] == "tiny-encoder" and len(vecs[1]) == 3
        np.testing.assert_allclose(np.linalg.norm(vecs[1], axis=-1), 1.0,
                                   atol=1e-5)
    finally:
        for c in (ref, port):
            await c.close()


async def test_gateway_recovery_drill_matches_the_reference(port_params):
    """The recovery drill through both gateways, each supervised (the
    default): with ``decode_step`` armed to raise once, a chat completes
    200 with ``"resumed": true`` and the body the undisturbed run gives;
    ``/stats`` shows one restart, one resumed, none lost and the
    transitions serving -> recovering -> degraded; ``/health`` and the
    item-7 routes (``/debug/flight``, ``/debug/perf``,
    ``/debug/requests`` and one record, ``/debug/spans``, ``/v1/profile``)
    answer the reference's status codes with its keys."""
    from vgate_tpu import faults as j_faults
    from vgate_tpu_torch import faults

    # the result cache off: the drill's request repeats the clean one
    sections = dict(COMMON, recovery={"backoff_base_s": 0.05},
                    cache={"enabled": False})
    apps = [
        j_create_app(j_load_config(
            model={**MODEL, "engine_type": "jax_tpu"},
            tpu={"dp": 1, "tp": 1, "ep": 1, "sp": 1, "num_devices": 1,
                 "use_pallas": False, **SHAPES},
            **sections,
        )),
        create_app(load_config(
            model={**MODEL, "engine_type": "torch_cuda"},
            device={"device": "cpu", **SHAPES}, **sections,
        )),
    ]
    ref, port = [TestClient(TestServer(app)) for app in apps]
    for c in (ref, port):
        await c.start_server()
    faults.reset()
    try:
        async def both(method, path, **kw):
            out = []
            for c in (ref, port):
                resp = await getattr(c, method)(path, **kw)
                out.append((resp.status, await resp.json()))
            assert out[0][0] == out[1][0], (path, out)
            return out

        body = _chat("the drill", max_tokens=12)
        [(_, clean_r), (_, clean_p)] = await both(
            "post", "/v1/chat/completions", json=body)
        j_faults.arm("decode_step", mode="raise", times=1)
        faults.arm("decode_step", mode="raise", times=1)
        [(status, r), (_, p)] = await both(
            "post", "/v1/chat/completions", json=body,
            headers={"X-Request-ID": "drill-1"})
        assert status == 200
        assert r.pop("resumed") is True and p.pop("resumed") is True
        _assert_same(_strip(r), _strip(p))
        assert clean_p.pop("resumed") is False
        _assert_same(_strip(clean_p), _strip(p))
        [(_, rs), (_, ps)] = await both("get", "/stats")
        for stats in (rs, ps):
            sup = stats["engine"]["supervisor"]
            assert (sup["restarts"], sup["resumed"], sup["lost"]) == \
                (1, 1, 0)
            assert sup["transitions"][:2] == [["serving", "recovering"],
                                              ["recovering", "degraded"]]
            assert stats["engine"]["last_resume"]["replayed"] == 1
        for block in ("supervisor", "last_crash", "last_resume", "flight",
                      "perf", "integrity"):
            assert set(rs["engine"][block]) == set(ps["engine"][block]), \
                block
        [(_, rh), (_, ph)] = await both("get", "/health")
        assert set(rh) == set(ph) and set(rh["engine"]) == set(ph["engine"])
        assert rh["engine"]["state"] == ph["engine"]["state"] == "degraded"
        for path in ("/debug/flight", "/debug/perf", "/debug/requests",
                     "/debug/spans"):
            [(_, rd), (_, pd)] = await both("get", path)
            assert set(rd) == set(pd), path
        [(status, rd), (_, pd)] = await both("get",
                                             "/debug/requests/drill-1")
        assert status == 200 and set(rd) == set(pd)
        assert rd["request_id"] == pd["request_id"] == "drill-1"
        [(status, rd), (_, pd)] = await both(
            "post", "/v1/profile", json={"duration_ms": 50})
        assert status == 200 and set(rd) == set(pd)
    finally:
        j_faults.reset()
        faults.reset()
        for c in (ref, port):
            await c.close()
