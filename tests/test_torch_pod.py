"""The port's process-isolated pod on the CPU, against the reference's
in-process EngineCore.

Both engines load one ``tiny-dense`` safetensors checkpoint that the
test writes: the port's workers through ``params_from_safetensors``,
the reference through its own loader.  Real worker processes
(``python -m vgate_tpu_torch.runtime.worker``) serve the streams; the
reference engine runs each wave in-process, tick by tick.  Greedy
streams must be token-identical:

* through the backend seam (``pod.workers: 0`` stays in-process, 2
  gives a PodEngine), before and after a worker is SIGKILLed
  mid-stream (its streams replay on the survivor; the respawned worker
  passes the canary gate before it is routed to);
* with ``pod.roles: [prefill, decode]`` on bf16 and int8 pools, where
  the KV crosses by the chunked, checksummed transfer (handoffs > 0)
  and a prompt past the staging floor falls back, counted;

a stale-epoch frame is discarded and counted on both sides; the
gateway's ``/debug/pod`` and ``/admin/replicas`` answer a pod with the
reference's shapes; and ``EngineCore.evacuate`` (a worker's drain)
folds what the reference's folds.  Every test bounds itself: low pod timeouts, and a
fixture that kills every worker process a pod spawned at teardown.
"""

import os
import signal
import time

import numpy as np
import pytest
import torch

from aiohttp.test_utils import TestClient, TestServer

import jax

from vgate_tpu.backends.base import SamplingParams as JSamplingParams
from vgate_tpu.config import load_config as j_load_config
from vgate_tpu.runtime.engine_core import EngineCore as JEngineCore
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.backends.torch_backend import TorchCUDABackend
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.models.specs import TINY_DENSE
from vgate_tpu_torch.runtime import pod_engine
from vgate_tpu_torch.runtime.pod_engine import PodEngine
from vgate_tpu_torch.runtime.supervisor import EngineSupervisor
from vgate_tpu_torch.server.app import create_app

PS = 4
MODEL = {"model_id": "tiny-dense", "dtype": "float32", "max_model_len": 96}
SHAPES = {"kv_num_pages": 96, "kv_page_size": PS, "max_batch_slots": 4,
          "prefill_buckets": [8, 16, 32, 64], "decode_chunk": 2}
POD = {"heartbeat_interval_s": 0.2, "heartbeat_timeout_s": 60.0,
       "spawn_timeout_s": 120.0, "call_timeout_s": 60.0,
       "connect_timeout_s": 10.0, "transfer_timeout_s": 60.0}
TOKENS = 16
# bf16 pages of tiny-dense hold 2 layers x K,V x 2 heads x 4 slots x 16
PAGE_BYTES = {"bf16": 2 * 2 * 2 * PS * 16 * 2, "int8": 2 * 2 * 2 * PS * 18}


def _prompts(seed, n, lo=6, hi=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, TINY_DENSE.vocab_size,
                         size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _state_dict(seed=0):
    """HF ``Qwen2ForCausalLM`` names, linear weights [out, in]."""
    g = torch.Generator().manual_seed(seed)
    spec = TINY_DENSE
    D, F = spec.hidden_size, spec.intermediate_size
    H, KV, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim

    def w(*shape):
        return torch.randn(shape, generator=g) * 0.08

    sd = {"model.embed_tokens.weight": w(spec.vocab_size, D) * 10,
          "model.norm.weight": 1 + w(D),
          "lm_head.weight": w(spec.vocab_size, D)}
    for i in range(spec.num_layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = 1 + w(D)
        sd[p + "post_attention_layernorm.weight"] = 1 + w(D)
        for name, out in (("q", H * hd), ("k", KV * hd), ("v", KV * hd)):
            sd[p + f"self_attn.{name}_proj.weight"] = w(out, D)
            sd[p + f"self_attn.{name}_proj.bias"] = w(out)
        sd[p + "self_attn.o_proj.weight"] = w(D, H * hd)
        sd[p + "mlp.gate_proj.weight"] = w(F, D)
        sd[p + "mlp.up_proj.weight"] = w(F, D)
        sd[p + "mlp.down_proj.weight"] = w(D, F)
    return sd


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from safetensors.torch import save_file

    path = tmp_path_factory.mktemp("tiny-dense-ckpt")
    save_file({k: v.contiguous() for k, v in _state_dict().items()},
              str(path / "model.safetensors"))
    return str(path)


class _Reference:
    """The reference's in-process EngineCore over the checkpoint, one
    per pool dtype; ``streams`` runs a wave tick by tick."""

    def __init__(self, ckpt):
        self.ckpt = ckpt
        self.cores = {}

    def streams(self, prompts, kv="auto", tokens=TOKENS):
        if kv not in self.cores:
            cfg = j_load_config(
                model={**MODEL, "engine_type": "jax_tpu",
                       "checkpoint_path": self.ckpt},
                tpu={"dp": 1, "tp": 1, "ep": 1, "sp": 1,
                     "use_pallas": False, **SHAPES},
                kv_cache={"dtype": kv},
                scheduler={"max_queue_size": 64},
                integrity={"enabled": False}, logging={"level": "ERROR"},
            )
            self.cores[kv] = JEngineCore(cfg, devices=jax.devices()[:1])
        core = self.cores[kv]
        params = JSamplingParams(max_tokens=tokens, temperature=0.0)
        seqs = [core.submit_tokens(list(p), params) for p in prompts]
        for _ in range(100_000):
            if all(s.done_event.is_set() for s in seqs):
                break
            core._tick()
        return [list(s.generated_ids) for s in seqs]

    def stop(self):
        for core in self.cores.values():
            core.stop()


@pytest.fixture(scope="module")
def reference(ckpt):
    ref = _Reference(ckpt)
    yield ref
    ref.stop()


@pytest.fixture
def spawned(monkeypatch):
    """Every worker process any pod of the test spawns, SIGKILLed (if
    still alive) at teardown, so no test can leave one behind."""
    procs = []
    real = pod_engine.PodEngine._spawn

    def spawn(self, w):
        real(self, w)
        procs.append(w.proc)

    monkeypatch.setattr(pod_engine.PodEngine, "_spawn", spawn)
    yield procs
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def _config(ckpt, kv="auto", **pod):
    return load_config(
        model={**MODEL, "engine_type": "torch_cuda", "checkpoint_path": ckpt},
        device={"device": "cpu", **SHAPES},
        kv_cache={"dtype": kv},
        scheduler={"max_queue_size": 64},
        recovery={"backoff_base_s": 0.05, "backoff_cap_s": 0.5},
        logging={"level": "ERROR"},
        pod={**POD, **pod},
    )


def _serve(core, prompts, tokens=TOKENS):
    params = SamplingParams(max_tokens=tokens, temperature=0.0)
    return [core.submit_tokens(list(p), params) for p in prompts]


def _wait(seqs, timeout=180.0):
    deadline = time.monotonic() + timeout
    for s in seqs:
        assert s.done_event.wait(max(0.1, deadline - time.monotonic())), \
            "a stream never finished"
        assert s.error is None, s.error
    return [list(s.generated_ids) for s in seqs]


def _wait_for(cond, what, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


# ---------------------------------------------------------------- seam


def test_seam_keeps_workers_0_in_process(ckpt):
    backend = TorchCUDABackend()
    backend.load_model(_config(ckpt, workers=0))
    try:
        assert isinstance(backend.core, EngineSupervisor)
    finally:
        backend.shutdown()


def test_pod_streams_match_the_reference_before_and_after_a_sigkill(
        ckpt, reference, spawned, monkeypatch):
    """Two workers through the backend seam.  Worker 0's first
    incarnation decodes slowly (a delay fault on its decode chunks), so
    it is SIGKILLed mid-stream: its streams replay on worker 1 and
    finish token-identical; worker 0 respawns, passes the canary gate,
    and serves a third wave."""
    monkeypatch.setenv("VGT_POD_WORKER_FAULTS",
                       "0=decode_step:delay:delay=0.05:times=-1")
    backend = TorchCUDABackend()
    backend.load_model(_config(ckpt, workers=2))
    pod = backend.core
    try:
        assert isinstance(pod, PodEngine)
        assert [w.state for w in pod.workers] == ["serving", "serving"]
        first = _prompts(1, 6)
        assert _wait(_serve(pod, first)) == reference.streams(first)

        second = _prompts(2, 6)
        seqs = _serve(pod, second)
        on_0 = [s for s in seqs if s._worker_idx == 0]
        assert on_0, "the prompts' prefix hash placed none on worker 0"
        _wait_for(lambda: any(len(s.generated_ids) >= 2 for s in on_0),
                  "worker 0 never streamed")
        victim = pod.workers[0]
        assert not all(s.done_event.is_set() for s in on_0)
        os.kill(victim.proc.pid, signal.SIGKILL)
        assert _wait(seqs) == reference.streams(second)
        assert pod.total_failovers == 1 and pod.total_resumed >= 1
        assert sum(s.resume_count for s in seqs) >= 1

        # respawned in a fresh process, gated by the canary, routable
        _wait_for(lambda: victim.alive and victim.epoch >= 3,
                  "worker 0 never came back")
        assert pod.total_restarts == 1
        assert pod._canary_expected is not None
        third = _prompts(3, 6)
        seqs = _serve(pod, third)
        assert _wait(seqs) == reference.streams(third)
        health = pod.health()
        assert health["state"] == "serving"
        assert [r["epoch"] for r in health["replicas"]] == [3, 1]
    finally:
        backend.shutdown()


def test_stale_epoch_frames_are_discarded_and_counted(ckpt, spawned):
    pod = PodEngine(_config(ckpt, workers=1))
    pod.start()
    try:
        [seq] = _serve(pod, _prompts(4, 1))
        out = _wait([seq])
        w = pod.workers[0]
        # gateway side: a late frame stamped with a dead incarnation's
        # epoch never reaches the stream
        before = pod.fenced_frames
        pod._on_frame(0, w.epoch, {"op": "tok", "sid": seq._sid, "t": 5,
                                   "e": w.epoch - 1})
        pod._on_frame(0, w.epoch, {"op": "done", "sid": seq._sid,
                                   "e": w.epoch + 7})
        assert pod.fenced_frames == before + 2
        assert list(seq.generated_ids) == out[0]
        # worker side: an RPC addressed to another incarnation is refused
        # typed and counted, and never touches the engine
        from vgate_tpu_torch.errors import WorkerFencedError

        client = w.client
        client.epoch = w.epoch + 1
        try:
            with pytest.raises(WorkerFencedError):
                client.call("stats", timeout=30)
        finally:
            client.epoch = w.epoch
        assert client.call("ping", timeout=30)["fenced_rejects"] == 1
        assert pod.get_stats()["pod"]["fenced_frames"] == before + 2
    finally:
        pod.stop()


# --------------------------------------------------------------- roles


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_roles_hand_off_kv_token_identically(ckpt, reference, spawned, kv):
    """``pod.roles: [prefill, decode]``: short prompts prefill on worker
    0 and decode on worker 1 after their KV crosses (handoffs counted
    exactly); a prompt whose pages exceed the staging floor falls back
    to monolithic decode on the prefill worker, counted.  Streams equal
    the reference's with the same pool dtype."""
    staging = 10 * PAGE_BYTES[kv]
    pod = PodEngine(_config(ckpt, kv, workers=2, roles=["prefill", "decode"],
                            transfer_staging_bytes=staging,
                            transfer_chunk_bytes=1000))
    pod.start()
    try:
        short = _prompts(5, 3, lo=5, hi=9)
        assert _wait(_serve(pod, short)) == reference.streams(short, kv)
        stats = pod.get_stats()["pod"]["handoffs"]
        assert stats["completed"] == 3 and stats["fallback_monolithic"] == 0
        assert stats["failed"] == 0
        long = _prompts(6, 1, lo=50, hi=51)
        assert _wait(_serve(pod, long)) == reference.streams(long, kv)
        stats = pod.get_stats()["pod"]["handoffs"]
        assert stats["completed"] == 3 and stats["fallback_monolithic"] == 1
        per_worker = pod.get_stats()["replicas"]
        # worker 1 decoded the handed-off streams from adopted pages
        assert per_worker[1]["kv_swap"]["swap_in_pages"]["handoff"] > 0
        assert per_worker[0]["kv_dtype"] == per_worker[1]["kv_dtype"]
    finally:
        pod.stop()


# ------------------------------------------------------------- gateway


async def test_gateway_pod_routes_answer_the_reference_shapes(ckpt, spawned):
    cfg = _config(ckpt, workers=2)
    client = TestClient(TestServer(create_app(cfg)))
    await client.start_server()
    try:
        body = await (await client.get("/debug/pod")).json()
        assert body["enabled"] is True
        assert set(body) == {
            "enabled", "workers", "transport", "roles", "inflight",
            "orphans", "fenced_frames", "handoffs", "adoption",
            "last_crash",
        }
        assert {"replica", "state", "epoch", "role", "pid",
                "inflight"} <= set(body["workers"][0])
        assert set(body["handoffs"]) == {
            "active", "completed", "fallback_monolithic", "failed",
            "roles", "table",
        }
        replicas = await (await client.get("/admin/replicas")).json()
        assert replicas["workers"] == 2 and replicas["dp"] == 2
        assert [r["state"] for r in replicas["replicas"]] == ["serving"] * 2
        drained = await client.post("/admin/replicas/1/drain")
        assert drained.status == 200
        assert (await drained.json()) == {"drained": 0, "worker": 1,
                                          "epoch": 1}
        replicas = await (await client.get("/admin/replicas")).json()
        assert replicas["draining"] == [1]
        assert replicas["state"] == "degraded"
        undrained = await client.post("/admin/replicas/1/undrain")
        assert (await undrained.json()) == {"worker": 1, "draining": False}
        for resp in (await client.post("/admin/replicas"),
                     await client.delete("/admin/replicas/0")):
            assert resp.status == 409
            assert (await resp.json())["error"]["type"] == "migration_refused"
        assert (await client.post("/admin/replicas/9/drain")).status == 409
        stats = await (await client.get("/stats")).json()
        assert stats["engine"]["pod"]["workers"][0]["state"] == "serving"
    finally:
        await client.close()


# ------------------------------------------------- planned evacuation


def test_evacuate_checkpoints_as_the_reference_and_replays_equal(ckpt):
    """``EngineCore.evacuate``'s engine-thread half, which a worker's
    drain runs: mid-decode, both engines fold every resident sequence
    (same generated tokens, kv-dtype stamped, migrate count 1, pages
    freed); re-admitted, each finishes with the reference's stream."""
    from vgate_tpu.runtime.engine_core import _EvacRequest as JEvac
    from vgate_tpu_torch.runtime.engine_core import EngineCore, _EvacRequest

    j_cfg = j_load_config(
        model={**MODEL, "engine_type": "jax_tpu", "checkpoint_path": ckpt},
        tpu={"dp": 1, "tp": 1, "ep": 1, "sp": 1, "use_pallas": False,
             **SHAPES},
        scheduler={"max_queue_size": 64}, integrity={"enabled": False},
        logging={"level": "ERROR"},
    )
    cores = {"j": JEngineCore(j_cfg, devices=jax.devices()[:1]),
             "t": EngineCore(_config(ckpt))}
    out = {}
    try:
        for name, sp, evac in (("j", JSamplingParams, JEvac),
                               ("t", SamplingParams, _EvacRequest)):
            core = cores[name]
            params = sp(max_tokens=TOKENS, temperature=0.0)
            seqs = [core.submit_tokens(list(p), params)
                    for p in _prompts(7, 3)]
            for _ in range(4):
                core._tick()
            req = evac(None, "drain")
            core._evac_q.put(req)
            core._tick()
            assert req.event.is_set() and req.error is None
            moved = req.result
            assert [s.seq_id for s in moved] == [s.seq_id for s in seqs]
            assert all(s.migrate_count == 1 and not s.done_event.is_set()
                       for s in moved)
            assert core.allocator.num_used == 0
            folded = [list(s.generated_ids) for s in moved]
            assert all(0 < len(g) < TOKENS for g in folded)
            for s in moved:
                core.submit_existing(s)
            for _ in range(10_000):
                if all(s.done_event.is_set() for s in moved):
                    break
                core._tick()
            out[name] = (folded, [list(s.generated_ids) for s in moved],
                         [s.kv_dtype for s in moved])
        assert out["t"][0] == out["j"][0]
        assert out["t"][1] == out["j"][1]
        assert out["t"][2] == ["f32"] * 3
    finally:
        for core in cores.values():
            core.stop()
