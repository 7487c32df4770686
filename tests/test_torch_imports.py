"""Isolation of the PyTorch/CUDA port from JAX and the JAX package.

A fresh interpreter imports every ``vgate_tpu_torch`` module and
``chip_smoke.py`` (the script that drives the port on a card) and must
end with neither ``jax`` nor ``vgate_tpu`` — matched by exact package
name, since ``vgate_tpu_torch`` starts with ``vgate_tpu`` — loaded.
A second probe blocks the HTTP layer's packages and PyYAML, which the
card's machine lacks, and runs the engine path without them; a third
warms up a host-swap engine and serves a wave that swaps, with the
engine-side metric series resolved to no-op stand-ins.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, json, pkgutil, sys
import vgate_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    vgate_tpu_torch.__path__, "vgate_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(
    m for m in sys.modules
    if m in ("jax", "jaxlib", "vgate_tpu")
    or m.startswith(("jax.", "jaxlib.", "vgate_tpu."))
)
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout
    report = json.loads(out.strip().splitlines()[-1])
    assert report["bad"] == []
    for name in (
        "vgate_tpu_torch.runtime.engine_core",
        "vgate_tpu_torch.ops.kernels.paged_decode",
        "vgate_tpu_torch.ops.kernels.flash_prefill",
        "vgate_tpu_torch.ops.kernels.quant_matmul",
        "vgate_tpu_torch.ops.quant",
        "vgate_tpu_torch.ops.kv_quant",
        "vgate_tpu_torch.backends.torch_backend",
        "vgate_tpu_torch.engine",
        "vgate_tpu_torch.server.app",
        "vgate_tpu_torch.batcher",
        "vgate_tpu_torch.admission",
        "vgate_tpu_torch.runtime.journal",
    ):
        assert name in report["modules"]


# the HTTP layer's packages and PyYAML, none of which the card's machine
# has: the engine path must import without them
BLOCKED = ("aiohttp", "pydantic", "prometheus_client", "yaml")

BLOCKED_PROBE = """
import sys
for name in %r:
    sys.modules[name] = None
import vgate_tpu_torch.engine
import vgate_tpu_torch.backends.torch_backend
import vgate_tpu_torch.runtime.engine_core
import chip_smoke
from vgate_tpu_torch.lifecycle import CancelToken
CancelToken().cancel()
import asyncio
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import load_config
backend = vgate_tpu_torch.backends.torch_backend.TorchCUDABackend()
backend.load_model(load_config(
    model={"model_id": "tiny-dense", "dtype": "float32",
           "max_model_len": 64},
    device={"device": "cpu", "kv_num_pages": 32, "kv_page_size": 4,
            "max_batch_slots": 2, "prefill_buckets": [8, 16]},
))
usage = []
async def stream():
    sp = SamplingParams(max_tokens=3, min_tokens=3, temperature=0.0)
    return [p async for p in backend.stream_async("hi", sp,
                                                  on_usage=usage.append)]
asyncio.run(stream())
assert usage[0]["completion_tokens"] == 3, usage
backend.shutdown()
print("ok")
""" % (BLOCKED,)


def test_engine_path_imports_and_streams_without_the_http_packages():
    """The engine path (and the backend's stream, which feeds the
    gateway's histograms when they exist) runs with the HTTP layer's
    packages and PyYAML missing."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"


SWAP_PROBE = """
import sys
for name in %r:
    sys.modules[name] = None
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.runtime import engine_metrics
from vgate_tpu_torch.runtime.engine_core import EngineCore
assert engine_metrics._registry is None
assert engine_metrics.KV_PAGES_TOTAL is engine_metrics._NOOP
core = EngineCore(load_config(
    model={"model_id": "tiny-dense", "dtype": "float32",
           "max_model_len": 96},
    kv_cache={"host_swap_bytes": 1 << 24},
    device={"device": "cpu", "kv_num_pages": 40, "kv_page_size": 4,
            "max_batch_slots": 4, "prefill_buckets": [8, 16, 32]},
))
assert core.warmup() > 0
sp = SamplingParams(max_tokens=40, min_tokens=40, temperature=0.0)
seqs = [core.submit_tokens([7 + i, 3, 9, 4 + i, 11, 6, 2, 13 + i, 5, 8,
                            12, 10 + i], sp) for i in range(4)]
for _ in range(10_000):
    if all(s.done_event.is_set() for s in seqs):
        break
    core._tick()
assert all(s.num_output_tokens == 40 for s in seqs)
sched = core.get_stats()["scheduler"]
assert sched["swap_preempts"] == sched["preemptions"] > 0, sched
assert sched["preempt_recompute_tokens"] == 0, sched
print("ok")
""" % (BLOCKED,)


def test_swap_engine_warms_up_and_serves_without_prometheus_client():
    """The engine-side series resolve to stand-ins without
    prometheus_client: a swap-on engine warms up and serves a wave that
    preempts, swaps out and swaps back in."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", SWAP_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"


SUPERVISED_PROBE = """
import sys
for name in %r:
    sys.modules[name] = None
from vgate_tpu_torch import faults
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.backends.torch_backend import TorchCUDABackend
from vgate_tpu_torch.config import load_config
backend = TorchCUDABackend()
backend.load_model(load_config(
    model={"model_id": "tiny-dense", "dtype": "float32",
           "max_model_len": 64},
    device={"device": "cpu", "kv_num_pages": 32, "kv_page_size": 4,
            "max_batch_slots": 2, "prefill_buckets": [8, 16],
            "prefix_cache": False},
    recovery={"backoff_base_s": 0.01},
    integrity={"canary_record_on_start": True},
))
sup = backend.core
assert type(sup).__name__ == "EngineSupervisor"
assert sup.core.integrity is not None and sup._canary.expected
assert sup.warmup() > 0
sp = [SamplingParams(max_tokens=12, temperature=0.0)] * 2
clean = backend.generate(["alpha", "beta"], sp)
faults.arm("decode_step", mode="raise", times=1)
again = backend.generate(["alpha", "beta"], sp)
assert [r.token_ids for r in again] == [r.token_ids for r in clean]
assert all(r.metrics["resumed"] for r in again)
stats = backend.get_stats()
assert stats["supervisor"]["restarts"] == 1, stats["supervisor"]
# the probe fired as an injected fault, not as an ImportError of the
# HTTP layer's metrics
assert stats["supervisor"]["last_fatal"].startswith("InjectedFault"), (
    stats["supervisor"]["last_fatal"])
assert stats["supervisor"]["resumed"] == 2 and stats["supervisor"]["lost"] == 0
assert backend.serving_state() == "degraded"
assert stats["perf"]["enabled"] and stats["flight"]["enabled"]
assert stats["integrity"]["sentinel_trips"] == {}
backend.shutdown()
print("ok")
""" % (BLOCKED + ("opentelemetry",),)


def test_supervised_engine_with_integrity_serves_without_the_http_packages():
    """The default engine (supervised, integrity on, the flight and perf
    recorders on) warms up, serves, survives an injected crash by replay
    and reports its blocks with aiohttp, pydantic, PyYAML,
    prometheus_client and opentelemetry all missing (a fault firing
    counts through the engine-side stand-ins)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", SUPERVISED_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"


SPEC_PROBE = """
import sys
for name in %r:
    sys.modules[name] = None
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.backends.torch_backend import TorchCUDABackend
from vgate_tpu_torch.config import load_config
backend = TorchCUDABackend()
backend.load_model(load_config(
    model={"model_id": "tiny-dense", "dtype": "float32",
           "max_model_len": 64, "draft_model_id": "tiny-dense",
           "embedding_model_id": "tiny-encoder"},
    device={"device": "cpu", "kv_num_pages": 32, "kv_page_size": 4,
            "max_batch_slots": 2, "prefill_buckets": [8, 16],
            "speculative_k": 3, "draft_window": 16},
))
assert backend.core.warmup() > 0
out = backend.generate(["one two one two", "abc"],
                       [SamplingParams(max_tokens=10, temperature=0.0)] * 2)
assert [r.num_tokens for r in out] == [10, 10]
backend.set_spec_suspended(True)
assert backend.core.spec_suspended
backend.set_spec_suspended(False)
spec = backend.get_stats()["speculative"]
assert spec["drafter"] == "draft-model:tiny-dense" and spec["draft_calls"] > 0
vecs = backend.embed(["hello", "world"])
assert len(vecs) == 2 and len(vecs[0]) == 64
backend.shutdown()
print("ok")
""" % (BLOCKED + ("opentelemetry",),)


def test_speculative_engine_and_encoder_serve_without_the_http_packages():
    """A supervised speculative engine with a draft model warms up and
    serves, brownout L3 reaches its core, and the encoder embeds, with
    aiohttp, pydantic, PyYAML, prometheus_client and opentelemetry all
    missing."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", SPEC_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_http_layer_needs_its_packages():
    """The probe is live: with aiohttp blocked, the gateway's import
    fails."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.modules['aiohttp'] = None; "
         "import vgate_tpu_torch.server.app"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "aiohttp" in proc.stderr


def test_default_config_asks_for_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from vgate_tpu_torch.config import load_config
    from vgate_tpu_torch.runtime.engine_core import EngineCore

    cfg = load_config(model={"model_id": "tiny-dense"})
    assert cfg.device.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        EngineCore(cfg)


def test_chip_smoke_without_a_card_exits_nonzero_without_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
