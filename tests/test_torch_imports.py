"""Isolation of the PyTorch/CUDA port from JAX and the JAX package.

A fresh interpreter imports every ``vgate_tpu_torch`` module and
``chip_smoke.py`` (the script that drives the port on a card) and must
end with neither ``jax`` nor ``vgate_tpu`` — matched by exact package
name, since ``vgate_tpu_torch`` starts with ``vgate_tpu`` — loaded.
A second probe blocks the HTTP layer's packages and PyYAML, which the
card's machine lacks, and runs the engine path without them.
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
