"""Isolation of the PyTorch/CUDA port from JAX and the JAX package.

A fresh interpreter imports every ``vgate_tpu_torch`` module and
``chip_smoke.py`` (the script that drives the port on a card) and must
end with neither ``jax`` nor ``vgate_tpu`` — matched by exact package
name, since ``vgate_tpu_torch`` starts with ``vgate_tpu`` — loaded.
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
    ):
        assert name in report["modules"]


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
