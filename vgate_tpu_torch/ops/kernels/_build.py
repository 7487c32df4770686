"""Build and load the hand-written CUDA kernels (``vgate_tpu_torch/csrc``).

Each ``.cu`` source has a plain C interface and compiles with ``nvcc``
alone (no PyTorch headers, so a build takes seconds) into its own shared
library, which is loaded with ``ctypes``.  The build happens on first
use, never at import, into ``build/kernels/`` beside the package (or
``$VGT_KERNEL_BUILD_DIR``); the library name carries a hash of the
source, the shared headers (``*.cuh``) and the flags, so an edited
source or header is rebuilt.  :func:`build` starts one ``nvcc`` per
source at once.  :func:`workspace` holds the fp32 scratch that the
kernels' second launches read (split-k and split-decode partials), and
:func:`sm_count` the card's SM count that the plans size grids by.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
SOURCES = {
    "paged_decode": "paged_decode.cu",
    "flash_prefill": "flash_prefill.cu",
    "paged_multitok": "paged_multitok.cu",
    "dequant_matmul": "dequant_matmul.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> pathlib.Path:
    env = os.environ.get("VGT_KERNEL_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return CSRC.parents[1] / "build" / "kernels"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels of vgate_tpu_torch build on first use"
        )
    return path


def _lib_path(name: str) -> pathlib.Path:
    # the shared headers are part of every source's identity
    src = (CSRC / SOURCES[name]).read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh"))
    )
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"libvgt_{name}_{digest[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` process per source, all started together.  Returns
    ``{name: {"seconds": s, "cached": bool, "ptxas": text}}``; raises
    with the compiler's output when a build fails."""
    names = list(names or SOURCES)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    report: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        target = _lib_path(name)
        if target.exists():
            report[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            target,
        )
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, target)
        report[name] = {
            "seconds": time.perf_counter() - t0, "cached": False,
            "ptxas": log,
        }
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return report


def ptxas_entries(log: str) -> list:
    """``(entry, line)`` for each register and spill line of a ``ptxas
    -v`` log, under the (mangled) entry function it belongs to."""
    out, entry = [], "?"
    for line in log.splitlines():
        named = re.search(
            r"(?:Compiling entry function|Function properties for) "
            r"'?([\w$.]+)'?", line)
        if named:
            entry = named.group(1)
        elif "registers" in line or "spill" in line.lower():
            out.append((entry, line.strip()))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA ``device`` (the plans' grid
    sizes follow it)."""
    return _sm_count(device.index or 0)


# One fp32 scratch buffer per (device, stream), kept across calls and grown
# when a call needs more.  The calls on one stream run in order, so the
# kernels that share it (K4/K5's split-k partials, K1's and K6's chunk
# partials) never hold it at once.
_workspaces: Dict[Tuple[int, int], "torch.Tensor"] = {}


def workspace(device, stream: int, size: int):
    """At least ``size`` fp32 values of scratch on ``device`` for work on
    ``stream`` (the stream's handle).

    A CUDA graph bakes the buffer's address into every node that uses it,
    so it must not grow while a graph is captured: the old block would go
    back to the allocator while earlier nodes (of this graph or of one
    captured before) still address it.  A capture is preceded by an eager
    run of the same work on the same stream, which sizes it."""
    import torch

    key = (device.index or 0, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < size:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"kernel workspace on stream {stream:#x} must grow to {size} "
                f"values during a CUDA graph capture; run the captured work "
                "eagerly on the capture stream first"
            )
        ws = torch.empty(size, dtype=torch.float32, device=device)
        _workspaces[key] = ws
    return ws
