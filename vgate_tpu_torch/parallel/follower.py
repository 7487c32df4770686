"""A mesh follower rank: ``python -m vgate_tpu_torch.parallel.follower``.

Rank 0 (runtime/engine_core.py) spawns ranks 1..n-1 of its ``pp x ep x
sp x tp`` mesh (parallel/mesh.py ``build_mesh``), each with the resolved
config as JSON, its rank, the port of rank 0's store and every rank's
device.  A follower:

* joins the control and device groups;
* loads or initializes the same tree as a one-rank engine (seed 0 or
  the checkpoint) and keeps its own shard (parallel/sharding.py: its
  heads and FFN channels, its experts, or as a pipeline stage its
  layers and no embedding or head; under sp the whole tree), a leaf (an
  expert leaf, a layer)
  at a time, each quantized leaf quantized whole first, as rank 0 does;
  W8A8 (``device.int8_native``) lays its shard out as rank 0 does;
* records its shard's checksum baseline (``integrity.enabled``);
* sizes its pools ``[L, KV/tp, P, ps, hd]`` with rank 0 (the minimum
  over the ranks; under sp its shard ``[L, KV, P/sp, ps, hd]`` of the
  pages);
* then loops on the control group, running the program rank 0 names on
  the host inputs rank 0 sends:

  - ``prefill``, ``suffix`` (prefix hits, copy-on-write hits and chunked
    passes) and ``cow``: the prompt passes and the page copy on its own
    pools; the logits are all-gathered with rank 0's and dropped.  A
    pipeline stage runs the relay's stage body instead (parallel/
    pipeline.py): it receives the activations from the previous stage,
    runs its layers and sends them on; an sp rank runs its rows of a
    cold prompt through the ring and its part of every suffix pass's
    attention;
  - ``decode_state`` and ``page_tables``: its copy of the decode
    chunk's feed (a stage keeps its own positions and active mask);
    ``decode``: the chunk's steps (``follower_decode_chunk``), each
    step's tokens from rank 0's broadcast, or a stage's activations
    from the previous stage, as a graph replay where rank 0 replays one
    (NCCL);
  - ``sweep``: the checksum check of the leaves rank 0 sweeps that it
    holds, replied;
  - ``stats`` and ``reset_launches``: its kernel launch counts (which
    live in this process), memory and counters, as a pod worker's;
  - ``rebuild``: free its pool and graphs and build them again, with
    its shard kept (or reloaded); ``stop``: leave.

It never samples: rank 0 samples and broadcasts each step's tokens, so
a mesh's streams are those of one engine with the same seed.  It
imports neither JAX nor anything of the HTTP layer.  An error ends the
process; rank 0 sees a closed peer, and its supervisor rebuilds the
group.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import logging
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from vgate_tpu_torch import integrity
from vgate_tpu_torch.config import VGTConfig, config_from_dict, set_config
from vgate_tpu_torch.logging_config import get_logger
from vgate_tpu_torch.models.decoder import (
    prefill_forward,
    prefill_suffix_forward,
)
from vgate_tpu_torch.models.specs import spec_for_model_id
from vgate_tpu_torch.ops.kernels import _build, launch_counts
from vgate_tpu_torch.ops.quant import int8_native_layout
from vgate_tpu_torch.parallel.mesh import Mesh, join_mesh
from vgate_tpu_torch.parallel.sharding import local_spec
from vgate_tpu_torch.runtime.decode_graph import (
    CudaCapture,
    DecodeGraphs,
    DecodeState,
)
from vgate_tpu_torch.runtime.engine_core import (
    _DTYPES,
    LOGPROBS_K,
    _cow_copy_pages,
    follower_decode_chunk,
    kv_layout,
)
from vgate_tpu_torch.runtime.kv_cache import make_kv_buffers
from vgate_tpu_torch.runtime.weights import load_or_init_params

logger = get_logger(__name__)


def _nbytes(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


class Follower:
    """One follower rank's shard, pools and program loop."""

    def __init__(self, config: VGTConfig, mesh: Mesh) -> None:
        self.config = config
        self.mesh = mesh
        self.device = mesh.device
        self.cuda = self.device.type == "cuda"
        spec = spec_for_model_id(config.model.model_id)
        if config.device.decode_block_slots > 1:
            spec = dataclasses.replace(
                spec, decode_block_slots=config.device.decode_block_slots
            )
        if config.model.quantization in ("int8", "int4"):
            spec = dataclasses.replace(
                spec, int8_native=bool(config.device.int8_native)
            )
        self.model_spec = spec
        self.spec = local_spec(spec, mesh.tp, mesh)
        self.dtype = _DTYPES[config.model.dtype]
        self.params: Optional[Dict[str, Any]] = None
        self.verifier: Optional[integrity.WeightVerifier] = None
        self.steps = 0
        self.prompt_passes = 0
        self.boot()

    # -------------------------------------------------------------- boot

    def boot(self) -> None:
        """Weights (unless kept), the checksum baseline, then the pools
        sized with rank 0 (the same order as rank 0's EngineCore)."""
        cfg = self.config
        if self.params is None:
            self.params = load_or_init_params(
                self.model_spec, cfg.model.checkpoint_path, self.device,
                self.dtype, quantization=cfg.model.quantization,
                shard=self.mesh,
            )
            if self.spec.int8_native and self.cuda:
                # as rank 0 lays its shard out (ops/quant.py k_major)
                self.params = int8_native_layout(self.params)
            if self.cuda:
                torch.cuda.synchronize(self.device)
        icfg = cfg.integrity
        self.verifier = None
        if icfg.enabled and icfg.sweep_enabled:
            self.verifier = integrity.WeightVerifier(icfg)
            self.verifier.record(self.params)
        self.geometry, pool_dtype = kv_layout(
            cfg, self.spec, self.device, self.dtype, self.mesh
        )
        self.k_pages, self.v_pages = make_kv_buffers(
            self.geometry, pool_dtype, self.device
        )
        self.state = DecodeState(
            cfg.device.max_batch_slots, self.geometry.pages_per_seq,
            self.spec.vocab_size, max(1, cfg.device.decode_chunk),
            LOGPROBS_K, self.device,
        )
        # the follower samples nothing; a capture still registers a
        # generator
        self.graphs = DecodeGraphs(CudaCapture(
            self.device, torch.Generator(device=self.device)
        )) if self.cuda else None
        logger.info("mesh follower ready", extra={"extra_data": {
            "rank": self.mesh.rank, "pages": self.geometry.num_pages}})

    def release(self) -> None:
        """Free the pools, the decode feed and the graphs (a rebuild, or
        the end), once the work queued on them has run."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self.k_pages = self.v_pages = None
        self.state = None
        self.graphs = None
        if self.cuda:
            stream = torch.cuda.current_stream(self.device).cuda_stream
            _build.release_workspace(self.device, stream)
            torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- programs

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def op_prefill(self, tokens, seq_lens, page_tables) -> None:
        prefill_forward(
            self.params, self.spec, self._dev(tokens), self._dev(seq_lens),
            self.k_pages, self.v_pages, self._dev(page_tables),
        )
        self.prompt_passes += 1

    def op_suffix(self, tokens, prefix_lens, suffix_lens, suffix_pt,
                  ctx_pt, unaligned) -> None:
        prefill_suffix_forward(
            self.params, self.spec, self._dev(tokens),
            self._dev(prefix_lens), self._dev(suffix_lens), self.k_pages,
            self.v_pages, self._dev(suffix_pt), self._dev(ctx_pt),
            unaligned=unaligned,
        )
        self.prompt_passes += 1

    def op_cow(self, page) -> None:
        _cow_copy_pages(self.k_pages, self.v_pages, *page)

    def op_decode_state(self, tokens, positions, active, page_tables) -> None:
        self.state.load_feed(tokens, positions, active, page_tables)

    def op_page_tables(self, page_tables) -> None:
        self.state.load_page_tables(page_tables)

    def op_decode(self, key, num_steps, max_position, graphs) -> None:
        def body(st: DecodeState = self.state) -> None:
            follower_decode_chunk(
                self.params, self.spec, st, self.k_pages, self.v_pages,
                num_steps, max_position,
            )

        if graphs:
            self.graphs.run(key, body, lambda: body(self.state.scratch()))
        else:
            body()
        self.steps += num_steps

    def op_sweep(self, paths: List[str]) -> None:
        mismatch = None
        if self.verifier is not None:
            mismatch = self.verifier.check_paths(self.params, paths)
        self.mesh.gather(mismatch)

    def op_stats(self) -> None:
        self.mesh.gather(self.stats())

    def op_reset_launches(self) -> None:
        launch_counts(reset=True)

    def op_rebuild(self, reload: bool) -> None:
        self.release()
        if reload:
            self.params = None
        self.boot()

    def stats(self) -> Dict[str, Any]:
        """This rank's counters, kernel launches (they live in this
        process's wrappers) and memory."""
        return {
            "rank": self.mesh.rank,
            "steps": self.steps,
            "prompt_passes": self.prompt_passes,
            "kernel_launches": launch_counts(),
            "decode_graphs": None if self.graphs is None
            else self.graphs.stats(),
            "memory": {
                "weights_bytes": _nbytes(self.params),
                "leaves": sorted(self.params),
                "pool_pages": self.geometry.num_pages,
                # inactive slots and padding write nothing to trash page
                # 0 (ops/kv_quant.py kv_write)
                "trash_page_zero": not (self.k_pages[:, :, 0].any()
                                        or self.v_pages[:, :, 0].any()),
                "pool_bytes": _nbytes([self.k_pages, self.v_pages]),
                "peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                               if self.cuda else None),
            },
        }

    def serve(self) -> None:
        """Run rank 0's programs until ``stop``, then free the pools and
        graphs (a graph holds the NCCL communicator it captured)."""
        while True:
            msg = self.mesh.recv()
            op = msg.pop("op")
            if op == "stop":
                self.release()
                gc.collect()
                return
            getattr(self, "op_" + op)(**msg)


def _watch_parent(ppid: int) -> None:
    """Leave if rank 0's process goes away."""
    while os.getppid() == ppid:
        time.sleep(0.5)
    os._exit(1)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="vgate-tpu PyTorch mesh follower rank"
    )
    parser.add_argument("--config", required=True,
                        help="rank 0's resolved config, JSON")
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--port", type=int, required=True,
                        help="rank 0's store, on localhost")
    parser.add_argument("--devices", required=True,
                        help="every rank's device, comma-separated")
    args = parser.parse_args(argv)
    threading.Thread(target=_watch_parent, args=(os.getppid(),),
                     daemon=True, name="vgt-tp-parent").start()
    with open(args.config) as fh:
        config = config_from_dict(json.load(fh))
    set_config(config)
    logging.basicConfig(
        level=getattr(logging, config.logging.level.upper(), logging.INFO),
        format=f"%(asctime)s mesh-rank[{args.rank}] %(levelname)s %(name)s: "
               "%(message)s",
        stream=sys.stderr,
    )
    mesh = join_mesh(config, args.devices.split(","), args.rank, args.port)
    Follower(config, mesh).serve()
    mesh.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
