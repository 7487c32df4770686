"""The decode chunk as one CUDA graph a static key.

The reference compiles ``_decode_chunk`` (vgate_tpu/runtime/
engine_core.py) with ``jax.jit``: one device program per static key
(``num_steps``, ``num_logprobs``, ``all_greedy``, and which of the
penalty, logit-bias and min-token inputs are present, at their shapes),
its steps fused by ``lax.scan``.  The port's counterpart captures the
eager chunk body once per key into a ``torch.cuda.CUDAGraph`` and
replays it, so a chunk costs the host one launch instead of a few
thousand.

What a graph needs, and where this module provides it:

* **Static buffers** (:class:`DecodeState`).  A graph reads and writes
  fixed addresses, so the chunk's inputs (tokens, positions, steps,
  slots in use, page tables, sampling parameters, penalty counts, bias
  and stop ids) and outputs (tokens, with logprobs the chosen and top
  logprobs, and with the integrity guard each step's per-slot flag
  word) live in buffers allocated once per engine, outside any
  capture.  The engine fills them with ``copy_`` on its one stream, so a
  chunk in flight still reads what it was enqueued after.
* **One memory pool** shared by every graph of an engine.  Nothing
  allocated inside a capture outlives it (every output goes to the
  static buffers), so one graph's transients may reuse another's.
* **A warm-up** before each capture: the same body run eagerly on the
  capture stream over scratch copies of the small state with every slot
  inactive (the KV writes go to trash page 0).  It runs every first-call
  path outside the capture (kernel builds, function attributes, tensor
  maps, cuBLAS workspaces) and sizes the kernels' shared workspace for
  this stream (``_build.workspace`` refuses to grow during a capture).
* **Launch counts.**  A kernel wrapper counts a launch when its Python
  code runs, which under a graph is once, at capture.  The warm-up and
  the capture count into a tally of the capturing thread
  (``_build.tallied_launches``), never into the wrappers; each graph
  keeps its capture's tally, and every replay adds it: the totals stay
  the launches that served decode steps, also while another engine of
  the process launches kernels on its own thread.
* **Several engines in one process** (data-parallel replicas,
  runtime/dp_engine.py).  Each engine captures on a capture stream of
  its own, so the kernels' scratch and cuBLAS's workspace that its
  graphs bake in are never the ones another engine's graphs replay
  over.  A capture forbids device-wide synchronization on its device
  (CUDA's rule for a device with a capturing stream), so captures on
  one card, and the device-wide calls of engine construction and
  teardown, serialize on :func:`device_lock`; and the collector is off
  while any capture of the process runs, on again when the last ends.

* **A mesh's collectives** (parallel/mesh.py).  Over NCCL (one card a
  rank) a chunk's collectives are captured with it: tp's all-reduces
  and logits' all-gather, the pipeline relay's sends, sp's all-gather
  of each layer's attention partials, the tokens' broadcast.  A gloo
  device group cannot be captured, so its chunks run eagerly.

There is no fallback: a capture or replay that fails raises, and the
engine dies as on any device error.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from vgate_tpu_torch.ops.kernels import _build


def _width(n: int) -> int:
    """A padded width for per-row id lists (bias, stop ids): the next
    power of two, so a handful of graphs cover every request mix.
    Padding entries hold an out-of-vocabulary id, which both transforms
    drop."""
    return 0 if n <= 0 else 1 << (n - 1).bit_length()


def _padded(arr: np.ndarray, fill) -> np.ndarray:
    """``arr`` [B, n] widened to ``_width(n)`` columns of ``fill``."""
    out = np.full((arr.shape[0], _width(arr.shape[1])), fill, arr.dtype)
    out[:, : arr.shape[1]] = arr
    return out


class DecodeState:
    """The decode chunk's inputs and outputs, allocated once per engine.

    ``load`` and ``load_page_tables`` fill them in place; the chunk body
    reads the inputs, writes ``out_*`` and writes the advanced tokens,
    positions, steps and counts back in place.  ``penalties``,
    ``bias_width`` and ``stop_width`` say which optional inputs the
    current members use (widths padded by :func:`_width`; 0 = absent)."""

    def __init__(self, slots: int, pages_per_seq: int, vocab: int,
                 chunk: int, logprobs_k: int, device: torch.device) -> None:
        self.device = device
        self.vocab = vocab
        B = slots

        def buf(shape, dtype, fill=0):
            return torch.full(shape, fill, dtype=dtype, device=device)

        self.tokens = buf((B,), torch.int32)
        self.positions = buf((B,), torch.int32)
        self.steps = buf((B,), torch.int32)
        self.active = buf((B,), torch.bool, False)
        self.page_tables = buf((B, pages_per_seq), torch.int32)
        self.temps = buf((B,), torch.float32)
        self.top_ps = buf((B,), torch.float32, 1.0)
        self.top_ks = buf((B,), torch.int32)
        self.seeds = buf((B,), torch.int64, -1)
        self.freq_pens = buf((B,), torch.float32)
        self.pres_pens = buf((B,), torch.float32)
        self.min_toks = buf((B,), torch.int32)
        # [B, V] generated-token counts, allocated at the first penalty
        self.counts: Optional[torch.Tensor] = None
        # by padded width: [B, w] stop ids; ([B, w] bias ids, values)
        self._stop_ids: Dict[int, torch.Tensor] = {}
        self._bias: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.penalties = False
        self.bias_width = 0
        self.stop_width = 0
        self.out_tokens = buf((chunk, B), torch.int32)
        self.out_lp = buf((chunk, B), torch.float32)
        self.out_top_ids = buf((chunk, B, logprobs_k), torch.int32)
        self.out_top_lps = buf((chunk, B, logprobs_k), torch.float32)
        # integrity.logit_guard's flag word per step and slot, written
        # when the engine runs the guard (fixed for an engine, so it is
        # no part of the key)
        self.out_flags = buf((chunk, B), torch.uint8)

    # ------------------------------------------------------------ loading

    def _put(self, dst: torch.Tensor, arr: np.ndarray) -> None:
        """``dst[...] = arr`` in place; on CUDA staged through pinned
        memory so the copy is asynchronous on the engine stream."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            dst.copy_(src.pin_memory(), non_blocking=True)
        else:
            dst.copy_(src)

    def load_page_tables(self, tables: np.ndarray) -> None:
        self._put(self.page_tables, tables)

    def load_feed(self, tokens, positions, active, page_tables) -> None:
        """What a mesh follower's chunk reads (runtime/engine_core.py
        ``follower_decode_chunk``): tokens, positions, slots in use and
        page tables, from host arrays."""
        for dst, arr in ((self.tokens, tokens), (self.positions, positions),
                         (self.active, active)):
            self._put(dst, arr)
        self.load_page_tables(page_tables)

    def load(self, tokens, positions, active, page_tables,
             rows: Dict[str, Any]) -> None:
        """Every input, from host arrays (``rows`` as
        ``EngineCore._row_host``)."""
        for dst, arr in ((self.tokens, tokens), (self.positions, positions),
                         (self.active, active), (self.temps, rows["temps"]),
                         (self.top_ps, rows["top_ps"]),
                         (self.top_ks, rows["top_ks"]),
                         (self.seeds, rows["seeds"]),
                         (self.steps, rows["steps"])):
            self._put(dst, arr)
        self.load_page_tables(page_tables)
        B = self.tokens.shape[0]
        self.penalties = rows["counts"] is not None
        if self.penalties:
            if self.counts is None:
                self.counts = torch.zeros((B, self.vocab), dtype=torch.int32,
                                          device=self.device)
            self._put(self.counts, rows["counts"])
            self._put(self.freq_pens, rows["freq_pens"])
            self._put(self.pres_pens, rows["pres_pens"])
        self.stop_width = 0
        if rows["min_tok"] is not None:
            min_toks, ids = rows["min_tok"]
            self.stop_width = _width(ids.shape[1])
            dst = self._stop_ids.get(self.stop_width)
            if dst is None:
                dst = torch.empty((B, self.stop_width), dtype=torch.int64,
                                  device=self.device)
                self._stop_ids[self.stop_width] = dst
            self._put(self.min_toks, min_toks)
            self._put(dst, _padded(ids, self.vocab))
        self.bias_width = 0
        if rows["bias"] is not None:
            ids, vals = rows["bias"]
            self.bias_width = _width(ids.shape[1])
            dst = self._bias.get(self.bias_width)
            if dst is None:
                dst = (torch.empty((B, self.bias_width), dtype=torch.int64,
                                   device=self.device),
                       torch.empty((B, self.bias_width), dtype=torch.float32,
                                   device=self.device))
                self._bias[self.bias_width] = dst
            self._put(dst[0], _padded(ids, self.vocab))
            self._put(dst[1], _padded(vals, 0))

    # ----------------------------------------------------- the chunk body

    def pen(self):
        """(counts, frequency, presence) or None."""
        if not self.penalties:
            return None
        return self.counts, self.freq_pens, self.pres_pens

    def bias(self):
        """([B, w] ids, [B, w] values) or None."""
        return self._bias[self.bias_width] if self.bias_width else None

    def min_tok(self):
        """([B] floors, [B, w] stop ids) or None."""
        if not self.stop_width:
            return None
        return self.min_toks, self._stop_ids[self.stop_width]

    def key(self, num_steps: int, all_greedy: bool, num_logprobs: int):
        """The static key of a chunk over the current inputs: the
        reference's static arguments and the shapes of its optional
        inputs."""
        return (num_steps, all_greedy, num_logprobs, self.penalties,
                self.bias_width, self.stop_width)

    def scratch(self) -> "DecodeState":
        """A copy for a warm-up run: what the body writes is cloned and
        every slot is inactive (its KV writes land on trash page 0); the
        read-only inputs are shared."""
        out = copy.copy(self)
        for name in ("tokens", "positions", "steps", "out_tokens", "out_lp",
                     "out_top_ids", "out_top_lps", "out_flags"):
            setattr(out, name, getattr(self, name).clone())
        if self.counts is not None:
            out.counts = self.counts.clone()
        out.active = torch.zeros_like(self.active)
        return out


class CapturedChunk:
    """One captured chunk and the kernel launches its capture made."""

    def __init__(self, graph: Any, launches: Dict[Callable, int]) -> None:
        self.graph = graph
        self.launches = {w: n for w, n in launches.items() if n}

    def replay(self) -> None:
        self.graph.replay()
        for wrapper, n in self.launches.items():
            _build.count_launch(wrapper, n)


_device_locks: Dict[int, "threading.RLock"] = {}
_device_locks_guard = threading.Lock()


def device_lock(device: torch.device) -> "threading.RLock":
    """The process's lock of one card: held by a capture (its warm-up
    included) and by every device-wide call an engine makes
    (``torch.cuda.synchronize``, ``empty_cache``), which CUDA forbids
    while a stream of that device captures."""
    index = device.index or 0
    with _device_locks_guard:
        lock = _device_locks.get(index)
        if lock is None:
            lock = _device_locks[index] = threading.RLock()
        return lock


_gc_guard = threading.Lock()
_gc_holds = 0
_gc_restore = False


@contextlib.contextmanager
def no_collection() -> Iterator[None]:
    """No cyclic garbage collection while the block runs on any thread
    that holds it: the collector is switched off by the first holder and
    back on (if it was on) by the last, so one capture ending can never
    turn it on inside another's."""
    global _gc_holds, _gc_restore
    with _gc_guard:
        if _gc_holds == 0:
            _gc_restore = gc.isenabled()
            gc.disable()
        _gc_holds += 1
    try:
        yield
    finally:
        with _gc_guard:
            _gc_holds -= 1
            if _gc_holds == 0 and _gc_restore:
                gc.enable()


class CudaCapture:
    """Warm-up and capture on the card: the warm-up on the engine's own
    capture stream, then ``torch.cuda.graph`` into the engine's pool with
    the engine's sampling generator registered, so each replay draws new
    noise for unseeded sampled rows.  Both hold the card's
    :func:`device_lock`."""

    def __init__(self, device: torch.device,
                 generator: torch.Generator) -> None:
        self.device = device
        # the kernels' scratch (``_build.workspace``) and cuBLAS's
        # workspace are kept per stream, and a graph bakes their
        # addresses in: a stream of its own keeps this engine's graphs
        # off every other engine's scratch
        self.stream = torch.cuda.Stream(device)
        self.generator = generator
        self.pool = torch.cuda.graph_pool_handle()

    def warmup(self, fn: Callable[[], None]) -> None:
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with device_lock(self.device), torch.cuda.stream(self.stream):
            fn()
        current.wait_stream(self.stream)

    def capture(self, fn: Callable[[], None]) -> Any:
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        with device_lock(self.device), torch.cuda.graph(
                graph, pool=self.pool, stream=self.stream,
                capture_error_mode="thread_local"):
            fn()
        return graph

    def pool_bytes(self) -> int:
        """Bytes the graphs' private pool holds on the card (from the
        allocator's snapshot)."""
        pool = tuple(self.pool)
        return sum(s["total_size"]
                   for s in torch.cuda.memory._snapshot(self.device)[
                       "segments"]
                   if tuple(s["segment_pool_id"]) == pool)


class DecodeGraphs:
    """The graph cache of one engine: :meth:`run` replays the graph of
    ``key``, capturing it at its first use (warm-up first) and keeping it
    for the engine's life.  ``capture`` is :class:`CudaCapture` on the
    card; the CPU tests hand in a stand-in with the same methods."""

    def __init__(self, capture: Any) -> None:
        self.capture = capture
        self.graphs: Dict[tuple, CapturedChunk] = {}
        self.capture_s = 0.0
        # (key, seconds) of each capture, in order
        self.capture_log: List[Tuple[tuple, float]] = []
        self.replays = 0

    def run(self, key: tuple, body: Callable[[], None],
            warmup: Callable[[], None]) -> None:
        entry = self.graphs.get(key)
        if entry is None:
            t0 = time.perf_counter()
            entry = self._capture(body, warmup)
            self.graphs[key] = entry
            seconds = time.perf_counter() - t0
            self.capture_s += seconds
            self.capture_log.append((key, seconds))
        entry.replay()
        self.replays += 1

    def _capture(self, body, warmup) -> CapturedChunk:
        # neither the warm-up nor the capture serves a decode step: their
        # launches go to this thread's tallies, the capture's is replayed
        with _build.tallied_launches():
            self.capture.warmup(warmup)
        # No cyclic garbage collection inside a capture: the finalizers
        # of what it frees can make CUDA calls on this thread that a
        # capture forbids, and the capture is then invalidated (seen on
        # the card when a collection fell inside one).  ``torch.cuda.graph``
        # collects explicitly before the capture begins.
        with _build.tallied_launches() as launches, no_collection():
            graph = self.capture.capture(body)
        return CapturedChunk(graph, launches)

    def stats(self) -> Dict[str, Any]:
        return {"captured": len(self.graphs), "capture_s": self.capture_s,
                "replays": self.replays,
                "pool_bytes": self.capture.pool_bytes()}
