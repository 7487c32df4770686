"""The engine core: a device-owning continuous-batching loop (main path).

The PyTorch counterpart of vgate_tpu/runtime/engine_core.py on its main
path — batched, bucketed prompt passes and pipelined decode chunks:

* One **engine thread** owns the device.  Each tick it admits every
  waiting prompt it can (same-bucket prompts stacked into one prompt
  pass, batch padded to a power of two, padding rows writing trash page
  0), reads all first tokens back in one transfer, then keeps up to
  ``device.decode_pipeline`` decode chunks of up to
  ``device.decode_chunk`` steps in flight.
* A decode chunk runs its steps back to back on the device with **no
  host sync inside the chunk**; its tokens come back through one
  ``non_blocking`` copy into pinned host memory plus a CUDA event, and
  the host blocks only on the OLDEST chunk's event, so host-side token
  processing overlaps the next chunk's device work.  EOS and length
  stops are detected at readback; overshoot steps are discarded and
  their KV writes land in horizon pages the scheduler reserved.
* On the card a decode chunk is the **replay of one CUDA graph** per
  static key, as the reference runs it as one compiled program per key
  (runtime/decode_graph.py): the chunk body reads and writes static
  buffers allocated once per engine, and each graph is captured at its
  first use and kept.  On the CPU the same body runs eagerly.
* **Logprobs**: a pass or chunk where any row asks for them also
  returns each row's chosen logprob and its top ``LOGPROBS_K`` ids and
  logprobs (the log-softmax after penalties, bias and min-token
  suppression), read back with the tokens.
* The KV pools are updated IN PLACE by every program (the reference
  donates them through its jitted calls).  Every writer and reader runs
  on the engine thread's one stream, so stream order is the only
  ordering relied on.  Tokens/positions stay on the device between
  chunks and are re-uploaded only when slot membership changes.
* **Prefix cache** (on by default, as in the reference): the radix tree
  (runtime/radix_cache.py) shares full KV pages across requests, copies
  the shared head of a diverging page (copy-on-write) and indexes a
  finished sequence's generated tokens; a hit prefills only its suffix
  through the multi-token kernel (K3).  **Chunked prefill** runs a
  prompt longer than ``device.prefill_chunk`` as serial suffix passes.
* **Quantized serving**: ``model.quantization`` (int8/int4) quantizes
  the weights at load, and every projection then runs the dequant
  matmuls (K4/K5); ``kv_cache.dtype: int8`` makes the pools int8
  ``QuantPages`` (quantized on write, read by the int8 modes of K1/K3),
  ~1.97x the bf16 page count for one memory budget.
* **Blocked decode**: ``device.decode_block_slots > 1`` is threaded onto
  the spec, and decode attention then runs K6 (that many slots per CTA)
  instead of K1.

* **Serving surface**: ``abort`` / ``abort_in_flight`` (cancel one
  sequence, or every waiting and running one, at the next tick),
  ``pressure_signals`` for the gateway's admission and brownout,
  ``set_prefix_insert_suspended`` (brownout L4), ``device_health``.
  Stream callbacks run on the engine thread inside readback, so they
  must not block or touch the device (backends/torch_backend.py only
  hands each token to its event loop).
* **Host KV swap** (``kv_cache.host_swap_bytes`` > 0): preemption parks
  the victim's pages in host RAM (pinned on the card) and re-admission
  scatters them back into the pools in place, with zero recompute;
  radix eviction demotes warm prefixes there (runtime/kv_swap.py,
  ``_DeviceSwapExecutor``).
* **Warm-up** (``warmup``): the reference's start-up walk, which on the
  card captures the common decode graphs before the first request.
* **Metrics**: the engine-side Prometheus series, set on the host side
  of each readback (runtime/engine_metrics.py), never inside a captured
  decode body.

Not ported yet (the config refuses them): speculative decoding,
multi-device meshes.  The supervisor, integrity checks and flight
recorder come with later slices.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence as Seq

import numpy as np
import torch

from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import (
    NotPortedError,
    VGTConfig,
    get_config,
)
from vgate_tpu_torch.errors import DeadlineExceededError, EngineRecoveringError
from vgate_tpu_torch.logging_config import get_logger
from vgate_tpu_torch.models.decoder import (
    decode_forward,
    prefill_forward,
    prefill_suffix_forward,
)
from vgate_tpu_torch.models.specs import ModelSpec, spec_for_model_id
from vgate_tpu_torch.ops.kernels.paged_multitok import check_engine_page_size
from vgate_tpu_torch.ops.kv_quant import (
    SCALE_BYTES,
    copy_page_prefix,
    dtype_short_name,
    is_quantized,
)
from vgate_tpu_torch.ops.sampling import (
    apply_logit_bias,
    apply_penalties,
    sample_tokens,
    sample_tokens_with_logprobs,
    suppress_stop_tokens,
)
from vgate_tpu_torch.runtime.decode_graph import (
    CudaCapture,
    DecodeGraphs,
    DecodeState,
    _width,
)
from vgate_tpu_torch.runtime import engine_metrics as metrics
from vgate_tpu_torch.runtime.kv_cache import (
    KVGeometry,
    PageAllocator,
    auto_num_pages,
    make_kv_buffers,
)
from vgate_tpu_torch.runtime.kv_swap import KVSwapManager
from vgate_tpu_torch.runtime.radix_cache import RadixCache
from vgate_tpu_torch.runtime.scheduler import (
    PrefillPlan,
    Scheduler,
    SwapInPlan,
)
from vgate_tpu_torch.runtime.sequence import Sequence, SeqStatus
from vgate_tpu_torch.runtime.tokenizer import get_tokenizer
from vgate_tpu_torch.runtime.weights import (
    load_or_init_params,
    quantize_params,
)
from vgate_tpu_torch.utils.math import bucket_for, cdiv

logger = get_logger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# top alternatives computed per position when a request asks for
# logprobs (a request's ``top_logprobs`` is clamped to this)
LOGPROBS_K = 8


def resolve_device(name: str) -> torch.device:
    """The torch device the config names.  ``cuda`` without a GPU raises:
    the port never falls back to the CPU on its own."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() "
                "is false; pass device='cpu' explicitly to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}")
    return dev


def _logit_transforms(logits, steps, pen, min_tok, bias):
    """Penalties, logit bias and min-token stop suppression, each only
    when some row of the batch asks for it (``None`` otherwise)."""
    if pen is not None:
        logits = apply_penalties(logits, *pen)
    if bias is not None:
        logits = apply_logit_bias(logits, *bias)
    if min_tok is not None:
        logits = suppress_stop_tokens(logits, steps, *min_tok)
    return logits


def _first_tokens(logits, generator, sampling: Dict[str, Any],
                  num_logprobs: int = 0):
    """Sample each prompt's first token from its last-token logits, with
    the rows' penalties, logit bias and min-token floors (``sampling`` is
    ``EngineCore._group_sampling``).  Returns ([B] int32 on the device, the
    logprob triple ``(chosen [B], top ids [B, K], top lps [B, K])`` when
    ``num_logprobs`` > 0, else None)."""
    pen = None
    if sampling["counts"] is not None:
        pen = (sampling["counts"], sampling["freq_pens"],
               sampling["pres_pens"])
    logits = _logit_transforms(
        logits, sampling["steps"], pen, sampling["min_tok"], sampling["bias"]
    )
    args = (logits, sampling["temps"], sampling["top_ps"],
            sampling["top_ks"])
    kw = dict(generator=generator, seeds=sampling["seeds"],
              steps=sampling["steps"])
    if num_logprobs > 0:
        tokens, *lp = sample_tokens_with_logprobs(
            *args, **kw, num_top=num_logprobs
        )
        return tokens, tuple(lp)
    return sample_tokens(*args, **kw), None


def _prefill_step(
    params, spec: ModelSpec, tokens, seq_lens, k_pages, v_pages,
    page_tables, generator, sampling: Dict[str, Any], num_logprobs: int = 0,
):
    """Prompt pass with fused first-token sampling: returns the [B] int32
    first tokens (on the device) and their logprobs (``_first_tokens``);
    the pools are written in place."""
    logits = prefill_forward(
        params, spec, tokens, seq_lens, k_pages, v_pages, page_tables
    )
    return _first_tokens(logits, generator, sampling, num_logprobs)


def _suffix_prefill_step(
    params, spec: ModelSpec, tokens, prefix_lens, suffix_lens, k_pages,
    v_pages, suffix_page_tables, ctx_page_tables, generator,
    sampling: Dict[str, Any], unaligned: bool = False,
    num_logprobs: int = 0,
):
    """Prompt pass of the uncached suffix of a prefix-cache hit (models/
    decoder.py ``prefill_suffix_forward``) with fused first-token
    sampling, returning as ``_prefill_step``.  ``unaligned`` is the
    copy-on-write variant: prefix_lens may fall mid-page and the KV
    write becomes a per-token scatter."""
    logits = prefill_suffix_forward(
        params, spec, tokens, prefix_lens, suffix_lens, k_pages, v_pages,
        suffix_page_tables, ctx_page_tables, unaligned=unaligned,
    )
    return _first_tokens(logits, generator, sampling, num_logprobs)


def _suffix_key(bucket, B, ctx_pages, has_pen, mt_width, num_lp, lb_width,
                unaligned=False) -> tuple:
    """The reference's static key of one suffix pass shape, shared by
    the batched suffix groups and the chunked passes."""
    return ("suffix", bucket, B, ctx_pages, has_pen, mt_width, num_lp,
            lb_width, unaligned)


def _cow_copy_pages(k_pages, v_pages, src: int, dst: int, upto: int):
    """Copy-on-write page copy (runtime/radix_cache.py): the first
    ``upto`` token slots of page ``src`` into page ``dst`` across every
    layer and head (with their scales, for int8 pools), in place on the
    engine stream, so a sequence diverging mid-page gets the shared
    head's KV without recomputing it.
    Stream order puts the copy after every earlier writer of ``src``
    and before the suffix pass that writes the rest of ``dst``."""
    copy_page_prefix(k_pages, src, dst, upto)
    copy_page_prefix(v_pages, src, dst, upto)


# pages moved per gather or scatter when swapping KV to or from host RAM
# (runtime/kv_swap.py), as the reference's SWAP_CHUNK_PAGES: here it
# bounds the device staging a swap allocates (eager torch has no fixed
# program shape, so short runs need no padding)
SWAP_CHUNK_PAGES = 16


def _pool_tensors(k_pages, v_pages) -> List[torch.Tensor]:
    """Every tensor of the K and V pools: the data, and for int8
    ``QuantPages`` also the scale pools (the data's shape minus hd),
    each with the page axis at 2."""
    out = []
    for pool in (k_pages, v_pages):
        out += [pool.data, pool.scale] if is_quantized(pool) else [pool]
    return out


def _gather_swap_pages(k_pages, v_pages, idx) -> List[torch.Tensor]:
    """Device half of a swap-out: the page slices ``idx`` of every pool
    tensor (``_pool_tensors`` order), as new tensors on the pools'
    device.  The pools are only read."""
    return [t.index_select(2, idx) for t in _pool_tensors(k_pages, v_pages)]


def _scatter_swap_pages(k_pages, v_pages, idx, parts) -> None:
    """Device half of a swap-in: ``parts`` (``_gather_swap_pages``'
    layout, on the pools' device) into pages ``idx``, IN PLACE.  The
    pools keep their storage: the decode graphs captured its address,
    so a rebound pool would leave every replay reading stale memory."""
    for t, part in zip(_pool_tensors(k_pages, v_pages), parts, strict=True):
        t.index_copy_(2, idx, part)


class _DeviceSwapExecutor:
    """The device half of the host swap tier (runtime/kv_swap.py): the
    manager stays host-side policy, and every device touch happens here,
    on the engine thread, at tick boundaries.

    A payload is a list of chunks of up to ``SWAP_CHUNK_PAGES`` pages,
    each the gathered tensors of ``_pool_tensors``; on the card they are
    pinned host tensors, on the CPU plain ones.  A failed pinned
    allocation or copy raises: there is no path through pageable memory."""

    def __init__(self, core: Any) -> None:
        self._core = core

    def _index(self, pages: List[int]) -> torch.Tensor:
        """The page ids on the pools' device.  On the card they are
        staged through pinned memory, so the upload never waits for the
        chunks in flight."""
        idx = torch.tensor(pages, dtype=torch.int64)
        dev = self._core.device
        if dev.type != "cuda":
            return idx
        return idx.pin_memory().to(dev, non_blocking=True)

    def read_pages(self, pages: List[int]) -> list:
        """Swap-out: a blocking device-to-host copy of ``pages``, as the
        reference's ``jax.device_get``.  The gathers are enqueued on the
        engine stream, after every chunk in flight that wrote these
        pages, and the host waits for the last copy."""
        core = self._core
        cuda = core.device.type == "cuda"
        chunks = []
        for i in range(0, len(pages), SWAP_CHUNK_PAGES):
            idx = self._index(pages[i : i + SWAP_CHUNK_PAGES])
            parts = _gather_swap_pages(core.k_pages, core.v_pages, idx)
            if cuda:
                host = []
                for part in parts:
                    buf = torch.empty(part.shape, dtype=part.dtype,
                                      pin_memory=True)
                    buf.copy_(part, non_blocking=True)
                    host.append(buf)
                parts = host
            chunks.append(parts)
        if cuda:
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        return chunks

    def write_pages(self, pages: List[int], payload: list) -> None:
        """Swap-in: each chunk's host-to-device copies, then its scatter
        into ``pages``, enqueued on the engine stream before the next
        decode chunk; the host does not wait.  The payload may be freed
        as soon as this returns: its pinned blocks come from PyTorch's
        caching host allocator, which records the copy's event and hands
        a block out again only after that event has completed."""
        core = self._core
        cuda = core.device.type == "cuda"
        starts = range(0, len(pages), SWAP_CHUNK_PAGES)
        if len(payload) != len(starts) or sum(
            part[0].shape[2] for part in payload
        ) != len(pages):
            raise ValueError(
                f"swap payload of {len(payload)} chunks does not fit "
                f"{len(pages)} pages"
            )
        for i, parts in zip(starts, payload):
            idx = self._index(pages[i : i + SWAP_CHUNK_PAGES])
            if cuda:
                parts = [t.to(core.device, non_blocking=True)
                         for t in parts]
            _scatter_swap_pages(core.k_pages, core.v_pages, idx, parts)


def _decode_chunk(
    params, spec: ModelSpec, state: DecodeState, k_pages, v_pages,
    generator, num_steps: int, max_position: int, all_greedy: bool,
    num_logprobs: int = 0,
) -> None:
    """``num_steps`` decode steps back to back on the device, without a
    host sync: the body the reference fuses with ``lax.scan``, and the
    body a CUDA graph captures (runtime/decode_graph.py).  It reads only
    ``state``'s static buffers and writes only to them: the sampled
    tokens to ``state.out_tokens[:num_steps]`` (with ``num_logprobs``
    also the chosen logprobs and the top ids and logprobs to
    ``state.out_lp`` / ``out_top_ids`` / ``out_top_lps``), the counts in
    place each step, and the advanced tokens, positions and steps at the
    end.  The pools are written in place."""
    tokens, positions, steps = state.tokens, state.positions, state.steps
    active = state.active
    act = active.to(positions.dtype)
    pen, bias, min_tok = state.pen(), state.bias(), state.min_tok()
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    for i in range(num_steps):
        logits = decode_forward(
            params, spec, tokens, positions, k_pages, v_pages,
            state.page_tables, active=active,
        )
        logits = _logit_transforms(logits, steps, pen, min_tok, bias)
        args = (logits, state.temps, state.top_ps, state.top_ks)
        kw = dict(generator=generator, seeds=state.seeds, steps=steps)
        if num_logprobs > 0:
            tokens, lp, top_ids, top_lps = sample_tokens_with_logprobs(
                *args, **kw, num_top=num_logprobs
            )
            state.out_lp[i].copy_(lp)
            state.out_top_ids[i].copy_(top_ids)
            state.out_top_lps[i].copy_(top_lps)
        else:
            tokens = sample_tokens(*args, **kw, all_greedy=all_greedy)
        state.out_tokens[i].copy_(tokens)
        positions = positions + act
        steps = steps + act
        if pen is not None:
            pen[0].index_put_(
                (rows, tokens.long()), act.to(pen[0].dtype), accumulate=True
            )
        # overshoot steps (the chunk is sized by the LONGEST remaining
        # budget) must stay in bounds: seq_len = position + 1 drives the
        # decode kernel's page loop, which must not run past the table
        positions = torch.clamp(positions, max=max_position)
    state.tokens.copy_(tokens)
    state.positions.copy_(positions)
    state.steps.copy_(steps)


class _Readback:
    """Device->host copies in flight: pinned host buffers filled by
    ``non_blocking`` copies on the engine stream, plus the event after
    them.  ``result()`` blocks only until those copies are done."""

    def __init__(self, *dev_tensors: torch.Tensor) -> None:
        cuda = dev_tensors[0].device.type == "cuda"
        self.host = []
        for t in dev_tensors:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
            host.copy_(t, non_blocking=cuda)
            self.host.append(host)
        self.event = None
        if cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def result(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


class EngineCore:
    """Owns the parameters, the KV pools and the engine thread."""

    def __init__(
        self,
        config: Optional[VGTConfig] = None,
        spec: Optional[ModelSpec] = None,
        params: Optional[Dict[str, Any]] = None,
        decode_graphs: Optional[bool] = None,
    ) -> None:
        """``decode_graphs`` (default: on for a CUDA device) runs each
        decode chunk as the replay of a captured CUDA graph
        (runtime/decode_graph.py).  ``False`` on the card runs the same
        chunk body eagerly, for comparisons with the graphs; ``True`` on
        the CPU raises."""
        self.config = config or get_config()
        self.spec = spec or spec_for_model_id(self.config.model.model_id)
        dcfg = self.config.device
        if dcfg.decode_block_slots > 1:
            # decode attention through K6, threaded on the spec as the
            # reference does (models/decoder.py decode_forward reads it)
            self.spec = dataclasses.replace(
                self.spec, decode_block_slots=dcfg.decode_block_slots
            )
        self.device = resolve_device(dcfg.device)
        if decode_graphs is None:
            decode_graphs = self.device.type == "cuda"
        if decode_graphs and self.device.type != "cuda":
            raise ValueError(
                f"decode_graphs=True needs a CUDA device, not {self.device}"
            )
        self.decode_graphs = decode_graphs
        self.dtype = _DTYPES[self.config.model.dtype]
        if self.device.type == "cuda" and self.dtype != torch.bfloat16:
            raise NotPortedError(
                f"model.dtype={self.config.model.dtype} on CUDA: the "
                "flash-prefill kernel takes bf16 (ROADMAP queue 2, K2)"
            )
        # a page size K3 refuses would fail at the first hit or chunk
        check_engine_page_size(
            self.device.type, dcfg.kv_page_size, self.spec.head_dim,
            self.config.kv_cache.dtype == "int8", dcfg.prefix_cache.enabled,
            dcfg.prefill_chunk,
        )
        self._stop_ids = frozenset(self.spec.extra_stop_ids)
        self.tokenizer = get_tokenizer(
            self.spec,
            self.config.model.tokenizer_path
            or self.config.model.checkpoint_path,
        )

        load_start = time.perf_counter()
        if params is None:
            params = load_or_init_params(
                self.spec, self.config.model.checkpoint_path, self.device,
                self.dtype,
            )
        if self.config.model.quantization:
            params = quantize_params(
                params, self.spec, self.config.model.quantization
            )
        self.params = params
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.load_time_s = time.perf_counter() - load_start

        # what the pages hold (kv_cache.dtype): int8 halves the page data
        # and adds one bf16 scale per (page, head, slot), so one memory
        # budget holds ~2x the bf16 page count
        kv_mode = self.config.kv_cache.dtype
        kv_quant = kv_mode == "int8"
        if kv_quant:
            kv_pool_dtype = torch.int8
        elif kv_mode == "bf16":
            kv_pool_dtype = torch.bfloat16
        else:  # auto: the model dtype
            kv_pool_dtype = self.dtype
        kv_bytes = kv_pool_dtype.itemsize
        kv_scale_bytes = SCALE_BYTES if kv_quant else 0
        ps = dcfg.kv_page_size
        pages_per_seq = cdiv(self.config.model.max_model_len, ps)
        # more pages than every slot's full context can never be used
        max_useful = dcfg.max_batch_slots * pages_per_seq + 1
        num_pages = dcfg.kv_num_pages or min(
            max_useful,
            auto_num_pages(
                self.spec, ps, dcfg.hbm_utilization, self.device,
                dtype_bytes=kv_bytes, scale_bytes=kv_scale_bytes,
            ),
        )
        self.geometry = KVGeometry(
            num_layers=self.spec.num_layers,
            num_pages=num_pages,
            page_size=ps,
            kv_heads=self.spec.num_kv_heads,
            head_dim=self.spec.head_dim,
            max_model_len=self.config.model.max_model_len,
            dtype_bytes=kv_bytes,
            scale_bytes=kv_scale_bytes,
            kv_dtype=dtype_short_name(kv_pool_dtype),
        )
        self.k_pages, self.v_pages = make_kv_buffers(
            self.geometry, kv_pool_dtype, self.device
        )
        self.allocator = PageAllocator(num_pages)
        self.allocator.quantized = kv_quant
        for name in ("bf16", "f32", "f16", "int8"):
            metrics.KV_DTYPE.labels(dtype=name).set(
                1 if name == self.geometry.kv_dtype else 0
            )
        self.max_slots = dcfg.max_batch_slots
        # radix-tree prefix index: page-granular sharing with COW partial
        # pages; the tree registers itself as the allocator's reclaimer
        # so cached pages stay allocatable.  radix=False keeps the
        # scheduler's flat whole-page hash chain.
        pc = dcfg.prefix_cache
        self.radix_cache: Optional[RadixCache] = None
        if pc.enabled and pc.radix:
            self.radix_cache = RadixCache(
                self.allocator, ps, min_share_pages=pc.min_share_pages,
                cow=pc.cow, cow_min_tokens=pc.cow_min_tokens,
            )
            self.allocator.set_reclaimer(self.radix_cache)
        # host-RAM KV swap tier (runtime/kv_swap.py): a budgeted host
        # pool under the paged allocator.  Preemption parks the victim's
        # pages there instead of recomputing them, and radix eviction
        # demotes warm prefixes into it.  0 = off keeps the engine as
        # before; the device half is _DeviceSwapExecutor.
        self.kv_swap: Optional[KVSwapManager] = None
        host_swap_bytes = int(self.config.kv_cache.host_swap_bytes)
        if host_swap_bytes > 0:
            self.kv_swap = KVSwapManager(
                budget_bytes=host_swap_bytes,
                page_bytes=self.geometry.page_bytes,
                executor=_DeviceSwapExecutor(self),
            )
            if self.radix_cache is not None:
                self.radix_cache.attach_swap(self.kv_swap)
        self.scheduler = Scheduler(
            allocator=self.allocator,
            max_slots=self.max_slots,
            page_size=ps,
            prefill_buckets=dcfg.prefill_buckets,
            max_model_len=self.config.model.max_model_len,
            max_queue_size=self.config.scheduler.max_queue_size,
            preempt_on_oom=self.config.scheduler.preempt_on_oom,
            admission_deadline_ms=(
                self.config.scheduler.admission_deadline_ms
            ),
            prefix_cache=pc.enabled,
            prefill_chunk=dcfg.prefill_chunk,
            text_fn=self.final_text,
            radix=self.radix_cache,
            cache_aware_sched=pc.cache_aware_sched,
            insert_generated=pc.insert_generated,
            evict_watermark=pc.evict_watermark,
            swap=self.kv_swap,
        )
        # host-side mirror of the device page tables, one row per slot
        self._page_tables_np = np.zeros(
            (self.max_slots, self.geometry.pages_per_seq), np.int32
        )
        # noise for unseeded sampled rows (seeded rows hash their seed)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.config.model.max_model_len)
        self._decode_signature_cache: Optional[tuple] = None
        # the static keys of the prompt passes and decode chunks seen so
        # far: the reference counts a compilation at each new one, and
        # on the card a new decode key is a graph capture
        self._compiled_buckets: set = set()
        self._compiled_chunks: set = set()
        # in-flight decode chunks awaiting readback:
        # ([(seq, preempt epoch)], chunk length, _Readback)
        self._pending_chunks: list = []
        self.decode_chunk = max(1, dcfg.decode_chunk)
        # the decode chunk's static inputs and outputs, and on the card
        # its graphs (one per static key, captured at first use)
        self._dec_state = DecodeState(
            self.max_slots, self.geometry.pages_per_seq,
            self.spec.vocab_size, self.decode_chunk, LOGPROBS_K, self.device,
        )
        self._graphs: Optional[DecodeGraphs] = None
        if self.device.type == "cuda":
            self._graphs = DecodeGraphs(
                CudaCapture(self.device, self._generator)
            )
        self.pipeline_depth = max(1, dcfg.decode_pipeline)
        self._submit_q: "queue.Queue[Sequence]" = queue.Queue()
        # held while a batch is queued and while the loop drains the
        # queue, so one ``generate`` batch is admitted as one wave
        self._submit_lock = threading.Lock()
        self._abort_q: "queue.Queue[tuple]" = queue.Queue()
        self._wakeup = threading.Event()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._fatal: Optional[BaseException] = None
        self.total_steps = 0
        self.total_chunks = 0  # decode chunks dispatched
        self.total_prefills = 0
        self.total_decode_tokens = 0
        self.total_state_rebuilds = 0
        self.total_chunked_prefills = 0  # plans run as serial chunks
        self.total_chunk_passes = 0  # their non-final passes
        # forward passes over prompt tokens: prompt, suffix and chunk
        # passes (each runs attention once per layer)
        self.total_prompt_passes = 0

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="vgt-torch-engine", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        self._wakeup.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        owed = list(self.scheduler.running) + list(self.scheduler.waiting)
        while True:
            try:
                owed.append(self._submit_q.get_nowait())
            except queue.Empty:
                break
        for seq in owed:
            if seq.status in (SeqStatus.RUNNING, SeqStatus.WAITING):
                self.scheduler._release_residency(seq)
                seq.fail(EngineRecoveringError(
                    "engine stopped before the request could finish"
                ))
        self.scheduler.waiting.clear()

    # ----------------------------------------------------------- submission

    def submit_tokens(
        self,
        prompt_ids: List[int],
        params: SamplingParams,
        stream_cb: Optional[Callable[[int], Any]] = None,
        meta: Optional[Any] = None,
    ) -> Sequence:
        """Queue one sequence.  ``meta`` (observability/reqtrace.py
        ``RequestMeta``) rides on the sequence with its request id; the
        phase spans the reference parents on it come with the flight
        recorder (ROADMAP queue 1, item 7)."""
        if self._fatal is not None:
            raise RuntimeError("engine is dead") from self._fatal
        seq = Sequence(
            prompt_ids=list(prompt_ids), params=params, stream_cb=stream_cb
        )
        if meta is not None:
            seq.meta = meta
            seq.request_id = meta.request_id
        self._submit_q.put(seq)
        if self._fatal is not None:
            # the loop died between the check and the put: its sweep
            # may have missed this sequence, so fail the queue here
            self._fail_queued(self._fatal)
            raise RuntimeError("engine is dead") from self._fatal
        self._wakeup.set()
        return seq

    def encode_prompt(self, prompt: str) -> List[int]:
        """Prompt -> token ids, keeping the suffix when too long."""
        ids = self.tokenizer.encode(prompt)
        max_prompt = self.config.model.max_model_len - 1
        if len(ids) > max_prompt:
            ids = ids[-max_prompt:]
        return ids or [self.tokenizer.bos_id]

    def submit_prompt(
        self,
        prompt: str,
        params: SamplingParams,
        stream_cb: Optional[Callable[[int], Any]] = None,
        meta: Optional[Any] = None,
    ) -> Sequence:
        return self.submit_tokens(
            self.encode_prompt(prompt), params, stream_cb, meta=meta
        )

    def generate(
        self, prompts: Seq[str], params: Seq[SamplingParams]
    ) -> List[Dict[str, Any]]:
        """Blocking batch API used by the sync backend seam.  The batch is
        queued as one: the loop admits it in one wave, never split by a
        tick that ran between two submissions."""
        with self._submit_lock:
            seqs = [
                self.submit_prompt(p, sp) for p, sp in zip(prompts, params)
            ]
        results = []
        for seq in seqs:
            seq.done_event.wait()
            if seq.status is SeqStatus.FAILED:
                raise seq.error  # type: ignore[misc]
            result = {
                "text": self.final_text(seq),
                "token_ids": list(seq.generated_ids),
                "num_tokens": seq.num_output_tokens,
                "prompt_tokens": seq.orig_prompt_len,
                "finish_reason": seq.finish_reason,
                "metrics": {
                    "ttft": seq.ttft or 0.0,
                    "tpot": seq.tpot or 0.0,
                    "gen_time": (seq.finish_t or 0) - seq.arrival_t,
                    **seq.resume_metrics(),
                },
            }
            if seq.params.logprobs:
                result["logprobs"] = self.logprob_entries(seq)
            results.append(result)
        return results

    # ------------------------------------------------------------- the loop

    def _loop(self) -> None:
        logger.info("engine thread started")
        while self._running:
            try:
                if not self._tick():
                    self._wakeup.wait(timeout=0.005)
                    self._wakeup.clear()
            except Exception as exc:
                logger.error("engine loop fatal error", exc_info=True)
                self._die(exc)
                return

    def _fail_queued(self, exc: BaseException) -> None:
        while True:
            try:
                self._submit_q.get_nowait().fail(exc)
            except queue.Empty:
                return

    def _die(self, exc: BaseException) -> None:
        """Fatal error on the engine thread: fail every owed sequence and
        stop (restart-and-resume is the supervisor's job, not ported)."""
        self._fatal = exc
        self._running = False
        self._pending_chunks.clear()
        for seq in list(self.scheduler.running) + list(
            self.scheduler.waiting
        ):
            if seq.status in (SeqStatus.RUNNING, SeqStatus.WAITING):
                self.scheduler._release_residency(seq)
                seq.fail(exc)
        self.scheduler.waiting.clear()
        self._fail_queued(exc)

    def _tick(self) -> bool:
        """One iteration: admit + prefill, then keep up to
        ``pipeline_depth`` decode chunks in flight, blocking only on the
        oldest one's readback.  Returns False when there was no work."""
        self._drain_submissions()
        self._drain_abort_requests()
        self._handle_aborts()
        self._handle_deadlines()
        # proactive prefix-cache trim: keep truly-free pages above the
        # evict watermark so allocation never pays the eviction walk
        self.scheduler.maybe_trim()
        worked = self._admit_and_prefill()

        active = self._running_seqs()
        if active:
            signature = self._decode_signature(active)
            if signature != self._decode_signature_cache:
                # membership changed: fold every in-flight chunk into host
                # state before rebuilding the device state
                self._decode_signature_cache = None
                self._process_chunks(drain=True)
                active = self._running_seqs()
                if active:
                    chunk = self._pick_chunk(active)
                    if self.scheduler.prepare_decode(active, horizon=chunk):
                        active = self._running_seqs()  # minus any victims
                        if active:
                            self._build_decode_state(active)
                            self._decode_signature_cache = (
                                self._decode_signature(active)
                            )
                            self._dispatch_chunk(active, chunk)
                worked = True
            elif len(self._pending_chunks) < self.pipeline_depth:
                in_flight = sum(c[1] for c in self._pending_chunks)
                chunk = self._pick_chunk(active, lead=in_flight)
                if chunk == 0:
                    # every budget is covered by the in-flight steps
                    self._process_chunks()
                elif self.scheduler.prepare_decode(
                    active, horizon=in_flight + chunk
                ):
                    survivors = self._running_seqs()
                    new_sig = self._decode_signature(survivors)
                    if new_sig == self._decode_signature_cache:
                        self._dispatch_chunk(active, chunk)
                    elif [t[:3] for t in new_sig] == [
                        t[:3] for t in self._decode_signature_cache or ()
                    ]:
                        # same sequences, pages merely grew: re-upload the
                        # page tables only (no drain at page boundaries)
                        self._refresh_page_tables(survivors)
                        self._decode_signature_cache = new_sig
                        self._dispatch_chunk(active, chunk)
                worked = True

        if self._pending_chunks and (
            len(self._pending_chunks) >= self.pipeline_depth or not active
        ):
            self._process_chunks(drain=not active)
            worked = True
        return (
            worked
            or bool(self._pending_chunks)
            or self.scheduler.has_admissible_waiting()
        )

    def _running_seqs(self) -> List[Sequence]:
        return [
            s for s in self.scheduler.running
            if s.status is SeqStatus.RUNNING
        ]

    def _handle_aborts(self) -> None:
        """Drop RUNNING sequences whose client cancelled; in-flight
        chunks holding them are discarded at readback."""
        for seq in self._running_seqs():
            if seq.abort_requested:
                self.scheduler.abort(seq)

    def _handle_deadlines(self) -> None:
        """Shed RUNNING sequences past their end-to-end deadline; the
        owed future fails with the partial generation attached."""
        now = time.perf_counter()
        for seq in self._running_seqs():
            if not seq.past_deadline(now):
                continue
            self.scheduler.shed(
                seq,
                DeadlineExceededError(
                    f"request deadline ({seq.params.timeout_s:.3f}s) "
                    f"passed mid-generation after "
                    f"{seq.num_generated} tokens",
                    partial_text=self.final_text(seq),
                    partial_tokens=seq.num_generated,
                    deadline_s=seq.params.timeout_s or 0.0,
                ),
            )

    def abort(self, seq_id: int, reason: str = "client_disconnect") -> None:
        """Cancel one sequence by id; applied by the engine thread at its
        next tick (slot and pages freed there)."""
        self._abort_q.put((seq_id, reason))
        self._wakeup.set()

    def abort_in_flight(self, reason: str = "drain") -> None:
        """Request-abort EVERY waiting and running sequence (the graceful
        drain's straggler sweep), at the engine thread's next tick."""
        self._abort_q.put((None, reason))
        self._wakeup.set()

    def _drain_abort_requests(self) -> None:
        while True:
            try:
                seq_id, reason = self._abort_q.get_nowait()
            except queue.Empty:
                return
            for seq in list(self.scheduler.running) + list(
                self.scheduler.waiting
            ):
                if (
                    (seq_id is None or seq.seq_id == seq_id)
                    and seq.status in (SeqStatus.RUNNING, SeqStatus.WAITING)
                    and not seq.abort_requested
                ):
                    seq.request_abort(reason)

    def _drain_submissions(self) -> None:
        with self._submit_lock:
            while True:
                try:
                    seq = self._submit_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    self.scheduler.add(seq)
                except Exception as exc:
                    seq.fail(exc)

    # -------------------------------------------------------- device inputs

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        """Upload a host array.  On CUDA it is staged through pinned
        memory so the copy is asynchronous and never waits for the decode
        chunks already in flight on the stream."""
        t = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _group_sampling(self, plans: List[PrefillPlan], B: int):
        """A prompt pass's sampling inputs, uploaded (``seeds`` None when
        no row is seeded); its logprobs variant (``_num_logprobs``); and
        the sampling part of its static key as the reference builds it:
        penalty counts present (only a penalized row that already
        generated needs them), the padded stop-id width, logprobs, the
        padded bias width."""
        host = self._row_host(B, enumerate(p.seq for p in plans))
        num_lp = self._num_logprobs(p.seq for p in plans)
        key = (
            any(p.seq.params.has_penalties and p.seq.generated_ids
                for p in plans),
            None if host["min_tok"] is None
            else _width(host["min_tok"][1].shape[1]),
            num_lp,
            None if host["bias"] is None
            else _width(host["bias"][0].shape[1]),
        )
        if not (host["seeds"] >= 0).any():
            host["seeds"] = None  # no row hashes its own noise
        sampling = {
            k: None if a is None
            else tuple(map(self._dev, a)) if isinstance(a, tuple)
            else self._dev(a)
            for k, a in host.items()
        }
        return sampling, num_lp, key

    def _note_key(self, seen: set, key: tuple, kind: str) -> None:
        """``vgt_engine_compilations{kind}`` at the first sight of a
        static key, where the reference compiles a program (on the card
        a new decode key is a graph capture; prompt passes run eagerly)."""
        if key not in seen:
            seen.add(key)
            metrics.RECOMPILES.labels(kind=kind).inc()

    def _row_host(self, B: int, rows) -> Dict[str, Any]:
        """Per-row sampling inputs for ``rows`` = [(row, Sequence)], as
        host arrays: temperatures, top-p/k, seeds (-1 unseeded),
        per-sequence token index, and the penalty / logit-bias /
        min-token arrays (None when no row needs them, so the common
        case adds no work)."""
        rows = list(rows)
        temps = np.zeros((B,), np.float32)
        top_ps = np.ones((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        seeds = np.full((B,), -1, np.int64)
        steps = np.zeros((B,), np.int32)
        for row, seq in rows:
            sp = seq.params
            temps[row] = sp.temperature
            top_ps[row] = sp.top_p
            top_ks[row] = sp.top_k
            if sp.seed is not None:
                seeds[row] = sp.seed
            steps[row] = seq.num_generated
        V = self.spec.vocab_size
        out: Dict[str, Any] = {
            "temps": temps,
            "top_ps": top_ps,
            "top_ks": top_ks,
            "seeds": seeds,
            "steps": steps,
            "counts": None,
            "freq_pens": None,
            "pres_pens": None,
            "min_tok": None,
            "bias": None,
        }
        if any(seq.params.has_penalties for _, seq in rows):
            counts = np.zeros((B, V), np.int32)
            freq = np.zeros((B,), np.float32)
            pres = np.zeros((B,), np.float32)
            for row, seq in rows:
                freq[row] = seq.params.frequency_penalty
                pres[row] = seq.params.presence_penalty
                if seq.generated_ids:
                    np.add.at(counts[row], np.asarray(seq.generated_ids), 1)
            out.update(counts=counts, freq_pens=freq, pres_pens=pres)
        floors = [(r, s) for r, s in rows if s.params.min_tokens > 0]
        if floors:
            base = [self.tokenizer.eos_id, *self.spec.extra_stop_ids]
            per = {
                r: base + list(s.params.stop_token_ids or [])
                for r, s in floors
            }
            K = max(len(v) for v in per.values())
            mat = np.full((B, K), V, np.int64)
            min_toks = np.zeros((B,), np.int32)
            for r, s in floors:
                mat[r, : len(per[r])] = per[r]
                min_toks[r] = s.params.min_tokens
            out["min_tok"] = (min_toks, mat)
        biased = [(r, s.params.logit_bias) for r, s in rows
                  if s.params.logit_bias]
        if biased:
            K = max(len(b) for _, b in biased)
            ids = np.full((B, K), V, np.int64)
            vals = np.zeros((B, K), np.float32)
            for r, b in biased:
                for j, (tid, val) in enumerate(sorted(b.items())):
                    ids[r, j] = tid
                    vals[r, j] = val
            out["bias"] = (ids, vals)
        return out

    # -------------------------------------------------------------- prefill

    def _admit_and_prefill(self) -> bool:
        """Admit waiting prompts a free slot + pages exist for, prefill
        them in batched prompt passes (up to ``prefill_batch_max`` rows
        each), then read every first token back in one transfer.  While
        sequences decode, at most ``prefill_admit_limit`` prompts are
        admitted per tick.

        Plans group by (bucket, prefix hit, unaligned hit): cold prompts
        take the prompt pass, prefix-cache hits the suffix pass, and
        copy-on-write hits (which start mid-page) a suffix pass of their
        own.  Chunked plans run serial suffix passes and never batch.
        The radix tree indexes the new pages only after every writer is
        enqueued, so a reader admitted in a later tick runs after its
        writer in stream order."""
        dcfg = self.config.device
        limit = dcfg.prefill_admit_limit
        decoding = bool(self._running_seqs())
        plans: List[PrefillPlan] = []
        swap_plans: List[SwapInPlan] = []
        start = time.perf_counter()
        while not (
            decoding and limit and len(plans) + len(swap_plans) >= limit
        ):
            plan = self.scheduler.try_admit()
            if plan is None:
                break
            if isinstance(plan, SwapInPlan):
                swap_plans.append(plan)
            else:
                plans.append(plan)
        for plan in swap_plans:
            # host-swap re-admission: a host->device copy and scatter
            # replace the re-prefill entirely (zero recompute tokens)
            self._dispatch_swap_in(plan)
        if not plans:
            return bool(swap_plans)
        ps = self.geometry.page_size
        groups: Dict[tuple, List[PrefillPlan]] = {}
        # (group plans, ([B] device first tokens, logprob triple or None))
        dispatched = []
        for plan in plans:
            if plan.chunked:
                dispatched.append(
                    ([plan], self._dispatch_chunked_prefill(plan))
                )
                continue
            cached = plan.cached_len
            key = (plan.bucket, cached > 0, cached % ps != 0)
            groups.setdefault(key, []).append(plan)
        batch_max = max(1, dcfg.prefill_batch_max)
        for (bucket, cached, unaligned), group in sorted(groups.items()):
            for i in range(0, len(group), batch_max):
                chunk = group[i : i + batch_max]
                if cached:
                    tokens = self._dispatch_suffix_group(
                        chunk, bucket, unaligned=unaligned
                    )
                else:
                    tokens = self._dispatch_prefill_group(chunk, bucket)
                dispatched.append((chunk, tokens))
        for plan in plans:
            self.scheduler.commit_prefill(plan)
        lps = [t for _, (_, lp) in dispatched if lp is not None for t in lp]
        readback = _Readback(
            torch.cat([t for _, (t, _) in dispatched]), *lps
        )
        firsts, *lps = readback.result()
        # one combined dispatch and readback for the wave: each prompt
        # is observed with an equal share, as the reference does
        share = (time.perf_counter() - start) / len(plans)
        for plan in plans:
            metrics.observe_with_exemplar(
                metrics.ENGINE_STEP_TIME.labels(kind="prefill"), share,
                trace_id=getattr(plan.seq.trace, "trace_id", None),
            )
        offset = 0
        # one thread owns admission and readback, so every admitted
        # sequence is still RUNNING in its own slot here
        for group, (tokens, lp) in dispatched:
            lp_np = None
            if lp is not None:
                lp_np, lps = tuple(lps[:3]), lps[3:]
            for row, plan in enumerate(group):
                token = int(firsts[offset + row])
                self.total_prefills += 1
                if lp_np is not None and plan.seq.params.logprobs:
                    self._attach_logprob(plan.seq, lp_np, None, row)
                plan.seq.append_token(token)
                self._maybe_finish(plan.seq, token)
            offset += tokens.shape[0]
        return True

    def _dispatch_swap_in(self, plan: SwapInPlan) -> None:
        """Re-admit a host-swapped preemption victim: its parked KV into
        the freshly allocated ``seq.pages`` (runtime/kv_swap.py), and it
        rejoins decode at the exact position it stopped: no prompt pass,
        no first-token readback (its last sampled token is the next
        decode feed).  Its new slot and epoch change the membership
        signature, so ``_build_decode_state`` uploads its row before the
        next chunk."""
        self.kv_swap.swap_in_seq(plan.seq, plan.seq.pages)

    def _set_slot_row(self, plan: PrefillPlan) -> None:
        """The decode-side page-table row of the plan's slot: its pages,
        then trash page 0."""
        slot_row = self._page_tables_np[plan.slot]
        slot_row[:] = 0
        slot_row[: len(plan.seq.pages)] = plan.seq.pages

    @staticmethod
    def _num_logprobs(seqs) -> int:
        """``LOGPROBS_K`` when any of ``seqs`` asks for logprobs, else 0
        (the static logprobs variant of a pass or chunk)."""
        return LOGPROBS_K if any(s.params.logprobs for s in seqs) else 0

    @staticmethod
    def _all_greedy(seqs, num_logprobs: int) -> bool:
        """The all-greedy chunk variant: every row at temperature 0 and
        no logprobs (its argmax skips the top-TRUNC slice they need)."""
        return num_logprobs == 0 and all(
            s.params.temperature == 0.0 for s in seqs
        )

    def _dispatch_prefill_group(self, plans: List[PrefillPlan], bucket: int):
        """Enqueue ONE prompt pass for same-bucket plans; returns the [B]
        first tokens on the device and their logprob triple (None when no
        plan asks).  B pads to a power of two; padding rows use trash
        page tables, temperature 0 and seq_len 1, and their tokens are
        discarded."""
        n = len(plans)
        B = 1 << (n - 1).bit_length()
        ps = self.geometry.page_size
        n_bucket_pages = bucket // ps
        tokens = np.zeros((B, bucket), np.int32)
        seq_lens = np.ones((B,), np.int32)
        prefill_pt = np.zeros((B, n_bucket_pages), np.int32)
        for row, plan in enumerate(plans):
            seq = plan.seq
            tokens[row, : seq.num_prompt_tokens] = seq.prompt_ids
            seq_lens[row] = seq.num_prompt_tokens
            self._set_slot_row(plan)
            prefill_pt[row, : len(seq.pages)] = seq.pages[:n_bucket_pages]
        sampling, num_lp, key = self._group_sampling(plans, B)
        self._note_key(self._compiled_buckets, (bucket, B, *key), "prefill")
        self.total_prompt_passes += 1
        return _prefill_step(
            self.params, self.spec, self._dev(tokens), self._dev(seq_lens),
            self.k_pages, self.v_pages, self._dev(prefill_pt),
            self._generator, sampling, num_lp,
        )

    def _ctx_pages(self, n_tokens: int) -> int:
        """Context-window width for ``n_tokens``: the page count rounded
        up to a power of two (bounds the plain version's gather), capped
        at a sequence's table width."""
        n = cdiv(n_tokens, self.geometry.page_size)
        return min(self.geometry.pages_per_seq,
                   1 << max(0, n - 1).bit_length())

    def _dispatch_suffix_group(
        self, plans: List[PrefillPlan], bucket: int, unaligned: bool = False
    ):
        """Enqueue ONE suffix pass for up to ``prefill_batch_max``
        prefix-cache hits whose suffixes share a bucket; returns as
        ``_dispatch_prefill_group``.  The cached prefix pages are shared
        and read-only; only the suffix pages are written.  ``unaligned``
        is the copy-on-write group: each plan's page copy is enqueued
        first, the suffix then starts mid-page, and the suffix table
        carries one extra column."""
        n = len(plans)
        B = 1 << (n - 1).bit_length()
        ps = self.geometry.page_size
        n_suffix_pages = bucket // ps + (1 if unaligned else 0)
        for plan in plans:
            if plan.cow is not None:
                _cow_copy_pages(self.k_pages, self.v_pages, *plan.cow)
                if self.radix_cache is not None:
                    self.radix_cache.total_cow_copies += 1
                metrics.PREFIX_COW_COPIES.inc()
        ctx_pages = self._ctx_pages(
            max(p.seq.num_prompt_tokens for p in plans)
        )
        tokens = np.zeros((B, bucket), np.int32)
        prefix_lens = np.zeros((B,), np.int32)
        suffix_lens = np.ones((B,), np.int32)
        suffix_pt = np.zeros((B, n_suffix_pages), np.int32)
        ctx_pt = np.zeros((B, ctx_pages), np.int32)
        for row, plan in enumerate(plans):
            seq = plan.seq
            suffix = seq.prompt_ids[plan.cached_len :]
            tokens[row, : len(suffix)] = suffix
            prefix_lens[row] = plan.cached_len
            suffix_lens[row] = len(suffix)
            own = seq.pages[plan.cached_len // ps :][:n_suffix_pages]
            suffix_pt[row, : len(own)] = own
            self._set_slot_row(plan)
            ctx = seq.pages[:ctx_pages]
            ctx_pt[row, : len(ctx)] = ctx
        sampling, num_lp, key = self._group_sampling(plans, B)
        self._note_key(
            self._compiled_buckets,
            _suffix_key(bucket, B, ctx_pages, *key, unaligned=unaligned),
            "prefill",
        )
        self.total_prompt_passes += 1
        return _suffix_prefill_step(
            self.params, self.spec, self._dev(tokens), self._dev(prefix_lens),
            self._dev(suffix_lens), self.k_pages, self.v_pages,
            self._dev(suffix_pt), self._dev(ctx_pt), self._generator,
            sampling, unaligned=unaligned, num_logprobs=num_lp,
        )

    def _dispatch_chunked_prefill(self, plan: PrefillPlan):
        """A (suffix-)prompt longer than the bucket cap: page-aligned
        suffix passes of ``plan.bucket`` tokens, each attending the whole
        resident context.  The non-final passes are lean — no sampling,
        nothing read back; the final pass is a one-row suffix group, so
        its sampling can never drift from the unchunked path.  Returns
        the final pass's [1] first token on the device and its logprob
        triple (or None)."""
        self.total_chunked_prefills += 1
        seq = plan.seq
        ps = self.geometry.page_size
        chunk = plan.bucket  # page-aligned, as every bucket is
        total = seq.num_prompt_tokens
        self._set_slot_row(plan)
        start = plan.cached_len  # full cached pages: chunked plans drop COW
        while total - start > chunk:
            tokens = np.asarray([seq.prompt_ids[start : start + chunk]],
                                np.int32)
            pages = np.asarray(
                [seq.pages[start // ps : (start + chunk) // ps]], np.int32
            )
            n_ctx = self._ctx_pages(start + chunk)
            ctx_pt = np.zeros((1, n_ctx), np.int32)
            ctx_pt[0, : min(n_ctx, len(seq.pages))] = seq.pages[:n_ctx]
            self._note_key(
                self._compiled_buckets,
                _suffix_key(chunk, 1, n_ctx, False, None, 0, None),
                "prefill",
            )
            prefill_suffix_forward(
                self.params, self.spec, self._dev(tokens),
                self._dev(np.asarray([start], np.int32)),
                self._dev(np.asarray([chunk], np.int32)),
                self.k_pages, self.v_pages, self._dev(pages),
                self._dev(ctx_pt),
            )
            self.total_chunk_passes += 1
            self.total_prompt_passes += 1
            start += chunk
        final = PrefillPlan(
            seq=seq, slot=plan.slot, cached_len=start,
            bucket=bucket_for(total - start, self.scheduler.prefill_buckets),
        )
        return self._dispatch_suffix_group([final], final.bucket)

    # --------------------------------------------------------------- decode

    def _decode_signature(self, seqs: List[Sequence]):
        """Membership signature: while unchanged, every device input
        except tokens/positions/steps (which flow device to device) is
        reusable.  ``preempt_count`` is part of the identity, so a victim
        re-admitted into the same slot never matches its old state."""
        return tuple(
            (seq.seq_id, seq.slot, seq.preempt_count, len(seq.pages))
            for seq in seqs
        )

    def _build_decode_state(self, seqs: List[Sequence]) -> None:
        """Every decode input of the new membership into the static
        buffers, in place on the engine stream (no chunk is in flight:
        the caller drained them)."""
        self.total_state_rebuilds += 1
        B = self.max_slots
        tokens = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        for seq in seqs:
            slot = seq.slot
            row = self._page_tables_np[slot]
            row[:] = 0
            row[: len(seq.pages)] = seq.pages
            tokens[slot] = seq.output_ids[-1]
            positions[slot] = seq.total_len - 1
            active[slot] = True
        self._dec_state.load(
            tokens, positions, active, self._page_tables_np,
            self._row_host(B, ((s.slot, s) for s in seqs)),
        )

    def _refresh_page_tables(self, seqs: List[Sequence]) -> None:
        """Rewrite ONLY the page tables after in-place page growth, in
        place.  A chunk in flight still reads the older table: the copy
        is enqueued after it on the same stream.  That table stays valid
        for it: the new page is only addressed at positions it never
        reaches."""
        for seq in seqs:
            row = self._page_tables_np[seq.slot]
            row[:] = 0
            row[: len(seq.pages)] = seq.pages
        self._dec_state.load_page_tables(self._page_tables_np)

    def _pick_chunk(self, active: List[Sequence], lead: int = 0) -> int:
        """The next chunk length: the largest power of two that neither
        exceeds ``decode_chunk`` nor overshoots every sequence's remaining
        budget (``lead`` = steps in flight, not yet folded).  With prompts
        waiting for a free slot it caps at decode_chunk/8, so admission
        comes back within a short chunk."""
        max_len = self.config.model.max_model_len
        headroom = 0
        for seq in active:
            rem_tokens = max(1, seq.params.max_tokens) - seq.num_generated
            rem_len = max_len - seq.total_len
            headroom = max(headroom, min(rem_tokens, rem_len) - lead)
        if headroom <= 0:
            return 0
        headroom = min(self.decode_chunk, headroom)
        if self.scheduler.has_admissible_waiting():
            headroom = min(headroom, max(1, self.decode_chunk // 8))
        return 1 << (headroom.bit_length() - 1)

    def _dispatch_chunk(self, active: List[Sequence], chunk: int) -> None:
        """Enqueue one decode chunk and the readback of its outputs.  On
        the card the chunk is the replay of its key's graph (captured at
        first use); eagerly otherwise.  The readback is enqueued before
        the next chunk can overwrite the static outputs."""
        state = self._dec_state
        num_lp = self._num_logprobs(active)
        all_greedy = self._all_greedy(active, num_lp)

        def body(st: DecodeState = state) -> None:
            _decode_chunk(
                self.params, self.spec, st, self.k_pages, self.v_pages,
                self._generator, num_steps=chunk,
                max_position=self.config.model.max_model_len - 1,
                all_greedy=all_greedy, num_logprobs=num_lp,
            )

        key = state.key(chunk, all_greedy, num_lp)
        self._note_key(self._compiled_chunks, key, "decode")
        if self.decode_graphs:
            self._graphs.run(key, body, lambda: body(state.scratch()))
        else:
            body()
        self.total_chunks += 1
        outs = [state.out_tokens[:chunk]]
        if num_lp:
            outs += [state.out_lp[:chunk], state.out_top_ids[:chunk],
                     state.out_top_lps[:chunk]]
        # the preempt epoch: a sequence preempted (and maybe re-admitted)
        # while this chunk is in flight must not receive its tokens
        self._pending_chunks.append(
            ([(s, s.preempt_count) for s in active], chunk,
             _Readback(*outs))
        )

    def _process_chunks(self, drain: bool = False) -> None:
        """Fold the oldest in-flight chunk (all of them when ``drain``)
        into host state: append tokens (and their logprobs) in order,
        detect stops, discard steps past a stop."""
        while self._pending_chunks:
            seqs, chunk, readback = self._pending_chunks.pop(0)
            # the host-blocking readback time only: dispatch-to-now would
            # count the chunks queued ahead of this one
            block_start = time.perf_counter()
            sampled, *lp = readback.result()  # [chunk, B] (+ logprobs)
            metrics.observe_with_exemplar(
                metrics.ENGINE_STEP_TIME.labels(kind="decode"),
                time.perf_counter() - block_start,
                trace_id=next(
                    (s.trace.trace_id for s, _ in seqs
                     if s.trace is not None and s.trace.trace_id),
                    None,
                ),
            )
            lp_np = tuple(lp) if lp else None
            for seq, epoch in seqs:
                if (
                    seq.status is not SeqStatus.RUNNING
                    or seq.preempt_count != epoch
                ):
                    continue  # stopped or preempted since dispatch
                for k in range(chunk):
                    token = int(sampled[k, seq.slot])
                    if lp_np is not None and seq.params.logprobs:
                        self._attach_logprob(seq, lp_np, k, seq.slot)
                    seq.append_token(token)
                    self.total_decode_tokens += 1
                    self._maybe_finish(seq, token)
                    if seq.status is not SeqStatus.RUNNING:
                        break
            self.total_steps += chunk
            if not drain:
                break

    # ------------------------------------------------------------- logprobs

    def lp_entry(self, tid: int, lp: float, top) -> Dict[str, Any]:
        """One OpenAI-shape logprob entry for a delivered token."""
        return {
            "token": self.tokenizer.decode([tid]),
            "token_id": tid,
            "logprob": lp,
            "top_logprobs": [
                {
                    "token": self.tokenizer.decode([i]),
                    "token_id": i,
                    "logprob": l,
                }
                for i, l in top
            ],
        }

    def logprob_entries(self, seq: Sequence) -> List[Dict[str, Any]]:
        """OpenAI-shape logprob content for a finished sequence (one entry
        per generated token, aligned with ``generated_ids``)."""
        return [
            self.lp_entry(tid, lp, top)
            for tid, (lp, top) in zip(seq.generated_ids, seq.logprob_data)
        ]

    def _attach_logprob(self, seq: Sequence, lp_np, k, slot) -> None:
        """Record one delivered token's logprob data from a readback
        triple ``(lp, top_ids, top_lps)``: a chunk's ``[chunk, B(, K)]``
        at step ``k``, or a prompt pass's ``[B(, K)]`` (``k`` None)."""
        lp, tids, tlps = lp_np
        if k is not None:
            lp, tids, tlps = lp[k], tids[k], tlps[k]
        n = min(seq.params.top_logprobs, tids.shape[-1])
        seq.logprob_data.append(
            (
                float(lp[slot]),
                [
                    (int(tids[slot, j]), float(tlps[slot, j]))
                    for j in range(n)
                ],
            )
        )

    # ------------------------------------------------------------ finishing

    def _maybe_finish(self, seq: Sequence, token: int) -> None:
        reason = None
        # min_tokens gates the STOP kinds only; length stays live
        if seq.num_generated >= seq.params.min_tokens:
            if token == self.tokenizer.eos_id or token in self._stop_ids:
                reason = "stop"
            elif (
                seq.params.stop_token_ids
                and token in seq.params.stop_token_ids
            ):
                reason = "stop"
            elif self._hit_stop_string(seq):
                reason = "stop"
        if reason is None:
            if seq.num_generated >= max(1, seq.params.max_tokens):
                reason = "length"
            elif seq.total_len >= self.config.model.max_model_len:
                reason = "length"
        if reason is not None:
            self.scheduler.remove(seq)
            seq.finish(reason)

    def _hit_stop_string(self, seq: Sequence) -> bool:
        """Host-side stop strings: decode a tail window first, and only
        on a hit decode the whole generation to truncate at the earliest
        match (matches ending inside the min_tokens floor are ignored)."""
        stops = seq.params.stop
        if not stops:
            return False
        longest = max(len(s) for s in stops)
        window = min(len(seq.generated_ids), longest + 8)
        tail = self.tokenizer.decode(seq.generated_ids[-window:])
        if not any(s in tail for s in stops):
            return False
        text = self.tokenizer.decode(seq.generated_ids)
        floor_chars = 0
        if seq.params.min_tokens > 0:
            floor_chars = len(
                self.tokenizer.decode(
                    seq.generated_ids[: seq.params.min_tokens]
                )
            )
        cuts = []
        for s in stops:
            idx = text.find(s, max(0, floor_chars - len(s) + 1))
            if idx != -1:
                cuts.append(idx)
        if not cuts:
            return False
        seq.text_override = text[: min(cuts)]
        return True

    def final_text(self, seq: Sequence) -> str:
        """The stop-truncated text when a stop string matched, else the
        whole decoded generation."""
        if seq.text_override is not None:
            return seq.text_override
        return self.tokenizer.decode(seq.generated_ids)

    # ------------------------------------------------------------ utilities

    def warmup(self, buckets: Optional[List[int]] = None) -> float:
        """Run the first use of the decode-chunk ladder and of the given
        (default: smallest) prefill buckets before serving, as the
        reference's warm-up compiles them; returns its seconds.  On the
        card this captures the decode graphs the walk reaches and builds
        and launches the engine's kernels.  The first sequence generates
        ``2*decode_chunk`` tokens, which walks the power-of-two chunk
        descent (K, ..., 2, 1) ``_pick_chunk`` produces near a budget
        boundary, greedy and then sampled (the ``all_greedy`` keys
        split).  For the first bucket the batched-prefill ladder (B =
        prefill_batch_max, ..., 2) is also walked, each group submitted
        as one burst so it admits as one stacked pass.  Keys with
        logprobs, penalties, bias or min-tokens stay cold, as in the
        reference."""
        start = time.perf_counter()
        was_running = self._running
        if not was_running:
            self.start()
        ladder = SamplingParams(
            max_tokens=max(1, 2 * self.decode_chunk), temperature=0.0
        )
        ladder_sampled = SamplingParams(
            max_tokens=max(1, 2 * self.decode_chunk), temperature=0.7
        )
        single = SamplingParams(max_tokens=1, temperature=0.0)
        buckets = buckets or [self.scheduler.prefill_buckets[0]]
        for i, bucket in enumerate(buckets):
            n = max(1, min(bucket - 1, 8))
            seq = self.submit_tokens([5] * n, ladder if i == 0 else single)
            seq.done_event.wait(timeout=600)
            if i == 0:
                seq = self.submit_tokens([5] * n, ladder_sampled)
                seq.done_event.wait(timeout=600)
                B = max(1, self.config.device.prefill_batch_max)
                while B >= 2:
                    group = [
                        self.submit_tokens([5] * n, single)
                        for _ in range(min(B, self.max_slots))
                    ]
                    for g in group:
                        g.done_event.wait(timeout=600)
                    B //= 2
        if self.scheduler.prefill_chunk > 0:
            # chunked prefill runs suffix passes (one per power-of-two
            # context width) the bucket walk never reaches: one
            # max-length prompt reaches every width
            n_long = self.config.model.max_model_len - 2
            if n_long > self.scheduler.prefill_buckets[-1]:
                seq = self.submit_tokens([5] * n_long, single)
                seq.done_event.wait(timeout=600)
        if not was_running:
            self.stop()
        return time.perf_counter() - start

    def set_prefix_insert_suspended(self, flag: bool) -> None:
        """Brownout L4 (admission.py "bypass cache writes"): stop
        inserting into the prefix tree, keep serving hits.  Safe from
        any thread (a bool store)."""
        if self.radix_cache is not None:
            self.radix_cache.insert_suspended = bool(flag)
        if self.kv_swap is not None:
            # L4 also stops host-pool DEMOTIONS (a demotion is a cache
            # write) while promotions keep serving.  Preemption
            # swap-outs are not gated: parking client-owed work beats
            # recomputing it at any brownout level.
            self.kv_swap.demote_suspended = bool(flag)

    def pressure_signals(self) -> Dict[str, Any]:
        """Gauges for the gateway's admission and brownout controllers:
        plain int and len reads, no lock, no device touch.
        ``kv_free_ratio`` counts reclaimable cached pages as free,
        ``kv_truly_free_ratio`` does not.  With the host swap tier on,
        its occupancy block (``KVSwapManager.signal_block``) joins."""
        total = max(1, self.allocator.num_allocatable)
        swap_block = (
            self.kv_swap.signal_block() if self.kv_swap is not None else {}
        )
        return {
            **swap_block,
            "kv_free_ratio": round(self.allocator.num_free / total, 4),
            "kv_truly_free_ratio": round(
                self.allocator.num_truly_free / total, 4
            ),
            "prefix_cached_ratio": round(
                self.allocator.num_cached / total, 4
            ),
            "kv_token_capacity": self.geometry.total_tokens,
            "kv_dtype": self.geometry.kv_dtype,
            "engine_queue_depth": len(self.scheduler.waiting),
            "running": len(self.scheduler.running),
        }

    def device_health(self) -> Dict[str, Any]:
        """Liveness of the engine's device: one tiny tensor op on it."""
        try:
            value = float(torch.ones(1, device=self.device).sum())
            cuda = self.device.type == "cuda"
            return {
                "alive": value == 1.0,
                "platform": "gpu" if cuda else "cpu",
                "device_kind": (
                    torch.cuda.get_device_name(self.device) if cuda
                    else "cpu"
                ),
                "num_devices": 1,
            }
        except Exception as exc:  # pragma: no cover
            return {"alive": False, "error": str(exc)}

    def get_stats(self) -> Dict[str, Any]:
        """Engine counters.  ``steps`` counts dispatched decode steps
        (chunk lengths summed, overshoot included); ``prefix_cache``
        restates the scheduler's prefix-cache counters beside the
        engine's chunked-prefill counts."""
        sched = self.scheduler.get_stats()
        pc = sched["prefix_cache"]
        return {
            "scheduler": sched,
            "prefix_cache": {
                "enabled": pc["enabled"],
                "mode": pc["mode"],
                "hit_tokens": pc["hit_tokens"],
                "cow_copies": pc.get("cow_copies", 0),
                "chunked_prefills": self.total_chunked_prefills,
                "chunk_passes": self.total_chunk_passes,
            },
            "running": len(self.scheduler.running),
            "used_pages": self.allocator.num_used,
            "admitted": self.scheduler.total_admitted,
            "finished": self.scheduler.total_finished,
            "steps": self.total_steps,
            "chunks": self.total_chunks,
            "prefills": self.total_prefills,
            "prompt_passes": self.total_prompt_passes,
            "decode_tokens": self.total_decode_tokens,
            "state_rebuilds": self.total_state_rebuilds,
            # on the card: whether chunks replay graphs, the graphs
            # captured, their capture seconds and their pool's bytes
            "decode_graphs": None if self._graphs is None else {
                "enabled": self.decode_graphs, **self._graphs.stats()},
            "kv_pages_total": self.allocator.num_allocatable,
            "kv_token_capacity": self.geometry.total_tokens,
            "kv_dtype": self.geometry.kv_dtype,
            "kv_page_bytes": self.geometry.page_bytes,
            "model": self.spec.name,
            "device": str(self.device),
            "load_time_s": round(self.load_time_s, 2),
            **(
                {"kv_swap": self.kv_swap.get_stats()}
                if self.kv_swap is not None
                else {}
            ),
        }
