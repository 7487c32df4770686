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
  matmuls (K4/K5), or with ``device.int8_native`` the W8A8/W4A8 int8
  products (the lm_head stays on K4/K5); a checkpoint, and a MoE
  tree's random init, are quantized a layer at a time as they load.  ``kv_cache.dtype: int8`` makes the pools int8
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
* **Supervision hooks** (runtime/supervisor.py): the loop stamps a
  watchdog heartbeat around every dispatch and readback (``compiling``
  around a graph capture or a kernel's first build); a fatal error or a
  declared stall is *contained* — in-flight sequences are checkpointed
  for replay (``take_checkpointed``) or failed with a retryable error,
  and ``on_fatal`` hands off to the supervisor, which tears the core
  down with :func:`rebuild_core` and replays into its successor with
  :func:`replay_into`.  On the card each core runs on its own stream.
* **Integrity** (integrity.py, ``integrity.enabled``): the output
  sentinels over each chunk's readback (the guard flags written inside
  the chunk), the weight-checksum sweep on idle ticks, and the fault
  probes ``stall``, ``prefill``, ``decode_step`` and ``logit_corrupt``.
* **Observability**: the flight recorder (observability/flight.py) and
  the per-tick perf attribution (observability/perf.py), both fed on the
  host side of each readback; ``capture_profile`` writes a
  ``torch.profiler`` Chrome trace.
* **Speculative decoding** (``device.speculative_k`` > 0,
  runtime/speculative.py): each tick drafts up to k tokens a sequence
  (prompt lookup, or a draft model with ``model.draft_model_id``) and
  scores them in ONE verify pass (models/decoder.py
  ``spec_verify_forward``, K3 on the card), accepting by argmax match
  (greedy) or rejection sampling (``verify_and_sample``).  Rounds are
  host-driven and eager: acceptance is data-dependent, so positions come
  back through the host each round, and no graph is captured for them.
  Brownout L3 (``set_spec_suspended``) falls back to the decode chunks.

Not ported yet (the config refuses them): multi-device meshes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence as Seq

import numpy as np
import torch

from vgate_tpu_torch import faults, integrity
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import (
    NotPortedError,
    VGTConfig,
    get_config,
)
from vgate_tpu_torch.errors import (
    DeadlineExceededError,
    EngineRecoveringError,
    IntegrityError,
    PoisonRequestError,
    ResumeExhaustedError,
)
from vgate_tpu_torch.logging_config import get_logger
from vgate_tpu_torch.models.decoder import (
    decode_forward,
    prefill_forward,
    prefill_suffix_forward,
    spec_verify_forward,
)
from vgate_tpu_torch.models.specs import ModelSpec, spec_for_model_id
from vgate_tpu_torch.observability.flight import FlightRecorder
from vgate_tpu_torch.observability.perf import PerfRecorder
from vgate_tpu_torch.observability.reqtrace import RequestTrace
from vgate_tpu_torch.observability.roofline import (
    EngineRoofline,
    kv_bytes_per_token,
    stream_weight_bytes,
)
from vgate_tpu_torch.ops.kernels import _build
from vgate_tpu_torch.ops.kernels.paged_multitok import check_engine_page_size
from vgate_tpu_torch.ops.kv_quant import (
    SCALE_BYTES,
    copy_page_prefix,
    dtype_short_name,
    is_quantized,
)
from vgate_tpu_torch.ops.quant import int8_native_layout
from vgate_tpu_torch.ops.sampling import (
    apply_logit_bias,
    apply_penalties,
    sample_tokens,
    sample_tokens_with_logprobs,
    suppress_stop_tokens,
    verify_and_sample,
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
from vgate_tpu_torch.runtime.speculative import (
    DraftModelDrafter,
    NgramIndex,
    count_accepted,
)
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


def _spec_verify_step(
    params, spec: ModelSpec, tokens, positions0, input_lens, k_pages,
    v_pages, page_tables, active, generator, sampling: Dict[str, Any],
    pen=None, num_logprobs: int = 0, all_greedy: bool = False,
):
    """One speculative round on the device: score the current token and
    the drafts in a single forward (models/decoder.py
    ``spec_verify_forward``), verify every draft position with the rows'
    sampling params (``verify_and_sample``: greedy rows by argmax match,
    sampled rows by rejection sampling) and count the accepted drafts.

    ``sampling`` holds the rows' [B] temperatures, top-p/k, seeds (None
    when no row is seeded) and steps, and the membership's logit-bias
    and min-token arrays (or None); ``pen`` the penalty histogram [B, V]
    with its frequency and presence penalties, or None.  Position j's
    penalties include the drafts before it (if draft j+1 is rejected,
    position j+1's output is discarded anyway, so every appended token
    is exact); bias and min-token suppression apply at every position,
    each position with its own step index, and the tokens the round
    appends (accepted run + bonus) are folded into the histogram IN
    PLACE.  Returns (model_toks [B, S] int32, accepted [B] int32, the
    logprob triple ``(lp [B, S], top ids [B, S, K], top lps [B, S,
    K])`` or None), all on the device."""
    logits = spec_verify_forward(
        params, spec, tokens, positions0, input_lens, k_pages, v_pages,
        page_tables, active=active,
    )  # [B, S, V]
    B, S = tokens.shape
    dev = tokens.device
    rows = torch.arange(B, device=dev)
    j = torch.arange(S, device=dev)
    if pen is not None:
        counts, freq, pres = pen
        run = counts.clone()
        per_pos = []
        for i in range(S):
            per_pos.append(apply_penalties(logits[:, i], run, freq, pres))
            if i + 1 < S:
                inc = ((i + 1) < input_lens) & active
                run.index_put_((rows, tokens[:, i + 1].long()),
                               inc.to(run.dtype), accumulate=True)
        logits = torch.stack(per_pos, dim=1)
    flat = logits.reshape(B * S, -1)

    def rep(t):
        return t.repeat_interleave(S, dim=0)

    # per-position step indices keep seeded rows aligned with the token
    # index, as the decode chunk's per-step increment does
    steps_flat = (sampling["steps"][:, None] + j[None, :]).reshape(-1)
    if sampling["bias"] is not None:
        flat = apply_logit_bias(flat, *map(rep, sampling["bias"]))
    if sampling["min_tok"] is not None:
        flat = suppress_stop_tokens(flat, steps_flat,
                                    *map(rep, sampling["min_tok"]))
    # row (b, j) verifies draft tokens[b, j+1]; the row at input_len - 1
    # (and any unused row past it) draws the plain bonus sample
    draft_next = torch.cat(
        [tokens[:, 1:], torch.zeros((B, 1), dtype=tokens.dtype, device=dev)],
        dim=1,
    )
    is_bonus = j[None, :] >= (input_lens[:, None] - 1)
    seeds = sampling["seeds"]
    flat_toks, _accept, lp = verify_and_sample(
        flat, draft_next.reshape(-1), is_bonus.reshape(-1),
        rep(sampling["temps"]), rep(sampling["top_ps"]),
        rep(sampling["top_ks"]), generator,
        seeds=None if seeds is None else rep(seeds), steps=steps_flat,
        num_top=num_logprobs, all_greedy=all_greedy,
    )
    model_toks = flat_toks.reshape(B, S)
    lp_data = None
    if lp is not None:
        lp_data = (lp[0].reshape(B, S), lp[1].reshape(B, S, -1),
                   lp[2].reshape(B, S, -1))
    accepted = count_accepted(model_toks, tokens, input_lens)
    if pen is not None:
        appended = (j[None, :] <= accepted[:, None]) & active[:, None]
        pen[0].index_put_(
            (rows[:, None].expand(B, S), model_toks.long()),
            appended.to(pen[0].dtype), accumulate=True,
        )
    return model_toks, accepted, lp_data


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
        # the watchdog's beat before each blocking gather (a stand-in
        # core without one, as the executor's tests use, is not watched)
        beat = getattr(core, "_beat", None)
        for i in range(0, len(pages), SWAP_CHUNK_PAGES):
            if beat is not None:
                beat("swap_readback",
                     batch=len(pages[i : i + SWAP_CHUNK_PAGES]))
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
    num_logprobs: int = 0, guard_threshold: Optional[float] = None,
) -> None:
    """``num_steps`` decode steps back to back on the device, without a
    host sync: the body the reference fuses with ``lax.scan``, and the
    body a CUDA graph captures (runtime/decode_graph.py).  It reads only
    ``state``'s static buffers and writes only to them: the sampled
    tokens to ``state.out_tokens[:num_steps]`` (with ``num_logprobs``
    also the chosen logprobs and the top ids and logprobs to
    ``state.out_lp`` / ``out_top_ids`` / ``out_top_lps``), the counts in
    place each step, and the advanced tokens, positions and steps at the
    end.  The pools are written in place.

    With ``guard_threshold`` (integrity.logit_guard on), each step's
    per-slot guard word over the RAW logits — before penalties, bias and
    min-token suppression, whose deliberate -1e30 writes would trip the
    saturation check — goes to ``state.out_flags[step]``, as the
    reference folds the guard into its chunk."""
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
        if guard_threshold is not None:
            state.out_flags[i].copy_(
                integrity.logit_guard(logits, guard_threshold)
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

    def wait(self) -> None:
        """Block until the copies are done (the one host wait)."""
        if self.event is not None:
            self.event.synchronize()

    def result(self) -> List[np.ndarray]:
        self.wait()
        return [h.numpy() for h in self.host]


def _release_device_state(old: "EngineCore") -> None:
    """Drop every reference the dead core holds to memory on the card or
    pinned on the host, but its weights: the KV pools, the decode state
    buffers, the decode graphs (their private pool goes with them), the
    host swap pool with its pinned chunks, and cuBLAS's workspaces (one a
    stream; ``stop`` already gave back its share of the kernels'
    scratch).  No other engine's graphs may replay after this in the
    process (a supervised process serves one engine): a graph captured
    earlier may use a cleared workspace.  The supervisor still holds the
    old core while its successor sizes its pool, so anything left here
    would be sized out of the new pool."""
    old.k_pages = None
    old.v_pages = None
    old._dec_state = None
    old._graphs = None
    old._pending_chunks.clear()
    old._spec_pen = None
    old._spec_mt = None
    # the draft model's weights and scratch pools; the successor loads
    # its own
    old.draft_model = None
    old.drafter = old._ngram_drafter
    # the host swap pool dies with its core: every parked ticket's epoch
    # went stale when containment folded the owners, and the new core
    # builds a fresh (empty) pool
    old.kv_swap = None
    old.scheduler.swap = None
    if old.radix_cache is not None:
        old.radix_cache.swap = None
    if old.stream is not None:
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()


def rebuild_core(
    old: "EngineCore",
    config: VGTConfig,
    reload_weights: bool = False,
) -> "EngineCore":
    """Tear a dead core down and construct its successor (the
    reference's ``rebuild_core``): stop the old core, release what it
    holds on the card BEFORE the new pool is sized (an auto-sized pool
    fills most of the card, and the old core stays referenced by its
    owner until the swap), and rebuild with the weights KEPT (the old
    tree is already quantized and on the card) or, with
    ``reload_weights``, reloaded.  The brownout flag that suspends
    prefix-tree inserts is carried over, and so are ``decode_graphs``
    and ``spec_suspended`` (a crash at brownout level >= 3 must not
    silently re-enable speculative decoding).
    The caller swaps it in, re-attaches ``on_fatal`` and starts it.  A
    successor of a warmed core is warmed before it is returned.

    A kept tree is first re-verified against its checksum baseline —
    restarting on a flipped tree would keep the corruption through every
    incarnation — and a mismatch raises :class:`IntegrityError` so the
    caller escalates to ``reload_weights=True``, which drops the old
    tree before the reload materializes a new one.  The reference's mesh
    argument (``devices``) is absent: the port serves one device."""
    old.stop()
    _release_device_state(old)
    old_integrity = getattr(old, "integrity", None)
    if (
        not reload_weights
        and old_integrity is not None
        and old_integrity.verifier is not None
        and old.params is not None
    ):
        mismatch = old_integrity.verifier.verify_all(old.params)
        if mismatch is not None:
            metrics.INTEGRITY_EVENTS.labels(
                kind="rebuild_verify_failed"
            ).inc()
            raise IntegrityError(
                "kept-weights rebuild verification failed: shard "
                f"{mismatch['leaf']!r} no longer matches its load-time "
                "checksum; escalate to a weight reload",
                kind="checksum_mismatch",
                detail=mismatch,
            )
    if reload_weights:
        # two full trees would not fit next to an auto-sized pool (the
        # verifier's leaf map holds the old tree's tensors too)
        old.params = None
        old.integrity = None
        metrics.CORRUPT_RELOADS.inc()
        metrics.INTEGRITY_EVENTS.labels(kind="corrupt_reload").inc()
        logger.warning(
            "rebuilding engine with a FULL WEIGHT RELOAD "
            "(corrupt-classified fatal; weights-kept would preserve "
            "the corruption)"
        )
        new_core = EngineCore(
            config, spec=old.spec, decode_graphs=old.decode_graphs
        )
    else:
        new_core = EngineCore(
            config, spec=old.spec, params=old.params,
            decode_graphs=old.decode_graphs,
        )
    new_core.spec_suspended = bool(getattr(old, "spec_suspended", False))
    new_core.set_prefix_insert_suspended(
        getattr(old, "prefix_insert_suspended", False)
    )
    if getattr(old, "warmed", None) is not None:
        # the old core's decode graphs died with its buffers (XLA keeps
        # its compiled programs across a rebuild; a graph is bound to
        # addresses): capture the warm-up's keys again before the
        # replay, so the replayed requests do not pay the captures
        # inside their window.  The captures go into the new core's
        # compile ledger.
        new_core.warmup(old.warmed)
    return new_core


def replay_into(
    core: "EngineCore",
    seq: Sequence,
    quarantine: set,
    retry_after: float = 1.0,
    kind: str = "resume",
    **tick_fields: Any,
) -> str:
    """Replay ONE checkpointed sequence into ``core`` (the reference's
    ``replay_into``): a quarantined fingerprint fails with the 400
    poison error, a refused resubmission with the retryable 503, and a
    success records the ``kind`` flight tick and, for a crash replay,
    ``vgt_resumed_sequences``.  Returns "replayed" | "quarantined" |
    "failed"."""
    fp = faults.fingerprint(seq.prompt_ids[: seq.orig_prompt_len])
    if fp in quarantine:
        metrics.LOST_SEQUENCES.labels(reason="quarantined").inc()
        seq.fail(
            PoisonRequestError(
                f"request {fp} was quarantined while its generation "
                "was checkpointed and will not be replayed"
            )
        )
        return "quarantined"
    try:
        core.submit_existing(seq)
    except Exception:
        logger.error("resume resubmission failed", exc_info=True)
        metrics.LOST_SEQUENCES.labels(reason="resubmit_failed").inc()
        seq.fail(
            EngineRecoveringError(
                "engine restarted but the checkpointed request could "
                "not be replayed; retry shortly",
                retry_after=retry_after,
            )
        )
        return "failed"
    if kind == "resume":
        metrics.RESUMED_SEQUENCES.inc()
    core.flight.record_tick(
        kind,
        seq_id=seq.seq_id,
        request_id=seq.request_id,
        tokens=seq.num_generated,
        attempt=seq.resume_count if kind == "resume" else seq.migrate_count,
        **tick_fields,
    )
    return "replayed"


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
        if self.config.model.quantization in ("int8", "int4"):
            # W8A8/W4A8 projections, threaded on the spec as the
            # reference does (models/decoder.py reads it)
            self.spec = dataclasses.replace(
                self.spec, int8_native=bool(dcfg.int8_native)
            )
        elif dcfg.int8_native:
            logger.warning(
                "device.int8_native has no effect without "
                "model.quantization (int8 or int4) — serving stays on the "
                "plain dtype path"
            )
        self.device = resolve_device(dcfg.device)
        # on the card every device call of this core runs on its own
        # stream, so a successor built after a stall never queues behind
        # its predecessor's work
        self.stream: Optional[torch.cuda.Stream] = (
            torch.cuda.Stream(self.device)
            if self.device.type == "cuda" else None
        )
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
            # a checkpoint (and a MoE random init) is quantized a layer
            # at a time as it loads: Mixtral's experts do not fit the
            # card in bf16
            params = load_or_init_params(
                self.spec, self.config.model.checkpoint_path, self.device,
                self.dtype, log_digests=self.config.integrity.enabled,
                quantization=self.config.model.quantization,
            )
        if self.config.model.quantization:
            params = quantize_params(
                params, self.spec, self.config.model.quantization
            )
            if self.spec.int8_native and self.device.type == "cuda":
                # W8A8's int8 product reads its weights along the
                # contracted dim (ops/quant.py k_major).  This rewrites
                # the tree in place: K4/K5 refuse that layout, so a tree
                # handed to a W8A8 engine on the card serves no
                # dequant-matmul engine afterwards.
                params = int8_native_layout(params)
        self.params = params
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.load_time_s = time.perf_counter() - load_start
        # silent-corruption defense (integrity.py): the sentinel scanner
        # and the weight-checksum baseline over the FINAL serving tree
        # (after quantization: the tree a supervised rebuild keeps).
        # None when disabled, so every probe site is one attribute check
        # and the decode chunk writes no guard word.
        icfg = self.config.integrity
        self.integrity: Optional[integrity.EngineIntegrity] = None
        if icfg.enabled:
            self.integrity = integrity.EngineIntegrity(
                icfg, self.spec.vocab_size
            )
            self.integrity.record_baseline(self.params)

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
        # flight recorder (observability/flight.py): per-tick and
        # per-request post-mortem rings; the supervisor snapshots it on
        # every crash and /debug serves it live
        self.flight = FlightRecorder(self.config.observability)
        # perf attribution (observability/perf.py): the per-tick phase
        # split, the compile ledger and the MFU / HBM-roofline gauges
        # from the engine's own geometry; rebuilt fresh with the core
        self.perf = PerfRecorder(
            self.config.observability,
            roofline=EngineRoofline(
                device_kind=(
                    torch.cuda.get_device_name(self.device)
                    if self.device.type == "cuda" else "cpu"
                ),
                num_chips=1,
                num_params=int(self.spec.num_params),
                weight_stream_bytes=stream_weight_bytes(
                    self.params, self.spec.tie_embeddings
                ),
                kv_token_bytes=kv_bytes_per_token(
                    self.spec.num_layers, self.spec.num_kv_heads,
                    self.spec.head_dim, dtype_bytes=kv_bytes,
                    scale_bytes=kv_scale_bytes,
                ),
            ),
        )
        # readback/containment mutual exclusion: every token-append
        # section holds it, and so does containment's checkpoint sweep,
        # so a stalled thread that wakes late never interleaves appends
        # with the fold of its sequences (the swap manager's publication
        # guard shares it)
        self._readback_lock = threading.Lock()
        self.prefix_insert_suspended = False
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
                lock=self._readback_lock,
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
            recorder=self.flight,
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
        self._init_speculation()
        self._submit_q: "queue.Queue[Sequence]" = queue.Queue()
        # held while a batch is queued and while the loop drains the
        # queue, so one ``generate`` batch is admitted as one wave
        self._submit_lock = threading.Lock()
        self._abort_q: "queue.Queue[tuple]" = queue.Queue()
        self._wakeup = threading.Event()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._fatal: Optional[BaseException] = None
        # hang-watchdog heartbeat, stamped as a whole dict around every
        # dispatch and readback (atomic under the GIL); ``compiling``
        # beats (a graph capture, a kernel's first build) get
        # recovery.compile_grace_s instead of step_stall_s
        self._heartbeat: Dict[str, Any] = {
            "t": time.monotonic(), "kind": "init", "compiling": True,
        }
        # set by declare_stalled: the engine thread is presumed stuck, so
        # stop() joins briefly instead of for 30 s
        self._stalled = False
        # only the first entry into containment runs (the watchdog and a
        # woken engine thread can both reach it)
        self._contain_lock = threading.Lock()
        # published at the end of containment, before on_fatal
        self._containment_done = False
        # in-flight sequences checkpointed by containment for the
        # supervisor to replay (take_checkpointed), and those it gave up
        # on (take_resume_losses)
        self._checkpointed: List[Sequence] = []
        self._resume_losses = 0
        self._resume_enabled = bool(self.config.recovery.resume_in_flight)
        self._max_resume_attempts = max(
            0, int(self.config.recovery.max_resume_attempts)
        )
        # flight snapshot taken on the dying engine thread
        self._crash_snapshot: Optional[Dict[str, Any]] = None
        # supervision hook (runtime/supervisor.py), called once after a
        # fatal error is contained; when set, owed futures fail with the
        # retryable EngineRecoveringError instead of the raw fault
        self.on_fatal: Optional[Callable[[BaseException], None]] = None
        # (fingerprint, resume_count) of the requests resident at death,
        # for the supervisor's poison heuristic
        self._fatal_suspects: List[tuple] = []
        # the buckets ``warmup`` walked (None before it ran): a supervised
        # rebuild warms the successor the same way
        self.warmed: Optional[List[int]] = None
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

    def _init_speculation(self) -> None:
        """Speculative decoding's state (runtime/speculative.py): the
        drafter (prompt lookup, or with ``model.draft_model_id`` a draft
        model on this engine's device; tests inject oracles through
        ``drafter``), the brownout flag, the counters and the
        membership-keyed device caches of the verify rounds."""
        dcfg = self.config.device
        self.spec_k = max(0, dcfg.speculative_k)
        self.spec_ngram = max(1, dcfg.speculative_ngram)
        # brownout level >= 3 (admission.py) suspends speculation at run
        # time: one bool read a tick, flipped from any thread by
        # set_spec_suspended
        self.spec_suspended = False
        self.drafter: Callable[[Sequence, int], List[int]] = (
            self._ngram_drafter
        )
        self.draft_model: Optional[DraftModelDrafter] = None
        draft_id = self.config.model.draft_model_id
        if draft_id and self.spec_k <= 0:
            logger.warning(
                "model.draft_model_id has no effect with "
                "device.speculative_k=0 — speculative decoding is off",
                extra={"extra_data": {"draft_model_id": draft_id}},
            )
        if self.spec_k > 0 and draft_id:
            self.draft_model = DraftModelDrafter(
                draft_id,
                k_max=self.spec_k,
                dtype=self.dtype,
                window=int(dcfg.draft_window),
                checkpoint_path=self.config.model.draft_checkpoint_path,
                target_vocab=self.spec.vocab_size,
                device=self.device,
                target_has_checkpoint=bool(
                    self.config.model.checkpoint_path
                ),
            )
            self.drafter = self.draft_model.draft_for
        self.total_spec_drafted = 0
        self.total_spec_accepted = 0
        self.total_spec_rounds = 0
        # the penalty histogram on the device, keyed by a membership
        # signature (rebuilt from the host token lists when membership
        # changes, updated by each round otherwise)
        self._spec_pen: Optional[Dict[str, Any]] = None
        # the membership's min-token and logit-bias arrays on the device
        self._spec_mt: Optional[Dict[str, Any]] = None
        self._compiled_spec: set = set()

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
            # a watchdog-declared stall means the thread is presumed
            # stuck (in a host wait or a device call): do not hold the
            # rebuild for 30 s on it (it is a daemon, and the epoch
            # checks discard whatever it does if it ever wakes)
            self._thread.join(timeout=1 if self._stalled else 30)
            self._thread = None
        # every owed future is resolved, checkpointed sequences nobody
        # claimed included
        checkpointed = self.take_checkpointed()
        for _ in checkpointed:
            metrics.LOST_SEQUENCES.labels(reason="shutdown").inc()
        owed = (
            list(self.scheduler.running)
            + list(self.scheduler.waiting)
            + checkpointed
        )
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
        if self.stream is not None:
            # this core's stream's share of the kernels' scratch (a
            # restart re-allocates it at the first use)
            _build.release_workspace(self.device, self.stream.cuda_stream)

    # ----------------------------------------------------------- submission

    def _fail_exception(self, exc: BaseException) -> BaseException:
        """The exception owed futures fail with after a fatal: a
        supervised engine (``on_fatal`` set) is about to restart, so
        clients get the retryable 503 type with the raw fault chained;
        an unsupervised one keeps the raw fault."""
        if self.on_fatal is None:
            return exc
        wrapped = EngineRecoveringError(
            f"engine crashed and is restarting: {exc}"
        )
        wrapped.__cause__ = exc
        return wrapped

    def _on_seq_settle(self, seq: Sequence) -> None:
        """The one settle observer (Sequence.finish/fail): closes the
        flight recorder's request record and the request's phase spans,
        on every settle path."""
        self.flight.on_close(seq)
        tr = seq.trace
        if tr is not None:
            if seq.error is None:
                tr.end("decode", tokens=seq.num_generated)
            # a failure leaves the phase span open so close() annotates
            # it with the exception
            tr.close(seq.error)

    def _enqueue(self, seq: Sequence) -> None:
        """Queue ``seq`` and wake the loop.  If the engine died between
        the caller's check and the put, its sweep may have missed this
        sequence: everything still queued fails here."""
        self._submit_q.put(seq)
        if self._fatal is not None:
            exc = self._fail_exception(self._fatal)
            while True:
                try:
                    orphan = self._submit_q.get_nowait()
                except queue.Empty:
                    break
                orphan.fail(exc)
            if seq.status is SeqStatus.FAILED:
                raise RuntimeError("engine is dead") from exc
        self._wakeup.set()

    def submit_tokens(
        self,
        prompt_ids: List[int],
        params: SamplingParams,
        stream_cb: Optional[Callable[[int], Any]] = None,
        meta: Optional[Any] = None,
    ) -> Sequence:
        """Queue one sequence.  ``meta`` (observability/reqtrace.py
        ``RequestMeta``) rides on the sequence with its request id; with
        the flight recorder on, the request's phase spans are parented
        on its trace context and its queue phase starts now."""
        if self._fatal is not None:
            raise RuntimeError("engine is dead") from self._fatal
        seq = Sequence(
            prompt_ids=list(prompt_ids), params=params, stream_cb=stream_cb
        )
        if meta is not None:
            seq.meta = meta
            seq.request_id = meta.request_id
        if self.flight.enabled:
            seq.on_settle = self._on_seq_settle
            if meta is not None:
                seq.trace = RequestTrace(meta)
                seq.trace.start("queue", start_pc=seq.arrival_t)
        self._enqueue(seq)
        return seq

    def submit_existing(self, seq: Sequence) -> None:
        """Re-admit a checkpointed sequence from another incarnation of
        the engine (the supervisor's replay), or the canary probe.  The
        SAME Sequence object rides in — its waiter, stream callback,
        cancel hooks and absolute deadline stay valid — re-wired to this
        core's settle observer, and prefilled-continue on admission
        (``prepare_resume`` folded its partial generation into the
        prompt).  A checkpoint taken under another KV format is
        refused."""
        if self._fatal is not None:
            raise RuntimeError("engine is dead") from self._fatal
        if (
            seq.kv_dtype is not None
            and seq.kv_dtype != self.geometry.kv_dtype
        ):
            raise ValueError(
                f"checkpoint was taken under kv dtype "
                f"{seq.kv_dtype!r} but this core serves "
                f"{self.geometry.kv_dtype!r}; refusing the replay"
            )
        seq.on_settle = (
            self._on_seq_settle if self.flight.enabled else None
        )
        self._enqueue(seq)

    def take_checkpointed(self) -> List[Sequence]:
        """Hand containment's checkpoint to its replayer (the
        supervisor); empty after."""
        out, self._checkpointed = self._checkpointed, []
        return out

    def take_resume_losses(self) -> int:
        """Sequences containment gave up on (already failed typed); the
        replayer folds the count into its lost total.  Zeroed, so
        repeated sweeps never count twice."""
        n, self._resume_losses = self._resume_losses, 0
        return n

    def encode_prompt(self, prompt: str) -> List[int]:
        """Prompt -> token ids, keeping the suffix when too long (split
        out so the supervisor can fingerprint a prompt for the poison
        quarantine before submission)."""
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
        return [self.result_dict(seq) for seq in seqs]

    def result_dict(self, seq: Sequence) -> Dict[str, Any]:
        """Wait for ``seq`` and return ``generate``'s result for it;
        raises its error when it failed."""
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
        return result

    # ------------------------------------------------------------- the loop

    def _loop(self) -> None:
        logger.info("engine thread started")
        # a kernel's first nvcc build on this thread is a compile pause
        _build.observe_builds(self._on_kernel_build)
        stream = (
            torch.cuda.stream(self.stream) if self.stream is not None
            else contextlib.nullcontext()
        )
        with stream:
            while self._running:
                try:
                    self._beat("tick")
                    # the phases measured inside the tick are taken from
                    # its wall; the rest is host time, so the five phases
                    # sum to the wall by construction
                    self.perf.tick_begin()
                    worked = self._tick()
                    self.perf.tick_end(worked)
                    if not worked:
                        self._wakeup.wait(timeout=0.005)
                        self._wakeup.clear()
                except Exception as exc:
                    logger.error("engine loop fatal error", exc_info=True)
                    self._contain_fatal(exc)
        _build.observe_builds(None)
        logger.info("engine thread stopped")

    def _beat(self, kind: str, compiling: bool = False, **fields) -> None:
        """Stamp the watchdog heartbeat just BEFORE a dispatch or a wait
        that can block, so a wedge there is what ages the beat;
        ``compiling`` widens the limit to recovery.compile_grace_s."""
        self._heartbeat = {
            "t": time.monotonic(),
            "kind": kind,
            "compiling": bool(compiling),
            **fields,
        }

    def _on_kernel_build(self, name: str, seconds: Optional[float]) -> None:
        """``_build.observe_builds`` callback: a build starting is a
        compiling beat; its end goes into the compile ledger."""
        if seconds is None:
            self._beat("kernel_build", compiling=True, kernel=name)
            return
        self.flight.record_tick("recompile", program="kernel", kernel=name)
        self.perf.record_compile("kernel", name, seconds,
                                 trigger="first_build")

    def _contain_fatal(self, exc: BaseException) -> bool:
        """Fatal containment, shared by the engine thread's crash handler
        and the watchdog's :meth:`declare_stalled`: record the crash tick
        and flight snapshot, collect poison suspects, then CHECKPOINT the
        resumable in-flight sequences for the supervisor to replay
        (``resume_in_flight`` under supervision) or fail every owed
        future.  First entry only (returns False otherwise): a stalled
        thread that wakes into the swept state raises and lands here
        again, and a second sweep would drop the checkpoint."""
        with self._contain_lock:
            if self._fatal is not None:
                logger.warning(
                    "fatal containment skipped: engine already contained",
                    extra={"extra_data": {
                        "error": f"{type(exc).__name__}: {exc}",
                        "first": (f"{type(self._fatal).__name__}: "
                                  f"{self._fatal}"),
                    }},
                )
                return False
            self._fatal = exc
        try:
            self._contain_body(exc)
        except Exception:  # pragma: no cover - defensive
            # containment failing must not strand the system: _fatal is
            # set, so the flag and on_fatal below must still run
            logger.error(
                "fatal containment raised; proceeding to publication "
                "with a possibly partial sweep",
                exc_info=True,
            )
            self._running = False
        self._containment_done = True
        if self.on_fatal is not None:
            try:
                self.on_fatal(exc)
            except Exception:  # pragma: no cover - defensive
                logger.error("on_fatal hook failed", exc_info=True)
        return True

    def _contain_body(self, exc: BaseException) -> None:
        """The containment work itself: snapshot, suspects, sweep."""
        self.flight.record_tick(
            "crash",
            error=f"{type(exc).__name__}: {exc}",
            batch=len(self.scheduler.running),
            queue_depth=len(self.scheduler.waiting),
        )
        self._crash_snapshot = self.flight.crash_snapshot(exc)
        # poison evidence: the requests resident at the crash, by their
        # ORIGINAL prompt, with their resume count (only fresh
        # submissions advance a poison streak); canaries never count
        self._fatal_suspects = [
            (
                faults.fingerprint(s.prompt_ids[: s.orig_prompt_len]),
                s.resume_count,
            )
            for s in self.scheduler.running
            if not s.canary
        ]
        checkpointing = self._resume_enabled and self.on_fatal is not None
        fail_exc: Optional[BaseException] = None
        kept: List[Sequence] = []
        # excluded from the token-append sections: a woken stalled thread
        # sees either the state before the fold (its epoch check passes
        # and this waits) or after it (epoch bumped, it skips).  Bounded
        # and fail-open: a wedge inside an append section (a stuck stream
        # callback) must not wedge the watchdog thread too.
        locked = self._readback_lock.acquire(timeout=5.0)
        if not locked:
            logger.error(
                "containment proceeding WITHOUT the readback lock "
                "(append section appears wedged); sequences mid-append "
                "may replay with a duplicated token"
            )
        try:
            doomed = list(self.scheduler.running) + list(
                self.scheduler.waiting
            )
            while True:
                try:
                    doomed.append(self._submit_q.get_nowait())
                except queue.Empty:
                    break
            for seq in doomed:
                if (
                    checkpointing
                    and not seq.abort_requested
                    and not seq.canary
                ):
                    if seq.resume_count >= self._max_resume_attempts:
                        metrics.LOST_SEQUENCES.labels(
                            reason="max_attempts"
                        ).inc()
                        self._resume_losses += 1
                        seq.fail(
                            ResumeExhaustedError(
                                "request was in flight across "
                                f"{seq.resume_count} engine restarts "
                                "and was given up on; retry shortly"
                            )
                        )
                        continue
                    if seq.trace is not None:
                        seq.trace.resumed()
                    # the pool format the sampling history ran under:
                    # submit_existing refuses a replay into another
                    seq.kv_dtype = self.geometry.kv_dtype
                    seq.prepare_resume()
                    kept.append(seq)
                    continue
                if fail_exc is None:
                    fail_exc = self._fail_exception(exc)
                seq.fail(fail_exc)
            self._checkpointed = kept
            self.scheduler.waiting.clear()
            for i in range(len(self.scheduler.slots)):
                self.scheduler.slots[i] = None
            self._pending_chunks.clear()
            self._running = False
        finally:
            if locked:
                self._readback_lock.release()

    def declare_stalled(self, exc: BaseException) -> bool:
        """Watchdog containment, called OFF the engine thread when the
        heartbeat went stale: the loop is presumed stuck in a wait that
        will never raise.  Stops the loop flag first (the stuck thread
        exits if it ever wakes), then runs the same containment as a
        crash on the thread.  The preempt-epoch checks of every readback
        discard what a merely-slow thread reads back late: each
        checkpointed sequence bumped its epoch.  Returns False when the
        engine already died or stopped another way."""
        if self._fatal is not None or not self._running:
            return False
        self._stalled = True
        self._running = False
        self._wakeup.set()
        hb = self._heartbeat
        self.flight.record_tick(
            "stall",
            phase=hb.get("kind"),
            stalled_s=round(time.monotonic() - hb.get("t", 0.0), 3),
            compiling=hb.get("compiling", False),
            batch=len(self.scheduler.running),
            queue_depth=len(self.scheduler.waiting),
        )
        return self._contain_fatal(exc)

    def _tick(self) -> bool:
        """One iteration: admit + prefill, then keep up to
        ``pipeline_depth`` decode chunks in flight, blocking only on the
        oldest one's readback.  Returns False when there was no work."""
        self._drain_submissions()
        # stall fault probe (faults.py): a `delay` armed here past
        # recovery.step_stall_s is a wedged loop for the hang watchdog;
        # probed only while work is resident, so arming it cannot stall
        # an idle engine into a pointless restart
        if faults.is_active() and self.scheduler.has_work():
            faults.check("stall")
            if not self._running:
                # the watchdog declared this core stalled while the delay
                # slept: containment swept the residents already, and
                # touching scheduler state now would race the replay
                return False
        self._drain_abort_requests()
        self._handle_aborts()
        self._handle_deadlines()
        # proactive prefix-cache trim: keep truly-free pages above the
        # evict watermark so allocation never pays the eviction walk
        self.scheduler.maybe_trim()
        if self.spec_k > 0 and not self.spec_suspended:
            # chunks dispatched while a brownout suspended speculation
            # are folded into host state before a round reads the last
            # tokens and positions; the rounds move tokens and positions
            # behind the decode state's back, so its signature is dropped
            # and the next chunk after a suspension reloads it
            if self._pending_chunks:
                self._process_chunks(drain=True)
            self._decode_signature_cache = None
            worked = self._admit_and_prefill()
            worked = self._tick_speculative() or worked
            if (
                self.integrity is not None
                and not worked
                and not self.scheduler.has_work()
            ):
                # idle-tick checksum sweep, speculative path
                self.integrity.idle_tick(self)
            return worked
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
        if (
            self.integrity is not None
            and not worked
            and not self._pending_chunks
            and not self.scheduler.has_work()
        ):
            # idle tick: advance the budgeted weight-checksum sweep, never
            # on a tick that did work and never with a chunk in flight.
            # A mismatch raises IntegrityError, which containment routes
            # to the supervisor as a `corrupt` fatal (a weight reload).
            self.integrity.idle_tick(self)
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
                    # where the budget went (flight recorder): the 504
                    # tells "queued forever" from "decoded slowly"
                    phases=self.flight.phases_of(seq),
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

    def _note_key(self, seen: set, key: tuple, kind: str, seqs=(),
                  **fields) -> bool:
        """``vgt_engine_compilations{kind}`` at the first sight of a
        static key, where the reference compiles a program (on the card a
        new decode key is a graph capture, and a prompt pass may build a
        kernel), with its flight tick and a span event on each request;
        returns whether the key is new."""
        if key in seen:
            return False
        seen.add(key)
        metrics.RECOMPILES.labels(kind=kind).inc()
        self.flight.record_tick("recompile", program=kind, **fields)
        for seq in seqs:
            if seq.trace is not None:
                seq.trace.event("compile", **fields)
        return True

    def _dispatched(self, kind: str, key: tuple, fresh: bool,
                    t0: float, trigger: str) -> None:
        """After an enqueue that began at ``t0``: its time into the
        tick's dispatch phase, and a new key's into the compile ledger
        (its dispatch ran the capture or the kernel build, on the card
        synchronously)."""
        dispatch_s = time.perf_counter() - t0
        self.perf.phase("dispatch", dispatch_s)
        if fresh:
            self.perf.record_compile(kind, key, dispatch_s, trigger=trigger)

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
        # stale-wake epochs: a watchdog-declared stall may checkpoint
        # (preempt_count bump) and replay these sequences while this
        # thread waits on the readback below, so the readback compares
        # the epoch taken here, not only the status
        plan_epochs = {id(plan): plan.seq.preempt_count for plan in plans}
        if self.flight.enabled:
            for plan in plans:
                seq = plan.seq
                preview = None
                if not self.flight.redact_prompts:
                    try:
                        preview = self.tokenizer.decode(seq.prompt_ids[:32])
                    except Exception:  # pragma: no cover - defensive
                        preview = None
                self.flight.on_admit(
                    seq, plan.bucket, plan.cached_len, preview=preview
                )
                if seq.trace is not None:
                    seq.trace.end("queue")
                    seq.trace.start(
                        "prefill", bucket=plan.bucket,
                        cached_tokens=plan.cached_len, chunked=plan.chunked,
                    )
        if faults.is_active():
            # fault probe: the payload is the request's ORIGINAL prompt,
            # so a poison fault can target one request
            for plan in plans:
                faults.check(
                    "prefill",
                    payload=tuple(
                        plan.seq.prompt_ids[: plan.seq.orig_prompt_len]
                    ),
                )
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
            stale = (
                plan.seq.status is not SeqStatus.RUNNING
                or plan.seq.preempt_count != plan_epochs[id(plan)]
            )
            self.scheduler.commit_prefill(plan, stale=stale)
        lps = [t for _, (_, lp) in dispatched if lp is not None for t in lp]
        readback = _Readback(
            torch.cat([t for _, (t, _) in dispatched]), *lps
        )
        self._beat("prefill_readback", batch=len(plans))
        # the perf split of the one wait this path has: the event wait
        # (device_s), then the host-side copy out (readback_s)
        readback_t0 = time.perf_counter()
        readback.wait()
        device_s = time.perf_counter() - readback_t0
        firsts, *lps = readback.result()
        readback_s = time.perf_counter() - readback_t0 - device_s
        self.perf.phase("device", device_s)
        self.perf.phase("readback", readback_s)
        # one combined dispatch and readback for the wave: each prompt
        # is observed with an equal share, as the reference does
        share = (time.perf_counter() - start) / len(plans)
        for plan in plans:
            metrics.observe_with_exemplar(
                metrics.ENGINE_STEP_TIME.labels(kind="prefill"), share,
                trace_id=getattr(plan.seq.trace, "trace_id", None),
            )
        detok_t0 = time.perf_counter()
        delivered = 0
        offset = 0
        for group, (tokens, lp) in dispatched:
            self.flight.record_tick(
                "prefill",
                batch=len(group),
                bucket=group[0].bucket,
                step_s=round(share * len(group), 6),
                device_s=round(device_s * len(group) / len(plans), 6),
                readback_s=round(readback_s * len(group) / len(plans), 6),
                kv_used=self.allocator.num_used,
                kv_free=self.allocator.num_free,
                queue_depth=len(self.scheduler.waiting),
            )
            lp_np = None
            if lp is not None:
                lp_np, lps = tuple(lps[:3]), lps[3:]
            # appends under the readback lock: the stale-wake guard is
            # check-then-append, and a containment fold must not
            # interleave with it
            with self._readback_lock:
                for row, plan in enumerate(group):
                    seq = plan.seq
                    if (
                        seq.status is not SeqStatus.RUNNING
                        or seq.preempt_count != plan_epochs[id(plan)]
                    ):
                        continue  # checkpointed by a declared stall
                    token = int(firsts[offset + row])
                    self.total_prefills += 1
                    if lp_np is not None and seq.params.logprobs:
                        self._attach_logprob(seq, lp_np, None, row)
                    # a RE-prefill keeps the original first_token_t; its
                    # phase boundary is now
                    fresh_first = seq.first_token_t is None
                    seq.append_token(token)
                    delivered += 1
                    self.flight.on_first_token(seq)
                    tr = seq.trace
                    if tr is not None:
                        boundary = (seq.first_token_t if fresh_first
                                    else time.perf_counter())
                        tr.end("prefill", end_pc=boundary)
                        tr.start("decode", start_pc=boundary)
                    self._maybe_finish(seq, token)
            offset += tokens.shape[0]
        self.perf.phase("detok", time.perf_counter() - detok_t0)
        self.perf.note_tokens(delivered)
        return True

    def _dispatch_swap_in(self, plan: SwapInPlan) -> None:
        """Re-admit a host-swapped preemption victim: its parked KV into
        the freshly allocated ``seq.pages`` (runtime/kv_swap.py), and it
        rejoins decode at the exact position it stopped: no prompt pass,
        no first-token readback (its last sampled token is the next
        decode feed).  Its new slot and epoch change the membership
        signature, so ``_build_decode_state`` uploads its row before the
        next chunk."""
        seq = plan.seq
        t0 = time.perf_counter()
        self._beat("swap_in", batch=1)
        n = self.kv_swap.swap_in_seq(seq, seq.pages)
        if self.flight.enabled:
            self.flight.on_admit(seq, bucket=0, cached_len=seq.total_len - 1)
            # mid-decode, not prefilling: straight to the decode phase
            self.flight.on_first_token(seq)
            if seq.trace is not None:
                seq.trace.end("queue")
                seq.trace.start("decode", swapped_in_pages=n)
        self.flight.record_tick(
            "swap_in",
            batch=1,
            pages=n,
            step_s=round(time.perf_counter() - t0, 6),
            kv_used=self.allocator.num_used,
            kv_free=self.allocator.num_free,
            queue_depth=len(self.scheduler.waiting),
            seq_id=seq.seq_id,
            request_id=seq.request_id,
        )

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
        key = (bucket, B, *key)
        fresh = self._note_key(
            self._compiled_buckets, key, "prefill",
            [p.seq for p in plans], bucket=bucket, batch=B,
        )
        self._beat("prefill", compiling=fresh, bucket=bucket, batch=B)
        t0 = time.perf_counter()
        self.total_prompt_passes += 1
        out = _prefill_step(
            self.params, self.spec, self._dev(tokens), self._dev(seq_lens),
            self.k_pages, self.v_pages, self._dev(prefill_pt),
            self._generator, sampling, num_lp,
        )
        self._dispatched("prefill", key, fresh, t0, trigger="bucket")
        return out

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
        key = _suffix_key(bucket, B, ctx_pages, *key, unaligned=unaligned)
        fresh = self._note_key(
            self._compiled_buckets, key, "prefill",
            [p.seq for p in plans], bucket=bucket, batch=B,
        )
        self._beat("prefill", compiling=fresh, bucket=bucket, batch=B)
        t0 = time.perf_counter()
        self.total_prompt_passes += 1
        out = _suffix_prefill_step(
            self.params, self.spec, self._dev(tokens), self._dev(prefix_lens),
            self._dev(suffix_lens), self.k_pages, self.v_pages,
            self._dev(suffix_pt), self._dev(ctx_pt), self._generator,
            sampling, unaligned=unaligned, num_logprobs=num_lp,
        )
        self._dispatched("prefill", key, fresh, t0,
                         trigger="cow" if unaligned else "prefix_hit")
        return out

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
            key = _suffix_key(chunk, 1, n_ctx, False, None, 0, None)
            fresh = self._note_key(
                self._compiled_buckets, key, "prefill", [seq],
                bucket=chunk, batch=1,
            )
            self._beat("prefill_chunk", compiling=fresh, bucket=chunk,
                       batch=1)
            t0 = time.perf_counter()
            prefill_suffix_forward(
                self.params, self.spec, self._dev(tokens),
                self._dev(np.asarray([start], np.int32)),
                self._dev(np.asarray([chunk], np.int32)),
                self.k_pages, self.v_pages, self._dev(pages),
                self._dev(ctx_pt),
            )
            self._dispatched("prefill", key, fresh, t0, trigger="chunk")
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
        faults.check("decode_step")
        state = self._dec_state
        num_lp = self._num_logprobs(active)
        all_greedy = self._all_greedy(active, num_lp)
        guard = self.integrity is not None and self.integrity.guard_enabled
        threshold = (
            self.config.integrity.saturate_threshold if guard else None
        )

        def body(st: DecodeState = state) -> None:
            _decode_chunk(
                self.params, self.spec, st, self.k_pages, self.v_pages,
                self._generator, num_steps=chunk,
                max_position=self.config.model.max_model_len - 1,
                all_greedy=all_greedy, num_logprobs=num_lp,
                guard_threshold=threshold,
            )

        key = state.key(chunk, all_greedy, num_lp)
        fresh = self._note_key(self._compiled_chunks, key, "decode", active,
                               chunk=chunk, batch=len(active))
        self._beat("decode", compiling=fresh, chunk=chunk, batch=len(active))
        t0 = time.perf_counter()
        if self.decode_graphs:
            self._graphs.run(key, body, lambda: body(state.scratch()))
        else:
            body()
        self._dispatched("decode", key, fresh, t0, trigger="chunk_variant")
        self.total_chunks += 1
        outs = [state.out_tokens[:chunk]]
        if num_lp:
            outs += [state.out_lp[:chunk], state.out_top_ids[:chunk],
                     state.out_top_lps[:chunk]]
        if guard:
            outs.append(state.out_flags[:chunk])
        # the preempt epoch: a sequence preempted (and maybe re-admitted)
        # or checkpointed while this chunk is in flight must not receive
        # its tokens
        self._pending_chunks.append(
            ([(s, s.preempt_count) for s in active], chunk,
             _Readback(*outs), bool(num_lp), guard)
        )

    def _process_chunks(self, drain: bool = False) -> None:
        """Fold the oldest in-flight chunk (all of them when ``drain``)
        into host state: the sentinel scan first, then append tokens (and
        their logprobs) in order, detect stops, discard steps past a
        stop."""
        while self._pending_chunks:
            seqs, chunk, readback, has_lp, guard = self._pending_chunks.pop(0)
            self._beat("decode_readback", chunk=chunk, batch=len(seqs))
            # the host-blocking readback time only: dispatch-to-now would
            # count the chunks queued ahead of this one.  The one wait is
            # split into the event wait (device_s) and the copy out.
            block_start = time.perf_counter()
            readback.wait()
            device_s = time.perf_counter() - block_start
            outs = readback.result()
            sampled = faults.corrupt_array("decode_step", outs[0])
            lp_np = tuple(outs[1:4]) if has_lp else None
            block_s = time.perf_counter() - block_start
            self.perf.phase("device", device_s)
            self.perf.phase("readback", block_s - device_s)
            if self.perf.enabled:
                self.perf.note_decode(
                    steps=chunk,
                    ctx_tokens=sum(s.total_len for s, _ in seqs),
                    device_s=device_s,
                )
            flags_np = None
            if self.integrity is not None and guard:
                flags_np = np.bitwise_or.reduce(outs[-1], axis=0)
                faults.check("logit_corrupt")
                flags_np = faults.corrupt_array("logit_corrupt", flags_np)
            if self.integrity is not None:
                # sentinel scan BEFORE any append or stream: a HARD trip
                # raises, discarding this whole chunk (already popped;
                # containment clears the rest), so no token sampled from
                # corrupt logits reaches a client; a SOFT trip (entropy
                # collapse) fails only its sequence.  Under the readback
                # lock: the status/epoch snapshot and the fail must not
                # interleave with a containment fold on another thread.
                with self._readback_lock:
                    live_rows = [
                        (s, s.slot) for s, epoch in seqs
                        if s.status is SeqStatus.RUNNING
                        and s.preempt_count == epoch
                    ]
                    for _kind, seq, soft_exc in self.integrity.scan_decode(
                        sampled, flags_np, live_rows, chunk
                    ):
                        self.scheduler.fail_sequence(seq, soft_exc)
            metrics.observe_with_exemplar(
                metrics.ENGINE_STEP_TIME.labels(kind="decode"),
                block_s,
                trace_id=next(
                    (s.trace.trace_id for s, _ in seqs
                     if s.trace is not None and s.trace.trace_id),
                    None,
                ),
            )
            self.flight.record_tick(
                "decode",
                batch=len(seqs),
                chunk=chunk,
                step_s=round(block_s, 6),
                device_s=round(device_s, 6),
                readback_s=round(block_s - device_s, 6),
                kv_used=self.allocator.num_used,
                kv_free=self.allocator.num_free,
                queue_depth=len(self.scheduler.waiting),
            )
            detok_t0 = time.perf_counter()
            delivered = 0
            # appends under the readback lock: the epoch guard is
            # check-then-append, and a containment fold on the watchdog
            # thread must not interleave with it
            with self._readback_lock:
                for seq, epoch in seqs:
                    if (
                        seq.status is not SeqStatus.RUNNING
                        or seq.preempt_count != epoch
                    ):
                        continue  # stopped, preempted or checkpointed
                    for k in range(chunk):
                        token = int(sampled[k, seq.slot])
                        if lp_np is not None and seq.params.logprobs:
                            self._attach_logprob(seq, lp_np, k, seq.slot)
                        seq.append_token(token)
                        self.total_decode_tokens += 1
                        delivered += 1
                        self._maybe_finish(seq, token)
                        if seq.status is not SeqStatus.RUNNING:
                            break
            self.perf.phase("detok", time.perf_counter() - detok_t0)
            self.perf.note_tokens(delivered)
            self.total_steps += chunk
            if not drain:
                break

    # ---------------------------------------------------------- speculative

    def _ngram_drafter(self, seq: Sequence, k: int) -> List[int]:
        """The default drafter: prompt lookup over the sequence's own
        history, with an index that grows with it."""
        index = getattr(seq, "_ngram_index", None)
        if index is None or index.ngram != self.spec_ngram:
            index = NgramIndex(self.spec_ngram)
            seq._ngram_index = index  # incremental; dies with the seq
        return index.draft(seq.prompt_ids + seq.output_ids, k)

    def _tick_speculative(self) -> bool:
        """One speculative round (``device.speculative_k`` > 0): draft up
        to k tokens a sequence, verify them all in ONE forward, and
        append each row's accepted run plus the model's bonus token.  A
        round advances a sequence by 1..k+1 tokens; with no drafts it is
        exactly a decode step.  Host-driven and eager (acceptance is
        data-dependent, so positions feed back through the host): the
        round's width S is the drafted maximum rounded up to a power of
        two, and the page-table width the live maximum rounded the same
        way."""
        active = self._running_seqs()
        if not active:
            return False
        S = self.spec_k + 1
        if not self.scheduler.prepare_decode(active, horizon=S):
            return True  # preemption changed membership; retry next tick
        active = self._running_seqs()
        if not active:
            return True
        B = self.max_slots
        max_len = self.config.model.max_model_len
        if (
            self.draft_model is not None
            and self.draft_model.total_draft_calls == 0
        ):
            # the drafter's first call may build a kernel: a compile
            # beat, so the watchdog does not judge it against
            # step_stall_s
            self._beat("draft", compiling=True)
        tokens = np.zeros((B, S), np.int32)
        positions0 = np.zeros((B,), np.int32)
        input_lens = np.ones((B,), np.int32)
        active_mask = np.zeros((B,), bool)
        temps = np.zeros((B,), np.float32)
        top_ps = np.ones((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        seeds = np.full((B,), -1, np.int64)
        steps = np.zeros((B,), np.int32)
        for seq in active:
            slot = seq.slot
            row = self._page_tables_np[slot]
            row[:] = 0
            row[: len(seq.pages)] = seq.pages
            tokens[slot, 0] = seq.output_ids[-1]
            positions0[slot] = seq.total_len - 1
            active_mask[slot] = True
            temps[slot] = seq.params.temperature
            top_ps[slot] = seq.params.top_p
            top_ks[slot] = seq.params.top_k
            if seq.params.seed is not None:
                seeds[slot] = seq.params.seed
            steps[slot] = seq.num_generated
            # acceptance + bonus never exceeds input_len, so capping the
            # input at the remaining budget and length bounds overshoot
            room = min(
                S,
                max(1, seq.params.max_tokens) - seq.num_generated,
                max_len - seq.total_len + 1,
            )
            if room > 1:
                # greedy and sampled sequences both draft
                draft = self.drafter(seq, room - 1)
                if draft:
                    tokens[slot, 1 : 1 + len(draft)] = draft
                    input_lens[slot] = 1 + len(draft)
        # a round with few drafts runs a narrower verify: widths are
        # powers of two, so a no-draft round costs a decode step
        S_round = 1 << (max(1, int(input_lens.max())) - 1).bit_length()
        S_round = max(1, min(S, S_round))
        # the context window bucketed to the live maximum (a power of two
        # in pages): K3 reads the table only below each row's length, the
        # plain version gathers the whole width
        w_needed = max(len(seq.pages) for seq in active)
        width = self._page_tables_np.shape[1]
        if w_needed < width:
            width = min(width, 1 << (max(1, w_needed) - 1).bit_length())
            width = max(width, w_needed)
        host: Dict[str, Any] = {}

        def row_host() -> Dict[str, Any]:
            if not host:
                host.update(self._row_host(B, ((s.slot, s) for s in active)))
            return host

        want_pen = any(s.params.has_penalties for s in active)
        if want_pen:
            sig = tuple((s.seq_id, s.slot, s.preempt_count) for s in active)
            if self._spec_pen is None or self._spec_pen["sig"] != sig:
                h = row_host()
                self._spec_pen = {
                    "sig": sig,
                    "pen": tuple(map(self._dev, (
                        h["counts"], h["freq_pens"], h["pres_pens"]))),
                }
        else:
            self._spec_pen = None
        mt_sig = tuple((s.seq_id, s.slot) for s in active)
        if self._spec_mt is None or self._spec_mt["sig"] != mt_sig:
            h = row_host()
            self._spec_mt = {"sig": mt_sig}
            for name in ("min_tok", "bias"):
                self._spec_mt[name] = (
                    None if h[name] is None
                    else tuple(map(self._dev, h[name]))
                )
        faults.check("decode_step")
        # stale-wake epochs for the readback below (a stall declared
        # while this thread waits may checkpoint and replay these)
        spec_epochs = {s.seq_id: s.preempt_count for s in active}
        start = time.perf_counter()
        num_lp = self._num_logprobs(active)
        all_greedy = self._all_greedy(active, num_lp)
        spec_key = (S_round, width, num_lp, all_greedy, want_pen)
        fresh = spec_key not in self._compiled_spec
        self._beat("spec_verify", compiling=fresh, chunk=S_round,
                   batch=len(active))
        self._compiled_spec.add(spec_key)
        sampling = {
            "temps": self._dev(temps),
            "top_ps": self._dev(top_ps),
            "top_ks": self._dev(top_ks),
            "seeds": self._dev(seeds) if (seeds >= 0).any() else None,
            "steps": self._dev(steps),
            "min_tok": self._spec_mt["min_tok"],
            "bias": self._spec_mt["bias"],
        }
        t0 = time.perf_counter()
        model_toks, accepted, lp_data = _spec_verify_step(
            self.params, self.spec,
            self._dev(np.ascontiguousarray(tokens[:, :S_round])),
            self._dev(positions0), self._dev(input_lens),
            self.k_pages, self.v_pages,
            self._dev(np.ascontiguousarray(self._page_tables_np[:, :width])),
            self._dev(active_mask), self._generator, sampling,
            pen=self._spec_pen["pen"] if want_pen else None,
            num_logprobs=num_lp, all_greedy=all_greedy,
        )
        self._dispatched("spec_verify", spec_key, fresh, t0,
                         trigger="spec_width")
        self.total_spec_rounds += 1
        readback = _Readback(model_toks, accepted,
                             *(lp_data if lp_data is not None else ()))
        self._beat("spec_readback", chunk=S_round, batch=len(active))
        # the perf split of the one wait: the event wait (device_s),
        # then the copy out (readback_s)
        device_t0 = time.perf_counter()
        readback.wait()
        device_s = time.perf_counter() - device_t0
        toks_np, acc_np, *lps = readback.result()
        lp_np = None
        if lp_data is not None:
            # step-major, so _attach_logprob's [step][slot] applies
            lp_np = (lps[0].T, np.transpose(lps[1], (1, 0, 2)),
                     np.transpose(lps[2], (1, 0, 2)))
        spec_s = time.perf_counter() - start
        readback_s = time.perf_counter() - device_t0 - device_s
        self.perf.phase("device", device_s)
        self.perf.phase("readback", readback_s)
        if self.perf.enabled:
            self.perf.note_decode(
                steps=1,
                ctx_tokens=sum(s.total_len for s in active),
                device_s=device_s,
            )
        metrics.observe_with_exemplar(
            metrics.ENGINE_STEP_TIME.labels(kind="decode"),
            spec_s,
            trace_id=next(
                (s.trace.trace_id for s in active
                 if s.trace is not None and s.trace.trace_id),
                None,
            ),
        )
        self.flight.record_tick(
            "spec_verify",
            batch=len(active),
            chunk=S_round,
            step_s=round(spec_s, 6),
            device_s=round(device_s, 6),
            readback_s=round(readback_s, 6),
            kv_used=self.allocator.num_used,
            kv_free=self.allocator.num_free,
            queue_depth=len(self.scheduler.waiting),
        )
        detok_t0 = time.perf_counter()
        delivered = 0
        # appends under the readback lock, each sequence checked against
        # the epoch taken at dispatch (see _admit_and_prefill)
        with self._readback_lock:
            for seq in active:
                if (
                    seq.status is not SeqStatus.RUNNING
                    or seq.preempt_count != spec_epochs[seq.seq_id]
                ):
                    continue
                slot = seq.slot
                self.total_spec_drafted += int(input_lens[slot]) - 1
                self.total_spec_accepted += int(acc_np[slot])
                # model_toks[:, j] for j < accepted IS draft j+1; position
                # `accepted` holds the bonus token
                for j in range(int(acc_np[slot]) + 1):
                    token = int(toks_np[slot, j])
                    if lp_np is not None and seq.params.logprobs:
                        self._attach_logprob(seq, lp_np, j, slot)
                    seq.append_token(token)
                    self.total_decode_tokens += 1
                    delivered += 1
                    self._maybe_finish(seq, token)
                    if seq.status is not SeqStatus.RUNNING:
                        break
        self.perf.phase("detok", time.perf_counter() - detok_t0)
        self.perf.note_tokens(delivered)
        self.total_steps += 1
        return True

    def set_spec_suspended(self, flag: bool) -> None:
        """Brownout L3 (admission.py): suspend or resume speculative
        decoding without a rebuild.  Safe from any thread (a bool store):
        the loop reads the flag every tick, and the first round after a
        resume folds the decode chunks in flight."""
        self.spec_suspended = bool(flag)

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
        self.warmed = buckets
        return time.perf_counter() - start

    def capture_profile(
        self, duration_s: float = 1.0, out_dir: Optional[str] = None
    ) -> Dict[str, Any]:
        """Capture a ``torch.profiler`` trace (host ops and, on the card,
        every kernel through CUPTI) while serving continues, written as a
        Chrome trace into ``out_dir`` (default: a new directory under the
        system temp dir), as the reference captures a ``jax.profiler``
        trace."""
        out_dir = out_dir or os.path.join(
            tempfile.gettempdir(), f"vgt_profile_{int(time.time())}"
        )
        duration_s = max(0.05, min(duration_s, 60.0))
        os.makedirs(out_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        capture_start = time.time()
        with torch.profiler.profile(activities=activities) as prof:
            time.sleep(duration_s)
        prof.export_chrome_trace(
            os.path.join(out_dir, f"trace_{int(capture_start)}.json")
        )
        # count only files this capture wrote (out_dir may be reused)
        n_files = sum(
            1
            for root, _, files in os.walk(out_dir)
            for f in files
            if os.path.getmtime(os.path.join(root, f)) >= capture_start - 1
        )
        result = {
            "trace_dir": out_dir,
            "duration_s": duration_s,
            "files": n_files,
        }
        # the flight ring shows when the window sat relative to captures
        # and sheds; /debug/perf reports the last capture
        self.flight.record_tick("profile", **result)
        self.perf.note_profile(result)
        return result

    def perf_snapshot(self) -> Dict[str, Any]:
        """The /debug/perf payload (observability/perf.py): the per-tick
        phase window, the compile ledger, the live MFU / roofline gauges
        and the last profile capture."""
        return self.perf.snapshot()

    def set_prefix_insert_suspended(self, flag: bool) -> None:
        """Brownout L4 (admission.py "bypass cache writes"): stop
        inserting into the prefix tree, keep serving hits.  Safe from
        any thread (a bool store); carried across supervised rebuilds."""
        self.prefix_insert_suspended = bool(flag)
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
            "flight": self.flight.get_stats(),
            "perf": self.perf.get_stats(),
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
            **(
                {"integrity": self.integrity.stats()}
                if self.integrity is not None
                else {}
            ),
            **(
                {"speculative": self._spec_stats()}
                if self.spec_k > 0
                else {}
            ),
        }

    def _spec_stats(self) -> Dict[str, Any]:
        """``get_stats()["speculative"]``: the reference's keys, plus
        the verify rounds run."""
        out: Dict[str, Any] = {
            "k": self.spec_k,
            "drafter": (
                f"draft-model:{self.draft_model.spec.name}"
                if self.draft_model is not None
                else f"ngram:{self.spec_ngram}"
            ),
        }
        if self.draft_model is not None:
            out["draft_calls"] = self.draft_model.total_draft_calls
        out.update(
            drafted=self.total_spec_drafted,
            accepted=self.total_spec_accepted,
            acceptance_rate=round(
                self.total_spec_accepted / max(1, self.total_spec_drafted),
                3,
            ),
            rounds=self.total_spec_rounds,
            suspended=self.spec_suspended,
        )
        return out
