"""Continuous-batching scheduler.

Replaces the stop-the-world batch lock at the heart of the reference
(vgate/batcher.py:79,195 serializes every batch behind one asyncio.Lock,
SURVEY.md section 7 step 4) with per-step admission: the decode loop owns
the device, and between decode steps the scheduler admits waiting prompts
into free slots, allocates KV pages on demand, and preempts under memory
pressure.

Pure host-side policy, no JAX: fully unit-testable (SURVEY.md section 4's
CPU-only strategy).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Union

import numpy as np

from vgate_tpu_torch.runtime import engine_metrics as metrics
from vgate_tpu_torch.errors import DeadlineExceededError, KVCapacityError
from vgate_tpu_torch.logging_config import get_logger
from vgate_tpu_torch.runtime.kv_cache import PageAllocator
from vgate_tpu_torch.runtime.kv_swap import KVSwapManager, SwapTicket
from vgate_tpu_torch.runtime.radix_cache import RadixCache, RadixMatch
from vgate_tpu_torch.runtime.sequence import Sequence, SeqStatus
from vgate_tpu_torch.utils.math import bucket_for, cdiv, round_up

logger = get_logger(__name__)

# Threading contract (scripts/vgt_lint.py, thread-discipline): the
# scheduler is engine-thread-owned state; cross-module resolution for
# self.radix.* / self.swap.* calls.
VGT_COMPONENTS = {"radix": "RadixCache", "swap": "KVSwapManager"}


def _rank(seq: "Sequence") -> int:
    """Priority-tier rank from the request's SamplingParams
    (vgate_tpu_torch/admission.py: 0 interactive, 1 standard, 2 batch);
    direct engine callers without the field schedule as standard.
    Integrity canary self-probes rank ahead of every tier: a replica's
    fitness check must not queue behind the very traffic it gates
    (vgate_tpu_torch/integrity.py CanaryKeeper)."""
    if seq.canary:
        return -1
    return getattr(seq.params, "priority", 1)


class EngineBusyError(RuntimeError):
    """Raised at admission when the waiting queue is full (load shedding,
    SURVEY.md section 5.3: 'add deadlines/load-shedding at admission')."""

    # the 503 body's machine-readable flavor (vgate_tpu_torch/errors.py)
    reason = "overloaded"


class AdmissionDeadlineExceeded(EngineBusyError):
    """A queued request waited past ``scheduler.admission_deadline_ms`` and
    was shed instead of admitted (the completion would arrive too late to
    be useful; SURVEY.md section 5.3)."""


@dataclass
class PrefillPlan:
    seq: Sequence
    slot: int
    bucket: int  # padded sequence length for this prefill program
    # prefix-cache reuse: the first cached_len prompt tokens' KV is already
    # resident in shared pages; only the suffix needs the prompt pass.
    # `bucket` then buckets the SUFFIX length, and register_hashes lists
    # (page, chain_hash) pairs to index once this prefill is dispatched.
    # With the radix tree, cached_len may be UNALIGNED (full shared pages
    # plus a copy-on-write partial page) and register_hashes stays None —
    # radix_insert/cow carry the tree bookkeeping instead.
    cached_len: int = 0
    register_hashes: list = None  # type: ignore[assignment]
    # chunked prefill: the (suffix) prompt exceeds the bucket cap and
    # runs as SERIAL suffix passes of `bucket` tokens each
    # (engine_core._dispatch_chunked_prefill)
    chunked: bool = False
    # copy-on-write partial page: (src_page, dst_page, shared_tokens) —
    # the engine device-copies the first shared_tokens of src into dst
    # (the sequence's own page) BEFORE dispatching the suffix prefill,
    # then prefill starts mid-page at cached_len
    cow: tuple = None  # type: ignore[assignment]
    # radix commit data snapshotted at admission: (tokens, pages) of the
    # full prompt pages this prefill makes indexable, plus the match
    # handle whose COW lock commit_prefill releases.  Snapshotted so a
    # containment fold between dispatch and commit cannot skew it.
    radix_insert: tuple = None  # type: ignore[assignment]
    radix_match: RadixMatch = None  # type: ignore[assignment]


@dataclass
class SwapInPlan:
    """Re-admission of a host-swapped preemption victim
    (runtime/kv_swap.py): the engine scatters the parked KV into the
    freshly-allocated ``seq.pages`` and the sequence rejoins decode at
    the exact position it stopped — no prefill program, no first-token
    sampling (its last sampled token is the decode feed)."""

    seq: Sequence
    slot: int
    ticket: SwapTicket


@dataclass
class DecodePlan:
    seqs: List[Sequence]  # active sequences, indexed by slot in .slot


Plan = Union[PrefillPlan, SwapInPlan, DecodePlan]


class Scheduler:
    def __init__(
        self,
        allocator: PageAllocator,
        max_slots: int,
        page_size: int,
        prefill_buckets: List[int],
        max_model_len: int,
        max_queue_size: int = 512,
        preempt_on_oom: bool = True,
        admission_deadline_ms: float = 0.0,
        prefix_cache: bool = False,
        prefill_chunk: int = 0,
        text_fn=None,
        recorder=None,
        radix: Optional[RadixCache] = None,
        cache_aware_sched: bool = True,
        insert_generated: bool = True,
        evict_watermark: float = 0.0,
        swap: Optional[KVSwapManager] = None,
    ) -> None:
        # optional flight recorder (observability/flight.py): residency
        # events (preempt/shed/abort) become post-mortem ring entries
        self.recorder = recorder
        # renders a sequence's partial generation for deadline-shed
        # metadata (the engine injects tokenizer.decode-backed
        # final_text); None keeps queued sheds text-less.  A preempted
        # sequence shed from the WAITING queue can hold generated
        # tokens, and its 504 must carry them like a running shed's.
        self.text_fn = text_fn
        self.allocator = allocator
        self.page_size = page_size
        # buckets: page-aligned, capped at max_model_len, and always
        # including a top bucket that can hold any admissible prompt
        # (preempted sequences re-prefill with their grown context).
        # With chunked prefill (prefill_chunk > 0) the ladder caps at the
        # chunk size instead, and longer prompts run serial suffix passes
        # of top-bucket tokens each.
        top = round_up(max_model_len, page_size)
        if prefill_chunk > 0:
            top = min(top, round_up(prefill_chunk, page_size))
        self.prefill_chunk = prefill_chunk
        aligned = {
            min(round_up(b, page_size), top)
            for b in prefill_buckets
            if b > 0
        }
        aligned.add(top)
        self.prefill_buckets = sorted(aligned)
        self.max_model_len = max_model_len
        self.max_queue_size = max_queue_size
        self.preempt_on_oom = preempt_on_oom
        self.admission_deadline_ms = admission_deadline_ms
        self.total_deadline_shed = 0
        self.prefix_cache = prefix_cache
        # radix-tree prefix index (runtime/radix_cache.py): replaces the
        # flat hash chain when provided; None keeps the r2-era flat
        # whole-page chain (still constructible for comparison)
        self.radix = radix if prefix_cache else None
        self.cache_aware_sched = bool(cache_aware_sched)
        self.insert_generated = bool(insert_generated)
        # proactive trim target in PAGES (0 disables): the engine tick
        # calls maybe_trim() so eviction walks run off the allocation
        # hot path, before admission's kv_pressure watermark engages
        self._trim_target = 0
        if self.radix is not None and evict_watermark > 0:
            self._trim_target = int(
                evict_watermark * allocator.num_allocatable
            )
        self.total_prefix_hit_tokens = 0
        self.waiting: Deque[Sequence] = deque()
        # sticky: set once any deadline-bearing sequence is ever queued,
        # so deployments without client deadlines skip _shed_expired's
        # per-tick queue scan entirely (try_admit runs in a tight loop
        # on the engine thread)
        self._deadline_seen = False
        # sticky twin for priority tiers: until a non-standard-priority
        # sequence is queued, admission selection stays head-of-queue
        self._priority_seen = False
        self.slots: List[Optional[Sequence]] = [None] * max_slots
        # host-RAM KV swap tier (runtime/kv_swap.py): preemption parks
        # the victim's pages instead of recomputing, re-admission
        # swaps them back in; None keeps the pre-swap engine
        # byte-identical (kv_cache.host_swap_bytes = 0)
        self.swap = swap
        self.total_preemptions = 0
        self.total_swap_preempts = 0
        self.total_preempt_recompute_tokens = 0
        self.total_admitted = 0
        self.total_finished = 0
        self.total_aborted = 0
        # sequences folded + staged for a prefill→decode handoff
        self.total_handoff_holds = 0

    # -- admission --

    def add(self, seq: Sequence) -> None:
        if (
            len(self.waiting) >= self.max_queue_size
            and seq.resume_count == 0
            and seq.migrate_count == 0
            # a handoff-adopted sequence (disaggregated prefill→decode)
            # was likewise already admitted on its prefill worker
            and seq.handoff_count == 0
            # integrity canaries bypass too: a self-probe rejected by an
            # overload gate would read as a corruption verdict and tear
            # down a merely-busy replica (one tiny greedy probe cannot
            # meaningfully deepen a 512-entry queue)
            and not seq.canary
        ):
            # replayed sequences (resume_count > 0: checkpointed across
            # an engine restart / dp failover; migrate_count > 0:
            # planned drain/rebalance movement) bypass the queue-full
            # gate — they were ALREADY admitted once and their clients
            # are still owed an answer; shedding them here would turn a
            # survivable restart (or a routine rolling deploy) into a
            # 503 exactly when the surviving queue is busiest.  Bounded:
            # at most slots+queue sequences existed on the source, so
            # the overshoot is one queue's worth.
            raise EngineBusyError(
                f"engine queue full ({self.max_queue_size} waiting)"
            )
        if seq.num_prompt_tokens >= self.max_model_len:
            raise ValueError(
                f"prompt of {seq.num_prompt_tokens} tokens exceeds "
                f"max_model_len={self.max_model_len}"
            )
        if seq.deadline_t is not None:
            self._deadline_seen = True
        if _rank(seq) != 1 and not seq.canary:
            # sticky, like _deadline_seen: deployments without priority
            # tiers keep the O(1) head-of-queue admission path.  The
            # engine's own canary probes (rank -1) don't flip it — one
            # boot probe must not tax every client admission for the
            # process lifetime; canaries only run on idle engines, so
            # queue position is moot for them.
            self._priority_seen = True
        self.waiting.append(seq)
        metrics.ENGINE_QUEUE_DEPTH.set(len(self.waiting))

    # -- queries --

    @property
    def running(self) -> List[Sequence]:
        return [s for s in self.slots if s is not None]

    def has_work(self) -> bool:
        return bool(self.waiting) or any(
            s is not None for s in self.slots
        )

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def has_admissible_waiting(self) -> bool:
        """True when the head-of-queue prompt could actually be admitted
        right now: a free slot exists AND its pages are allocatable.
        The engine's admission-pressure signals (re-tick without napping,
        decode-chunk cap) key off this — page-exhausted queues must NOT
        shrink chunks or spin, since admission is blocked on a sequence
        finishing, not on loop latency."""
        head = self._select_next()
        if head is None or self._free_slot() is None:
            return False
        if self.swap is not None:
            # a swapped-out head re-admits via swap-in: exactly the
            # parked page count, no prefix sharing (probe only — a
            # stale ticket falls through to the prefill math below,
            # which is consistent because staleness implies the fold
            # already moved the generation into the prompt)
            ticket = getattr(head, "_swap_ticket", None)
            if (
                ticket is not None
                and head.preempt_count == ticket.epoch
            ):
                return self.allocator.num_free >= ticket.num_pages
        n_pages = cdiv(max(1, head.num_prompt_tokens), self.page_size)
        if self.radix is not None:
            # mirror try_admit's radix accounting: matched pages are
            # shared, not allocated, but matched pages of UNLOCKED
            # nodes currently count toward num_free and a real match
            # would revive them out of that pool — subtract those or
            # this predicate would say "admissible" where allocate()
            # then fails (busy-spin + needless decode-chunk shrink)
            full, evictable = self._radix_probe(head)
            return (
                self.allocator.num_free - evictable >= n_pages - full
            )
        if self.prefix_cache:
            # mirror try_admit's accounting: resident prefix pages are
            # shared, not allocated (peek — no refcount mutation).  A
            # matched page that is currently EVICTABLE counts toward
            # num_free, but try_admit's lookup() would revive it out of
            # that pool — subtract those or this predicate would say
            # "admissible" where allocate() then fails (busy-spin +
            # needless decode-chunk shrink).
            matched_evictable = 0
            for h in self._prefix_chain(head):
                page = self.allocator.peek(h)
                if page is None:
                    break
                n_pages -= 1
                if self.allocator.is_evictable(page):
                    matched_evictable += 1
            return (
                self.allocator.num_free - matched_evictable >= n_pages
            )
        return self.allocator.num_free >= n_pages

    # -- planning --

    def schedule(self) -> Optional[Plan]:
        """Pick the next device program: prefill-priority admission, else a
        decode step over the active slots.

        Convenience wrapper composing the two primitives the engine loop
        calls directly (``try_admit`` for async prefill dispatch and
        ``prepare_decode`` with a chunk horizon — engine_core.py:_tick);
        kept for simple single-step drivers and tests."""
        plan = self.try_admit()
        if plan is not None:
            return plan
        active = self.running
        if not active:
            return None
        if self.prepare_decode(active):
            # preemption may have emptied the slots
            active = self.running
            if active:
                return DecodePlan(seqs=active)
        return self.try_admit()  # everything preempted; try re-admission

    def _shed_expired(self) -> None:
        """Fail queued sequences whose deadline has passed (their
        completion would arrive too late to be useful).  Two deadlines
        apply: the global admission deadline (preempted sequences are
        exempt — they were already admitted once and hold generated
        tokens the client is owed) and each request's own end-to-end
        deadline (``seq.deadline_t``; applies unconditionally — the
        client's budget is blown either way)."""
        if not self.admission_deadline_ms and not self._deadline_seen:
            return
        admission_s = self.admission_deadline_ms / 1000.0
        now = time.perf_counter()
        kept: Deque[Sequence] = deque()
        shed = 0
        for seq in self.waiting:
            if seq.past_deadline(now):
                waited = (now - seq.arrival_t) * 1000
                partial_text = ""
                if seq.num_generated and self.text_fn is not None:
                    # preempted sequences re-enter the queue carrying
                    # generated tokens — their shed metadata must be as
                    # complete as a running shed's
                    try:
                        partial_text = self.text_fn(seq)
                    except Exception:  # pragma: no cover - defensive
                        pass
                self._event(
                    "shed", seq, where="queued",
                    partial_tokens=seq.num_generated,
                )
                # phase attribution from the recorder when attached: a
                # PREEMPTED sequence re-queued here spent most of its
                # budget computing, and reporting the whole lifetime as
                # queue_s would misattribute it
                if self.recorder is not None:
                    phases = self.recorder.phases_of(seq)
                else:
                    phases = {"queue_s": round(waited / 1000.0, 6)}
                self._discard_swap(seq, "settled")
                seq.fail(
                    DeadlineExceededError(
                        f"request deadline "
                        f"({seq.params.timeout_s:.3f}s) passed after "
                        f"{waited:.0f}ms in queue, before generation "
                        "could finish",
                        partial_text=partial_text,
                        partial_tokens=seq.num_generated,
                        deadline_s=seq.params.timeout_s or 0.0,
                        phases=phases,
                    )
                )
                metrics.CANCELLED_REQUESTS.labels(reason="deadline").inc()
                metrics.DEADLINE_PARTIAL_TOKENS.observe(seq.num_generated)
                shed += 1
            elif (
                self.admission_deadline_ms
                and seq.preempt_count == 0
                and now - seq.arrival_t > admission_s
            ):
                self._event("shed", seq, where="admission")
                seq.fail(
                    AdmissionDeadlineExceeded(
                        f"request waited {(now - seq.arrival_t) * 1000:.0f}ms "
                        f"in queue (> {self.admission_deadline_ms:.0f}ms "
                        "admission deadline)"
                    )
                )
                shed += 1
            else:
                kept.append(seq)
        if shed:
            self.waiting = kept
            self.total_deadline_shed += shed
            metrics.ENGINE_QUEUE_DEPTH.set(len(self.waiting))
            logger.warning(
                "shed requests past deadline",
                extra={"extra_data": {"shed": shed}},
            )

    def _prefix_chain(self, seq: Sequence) -> List[bytes]:
        """Chain digests, one per full prompt page, cached on the sequence
        (re-admission attempts under memory pressure must not rehash the
        prompt every tick).  sha256 over the token bytes — a collision
        would silently share another request's KV (the weakness behind
        vLLM's prefix-cache CVE-2025-25183), so the builtin hash() is not
        acceptable here."""
        import hashlib

        key = (len(seq.prompt_ids), seq.preempt_count)
        cached = getattr(seq, "_prefix_chain_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        n_full = seq.num_prompt_tokens // self.page_size
        # never match the ENTIRE prompt: the prefill program must run at
        # least one real token to produce the first sampled token
        if n_full * self.page_size == seq.num_prompt_tokens:
            n_full -= 1
        chain: List[bytes] = []
        h = b""
        for i in range(n_full):
            block = np.asarray(
                seq.prompt_ids[
                    i * self.page_size : (i + 1) * self.page_size
                ],
                np.int64,
            ).tobytes()
            h = hashlib.sha256(h + block).digest()
            chain.append(h)
        seq._prefix_chain_cache = (key, chain)  # type: ignore[attr-defined]
        return chain

    def _radix_probe(self, seq: Sequence) -> tuple:
        """(matched full pages, matched-but-reclaimable pages) for a
        waiting sequence, memoized per (prompt epoch, tree clock) —
        cache-aware selection probes several candidates per admission
        and must not re-walk an unchanged tree."""
        key = (
            len(seq.prompt_ids), seq.preempt_count, self.radix._clock
        )
        cached = getattr(seq, "_radix_probe_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        result = self.radix.probe(seq.prompt_ids)
        if result[0] < self.radix.min_share_pages:
            # match() refuses sub-threshold shares, so crediting them
            # here would claim admissibility where try_admit must then
            # allocate every page (busy-spin when it can't), and would
            # prefer a "warm" candidate that actually admits cold
            result = (0, 0)
        seq._radix_probe_cache = (key, result)  # type: ignore[attr-defined]
        return result

    # bounded FIFO bypass for cache-aware selection: a cold head is
    # passed over at most this many times before it is admitted
    # regardless, so warm traffic cannot starve it
    CACHE_AWARE_MAX_BYPASS = 4
    # candidates probed per admission (first K of the best tier, queue
    # order) — bounds the per-tick probe cost under deep queues
    CACHE_AWARE_LOOKAHEAD = 8

    def _select_next(self, count_bypass: bool = False) -> Optional[Sequence]:
        """Admission candidate: the oldest sequence of the most
        important waiting tier (rank, then seq_id — FIFO within a
        tier; a preempted sequence's old seq_id keeps it ahead of
        younger tier-mates on re-admission).  Aborted sequences are
        skipped here and reaped by ``_reap_aborted``.  Without priority
        tiers in play this is the head of the queue (O(1)).

        With the radix tree and ``cache_aware_sched``, same-tier
        candidates that share MORE resident tree pages are preferred
        (bounded lookahead, bounded bypass): admitting warm work while
        its prefix is locked-resident keeps hot prefixes co-batched and
        un-evictable, and costs the cold head at most
        ``CACHE_AWARE_MAX_BYPASS`` admissions of delay.
        ``count_bypass`` is set only by ``try_admit`` — probe callers
        (``has_admissible_waiting``) must not age the head."""
        if not self._priority_seen:
            best = None
            for seq in self.waiting:  # head modulo an aborted/held prefix
                if not seq.abort_requested and not getattr(
                    seq, "_handoff_hold", False
                ):
                    best = seq
                    break
        else:
            best = None
            for seq in self.waiting:
                if seq.abort_requested or getattr(
                    seq, "_handoff_hold", False
                ):
                    continue
                if best is None or (_rank(seq), seq.seq_id) < (
                    _rank(best), best.seq_id
                ):
                    best = seq
        if (
            best is None
            or self.radix is None
            or not self.cache_aware_sched
        ):
            return best
        if (
            getattr(best, "_cache_bypassed", 0)
            >= self.CACHE_AWARE_MAX_BYPASS
        ):
            return best
        best_rank = _rank(best)
        best_pages = self._radix_probe(best)[0]
        warm, warm_pages = best, best_pages
        seen = 0
        for seq in self.waiting:
            if (
                seq.abort_requested
                or getattr(seq, "_handoff_hold", False)
                or _rank(seq) != best_rank
            ):
                continue
            seen += 1
            if seen > self.CACHE_AWARE_LOOKAHEAD:
                break
            pages = self._radix_probe(seq)[0]
            if pages > warm_pages or (
                pages == warm_pages and seq.seq_id < warm.seq_id
            ):
                warm, warm_pages = seq, pages
        if warm is not best and warm_pages > best_pages:
            if count_bypass:
                best._cache_bypassed = (  # type: ignore[attr-defined]
                    getattr(best, "_cache_bypassed", 0) + 1
                )
            return warm
        return best

    def _dequeue(self, seq: Sequence) -> None:
        """Remove a selected sequence from the waiting queue — O(1) for
        the head (the only case without priority tiers in play)."""
        if self.waiting and self.waiting[0] is seq:
            self.waiting.popleft()
        else:
            self.waiting.remove(seq)

    def _reap_aborted(self) -> None:
        """Settle client-cancelled waiting sequences WHEREVER they sit.
        Head-only reaping is not enough once priority selection admits
        around the head: an aborted sequence parked behind a bypassed
        lower-tier head would otherwise never settle — its future (and
        the gateway's admission backlog charge) would leak forever."""
        if not any(s.abort_requested for s in self.waiting):
            return
        kept: Deque[Sequence] = deque()
        for seq in self.waiting:
            if seq.abort_requested:
                self.abort(seq)
            else:
                kept.append(seq)
        self.waiting = kept
        metrics.ENGINE_QUEUE_DEPTH.set(len(self.waiting))

    def try_admit(self) -> Optional[PrefillPlan]:
        self._shed_expired()
        self._reap_aborted()
        if not self.waiting:
            return None
        slot = self._free_slot()
        if slot is None:
            return None
        seq = self._select_next(count_bypass=True)
        if seq is None:
            return None
        if self.swap is not None:
            # swapped-out preemption victim: re-admit via host->device
            # swap-in instead of re-prefill (ticket_for discards a
            # stale ticket internally, falling through to recompute)
            ticket = self.swap.ticket_for(seq)
            if ticket is not None:
                return self._admit_swap_in(seq, slot, ticket)
        n_pages = cdiv(max(1, seq.num_prompt_tokens), self.page_size)

        # prefix cache: match the longest shared prefix already resident;
        # only the remainder allocates + prefills.  Radix mode walks the
        # tree (full pages + optional COW partial page); flat mode
        # matches the whole-page hash chain.
        matched: List[int] = []
        chain: List[bytes] = []
        radix_match: Optional[RadixMatch] = None
        cow_tokens = 0
        if self.radix is not None:
            radix_match = self.radix.match(seq.prompt_ids)
            if radix_match is not None:
                matched = radix_match.pages
                cow_tokens = radix_match.cow_tokens
        elif self.prefix_cache:
            chain = self._prefix_chain(seq)
            for h in chain:
                page = self.allocator.lookup(h)
                if page is None:
                    break
                matched.append(page)

        if cow_tokens and (
            seq.num_prompt_tokens
            - len(matched) * self.page_size
            - cow_tokens
            > self.prefill_buckets[-1]
        ):
            # the suffix exceeds the bucket cap, so this prefill runs
            # CHUNKED — serial page-aligned passes that cannot start
            # mid-page.  Drop the COW tail and recompute those tokens
            # with the first chunk instead.
            self.radix.release_cow(radix_match)
            radix_match.cow_tokens = 0
            cow_tokens = 0

        pages = self.allocator.allocate(n_pages - len(matched))
        if pages is None:
            self.allocator.release(matched)
            if radix_match is not None:
                self.radix.unlock(radix_match)
            if self.preempt_on_oom and not self.running:
                # nothing to preempt and still no memory: the prompt can
                # never fit — fail it rather than deadlock
                self._dequeue(seq)
                seq.fail(
                    RuntimeError(
                        "KV cache too small for prompt "
                        f"({seq.num_prompt_tokens} tokens)"
                    )
                )
            return None
        self._dequeue(seq)
        metrics.ENGINE_QUEUE_DEPTH.set(len(self.waiting))
        seq.pages = matched + pages
        seq.slot = slot
        seq.status = SeqStatus.RUNNING
        self.slots[slot] = seq
        self.total_admitted += 1
        metrics.ACTIVE_SEQUENCES.set(len(self.running))
        cached_len = len(matched) * self.page_size + cow_tokens
        if getattr(seq, "_preempt_recompute", False):
            # the waste the host swap tier exists to eliminate: suffix
            # tokens this re-prefill recomputes because a preemption
            # destroyed (rather than parked) the sequence's KV
            seq._preempt_recompute = False  # type: ignore[attr-defined]
            waste = max(0, seq.num_prompt_tokens - cached_len)
            self.total_preempt_recompute_tokens += waste
            metrics.PREEMPT_RECOMPUTE_TOKENS.inc(waste)
        self.total_prefix_hit_tokens += cached_len
        # hits count only on successful admission (a failed allocate above
        # rolls the references back and must not inflate the stat)
        self.allocator.prefix_hits += len(matched)
        if cached_len:
            metrics.PREFIX_HIT_TOKENS.inc(cached_len)
            metrics.PREFIX_HIT_PAGES.inc(len(matched))
        cow = None
        if cow_tokens:
            # dst = the sequence's first OWN page: the engine copies the
            # shared head of the diverging source page into it, then the
            # suffix prefill starts mid-page at cached_len
            cow = (radix_match.cow_src, pages[0], cow_tokens)
        if radix_match is not None:
            # the sequence's release path must drop the tree path locks
            seq._radix_match = radix_match  # type: ignore[attr-defined]
        radix_insert = None
        if self.radix is not None:
            # snapshot what this prefill makes indexable (all full
            # prompt pages): commit_prefill inserts it after dispatch.
            # Snapshotted NOW so a watchdog containment folding the
            # sequence mid-dispatch cannot skew the commit data.
            n_full = seq.num_prompt_tokens // self.page_size
            if n_full > len(matched):
                radix_insert = (
                    list(seq.prompt_ids[: n_full * self.page_size]),
                    list(seq.pages[:n_full]),
                )
        # flat mode: pages this prefill will fill (full prompt pages
        # beyond the matched prefix), for the ENGINE to index AFTER it
        # dispatched the program — registering here would let a
        # same-tick reader's program be grouped ahead of this writer's
        # and gather unwritten pages (same-wave identical prompts are
        # the batcher dedup's job)
        register_hashes = [
            (seq.pages[i], chain[i]) for i in range(len(matched), len(chain))
        ]
        suffix_len = seq.num_prompt_tokens - cached_len
        top = self.prefill_buckets[-1]
        if suffix_len > top:
            # chunked prefill: serial suffix passes of `top` tokens
            return PrefillPlan(
                seq=seq, slot=slot, bucket=top, cached_len=cached_len,
                register_hashes=register_hashes, chunked=True,
                cow=cow, radix_insert=radix_insert,
                radix_match=radix_match,
            )
        bucket = bucket_for(suffix_len, self.prefill_buckets)
        return PrefillPlan(
            seq=seq, slot=slot, bucket=bucket, cached_len=cached_len,
            register_hashes=register_hashes,
            cow=cow, radix_insert=radix_insert, radix_match=radix_match,
        )

    def _admit_swap_in(
        self, seq: Sequence, slot: int, ticket: SwapTicket
    ) -> Optional[SwapInPlan]:
        """Re-admit a host-swapped sequence: allocate exactly the
        parked page count (its KV is complete — no radix match, no
        prefill) and hand the engine a :class:`SwapInPlan` to scatter
        the content back.  On allocation failure the sequence simply
        waits, unless nothing is running and nothing can be preempted —
        then the ticket is dropped and the sequence folds to the
        recompute path, whose radix sharing may still fit it (and
        whose own fail-fast gives the definitive answer if not)."""
        pages = self.allocator.allocate(ticket.num_pages)
        if pages is None:
            if self.preempt_on_oom and not self.running:
                self.swap.discard_for(seq, reason="no_fit")
                seq.reset_for_recompute()
                seq._preempt_recompute = True  # type: ignore[attr-defined]
            return None
        self._dequeue(seq)
        metrics.ENGINE_QUEUE_DEPTH.set(len(self.waiting))
        seq.pages = pages
        seq.slot = slot
        seq.status = SeqStatus.RUNNING
        self.slots[slot] = seq
        self.total_admitted += 1
        metrics.ACTIVE_SEQUENCES.set(len(self.running))
        return SwapInPlan(seq=seq, slot=slot, ticket=ticket)

    def commit_prefill(self, plan: PrefillPlan, stale: bool = False) -> None:
        """Index the pages a dispatched prefill has made reusable —
        called by the engine AFTER every writer program of the admission
        wave is enqueued, so a reader admitted in a later tick provably
        dispatches after the writer.  Flat mode registers the chain
        hashes; radix mode inserts the admission-time snapshot and
        releases the COW source lock.  ``stale`` (the sequence was
        checkpointed by a watchdog containment mid-dispatch) skips the
        insert — its snapshot pages were already released — but still
        drops the COW lock."""
        if self.radix is not None:
            if plan.radix_match is not None:
                self.radix.release_cow(plan.radix_match)
            if plan.radix_insert is not None and not stale:
                tokens, pages = plan.radix_insert
                node = self.radix.insert(tokens, pages)
                if node is not None:
                    # the adopted pages are still referenced by the
                    # RUNNING sequence: pin the path until its release
                    # (_radix_unlock), or eviction would count/strip
                    # seq-referenced pages as reclaimable
                    self.radix.lock_node(node)
                    plan.seq._radix_insert_node = (  # type: ignore[attr-defined]
                        node
                    )
            return
        if stale:
            return
        for page, h in plan.register_hashes or ():
            self.allocator.register(page, h)

    def maybe_trim(self) -> None:
        """Proactive cache trim (engine tick): keep the truly-free list
        above the evict watermark by evicting cold tree pages, so
        allocation bursts never pay the eviction walk synchronously and
        admission's kv_pressure shedding only engages when the pool is
        genuinely exhausted."""
        if (
            self._trim_target
            and self.allocator.num_truly_free < self._trim_target
        ):
            self.radix.trim_to_watermark(self._trim_target)

    def prepare_decode(
        self, active: List[Sequence], horizon: int = 1
    ) -> bool:
        """Allocate pages so every sequence can decode ``horizon`` steps
        (KV writes land at positions ``pos .. pos+horizon-1``) without
        crossing into unowned memory; preempt the youngest sequences on
        exhaustion.  Returns True when a decode step can proceed."""
        max_pages = cdiv(self.max_model_len, self.page_size)
        # higher tiers claim pages first, so when the pool runs dry
        # mid-loop it is the lower tiers that trigger preemption
        for seq in sorted(active, key=lambda s: (_rank(s), s.seq_id)):
            if seq.status is not SeqStatus.RUNNING:
                continue  # preempted by an earlier iteration
            # pages only need to cover the steps this sequence will KEEP
            # (overshoot past its budget is discarded at readback; those
            # writes fall through to the trash page once the page-table row
            # runs out of real pages)
            rem = max(1, seq.params.max_tokens) - seq.num_generated
            steps = max(1, min(horizon, rem))
            while True:
                # last position written within the horizon (clamped: steps
                # past max_model_len clip into the final page harmlessly)
                pos = seq.total_len - 1
                needed = min((pos + steps - 1) // self.page_size + 1,
                             max_pages)
                if len(seq.pages) >= needed:
                    break
                pages = self.allocator.allocate(1)
                if pages is not None:
                    seq.pages.extend(pages)
                    continue  # horizon may need several pages
                if not self.preempt_on_oom:
                    seq.fail(
                        KVCapacityError(
                            "KV pages exhausted mid-decode "
                            "(scheduler.preempt_on_oom is off); retry "
                            "when resident work completes"
                        )
                    )
                    self.remove(seq)
                    break
                victim = self._pick_victim()
                if victim is None or (
                    victim is seq and len(self.running) == 1
                ):
                    # alone and still no memory: the context can never fit
                    seq.fail(
                        KVCapacityError(
                            "KV pages exhausted: the sequence's grown "
                            f"context ({seq.total_len} tokens) cannot "
                            "fit the pool even alone; retry against a "
                            "less-loaded replica",
                            retry_after=5.0,
                        )
                    )
                    self.remove(seq)
                    break
                self._preempt(victim)
                if victim is seq:
                    break  # requester preempted itself; skip its decode
        return any(s is not None for s in self.slots)

    def _pick_victim(self) -> Optional[Sequence]:
        """Lowest-tier running sequence, youngest within the tier —
        under KV pressure batch work yields to interactive before any
        same-tier sequence is touched.  Possibly the requester itself."""
        running = self.running
        if not running:
            return None
        return max(running, key=lambda s: (_rank(s), s.seq_id))

    def _event(self, kind: str, seq: Sequence, **fields) -> None:
        if self.recorder is not None:
            self.recorder.record_tick(
                kind,
                seq_id=seq.seq_id,
                request_id=seq.request_id,
                queue_depth=len(self.waiting),
                **fields,
            )

    def _preempt(self, seq: Sequence) -> None:
        # host swap tier first, BEFORE anything releases the pages:
        # park the valid KV (positions 0 .. total_len-2 — the final
        # sampled token's KV was never written) so re-admission resumes
        # decode with ZERO recompute.  Page content survives release()
        # untouched until reallocated, but the read must complete
        # before any later program could write these pages — both
        # happen on this engine thread, so reading first is sufficient.
        swapped = False
        if self.swap is not None:
            n_valid = cdiv(max(1, seq.total_len - 1), self.page_size)
            swapped = self.swap.swap_out_seq(seq, seq.pages[:n_valid])
        logger.warning(
            "preempting sequence for KV pressure",
            extra={
                "extra_data": {
                    "seq_id": seq.seq_id,
                    "request_id": seq.request_id,
                    "trace_id": getattr(seq.trace, "trace_id", None),
                    "resident_tokens": seq.total_len,
                    "swapped": swapped,
                }
            },
        )
        self._event(
            "preempt", seq, resident_tokens=seq.total_len,
            swapped=swapped,
        )
        if self.recorder is not None:
            # phase accounting: accrue the interrupted compute phase,
            # re-enter queue time (re-admission resumes at on_admit)
            self.recorder.on_preempt(seq)
        if seq.trace is not None:
            seq.trace.preempted()
        slot = seq.slot
        self._radix_unlock(seq)
        self.allocator.release(seq.pages)
        if slot is not None:
            self.slots[slot] = None
        if swapped:
            seq.reset_for_swap()
            self.total_swap_preempts += 1
        else:
            seq.reset_for_recompute()
            # marks the re-admission prefill as preemption-caused waste
            # (vgt_preempt_recompute_tokens — the cost the swap tier
            # exists to eliminate); counted when the re-prefill is
            # actually planned, cleared there
            seq._preempt_recompute = True  # type: ignore[attr-defined]
        self.waiting.appendleft(seq)
        self.total_preemptions += 1
        metrics.PREEMPTED_SEQUENCES.inc()
        metrics.ACTIVE_SEQUENCES.set(len(self.running))
        metrics.ENGINE_QUEUE_DEPTH.set(len(self.waiting))

    # -- disaggregated prefill→decode handoff (runtime/handoff.py) --

    def hold_for_handoff(self, seq: Sequence) -> bool:
        """Fold a RUNNING sequence off the device and park its valid KV
        in the host pool for a prefill→decode handoff — mechanically a
        swap-preemption (same valid-KV bound, same ticket), but the
        sequence then sits in ``waiting`` marked HELD: ``_select_next``
        skips it, so it neither re-admits locally nor blocks admission,
        while every existing settle path (abort reap, deadline shed,
        containment fold) still finds it.  The exit paths:

        * transfer accepted → :meth:`evacuate` (dequeue + discard the
          local ticket; the decode worker owns the sequence now),
        * transfer failed / cancelled → :meth:`release_hold` (clear the
          mark; ``try_admit`` swap-ins the local ticket and decode
          continues monolithically with zero recompute).

        False = could not stage (no swap tier / pool full / readback
        raced a fold): the sequence keeps running untouched and the
        caller reports the monolithic fallback."""
        if self.swap is None or seq.status is not SeqStatus.RUNNING:
            return False
        n_valid = cdiv(max(1, seq.total_len - 1), self.page_size)
        if not self.swap.swap_out_seq(seq, seq.pages[:n_valid]):
            return False
        self._event(
            "handoff_hold", seq, resident_tokens=seq.total_len,
        )
        if self.recorder is not None:
            # phase accounting: accrue the interrupted compute phase;
            # re-enters queue time until the decode worker resumes it
            # (or release_hold re-admits it here)
            self.recorder.on_preempt(seq)
        slot = seq.slot
        self._radix_unlock(seq)
        self.allocator.release(seq.pages)
        if slot is not None:
            self.slots[slot] = None
        seq.reset_for_swap()
        seq._handoff_hold = True  # type: ignore[attr-defined]
        self.waiting.appendleft(seq)
        self.total_handoff_holds += 1
        metrics.ACTIVE_SEQUENCES.set(len(self.running))
        metrics.ENGINE_QUEUE_DEPTH.set(len(self.waiting))
        return True

    def release_hold(self, seq: Sequence) -> None:
        """Lift a handoff hold: the transfer fell through (retries
        exhausted, decode pool drained, raced a cancel), so the
        sequence becomes an ordinary swapped-out waiting sequence —
        the next ``try_admit`` finds its live ticket and swap-ins for
        a monolithic local decode with zero recompute.  Idempotent;
        a no-op for settled or never-held sequences."""
        if getattr(seq, "_handoff_hold", False):
            seq._handoff_hold = False  # type: ignore[attr-defined]
            self._event("handoff_release", seq)

    # -- completion --

    def _radix_unlock(self, seq: Sequence) -> None:
        """Drop the sequence's tree path locks (idempotent; its page
        references are released with the rest of ``seq.pages``) — both
        the match-time path lock and the commit-time pin on the node
        holding its own adopted prompt pages."""
        if self.radix is None:
            return
        match = getattr(seq, "_radix_match", None)
        if match is not None:
            self.radix.unlock(match)
            seq._radix_match = None  # type: ignore[attr-defined]
        node = getattr(seq, "_radix_insert_node", None)
        if node is not None:
            self.radix.unlock_node(node)
            seq._radix_insert_node = None  # type: ignore[attr-defined]

    def _radix_insert_final(self, seq: Sequence) -> None:
        """Index a finishing sequence's GENERATED tokens too: turn N+1
        of a chat re-sends turn N's answer inside its prompt, so the
        transcript's full pages are exactly what the next request
        matches.  Valid KV covers positions ``0 .. total_len - 2`` (the
        final sampled token was never fed back, so its KV was never
        written) — only full pages at or below that bound insert."""
        if (
            self.radix is None
            or not self.insert_generated
            or seq.status is not SeqStatus.RUNNING
            or not seq.pages
        ):
            return
        n_full = (seq.total_len - 1) // self.page_size
        if n_full <= 0:
            return
        stream = seq.prompt_ids + seq.output_ids
        self.radix.insert(
            stream[: n_full * self.page_size], seq.pages[:n_full]
        )

    def _discard_swap(self, seq: Sequence, reason: str) -> None:
        """Drop a waiting sequence's parked host-pool KV (idempotent
        no-op for sequences without a live ticket) — called on every
        path that settles or re-folds a sequence out from under its
        ticket.  The manager's stale sweep is the backstop for any
        path that slips through (e.g. fatal containment, whose pool
        dies with the core anyway)."""
        if self.swap is not None:
            self.swap.discard_for(seq, reason=reason)

    def _release_residency(self, seq: Sequence) -> None:
        self._radix_unlock(seq)
        if seq.pages:
            self.allocator.release(seq.pages)
            seq.pages = []
        if seq.slot is not None and self.slots[seq.slot] is seq:
            self.slots[seq.slot] = None
        seq.slot = None
        metrics.ACTIVE_SEQUENCES.set(len(self.running))

    def remove(self, seq: Sequence) -> None:
        """Release residency after finish/failure.  A sequence finishing
        cleanly (the engine calls remove just before ``seq.finish``, so
        its status is still RUNNING — failures arrive already FAILED)
        donates its transcript's full pages to the radix tree first."""
        self._radix_insert_final(seq)
        self._release_residency(seq)
        self.total_finished += 1

    def evacuate(self, seq: Sequence) -> None:
        """Planned migration (engine thread only): release this
        sequence's residency or queue position WITHOUT settling it —
        unlike :meth:`abort`/:meth:`shed`, the future stays open; the
        caller folds the sequence (``Sequence.prepare_migrate``) and
        replays it into another replica.  Accounted as neither finished
        nor aborted: the sequence's terminal outcome happens wherever
        it lands."""
        if seq.status is SeqStatus.RUNNING:
            self._release_residency(seq)
        else:
            try:
                self.waiting.remove(seq)
            except ValueError:
                pass  # already dequeued (racing admission this tick)
            # a swapped-out waiting sequence folds to the recompute
            # path on the migration target (the parked KV is local to
            # this core's pool and cannot travel)
            self._discard_swap(seq, "stale")
            metrics.ENGINE_QUEUE_DEPTH.set(len(self.waiting))

    def abort(self, seq: Sequence) -> None:
        """Client cancellation: release any residency, account it as
        aborted (NOT finished — the two are disjoint outcomes), and
        finish the sequence with reason "abort".  The single owner of
        abort bookkeeping for both the running and queued paths."""
        self._release_residency(seq)
        self._discard_swap(seq, "settled")
        self.total_aborted += 1
        metrics.CANCELLED_REQUESTS.labels(reason=seq.abort_reason).inc()
        self._event("abort", seq, reason=seq.abort_reason)
        seq.finish("abort")

    def fail_sequence(self, seq: Sequence, exc: BaseException) -> None:
        """Fail ONE sequence with a typed error, freeing its residency
        this tick (slot + KV pages) — the integrity soft-sentinel path:
        the sequence's own output is suspect (entropy collapse) but the
        engine and its weights are not, so the replica keeps serving
        everyone else."""
        if seq in self.waiting:
            self.waiting.remove(seq)
        self._release_residency(seq)
        self._discard_swap(seq, "settled")
        self._event("integrity_fail", seq, error=type(exc).__name__)
        seq.fail(exc)

    def shed(self, seq: Sequence, exc: DeadlineExceededError) -> None:
        """Deadline shed of a RUNNING sequence (the engine detected
        ``past_deadline`` between decode ticks and built the exception,
        which carries the partial text): release residency immediately —
        slot and KV pages free this tick, not at natural completion —
        and fail the owed future.  Counted with the queued sheds in
        ``total_deadline_shed``."""
        self._release_residency(seq)
        self.total_deadline_shed += 1
        metrics.CANCELLED_REQUESTS.labels(reason="deadline").inc()
        metrics.DEADLINE_PARTIAL_TOKENS.observe(seq.num_generated)
        self._event(
            "shed", seq, where="running",
            partial_tokens=seq.num_generated,
        )
        seq.fail(exc)

    def get_stats(self) -> dict:
        return {
            "waiting": len(self.waiting),
            "running": len(self.running),
            "slots": len(self.slots),
            "free_pages": self.allocator.num_free,
            "used_pages": self.allocator.num_used,
            "admitted": self.total_admitted,
            "finished": self.total_finished,
            "preemptions": self.total_preemptions,
            "swap_preempts": self.total_swap_preempts,
            "preempt_recompute_tokens": (
                self.total_preempt_recompute_tokens
            ),
            "deadline_shed": self.total_deadline_shed,
            "aborted": self.total_aborted,
            "prefix_cache": {
                "enabled": self.prefix_cache,
                "mode": "radix" if self.radix is not None else "flat",
                "hit_tokens": self.total_prefix_hit_tokens,
                "hit_pages": self.allocator.prefix_hits,
                "cached_pages": self.allocator.num_cached,
                "evictions": (
                    sum(self.radix.total_evictions.values())
                    if self.radix is not None
                    else self.allocator.prefix_evictions
                ),
                **(
                    {
                        "nodes": self.radix.total_nodes,
                        "inserted_pages": self.radix.total_inserted_pages,
                        "evictions_lru": self.radix.total_evictions.get(
                            "lru", 0
                        ),
                        "evictions_pressure": (
                            self.radix.total_evictions.get("pressure", 0)
                        ),
                        "cow_copies": self.radix.total_cow_copies,
                        "insert_suspended": self.radix.insert_suspended,
                        **(
                            {
                                "swapped_nodes": (
                                    self.radix._swapped_nodes
                                ),
                                "demoted_pages": (
                                    self.radix.total_demoted_pages
                                ),
                                "promoted_pages": (
                                    self.radix.total_promoted_pages
                                ),
                            }
                            if self.radix.swap is not None
                            else {}
                        ),
                    }
                    if self.radix is not None
                    else {}
                ),
            },
        }
