"""Host-RAM KV swap tier: a budgeted page pool UNDER the device pool.

Every KV-pressure response the engine had before this module destroys
work: preemption releases the victim's pages and re-prefills from
scratch (``Sequence.reset_for_recompute``), and radix-cache eviction
discards warm prefix pages outright — so under sustained overload the
engine burns prefill FLOPs re-deriving KV it just threw away, exactly
when it can least afford to (the recompute storm).  vLLM's answer is a
CPU swap space behind the paged allocator; this is its first-party
twin: a pinned host-RAM pool (``kv_cache.host_swap_bytes``, 0 = off ⇒
byte-identical engine) that gives the pressure ladder a third tier
between "resident" and "gone":

* **Preemption swap-out**: the victim's valid KV pages are read back
  device→host (chunked, at a tick boundary) *instead of* being
  recomputed later; re-admission scatters them host→device and decode
  resumes at the exact position it stopped — token-identical, zero
  prefill.  ``reset_for_recompute`` stays as the fallback when the
  pool is full or the ticket went stale (engine restart, migration).
* **Radix demotion (victim cache)**: pressure/LRU eviction of
  lock-free leaf pages demotes them here before truly discarding; a
  later ``match()`` promotes them back into fresh device pages, so a
  warm prefix tree survives a KV squeeze.

The manager is pure host-side policy — the device work is behind an
injected *executor* (``read_pages(pages) -> payload`` /
``write_pages(pages, payload)``), so the whole tier is unit-testable
with a fake device exactly like the scheduler and radix cache
(tests/test_kv_swap.py; the randomized radix drill drives demote/
promote/discard against the allocator invariants).  All mutation runs
on the engine thread; the gateway only ever reads the plain-int
occupancy gauges through ``pressure_signals``.

Priority under budget pressure: client-owed work wins.  A preemption
swap-out may discard prefix (victim-cache) tickets LRU-first to make
room; a prefix demotion never discards anything but stale tickets —
rotating the victim cache to admit a colder entry would be pure churn.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from vgate_tpu_torch.runtime import engine_metrics as metrics
from vgate_tpu_torch.logging_config import get_logger
from vgate_tpu_torch.runtime.sequence import Sequence, SeqStatus

logger = get_logger(__name__)

# Obligation contract (vgtlint obligations checker): host-pool bytes
# are charged exactly once per ticket and refunded exactly once — the
# PR-11 review-round bug was a DOUBLE refund on the sweep-then-settle
# path (the registry, not the seq attribute, is the accounting truth).
# A charge is discharged by parking the ticket in its registry
# (transfer_assign) or refunding; _count_discard subsumes _refund.
VGT_OBLIGATIONS = {
    "host-pool-bytes": {
        "acquire": ("self._charge",),
        "release": ("self._refund", "self._count_discard"),
        "transfer_assign": ("self._seq_tickets", "self._prefix_lru"),
    },
}


class SwapTicket:
    """One swapped-out run of KV pages parked in host RAM.

    ``kind`` is ``"seq"`` (a preempted sequence's resident KV; validity
    is epoch-guarded by ``seq.preempt_count`` so a checkpoint/replay or
    a second fold can never resume against stale content) or
    ``"prefix"`` (a demoted radix-tree leaf; the owning node keeps the
    ticket on ``node.swapped`` and the token-keyed tree itself is the
    lookup index).  ``payload`` is opaque to the pool — the device
    executor produced it and only the device executor reads it.
    """

    __slots__ = (
        "kind", "num_pages", "nbytes", "payload", "seq_id", "epoch",
        "node", "created_t",
    )

    def __init__(
        self,
        kind: str,
        num_pages: int,
        nbytes: int,
        payload: Any,
        seq_id: Optional[int] = None,
        epoch: int = 0,
        node: Any = None,
    ) -> None:
        self.kind = kind
        self.num_pages = num_pages
        self.nbytes = nbytes
        self.payload = payload
        self.seq_id = seq_id
        self.epoch = epoch
        self.node = node
        self.created_t = time.monotonic()


class KVSwapManager:
    """Budgeted host-RAM page pool + swap policy (the "host pool").

    ``lock`` is the publication guard shared with the engine's readback
    lock: the chunked device read for a swap-out can block for a long
    time, and a watchdog containment may fold the victim meanwhile —
    the ticket is only published under the lock, against a re-checked
    status/epoch, mirroring every other readback path.
    """

    def __init__(
        self,
        budget_bytes: int,
        page_bytes: int,
        executor: Any,
        lock: Optional[threading.Lock] = None,
    ) -> None:
        self.budget_bytes = max(0, int(budget_bytes))
        self.page_bytes = max(1, int(page_bytes))
        self.executor = executor
        self._lock = lock if lock is not None else threading.Lock()
        self.used_bytes = 0
        # seq tickets by seq_id (the seq also holds seq._swap_ticket);
        # prefix tickets in LRU order (oldest first) for capacity drops
        self._seq_tickets: Dict[int, tuple] = {}  # seq_id -> (seq, ticket)
        self._prefix_lru: Dict[int, SwapTicket] = {}  # id(ticket) -> ticket
        # brownout L4 ("bypass cache writes"): stop demotions, keep
        # serving promotions — flipped cross-thread via
        # EngineCore.set_prefix_insert_suspended (GIL-atomic bool store)
        self.demote_suspended = False
        # radix hook: called when a prefix ticket is dropped for
        # capacity so the tree unlinks the page-less node
        self.on_drop_node: Optional[Callable[[Any], None]] = None
        self.total_swap_out_pages = {"preempt": 0, "prefix": 0}
        self.total_swap_in_pages = {"preempt": 0, "prefix": 0}
        self.total_discard_pages: Dict[str, int] = {}
        self.total_refused = 0

    # ------------------------------------------------------- accounting

    @property
    def free_bytes(self) -> int:
        return max(0, self.budget_bytes - self.used_bytes)

    def _charge(self, nbytes: int) -> None:
        self.used_bytes += nbytes
        metrics.KV_HOST_POOL_BYTES.set(self.used_bytes)

    def _refund(self, nbytes: int) -> None:
        self.used_bytes = max(0, self.used_bytes - nbytes)
        metrics.KV_HOST_POOL_BYTES.set(self.used_bytes)

    def _count_discard(self, ticket: SwapTicket, reason: str) -> None:
        self._refund(ticket.nbytes)
        ticket.payload = None
        self.total_discard_pages[reason] = (
            self.total_discard_pages.get(reason, 0) + ticket.num_pages
        )
        metrics.KV_SWAP_DISCARD_PAGES.labels(reason=reason).inc(
            ticket.num_pages
        )

    def _sweep_stale(self) -> None:
        """Drop seq tickets whose owner can never claim them: settled
        (finished/failed/aborted elsewhere) or epoch-mismatched (the
        sequence was folded for recompute/replay/migration — its
        generation now rides inside the prompt and the parked KV is
        for a dead epoch).  The explicit discard hooks on every settle
        path make this a backstop, not the mechanism."""
        dead = []
        for seq_id, (seq, ticket) in self._seq_tickets.items():
            if seq.status in (SeqStatus.FINISHED, SeqStatus.FAILED):
                dead.append((seq_id, ticket, "settled"))
            elif (
                seq.preempt_count != ticket.epoch
                or getattr(seq, "_swap_ticket", None) is not ticket
            ):
                dead.append((seq_id, ticket, "stale"))
        for seq_id, ticket, reason in dead:
            seq = self._seq_tickets.pop(seq_id)[0]
            if getattr(seq, "_swap_ticket", None) is ticket:
                seq._swap_ticket = None  # type: ignore[attr-defined]
            self._count_discard(ticket, reason)

    def _make_room(self, nbytes: int, evict_prefix: bool) -> bool:
        if nbytes > self.budget_bytes:
            return False
        if self.free_bytes >= nbytes:
            return True
        self._sweep_stale()
        while evict_prefix and self.free_bytes < nbytes and self._prefix_lru:
            # oldest victim-cache entry goes first; client-owed seq
            # tickets are never discarded to make room
            key = next(iter(self._prefix_lru))
            ticket = self._prefix_lru.pop(key)
            self._count_discard(ticket, "capacity")
            if self.on_drop_node is not None and ticket.node is not None:
                self.on_drop_node(ticket.node)
            ticket.node = None
        return self.free_bytes >= nbytes

    # ---------------------------------------------- preempted sequences

    def swap_out_seq(self, seq: Sequence, pages: List[int]) -> bool:
        """Park a preemption victim's valid KV pages in the host pool.

        Called by the scheduler BEFORE the pages are released; on True
        the caller resumes the sequence later via swap-in instead of
        recompute (``Sequence.reset_for_swap``).  The ticket's epoch is
        the preempt_count the sequence will have AFTER that reset, so a
        containment fold in between (which bumps the epoch again)
        invalidates it automatically."""
        if self.budget_bytes <= 0 or not pages:
            return False
        nbytes = len(pages) * self.page_bytes
        if not self._make_room(nbytes, evict_prefix=True):
            self.total_refused += 1
            return False
        epoch0 = seq.preempt_count
        try:
            payload = self.executor.read_pages(pages)
        except Exception:
            logger.warning(
                "swap-out readback failed; falling back to recompute",
                exc_info=True,
            )
            return False
        with self._lock:
            # stale-wake guard, mirroring every other readback: a
            # watchdog containment may have folded this sequence while
            # the device read above was blocked — its epoch moved, and
            # publishing the ticket now would resume a dead epoch
            if (
                seq.status is not SeqStatus.RUNNING
                or seq.preempt_count != epoch0
            ):
                return False
            ticket = SwapTicket(
                "seq", len(pages), nbytes, payload,
                seq_id=seq.seq_id, epoch=epoch0 + 1,
            )
            seq._swap_ticket = ticket  # type: ignore[attr-defined]
            seq.swap_count += 1
            # charge, then park in the registry that owns the refund
            # from here on — nothing can raise between the two, so the
            # charge can never outlive an unregistered ticket
            self._charge(nbytes)
            self._seq_tickets[seq.seq_id] = (seq, ticket)
        self.total_swap_out_pages["preempt"] += len(pages)
        metrics.KV_SWAP_OUT_PAGES.labels(kind="preempt").inc(len(pages))
        return True

    def adopt_remote(
        self, seq: Sequence, payload: Any, num_pages: int
    ) -> bool:
        """Park a payload that arrived OVER THE WIRE (disaggregated
        prefill→decode handoff, runtime/handoff.py) as ``seq``'s swap
        ticket, exactly as if this worker had swapped it out itself —
        the normal ``try_admit`` swap-in path then restores the pages
        with zero recompute.  The sequence is WAITING (never ran here),
        so the ticket epoch is its CURRENT preempt_count; any later
        containment fold bumps the epoch and invalidates the ticket,
        and the fold's prompt then carries the generation instead.
        False (no budget / no room) sends the caller to the recompute
        fallback — correct, just slower."""
        if self.budget_bytes <= 0 or num_pages <= 0:
            return False
        nbytes = num_pages * self.page_bytes
        if not self._make_room(nbytes, evict_prefix=True):
            self.total_refused += 1
            return False
        with self._lock:
            ticket = SwapTicket(
                "seq", num_pages, nbytes, payload,
                seq_id=seq.seq_id, epoch=seq.preempt_count,
            )
            seq._swap_ticket = ticket  # type: ignore[attr-defined]
            seq.swap_count += 1
            self._charge(nbytes)
            self._seq_tickets[seq.seq_id] = (seq, ticket)
        self.total_swap_in_pages["handoff"] = (
            self.total_swap_in_pages.get("handoff", 0) + num_pages
        )
        metrics.KV_SWAP_IN_PAGES.labels(kind="handoff").inc(num_pages)
        return True

    def ticket_for(self, seq: Sequence) -> Optional[SwapTicket]:
        """The sequence's live swap ticket, or None — an invalid ticket
        (epoch moved under a fold, pool lost it) is discarded here so
        the caller falls back to the recompute path cleanly."""
        ticket = getattr(seq, "_swap_ticket", None)
        if ticket is None:
            return None
        if (
            seq.status is not SeqStatus.WAITING
            or seq.preempt_count != ticket.epoch
            or self._seq_tickets.get(seq.seq_id, (None, None))[1]
            is not ticket
        ):
            self.discard_for(seq, reason="stale")
            return None
        return ticket

    def swap_in_seq(self, seq: Sequence, pages: List[int]) -> int:
        """Scatter a parked sequence's KV into its freshly-allocated
        device pages (engine thread, at admission).  Returns the page
        count; the ticket is consumed.  An executor failure propagates
        — a failed device dispatch is an engine fatal like any other,
        and containment folds the sequence for replay."""
        ticket = getattr(seq, "_swap_ticket", None)
        assert ticket is not None and len(pages) == ticket.num_pages
        self._seq_tickets.pop(seq.seq_id, None)
        seq._swap_ticket = None  # type: ignore[attr-defined]
        try:
            self.executor.write_pages(pages, ticket.payload)
        finally:
            self._refund(ticket.nbytes)
            ticket.payload = None
        self.total_swap_in_pages["preempt"] += len(pages)
        metrics.KV_SWAP_IN_PAGES.labels(kind="preempt").inc(len(pages))
        return len(pages)

    def discard_for(self, seq: Sequence, reason: str = "settled") -> None:
        """Drop a sequence's parked KV (idempotent): the sequence
        settled, was evacuated, or folded to the recompute path.  The
        registry is the single accounting truth — a ticket the stale
        sweep already discarded (registry entry gone) must not refund
        its bytes a second time just because the seq attribute
        lingered."""
        if getattr(seq, "_swap_ticket", None) is not None:
            seq._swap_ticket = None  # type: ignore[attr-defined]
        entry = self._seq_tickets.pop(seq.seq_id, None)
        if entry is not None:
            self._count_discard(entry[1], reason)

    # --------------------------------------------- radix prefix victims

    def demote_node(self, node: Any, pages: List[int]) -> Optional[SwapTicket]:
        """Victim-cache a radix leaf's pages before eviction frees
        them.  Only stale tickets are swept to make room — a demotion
        never rotates other victim-cache entries out (see module
        docstring).  Returns the ticket (the caller parks it on
        ``node.swapped``) or None to discard as before."""
        if (
            self.budget_bytes <= 0
            or self.demote_suspended
            or not pages
        ):
            return None
        nbytes = len(pages) * self.page_bytes
        if not self._make_room(nbytes, evict_prefix=False):
            self.total_refused += 1
            return None
        try:
            payload = self.executor.read_pages(pages)
        except Exception:
            logger.warning("prefix demotion readback failed", exc_info=True)
            return None
        ticket = SwapTicket(
            "prefix", len(pages), nbytes, payload, node=node
        )
        # charge, then park in the LRU registry that owns the refund
        self._charge(nbytes)
        self._prefix_lru[id(ticket)] = ticket
        self.total_swap_out_pages["prefix"] += len(pages)
        metrics.KV_SWAP_OUT_PAGES.labels(kind="prefix").inc(len(pages))
        return ticket

    def promote_node(self, ticket: SwapTicket, pages: List[int]) -> bool:
        """Restore a demoted leaf's KV into fresh device pages (a
        ``match()`` walked into it).  Consumes the ticket.  Promotion
        is always served, even at brownout L4 — existing warm content
        saving prefill is exactly what overload needs."""
        assert len(pages) == ticket.num_pages
        self._prefix_lru.pop(id(ticket), None)
        try:
            self.executor.write_pages(pages, ticket.payload)
        finally:
            self._refund(ticket.nbytes)
            ticket.payload = None
            ticket.node = None
        self.total_swap_in_pages["prefix"] += len(pages)
        metrics.KV_SWAP_IN_PAGES.labels(kind="prefix").inc(len(pages))
        return True

    def drop_node_ticket(
        self, ticket: SwapTicket, reason: str = "settled"
    ) -> None:
        """Radix-side discard (tree reset, failed promotion)."""
        if self._prefix_lru.pop(id(ticket), None) is not None:
            self._count_discard(ticket, reason)
            ticket.node = None

    # ----------------------------------------------------- introspection

    def signal_block(self) -> Dict[str, Any]:
        """Plain-int gauges for ``pressure_signals`` (cross-thread
        reads; GIL-atomic)."""
        budget = max(1, self.budget_bytes)
        return {
            "kv_swap_enabled": True,
            "kv_host_pool_bytes": self.used_bytes,
            "kv_host_pool_budget_bytes": self.budget_bytes,
            "kv_host_free_ratio": round(
                (budget - self.used_bytes) / budget, 4
            ),
            "kv_swapped_seqs": len(self._seq_tickets),
        }

    def get_stats(self) -> Dict[str, Any]:
        return {
            "enabled": self.budget_bytes > 0,
            "budget_bytes": self.budget_bytes,
            "used_bytes": self.used_bytes,
            "page_bytes": self.page_bytes,
            "swapped_seqs": len(self._seq_tickets),
            "prefix_tickets": len(self._prefix_lru),
            "swap_out_pages": dict(self.total_swap_out_pages),
            "swap_in_pages": dict(self.total_swap_in_pages),
            "discard_pages": dict(self.total_discard_pages),
            "refused": self.total_refused,
            "demote_suspended": self.demote_suspended,
        }
