"""Radix-tree KV prefix cache over the paged pool (cross-request reuse).

Replaces the flat per-page hash chain (``PageAllocator.register/lookup``
+ ``Scheduler._prefix_chain``) as the prefix index when
``tpu.prefix_cache.radix`` is on.  The million-user workloads the
roadmap targets (multi-turn chat, RAG with shared system+corpus
preambles, agent loops re-sending growing transcripts) are dominated by
shared prefixes, and the flat chain can only match whole-page exact
chains of *prompt* pages.  The tree adds what those shapes need:

* **Longest-shared-prefix matching** by walking token-keyed nodes that
  hold runs of full KV pages, splitting a node at a partial match point
  so the shared part becomes a common ancestor (SGLang's RadixAttention
  structure, first-party here).
* **Generated-token reuse**: a finished sequence's full transcript
  (prompt + generation, minus the final token whose KV was never
  written) is inserted, so turn N+1 of a chat — which re-sends turn N's
  answer inside its prompt — hits pages the flat chain never indexed.
* **Copy-on-write partial pages**: when a request diverges from a
  cached page mid-page, the shared head of that page is device-copied
  into a fresh page (engine_core ``_cow_copy_pages``) and prefill
  starts at the unaligned boundary — up to ``page_size - 1`` more hit
  tokens per request than page-granular matching.
* **Pressure-integrated eviction**: refcount-0 subtrees are reclaimable
  LRU-leaf-first, on demand when ``PageAllocator.allocate`` runs short
  (reason ``lru``) and *proactively* when the truly-free ratio sinks
  below ``tpu.prefix_cache.evict_watermark`` (reason ``pressure``) —
  trimming runs before the gateway's admission controller would start
  shedding on ``kv_pressure``, so a warm cache never turns into 503s.

Sharing/locking model: every page indexed by the tree carries one
allocator reference owned by the tree; each sequence whose prefix
matched also holds its own allocator reference on the shared pages (the
scheduler releases ``seq.pages`` uniformly).  ``lock_ref`` counts, per
node, the live sequences whose matched path passes through it —
matching locks the whole path, so ``lock_ref == 0`` implies the entire
subtree is unreferenced by running work and is therefore reclaimable in
one sweep.  Pure host-side policy, no JAX: unit-testable like the
scheduler (tests/test_radix_cache.py drives randomized interleavings
against the allocator invariants).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

from vgate_tpu_torch.logging_config import get_logger

logger = get_logger(__name__)

# Threading contract (scripts/vgt_lint.py, thread-discipline): tree
# mutation is engine-thread-only; cross-thread readers get plain-int
# gauges, never tree walks (the PR-6 hardening).
VGT_COMPONENTS = {"swap": "KVSwapManager"}


class RadixNode:
    """One run of full KV pages keyed by its token content.

    ``tokens`` always has exactly ``len(pages) * page_size`` entries;
    children are keyed by the tuple of their first page's tokens (two
    children of one node must differ somewhere inside their first page,
    or insert would have factored the common page into a shared node).
    """

    __slots__ = (
        "tokens", "pages", "children", "parent", "lock_ref", "last_access",
        "swapped",
    )

    def __init__(
        self,
        tokens: Tuple[int, ...],
        pages: List[int],
        parent: Optional["RadixNode"],
    ) -> None:
        self.tokens = tokens
        self.pages = pages
        self.children: Dict[Tuple[int, ...], "RadixNode"] = {}
        self.parent = parent
        self.lock_ref = 0
        self.last_access = 0
        # host-swap victim cache (runtime/kv_swap.py): when eviction
        # demoted this leaf's pages to the host pool, `pages` is empty
        # and this holds the SwapTicket; a later match() promotes the
        # content back into fresh device pages.  Invariant: a node has
        # pages XOR a swapped ticket (or neither transiently never —
        # the root alone is permanently page-less).  Swapped nodes are
        # always leaves: eviction is leaf-first and neither insert nor
        # split ever descends below one.
        self.swapped = None


class RadixMatch:
    """A successful prefix match: shared full pages (+ optional COW tail).

    Holds the DEEPEST matched node; the lock walk goes deepest →
    parent → … → root, so a later :meth:`RadixCache._split` of any node
    on the path keeps the accounting exact (the split head sits on the
    parent chain and inherits the tail's count — storing the node list
    instead would orphan the head's share on unlock).  ``cow_node``
    stays locked only until the copy program is dispatched
    (``release_cow``) — after that the source page may be evicted
    freely, the copy is already in a sequence-owned page.
    """

    __slots__ = ("pages", "node", "cow_src", "cow_tokens", "cow_node")

    def __init__(
        self,
        pages: List[int],
        node: Optional[RadixNode],
        cow_src: Optional[int] = None,
        cow_tokens: int = 0,
        cow_node: Optional[RadixNode] = None,
    ) -> None:
        self.pages = pages
        self.node = node
        self.cow_src = cow_src
        self.cow_tokens = cow_tokens
        self.cow_node = cow_node

class RadixCache:
    """Page-granular radix tree over a :class:`PageAllocator`'s pool."""

    def __init__(
        self,
        allocator,
        page_size: int,
        min_share_pages: int = 1,
        cow: bool = True,
        cow_min_tokens: int = 8,
    ) -> None:
        self.allocator = allocator
        self.page_size = page_size
        self.min_share_pages = max(1, int(min_share_pages))
        self.cow = bool(cow)
        self.cow_min_tokens = max(1, int(cow_min_tokens))
        self.root = RadixNode((), [], None)
        # logical LRU clock: bumped per match/insert touch — wall time
        # adds nothing for recency ordering and a counter is testable
        self._clock = 0
        # reclaimable-page count, maintained INCREMENTALLY on the
        # lock_ref 0<->1 edges (_lock_chain), node creation (insert)
        # and node removal (evict) — a plain int, NOT a lazy tree walk:
        # allocator.num_free reads it on every decode page fault, and
        # the gateway event loop reads it cross-thread through
        # pressure_signals -> num_cached while the engine thread
        # mutates children dicts (a DFS there would die with
        # "dictionary changed size during iteration").  _split moves
        # pages between two nodes of the same lock state, so it never
        # touches the count.
        self._evictable = 0
        # brownout L4 (admission.py BROWNOUT_STEPS "bypass_cache_writes"):
        # stop inserting, keep serving hits — flipped cross-thread via
        # EngineCore.set_prefix_insert_suspended (bool stores are atomic
        # under the GIL)
        self.insert_suspended = False
        self.total_inserted_pages = 0
        self.total_evictions = {"lru": 0, "pressure": 0}
        # incremented by the ENGINE when it dispatches a COW page copy
        # (the copy program lives with the device code, the counter
        # lives with the rest of the cache stats)
        self.total_cow_copies = 0
        self.total_nodes = 1  # root
        # host-RAM swap tier (runtime/kv_swap.py), attached by the
        # engine via attach_swap(): eviction demotes lock-free leaves
        # into it (victim cache) and match() promotes them back.  None
        # keeps eviction = discard, byte-identical to the pre-swap tree.
        self.swap = None
        self._swapped_nodes = 0
        self.total_demoted_pages = 0
        self.total_promoted_pages = 0
        # inserts that stopped at a swapped node (we never index below
        # a host-resident prefix) — observability for victim-cache cost
        self.total_insert_blocked_on_swap = 0

    def attach_swap(self, swap) -> None:
        """Wire the host swap manager in (engine init): eviction gains
        the demote path and the manager's capacity drops unlink nodes
        through :meth:`drop_swapped`."""
        self.swap = swap
        swap.on_drop_node = self.drop_swapped

    # ------------------------------------------------------------- clock

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _key(self, tokens: Sequence[int], d: int) -> Tuple[int, ...]:
        return tuple(tokens[d : d + self.page_size])

    # ------------------------------------------------------------- match

    def match(self, tokens: Sequence[int]) -> Optional[RadixMatch]:
        """Walk to the longest shared prefix of ``tokens`` and lock it.

        Matches whole pages only up to ``len(tokens) - 1`` tokens (the
        suffix prefill must run at least one real token to sample
        from), splitting a node when the walk ends inside its page run.
        On success every matched page carries a NEW allocator reference
        owned by the caller (released via the sequence's normal page
        release) and every node on the path is locked (released via
        :meth:`unlock`).  A copy-on-write tail — ``cow_tokens`` shared
        tokens inside the first diverging page — is attached when
        enabled and worth a device copy.  Returns None when fewer than
        ``min_share_pages`` full pages match.
        """
        ps = self.page_size
        limit = len(tokens) - 1
        if limit < ps:
            return None  # min_share_pages >= 1: no full page can match
        node = self.root
        d = 0
        pages: List[int] = []
        path: List[RadixNode] = []
        diverged: Optional[RadixNode] = None  # node whose run we split off
        while d + ps <= limit:
            child = node.children.get(self._key(tokens, d))
            if child is None:
                break
            if child.swapped is not None:
                # host-swapped victim: promote its pages back into the
                # device pool so the walk (and the sharing) continues —
                # a failed promotion (no device pages / executor error)
                # simply ends the match at the resident prefix
                if not self._try_promote(child):
                    break
            # count matching full pages inside the child's run (first
            # page matched via the key)
            j = 1
            run = len(child.pages)
            while (
                j < run
                and d + (j + 1) * ps <= limit
                and child.tokens[j * ps : (j + 1) * ps]
                == tuple(tokens[d + j * ps : d + (j + 1) * ps])
            ):
                j += 1
            if j < run:
                # partial match point inside the run: split so the
                # shared head becomes its own (lockable) node; the tail
                # (holding the diverging page) is the COW candidate
                child = self._split(child, j)
                diverged = next(iter(child.children.values()))
            pages.extend(child.pages)
            d += j * ps
            path.append(child)
            node = child
            if j < run:
                break  # the tail child diverges — walk is over
        if len(pages) < self.min_share_pages:
            return None
        # copy-on-write tail: the first page of whichever child the walk
        # diverged from may still share a head of tokens
        cow_src = None
        cow_tokens = 0
        cow_node = None
        if self.cow:
            cand = diverged
            if cand is None:
                best = 0
                for child in node.children.values():
                    if child.swapped is not None:
                        # host-swapped: its first page is not device-
                        # resident, so there is nothing to COW-copy
                        # from (promoting a whole run for a sub-page
                        # tail would cost more than it saves)
                        continue
                    n = self._common_prefix(child.tokens, tokens, d, limit)
                    if n > best:
                        best, cand = n, child
                cow_tokens = best
            else:
                cow_tokens = self._common_prefix(
                    cand.tokens, tokens, d, limit
                )
            if cand is not None and self.cow_min_tokens <= cow_tokens < ps:
                cow_src = cand.pages[0]
                cow_node = cand
            else:
                cow_tokens = 0
        # lock the matched path by walking the parent chain from the
        # deepest node (+ the COW source node until dispatch).  The
        # chain walk — not a recorded node list — is what keeps later
        # splits of these nodes consistent: a split head joins the
        # chain and inherits the tail's count, so unlock finds it.
        now = self._tick()
        deepest = path[-1]
        self._lock_chain(deepest, +1, now)
        if cow_node is not None:
            # chain-walked like the path lock (a split of the source
            # node between match and dispatch must not orphan a share)
            self._lock_chain(cow_node, +1, now)
        self.allocator.retain(pages)
        self._touch_gauges()
        return RadixMatch(
            pages, deepest, cow_src=cow_src, cow_tokens=cow_tokens,
            cow_node=cow_node,
        )

    def _try_promote(self, child: RadixNode) -> bool:
        """Restore a host-swapped leaf's pages into the device pool
        (match-time promotion).  The node's chain is locked around the
        allocation so the eviction walk ``allocate`` may trigger can
        never touch the node being promoted; the unlock edge afterwards
        credits the restored pages back to the evictable count.
        Refcounts/locks then re-establish through the caller's normal
        parent-chain walk, exactly like a never-demoted match."""
        ticket = child.swapped
        if self.swap is None or ticket is None:
            return False
        self._lock_chain(child, +1, self._tick())
        pages = self.allocator.allocate(ticket.num_pages)
        if pages is None:
            self._lock_chain(child, -1, self._tick())
            return False
        try:
            self.swap.promote_node(ticket, pages)
        except Exception:  # executor failure: drop the dead node
            logger.warning(
                "prefix promotion failed; dropping swapped node",
                exc_info=True,
            )
            self.allocator.release(pages)
            self._lock_chain(child, -1, self._tick())
            self.drop_swapped(child, reason="stale")
            return False
        child.pages = pages
        child.swapped = None
        self._swapped_nodes -= 1
        self._lock_chain(child, -1, self._tick())
        self.total_promoted_pages += len(pages)
        self._touch_gauges()
        return True

    def _lock_chain(self, node: RadixNode, delta: int, now: int) -> None:
        while node is not None and node is not self.root:
            was_free = node.lock_ref == 0
            node.lock_ref += delta
            if was_free and delta > 0:
                self._evictable -= len(node.pages)
            elif node.lock_ref == 0 and delta < 0:
                self._evictable += len(node.pages)
            node.last_access = now
            node = node.parent

    def _common_prefix(
        self,
        child_tokens: Tuple[int, ...],
        tokens: Sequence[int],
        d: int,
        limit: int,
    ) -> int:
        n = 0
        cap = min(self.page_size, limit - d, len(child_tokens))
        while n < cap and child_tokens[n] == tokens[d + n]:
            n += 1
        return n

    def probe(self, tokens: Sequence[int]) -> Tuple[int, int]:
        """Lock-free admissibility probe: (matched full pages, how many
        of them are currently reclaimable).  A real ``match`` would
        revive reclaimable pages OUT of the free pool, so the
        scheduler's admissibility math subtracts them — mirroring the
        flat chain's ``is_evictable`` accounting.  Never splits."""
        ps = self.page_size
        limit = len(tokens) - 1
        node = self.root
        d = 0
        full = 0
        evictable = 0
        while d + ps <= limit:
            child = node.children.get(self._key(tokens, d))
            if child is None:
                break
            # token-run length works for resident AND host-swapped
            # nodes (tokens survive demotion; pages do not)
            run = len(child.tokens) // ps
            j = 1
            while (
                j < run
                and d + (j + 1) * ps <= limit
                and child.tokens[j * ps : (j + 1) * ps]
                == tuple(tokens[d + j * ps : d + (j + 1) * ps])
            ):
                j += 1
            full += j
            if child.swapped is not None:
                # promotable on a real match(), but promotion must
                # ALLOCATE the pages — counting them as evictable too
                # keeps the admissibility math honest (num_free -
                # evictable >= n_pages - full still requires the
                # device pages the swap-in will claim)
                evictable += j
                break
            if child.lock_ref == 0:
                evictable += j
            d += j * ps
            node = child
            if j < run:
                break
        return full, evictable

    # ------------------------------------------------------------ insert

    def insert(
        self, tokens: Sequence[int], pages: List[int]
    ) -> Optional[RadixNode]:
        """Index ``pages`` (full pages covering exactly ``tokens``) in
        the tree; returns the deepest node covering the stream (None
        when nothing was indexed or inserts are suspended).  Pages
        already covered by an existing prefix are NOT adopted — the
        caller's duplicates stay private and release normally (their
        content is identical by construction).  Each adopted page gains
        one allocator reference owned by the tree.

        Adopted pages are usually still referenced by the inserting
        sequence — callers indexing on behalf of RUNNING work
        (``Scheduler.commit_prefill``) must lock the returned node
        (:meth:`lock_node`) until the sequence releases, or the
        eviction accounting would count seq-referenced pages as
        reclaimable (``num_free`` overstating what allocate() can
        actually obtain).  Finish-time inserts release immediately
        after, so they skip the lock."""
        ps = self.page_size
        if self.insert_suspended or not pages:
            return None
        assert len(tokens) >= len(pages) * ps, "tokens must cover pages"
        node = self.root
        d = 0
        i = 0  # pages consumed
        created: Optional[RadixNode] = None
        now = self._tick()
        total = len(pages)
        while i < total:
            key = self._key(tokens, d)
            child = node.children.get(key)
            if child is None:
                run_tokens = tuple(tokens[d : d + (total - i) * ps])
                new = RadixNode(run_tokens, list(pages[i:]), node)
                new.last_access = now
                node.children[key] = new
                self.allocator.retain(new.pages)
                self.total_inserted_pages += len(new.pages)
                self.total_nodes += 1
                self._evictable += len(new.pages)
                created = new
                break
            if child.swapped is not None:
                # never index below a host-resident prefix: the walk
                # cannot split or extend a page-less run, and adopting
                # pages under it would claim device residency the
                # prefix doesn't have.  A later match() promotes the
                # node and re-opens the subtree for indexing.
                self.total_insert_blocked_on_swap += 1
                break
            # walk the child's run while it matches
            j = 0
            run = len(child.pages)
            while (
                j < run
                and i + j < total
                and child.tokens[j * ps : (j + 1) * ps]
                == tuple(tokens[d + j * ps : d + (j + 1) * ps])
            ):
                j += 1
            child.last_access = now
            if j == run:
                node = child
                d += j * ps
                i += j
                continue
            if i + j == total:
                # everything to insert already present inside this run
                break
            # diverged mid-run: split, then attach the new tail
            child = self._split(child, j)
            node = child
            d += j * ps
            i += j
        self._touch_gauges()
        return created

    def _split(self, child: RadixNode, j: int) -> RadixNode:
        """Split ``child``'s run at page ``j`` (0 < j < len): the head
        becomes a new node in child's place, the tail keeps ``child``'s
        identity (children, locks).  The head inherits the tail's
        lock_ref — every lock below passes through it — preserving the
        path-lock invariant."""
        ps = self.page_size
        parent = child.parent
        head = RadixNode(child.tokens[: j * ps], child.pages[:j], parent)
        head.lock_ref = child.lock_ref
        head.last_access = child.last_access
        parent.children[child.tokens[:ps]] = head
        child.tokens = child.tokens[j * ps :]
        child.pages = child.pages[j:]
        child.parent = head
        head.children[child.tokens[:ps]] = child
        self.total_nodes += 1
        return head

    # ---------------------------------------------------------- unlock

    def unlock(self, match: RadixMatch) -> None:
        """Release a sequence's path locks (its allocator page
        references are released separately, with the rest of
        ``seq.pages``)."""
        self.release_cow(match)
        if match.node is not None:
            self._lock_chain(match.node, -1, self._tick())
            match.node = None
        self._touch_gauges()

    def lock_node(self, node: RadixNode) -> None:
        """Pin ``node``'s parent chain on behalf of a RUNNING sequence
        whose private pages :meth:`insert` just adopted (commit-time
        indexing).  Until the matching :meth:`unlock_node` (the
        sequence's release path), those pages are still seq-referenced:
        an unpinned node would let ``evictable_pages`` count them as
        reclaimable and ``evict`` strip their tree references without
        freeing anything — ``num_free`` overstating what allocate()
        can actually obtain."""
        self._lock_chain(node, +1, self._tick())

    def unlock_node(self, node: RadixNode) -> None:
        """Drop a :meth:`lock_node` pin (chain-walked like every other
        lock, so later splits of the pinned path keep the accounting
        exact)."""
        self._lock_chain(node, -1, self._tick())
        self._touch_gauges()

    def release_cow(self, match: RadixMatch) -> None:
        """Drop the temporary lock on the COW source node — called once
        the copy program has been dispatched (device program order then
        guarantees the copy reads the page before any later reuse
        writes it)."""
        if match.cow_node is None:
            return
        self._lock_chain(match.cow_node, -1, self._tick())
        match.cow_node = None

    # --------------------------------------------------------- eviction

    def evictable_pages(self) -> int:
        """Pages reclaimable right now: every page in a ``lock_ref == 0``
        node (path-locking makes lock_ref==0 imply the whole subtree is
        unlocked, so leaf-first eviction can reach all of them in one
        ``reclaim`` call).  A maintained int — GIL-atomic for the
        gateway's cross-thread pressure reads (no tree walk here; the
        randomized invariant test checks it against an independent DFS
        every step)."""
        return self._evictable

    def reclaim(self, n: int) -> int:
        """PageAllocator's on-demand hook: free at least ``n`` pages if
        reclaimable (LRU leaves first)."""
        return self.evict(n, reason="lru")

    def evict(self, n: int, reason: str = "lru") -> int:
        """LRU walk over refcount-0 leaves: free up to ``n`` pages back
        to the allocator, cascading into parents as they become
        childless.  Returns pages actually freed."""
        if n <= 0:
            return 0

        def _evict_leaf(node: RadixNode) -> bool:
            # "leaf" for eviction purposes: nothing device-resident
            # BELOW it.  Host-swapped children are page-less, so a
            # node whose children are all swapped must still count —
            # otherwise a single swapped leaf would pin its whole
            # ancestor chain out of the walk while _evictable keeps
            # counting those pages (reclaim would under-deliver and
            # allocate() would refuse work the accounting promised).
            return (
                node.lock_ref == 0
                and bool(node.pages)
                and all(
                    g.swapped is not None
                    for g in node.children.values()
                )
            )

        heap: List[Tuple[int, int, RadixNode]] = []
        stack = [self.root]
        serial = 0
        while stack:
            node = stack.pop()
            for child in node.children.values():
                if _evict_leaf(child):
                    serial += 1
                    heapq.heappush(
                        heap, (child.last_access, serial, child)
                    )
                elif child.swapped is None:
                    stack.append(child)
                # swapped nodes: nothing device-resident in their
                # subtree (children of a swapped node are themselves
                # swapped); the host pool's LRU owns their lifetime
        freed = 0
        while heap and freed < n:
            _, _, leaf = heapq.heappop(heap)
            released = leaf.pages
            # count only pages whose tree reference was the LAST one
            # (the lock/ref pairing makes that all of them; defensive
            # against a caller unlocking without releasing)
            gone = sum(
                1 for p in released if self.allocator.refcount(p) == 1
            )
            # host swap tier: demote the content before the device
            # pages go — the node stays in the tree page-less (victim
            # cache) and a later match() promotes it back.  Demotion
            # declined (pool off/full, brownout L4) keeps the original
            # discard.
            ticket = (
                self.swap.demote_node(leaf, released)
                if self.swap is not None
                else None
            )
            self._evictable -= len(released)
            self.allocator.release(released)
            freed += gone
            parent = leaf.parent
            if ticket is not None:
                leaf.swapped = ticket
                leaf.pages = []
                self._swapped_nodes += 1
                self.total_demoted_pages += len(released)
                # the node stays its parent's child (victim cache)
            else:
                # truly discard — including any swapped descendants,
                # whose tickets would otherwise leak in the host pool
                # with their nodes unreachable
                self._drop_swapped_descendants(leaf)
                del parent.children[leaf.tokens[: self.page_size]]
                self.total_nodes -= 1
            if (
                parent is not self.root
                and _evict_leaf(parent)
            ):
                # cascade: the parent may have just become an eviction
                # leaf (childless, or all children now swapped)
                serial += 1
                heapq.heappush(
                    heap, (parent.last_access, serial, parent)
                )
            self.total_evictions[reason] = (
                self.total_evictions.get(reason, 0) + len(released)
            )
        if freed:
            self._touch_gauges()
        return freed

    def _drop_swapped_descendants(self, node: RadixNode) -> None:
        """Discard the host tickets of every swapped node under
        ``node`` (exclusive) — they are about to become unreachable."""
        stack = list(node.children.values())
        while stack:
            child = stack.pop()
            stack.extend(child.children.values())
            if child.swapped is not None:
                ticket = child.swapped
                child.swapped = None
                self._swapped_nodes -= 1
                if self.swap is not None:
                    self.swap.drop_node_ticket(ticket, "capacity")
            self.total_nodes -= 1

    def drop_swapped(self, node: RadixNode, reason: str = "capacity") -> None:
        """Unlink a host-swapped (page-less) node: the manager dropped
        its ticket to make room for a preemption swap-out, or its
        promotion failed.  Swapped descendants (demotion chains) go
        with it — their tickets would otherwise leak unreachable.
        Idempotent against the manager's own ticket accounting
        (drop_node_ticket refunds only a still-registered ticket)."""
        ticket = node.swapped
        node.swapped = None
        if ticket is not None:
            self._swapped_nodes -= 1
            if self.swap is not None:
                self.swap.drop_node_ticket(ticket, reason)
        self._drop_swapped_descendants(node)
        parent = node.parent
        if parent is not None:
            key = node.tokens[: self.page_size]
            if parent.children.get(key) is node:
                del parent.children[key]
                self.total_nodes -= 1
        node.parent = None

    def trim_to_watermark(self, target_free: int) -> int:
        """Proactive pressure trim: top the allocator's *truly free*
        list back up to ``target_free`` pages by evicting cold cache
        (reason ``pressure``).  Called from the engine tick so the
        eviction walk is paid off the allocation hot path, BEFORE
        admission's kv_pressure watermark could start shedding."""
        short = target_free - self.allocator.num_truly_free
        if short <= 0 or self.evictable_pages() == 0:
            return 0
        return self.evict(short, reason="pressure")

    # ----------------------------------------------------- introspection

    def _touch_gauges(self) -> None:
        pass

    def pages_in_tree(self) -> Dict[int, RadixNode]:
        """page id -> owning node, for invariant checks (a physical page
        must never be indexed twice)."""
        out: Dict[int, RadixNode] = {}
        stack = [self.root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                for p in child.pages:
                    assert p not in out, f"page {p} doubly indexed"
                    out[p] = child
                stack.append(child)
        return out

    def get_stats(self) -> dict:
        return {
            "nodes": self.total_nodes,
            "cached_pages": self.evictable_pages(),
            "inserted_pages": self.total_inserted_pages,
            "evictions": dict(self.total_evictions),
            "insert_suspended": self.insert_suspended,
            **(
                {
                    "swapped_nodes": self._swapped_nodes,
                    "demoted_pages": self.total_demoted_pages,
                    "promoted_pages": self.total_promoted_pages,
                    "insert_blocked_on_swap": (
                        self.total_insert_blocked_on_swap
                    ),
                }
                if self.swap is not None
                else {}
            ),
        }
