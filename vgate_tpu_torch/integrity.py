"""Silent-corruption defense: sentinels, weight checksums, canaries.

The port's copy of vgate_tpu/integrity.py.  A bit flipped in a weight
on the card survives every weights-kept restart, so the serving stack
has three independent ways to *notice* corruption and one typed way to
react:

* **Output sentinels** — a per-slot flag word computed from the decode
  logits inside the decode chunk (:func:`logit_guard`: NaN/Inf, all-zero
  rows, saturated rows; on the card it is written inside the captured
  graph into a ``DecodeState`` buffer and read back with the tokens),
  plus host-side checks over the readback (token ids outside the
  vocabulary, token-entropy collapse of a *sampled* generation).  A hard
  trip discards the poisoned chunk BEFORE any token is appended or
  streamed and raises :class:`~vgate_tpu_torch.errors.IntegrityError`
  with per-sequence attribution.
* **Weight checksum sweeps** — a per-leaf digest baseline recorded when
  the (quantized) tree is placed, re-verified a few leaves at a time on
  idle ticks and in full whenever a supervised rebuild wants to keep
  the old tree (runtime/engine_core.py ``rebuild_core``).  On the card
  each digest is one launch of the hand-written reduction
  (ops/kernels/leaf_digest.py) and a one-word readback.
* **Canary self-probes** — a pinned greedy prompt with a recorded
  output fingerprint, run after a reload and on a slow timer.

The supervisor classifies ``IntegrityError`` fatals as ``corrupt`` and
rebuilds with a full weight **reload**, holding the engine in
RECOVERING until its post-reload canary passes.

Digests are wraparound uint32 sums over the leaf's *bit pattern* with a
positional weight; not cryptographic — the adversary is a flipped bit.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vgate_tpu_torch import faults
from vgate_tpu_torch.errors import IntegrityError
from vgate_tpu_torch.logging_config import get_logger
from vgate_tpu_torch.ops.kernels import leaf_digest as _digest_kernel
from vgate_tpu_torch.runtime import engine_metrics as metrics

logger = get_logger(__name__)

# logit-guard flag bits ([B] uint8 computed inside the decode chunk)
FLAG_NONFINITE = 1  # NaN/Inf anywhere in the row
FLAG_ZERO = 2  # every logit exactly 0.0 (dead matmul / zeroed shard)
FLAG_SATURATED = 4  # |logit| at/above the saturation threshold

_FLAG_KINDS = (
    (FLAG_NONFINITE, "logit_nonfinite"),
    (FLAG_ZERO, "logit_zero"),
    (FLAG_SATURATED, "logit_saturated"),
)


def logit_guard(logits: torch.Tensor,
                saturate_threshold: float) -> torch.Tensor:
    """Per-row guard flags from a ``[B, V]`` logits tensor, as torch ops
    that neither sync the host nor allocate outside the caller's stream,
    so the decode chunk runs it inside its captured graph.  Returns
    ``[B] uint8`` (bits above).  The row max of ``|logits|`` is NaN on a
    row holding a NaN (torch propagates it), so that row is neither
    all-zero nor saturated — the nonfinite bit owns it, as in the
    reference, whose ``all(logits == 0)`` and ``max`` comparison are
    False there too."""
    finite = torch.isfinite(logits).all(dim=-1)
    peak = logits.abs().amax(dim=-1)
    return (
        (~finite).to(torch.uint8) * FLAG_NONFINITE
        | (peak == 0).to(torch.uint8) * FLAG_ZERO
        | (peak >= saturate_threshold).to(torch.uint8) * FLAG_SATURATED
    )


# --------------------------------------------------------------- digests


# positional-weight modulus (largest prime < 2^16): makes the digest
# sensitive to element *position*, not just the multiset of bit patterns
_WEIGHT_MOD = _digest_kernel.WEIGHT_MOD


def leaf_digest(x) -> int:
    """Wraparound-uint32 positional digest of one leaf's bit pattern.
    Works for float (bf16/f32), int8 quantized data, packed uint8 and
    scale leaves alike.  A tensor on the card reduces there (one kernel
    launch, a one-word readback); a CPU tensor through the plain
    version; numpy leaves through :func:`host_leaf_digest`."""
    if isinstance(x, np.ndarray) or np.isscalar(x):
        return host_leaf_digest(np.asarray(x))
    return _digest_kernel.leaf_digest(x)


def host_leaf_digest(arr) -> int:
    """Numpy twin of :func:`leaf_digest` — the reference's formula, so a
    host-side load digest and a device-side verify of the identical bit
    pattern agree.  A torch tensor is read as the integers of its width
    (torch's bf16 has no numpy dtype)."""
    if isinstance(arr, torch.Tensor):
        arr = _digest_kernel.bits_view(arr.detach().cpu()).numpy()
    arr = np.asarray(arr)
    if arr.dtype.itemsize == 8:  # pragma: no cover - no 64-bit leaves
        arr = arr.astype(np.float32)
    flat = np.ravel(arr)
    width = {1: np.uint8, 2: np.uint16, 4: np.uint32}[arr.dtype.itemsize]
    bits = flat.view(width).astype(np.uint32)
    weights = (
        np.arange(flat.shape[0], dtype=np.uint32) % _WEIGHT_MOD
    ) + 1
    return int(
        np.sum(bits * weights, dtype=np.uint32)
    )


def leaves_with_path(params: Any) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of a parameter tree in the reference's order and
    with its path strings (``jax.tree_util.keystr``): dict keys sorted,
    ``['key']``; the ``QTensor``/``PackedQTensor`` fields ``.name``;
    list items ``[i]``.  None leaves are skipped, as pytrees skip them."""
    out: List[Tuple[str, Any]] = []

    def walk(node: Any, path: str) -> None:
        if node is None:
            return
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], f"{path}[{key!r}]")
        elif hasattr(node, "_fields"):
            for name in node._fields:
                walk(getattr(node, name), f"{path}.{name}")
        elif isinstance(node, (list, tuple)):
            for i, item in enumerate(node):
                walk(item, f"{path}[{i}]")
        else:
            out.append((path, node))

    walk(params, "")
    return out


def tree_digests(params: Any) -> Dict[str, int]:
    """Per-leaf digest map for a parameter tree (quantized trees
    included — their data/scale leaves digest independently, so a flip
    in either is caught)."""
    return {path: leaf_digest(x) for path, x in leaves_with_path(params)}


def digest_summary(digests: Dict[str, int]) -> Dict[str, Any]:
    """Loggable one-liner: leaf count + a combined tree digest."""
    combined = 0
    for path in sorted(digests):
        combined = (combined * 1000003 + digests[path]) & 0xFFFFFFFF
    return {"leaves": len(digests), "tree_digest": f"{combined:08x}"}


def _bitflip_leaf(x: torch.Tensor, mask: int = 0x55) -> torch.Tensor:
    """XOR every element's bit pattern with ``mask``, IN PLACE, through a
    view as the signed integer of the same width (torch's unsigned types
    lack most ops; the bits are the same) — the fault-injection payload
    behind the ``weight_corrupt`` probe point.  In place, so the decode
    graphs, which captured the leaf's address, read the corrupted bits:
    a real corruption (checksums mismatch, outputs go wrong, the canary
    fails).  Returns ``x``."""
    bits = x.view(_digest_kernel._INT_OF_WIDTH[x.element_size()])
    bits.bitwise_xor_(mask)
    return x


# ------------------------------------------------------------ sentinels


class SentinelScanner:
    """Host-side output sentinels over one decode-chunk readback.
    Stateless between calls except trip counters; the entropy window is
    derived from each sequence's own ``output_ids`` so it survives
    preemption/replay without private bookkeeping."""

    def __init__(self, cfg, vocab_size: int) -> None:
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.trips: Dict[str, int] = {}

    def _trip(
        self, kind: str, seq, trips: List[Tuple[str, Any]]
    ) -> None:
        self.trips[kind] = self.trips.get(kind, 0) + 1
        metrics.INTEGRITY_EVENTS.labels(kind=kind).inc()
        trips.append((kind, seq))

    def scan_decode(
        self,
        sampled: np.ndarray,  # [chunk, B] host tokens
        flags: Optional[np.ndarray],  # [B] uint8 guard word or None
        seq_rows: List[Tuple[Any, int]],  # (live seq, slot) pairs
        chunk: int,
    ) -> List[Tuple[str, Any]]:
        """Scan one chunk readback BEFORE any token is appended.
        Returns ``[(kind, seq), ...]`` trips (empty when clean); the
        caller discards the chunk and raises IntegrityError on any."""
        cfg = self.cfg
        trips: List[Tuple[str, Any]] = []
        for seq, slot in seq_rows:
            if flags is not None and flags[slot]:
                word = int(flags[slot])
                for bit, kind in _FLAG_KINDS:
                    if word & bit:
                        self._trip(kind, seq, trips)
                continue  # one attribution per row is enough
            col = sampled[:chunk, slot]
            if np.any(col < 0) or np.any(col >= self.vocab_size):
                self._trip("token_range", seq, trips)
                continue
            # entropy collapse: a *sampled* generation emitting fewer
            # than entropy_min_distinct distinct tokens over a full
            # window is a collapsed distribution (greedy loops are
            # legitimate, so temperature gates the check)
            window = cfg.entropy_window
            if (
                window > 0
                and seq.params.temperature >= cfg.entropy_min_temp
                and len(seq.output_ids) + chunk >= window
            ):
                tail = seq.output_ids[-(window - chunk):] if (
                    window > chunk
                ) else []
                recent = list(tail) + [int(t) for t in col]
                if len(set(recent[-window:])) < cfg.entropy_min_distinct:
                    self._trip("entropy_collapse", seq, trips)
        return trips


# --------------------------------------------------------- weight sweeps


class WeightVerifier:
    """Baseline digests + the budgeted re-verification cursor.  One
    instance per EngineCore; ``verify_chunk`` is called from idle ticks
    only (never steals a decode tick) and walks ``leaves_per_tick``
    leaves per call, pacing full passes ``interval_s`` apart."""

    def __init__(self, cfg) -> None:
        self.cfg = cfg
        self.baseline: Dict[str, int] = {}
        self._order: List[str] = []
        self._cursor = 0
        self._next_pass_t = 0.0
        # path->leaf map cached per tree identity: rebuilding it costs
        # an O(leaves) flatten + keystr pass, which a 2-leaves-per-tick
        # budget must not pay on every idle tick
        self._leaf_cache: Optional[Dict[str, Any]] = None
        self._leaf_cache_src: Optional[int] = None
        self.sweeps_completed = 0
        self.leaves_verified = 0
        self.mismatches = 0

    def record(self, params: Any) -> Dict[str, Any]:
        start = time.perf_counter()
        self.baseline = tree_digests(params)
        self._order = sorted(self.baseline)
        self._cursor = 0
        self._leaf_cache = None
        self._leaf_cache_src = None
        self._next_pass_t = time.monotonic() + self.cfg.sweep_interval_s
        elapsed = time.perf_counter() - start
        metrics.WEIGHT_VERIFY_SECONDS.observe(elapsed)
        summary = digest_summary(self.baseline)
        summary["record_s"] = round(elapsed, 4)
        return summary

    def _leaf_map(self, params: Any) -> Dict[str, Any]:
        # keyed on tree identity: a reload builds a new tree object,
        # and the weight_corrupt injection flips bits in place in the
        # same tensors this map holds
        if (
            self._leaf_cache is None
            or self._leaf_cache_src != id(params)
        ):
            self._leaf_cache = dict(leaves_with_path(params))
            self._leaf_cache_src = id(params)
        return self._leaf_cache

    def _check(
        self, paths: List[str], leaf_map: Dict[str, Any]
    ) -> Optional[Dict[str, Any]]:
        for path in paths:
            leaf = leaf_map.get(path)
            digest = None if leaf is None else leaf_digest(leaf)
            self.leaves_verified += 1
            metrics.WEIGHT_LEAVES_VERIFIED.inc()
            if digest != self.baseline[path]:
                self.mismatches += 1
                metrics.INTEGRITY_EVENTS.labels(
                    kind="checksum_mismatch"
                ).inc()
                return {
                    "leaf": path,
                    "expected": self.baseline[path],
                    "got": digest,
                }
        return None

    def check_paths(
        self, params: Any, paths: List[str]
    ) -> Optional[Dict[str, Any]]:
        """The first mismatch among ``paths`` of ``params`` (a mesh
        follower's check of the slice rank 0 sweeps: those of its own
        leaves, as a pipeline stage past 0 holds no embedding or head),
        or None."""
        held = [p for p in paths if p in self.baseline]
        return self._check(held, self._leaf_map(params))

    def verify_chunk(
        self, params: Any, now: Optional[float] = None, remote=None
    ) -> Optional[Dict[str, Any]]:
        """Verify the next budgeted slice of leaves; returns the first
        mismatch found (None while clean or between passes).  ``remote``
        (a tp group's rank 0) checks the same paths in the other ranks'
        shards, and its mismatch is returned like a local one."""
        if not self.baseline:
            return None
        now = time.monotonic() if now is None else now
        if self._cursor == 0 and now < self._next_pass_t:
            return None  # between passes
        start = time.perf_counter()
        n = max(1, self.cfg.sweep_leaves_per_tick)
        paths = self._order[self._cursor : self._cursor + n]
        mismatch = self._check(paths, self._leaf_map(params))
        if mismatch is None and remote is not None:
            mismatch = remote(paths)
        metrics.WEIGHT_VERIFY_SECONDS.observe(
            time.perf_counter() - start
        )
        if mismatch is not None:
            return mismatch
        self._cursor += len(paths)
        if self._cursor >= len(self._order):
            self._cursor = 0
            self.sweeps_completed += 1
            self._next_pass_t = now + self.cfg.sweep_interval_s
        return None

    def verify_all(
        self, params: Any, remote=None
    ) -> Optional[Dict[str, Any]]:
        """Full-tree verification (supervised rebuilds ALWAYS run this
        before keeping the old incarnation's weights), ``remote`` as in
        :meth:`verify_chunk`."""
        if not self.baseline:
            return None
        start = time.perf_counter()
        mismatch = self._check(self._order, self._leaf_map(params))
        if mismatch is None and remote is not None:
            mismatch = remote(self._order)
        metrics.WEIGHT_VERIFY_SECONDS.observe(
            time.perf_counter() - start
        )
        return mismatch

    def next_path(self) -> Optional[str]:
        if not self._order:
            return None
        return self._order[self._cursor % len(self._order)]

    def stats(self) -> Dict[str, Any]:
        return {
            "leaves": len(self._order),
            "sweeps_completed": self.sweeps_completed,
            "leaves_verified": self.leaves_verified,
            "mismatches": self.mismatches,
        }


# --------------------------------------------------------- per-core glue

# sentinel kinds that are SOFT evidence: a model-behavior artifact
# (degenerate repetition, bias-constrained sampling) is far more likely
# than hardware corruption, so the engine fails only the attributed
# sequence instead of reloading weights for the whole replica
SOFT_SENTINELS = frozenset({"entropy_collapse"})


def _attribution(trips) -> List[Dict[str, Any]]:
    return [
        {
            "kind": kind,
            "seq_id": seq.seq_id,
            "request_id": seq.request_id,
            # the poison-streak quarantine keys on this: a request that
            # deterministically trips sentinels (NaN-overflowing prompt)
            # must be containable, or it drives a reload loop
            "fingerprint": faults.fingerprint(
                seq.prompt_ids[: seq.orig_prompt_len]
            ),
        }
        for kind, seq in trips
    ]


class EngineIntegrity:
    """One EngineCore's integrity state: sentinel scanner + weight
    verifier + the weight_corrupt fault hook.  Constructed only when
    ``integrity.enabled`` — a None attribute keeps the disabled path
    byte-identical to the pre-integrity engine."""

    def __init__(self, cfg, vocab_size: int) -> None:
        self.cfg = cfg
        self.sentinels = (
            SentinelScanner(cfg, vocab_size)
            if cfg.sentinels_enabled
            else None
        )
        self.verifier = WeightVerifier(cfg) if cfg.sweep_enabled else None

    @property
    def guard_enabled(self) -> bool:
        """Fold the on-device logit guard into the decode chunk?"""
        return bool(
            self.sentinels is not None and self.cfg.logit_guard
        )

    def record_baseline(self, params: Any) -> None:
        if self.verifier is None:
            return
        summary = self.verifier.record(params)
        logger.info(
            "weight checksum baseline recorded",
            extra={"extra_data": summary},
        )

    def scan_decode(
        self, sampled, flags, seq_rows, chunk
    ) -> List[tuple]:
        """Sentinel scan over one chunk readback.  HARD trips (logit
        flags, out-of-vocab tokens — strong corruption evidence) raise
        IntegrityError so the whole chunk is discarded and the engine
        fatals corrupt; SOFT trips (entropy collapse — far more likely
        a model-behavior artifact than hardware) are returned as
        ``[(kind, seq, exc)]`` for the engine to fail per-sequence
        without touching the replica.  Empty list when clean or
        disabled."""
        if self.sentinels is None:
            return []
        trips = self.sentinels.scan_decode(sampled, flags, seq_rows, chunk)
        if not trips:
            return []
        hard = [t for t in trips if t[0] not in SOFT_SENTINELS]
        soft = [t for t in trips if t[0] in SOFT_SENTINELS]
        if hard:
            kinds = sorted({kind for kind, _ in hard})
            raise IntegrityError(
                "output sentinel tripped "
                f"({', '.join(kinds)}) on {len(hard)} sequence(s); "
                "discarding the poisoned chunk and reloading weights",
                kind=kinds[0],
                sequences=_attribution(hard),
            )
        return [
            (
                kind,
                seq,
                IntegrityError(
                    f"output sentinel tripped ({kind}) on this "
                    "sequence; its generation was stopped (the engine "
                    "and its weights are not suspected)",
                    kind=kind,
                    sequences=_attribution([(kind, seq)]),
                ),
            )
            for kind, seq in soft
        ]

    def maybe_inject_weight_fault(self, core: Any) -> None:
        """``weight_corrupt`` probe point (corrupt mode): when armed and
        it fires, XOR-corrupt the sweep's next-to-verify leaf ON DEVICE,
        in place — a true silent corruption the checksum sweep then
        detects.
        Raise-mode specs at the same point fire through faults.check
        (classified by their armed kind, e.g. kind=corrupt drills the
        classification path without touching weights)."""
        if not faults.is_active():
            return
        faults.check("weight_corrupt")
        if self.verifier is None or not faults.take_corrupt(
            "weight_corrupt"
        ):
            return
        target = self.verifier.next_path()
        if target is None:
            return
        _bitflip_leaf(dict(leaves_with_path(core.params))[target])
        logger.error(
            "weight_corrupt fault injected: flipped bits in one "
            "weight shard on device",
            extra={"extra_data": {"leaf": target}},
        )

    def idle_tick(self, core: Any) -> None:
        """Budgeted idle-tick sweep step.  Raises IntegrityError on a
        checksum mismatch; the engine loop's containment then routes it
        to the supervisor/dp repair as a ``corrupt`` fatal."""
        self.maybe_inject_weight_fault(core)
        if self.verifier is None:
            return
        # on a mesh each follower sweeps the same leaves of its own shard
        mesh = getattr(core, "mesh", None)
        multi = mesh is not None and mesh.num_devices > 1
        remote = core._follower_check if multi else None
        mismatch = self.verifier.verify_chunk(core.params, remote=remote)
        if mismatch is None:
            return
        raise IntegrityError(
            "weight checksum sweep detected silent corruption in "
            f"shard {mismatch['leaf']!r} (expected "
            f"{mismatch['expected']:#010x}, got "
            + (
                f"{mismatch['got']:#010x}"
                if mismatch["got"] is not None
                else "a missing leaf"
            )
            + "); weights must be reloaded",
            kind="checksum_mismatch",
            detail=mismatch,
        )

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"enabled": True}
        if self.sentinels is not None:
            out["sentinel_trips"] = dict(self.sentinels.trips)
        if self.verifier is not None:
            out["sweep"] = self.verifier.stats()
        return out


# --------------------------------------------------------------- canary


def canary_prompt_ids(vocab_size: int, length: int) -> List[int]:
    """The pinned canary prompt: deterministic, model-agnostic token
    ids spread across the vocabulary (never depends on a tokenizer
    being present)."""
    v = max(2, int(vocab_size))
    return [(i * 17 + 11) % v for i in range(max(1, length))]


def canary_fingerprint(token_ids: List[int]) -> str:
    import hashlib

    data = ",".join(str(int(t)) for t in token_ids).encode()
    return hashlib.sha1(data).hexdigest()[:16]


class CanaryKeeper:
    """Pinned greedy self-probe with a recorded output fingerprint.
    The FIRST probe against a presumed-good core records; every later
    probe verifies.  Shared across dp replicas (identical weights +
    greedy decode ⇒ identical fingerprint), owned by the supervisor for
    dp=1."""

    def __init__(self, cfg) -> None:
        self.cfg = cfg
        self.expected: Optional[str] = None
        self.passes = 0
        self.failures = 0
        self.last: Optional[Dict[str, Any]] = None

    def _run(self, core: Any) -> List[int]:
        # imported here: integrity must stay importable without the
        # runtime package (errors.py-style layering for tests)
        from vgate_tpu_torch.backends.base import SamplingParams
        from vgate_tpu_torch.runtime.sequence import Sequence, SeqStatus

        cfg = self.cfg
        ids = canary_prompt_ids(
            core.spec.vocab_size, cfg.canary_prompt_len
        )
        params = SamplingParams(
            temperature=0.0, max_tokens=cfg.canary_max_tokens
        )
        seq = Sequence(prompt_ids=ids, params=params, canary=True)
        # compile-aware deadline (the stall watchdog's compile_grace_s
        # lesson): the canary is often the FIRST work on a fresh core
        # (post-reload), so its decode graphs are captured, and its
        # kernels maybe built, inside the probe.  Judging
        # that against the steady-state timeout would quarantine a
        # healthy replica and burn the restart budget on reload loops.
        timeout = cfg.canary_timeout_s
        if getattr(core, "total_steps", 1) == 0:
            timeout += cfg.canary_compile_grace_s
        core.submit_existing(seq)
        if not seq.done_event.wait(timeout=timeout):
            seq.request_abort(reason="drain")
            raise TimeoutError(
                f"canary self-probe timed out after {timeout}s"
            )
        if seq.status is SeqStatus.FAILED:
            raise RuntimeError(
                f"canary self-probe failed: {seq.error}"
            ) from seq.error
        return list(seq.generated_ids)

    def check(self, core: Any, context: str = "probe") -> Dict[str, Any]:
        """Run the probe; returns ``{"ok": bool, "recorded": bool,
        ...}``.  ``ok`` is False only on a *fingerprint mismatch or
        probe error* — the recording run reports ok=True/recorded=True.
        Never raises; errors count as failures (a core that cannot
        answer its canary is not servable)."""
        start = time.perf_counter()
        result: Dict[str, Any] = {
            "context": context,
            "time": time.time(),
        }
        try:
            out = self._run(core)
        except Exception as exc:
            self.failures += 1
            metrics.CANARY_FAILURES.inc()
            metrics.INTEGRITY_EVENTS.labels(kind="canary_fail").inc()
            result.update(
                ok=False, recorded=False,
                error=f"{type(exc).__name__}: {exc}",
            )
            self.last = result
            return result
        fp = canary_fingerprint(out)
        result["fingerprint"] = fp
        result["tokens"] = len(out)
        result["latency_s"] = round(time.perf_counter() - start, 4)
        if self.expected is None:
            self.expected = fp
            result.update(ok=True, recorded=True)
            metrics.INTEGRITY_EVENTS.labels(kind="canary_pass").inc()
            logger.info(
                "canary fingerprint recorded",
                extra={"extra_data": result},
            )
        elif fp == self.expected:
            self.passes += 1
            result.update(ok=True, recorded=False)
            metrics.INTEGRITY_EVENTS.labels(kind="canary_pass").inc()
        else:
            self.failures += 1
            metrics.CANARY_FAILURES.inc()
            metrics.INTEGRITY_EVENTS.labels(kind="canary_fail").inc()
            result.update(
                ok=False, recorded=False, expected=self.expected
            )
            logger.error(
                "canary self-probe FINGERPRINT MISMATCH — replica "
                "output is corrupt",
                extra={"extra_data": result},
            )
        self.last = result
        return result

    def stats(self) -> Dict[str, Any]:
        return {
            "expected": self.expected,
            "passes": self.passes,
            "failures": self.failures,
            "last": self.last,
        }
