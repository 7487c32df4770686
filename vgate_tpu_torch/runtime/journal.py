"""Durable request journal + idempotency keys (gateway survivability).

The gateway's half of the crash-survivability story (the workers' half
is orphan mode, ``pod.orphan_grace_s``): every accepted non-streaming
request that carries an ``Idempotency-Key`` header is appended to an
append-only JSONL journal *before* dispatch and settled with its result
body on completion.  A gateway that crashes mid-request therefore
leaves a durable record of what it had promised; its successor replays
the journal at startup and

* a client retry whose generation already completed (typically on an
  orphaned worker the successor adopted) returns the **identical**
  result body with zero recompute — ``vgt_journal_replays{outcome=
  "served"}``;
* an accepted-but-unsettled record re-submits through the normal
  admission path (``outcome="resubmitted"``), so the work is not lost
  even when the client never retries;
* a key that is still in flight on the live gateway gets a typed 409
  (:class:`~vgate_tpu_torch.errors.DuplicateRequestError`,
  ``outcome="duplicate"``) — two generations must never race under one
  key;
* a record that cannot be replayed (malformed snapshot, truncated
  tail) is counted (``outcome="failed"``) and skipped, never a crash.

Durability discipline: one JSON object per line, ``fsync`` after every
append (``gateway.journal_fsync``), and a loader that tolerates exactly
one torn record at the tail — the only partial write a crashed
``append → fsync`` sequence can leave.  A torn record anywhere else is
corruption and fails loudly.  Compaction (triggered past
``gateway.journal_max_bytes``) rewrites the file keeping only live
records: pending ones, and settled ones younger than
``gateway.journal_retention_s`` (still replayable to a retrying
client).

Wall-clock timestamps (``time.time``) are used deliberately — records
must stay meaningful across process restarts, which excludes
``perf_counter``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from vgate_tpu_torch import metrics
from vgate_tpu_torch.errors import DuplicateRequestError
from vgate_tpu_torch.logging_config import get_logger

logger = get_logger(__name__)

# Threading contract (scripts/vgt_lint.py, checker thread-discipline):
# _lock is a LEAF — held across the in-memory table AND the file append
# (ordering of journal lines must match ordering of state transitions),
# but nothing else is ever acquired under it.
VGT_COMPONENTS: Dict[str, str] = {}
VGT_LOCK_GUARDS = {
    "_records": "_lock",
}

# record states
PENDING = "pending"
SETTLED = "settled"
FAILED = "failed"


class JournalRecord:
    __slots__ = (
        "key", "state", "request_id", "endpoint", "snapshot",
        "result", "accepted_t", "settled_t", "inherited",
    )

    def __init__(
        self,
        key: str,
        request_id: str,
        endpoint: str,
        snapshot: Dict[str, Any],
        accepted_t: float,
    ) -> None:
        self.key = key
        self.state = PENDING
        self.request_id = request_id
        self.endpoint = endpoint
        self.snapshot = snapshot
        self.result: Optional[Dict[str, Any]] = None
        self.accepted_t = accepted_t
        self.settled_t: Optional[float] = None
        # loaded from a PREDECESSOR's journal (vs accepted this
        # lifetime).  A retry hitting an inherited pending key waits
        # for the startup replay to settle it — the original attempt
        # died with the old gateway, so 409 "wait for the original"
        # would dead-end the client.
        self.inherited = False

    def as_dict(self) -> Dict[str, Any]:
        return {
            "key": self.key,
            "state": self.state,
            "request_id": self.request_id,
            "endpoint": self.endpoint,
            "accepted_t": self.accepted_t,
            "settled_t": self.settled_t,
            "inherited": self.inherited,
        }


class RequestJournal:
    """Append-only fsync'd JSONL journal of idempotent requests.

    ``path=None`` runs fully in memory: idempotency still works within
    one gateway lifetime (duplicate 409s, settled replays), it just
    does not survive a restart — the mode tests and journal-less
    deployments get by default.
    """

    def __init__(
        self,
        path: Optional[str] = None,
        *,
        fsync: bool = True,
        max_bytes: int = 16 * 1024 * 1024,
        retention_s: float = 3600.0,
    ) -> None:
        self.path = path or None
        self.fsync = bool(fsync)
        self.max_bytes = int(max_bytes)
        self.retention_s = float(retention_s)
        self._lock = threading.Lock()
        self._records: Dict[str, JournalRecord] = {}
        self._fh = None
        self._bytes = 0
        self._torn_tail = False
        if self.path:
            # nothing shares the journal yet, but _load/_apply assert
            # _lock discipline (they also run under compaction) — hold
            # it for real rather than special-casing construction
            with self._lock:
                self._load()
                self._open_for_append()
            self._set_bytes_gauge()

    # ------------------------------------------------------------- loading

    def _load(self) -> None:
        """Rebuild the in-memory table from the journal file.  Tolerant
        of exactly one torn record at the tail (a crash mid-append);
        torn records elsewhere indicate corruption and raise."""
        if not self.path or not os.path.exists(self.path):
            return
        torn_at: Optional[int] = None
        with open(self.path, "rb") as fh:
            lines = fh.read().split(b"\n")
        # a trailing newline yields one empty final element; drop it
        if lines and lines[-1] == b"":
            lines.pop()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                op = json.loads(line.decode("utf-8"))
                if not isinstance(op, dict):
                    raise ValueError("journal line is not an object")
            except (ValueError, UnicodeDecodeError) as exc:
                if i == len(lines) - 1:
                    # the one legal torn record: a crash between the
                    # append and its newline/fsync
                    torn_at = i
                    logger.warning(
                        "journal: dropping torn trailing record "
                        "(crash mid-append): %s", exc,
                    )
                    break
                raise RuntimeError(
                    f"journal {self.path} corrupt at line {i + 1}: {exc}"
                ) from exc
            self._apply(op)
        self._torn_tail = torn_at is not None
        if self._torn_tail:
            # rewrite without the torn tail so the next append starts
            # at a clean record boundary
            self._compact_locked()

    def _apply(self, op: Dict[str, Any]) -> None:
        kind = op.get("op")
        key = op.get("key")
        if not isinstance(key, str) or not key:
            raise RuntimeError(f"journal record missing key: {op!r}")
        if kind == "accept":
            rec = JournalRecord(
                key,
                str(op.get("request_id") or ""),
                str(op.get("endpoint") or ""),
                dict(op.get("snapshot") or {}),
                float(op.get("t") or 0.0),
            )
            rec.inherited = True  # _apply only runs from _load
            self._records[key] = rec
        elif kind == "settle":
            rec = self._records.get(key)
            if rec is not None:
                rec.state = SETTLED
                rec.result = op.get("result")
                rec.settled_t = float(op.get("t") or 0.0)
        elif kind == "fail":
            rec = self._records.get(key)
            if rec is not None:
                rec.state = FAILED
                rec.settled_t = float(op.get("t") or 0.0)
        else:
            raise RuntimeError(f"journal record with unknown op: {kind!r}")

    # ------------------------------------------------------------ appending

    def _open_for_append(self) -> None:
        if not self.path:
            return
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        self._fh = open(self.path, "ab")
        self._bytes = self._fh.tell()

    def _append_locked(self, op: Dict[str, Any]) -> None:
        if self._fh is None:
            return
        data = json.dumps(op, separators=(",", ":")).encode("utf-8")
        self._fh.write(data + b"\n")
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        self._bytes += len(data) + 1
        if self._bytes > self.max_bytes:
            self._compact_locked()
        self._set_bytes_gauge()

    def _set_bytes_gauge(self) -> None:
        try:
            metrics.JOURNAL_BYTES.set(self._bytes)
        except Exception:  # noqa: BLE001 — telemetry never fails an append
            pass

    # ----------------------------------------------------------- compaction

    def _live_records(self) -> List[JournalRecord]:
        now = time.time()
        live = []
        for rec in self._records.values():
            if rec.state == PENDING:
                live.append(rec)
            elif rec.state == SETTLED:
                if (now - (rec.settled_t or now)) < self.retention_s:
                    live.append(rec)
            # FAILED records are never replayable; drop at compaction
        return live

    def _compact_locked(self) -> None:
        if not self.path:
            return
        live = self._live_records()
        tmp = self.path + ".compact"
        with open(tmp, "wb") as out:
            for rec in sorted(live, key=lambda r: r.accepted_t):
                out.write(json.dumps({
                    "op": "accept", "key": rec.key,
                    "request_id": rec.request_id,
                    "endpoint": rec.endpoint,
                    "snapshot": rec.snapshot, "t": rec.accepted_t,
                }, separators=(",", ":")).encode("utf-8") + b"\n")
                if rec.state == SETTLED:
                    out.write(json.dumps({
                        "op": "settle", "key": rec.key,
                        "result": rec.result, "t": rec.settled_t,
                    }, separators=(",", ":")).encode("utf-8") + b"\n")
            out.flush()
            os.fsync(out.fileno())
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        os.replace(tmp, self.path)
        # drop compacted-away records from memory too, so the table
        # cannot grow without bound across a long gateway lifetime
        keep = {rec.key for rec in live}
        for key in [k for k in self._records if k not in keep]:
            del self._records[key]
        self._open_for_append()
        self._set_bytes_gauge()

    # -------------------------------------------------------------- the API

    def accept(
        self,
        key: str,
        request_id: str,
        endpoint: str,
        snapshot: Dict[str, Any],
    ) -> None:
        now = time.time()
        with self._lock:
            rec = JournalRecord(key, request_id, endpoint, snapshot, now)
            self._records[key] = rec
            self._append_locked({
                "op": "accept", "key": key, "request_id": request_id,
                "endpoint": endpoint, "snapshot": snapshot, "t": now,
            })

    def settle(self, key: str, result: Dict[str, Any]) -> None:
        now = time.time()
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                return
            rec.state = SETTLED
            rec.result = result
            rec.settled_t = now
            self._append_locked({
                "op": "settle", "key": key, "result": result, "t": now,
            })

    def fail(self, key: str) -> None:
        """The request errored terminally — the key is released (a
        retry with it runs fresh rather than replaying a failure)."""
        now = time.time()
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                return
            rec.state = FAILED
            rec.settled_t = now
            self._append_locked({"op": "fail", "key": key, "t": now})

    def lookup(self, key: str) -> Optional[JournalRecord]:
        with self._lock:
            return self._records.get(key)

    def begin(
        self, key: str, request_id: str, endpoint: str,
        snapshot: Dict[str, Any],
    ) -> Tuple[str, Optional[Dict[str, Any]]]:
        """Admission decision for one keyed request.  Returns
        ``("replay", result)`` when the key settled (serve the stored
        body, zero recompute), ``("await", None)`` when the key is
        pending but INHERITED from a predecessor (the caller should
        wait for the startup replay to settle it), raises
        :class:`DuplicateRequestError` when it is pending from this
        lifetime, and returns ``("fresh", None)`` after journaling the
        accept."""
        now = time.time()
        with self._lock:
            rec = self._records.get(key)
            if rec is not None:
                if rec.state == SETTLED and rec.result is not None:
                    if (
                        rec.settled_t is not None
                        and (now - rec.settled_t) >= self.retention_s
                    ):
                        # past retention: the stored body may already be
                        # compacted away on disk — treat as fresh
                        pass
                    else:
                        return ("replay", rec.result)
                elif rec.state == PENDING:
                    if rec.inherited:
                        return ("await", None)
                    raise DuplicateRequestError(
                        f"Idempotency-Key {key!r} is already in flight; "
                        "wait for the original attempt",
                    )
                # FAILED (or expired-settled) falls through to fresh
            rec = JournalRecord(key, request_id, endpoint, snapshot, now)
            self._records[key] = rec
            self._append_locked({
                "op": "accept", "key": key, "request_id": request_id,
                "endpoint": endpoint, "snapshot": snapshot, "t": now,
            })
        return ("fresh", None)

    def pending(self) -> List[JournalRecord]:
        """Accepted-but-unsettled records (startup replay candidates:
        the previous gateway died between accept and settle)."""
        with self._lock:
            return [
                r for r in self._records.values() if r.state == PENDING
            ]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            by_state: Dict[str, int] = {}
            for rec in self._records.values():
                by_state[rec.state] = by_state.get(rec.state, 0) + 1
            return {
                "path": self.path,
                "bytes": self._bytes,
                "records": len(self._records),
                "by_state": by_state,
                "torn_tail_recovered": self._torn_tail,
            }

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                finally:
                    self._fh = None
