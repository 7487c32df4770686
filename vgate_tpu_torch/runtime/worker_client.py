"""Gateway-side client for one engine worker connection.

One :class:`WorkerClient` wraps one socket to one worker *incarnation*
(process + fencing epoch).  It owns a reader thread that demultiplexes
the two frame families the worker sends:

* **replies** (``op == "reply"``, correlated by ``id``) — completed
  synchronous calls; :meth:`call` blocks on them with a per-call
  deadline (``pod.call_timeout_s`` default), so a wedged worker costs a
  ``TimeoutError``, never a hung gateway thread.
* **notifications** (``tok`` / ``done`` / ``err`` / ``evacuated``) —
  handed to the PodEngine's dispatcher, which owns the fencing-epoch
  check (a frame from a replaced incarnation is *discarded and
  counted* there, not torn down here — the zombie's connection keeps
  draining so its late frames are observed rather than buffered).

Liveness is fail-fast: EOF, a frame-protocol violation, or any socket
error marks the client dead, fails every pending call with the typed
``WorkerLostError``, and fires ``on_lost`` exactly once — the
PodEngine's loss path (resubmit → respawn → canary gate) takes over.
The client never reconnects; a reconnect is a new incarnation with a
new epoch and therefore a new client.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

from vgate_tpu_torch.errors import WorkerLostError
from vgate_tpu_torch.runtime import engine_metrics as metrics
from vgate_tpu_torch.runtime import rpc
from vgate_tpu_torch.runtime.worker import unwire_error

# Threading contract (the reference's thread-discipline checker).
# Lock order: _lock (pending-call table) and _send_lock (socket writes)
# are both LEAVES and never nested — frames are encoded before either
# is taken, and reply delivery releases _lock before setting the event.
VGT_COMPONENTS: Dict[str, str] = {}
VGT_LOCK_GUARDS = {
    "_pending": "_lock",
}

Address = Union[str, Tuple[str, int]]


class _Pending:
    __slots__ = ("event", "reply")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.reply: Optional[Dict[str, Any]] = None


class WorkerClient:
    def __init__(
        self,
        address: Address,
        epoch: int,
        *,
        max_frame_bytes: int,
        connect_timeout_s: float,
        call_timeout_s: float,
        on_notify: Callable[[Dict[str, Any]], Any],
        on_lost: Callable[[Optional[BaseException]], Any],
        label: str = "worker",
    ) -> None:
        self.epoch = int(epoch)
        self.label = label
        self.max_frame_bytes = int(max_frame_bytes)
        self.call_timeout_s = float(call_timeout_s)
        self._on_notify = on_notify
        self._on_lost = on_lost
        self._lock = threading.Lock()
        self._send_lock = threading.Lock()
        self._pending: Dict[int, _Pending] = {}
        self._next_cid = 0
        self._dead: Optional[BaseException] = None
        self._lost_fired = False
        if isinstance(address, str):
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.settimeout(max(0.1, float(connect_timeout_s)))
        self._sock.connect(address)
        self._sock.settimeout(None)
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"vgt-pod-read-{label}",
        )
        self._reader.start()

    # ------------------------------------------------------------- outbound

    def _send(self, frame: Dict[str, Any]) -> None:
        if self._dead is not None:
            raise WorkerLostError(
                f"{self.label} connection is down: {self._dead}"
            )
        frame["e"] = self.epoch
        try:
            with self._send_lock:
                sent = rpc.send_frame(
                    self._sock, frame, self.max_frame_bytes
                )
            metrics.RPC_BYTES.labels(direction="sent").observe(sent)
        except OSError as exc:
            self._mark_dead(exc)
            raise WorkerLostError(
                f"{self.label} send failed: {exc}"
            ) from exc

    def notify(self, op: str, **fields: Any) -> None:
        """Fire-and-forget frame (no reply expected): abort, brownout
        toggles.  Raises WorkerLostError only if the connection is
        already known dead."""
        self._send({"op": op, **fields})

    def call(
        self, op: str, timeout: Optional[float] = None, **fields: Any
    ) -> Dict[str, Any]:
        """Synchronous request/reply with a hard deadline.  Raises the
        worker's typed error (rebuilt via the errors taxonomy), a
        TimeoutError past the deadline, or WorkerLostError if the
        connection dies while waiting."""
        deadline = timeout if timeout is not None else self.call_timeout_s
        with self._lock:
            self._next_cid += 1
            cid = self._next_cid
            pending = _Pending()
            self._pending[cid] = pending
        t0 = time.perf_counter()
        try:
            # the wire carries the remaining budget so the worker can
            # bound its own work against the caller's deadline
            self._send(
                {"op": op, "id": cid, "deadline_s": deadline, **fields}
            )
            if not pending.event.wait(timeout=deadline):
                raise TimeoutError(
                    f"{self.label} RPC {op!r} timed out after "
                    f"{deadline:.1f}s"
                )
        finally:
            with self._lock:
                self._pending.pop(cid, None)
            # gateway-observed verb latency: success, typed error, and
            # timeout all count — a wedged verb must show in the tail
            metrics.RPC_CALL_SECONDS.labels(verb=op).observe(
                time.perf_counter() - t0
            )
        reply = pending.reply
        if reply is None:
            raise WorkerLostError(
                f"{self.label} connection lost during RPC {op!r}"
            )
        if not reply.get("ok"):
            raise unwire_error(reply.get("error") or {})
        return reply.get("data") or {}

    # -------------------------------------------------------------- inbound

    def _read_loop(self) -> None:
        exc: Optional[BaseException] = None
        recv_bytes = metrics.RPC_BYTES.labels(direction="received")
        try:
            while True:
                frame = rpc.recv_frame(
                    self._sock, self.max_frame_bytes,
                    size_cb=recv_bytes.observe,
                )
                if frame is None:
                    break  # clean EOF: worker exited
                if frame.get("op") == "reply":
                    self._deliver_reply(frame)
                else:
                    try:
                        self._on_notify(frame)
                    except Exception:  # noqa: BLE001 — reader must live
                        pass
        except (rpc.FrameError, OSError) as err:
            exc = err
        self._mark_dead(exc)

    def _deliver_reply(self, frame: Dict[str, Any]) -> None:
        with self._lock:
            pending = self._pending.get(frame.get("id"))
        if pending is None:
            return  # caller timed out and moved on
        pending.reply = frame
        pending.event.set()

    # ------------------------------------------------------------ lifecycle

    @property
    def dead(self) -> bool:
        return self._dead is not None

    def _mark_dead(self, exc: Optional[BaseException]) -> None:
        with self._lock:
            if self._dead is None:
                self._dead = exc or ConnectionError("connection closed")
            pending = list(self._pending.values())
            self._pending.clear()
            fire = not self._lost_fired
            self._lost_fired = True
        for p in pending:
            p.event.set()  # reply stays None → WorkerLostError in call()
        try:
            self._sock.close()
        except OSError:
            pass
        if fire:
            try:
                self._on_lost(exc)
            except Exception:  # noqa: BLE001 — loss path must not raise
                pass

    def close(self) -> None:
        """Tear down without firing on_lost (deliberate shutdown)."""
        with self._lock:
            self._lost_fired = True
        self._mark_dead(ConnectionError("closed by gateway"))

    def join(self, timeout: float = 2.0) -> None:
        self._reader.join(timeout=timeout)
