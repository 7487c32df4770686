"""Length-prefixed JSON frame protocol for the gateway ↔ worker plane.

One frame = an 8-byte header (``>II``: magic, payload length) followed
by a UTF-8 JSON payload.  The magic word catches cross-talk and garbled
streams immediately instead of letting a corrupted length prefix turn
into a multi-gigabyte allocation or a silent desync; the length cap
(``pod.max_frame_bytes``) bounds allocation before any byte of the
payload is read.

Every violation raises :class:`FrameError` — the contract both sides
follow is *typed error then connection teardown, never a hang and never
a resync attempt*: once framing is lost there is no trustworthy record
boundary left on the stream, so the reader closes the socket and the
reconnect/fencing machinery (pod_engine.py / worker.py) takes over.
The frames are the reference's (``vgate_tpu/runtime/rpc.py``) byte for
byte, so a port gateway and a reference worker would read each other.

Fencing epochs ride *inside* the payload (key ``"e"``) rather than the
header so that every verb — control and stream alike — carries one and
the epoch check happens after structural validation: a garbled frame is
a framing violation, a well-formed frame from a dead incarnation is a
fencing violation (:class:`StaleEpochError`), and the two are counted
and handled differently (teardown vs. discard-and-count).

Fault points ``rpc_send`` / ``rpc_recv`` (vgate_tpu_torch/faults.py) probe
every frame in wire mode: ``drop`` discards it, ``garble`` scrambles
the raw bytes (the peer then hits the framing violation path for real),
``delay`` stalls, ``raise`` fails the call site.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Any, Dict, Optional

from vgate_tpu_torch import faults

# "VG16" — changes when the frame layout does, so a version-skewed peer
# fails loudly at the first frame instead of misparsing stream state
MAGIC = 0x56471601
_HEADER = struct.Struct(">II")
HEADER_BYTES = _HEADER.size

DEFAULT_MAX_FRAME_BYTES = 8 * 1024 * 1024


class FrameError(RuntimeError):
    """Structural protocol violation — truncated stream, bad magic,
    oversized or undecodable payload.  The connection that produced it
    is unusable and must be torn down by the caller."""


class StaleEpochError(RuntimeError):
    """A well-formed frame stamped with a fencing epoch other than the
    current incarnation's — a zombie's late frame (gateway side) or a
    stale RPC addressed to a dead incarnation (worker side).  Discarded
    and counted, never acted on."""

    def __init__(self, got: int, want: int) -> None:
        super().__init__(f"stale fencing epoch {got} (current {want})")
        self.got = got
        self.want = want


def _garble(data: bytes) -> bytes:
    """Deterministic byte scramble for the ``garble`` wire fault: flip
    bits across the whole frame (header included) so magic, length, and
    payload are all suspect — exactly what a torn TCP stream looks
    like."""
    return bytes(b ^ 0xA5 for b in data)


def encode_frame(obj: Dict[str, Any], max_frame_bytes: int) -> bytes:
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(payload) > max_frame_bytes:
        raise FrameError(
            f"outbound frame {len(payload)}B exceeds cap {max_frame_bytes}B"
        )
    return _HEADER.pack(MAGIC, len(payload)) + payload


def send_frame(
    sock: socket.socket,
    obj: Dict[str, Any],
    max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
) -> int:
    """Serialize and send one frame; returns the encoded byte count
    (header + payload) so callers can account wire volume
    (vgt_rpc_bytes) without re-encoding.  NOT thread-safe per socket —
    both pod_engine and worker serialize writers behind a per-connection
    send lock so a token frame can never interleave into a reply
    frame."""
    data = encode_frame(obj, max_frame_bytes)
    if faults.is_active():
        verdict = faults.wire_action("rpc_send", obj.get("op"))
        if verdict == "drop":
            return len(data)
        if verdict == "garble":
            data = _garble(data)
    sock.sendall(data)
    return len(data)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise :class:`FrameError` on EOF /
    truncation.  Socket timeouts propagate as ``socket.timeout`` so the
    caller can distinguish a dead peer (EOF → teardown) from a slow one
    (timeout → its own liveness policy)."""
    chunks = []
    remaining = n
    while remaining > 0:
        chunk = sock.recv(min(remaining, 1 << 16))
        if not chunk:
            raise FrameError(
                f"stream truncated: EOF with {remaining}/{n} bytes unread"
            )
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def decode_payload(payload: bytes) -> Dict[str, Any]:
    try:
        obj = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise FrameError(f"undecodable frame payload: {exc}") from exc
    if not isinstance(obj, dict):
        raise FrameError(
            f"frame payload must be a JSON object, got {type(obj).__name__}"
        )
    return obj


def recv_frame(
    sock: socket.socket,
    max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
    size_cb: Optional[Any] = None,
) -> Optional[Dict[str, Any]]:
    """Read one frame.  Returns the decoded dict, or ``None`` on clean
    EOF at a frame boundary (peer closed deliberately).  Raises
    :class:`FrameError` on any structural violation — the caller must
    tear the connection down, not retry the read.  ``size_cb`` (when
    given) is invoked with the frame's on-wire byte count for telemetry;
    its failures never fail the read."""
    try:
        first = sock.recv(HEADER_BYTES)
    except ConnectionResetError as exc:
        raise FrameError(f"connection reset mid-stream: {exc}") from exc
    if not first:
        return None  # clean EOF between frames
    header = (
        first if len(first) == HEADER_BYTES
        else first + recv_exact(sock, HEADER_BYTES - len(first))
    )
    raw = None
    if faults.is_active():
        verdict = faults.wire_action("rpc_recv")
        if verdict == "garble":
            header = _garble(header)
        elif verdict == "drop":
            raw = "drop"
    magic, length = _HEADER.unpack(header)
    if magic != MAGIC:
        raise FrameError(
            f"bad frame magic 0x{magic:08x} (want 0x{MAGIC:08x}) — "
            "stream desynced or peer version-skewed"
        )
    if length > max_frame_bytes:
        raise FrameError(
            f"inbound frame {length}B exceeds cap {max_frame_bytes}B"
        )
    payload = recv_exact(sock, length)
    if raw == "drop":
        # consume the bytes (framing stays intact) but discard the frame
        return recv_frame(sock, max_frame_bytes, size_cb)
    if size_cb is not None:
        try:
            size_cb(HEADER_BYTES + length)
        except Exception:  # noqa: BLE001 — telemetry never fails a read
            pass
    return decode_payload(payload)


def check_epoch(frame: Dict[str, Any], want: int) -> None:
    """Enforce the fencing epoch on a decoded frame.  Frames without an
    ``"e"`` key are structural violations (every verb stamps one);
    frames with the wrong one are fencing violations."""
    got = frame.get("e")
    if not isinstance(got, int):
        raise FrameError(f"frame missing fencing epoch: {frame.get('op')!r}")
    if got != want:
        raise StaleEpochError(got, want)
