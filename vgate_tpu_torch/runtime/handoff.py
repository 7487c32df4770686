"""Disaggregated prefill→decode KV handoff plane.

With ``pod.roles`` set, new requests prefill on the prefill pool; once
the first token exists the prefill worker folds the sequence
(``prepare_migrate`` shape) and stages its KV pages through the host
swap pool.  The gateway then ships the staged pages to a least-loaded
decode worker as a chunked, checksummed (the checksum sweep's digest),
fencing-epoch-stamped RPC transfer and the decode worker restores them
and continues the stream token-identically.

This module holds the pure, process-agnostic pieces all three parties
share:

* the **handoff state machine** — an explicit allowed-transition map
  (PREFILLING → STAGED → TRANSFERRING → ACCEPTED → DECODING, plus the
  terminal FALLBACK / CANCELLED / FAILED exits every failure branch
  lands on).  Transitions are idempotent (re-entering the current state
  is a no-op) so a duplicated ACCEPT cannot double-apply, and illegal
  jumps raise instead of silently corrupting the record.
* the **payload codec** — ``pack_payload``/``unpack_payload`` serialize
  the swap ticket's KV tree (nested tuples/lists/dicts of array leaves,
  including the int8 ``QuantPages``) to one self-describing byte
  buffer.  NOT pickle: a length-prefixed JSON manifest + raw array
  bytes, so a garbled wire produces a typed
  :class:`~vgate_tpu_torch.errors.HandoffTransferError`, never arbitrary
  object construction.  The layout is the reference's byte for byte
  (``vgate_tpu/runtime/handoff.py``): the same manifest, blob and
  digest, apart from the class path of a ``QuantPages`` leaf.  Leaves
  go in as torch tensors or numpy arrays and come out as CPU torch
  tensors; numpy has no bfloat16, so a bf16 leaf crosses as its raw
  16-bit words under the dtype name ``bfloat16``, as the reference
  writes it.  :func:`ticket_to_tree` and :func:`tree_to_ticket` convert
  between the host swap tier's chunked payload and that tree.
* the **chunk assembler** — reassembles out-of-order, possibly
  duplicated transfer chunks on the decode worker; exact re-delivery is
  idempotent, conflicting overlap / overflow / coverage gaps are typed
  errors, never hangs.

Gateway orchestration (records, retries, fallback) lives in
``runtime/pod_engine.py``; the worker-side verbs in ``runtime/worker.py``.
"""

from __future__ import annotations

import importlib
import json
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vgate_tpu_torch.errors import HandoffTransferError

# --------------------------------------------------------------- states

PREFILLING = "PREFILLING"
STAGED = "STAGED"
TRANSFERRING = "TRANSFERRING"
ACCEPTED = "ACCEPTED"
DECODING = "DECODING"
# terminal exits — every failure branch of a handoff lands on one
FALLBACK = "FALLBACK"  # monolithic decode on the prefill worker
CANCELLED = "CANCELLED"  # raced a loss/abort/finish; replay path owns it
FAILED = "FAILED"  # transfer exhausted and no fallback possible

STATES = (
    PREFILLING, STAGED, TRANSFERRING, ACCEPTED, DECODING,
    FALLBACK, CANCELLED, FAILED,
)

# the explicit transition map: state -> states reachable from it
TRANSITIONS: Dict[str, Tuple[str, ...]] = {
    PREFILLING: (STAGED, FALLBACK, CANCELLED, FAILED),
    STAGED: (TRANSFERRING, FALLBACK, CANCELLED, FAILED),
    TRANSFERRING: (ACCEPTED, FALLBACK, CANCELLED, FAILED),
    ACCEPTED: (DECODING, CANCELLED, FAILED),
    DECODING: (),
    FALLBACK: (),
    CANCELLED: (),
    FAILED: (),
}

TERMINAL = frozenset(s for s, nxt in TRANSITIONS.items() if not nxt)


class HandoffStateError(RuntimeError):
    """An illegal handoff state transition was attempted — a logic bug
    or a raced duplicate control frame; the record is left unchanged."""


def advance(current: str, to: str) -> bool:
    """Validate one state transition.  Returns True when the move is
    legal and real, False when ``to == current`` (idempotent re-entry —
    how a duplicated ACCEPT frame becomes a no-op), and raises
    :class:`HandoffStateError` on an illegal jump."""
    if current not in TRANSITIONS:
        raise HandoffStateError(f"unknown handoff state {current!r}")
    if to == current:
        return False
    if to not in TRANSITIONS:
        raise HandoffStateError(f"unknown handoff state {to!r}")
    if to not in TRANSITIONS[current]:
        raise HandoffStateError(
            f"illegal handoff transition {current} -> {to}"
        )
    return True


# -------------------------------------------------------- payload codec
#
# wire layout: MAGIC(4) | manifest_len(4, big-endian) | manifest | blob
# manifest: JSON spec tree; array leaves carry (dtype, shape, off, len)
# into the blob.  Self-describing and boring on purpose — every decode
# failure is a typed HandoffTransferError.

_MAGIC = b"VGKV"
_HEADER = struct.Struct(">I")
_MAX_MANIFEST = 4 * 1024 * 1024

# Record payload leaves (int8 KV ships QuantPages) reconstruct by import
# path, and only from this package: the reference's path
# (``vgate_tpu.``) would import the JAX package.  A class qualifies by a
# ``_fields`` tuple (a NamedTuple, or QuantPages' own).
_ALLOWED_NT_MODULES = ("vgate_tpu_torch.",)

# the numpy dtype of a tensor's raw words, for the dtypes numpy lacks
_RAW_WORDS = {torch.bfloat16: (np.uint16, "bfloat16")}


def _leaf_bytes(node: Any) -> Tuple[bytes, str, List[int]]:
    """(raw bytes, manifest dtype name, shape) of an array leaf."""
    if isinstance(node, torch.Tensor):
        t = node.detach().to("cpu").contiguous()
        words = _RAW_WORDS.get(t.dtype)
        if words is not None:
            arr = t.view(torch.int16).numpy().view(words[0])
            return arr.tobytes(), words[1], list(t.shape)
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(node)
    return arr.tobytes(), str(arr.dtype), list(arr.shape)


def _is_record(node: Any) -> bool:
    return isinstance(getattr(type(node), "_fields", None), tuple)


def _spec(node: Any, chunks: List[bytes], off: int) -> Tuple[Any, int]:
    if node is None:
        return {"t": "none"}, off
    if isinstance(node, (np.ndarray, torch.Tensor)):
        raw, dtype, shape = _leaf_bytes(node)
        chunks.append(raw)
        spec = {
            "t": "nd",
            "dtype": dtype,
            "shape": shape,
            "off": off,
            "len": len(raw),
        }
        return spec, off + len(raw)
    if _is_record(node):
        cls = type(node)
        items = []
        for field in cls._fields:
            child_spec, off = _spec(getattr(node, field), chunks, off)
            items.append(child_spec)
        return {
            "t": "namedtuple",
            "cls": f"{cls.__module__}:{cls.__qualname__}",
            "items": items,
        }, off
    if isinstance(node, (list, tuple)):
        items = []
        for child in node:
            child_spec, off = _spec(child, chunks, off)
            items.append(child_spec)
        return {
            "t": "tuple" if isinstance(node, tuple) else "list",
            "items": items,
        }, off
    if isinstance(node, dict):
        keys, items = [], []
        for key, child in node.items():
            if not isinstance(key, str):
                raise HandoffTransferError(
                    f"unpackable payload dict key {key!r} (want str)"
                )
            child_spec, off = _spec(child, chunks, off)
            keys.append(key)
            items.append(child_spec)
        return {"t": "dict", "keys": keys, "items": items}, off
    if isinstance(node, (bool, int, float, str)):
        return {"t": "py", "v": node}, off
    raise HandoffTransferError(
        f"unpackable payload leaf of type {type(node).__name__}"
    )


def pack_payload(payload: Any) -> bytes:
    """Serialize a KV payload tree to one self-describing byte buffer
    (manifest + raw array bytes).  Deterministic for a given payload, so
    the positional digest of the buffer is a transfer checksum."""
    chunks: List[bytes] = []
    spec, _ = _spec(payload, chunks, 0)
    manifest = json.dumps(spec, separators=(",", ":")).encode()
    if len(manifest) > _MAX_MANIFEST:
        raise HandoffTransferError(
            f"payload manifest too large ({len(manifest)} bytes)"
        )
    return b"".join([_MAGIC, _HEADER.pack(len(manifest)), manifest] + chunks)


def _build(spec: Any, blob: memoryview) -> Any:
    if not isinstance(spec, dict) or "t" not in spec:
        raise HandoffTransferError("malformed payload manifest node")
    kind = spec["t"]
    if kind == "none":
        return None
    if kind == "py":
        val = spec.get("v")
        if not isinstance(val, (bool, int, float, str)):
            raise HandoffTransferError("malformed scalar leaf")
        return val
    if kind == "nd":
        try:
            name = str(spec["dtype"])
            raw = {v[1]: (v[0], k) for k, v in _RAW_WORDS.items()}.get(name)
            dtype = np.dtype(raw[0] if raw else name)
            shape = tuple(int(d) for d in spec["shape"])
            off, length = int(spec["off"]), int(spec["len"])
        except (KeyError, TypeError, ValueError) as exc:
            raise HandoffTransferError(
                f"malformed array leaf: {exc}"
            ) from None
        if off < 0 or length < 0 or off + length > len(blob):
            raise HandoffTransferError(
                f"array leaf out of bounds (off={off} len={length} "
                f"blob={len(blob)})"
            )
        want = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
        if want != length:
            raise HandoffTransferError(
                f"array leaf size mismatch (shape wants {want}, "
                f"manifest says {length})"
            )
        arr = np.frombuffer(blob[off:off + length], dtype=dtype)
        out = torch.from_numpy(arr.reshape(shape).copy())
        if raw is not None:
            out = out.view(torch.int16).view(raw[1])
        return out
    if kind in ("list", "tuple"):
        items = spec.get("items")
        if not isinstance(items, list):
            raise HandoffTransferError("malformed container node")
        built = [_build(child, blob) for child in items]
        return tuple(built) if kind == "tuple" else built
    if kind == "dict":
        keys = spec.get("keys")
        items = spec.get("items")
        if (
            not isinstance(keys, list)
            or not isinstance(items, list)
            or len(keys) != len(items)
            or not all(isinstance(k, str) for k in keys)
        ):
            raise HandoffTransferError("malformed dict node")
        return {
            key: _build(child, blob) for key, child in zip(keys, items)
        }
    if kind == "namedtuple":
        path = spec.get("cls", "")
        items = spec.get("items")
        if not isinstance(path, str) or not isinstance(items, list):
            raise HandoffTransferError("malformed namedtuple node")
        if not path.startswith(_ALLOWED_NT_MODULES):
            raise HandoffTransferError(
                f"refusing namedtuple outside vgate_tpu_torch: {path!r}"
            )
        try:
            mod_name, _, qualname = path.partition(":")
            obj: Any = importlib.import_module(mod_name)
            for part in qualname.split("."):
                obj = getattr(obj, part)
        except (ImportError, AttributeError, ValueError) as exc:
            raise HandoffTransferError(
                f"cannot resolve payload class {path!r}: {exc}"
            ) from None
        if not (isinstance(obj, type)
                and isinstance(getattr(obj, "_fields", None), tuple)):
            raise HandoffTransferError(
                f"payload class {path!r} is not a NamedTuple"
            )
        if len(items) != len(obj._fields):
            raise HandoffTransferError(
                f"payload class {path!r} arity mismatch"
            )
        return obj(*[_build(child, blob) for child in items])
    raise HandoffTransferError(f"unknown manifest node type {kind!r}")


def unpack_payload(buf: bytes) -> Any:
    """Inverse of :func:`pack_payload`.  Every malformation — bad magic,
    truncation, undecodable manifest, out-of-bounds leaves — raises
    :class:`~vgate_tpu_torch.errors.HandoffTransferError`."""
    view = memoryview(buf)
    head = len(_MAGIC) + _HEADER.size
    if len(view) < head:
        raise HandoffTransferError(
            f"payload truncated ({len(view)} bytes, header needs {head})"
        )
    if bytes(view[:len(_MAGIC)]) != _MAGIC:
        raise HandoffTransferError("bad payload magic")
    (mlen,) = _HEADER.unpack(view[len(_MAGIC):head])
    if mlen > _MAX_MANIFEST or head + mlen > len(view):
        raise HandoffTransferError(
            f"payload manifest length {mlen} out of bounds"
        )
    try:
        spec = json.loads(bytes(view[head:head + mlen]).decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise HandoffTransferError(
            f"undecodable payload manifest: {exc}"
        ) from None
    return _build(spec, view[head + mlen:])


def payload_digest(buf: bytes) -> int:
    """Positional digest of a packed payload buffer (the checksum
    sweep's formula) — the transfer checksum the decode worker verifies
    before restoring pages."""
    from vgate_tpu_torch.integrity import host_leaf_digest

    return host_leaf_digest(np.frombuffer(buf, dtype=np.uint8))


# ------------------------------------------- swap ticket <-> wire tree


def ticket_to_tree(chunks: List[List[torch.Tensor]]) -> Tuple[Any, Any]:
    """A host swap ticket's payload (runtime/engine_core.py
    ``_DeviceSwapExecutor``: chunks of up to ``SWAP_CHUNK_PAGES`` pages,
    each ``[k, v]`` or, for int8 pools, ``[k, k_scale, v, v_scale]``
    with the page axis at 2) as the reference's wire tree: ``(k, v)``,
    each one tensor or a ``QuantPages`` over all the pages."""
    from vgate_tpu_torch.ops.kv_quant import QuantPages

    parts = [torch.cat(col, dim=2) for col in zip(*chunks)]
    if len(parts) == 2:
        return parts[0], parts[1]
    return QuantPages(parts[0], parts[1]), QuantPages(parts[2], parts[3])


def tree_to_ticket(tree: Any, chunk_pages: int) -> List[List[torch.Tensor]]:
    """Inverse of :func:`ticket_to_tree`: the swap-in payload for the
    pages of ``tree``, split into chunks of ``chunk_pages`` pages.
    Raises :class:`HandoffTransferError` on a tree of another shape."""
    if not (isinstance(tree, (tuple, list)) and len(tree) == 2):
        raise HandoffTransferError("handoff payload is not a (k, v) pair")
    parts: List[torch.Tensor] = []
    for pool in tree:
        if _is_record(pool):
            parts += [pool.data, pool.scale]
        elif isinstance(pool, torch.Tensor):
            parts.append(pool)
        else:
            raise HandoffTransferError(
                f"handoff pool of type {type(pool).__name__}"
            )
    n = parts[0].shape[2] if parts[0].dim() > 2 else 0
    if n == 0 or any(p.dim() < 3 or p.shape[2] != n for p in parts):
        raise HandoffTransferError("handoff pools disagree on pages")
    return [
        [p[:, :, i : i + chunk_pages] for p in parts]
        for i in range(0, n, chunk_pages)
    ]


# ------------------------------------------------------ chunk assembler


class ChunkAssembler:
    """Reassembles one transfer's chunks on the decode worker.

    Byte-identical redelivery of a chunk (the ``duplicate`` fault mode,
    or a gateway retry racing its own first attempt) is an idempotent
    no-op; conflicting overlap, overflow past ``total`` and commit with
    coverage gaps are typed errors.  Single-threaded per transfer (the
    worker's verb dispatch serializes puts for one connection)."""

    def __init__(self, total: int, max_bytes: int) -> None:
        if total <= 0 or total > max_bytes:
            raise HandoffTransferError(
                f"transfer size {total} out of bounds (cap {max_bytes})"
            )
        self.total = total
        self._buf = bytearray(total)
        # merged sorted coverage intervals [(start, end), ...)
        self._spans: List[Tuple[int, int]] = []

    @property
    def received(self) -> int:
        return sum(end - start for start, end in self._spans)

    def put(self, off: int, data: bytes) -> int:
        """Apply one chunk; returns total bytes covered so far."""
        if not data:
            raise HandoffTransferError("empty transfer chunk")
        end = off + len(data)
        if off < 0 or end > self.total:
            raise HandoffTransferError(
                f"chunk [{off}:{end}) outside transfer of {self.total}"
            )
        for start, stop in self._spans:
            lo, hi = max(off, start), min(end, stop)
            if lo < hi and (
                self._buf[lo:hi] != data[lo - off:hi - off]
            ):
                raise HandoffTransferError(
                    f"conflicting chunk overlap at [{lo}:{hi})"
                )
        self._buf[off:end] = data
        self._spans = _merge_spans(self._spans + [(off, end)])
        return self.received

    def complete(self) -> bytes:
        """Return the assembled buffer; raises (with the missing ranges
        named) when coverage has gaps — the gateway's retry signal."""
        if self._spans != [(0, self.total)]:
            missing = _gaps(self._spans, self.total)
            raise HandoffTransferError(
                f"transfer incomplete: missing byte ranges {missing}"
            )
        return bytes(self._buf)


def _merge_spans(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    spans = sorted(spans)
    merged = [spans[0]]
    for start, end in spans[1:]:
        last_start, last_end = merged[-1]
        if start <= last_end:
            merged[-1] = (last_start, max(last_end, end))
        else:
            merged.append((start, end))
    return merged


def _gaps(spans: List[Tuple[int, int]], total: int) -> List[Tuple[int, int]]:
    gaps, cursor = [], 0
    for start, end in spans:
        if start > cursor:
            gaps.append((cursor, start))
        cursor = max(cursor, end)
    if cursor < total:
        gaps.append((cursor, total))
    return gaps


def chunk_offsets(total: int, chunk_bytes: int) -> List[Tuple[int, int]]:
    """Split ``total`` transfer bytes into (offset, length) chunks."""
    if chunk_bytes <= 0:
        raise ValueError("chunk_bytes must be > 0")
    return [
        (off, min(chunk_bytes, total - off))
        for off in range(0, total, chunk_bytes)
    ]
