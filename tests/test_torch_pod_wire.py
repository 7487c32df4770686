"""The pod's wire parts in the port vs the reference's.

The frames (runtime/rpc.py) must be byte-equal for the same messages,
and both sides must refuse an oversized frame and read each other's.
``params_to_wire``, ``wire_error`` and ``unwire_error`` (runtime/
worker.py) must agree.  The handoff codec (runtime/handoff.py) must
write, for the same bf16, f32 and int8 (``QuantPages``) page sets, the
same manifest apart from the class path, the same blob bytes and the
same ``payload_digest``; the port must refuse the reference's
``vgate_tpu.`` class path (importing it would import the JAX package)
and read its own.  ``advance``, ``ChunkAssembler`` and
``chunk_offsets`` run the reference's own cases (tests/test_handoff.py)
on both.  The ``pod`` config section must take the reference's
defaults and refuse what its validators refuse.
"""

import dataclasses
import json
import socket

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vgate_tpu import errors as j_errors
from vgate_tpu.backends.base import SamplingParams as JSamplingParams
from vgate_tpu.config import PodConfig as JPodConfig
from vgate_tpu.ops.kv_quant import QuantPages as JQuantPages
from vgate_tpu.runtime import handoff as j_handoff
from vgate_tpu.runtime import rpc as j_rpc
from vgate_tpu.runtime import worker as j_worker
from vgate_tpu_torch import errors as t_errors
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import PodConfig, load_config
from vgate_tpu_torch.ops.kv_quant import QuantPages
from vgate_tpu_torch.runtime import handoff
from vgate_tpu_torch.runtime import rpc
from vgate_tpu_torch.runtime import worker

MESSAGES = [
    {"op": "ping", "id": 1, "e": 3, "deadline_s": 1.0},
    {"op": "tok", "sid": 7, "t": 42, "lp": None, "e": 1},
    {"op": "reply", "id": 9, "ok": True, "e": 2,
     "data": {"pid": 123, "geometry": {"num_pages": 96, "page_size": 4}}},
    {"op": "submit", "id": 2, "e": 1, "sid": 5, "prompt_ids": [1, 2, 3],
     "params": {"temperature": 0.0, "stop": ["ß", "\n"]},
     "request_id": "req-ü"},
    {"op": "reply", "id": 4, "ok": False, "e": 5,
     "error": {"type": "WorkerLostError", "message": "gone",
               "reason": None, "retry_after": 2.0}},
]


# ------------------------------------------------------------- frames


@pytest.mark.parametrize("msg", MESSAGES, ids=lambda m: m["op"])
def test_frames_are_byte_equal(msg):
    ours = rpc.encode_frame(dict(msg), rpc.DEFAULT_MAX_FRAME_BYTES)
    theirs = j_rpc.encode_frame(dict(msg), j_rpc.DEFAULT_MAX_FRAME_BYTES)
    assert ours == theirs
    assert rpc.MAGIC == j_rpc.MAGIC and rpc.HEADER_BYTES == j_rpc.HEADER_BYTES


@pytest.mark.parametrize("writer,reader", [(rpc, j_rpc), (j_rpc, rpc)],
                         ids=["port_to_reference", "reference_to_port"])
def test_each_side_reads_the_other(writer, reader):
    a, b = socket.socketpair()
    try:
        for msg in MESSAGES:
            writer.send_frame(a, dict(msg))
        a.close()
        got = [reader.recv_frame(b) for _ in MESSAGES]
        assert got == MESSAGES
        assert reader.recv_frame(b) is None  # clean EOF
    finally:
        b.close()


@pytest.mark.parametrize("side", [rpc, j_rpc], ids=["port", "reference"])
def test_oversize_frames_are_refused(side):
    msg = {"op": "put", "data": "x" * 200, "e": 1}
    with pytest.raises(side.FrameError, match="exceeds cap"):
        side.encode_frame(msg, 100)
    a, b = socket.socketpair()
    try:
        side.send_frame(a, msg, 1 << 20)
        with pytest.raises(side.FrameError, match="exceeds cap"):
            side.recv_frame(b, 100)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("frame", [{"op": "x", "e": 4}, {"op": "x"},
                                   {"op": "x", "e": 3}, {"op": "x", "e": "4"}],
                         ids=["current", "missing", "stale", "not_int"])
def test_check_epoch_verdicts_match(frame):
    def verdict(side):
        try:
            side.check_epoch(frame, 4)
        except side.StaleEpochError as exc:
            return ("stale", exc.got, exc.want)
        except side.FrameError as exc:
            return ("frame", str(exc))
        return ("ok",)

    assert verdict(rpc) == verdict(j_rpc)


# ------------------------------------------------- params and errors


@pytest.mark.parametrize("kw", [
    {},
    {"temperature": 0.7, "top_p": 0.9, "top_k": 5, "max_tokens": 12,
     "seed": 3},
    {"stop": ["a", "b"], "logprobs": True, "top_logprobs": 2,
     "logit_bias": {7: -1.5}, "min_tokens": 2, "presence_penalty": 0.5},
], ids=["defaults", "sampling", "stops_bias_logprobs"])
def test_params_wire_forms_match(kw):
    ours = worker.params_to_wire(SamplingParams(**kw))
    theirs = j_worker.params_to_wire(JSamplingParams(**kw))
    assert ours == theirs
    wired = json.loads(json.dumps(ours))  # the bias keys become strings
    assert worker.params_from_wire(wired) == SamplingParams(**kw)
    assert (worker.params_to_wire(worker.params_from_wire(wired))
            == j_worker.params_to_wire(j_worker.params_from_wire(wired)))


ERRORS = [
    {"type": "WorkerLostError", "message": "gone", "retry_after": 2.5},
    {"type": "HandoffTransferError", "message": "digest mismatch"},
    {"type": "HandoffStaleError", "message": "folded"},
    {"type": "WorkerFencedError", "message": "stale epoch"},
    {"type": "WorkerOrphanedError", "message": "orphaned",
     "retry_after": 1.0},
    {"type": "NoSuchError", "message": "what"},
    {"type": "NoSuchError", "message": "what", "retry_after": 3.0},
    {"type": "ValueError", "message": "bad"},
]


@pytest.mark.parametrize("err", ERRORS,
                         ids=lambda e: e["type"] + str(e.get("retry_after")))
def test_unwire_error_matches(err):
    ours = worker.unwire_error(err)
    theirs = j_worker.unwire_error(err)
    assert type(ours).__name__ == type(theirs).__name__
    assert str(ours) == str(theirs)
    assert (getattr(ours, "retry_after", None)
            == getattr(theirs, "retry_after", None))
    assert worker.wire_error(ours) == j_worker.wire_error(theirs)


def test_wire_errors_name_the_same_classes():
    for name in ("WorkerLostError", "WorkerFencedError",
                 "WorkerOrphanedError", "HandoffTransferError",
                 "HandoffStaleError", "MigrationRefusedError"):
        assert issubclass(getattr(t_errors, name), BaseException)
        assert (getattr(t_errors, name).__mro__[1].__name__
                == getattr(j_errors, name).__mro__[1].__name__)


# ------------------------------------------------------- payload codec


def _pages(kind, seed=0):
    """(port tree, reference tree) of one page set: K and V pools of
    [L 2, KV 2, pages 3, ps 4, hd 8], the same bits in both."""
    rng = np.random.default_rng(seed)
    shape = (2, 2, 3, 4, 8)

    def pool():
        if kind == "int8":
            data = rng.integers(-127, 128, shape, dtype=np.int8)
            scale = rng.standard_normal(shape[:-1]).astype(np.float32)
            jscale = np.asarray(jnp.asarray(scale, jnp.bfloat16))
            tscale = torch.from_numpy(scale).to(torch.bfloat16)
            return (QuantPages(torch.from_numpy(data), tscale),
                    JQuantPages(data=data, scale=jscale))
        x = rng.standard_normal(shape).astype(np.float32)
        if kind == "bf16":
            return (torch.from_numpy(x).to(torch.bfloat16),
                    np.asarray(jnp.asarray(x, jnp.bfloat16)))
        return torch.from_numpy(x), x

    (tk, jk), (tv, jv) = pool(), pool()
    return (tk, tv), (jk, jv)


def _split(buf):
    mlen = int.from_bytes(buf[4:8], "big")
    return json.loads(buf[8:8 + mlen]), buf[8 + mlen:]


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
def test_codec_writes_the_reference_bytes(kind):
    ours, theirs = _pages(kind)
    t_buf = handoff.pack_payload(ours)
    j_buf = j_handoff.pack_payload(theirs)
    t_manifest, t_blob = _split(t_buf)
    j_manifest, j_blob = _split(j_buf)
    if kind == "int8":
        for item in j_manifest["items"]:
            assert item["cls"] == "vgate_tpu.ops.kv_quant:QuantPages"
            item["cls"] = "vgate_tpu_torch.ops.kv_quant:QuantPages"
        # the reference's buffer under the port's class path
        manifest = json.dumps(j_manifest, separators=(",", ":")).encode()
        j_buf = (b"VGKV" + len(manifest).to_bytes(4, "big") + manifest
                 + j_blob)
    assert t_manifest == j_manifest
    assert t_blob == j_blob
    assert t_buf == j_buf
    assert handoff.payload_digest(t_buf) == j_handoff.payload_digest(j_buf)
    if kind == "bf16":
        assert t_manifest["items"][0]["dtype"] == "bfloat16"
    back = handoff.unpack_payload(t_buf)
    for got, want in zip(back, ours):
        if kind == "int8":
            assert isinstance(got, QuantPages)
            assert torch.equal(got.data, want.data)
            assert torch.equal(got.scale, want.scale)
        else:
            assert got.dtype == want.dtype and torch.equal(got, want)


def test_codec_refuses_the_reference_class_path():
    _, theirs = _pages("int8")
    with pytest.raises(t_errors.HandoffTransferError,
                       match="outside vgate_tpu_torch"):
        handoff.unpack_payload(j_handoff.pack_payload(theirs))


@pytest.mark.parametrize("mutate", ["magic", "truncated", "manifest"])
def test_codec_malformations_are_typed(mutate):
    ours, _ = _pages("bf16")
    buf = bytearray(handoff.pack_payload(ours))
    if mutate == "magic":
        buf[0] ^= 0xFF
    elif mutate == "truncated":
        buf = buf[: len(buf) // 2]
    else:
        buf[9] = ord("!")
    with pytest.raises(t_errors.HandoffTransferError):
        handoff.unpack_payload(bytes(buf))
    with pytest.raises(j_errors.HandoffTransferError):
        j_handoff.unpack_payload(bytes(buf))


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_swap_ticket_round_trips_through_the_wire_tree(kind):
    """The host swap tier's chunked payload ([k, v] or [k, k_scale, v,
    v_scale] per chunk, page axis 2) becomes the (k, v) tree and back."""
    ours, _ = _pages(kind)
    chunks = handoff.tree_to_ticket(ours, 2)
    assert [c[0].shape[2] for c in chunks] == [2, 1]
    assert len(chunks[0]) == (4 if kind == "int8" else 2)
    tree = handoff.ticket_to_tree(chunks)
    buf = handoff.pack_payload(tree)
    assert buf == handoff.pack_payload(ours)


# ------------------------------------- the reference's handoff cases


@pytest.mark.parametrize("cur", j_handoff.STATES + ("BOGUS",))
def test_advance_matches_for_every_pair(cur):
    assert handoff.STATES == j_handoff.STATES
    assert handoff.TRANSITIONS == j_handoff.TRANSITIONS
    assert handoff.TERMINAL == j_handoff.TERMINAL

    def verdict(side, to):
        try:
            return side.advance(cur, to)
        except side.HandoffStateError as exc:
            return str(exc)

    for to in j_handoff.STATES + ("BOGUS",):
        assert verdict(handoff, to) == verdict(j_handoff, to), to


BLOB = bytes(range(256)) * 4
ASSEMBLER_CASES = {
    "in_order": (len(BLOB), [(o, BLOB[o:o + n])
                             for o, n in j_handoff.chunk_offsets(len(BLOB),
                                                                 100)]),
    "out_of_order": (len(BLOB), [(o, BLOB[o:o + n]) for o, n in reversed(
        j_handoff.chunk_offsets(len(BLOB), 96))]),
    "duplicate": (64, [(0, b"abcdefgh" * 4), (0, b"abcdefgh" * 4),
                       (32, b"abcdefgh" * 4)]),
    "conflict": (64, [(0, b"\x01" * 32), (16, b"\x02" * 32)]),
    "out_of_bounds": (64, [(60, b"\x00" * 8)]),
    "negative": (64, [(-4, b"\x00" * 8)]),
    "empty": (64, [(0, b"")]),
    "gaps": (100, [(0, b"\x00" * 10), (50, b"\x00" * 10)]),
    "overlap_extension": (100, [(0, b"\x00" * 40), (20, b"\x00" * 40)]),
    "zero_total": (0, []),
    "over_cap": (1 << 21, []),
}


@pytest.mark.parametrize("case", sorted(ASSEMBLER_CASES))
def test_chunk_assembler_matches(case):
    total, puts = ASSEMBLER_CASES[case]

    def run(side):
        trace = []
        try:
            asm = side.ChunkAssembler(total, 1 << 20)
        except side.HandoffTransferError as exc:
            return [("ctor", str(exc))]
        for off, data in puts:
            try:
                trace.append(("put", asm.put(off, data)))
            except side.HandoffTransferError as exc:
                trace.append(("put", str(exc)))
        try:
            trace.append(("complete", asm.complete()))
        except side.HandoffTransferError as exc:
            trace.append(("complete", str(exc)))
        trace.append(("received", asm.received))
        return trace

    assert run(handoff) == run(j_handoff)


@pytest.mark.parametrize("total,chunk", [(1, 1), (10, 3), (100, 100),
                                         (257, 64), (0, 64), (100, 0)])
def test_chunk_offsets_match(total, chunk):
    def run(side):
        try:
            return side.chunk_offsets(total, chunk)
        except ValueError as exc:
            return str(exc)

    assert run(handoff) == run(j_handoff)


# ------------------------------------------------------- pod config


def test_pod_section_takes_the_reference_defaults():
    ours = dataclasses.asdict(PodConfig())
    theirs = JPodConfig().model_dump()
    assert ours == theirs
    assert len(ours) == 17
    cfg = load_config(pod={"workers": 2, "roles": ["prefill", "decode"]})
    assert cfg.pod.workers == 2 and cfg.pod.roles == ["prefill", "decode"]


@pytest.mark.parametrize("bad", [
    {"workers": -1},
    {"transport": "pipe"},
    {"roles": ["prefill", "bogus"], "workers": 2},
    {"roles": ["prefill"], "workers": 2},
    {"roles": ["decode", "decode"], "workers": 0},
    {"transfer_chunk_bytes": 0},
    {"transfer_max_retries": 0},
    {"transfer_timeout_s": -1.0},
    {"transfer_staging_bytes": 0},
    {"orphan_grace_s": -0.5},
], ids=lambda b: "-".join(sorted(b)))
def test_pod_validators_refuse_what_the_reference_refuses(bad):
    with pytest.raises(ValueError):
        JPodConfig(**bad)
    with pytest.raises(ValueError):
        load_config(pod=bad)
