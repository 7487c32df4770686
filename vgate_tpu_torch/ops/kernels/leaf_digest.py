"""Wrapper of the weight-checksum reduction (csrc/leaf_digest.cu).

No TPU kernel's port: the reference computes the integrity sweep's leaf
digest, ``sum(bits(x)[i] * (i % 65521 + 1))`` in wrapping uint32, as one
XLA reduction fused with the bitcast and the weights
(vgate_tpu/integrity.py ``_digest_device``), so that verifying a
multi-GB leaf allocates nothing of the leaf's size next to a KV pool
that fills the rest of the card.  Eager torch would materialize int64
temporaries of the leaf's size (4.4 GB for a 7B model's 1.09 GB
``lm_head``), so on the card this is one hand-written reduction.

A CPU tensor takes the plain version (:func:`leaf_digest_plain`, which
runs on any device in bounded int64 chunks); a CUDA tensor launches the
kernel or raises — there is no fallback.  ``leaf_digest.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vgate_tpu_torch.ops.kernels import _build

WEIGHT_MOD = 65521  # largest prime below 2^16
# the signed integer of each width: torch's unsigned types lack most ops,
# and the bits are the same
_INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32}
# elements the plain version widens to int64 at a time
PLAIN_CHUNK = 1 << 22


def _lib():
    fn = _build.load("leaf_digest").vgt_leaf_digest
    if fn.argtypes is None:  # declare once: pointers must not be cut to int
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return fn


def bits_view(x: torch.Tensor) -> torch.Tensor:
    """The leaf's elements in C order as the signed integers of their
    width (8-byte leaves are cast to float32 first, as the reference
    does).  A leaf stored with its last two dims transposed (a W8A8
    weight in ``ops/quant.py`` ``k_major`` layout) is read in storage
    order instead, without a copy of the leaf (an expert stack is 15 GB
    at Mixtral's width).  Such a leaf's digest is then that of its
    layout, not of its row-major twin: an engine digests the tree it
    serves, after the layout, and compares only with itself."""
    if x.element_size() == 8:
        x = x.to(torch.float32)
    if x.dim() >= 2 and not x.is_contiguous() and \
            x.transpose(-1, -2).is_contiguous():
        x = x.transpose(-1, -2)
    flat = x.contiguous().reshape(-1)
    return flat.view(_INT_OF_WIDTH[flat.element_size()])


def leaf_digest_plain(x: torch.Tensor) -> int:
    """The digest with torch ops on ``x``'s device: each chunk of
    ``PLAIN_CHUNK`` elements widened to int64, masked to the element's
    width, weighted, each product masked to 32 bits and summed (the sum
    of a chunk stays below 2^54), the running total masked to 32 bits."""
    bits = bits_view(x)
    mask = (1 << (8 * bits.element_size())) - 1
    total = 0
    for start in range(0, bits.numel(), PLAIN_CHUNK):
        part = bits[start : start + PLAIN_CHUNK].to(torch.int64) & mask
        weights = torch.arange(
            start, start + part.numel(), dtype=torch.int64, device=part.device
        ) % WEIGHT_MOD + 1
        total += int(((part * weights) & 0xFFFFFFFF).sum())
        total &= 0xFFFFFFFF
    return total


def leaf_digest(x: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> Optional[int]:
    """The digest of one tensor's bit pattern as a Python int.  On the
    card, ``out`` (one int32 element) takes the result on the device and
    nothing is read back (None is returned); without it the result word
    is read back."""
    if x.device.type == "cpu":
        return leaf_digest_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    bits = bits_view(x)
    word = out if out is not None else torch.empty(
        1, dtype=torch.int32, device=x.device
    )
    if word.device != x.device or word.numel() != 1 or \
            word.element_size() != 4:
        raise ValueError("out must be one 4-byte element on the leaf's card")
    rc = _lib()(
        bits.data_ptr(), bits.numel(), bits.element_size(), word.data_ptr(),
        _build.sm_count(x.device),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"leaf-digest kernel launch failed: cuda error {rc}")
    _build.count_launch(leaf_digest)
    if out is not None:
        return None
    return int(word.item()) & 0xFFFFFFFF


leaf_digest.launches = 0
