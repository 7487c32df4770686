"""Wrapper of the flash-prefill CUDA kernel (csrc/flash_prefill.cu, K2).

Replaces vgate_tpu/ops/pallas/flash_prefill.py
``flash_prefill_attention_pallas`` for bf16 inputs.  A CPU tensor takes
the plain version (ops/attention.py ``flash_prefill_attention``); a CUDA
tensor launches the kernel or raises — there is no fallback.
``flash_prefill_attention.launches`` counts kernel launches.

K2-ring (:func:`flash_prefill_partial`) is the kernel's partial mode: one
hop of the sequence-parallel ring prompt pass (parallel/
ring_attention.py), writing each row's unnormalised fp32 ``(acc, m,
l)``; its plain version is ops/attention.py
``prefill_partial_attention``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vgate_tpu_torch.ops import attention
from vgate_tpu_torch.ops.kernels import _build

HEAD_DIMS = (64, 128, 256)


def _lib(partial: bool = False):
    lib = _build.load("flash_prefill")
    fn = (lib.vgt_flash_prefill_partial_bf16 if partial
          else lib.vgt_flash_prefill_bf16)
    if fn.argtypes is None:  # declare once: pointers must not be cut to int
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * (8 if partial else 6) + [
            ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_float,
                                 ctypes.c_void_p]
    return fn


def _check(q, k, v, seq_lens, q_offsets) -> None:
    named = [("q", q), ("k", k), ("v", v), ("seq_lens", seq_lens)]
    if q_offsets is not None:
        named.append(("q_offsets", q_offsets))
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in named[:3]:
        if t.dtype != torch.bfloat16:
            raise ValueError(
                f"the flash-prefill kernel takes bf16, {name} is {t.dtype}"
            )
    for name, t in named[3:]:
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            "expected q [B, S, H, hd] and k/v [B, Sk, KV, hd], got "
            f"{tuple(q.shape)} and {tuple(k.shape)}"
        )
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS} or k/v mismatch")
    if H % k.shape[2]:
        raise ValueError(f"H={H} not divisible by KV={k.shape[2]}")
    if seq_lens.shape != (B,) or (
        q_offsets is not None and q_offsets.shape != (B,)
    ):
        raise ValueError(f"seq_lens and q_offsets must be [B={B}]")
    for name, t in named[:3]:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes (TMA)")


def flash_prefill_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, Sk, KV, hd]
    v: torch.Tensor,  # [B, Sk, KV, hd]
    seq_lens: torch.Tensor,  # [B] int32 real key lengths
    q_offsets: Optional[torch.Tensor] = None,  # [B] int32 pos of q[:, 0]
    softcap: float = 0.0,
    window: int = 0,  # >0 => attend only to the last `window` keys
    scale: Optional[float] = None,  # query scale; default hd**-0.5
) -> torch.Tensor:
    """Causal (optionally offset) attention. Returns [B, S, H, hd]."""
    if q.device.type == "cpu":
        return attention.flash_prefill_attention(
            q, k, v, seq_lens, q_offset=q_offsets, softcap=softcap,
            window=window if window else None, scale=scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, seq_lens, q_offsets)
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    rc = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seq_lens.data_ptr(),
        None if q_offsets is None else q_offsets.data_ptr(),
        out.data_ptr(), B, S, Sk, H, KV, hd, int(window),
        float(scale if scale is not None else hd ** -0.5), float(softcap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash-prefill kernel launch failed: cuda error {rc}")
    _build.count_launch(flash_prefill_attention)
    return out


flash_prefill_attention.launches = 0


def flash_prefill_partial(
    q: torch.Tensor,  # [B, S, H, hd] the rank's query block
    k: torch.Tensor,  # [B, Sk, KV, hd] the held K/V block
    v: torch.Tensor,
    key_lens: torch.Tensor,  # [B] int32 real keys of the block (0..Sk)
    q_offsets: torch.Tensor,  # [B] int32 position of q[:, 0] from key 0
    softcap: float = 0.0,
    window: int = 0,  # >0 => attend only to the last `window` keys
    scale: Optional[float] = None,  # query scale; default hd**-0.5
):
    """K2-ring: one hop of the ring prompt pass, the query rows against
    one K/V block, causal from ``q_offsets``, as the unnormalised fp32
    partials ``(acc [B, S, H, hd], m [B, S, H], l [B, S, H])``; a row that
    sees no key of the block comes out ``acc = 0``, ``m = -1e30``, ``l =
    0``."""
    if q.device.type == "cpu":
        return attention.prefill_partial_attention(
            q, k, v, key_lens, q_offsets, softcap=softcap, window=window,
            scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, key_lens, q_offsets)
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    rc = _lib(partial=True)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_lens.data_ptr(),
        q_offsets.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        B, S, Sk, H, KV, hd, int(window),
        float(scale if scale is not None else hd ** -0.5), float(softcap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"flash-prefill partial kernel launch failed: cuda error {rc}")
    _build.count_launch(flash_prefill_partial)
    return acc, m, l


flash_prefill_partial.launches = 0
