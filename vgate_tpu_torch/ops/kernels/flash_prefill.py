"""Wrapper of the flash-prefill CUDA kernel (csrc/flash_prefill.cu, K2).

Replaces vgate_tpu/ops/pallas/flash_prefill.py
``flash_prefill_attention_pallas`` for bf16 inputs.  A CPU tensor takes
the plain version (ops/attention.py ``flash_prefill_attention``); a CUDA
tensor launches the kernel or raises — there is no fallback.
``flash_prefill_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vgate_tpu_torch.ops import attention
from vgate_tpu_torch.ops.kernels import _build

HEAD_DIMS = (64, 128, 256)


def _lib():
    lib = _build.load("flash_prefill")
    fn = lib.vgt_flash_prefill_bf16
    if fn.argtypes is None:  # declare once: pointers must not be cut to int
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
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
    flash_prefill_attention.launches += 1
    return out


flash_prefill_attention.launches = 0
