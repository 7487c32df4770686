"""Wrappers of the paged-decode CUDA kernel (csrc/paged_decode.cu).

K1 replaces vgate_tpu/ops/pallas/paged_attention.py
``paged_decode_attention_pallas``: bf16 and f32 pools
(:func:`paged_decode_attention`) and, for int8 ``QuantPages`` pools, its
int8 mode (:func:`paged_decode_attention_int8`, K1-int8, which
:func:`paged_decode_attention` hands such pools to).  K6 replaces
``paged_decode_attention_pallas_blocked``, the same function with
``block_slots`` slots per CTA (:func:`paged_decode_attention_blocked`).
A CPU tensor takes the plain version (ops/attention.py
``paged_decode_attention``, the function of both); a CUDA tensor
launches the kernel or raises — there is no fallback.  Each function's
``launches`` counts the launches of its mode.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vgate_tpu_torch.ops import attention
from vgate_tpu_torch.ops.kernels import _build
from vgate_tpu_torch.ops.kv_quant import SCALE_DTYPE, KVPool, is_quantized

HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8  # query heads per kv head the kernel instantiates
DTYPES = {torch.bfloat16: 0, torch.float32: 1}  # the C interface's codes


def _lib(int8: bool = False, blocked: bool = False):  # one entry point
    lib = _build.load("paged_decode")
    if blocked:
        fn = lib.vgt_paged_decode_blocked
        if fn.argtypes is None:  # declare once: pointers must not be cut
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
                ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ]
        return fn
    if int8:
        fn = lib.vgt_paged_decode_int8
        if fn.argtypes is None:  # declare once: pointers must not be cut
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
                ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
            ]
        return fn
    fn = lib.vgt_paged_decode
    if fn.argtypes is None:  # declare once: pointers must not be cut to int
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
    return fn


def _check(q, k_pages, v_pages, page_tables, seq_lens,
           scales: tuple = ()) -> None:
    """Device, dtype, shape and contiguity; ``scales`` (the int8 mode's
    K and V scale pools) marks ``k_pages``/``v_pages`` as int8 data."""
    named = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
             ("page_tables", page_tables), ("seq_lens", seq_lens)]
    named += [(f"scale pool {i}", t) for i, t in enumerate(scales)]
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    pool_dtype = torch.int8 if scales else q.dtype
    if scales:
        if q.dtype != torch.bfloat16:
            raise ValueError(f"K1's int8 mode takes a bf16 q, not {q.dtype}")
        for t in scales:
            if t.dtype != SCALE_DTYPE or t.shape != k_pages.shape[:-1]:
                raise ValueError("the scale pools must be bf16 [KV, P, ps]")
    elif q.dtype not in DTYPES:
        raise ValueError(f"the paged-decode kernel takes bf16 or f32, "
                         f"not {q.dtype}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != pool_dtype:
            raise ValueError(f"{name} is {t.dtype}, expected {pool_dtype}")
    for name, t in (("page_tables", page_tables), ("seq_lens", seq_lens)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            "expected q [B, H, hd] and pools [KV, P, ps, hd], got "
            f"{tuple(q.shape)} and {tuple(k_pages.shape)}"
        )
    B, H, hd = q.shape
    KV = k_pages.shape[0]
    if k_pages.shape[3] != hd or hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS} or pool mismatch")
    if H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"H={H}, KV={KV}: need KV | H and H/KV <= {MAX_GROUP}")
    if page_tables.dim() != 2 or page_tables.shape[0] != B:
        raise ValueError(f"page_tables must be [B={B}, pps]")
    if seq_lens.shape != (B,):
        raise ValueError(f"seq_lens must be [B={B}]")


def paged_decode_attention(
    q: torch.Tensor,  # [B, H, hd]
    k_pages: KVPool,  # [KV, P, ps, hd] one layer's pool (a view)
    v_pages: KVPool,
    page_tables: torch.Tensor,  # [B, pps] int32
    seq_lens: torch.Tensor,  # [B] int32, context incl. the current token
    softcap: float = 0.0,
    window: int = 0,  # >0 => attend only to the last `window` keys
    scale: Optional[float] = None,  # query scale; default hd**-0.5
) -> torch.Tensor:
    """Decode attention over the paged pool. Returns [B, H, hd].

    The kernel reads page-table entries only below ``seq_len`` and clamps
    ``seq_len`` to ``pps * ps`` on the device, so a position the engine
    failed to clamp cannot read past the table (checking ``seq_lens`` on
    the host would cost a device sync per layer).  int8 ``QuantPages``
    pools go to :func:`paged_decode_attention_int8`."""
    if is_quantized(k_pages):
        return paged_decode_attention_int8(
            q, k_pages, v_pages, page_tables, seq_lens, softcap=softcap,
            window=window, scale=scale,
        )
    if q.device.type == "cpu":
        return attention.paged_decode_attention(
            q, k_pages, v_pages, page_tables, seq_lens, softcap=softcap,
            window=window if window else None, scale=scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k_pages, v_pages, page_tables, seq_lens)
    B, H, hd = q.shape
    KV, P, ps, _ = k_pages.shape
    out = torch.empty_like(q)
    rc = _lib()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        B, H, KV, P, ps, page_tables.shape[1], hd, int(window),
        float(scale if scale is not None else hd ** -0.5), float(softcap),
        DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged-decode kernel launch failed: cuda error {rc}")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention_int8(
    q: torch.Tensor,  # [B, H, hd] bf16
    k_pages: KVPool,  # QuantPages [KV, P, ps, hd] one layer's (views)
    v_pages: KVPool,
    page_tables: torch.Tensor,  # [B, pps] int32
    seq_lens: torch.Tensor,  # [B] int32, context incl. the current token
    softcap: float = 0.0,
    window: int = 0,  # >0 => attend only to the last `window` keys
    scale: Optional[float] = None,  # query scale; default hd**-0.5
) -> torch.Tensor:
    """K1-int8: decode attention over int8 pools with per-token bf16
    scales, folded into the score (K) and the softmax weight (V) as the
    TPU kernel folds them.  Returns [B, H, hd]."""
    if q.device.type == "cpu":
        return attention.paged_decode_attention(
            q, k_pages, v_pages, page_tables, seq_lens, softcap=softcap,
            window=window if window else None, scale=scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (is_quantized(k_pages) and is_quantized(v_pages)):
        raise ValueError("K1's int8 mode needs int8 QuantPages pools")
    _check(q, k_pages.data, v_pages.data, page_tables, seq_lens,
           scales=(k_pages.scale, v_pages.scale))
    B, H, hd = q.shape
    KV, P, ps, _ = k_pages.shape
    out = torch.empty_like(q)
    rc = _lib(int8=True)(
        q.data_ptr(), k_pages.data.data_ptr(), v_pages.data.data_ptr(),
        k_pages.scale.data_ptr(), v_pages.scale.data_ptr(),
        page_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        B, H, KV, P, ps, page_tables.shape[1], hd, int(window),
        float(scale if scale is not None else hd ** -0.5), float(softcap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"paged-decode int8 kernel launch failed: cuda error {rc}"
        )
    paged_decode_attention_int8.launches += 1
    return out


def paged_decode_attention_blocked(
    q: torch.Tensor,  # [B, H, hd]
    k_pages: KVPool,  # [KV, P, ps, hd] one layer's pool (a view)
    v_pages: KVPool,
    page_tables: torch.Tensor,  # [B, pps] int32
    seq_lens: torch.Tensor,  # [B] int32, context incl. the current token
    softcap: float = 0.0,
    window: int = 0,  # >0 => attend only to the last `window` keys
    scale: Optional[float] = None,  # query scale; default hd**-0.5
    block_slots: int = 8,
) -> torch.Tensor:
    """K6: K1's function with ``block_slots`` slots per CTA (grid
    B/block_slots x KV).  Returns [B, H, hd].

    The reference's dispatch: ``block_slots <= 1``, a batch that
    ``block_slots`` does not divide, or an int8 ``QuantPages`` pool goes
    to :func:`paged_decode_attention` (K1, or K1-int8), and counts as that
    kernel's launch, not K6's."""
    if block_slots <= 1 or q.shape[0] % block_slots or is_quantized(k_pages):
        return paged_decode_attention(
            q, k_pages, v_pages, page_tables, seq_lens, softcap=softcap,
            window=window, scale=scale,
        )
    if q.device.type == "cpu":
        return attention.paged_decode_attention(
            q, k_pages, v_pages, page_tables, seq_lens, softcap=softcap,
            window=window if window else None, scale=scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k_pages, v_pages, page_tables, seq_lens)
    B, H, hd = q.shape
    KV, P, ps, _ = k_pages.shape
    out = torch.empty_like(q)
    rc = _lib(blocked=True)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        B, H, KV, P, ps, page_tables.shape[1], hd, int(window),
        float(scale if scale is not None else hd ** -0.5), float(softcap),
        int(block_slots), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"blocked paged-decode kernel launch failed: cuda error {rc}"
        )
    paged_decode_attention_blocked.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention_int8.launches = 0
paged_decode_attention_blocked.launches = 0
