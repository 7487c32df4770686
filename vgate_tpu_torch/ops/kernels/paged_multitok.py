"""Wrapper of the paged multi-token CUDA kernel (csrc/paged_multitok.cu, K3).

Replaces vgate_tpu/ops/pallas/paged_attention.py
``paged_multitok_attention_pallas`` for bf16 pools (its int8-pool mode is
not ported yet).  A CPU tensor takes the plain version (ops/attention.py
``paged_suffix_attention``); a CUDA tensor launches the kernel or raises
— there is no fallback.  ``paged_multitok_attention.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vgate_tpu_torch.ops import attention
from vgate_tpu_torch.ops.kernels import _build

HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8  # query heads per kv head, as K1 and K2 are held to


def _lib():
    lib = _build.load("paged_multitok")
    fn = lib.vgt_paged_multitok_bf16
    if fn.argtypes is None:  # declare once: pointers must not be cut to int
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
    return fn


def _check(q, k_pages, v_pages, page_tables, positions0, input_lens) -> None:
    named = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
             ("page_tables", page_tables), ("positions0", positions0),
             ("input_lens", input_lens)]
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in named[:3]:
        if t.dtype != torch.bfloat16:
            raise ValueError(
                f"the paged multi-token kernel takes bf16, {name} is {t.dtype}"
            )
    for name, t in named[3:]:
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            "expected q [B, S, H, hd] and pools [KV, P, ps, hd], got "
            f"{tuple(q.shape)} and {tuple(k_pages.shape)}"
        )
    B, S, H, hd = q.shape
    KV, _, ps, _ = k_pages.shape
    if k_pages.shape[3] != hd or hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS} or pool mismatch")
    if H % KV or H // KV > MAX_GROUP:
        raise ValueError(
            f"H={H}, KV={KV}: need KV | H and H/KV <= {MAX_GROUP}"
        )
    if S % ps:
        raise ValueError(f"S={S} is not a multiple of the page size {ps}")
    if page_tables.dim() != 2 or page_tables.shape[0] != B:
        raise ValueError(f"page_tables must be [B={B}, ctx_pages]")
    if positions0.shape != (B,) or input_lens.shape != (B,):
        raise ValueError(f"positions0 and input_lens must be [B={B}]")


def paged_multitok_attention(
    q: torch.Tensor,  # [B, S, H, hd] suffix queries
    k_pages: torch.Tensor,  # [KV, P, ps, hd] one layer's pool (a view)
    v_pages: torch.Tensor,
    page_tables: torch.Tensor,  # [B, ctx_pages] int32 context window
    positions0: torch.Tensor,  # [B] int32 global position of q[:, 0]
    input_lens: torch.Tensor,  # [B] int32 real query rows (<= S)
    softcap: float = 0.0,
    window: int = 0,  # >0 => attend only to the last `window` keys
    scale: Optional[float] = None,  # query scale; default hd**-0.5
) -> torch.Tensor:
    """Attention of S query rows per slot over the paged context; the
    rows' own KV must already be in the pool.  Returns [B, S, H, hd];
    rows past ``input_lens`` are finite and unspecified.

    The kernel reads page-table entries only below ``positions0 +
    input_lens`` and clamps that to ``ctx_pages * ps`` on the device, so
    lengths the engine failed to bound cannot read past the table
    (checking them on the host would cost a device sync per layer)."""
    if q.device.type == "cpu":
        return attention.paged_suffix_attention(
            q, k_pages, v_pages, page_tables, positions0,
            positions0 + input_lens, softcap=softcap,
            window=window if window else None, scale=scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k_pages, v_pages, page_tables, positions0, input_lens)
    B, S, H, hd = q.shape
    KV, P, ps, _ = k_pages.shape
    out = torch.empty_like(q)
    rc = _lib()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_tables.data_ptr(), positions0.data_ptr(), input_lens.data_ptr(),
        out.data_ptr(), B, S, H, KV, P, ps, page_tables.shape[1], hd,
        int(window), float(scale if scale is not None else hd ** -0.5),
        float(softcap), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"paged multi-token kernel launch failed: cuda error {rc}"
        )
    paged_multitok_attention.launches += 1
    return out


paged_multitok_attention.launches = 0
