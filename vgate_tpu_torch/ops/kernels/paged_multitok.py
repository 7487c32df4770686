"""Wrapper of the paged multi-token CUDA kernel (csrc/paged_multitok.cu, K3).

Replaces vgate_tpu/ops/pallas/paged_attention.py
``paged_multitok_attention_pallas``: bf16 pools
(:func:`paged_multitok_attention`) and, for int8 ``QuantPages`` pools,
its int8 mode (:func:`paged_multitok_attention_int8`, K3-int8, which
:func:`paged_multitok_attention` hands such pools to).  A CPU tensor
takes the plain version (ops/attention.py ``paged_suffix_attention``); a
CUDA tensor launches the kernel or raises — there is no fallback.  Each
function's ``launches`` counts the launches of its mode.

K3-sp (:func:`paged_multitok_partial`) is the bf16 mode on one sequence-
parallel rank's pool shard, writing each row's unnormalised fp32 ``(acc,
m, l)`` over the keys of the pages it owns; its plain version is ops/
attention.py ``partial_suffix_attention``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vgate_tpu_torch.config import NotPortedError
from vgate_tpu_torch.ops import attention
from vgate_tpu_torch.ops.kernels import _build
from vgate_tpu_torch.ops.kv_quant import SCALE_DTYPE, KVPool, is_quantized

HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8  # query heads per kv head, as K1 and K2 are held to


def key_tile(hd: int) -> int:
    """Keys a tile of both modes (flash_sm90.cuh ``Cfg::kN``)."""
    return 64 if hd == 256 else 128


def tma_page_size(ps: int, hd: int, int8: bool = False) -> bool:
    """Whether K3 takes page size ``ps`` at head dim ``hd``, on bf16
    pools or (``int8``) on int8 pools.  Both modes copy a key tile of kN
    keys as boxes of ``min(ps, kN)`` rows of one page, so the tile must be
    whole boxes: kN % ps == 0 or ps % kN == 0.  What each box asks of its
    rows:

    * bf16 pools: a TMA box of a 2-D map over the layer view; a row is
      ``2 * hd`` bytes (a multiple of 16 at every head dim), and the
      kernel's boxes start on rows that are multiples of 8;
    * int8 pools: one bulk copy of the box's contiguous rows, ``hd``
      bytes a row (a multiple of 16 at every head dim, so any row count
      passes), and one of its bf16 scales, 2 bytes a row: a bulk copy
      moves multiples of 16 bytes from 16-byte addresses, so a box must be
      a multiple of 8 rows.

    Either way ps must be a multiple of 8 that divides kN or that kN
    divides (8, 16, 32, 64, 128, 256, ... at kN 128)."""
    kN = key_tile(hd)
    box = min(ps, kN)
    if kN % box or ps % box:  # a tile is whole boxes of one page
        return False
    if int8:  # K/V rows and scales by bulk copy, 16-byte multiples
        return box * hd % 16 == 0 and box * 2 % 16 == 0
    return box % 8 == 0  # whole 8-row swizzle atoms of 128-byte rows


def taken_page_sizes(hd: int, int8: bool = False, upto: int = 512) -> list:
    """The page sizes up to ``upto`` that K3 takes at head dim ``hd``."""
    return [ps for ps in range(1, upto + 1) if tma_page_size(ps, hd, int8)]


def check_engine_page_size(device: str, page_size: int, head_dim: int,
                           kv_int8: bool, prefix_cache: bool,
                           prefill_chunk: int) -> None:
    """Refuse, when an engine is built, a page size K3 cannot take.

    On a CUDA device every prefix hit and every prefill chunk runs K3
    (``paged_multitok_attention`` or its int8 mode), and its wrapper
    raises on such a page size: the engine would serve cold prompts and
    die at the first hit or chunk.  So with the prefix cache on or
    ``prefill_chunk`` > 0 this raises ``NotPortedError`` naming K3, the
    pool type and the page sizes it takes.  The CPU path takes every
    page size, and without either feature K3 never runs."""
    if device != "cuda" or not (prefix_cache or prefill_chunk > 0):
        return
    if tma_page_size(page_size, head_dim, kv_int8):
        return
    pools = "int8" if kv_int8 else "bf16"
    raise NotPortedError(
        f"device.kv_page_size={page_size} on CUDA with the prefix cache "
        f"or chunked prefill: K3 (paged multi-token attention) on {pools} "
        f"pools at head dim {head_dim} takes page sizes that are multiples "
        f"of 8 dividing {key_tile(head_dim)} or divided by it "
        f"({', '.join(map(str, taken_page_sizes(head_dim, kv_int8)))}); "
        "other page sizes: ROADMAP queue 2"
    )


def _lib(int8: bool = False, partial: bool = False):
    lib = _build.load("paged_multitok")
    if partial:
        fn = lib.vgt_paged_multitok_partial_bf16
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
                ctypes.c_float, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p]
        return fn
    fn = lib.vgt_paged_multitok_int8 if int8 else lib.vgt_paged_multitok_bf16
    if fn.argtypes is None:  # declare once: pointers must not be cut to int
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * (9 if int8 else 7) + [
            ctypes.c_int
        ] * 9 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    return fn


def _check(q, k_pages, v_pages, page_tables, positions0, input_lens,
           scales: tuple = ()) -> None:
    """Device, dtype, shape and contiguity; ``scales`` (the int8 mode's
    K and V scale pools) marks ``k_pages``/``v_pages`` as int8 data."""
    named = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
             ("page_tables", page_tables), ("positions0", positions0),
             ("input_lens", input_lens)]
    named += [(f"scale pool {i}", t) for i, t in enumerate(scales)]
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    pool_dtype = torch.int8 if scales else torch.bfloat16
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        want = torch.bfloat16 if name == "q" else pool_dtype
        if t.dtype != want:
            raise ValueError(
                f"the paged multi-token kernel takes {want} {name}, "
                f"not {t.dtype}"
            )
    for t in scales:
        if t.dtype != SCALE_DTYPE or t.shape != k_pages.shape[:-1]:
            raise ValueError("the scale pools must be bf16 [KV, P, ps]")
    for name, t in named[3:6]:
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            "expected q [B, S, H, hd] and pools [KV, P, ps, hd], got "
            f"{tuple(q.shape)} and {tuple(k_pages.shape)}"
        )
    B, S, H, hd = q.shape
    KV = k_pages.shape[0]
    if k_pages.shape[3] != hd or hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS} or pool mismatch")
    if H % KV or H // KV > MAX_GROUP:
        raise ValueError(
            f"H={H}, KV={KV}: need KV | H and H/KV <= {MAX_GROUP}"
        )
    if page_tables.dim() != 2 or page_tables.shape[0] != B:
        raise ValueError(f"page_tables must be [B={B}, ctx_pages]")
    if positions0.shape != (B,) or input_lens.shape != (B,):
        raise ValueError(f"positions0 and input_lens must be [B={B}]")


def paged_multitok_attention(
    q: torch.Tensor,  # [B, S, H, hd] suffix queries
    k_pages: KVPool,  # [KV, P, ps, hd] one layer's pool (a view)
    v_pages: KVPool,
    page_tables: torch.Tensor,  # [B, ctx_pages] int32 context window
    positions0: torch.Tensor,  # [B] int32 global position of q[:, 0]
    input_lens: torch.Tensor,  # [B] int32 real query rows (<= S)
    softcap: float = 0.0,
    window: int = 0,  # >0 => attend only to the last `window` keys
    scale: Optional[float] = None,  # query scale; default hd**-0.5
) -> torch.Tensor:
    """Attention of S query rows per slot over the paged context; the
    rows' own KV must already be in the pool.  Any S >= 1, from any
    ``positions0`` (a suffix pass, or a speculative verify pass of 1..k+1
    rows).  Returns [B, S, H, hd]; rows past ``input_lens`` are finite
    and unspecified.

    The kernel reads page-table entries only below ``positions0 +
    input_lens`` and clamps that to ``ctx_pages * ps`` on the device, so
    lengths the engine failed to bound cannot read past the table
    (checking them on the host would cost a device sync per layer).  int8
    ``QuantPages`` pools go to :func:`paged_multitok_attention_int8`."""
    if is_quantized(k_pages):
        return paged_multitok_attention_int8(
            q, k_pages, v_pages, page_tables, positions0, input_lens,
            softcap=softcap, window=window, scale=scale,
        )
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
    if not tma_page_size(ps, hd):
        raise ValueError(
            f"page size {ps} at head dim {hd}: the bf16 kernel takes "
            f"multiples of 8 that divide {key_tile(hd)} or that it divides"
        )
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes (TMA)")
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
    _build.count_launch(paged_multitok_attention)
    return out


def paged_multitok_attention_int8(
    q: torch.Tensor,  # [B, S, H, hd] bf16 suffix queries
    k_pages: KVPool,  # QuantPages [KV, P, ps, hd] one layer's (views)
    v_pages: KVPool,
    page_tables: torch.Tensor,  # [B, ctx_pages] int32 context window
    positions0: torch.Tensor,  # [B] int32 global position of q[:, 0]
    input_lens: torch.Tensor,  # [B] int32 real query rows (<= S)
    softcap: float = 0.0,
    window: int = 0,  # >0 => attend only to the last `window` keys
    scale: Optional[float] = None,  # query scale; default hd**-0.5
) -> torch.Tensor:
    """K3-int8: the suffix attention over int8 pools with per-token bf16
    scales, folded into the scores (K) and the softmax weights (V) as the
    TPU kernel folds them.  Returns [B, S, H, hd]."""
    if q.device.type == "cpu":
        return attention.paged_suffix_attention(
            q, k_pages, v_pages, page_tables, positions0,
            positions0 + input_lens, softcap=softcap,
            window=window if window else None, scale=scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (is_quantized(k_pages) and is_quantized(v_pages)):
        raise ValueError("K3's int8 mode needs int8 QuantPages pools")
    _check(q, k_pages.data, v_pages.data, page_tables, positions0,
           input_lens, scales=(k_pages.scale, v_pages.scale))
    B, S, H, hd = q.shape
    KV, P, ps, _ = k_pages.shape
    if not tma_page_size(ps, hd, int8=True):
        raise ValueError(
            f"page size {ps} at head dim {hd}: the int8 kernel takes "
            f"multiples of 8 that divide {key_tile(hd)} or that it divides"
        )
    for name, t in (("q", q), ("k_pages", k_pages.data),
                    ("v_pages", v_pages.data), ("k scales", k_pages.scale),
                    ("v scales", v_pages.scale)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes (bulk copy)")
    out = torch.empty_like(q)
    rc = _lib(int8=True)(
        q.data_ptr(), k_pages.data.data_ptr(), v_pages.data.data_ptr(),
        k_pages.scale.data_ptr(), v_pages.scale.data_ptr(),
        page_tables.data_ptr(), positions0.data_ptr(), input_lens.data_ptr(),
        out.data_ptr(), B, S, H, KV, P, ps, page_tables.shape[1], hd,
        int(window), float(scale if scale is not None else hd ** -0.5),
        float(softcap), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"paged multi-token int8 kernel launch failed: cuda error {rc}"
        )
    _build.count_launch(paged_multitok_attention_int8)
    return out


def paged_multitok_partial(
    q: torch.Tensor,  # [B, S, H, hd] bf16 queries
    k_pages: torch.Tensor,  # [KV, P/sp, ps, hd] one layer's pool shard
    v_pages: torch.Tensor,
    page_tables: torch.Tensor,  # [B, ctx_pages] int32 GLOBAL page ids
    positions0: torch.Tensor,  # [B] int32 global position of q[:, 0]
    input_lens: torch.Tensor,  # [B] int32 real query rows (<= S)
    base: int,  # the shard's first global page
    softcap: float = 0.0,
    window: int = 0,  # >0 => attend only to the last `window` keys
    scale: Optional[float] = None,  # query scale; default hd**-0.5
):
    """K3-sp: :func:`paged_multitok_attention` over the pages of one sp
    rank's shard, global pages ``[base, base + P/sp)``, as the
    unnormalised fp32 partials ``(acc [B, S, H, hd], m [B, S, H], l [B, S,
    H])``.  A key on another rank's page is masked (its box reads the
    rank's zeroed local page 0); a row that sees no owned key comes out
    ``acc = 0``, ``m = -1e30``, ``l = 0``.  The rows' own KV must already
    be in the pools of their owners."""
    if q.device.type == "cpu":
        local, owned = attention.local_pages(page_tables, base,
                                             k_pages.shape[1])
        return attention.partial_suffix_attention(
            q, k_pages, v_pages, local, owned, positions0,
            positions0 + input_lens, window=window, softcap=softcap,
            scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if is_quantized(k_pages):
        raise ValueError("K3-sp takes bf16 pools")
    _check(q, k_pages, v_pages, page_tables, positions0, input_lens)
    B, S, H, hd = q.shape
    KV, P, ps, _ = k_pages.shape
    if not tma_page_size(ps, hd):
        raise ValueError(
            f"page size {ps} at head dim {hd}: the bf16 kernel takes "
            f"multiples of 8 that divide {key_tile(hd)} or that it divides"
        )
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes (TMA)")
    acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    rc = _lib(partial=True)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_tables.data_ptr(), positions0.data_ptr(), input_lens.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), B, S, H, KV, P, ps,
        page_tables.shape[1], hd, int(window),
        float(scale if scale is not None else hd ** -0.5), float(softcap),
        int(base), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"paged multi-token partial kernel launch failed: cuda error {rc}"
        )
    _build.count_launch(paged_multitok_partial)
    return acc, m, l


paged_multitok_attention.launches = 0
paged_multitok_attention_int8.launches = 0
paged_multitok_partial.launches = 0
