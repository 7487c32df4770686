"""Wrappers of the paged-decode CUDA kernel (csrc/paged_decode.cu).

K1 replaces vgate_tpu/ops/pallas/paged_attention.py
``paged_decode_attention_pallas``: bf16 and f32 pools
(:func:`paged_decode_attention`) and, for int8 ``QuantPages`` pools, its
int8 mode (:func:`paged_decode_attention_int8`, K1-int8, which
:func:`paged_decode_attention` hands such pools to).  K6 replaces
``paged_decode_attention_pallas_blocked``, the same function with
``block_slots`` slots a program (:func:`paged_decode_attention_blocked`):
a page-split decode whose plan :func:`split_plan` sizes on the host,
whose units :func:`slot_chunks` mirrors and whose chunk merge
:func:`split_decode_plain` models.
A CPU tensor takes the plain version (ops/attention.py
``paged_decode_attention``, the function of both); a CUDA tensor
launches the kernel or raises — there is no fallback.  Each function's
``launches`` counts the launches of its mode.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from vgate_tpu_torch.ops import attention
from vgate_tpu_torch.ops.kernels import _build
from vgate_tpu_torch.ops.kv_quant import SCALE_DTYPE, KVPool, is_quantized

HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8  # query heads per kv head the kernel instantiates
DTYPES = {torch.bfloat16: 0, torch.float32: 1}  # the C interface's codes

# K6's plan (csrc/paged_decode.cu, split namespace): a copy warpgroup and
# 8 compute warps, one CTA an SM (the compute warps' registers); a stage
# holds one tile's K and V, at most STAGE_BYTES; the ring up to
# MAX_STAGES stages, as many as the SM's shared memory holds; a chunk
# about CHUNK_BYTES of a slot's K and V, whatever the block's slot count
# (shorter chunks at 8 slots a CTA measured slower: each ends in a merge)
SPLIT_WARPS = 8
STAGE_BYTES = 32 * 1024
MAX_STAGES = 8
CHUNK_BYTES = 256 * 1024
SM_SHARED_BYTES = 233472  # an H100 SM's shared memory, 1 KB a CTA reserved


class SplitPlan(NamedTuple):
    """How K6 cuts one call: ``tile_rows`` rows of a page a tile (a stage
    holds one tile's K and V), ``stages`` in the ring, ``chunk_tiles``
    tiles a chunk (at least: a slot longer than ``max_chunks`` chunks takes
    longer ones), ``max_chunks`` a slot (1: every slot writes its output
    directly and no merge launches), ``grid`` persistent CTAs,
    ``workspace`` fp32 values of chunk partials and ``smem`` bytes a
    CTA."""

    tile_rows: int
    stages: int
    chunk_tiles: int
    max_chunks: int
    grid: int
    workspace: int
    smem: int


def group_width(G: int) -> int:
    """The query heads a kv head the kernel's state is instantiated for:
    G rounded up to 1, 2, 4 or 8."""
    return next(w for w in (1, 2, 4, 8) if G <= w)


def live_tiles_bound(ps: int, pps: int, window: int, tile_rows: int) -> int:
    """The most tiles a slot's live range spans: the table's width, or a
    window of ``window`` tokens starting anywhere in a tile."""
    width = pps * ps // tile_rows
    if window <= 0:
        return width
    return min(width, -(-(tile_rows - 1 + window) // tile_rows))


@functools.lru_cache(maxsize=1024)
def split_plan(B: int, H: int, KV: int, hd: int, ps: int, pps: int,
               window: int, block_slots: int, elem_bytes: int,
               sm_count: int) -> SplitPlan:
    """K6's plan for one call shape (seq_lens stay on the card: the plan
    takes the live-range bound, and the kernel counts the live units).
    A tile is the largest divisor of ``ps`` whose K and V fit a stage; a
    chunk carries about ``CHUNK_BYTES`` of a slot's K and V, fewer tiles
    where the live-range bound would leave the grid short of two units a
    CTA; the grid is one CTA an SM, and no more than units exist."""
    tile_rows = max(t for t in range(1, ps + 1)
                    if ps % t == 0 and 2 * t * hd * elem_bytes <= STAGE_BYTES)
    tile_bytes = 2 * tile_rows * hd * elem_bytes
    groups = B // block_slots
    gm = group_width(H // KV)
    # the barriers, four query buffers, the warps' merge buffer, the prefix
    # sums; the ring takes what is left, 2 to MAX_STAGES stages
    other = (16 * (MAX_STAGES + 4) + 4 * gm * hd * elem_bytes
             + 4 * SPLIT_WARPS * gm * (hd + 2) + 4 * (groups + 1))
    room = SM_SHARED_BYTES - 1024 - other
    stages = max(2, min(MAX_STAGES, room // tile_bytes))
    smem = other + stages * tile_bytes
    bound = live_tiles_bound(ps, pps, window, tile_rows)
    chunk_tiles = max(1, CHUNK_BYTES // tile_bytes)
    chunk_tiles = max(1, min(chunk_tiles,
                             groups * KV * bound // (2 * sm_count)))
    max_chunks = -(-bound // chunk_tiles)
    grid = min(sm_count, groups * KV * max_chunks)
    workspace = B * KV * max_chunks * (H // KV) * (hd + 2) \
        if max_chunks > 1 else 0
    return SplitPlan(tile_rows, stages, chunk_tiles, max_chunks, grid,
                     workspace, smem)


def slot_chunks(seq_len: int, window: int, ps: int, pps: int,
                plan: SplitPlan) -> List[Tuple[int, int]]:
    """The tile ranges ``[t0, t1)`` of a slot's chunks in the kernel's
    order (csrc/paged_decode.cu ``split::slot_of``): the live range
    (window start to seq_len, clamped to the table's width) in tiles of
    ``plan.tile_rows`` tokens, cut into chunks of ``plan.chunk_tiles``
    tiles, or longer ones where that would make more than
    ``plan.max_chunks``.  An empty slot has one empty chunk (its unit
    writes zeros)."""
    T = plan.tile_rows
    sl = min(max(seq_len, 0), pps * ps)
    lo = max(sl - window, 0) if window > 0 else 0
    t0 = lo // T
    n = -(-sl // T) - t0 if sl > 0 else 0
    ct = max(plan.chunk_tiles, -(-n // plan.max_chunks))
    chunks = max(1, -(-n // ct))
    return [(t0 + c * ct, t0 + min(n, (c + 1) * ct)) for c in range(chunks)]


def split_decode_plain(q, k_pages, v_pages, page_tables, seq_lens,
                       plan: SplitPlan, softcap: float = 0.0,
                       window: int = 0,
                       scale: Optional[float] = None) -> torch.Tensor:
    """K6's arithmetic in plain PyTorch (fp32): each chunk of
    :func:`slot_chunks` reduced to its (m, l, acc) per query head, then a
    slot's chunks merged in chunk order.  Returns [B, H, hd] in fp32."""
    B, H, hd = q.shape
    KV, _, ps, _ = k_pages.shape
    G = H // KV
    pps = page_tables.shape[1]
    scale = hd ** -0.5 if scale is None else scale
    out = torch.zeros(B, H, hd, dtype=torch.float32)
    for b in range(B):
        sl = min(max(int(seq_lens[b]), 0), pps * ps)
        lo = max(sl - window, 0) if window > 0 else 0
        parts = []
        for t0, t1 in slot_chunks(int(seq_lens[b]), window, ps, pps, plan):
            a = max(t0 * plan.tile_rows, lo)
            e = min(t1 * plan.tile_rows, sl)
            pos = torch.arange(a, e)
            pages = page_tables[b, (pos // ps).long()].long()
            k = k_pages[:, pages, pos % ps].float()  # [KV, n, hd]
            v = v_pages[:, pages, pos % ps].float()
            qh = q[b].float().reshape(KV, G, hd) * scale
            s = torch.einsum("ghd,gnd->ghn", qh, k)
            if softcap > 0:
                s = torch.tanh(s / softcap) * softcap
            m = (s.amax(-1) if s.shape[-1] else
                 torch.full((KV, G), -1e30))
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("ghn,gnd->ghd", p, v)))
        m_all = torch.stack([m for m, _, _ in parts]).amax(0)
        l_all = torch.zeros(KV, G)
        a_all = torch.zeros(KV, G, hd)
        for m, l_c, a_c in parts:
            f = torch.exp(m - m_all)
            l_all = l_all + l_c * f
            a_all = a_all + a_c * f[..., None]
        out[b] = (a_all / l_all.clamp_min(1e-30)[..., None]).reshape(H, hd)
    return out


def _lib(int8: bool = False, blocked: bool = False):  # one entry point
    lib = _build.load("paged_decode")
    if blocked:
        fn = lib.vgt_paged_decode_blocked
        if fn.argtypes is None:  # declare once: pointers must not be cut
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
                ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 7 + [
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
    """K6: K1's function, split over pages: a unit of work is chunk c
    of each slot of a block of ``block_slots`` slots for one kv head (see
    :func:`split_plan`).  Returns [B, H, hd].

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
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("K6 needs q and the pools on 16 bytes (bulk "
                         "copies, paired loads)")
    B, H, hd = q.shape
    KV, P, ps, _ = k_pages.shape
    pps = page_tables.shape[1]
    plan = split_plan(B, H, KV, hd, ps, pps, int(window), int(block_slots),
                      q.element_size(), _build.sm_count(q.device))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = (_build.workspace(q.device, stream, plan.workspace)
          if plan.max_chunks > 1 else None)
    out = torch.empty_like(q)
    rc = _lib(blocked=True)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        B, H, KV, P, ps, pps, hd, int(window),
        float(scale if scale is not None else hd ** -0.5), float(softcap),
        int(block_slots), plan.tile_rows, plan.stages, plan.chunk_tiles,
        plan.max_chunks, plan.grid, DTYPES[q.dtype], stream,
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
