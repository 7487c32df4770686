"""Wrappers of the paged-decode CUDA kernels (csrc/paged_decode.cu).

K1 replaces vgate_tpu/ops/pallas/paged_attention.py
``paged_decode_attention_pallas``: bf16 and f32 pools
(:func:`paged_decode_attention`) and, for int8 ``QuantPages`` pools, its
int8 mode (:func:`paged_decode_attention_int8`, K1-int8, which
:func:`paged_decode_attention` hands such pools to).  K6 replaces
``paged_decode_attention_pallas_blocked``, the same function with
``block_slots`` slots a program (:func:`paged_decode_attention_blocked`).
K1-sp (:func:`paged_decode_partial`) is K1's partial mode under sequence
parallelism: the unnormalised partials over one sp rank's pool shard.
Both are page-split decodes: K1 (bf16 and int8 pools) runs both products
on the tensor cores with the plan :func:`decode_plan`, K6 (and K1 on f32
pools, by an explicit dtype dispatch) runs fp32 on the CUDA cores with
the plan :func:`split_plan`; :func:`slot_chunks` mirrors the units of
either plan and :func:`split_decode_plain` models their arithmetic,
int8 scale folding included.
A CPU tensor takes the plain version (ops/attention.py
``paged_decode_attention``, the function of both); a CUDA tensor
launches the kernel or raises — there is no fallback.  Each function's
``launches`` counts the launches of its mode.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

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


# K1's plan (csrc/paged_decode.cu, paged_decode_tc_kernel): K6's CTA; a
# stage holds one tile's K and V as TMA boxes of 128 bytes a row (64 for
# int8 rows at hd 64) over the tile's rows rounded up to whole m16 steps,
# each box on 1024 bytes, then (int8) the tile's K and V scale rows; at
# most TC_STAGE_BYTES a stage and TC_MAX_STAGES stages; a chunk at most
# TC_CHUNK_TILES tiles (one a compute warp), fewer where the live-range
# bound would leave the grid short of two units a CTA
TC_STAGE_BYTES = 32 * 1024
TC_MAX_STAGES = 12
TC_CHUNK_TILES = 8
TC_MAX_TILE_ROWS = 256  # a TMA box's rows

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


class DecodePlan(NamedTuple):
    """How K1 cuts one call: as :class:`SplitPlan` (``tile_rows``,
    ``stages``, ``chunk_tiles``, ``max_chunks``, ``grid``, ``workspace``,
    ``smem``), and ``scale_bulk``: int8 scale rows come by bulk copy (a
    page's scale row a multiple of 16 bytes), else by the copy warp's own
    loads."""

    tile_rows: int
    stages: int
    chunk_tiles: int
    max_chunks: int
    grid: int
    workspace: int
    smem: int
    scale_bulk: bool


def tc_stage_bytes(hd: int, elem_bytes: int, tile_rows: int) -> int:
    """Bytes of one K1 stage (csrc/paged_decode.cu ``tc_stage_bytes``)."""
    span = min(128, hd * elem_bytes)
    boxes = hd * elem_bytes // span
    pad = -(-tile_rows // 16) * 16
    box = -(-pad * span // 1024) * 1024
    scales = 4 * pad if elem_bytes == 1 else 0
    return -(-(2 * boxes * box + scales) // 1024) * 1024


@functools.lru_cache(maxsize=1024)
def decode_plan(B: int, H: int, KV: int, hd: int, ps: int, pps: int,
                window: int, elem_bytes: int, sm_count: int) -> DecodePlan:
    """K1's plan for one call shape (``elem_bytes`` 2: bf16 pools, 1: int8
    pools).  A tile is the largest divisor of ``ps`` (at most a TMA box's
    256 rows) whose stage fits ``TC_STAGE_BYTES``; the ring takes what
    shared memory leaves, 2 to ``TC_MAX_STAGES`` stages; a chunk is
    ``TC_CHUNK_TILES`` tiles, no more than the stages and fewer where the
    live-range bound would leave the grid short of two units a CTA; the
    grid is one CTA an SM, and no more than units exist."""
    G = H // KV
    tile_rows = max(t for t in range(1, min(ps, TC_MAX_TILE_ROWS) + 1)
                    if ps % t == 0
                    and tc_stage_bytes(hd, elem_bytes, t) <= TC_STAGE_BYTES)
    stage = tc_stage_bytes(hd, elem_bytes, tile_rows)
    # the query buffers, the warps' merge buffer, the prefix sums and the
    # merge flag, then the barriers (csrc/paged_decode.cu tc_smem_bytes)
    other = 4 * 8 * hd * 2 + 4 * SPLIT_WARPS * G * (hd + 2) + 4 * (B + 2)
    bars = 16 * (TC_MAX_STAGES + 4)
    room = SM_SHARED_BYTES - 1024 - other - 8 - bars
    stages = max(2, min(TC_MAX_STAGES, room // stage))
    smem = -(-(stages * stage + other) // 8) * 8 + bars
    bound = live_tiles_bound(ps, pps, window, tile_rows)
    # no more tiles a chunk than stages: a unit's tiles go to different
    # warps, and two of them waiting on one stage in two rounds would let
    # the later one pass the earlier round's phase
    chunk_tiles = max(1, min(TC_CHUNK_TILES, stages,
                             B * KV * bound // (2 * sm_count)))
    max_chunks = -(-bound // chunk_tiles)
    grid = min(sm_count, B * KV * max_chunks)
    workspace = B * KV * max_chunks * G * (hd + 2) if max_chunks > 1 else 0
    scale_bulk = elem_bytes == 1 and ps % 8 == 0 and tile_rows % 8 == 0
    return DecodePlan(tile_rows, stages, chunk_tiles, max_chunks, grid,
                      workspace, smem, scale_bulk)


def slot_chunks(seq_len: int, window: int, ps: int, pps: int,
                plan) -> List[Tuple[int, int]]:
    """The tile ranges ``[t0, t1)`` of a slot's chunks under ``plan`` (a
    :class:`SplitPlan` or a :class:`DecodePlan`), in the kernels' order
    (csrc/paged_decode.cu ``split::slot_of``): the live range
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
                       plan, softcap: float = 0.0, window: int = 0,
                       scale: Optional[float] = None) -> torch.Tensor:
    """The split kernels' arithmetic in plain PyTorch (fp32): each chunk
    of :func:`slot_chunks` reduced to its (m, l, acc) per query head, then
    a slot's chunks merged in chunk order.  int8 ``QuantPages`` pools fold
    their scales as K1-int8 does: the K scale multiplies the score before
    the softcap, the V scale the softmax weight after the row sum took it
    unweighted.  Returns [B, H, hd] in fp32."""
    B, H, hd = q.shape
    KV, _, ps, _ = k_pages.shape
    G = H // KV
    pps = page_tables.shape[1]
    scale = hd ** -0.5 if scale is None else scale
    quant = is_quantized(k_pages)
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
            qh = q[b].float().reshape(KV, G, hd)
            if quant:  # [KV, n, hd] int8 values, [KV, n] scales
                k = k_pages.data[:, pages, pos % ps].float()
                v = v_pages.data[:, pages, pos % ps].float()
                ks = k_pages.scale[:, pages, pos % ps].float()[:, None]
                vs = v_pages.scale[:, pages, pos % ps].float()[:, None]
                s = torch.einsum("ghd,gnd->ghn", qh, k) * ks * scale
            else:
                k = k_pages[:, pages, pos % ps].float()
                v = v_pages[:, pages, pos % ps].float()
                s = torch.einsum("ghd,gnd->ghn", qh * scale, k)
            if softcap > 0:
                s = torch.tanh(s / softcap) * softcap
            m = (s.amax(-1) if s.shape[-1] else
                 torch.full((KV, G), -1e30))
            p = torch.exp(s - m[..., None])
            pv = p * vs if quant else p
            parts.append((m, p.sum(-1), torch.einsum("ghn,gnd->ghd", pv, v)))
        m_all = torch.stack([m for m, _, _ in parts]).amax(0)
        l_all = torch.zeros(KV, G)
        a_all = torch.zeros(KV, G, hd)
        for m, l_c, a_c in parts:
            f = torch.exp(m - m_all)
            l_all = l_all + l_c * f
            a_all = a_all + a_c * f[..., None]
        out[b] = (a_all / l_all.clamp_min(1e-30)[..., None]).reshape(H, hd)
    return out


class DecodeArgs(ctypes.Structure):
    """K1's call shape and plan as csrc/paged_decode.cu's ``DecodeArgs``:
    packed once per call shape, so a call passes pointers only."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "B", "H", "KV", "P", "ps", "pps", "hd", "window")] + [
        ("scale", ctypes.c_float), ("softcap", ctypes.c_float)] + [
        (name, ctypes.c_int) for name in (
            "tile_rows", "stages", "chunk_tiles", "max_chunks", "grid",
            "int8", "scale_bulk")]


_ARGTYPES = {
    # q, pools, scale pools, tables, lens, out, workspace, DecodeArgs*,
    # the stream
    "vgt_paged_decode": [ctypes.c_void_p] * 11,
    # q, pools, tables, lens, acc, m, l, workspace, DecodeArgs*, base,
    # the stream
    "vgt_paged_decode_partial": [ctypes.c_void_p] * 10 + [
        ctypes.c_int, ctypes.c_void_p],
    "vgt_paged_decode_blocked": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 7 + [
        ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _lib(name: str):
    """One entry point of the library, its argument types declared once
    (pointers must not be cut to int)."""
    fn = getattr(_build.load("paged_decode"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES[name]
    return fn


def _check(q, k_pages, v_pages, page_tables, seq_lens,
           scales: tuple = ()) -> None:
    """Device, dtype, shape, contiguity and the 16-byte alignment the
    bulk and TMA copies need; ``scales`` (the int8 mode's K and V scale
    pools) marks ``k_pages``/``v_pages`` as int8 data."""
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
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("the decode kernels need q and the pools on 16 "
                         "bytes (bulk and TMA copies)")


# K1's launches by call shape: the key pins every shape, dtype and device
# that _check validates, so a call of a known shape checks only what a
# tensor of that shape can still get wrong (contiguity, 16-byte
# alignment); the value holds the plan and its packed DecodeArgs
_TC_SHAPES: Dict[tuple, tuple] = {}


def _tc_launch(q, k, v, ks, vs, page_tables, seq_lens, softcap, window,
               scale, base: Optional[int] = None):
    """K1 on bf16 pools (``ks`` None) or int8 pools with scale pools
    ``ks``/``vs``: one launch of ``paged_decode_tc_kernel`` and, where a
    slot may span chunks, one of its chunk merge.  With ``base`` (K1-sp,
    bf16 pools) the pools are the shard of global pages ``[base, base +
    P)`` and the result the fp32 partials ``(acc, m, l)``: every slot's
    chunks merge in the second launch."""
    key = (q.shape, q.dtype, q.device, k.shape, k.dtype, k.device, v.shape,
           v.dtype, v.device, page_tables.shape, page_tables.dtype,
           page_tables.device, seq_lens.shape, seq_lens.dtype,
           seq_lens.device, window, softcap, scale,
           None if ks is None else (ks.shape, ks.dtype, ks.device, vs.shape,
                                    vs.dtype, vs.device))
    entry = _TC_SHAPES.get(key)
    if entry is None:
        _check(q, k, v, page_tables, seq_lens,
               scales=() if ks is None else (ks, vs))
        B, H, hd = q.shape
        KV, P, ps, _ = k.shape
        pps = page_tables.shape[1]
        plan = decode_plan(B, H, KV, hd, ps, pps, window, k.element_size(),
                           _build.sm_count(q.device))
        args = DecodeArgs(
            B, H, KV, P, ps, pps, hd, window,
            scale if scale is not None else hd ** -0.5, softcap,
            plan.tile_rows, plan.stages, plan.chunk_tiles, plan.max_chunks,
            plan.grid, int(ks is not None), int(plan.scale_bulk))
        entry = (plan, args, ctypes.addressof(args), q.device.index or 0)
        _TC_SHAPES[key] = entry
    elif not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
              and page_tables.is_contiguous() and seq_lens.is_contiguous()
              and (ks is None or ks.is_contiguous() and vs.is_contiguous())
              and not (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16):
        _check(q, k, v, page_tables, seq_lens,
               scales=() if ks is None else (ks, vs))  # raises
    plan, _, args_ptr, index = entry
    # the current stream's handle without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(index)
    if base is not None:
        B, H, hd = q.shape
        ws = _build.workspace(
            q.device, stream, B * k.shape[0] * plan.max_chunks
            * (H // k.shape[0]) * (hd + 2)).data_ptr()
        acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        m = torch.empty((B, H), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        rc = _lib("vgt_paged_decode_partial")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), page_tables.data_ptr(),
            seq_lens.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            ws, args_ptr, int(base), stream,
        )
        if rc != 0:
            raise RuntimeError(
                f"paged-decode partial kernel launch failed: cuda error {rc}")
        return acc, m, l
    ws = (_build.workspace(q.device, stream, plan.workspace).data_ptr()
          if plan.max_chunks > 1 else None)
    out = torch.empty_like(q)
    rc = _lib("vgt_paged_decode")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(),
        page_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), ws,
        args_ptr, stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged-decode kernel launch failed: cuda error {rc}")
    return out


def _split_launch(q, k_pages, v_pages, page_tables, seq_lens, softcap,
                  window, scale, block_slots) -> torch.Tensor:
    """One launch of K6's ``paged_decode_split_kernel`` (and its chunk
    merge) at ``block_slots`` slots a unit."""
    B, H, hd = q.shape
    KV, P, ps, _ = k_pages.shape
    pps = page_tables.shape[1]
    plan = split_plan(B, H, KV, hd, ps, pps, int(window), int(block_slots),
                      q.element_size(), _build.sm_count(q.device))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = (_build.workspace(q.device, stream, plan.workspace)
          if plan.max_chunks > 1 else None)
    out = torch.empty_like(q)
    rc = _lib("vgt_paged_decode_blocked")(
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
    return out


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
    pools go to :func:`paged_decode_attention_int8`.  A dtype dispatch,
    not a fallback: bf16 pools run K1's tensor-core kernel; f32 pools
    (called directly only: the engine refuses ``model.dtype: float32`` on
    CUDA) run K6's fp32 CUDA-core body at one slot a unit.  Both count as
    K1's launches."""
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
    if q.dtype == torch.float32:
        _check(q, k_pages, v_pages, page_tables, seq_lens)
        out = _split_launch(q, k_pages, v_pages, page_tables, seq_lens,
                            softcap, window, scale, 1)
    else:
        out = _tc_launch(q, k_pages, v_pages, None, None, page_tables,
                         seq_lens, float(softcap), int(window), scale)
    _build.count_launch(paged_decode_attention)
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
    out = _tc_launch(q, k_pages.data, v_pages.data, k_pages.scale,
                     v_pages.scale, page_tables, seq_lens, float(softcap),
                     int(window), scale)
    _build.count_launch(paged_decode_attention_int8)
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
    out = _split_launch(q, k_pages, v_pages, page_tables, seq_lens, softcap,
                        window, scale, block_slots)
    _build.count_launch(paged_decode_attention_blocked)
    return out


paged_decode_attention.launches = 0
paged_decode_attention_int8.launches = 0
paged_decode_attention_blocked.launches = 0


def paged_decode_partial(
    q: torch.Tensor,  # [B, H, hd] bf16
    k_pages: torch.Tensor,  # [KV, P/sp, ps, hd] one layer's pool shard
    v_pages: torch.Tensor,
    page_tables: torch.Tensor,  # [B, pps] int32 GLOBAL page ids
    seq_lens: torch.Tensor,  # [B] int32, context incl. the current token
    base: int,  # the shard's first global page
    softcap: float = 0.0,
    window: int = 0,  # >0 => attend only to the last `window` keys
    scale: Optional[float] = None,  # query scale; default hd**-0.5
):
    """K1-sp: decode attention over the pages of one sp rank's shard,
    global pages ``[base, base + P/sp)``, as the unnormalised fp32
    partials ``(acc [B, H, hd], m [B, H], l [B, H])`` that merge over sp
    (parallel/sp_decode.py).  A tile whose page another rank owns is
    neither copied nor read; a head that sees no owned key comes out
    ``acc = 0``, ``m = -1e30``, ``l = 0``.  bf16 pools only (int8 KV under
    sp is the reference's own error).  The plain version is ops/
    attention.py ``partial_paged_attention``."""
    if q.device.type == "cpu":
        local, owned = attention.local_pages(page_tables, base,
                                             k_pages.shape[1])
        return attention.partial_paged_attention(
            q, k_pages, v_pages, local, owned, seq_lens, window=window,
            softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if is_quantized(k_pages) or q.dtype != torch.bfloat16:
        raise ValueError("K1-sp takes bf16 q and bf16 pools")
    out = _tc_launch(q, k_pages, v_pages, None, None, page_tables, seq_lens,
                     float(softcap), int(window), scale, base=int(base))
    _build.count_launch(paged_decode_partial)
    return out


paged_decode_partial.launches = 0
