"""Wrappers of the dequant-matmul CUDA kernels (csrc/int8_matmul.cu, K4;
csrc/quant_matmul.cu, K5).

K4 :func:`int8_matmul` replaces vgate_tpu/ops/pallas/quant_matmul.py
``int8_matmul_pallas``, K5 :func:`int4_matmul` its ``int4_matmul_pallas``:
``x [..., in] @ W [in, out]`` with W int8 (or int4 packed two a byte in
the half-split layout), f32 accumulation and the per-output-channel f32
scale applied before the cast to ``out_dtype``.  A CPU tensor takes the
plain version (:func:`int8_matmul_plain`, :func:`int4_matmul_plain`); a
CUDA tensor launches the kernel or raises — there is no fallback.  Each
wrapper's ``launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from vgate_tpu_torch.ops.kernels import _build

TILE_IN = 64  # the kernels' k step (unpacked values)
TILE_OUT = 64  # output columns per CTA of K5; the width K4 and K5 need
OUT_DTYPES = (torch.bfloat16, torch.float32)
CTAS_PER_SM = 4  # K5: split k until the grid has about this many CTAs an SM

# K4's tile configurations (int8_matmul.cu QCfg), (rows, columns) a CTA
# tile, by the config number the kernel takes: decode rows (the two
# consumer warpgroups split the columns), then prompt rows (they split the
# rows)
K4_TILES = ((64, 256), (128, 128), (128, 256))
# What the plan is costed with, measured on an H100 SXM (PERF.md): the
# time of one k step of a tile when its SM is not held by the copies
# (widening and products), by config; the rate the copies reach, over the
# whole card and for one SM alone; what partials cost (written and read
# once, mostly in L2); the epilogue of a unit; the second launch that
# sums the partials
K4_STEP_SECONDS = (0.9e-6, 0.74e-6, 1.19e-6)
HBM_BYTES_PER_S = 2.4e12
SM_COPY_BYTES_PER_S = 29e9
PARTIAL_BYTES_PER_S = 6e12
UNIT_SECONDS = 0.5e-6
REDUCE_SECONDS = 4e-6


def _lib(int8: bool):
    if int8:
        fn = _build.load("int8_matmul").vgt_int8_matmul
        ints = 7
    else:
        fn = _build.load("quant_matmul").vgt_int4_matmul
        ints = 5
    if fn.argtypes is None:  # declare once: pointers must not be cut to int
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * ints + [
            ctypes.c_void_p,
        ]
    return fn


# K4's split-k partials, one buffer per (device, stream), kept across calls
# (the calls on one stream run in order) and grown when a call needs more
_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}


def _workspace(device: torch.device, stream: int, size: int) -> torch.Tensor:
    key = (device.index or 0, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < size:
        ws = torch.empty(size, dtype=torch.float32, device=device)
        _workspaces[key] = ws
    return ws


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=4096)
def k4_plan(rows: int, in_dim: int, out_dim: int,
            sm_count: int) -> Tuple[int, int, int]:
    """K4's ``(config, splits, grid)``: the tile configuration (an index
    of :data:`K4_TILES`; rows <= 64 take the decode tile), the k split
    (a divisor of the k steps leaving each split at least two; at prompt
    rows only where the tiles alone leave SMs idle) and the persistent
    grid (at most one CTA an SM, at most one a unit), with the least
    modelled time.  A unit is one (row tile, column tile, split); the grid
    walks them in rounds.  A k step of a unit takes the larger of its
    weight bytes at the SM's share of the copy rate and the config's own
    step time; a split adds its fp32 partials and a second launch."""
    steps = in_dim // TILE_IN
    best = None
    for config in ((0,) if rows <= 64 else (1, 2)):
        bm, bn = K4_TILES[config]
        tiles = -(-rows // bm) * -(-out_dim // bn)
        for splits in range(1, steps // 2 + 1):
            # prompt tiles that fill the card keep their k whole
            if steps % splits or (splits > 1 and config and
                                  tiles >= sm_count):
                continue
            units = tiles * splits
            grid = min(units, sm_count)
            rounds = -(-units // grid)
            step_s = max(
                TILE_IN * bn / min(HBM_BYTES_PER_S / grid,
                                   SM_COPY_BYTES_PER_S),
                K4_STEP_SECONDS[config],
            )
            seconds = rounds * (steps // splits * step_s + UNIT_SECONDS)
            if splits > 1:
                seconds += (2 * splits * rows * out_dim * 4
                            / PARTIAL_BYTES_PER_S + REDUCE_SECONDS)
            if best is None or seconds < best[0]:
                best = (seconds, config, splits, grid)
    return best[1], best[2], best[3]


def split_k(rows: int, in_dim: int, out_dim: int, sm_count: int) -> int:
    """K5: how many CTAs share one output tile's k range: the largest divisor
    of the k steps that brings the grid to about ``CTAS_PER_SM`` CTAs an
    SM and leaves each split at least two steps (1 when the tiles alone
    fill the card)."""
    steps = in_dim // TILE_IN
    bm = 32 if rows <= 32 else 64
    tiles = -(-rows // bm) * (out_dim // TILE_OUT)
    want = -(-CTAS_PER_SM * sm_count // tiles)
    best = 1
    for d in range(1, min(want, steps // 2) + 1):
        if steps % d == 0:
            best = d
    return best


def int8_matmul_plain(x, q, scale, out_dtype=None) -> torch.Tensor:
    """K4's semantics: int8 -> f32, f32 product, x scale, cast."""
    out = x.float() @ q.float()
    return (out * scale.float()).to(out_dtype or x.dtype)


def int4_matmul_plain(x, q_packed, scale, out_dtype=None) -> torch.Tensor:
    """K5's semantics: ``packed_einsum(x, w) * scale`` in f32 — each
    nibble plane against its half of ``x`` — then the cast."""
    from vgate_tpu_torch.ops.quant import _nibble_planes

    half = q_packed.shape[0]
    lo, hi = _nibble_planes(q_packed)
    x32 = x.float()
    out = x32[..., :half] @ lo.float() + x32[..., half:] @ hi.float()
    return (out * scale.float()).to(out_dtype or x.dtype)


def _check(x, w, scale, out_dtype, in_dim, int4: bool) -> None:
    name = "K5 (int4)" if int4 else "K4 (int8)"
    for what, t in (("weight", w), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{what} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name} takes bf16 activations, not {x.dtype}")
    want = torch.uint8 if int4 else torch.int8
    if w.dtype != want or w.dim() != 2:
        raise ValueError(f"{name} takes a 2D {want} weight, got "
                         f"{w.dtype} {tuple(w.shape)}")
    out_dim = w.shape[1]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (out_dim,):
        raise ValueError(f"{name} takes an f32 scale [{out_dim}]")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"{name} writes bf16 or f32, not {out_dtype}")
    if in_dim % TILE_IN or out_dim % TILE_OUT:
        raise ValueError(
            f"{name} needs in % {TILE_IN} == 0 and out % {TILE_OUT} == 0, "
            f"got in={in_dim} out={out_dim}"
        )


def _launch(x, w, scale, out_dtype, in_dim, int4: bool) -> torch.Tensor:
    _check(x, w, scale, out_dtype, in_dim, int4)
    out_dim = w.shape[1]
    lead = x.shape[:-1]
    xf = x.reshape(-1, in_dim).contiguous()
    rows = xf.shape[0]
    out = torch.empty((rows, out_dim), dtype=out_dtype, device=x.device)
    sms = _sm_count(x.device.index or 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out_f32 = int(out_dtype == torch.float32)
    if int4:
        splits = split_k(rows, in_dim, out_dim, sms)
        partial = None
        if splits > 1:
            partial = torch.empty((splits, rows, out_dim),
                                  dtype=torch.float32, device=x.device)
        rc = _lib(False)(
            xf.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            rows, in_dim, out_dim, splits, out_f32, stream,
        )
    else:
        if xf.data_ptr() % 16 or w.data_ptr() % 16 or scale.data_ptr() % 16:
            raise ValueError("K4 (int8) needs x, the weight and the scale "
                             "on 16 bytes (TMA, paired loads)")
        config, splits, grid = k4_plan(rows, in_dim, out_dim, sms)
        partial = None
        if splits > 1:
            partial = _workspace(x.device, stream, splits * rows * out_dim)
        rc = _lib(True)(
            xf.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            rows, in_dim, out_dim, config, splits, grid, out_f32, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"dequant-matmul kernel launch failed: cuda error {rc}"
        )
    return out.reshape(*lead, out_dim)


def int8_matmul(
    x: torch.Tensor,  # [..., in] bf16
    q: torch.Tensor,  # [in, out] int8
    scale: torch.Tensor,  # [out] f32
    out_dtype: Optional[torch.dtype] = None,  # default x.dtype
) -> torch.Tensor:
    """``(x @ q) * scale`` cast to ``out_dtype`` (K4)."""
    if x.shape[-1] != q.shape[0]:
        raise ValueError(f"x in-dim {x.shape[-1]} != weight rows {q.shape[0]}")
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = _launch(x, q, scale, out_dtype or x.dtype, q.shape[0], int4=False)
    int8_matmul.launches += 1
    return out


def int4_matmul(
    x: torch.Tensor,  # [..., in] bf16
    q_packed: torch.Tensor,  # [in/2, out] uint8, half-split nibbles
    scale: torch.Tensor,  # [out] f32
    out_dtype: Optional[torch.dtype] = None,  # default x.dtype
) -> torch.Tensor:
    """``(x @ unpack(q_packed)) * scale`` cast to ``out_dtype`` (K5)."""
    if x.shape[-1] != 2 * q_packed.shape[0]:
        raise ValueError(
            f"x in-dim {x.shape[-1]} != 2 * packed rows {q_packed.shape[0]}"
        )
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q_packed, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = _launch(x, q_packed, scale, out_dtype or x.dtype, x.shape[-1],
                  int4=True)
    int4_matmul.launches += 1
    return out


int8_matmul.launches = 0
int4_matmul.launches = 0
