"""Wrappers of the dequant-matmul CUDA kernels (csrc/dequant_matmul.cu:
K4 on int8 weights, K5 on packed int4, one Hopper pipeline).

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
from typing import Optional, Tuple

import torch

from vgate_tpu_torch.ops.kernels import _build

TILE_IN = 64  # the kernels' k step (unpacked values)
TILE_OUT = 64  # the output width the kernels need a multiple of
OUT_DTYPES = (torch.bfloat16, torch.float32)

# The tile configurations of K4 and K5 (dequant_matmul.cu QCfg), (rows,
# columns) a CTA tile, by the config number the kernel takes: decode rows
# (the two consumer warpgroups split the columns), then prompt rows (they
# split the rows)
K4_TILES = ((64, 256), (128, 128), (128, 256))
# What the plans are costed with, measured on an H100 SXM (PERF.md): the
# time of one k step of a tile when its SM is not held by the copies
# (widening and products), by config, for K4 and for K5 (config 1 of K5
# scaled from K4's, the smoke never picks it on 132 SMs); the rate the
# copies reach, over the whole card and for one SM alone; what partials
# cost (written and read once, mostly in L2); the epilogue of a unit; the
# second launch that sums the partials
K4_STEP_SECONDS = (0.9e-6, 0.74e-6, 1.19e-6)
K5_STEP_SECONDS = (0.92e-6, 0.69e-6, 1.11e-6)
HBM_BYTES_PER_S = 2.4e12
SM_COPY_BYTES_PER_S = 29e9
PARTIAL_BYTES_PER_S = 6e12
UNIT_SECONDS = 0.5e-6
REDUCE_SECONDS = 4e-6


def _lib():
    fn = _build.load("dequant_matmul").vgt_dequant_matmul
    if fn.argtypes is None:  # declare once: pointers must not be cut to int
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p,
        ]
    return fn


def _plan(step_seconds, weight_bytes: float, rows: int, in_dim: int,
          out_dim: int, sm_count: int) -> Tuple[int, int, int]:
    """The ``(config, splits, grid)`` of a dequant matmul whose weight
    takes ``weight_bytes`` a value, with the least modelled time (see
    :func:`k4_plan`)."""
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
                TILE_IN * bn * weight_bytes / min(HBM_BYTES_PER_S / grid,
                                                  SM_COPY_BYTES_PER_S),
                step_seconds[config],
            )
            seconds = rounds * (steps // splits * step_s + UNIT_SECONDS)
            if splits > 1:
                seconds += (2 * splits * rows * out_dim * 4
                            / PARTIAL_BYTES_PER_S + REDUCE_SECONDS)
            if best is None or seconds < best[0]:
                best = (seconds, config, splits, grid)
    return best[1], best[2], best[3]


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
    return _plan(K4_STEP_SECONDS, 1.0, rows, in_dim, out_dim, sm_count)


@functools.lru_cache(maxsize=4096)
def k5_plan(rows: int, in_dim: int, out_dim: int,
            sm_count: int) -> Tuple[int, int, int]:
    """K5's ``(config, splits, grid)``: :func:`k4_plan`'s model with half
    a byte of weight a value and K5's own step times.  K5's k step is
    K4's 64 values (32 packed rows), so its splits divide the same
    ``in / 64`` steps."""
    return _plan(K5_STEP_SECONDS, 0.5, rows, in_dim, out_dim, sm_count)


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
    if xf.data_ptr() % 16 or w.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError(f"{'K5 (int4)' if int4 else 'K4 (int8)'} needs x, "
                         "the weight and the scale on 16 bytes (TMA, paired "
                         "loads)")
    sms = _build.sm_count(x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    plan = k5_plan if int4 else k4_plan
    config, splits, grid = plan(rows, in_dim, out_dim, sms)
    partial = None
    if splits > 1:
        partial = _build.workspace(x.device, stream, splits * rows * out_dim)
    rc = _lib()(
        xf.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        rows, in_dim, out_dim, 4 if int4 else 8, config, splits, grid,
        int(out_dtype == torch.float32), stream,
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
    _build.count_launch(int8_matmul)
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
    _build.count_launch(int4_matmul)
    return out


int8_matmul.launches = 0
int4_matmul.launches = 0
