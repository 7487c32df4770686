"""Weight-only int8 / int4 quantization (the port of vgate_tpu/ops/quant.py).

Symmetric per-output-channel narrow ints: a weight stores as
``QTensor(q=int8, scale=f32[out])`` or, for int4, as
``PackedQTensor(q_packed=uint8, scale=f32[out])`` with two values a byte
along the contracted dim.  Every decoder weight keeps its output dim
LAST (``[in, out]``, stacked ``[L, in, out]``), so one rule covers
q/k/v/o/gate/up/down and the lm_head.  The quantizers are bit-identical
to the reference's (f32 absmax, ``max(absmax, 1e-8) / qmax``, round half
to even, clip).

On the card every quantized contraction of the decoder runs the
hand-written dequant-matmul kernels (ops/kernels/quant_matmul.py: K4 for
int8, K5 for int4); a contraction they cannot take raises there.  The
reference turns its kernels off by default (``tpu.quant_kernel``) only
because of a compile hang of its TPU toolchain, which has no counterpart
here, so the port has no such switch.  W8A8 (``int8_native``) and MoE
expert quantization are not ported.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Union

import torch

from vgate_tpu_torch.ops.kernels import quant_matmul


class QTensor(NamedTuple):
    """int8 values + per-output-channel f32 scale (output dim is last)."""

    q: torch.Tensor  # int8, the original weight's shape
    scale: torch.Tensor  # f32 [out] (stacked: [L, out])


class PackedQTensor(NamedTuple):
    """int4 weights two a byte (uint8) along the contracted dim, in the
    reference's **half-split** layout: byte ``p[..., i, o]`` holds
    ``w[..., i, o]`` in its low nibble and ``w[..., i + in/2, o]`` in its
    high nibble, two's complement, so each nibble plane contracts the
    matching half of the activations directly."""

    q_packed: torch.Tensor  # uint8 [..., in/2, out]
    scale: torch.Tensor  # f32 [..., out]


Weight = Union[torch.Tensor, QTensor, PackedQTensor]

_QMAX = {8: 127, 4: 7}
BITS = {"int8": 8, "int4": 4}


def is_quantized_weight(w) -> bool:
    return isinstance(w, (QTensor, PackedQTensor))


def _matmul_form(subscripts: str) -> bool:
    """A plain ``[..., in] @ [in, out]`` contraction (``"...d,dh->...h"``
    and the like)."""
    ins, out = subscripts.replace(" ", "").split("->")
    a, b = ins.split(",")
    if not (a.startswith("...") and len(a) == 4 and len(b) == 2):
        return False
    return a[3] == b[0] and out == "..." + b[1]


def _use_quant_kernel(subscripts: str, w: Weight) -> bool:
    """Shape eligibility for the dequant-matmul kernels: a 2D weight in
    a plain ``[..., in] @ [in, out]`` contraction."""
    vals = w.q_packed if isinstance(w, PackedQTensor) else w.q
    return vals.ndim == 2 and _matmul_form(subscripts)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-7, 7], shape [..., in, out] -> uint8
    [..., in/2, out] (low nibbles: first half of ``in``; high: second)."""
    if q.shape[-2] % 2:
        raise ValueError(f"in-dim {q.shape[-2]} must be even to pack int4")
    half = q.shape[-2] // 2
    lo = q[..., :half, :].view(torch.uint8) & 0x0F
    hi = q[..., half:, :].view(torch.uint8) & 0x0F
    return lo | (hi << 4)


def _sext4(nibble: torch.Tensor) -> torch.Tensor:
    """two's-complement 4-bit -> int8."""
    return (nibble.to(torch.int8) ^ 8) - 8


def _nibble_planes(p: torch.Tensor):
    """Half-split packed bytes -> sign-extended int8 ``(lo, hi)`` planes."""
    return _sext4(p & 0x0F), _sext4(p >> 4)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """uint8 [..., in/2, out] -> sign-extended int8 [..., in, out]."""
    lo, hi = _nibble_planes(p)
    return torch.cat([lo, hi], dim=-2)


def packed_einsum(
    subscripts: str, x: torch.Tensor, w: PackedQTensor,
    preferred_element_type: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """einsum against packed int4, one nibble plane per activation half;
    the output scale is NOT applied (the caller broadcasts ``w.scale``).
    ``preferred_element_type`` f32 accumulates and returns f32."""
    half = w.q_packed.shape[-2]
    lo, hi = _nibble_planes(w.q_packed)
    dtype = preferred_element_type or x.dtype
    xd = x.to(dtype)
    return torch.einsum(subscripts, xd[..., :half], lo.to(dtype)) + (
        torch.einsum(subscripts, xd[..., half:], hi.to(dtype))
    )


def _quantize(w: torch.Tensor, reduce_dims, bits: int):
    """(q int8, scale f32) with the absmax over ``reduce_dims``."""
    qmax = _QMAX[bits]
    w32 = w.float()
    absmax = w32.abs().amax(dim=reduce_dims)
    scale = torch.clamp(absmax, min=1e-8) / qmax
    view = list(scale.shape)
    for d in sorted(d % w.ndim for d in reduce_dims):
        view.insert(d, 1)
    q = torch.clamp(
        torch.round(w32 / scale.reshape(view)), -qmax, qmax
    ).to(torch.int8)
    return q, scale


def _finish(q: torch.Tensor, scale: torch.Tensor, bits: int) -> Weight:
    if bits == 4:
        return PackedQTensor(q_packed=pack_int4(q), scale=scale)
    return QTensor(q=q, scale=scale)


def quantize_tensor(w: torch.Tensor, bits: int = 8) -> Weight:
    """Symmetric per-channel int8/int4 over the last (output) dim."""
    q, scale = _quantize(w, tuple(range(w.ndim - 1)), bits)
    return _finish(q, scale, bits)


def quantize_stacked(w: torch.Tensor, bits: int = 8) -> Weight:
    """Quantize a stacked-layer weight [L, ..., out] per (layer, channel),
    one layer at a time, so the f32 temporaries are one layer's."""
    reduce_dims = tuple(range(w.ndim - 2))  # of one layer's [..., out]
    parts = [_quantize(w[l], reduce_dims, bits) for l in range(w.shape[0])]
    q = torch.stack([p[0] for p in parts])
    scale = torch.stack([p[1] for p in parts])
    return _finish(q, scale, bits)


def weighted_einsum(
    subscripts: str, x: torch.Tensor, w: Weight,
    preferred_element_type: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """einsum that accepts plain or quantized weights.

    * A plain weight in ``[..., in] @ [in, out]`` form is ``x @ w``; with
      ``preferred_element_type`` f32 the product returns the f32
      accumulation, never rounded to the model dtype (on the card one
      cuBLAS call takes bf16 in and writes fp32 out).
    * A quantized 2D weight in that form runs K4 (int8) or K5 (int4)
      through its wrapper: the kernel on the card, its plain version on
      the CPU.  The scale multiplies in f32 before the cast to the
      output dtype.
    * Any other quantized contraction raises on the card; on the CPU it
      takes the reference's plain branches (the narrow ints cast to the
      activation dtype, the scale multiplied into the output)."""
    out_dtype = preferred_element_type or x.dtype
    if not is_quantized_weight(w):
        if not (w.dim() == 2 and _matmul_form(subscripts)):
            return torch.einsum(subscripts, x.to(out_dtype), w.to(out_dtype))
        if out_dtype == x.dtype:
            return x @ w
        if x.device.type == "cuda":
            flat = x.reshape(-1, x.shape[-1])
            out = torch.mm(flat, w, out_dtype=out_dtype)
            return out.reshape(*x.shape[:-1], w.shape[-1])
        return x.to(out_dtype) @ w.to(out_dtype)
    if _use_quant_kernel(subscripts, w):
        if isinstance(w, PackedQTensor):
            return quant_matmul.int4_matmul(
                x, w.q_packed, w.scale, out_dtype=out_dtype
            )
        return quant_matmul.int8_matmul(x, w.q, w.scale, out_dtype=out_dtype)
    if x.device.type != "cpu":
        raise ValueError(
            f"quantized contraction {subscripts!r} has no kernel: K4/K5 "
            "take a 2D [in, out] weight in [..., in] @ [in, out]"
        )
    if isinstance(w, PackedQTensor):
        out = packed_einsum(
            subscripts, x, w, preferred_element_type=preferred_element_type
        )
        return out * w.scale.to(out_dtype)
    out = torch.einsum(subscripts, x.to(out_dtype), w.q.to(out_dtype))
    return out * w.scale.to(out_dtype)


def quantize_decoder_params(params: Any, spec, bits: int = 8) -> Any:
    """The parameter dict with its seven projection weights and the
    lm_head quantized; the embedding and norms stay as they are.  Dense
    family only.  The dict is updated IN PLACE, one leaf at a time, each
    full-precision leaf replaced (and so freed) as soon as its quantized
    version exists, so the full-precision and the quantized trees never
    both sit whole in device memory."""
    if spec.is_moe:
        raise NotImplementedError(
            "MoE expert quantization is not ported yet (ROADMAP queue 1, "
            "item 9)"
        )
    if bits not in _QMAX:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        entry = params["layers"][name]
        entry["w"] = quantize_stacked(entry["w"], bits)
    if "lm_head" in params:
        params["lm_head"] = quantize_tensor(params["lm_head"], bits)
    return params
