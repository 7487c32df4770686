"""Weight-only int8 / int4 quantization (the port of vgate_tpu/ops/quant.py).

Symmetric per-output-channel narrow ints: a weight stores as
``QTensor(q=int8, scale=f32[out])`` or, for int4, as
``PackedQTensor(q_packed=uint8, scale=f32[out])`` with two values a byte
along the contracted dim.  Every decoder weight keeps its output dim
LAST (``[in, out]``, stacked ``[L, in, out]``), so one rule covers
q/k/v/o/gate/up/down and the lm_head.  The quantizers are bit-identical
to the reference's (f32 absmax, ``max(absmax, 1e-8) / qmax``, round half
to even, clip).

MoE expert weights ``[L, E, in, out]`` quantize per (layer, expert, out
channel) (:func:`quantize_expert_stacked`); the router stays as it is.

On the card every quantized contraction of the decoder runs the
hand-written dequant-matmul kernels (ops/kernels/quant_matmul.py: K4 for
int8, K5 for int4) on a 2D ``[in, out]`` weight; expert weights run them
one expert at a time (models/decoder.py ``_expert_einsum``).  Any other
quantized contraction raises there.  The reference turns its kernels off
by default (``tpu.quant_kernel``) only because of a compile hang of its
TPU toolchain, which has no counterpart here, so the port has no such
switch.

W8A8 / W4A8 (``int8_native``, :func:`int8_native_einsum`): the
activations are quantized per token to int8 and contracted against the
int8 weight (or each int4 nibble plane, sign-extended to int8) with an
exact int32 accumulation, then scaled.  The reference's are plain jnp
outside any Pallas kernel; here the int32 product is ``torch._int_mm``
on the card and an int32 matmul on the CPU, the same exact sums.
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


def shard_int4_rows(p: torch.Tensor, index: int, parts: int) -> torch.Tensor:
    """Part ``index`` of ``parts`` of a half-split packed weight's input
    rows, packed again: logical rows ``[index*in/parts, (index+1)*in/
    parts)`` of ``p`` (uint8 ``[..., in/2, out]``) as their own
    half-split ``[..., in/(2*parts), out]``.  In the half-split layout a
    slice of the input rows lies in both nibble planes, so a row-parallel
    shard is unpacked, sliced and repacked; exact."""
    q = unpack_int4(p)
    rows = q.shape[-2]
    if rows % (2 * parts):
        raise ValueError(
            f"in-dim {rows} does not split into {parts} even parts"
        )
    part = rows // parts
    return pack_int4(q.narrow(-2, index * part, part))


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


def _true_div(t: torch.Tensor, divisor: float) -> torch.Tensor:
    """``t / divisor`` correctly rounded, as the reference divides.  A
    Python or CPU scalar divisor makes CUDA multiply by its reciprocal,
    which can land one ulp away; a divisor tensor on ``t``'s device is
    divided elementwise."""
    return t / torch.full_like(t, divisor)


def _quantize(w: torch.Tensor, reduce_dims, bits: int):
    """(q int8, scale f32) with the absmax over ``reduce_dims``."""
    qmax = _QMAX[bits]
    w32 = w.float()
    absmax = w32.abs().amax(dim=reduce_dims)
    scale = _true_div(torch.clamp(absmax, min=1e-8), qmax)
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
    return stack_layers(lambda l: quantize_layer(w[l], bits, False),
                        w.shape[0])


def quantize_expert_stacked(w: torch.Tensor, bits: int = 8) -> Weight:
    """Quantize stacked MoE expert weights [L, E, in, out] per (layer,
    expert, out channel), reducing only the contracted ``in`` dim, one
    layer at a time."""
    return stack_layers(lambda l: quantize_layer(w[l], bits, True),
                        w.shape[0])


def quantize_layer(w: torch.Tensor, bits: int, expert: bool) -> Weight:
    """One layer's slice of a stacked weight quantized as its stack
    would be: a dense ``[..., out]`` per channel, an expert ``[E, in,
    out]`` per (expert, channel)."""
    reduce_dims = (-2,) if expert else tuple(range(w.ndim - 1))
    return _finish(*_quantize(w, reduce_dims, bits), bits)


def stack_layers(layer, num_layers: int, kept: Optional[range] = None
                 ) -> Weight:
    """A stacked ``[L, ...]`` weight built from ``layer(l)``, one layer
    at a time, into a preallocated stack.  A ``layer`` may return a
    quantized weight (a layer quantized as soon as it exists, so neither
    the full-precision stack nor more than one full-precision layer ever
    exists) or a mesh rank's shard of the layer.  With ``kept`` (a
    pipeline stage's layers) ``layer`` is still called for every layer,
    in order (a random init draws each), and only ``kept``'s are
    stacked."""
    kept = range(num_layers) if kept is None else kept
    stacks, kind = None, None
    for l in range(num_layers):
        w = layer(l)
        if l not in kept:
            del w
            continue
        kind = type(w) if is_quantized_weight(w) else None
        part = tuple(w) if kind is not None else (w,)
        del w
        if stacks is None:
            stacks = [torch.empty((len(kept), *p.shape), dtype=p.dtype,
                                  device=p.device) for p in part]
        for stack, p in zip(stacks, part):
            stack[l - kept.start] = p
        del part
    return stacks[0] if kind is None else kind(*stacks)


# the projections ``model.quantization`` quantizes in every layer (and the
# lm_head); a MoE model's gate, up and down are its experts
PROJECTIONS = ("q", "k", "v", "o", "gate", "up", "down")
EXPERT_PROJECTIONS = ("gate", "up", "down")


def quantize_leaf(path, leaf, spec, bits: int, lead: int = 1):
    """The leaf at ``path`` of a decoder tree as ``model.quantization``
    stores it: the projections per (layer, out channel), a MoE model's
    experts per (layer, expert, out channel), the lm_head per channel;
    any other leaf (the embedding, norms, biases, the router), and a
    leaf quantized already, as it is.  ``lead`` 0: one layer of a
    stacked leaf."""
    path = tuple(path)
    if is_quantized_weight(leaf):
        return leaf
    if path == ("lm_head",):
        return quantize_tensor(leaf, bits)
    if not (len(path) == 3 and path[0] == "layers"
            and path[1] in PROJECTIONS and path[2] == "w"):
        return leaf
    expert = spec.is_moe and path[1] in EXPERT_PROJECTIONS
    if lead == 0:
        return quantize_layer(leaf, bits, expert)
    return stack_layers(lambda l: quantize_layer(leaf[l], bits, expert),
                        leaf.shape[0])


def _quantize_activations(x: torch.Tensor):
    """Dynamic symmetric per-token int8 quantization of activations:
    per-row absmax over the contracted (last) axis, round half to even.
    Returns ``(x_q int8, x_scale f32[..., 1])``."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    x_scale = _true_div(torch.clamp(absmax, min=1e-8), 127.0)
    x_q = torch.clamp(torch.round(x32 / x_scale), -127, 127).to(torch.int8)
    return x_q, x_scale


# torch._int_mm (cuBLASLt int8 x int8 -> int32) takes more than this many
# rows, and inner and outer sizes that are multiples of 8
_INT_MM_MIN_ROWS = 16
_INT_MM_PAD_ROWS = 32


def int8_mm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 product ``x_q [..., in] @ w_q [in, out]`` of two
    int8 operands.  On the card ``torch._int_mm``, the rows padded with
    zeros past 16 (a decode step, an expert's capacity), the weight
    row-major or in :func:`k_major` layout; sizes it cannot take raise.
    On the CPU an int32 matmul."""
    lead, in_dim = x_q.shape[:-1], x_q.shape[-1]
    out_dim = w_q.shape[-1]
    flat = x_q.reshape(-1, in_dim)
    if x_q.device.type == "cpu":
        out = flat.to(torch.int32) @ w_q.to(torch.int32)
        return out.reshape(*lead, out_dim)
    if in_dim % 8 or out_dim % 8:
        raise ValueError(
            f"the int8 product needs in % 8 == 0 and out % 8 == 0, got "
            f"in={in_dim} out={out_dim}"
        )
    rows = flat.shape[0]
    if rows <= _INT_MM_MIN_ROWS:
        padded = flat.new_zeros((_INT_MM_PAD_ROWS, in_dim))
        padded[:rows] = flat
        flat = padded
    if 1 not in w_q.stride():
        w_q = w_q.contiguous()
    out = torch._int_mm(flat.contiguous(), w_q)
    return out[:rows].reshape(*lead, out_dim)


def k_major(w: Weight) -> Weight:
    """``w`` with its narrow ints stored contracted dim (``in``)
    contiguous: the same ``[..., in, out]`` values, as the transposed
    view of an ``[..., out, in]`` buffer.  W8A8's int8 product takes
    this layout at full rate on the card (cuBLASLt's int8 tensor-core
    path reads both operands along the contracted dim; on the row-major
    ``[in, out]`` weight it ran 4-13x slower at Mixtral's expert shapes,
    PERF.md).  K4/K5 take only the row-major layout, so an engine lays
    out only the weights W8A8 reads (:func:`int8_native_layout`)."""
    vals = w[0]
    if vals.stride(-2) == 1:
        return w
    return type(w)(vals.transpose(-1, -2).contiguous().transpose(-1, -2),
                   w.scale)


def int8_native_layout(params: Any) -> Any:
    """The projections W8A8 reads (q/k/v/o/gate/up/down; the lm_head
    stays on K4/K5) in :func:`k_major` layout, IN PLACE, one leaf at a
    time; a leaf in that layout already is kept.  This consumes the
    tree: K4/K5 refuse the layout, so it serves no dequant-matmul engine
    afterwards (an engine that needs both builds the dequant one first
    and stops it before handing the tree on)."""
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        entry = params["layers"][name]
        entry["w"] = k_major(entry["w"])
    return params


def int8_products(subscripts: str, x_q: torch.Tensor,
                  w: Weight) -> torch.Tensor:
    """The exact int32 contraction of int8 activations ``x_q`` with the
    narrow ints of ``w``: one product for a ``QTensor``, and for a
    ``PackedQTensor`` (W4A8) each sign-extended nibble plane against its
    half of the activations, summed.  A 2D weight in ``[..., in] @ [in,
    out]`` form runs :func:`int8_mm`; other contractions (the
    reference's batched expert einsum) run an int32 einsum on the CPU
    and raise on the card, where experts go one at a time."""
    planes = (_nibble_planes(w.q_packed) if isinstance(w, PackedQTensor)
              else (w.q,))
    half = x_q.shape[-1] // len(planes)
    if _use_quant_kernel(subscripts, w):
        def product(xp, wp):
            return int8_mm(xp, wp)
    elif x_q.device.type == "cpu":
        def product(xp, wp):
            return torch.einsum(subscripts, xp.to(torch.int32),
                                wp.to(torch.int32))
    else:
        raise ValueError(
            f"W8A8 contraction {subscripts!r} has no card route: it takes "
            "a 2D [in, out] weight in [..., in] @ [in, out]"
        )
    acc = product(x_q[..., :half], planes[0])
    if len(planes) == 2:
        acc = acc + product(x_q[..., half:], planes[1])
    return acc


def int8_native_partial(
    subscripts: str, x: torch.Tensor, w: Weight
) -> torch.Tensor:
    """W8A8 contraction WITHOUT the weight scale: per-token int8
    activations contracted against the int8 weight with an exact int32
    accumulation (:func:`int8_products`), returned as ``acc * x_scale``
    in f32.  The caller applies ``w.scale`` (dense ``[out]``, expert
    ``[E, out]``)."""
    x_q, x_scale = _quantize_activations(x)
    return int8_products(subscripts, x_q, w).float() * x_scale


def int8_native_experts(subscripts: str, x: torch.Tensor,
                        w: Weight) -> torch.Tensor:
    """Expert W8A8/W4A8 over ``x [E, C, in]`` and quantized expert
    weights ``[E, in, out]``, one expert at a time (``subscripts`` is
    one expert's ``[..., in] @ [in, out]`` form): the activations
    quantized per (expert, token row) once for all experts, each
    expert's exact int32 product, then ``acc * x_scale * scale[e]`` and
    the cast to ``x``'s dtype, as the reference's expert branch
    (``int8_native_partial`` times the ``[E, out]`` scale)."""
    x_q, x_scale = _quantize_activations(x)
    acc = torch.stack([
        int8_products(subscripts, x_q[e], type(w)(*(p[e] for p in w)))
        for e in range(x.shape[0])
    ])
    return (acc.float() * x_scale * w.scale[:, None, :]).to(x.dtype)


def int8_native_einsum(
    subscripts: str, x: torch.Tensor, w: Weight, out_dtype: torch.dtype,
) -> torch.Tensor:
    """Dense-weight W8A8/W4A8: :func:`int8_native_partial` with the
    per-output-channel scale applied, then the cast."""
    out = int8_native_partial(subscripts, x, w) * w.scale
    return out.to(out_dtype)


def weighted_einsum(
    subscripts: str, x: torch.Tensor, w: Weight,
    preferred_element_type: Optional[torch.dtype] = None,
    int8_native: bool = False,
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
    * With ``int8_native`` (W8A8/W4A8) such a weight takes
      :func:`int8_native_einsum` instead, before K4/K5, as in the
      reference.
    * Any other quantized contraction raises on the card; on the CPU it
      takes the reference's plain branches (the narrow ints cast to the
      activation dtype, the scale multiplied into the output)."""
    out_dtype = preferred_element_type or x.dtype
    if (int8_native and is_quantized_weight(w)
            and _use_quant_kernel(subscripts, w)):
        return int8_native_einsum(subscripts, x, w, out_dtype)
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
    lm_head quantized (:func:`quantize_leaf`); the embedding, norms and
    a MoE model's router stay as they are.  The dict is updated IN
    PLACE, one leaf at a time, each full-precision leaf replaced (and so
    freed) as soon as its quantized version exists, so the
    full-precision and the quantized trees never both sit whole in
    device memory."""
    if bits not in _QMAX:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    for name in PROJECTIONS:
        entry = params["layers"][name]
        entry["w"] = quantize_leaf(("layers", name, "w"), entry["w"], spec,
                                   bits)
    if "lm_head" in params:
        params["lm_head"] = quantize_leaf(("lm_head",), params["lm_head"],
                                          spec, bits)
    return params
