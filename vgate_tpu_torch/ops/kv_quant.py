"""KV page pools: plain bf16/f32 pools and int8 ``QuantPages`` pools.

The port of vgate_tpu/ops/kv_quant.py.  With ``kv_cache.dtype: int8`` a
pool stores int8 K/V plus one bf16 scale per (layer, kv head, page,
slot): every KV write quantizes (:func:`kv_write`), every read
dequantizes — inside the int8 modes of the attention kernels (K1, K3),
which fold the scales into the score row and the softmax weights, and
in :func:`gather_pages` for their plain versions.  Per-token-per-head
scales make quantization path-independent: a token quantizes the same
whether a prompt pass, a copy-on-write scatter or a decode step writes
it, so shared pages never need rescaling.

Unlike the reference, which returns updated copies that XLA aliases onto
donated buffers, every write here is IN PLACE, and indexing a
``QuantPages`` by layer returns views of both tensors, so a write
through ``k_pages[l]`` lands in the engine's pool.
"""

from __future__ import annotations

from typing import Union

import torch

# bf16's ~0.4% relative step is far below int8's ~0.8%-of-absmax step,
# and halves scale bytes vs f32
SCALE_DTYPE = torch.bfloat16
# symmetric int8: +-127 (not -128, so dequant is sign-symmetric)
QMAX = 127.0
# bytes one token-slot of one kv head spends on its scale
SCALE_BYTES = 2


class QuantPages:
    """An int8 KV page pool and its per-(page, head, slot) scale pool.

    ``data``: int8 ``[(L,) KV, P, ps, hd]``; ``scale``: bf16 with the
    same shape minus the trailing ``hd``.  ``shape``/``dtype``/``ndim``
    mirror the data pool so geometry probes (``k_pages.shape[3]``) work
    unchanged; ``pool[l]`` is layer ``l``'s pool as views of both."""

    __slots__ = ("data", "scale")
    # the handoff codec (runtime/handoff.py) ships and rebuilds a pool by
    # these fields, as the reference's NamedTuple
    _fields = ("data", "scale")

    def __init__(self, data: torch.Tensor, scale: torch.Tensor) -> None:
        if data.dtype != torch.int8 or scale.dtype != SCALE_DTYPE:
            raise ValueError(
                f"QuantPages takes int8 data and bf16 scales, got "
                f"{data.dtype} and {scale.dtype}"
            )
        if tuple(scale.shape) != tuple(data.shape[:-1]):
            raise ValueError(
                f"scale shape {tuple(scale.shape)} must be the data shape "
                f"{tuple(data.shape)} minus head_dim"
            )
        self.data = data
        self.scale = scale

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def ndim(self):
        return self.data.ndim

    def __getitem__(self, idx) -> "QuantPages":
        return QuantPages(self.data[idx], self.scale[idx])


KVPool = Union[torch.Tensor, QuantPages]


def is_quantized(pool) -> bool:
    return isinstance(pool, QuantPages)


def dtype_short_name(dtype: torch.dtype) -> str:
    """Reporting name of a pool dtype for stats (``bf16``, ``f32``...)."""
    return {
        torch.bfloat16: "bf16", torch.float32: "f32",
        torch.float16: "f16", torch.int8: "int8",
    }[dtype]


def quantize(x: torch.Tensor):
    """Symmetric per-token-per-head int8 over the trailing head_dim:
    ``(q int8 [..., hd], s bf16 [...])``, bit for bit the reference's.

    The scale is computed in f32, STORED as bf16, and the quantization
    divides by the stored scale, so ``q * s`` reconstructs against what
    the reader sees.  All-zero rows get scale 1 (dequant stays 0)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    s = torch.where(
        amax > 0, amax / QMAX, torch.ones_like(amax)
    ).to(SCALE_DTYPE)
    q = torch.clamp(
        torch.round(x32 / s.float()[..., None]), -QMAX, QMAX
    ).to(torch.int8)
    return q, s


def dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """f32 reconstruction; ``s`` broadcasts over the trailing head_dim."""
    return q.float() * s.float()[..., None]


def kv_write(pool: KVPool, idx: tuple, value: torch.Tensor) -> None:
    """``pool[idx] = value`` IN PLACE, quantizing on write for int8 pools.

    ``idx`` indexes every pool dim except the trailing head_dim (the
    value carries it) and mixes slices and index tensors, the page ids
    second (``idx[1]``, with the value's dims after the first following
    its shape); the scale pool takes the identical index.  Duplicate
    indices are allowed only where they all target trash page 0 (an
    inactive decode slot, a padding row or page), and every write there
    is zeros: on the card the winner of duplicate writes is not fixed,
    and a decode slot that never served reads page 0, so a mesh's ranks
    (or two runs) would otherwise read different trash and compute
    different inactive rows, which a MoE layer's capacity counts.  No
    live row reads page 0."""
    pages = idx[1] if len(idx) > 1 else None
    if torch.is_tensor(pages):
        keep = pages != 0
        keep = keep.reshape(1, *keep.shape,
                            *([1] * (value.dim() - 1 - keep.dim())))
        value = value.masked_fill(~keep, 0)
    if is_quantized(pool):
        q, s = quantize(value)
        pool.data[idx] = q
        pool.scale[idx] = s
        return
    pool[idx] = value.to(pool.dtype)


def gather_pages(pool: KVPool, page_tables: torch.Tensor, layer=None):
    """Gather each slot's page window: ``[KV, B, n_pages, ps, hd]``, the
    raw dtype for plain pools and dequantized f32 for int8 pools.  With
    ``layer`` the pool carries a leading [L] dim."""
    if layer is not None:
        pool = pool[layer]
    if is_quantized(pool):
        return dequantize(
            pool.data[:, page_tables], pool.scale[:, page_tables]
        )
    return pool[:, page_tables]


def copy_page_prefix(pool: KVPool, src: int, dst: int, upto: int) -> None:
    """Copy-on-write page copy IN PLACE: the first ``upto`` token slots
    of page ``src`` overwrite those of page ``dst`` in every layer and
    head of ``pool`` ([..., P, ps, hd]); the rest of ``dst`` is kept.
    For int8 pools the scales copy with the data, so a copied head
    dequantizes bit-identically to the page it came from.  The reference
    takes a [ps] keep mask and returns an updated copy; a prefix of
    ``upto`` slots is the only mask its engine builds."""
    if is_quantized(pool):
        pool.data[..., dst, :upto, :] = pool.data[..., src, :upto, :]
        pool.scale[..., dst, :upto] = pool.scale[..., src, :upto]
        return
    pool[..., dst, :upto, :] = pool[..., src, :upto, :]
