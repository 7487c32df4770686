"""KV page-pool writes and gathers (plain bf16/f32 pools).

The reference's int8 ``QuantPages`` pools (quantize-on-write,
dequantize-on-read) are not ported yet; the config rejects
``kv_cache.dtype: int8``.
"""

from __future__ import annotations

import torch


def kv_write(pool: torch.Tensor, idx: tuple, value: torch.Tensor) -> None:
    """``pool[idx] = value`` IN PLACE — an ``index_put_`` where ``idx``
    mixes slices and index tensors (the reference returns an updated
    copy that XLA aliases onto the donated buffer).  Duplicate indices
    are allowed only where they all target trash page 0, whose content
    is never read, so which duplicate wins does not matter."""
    pool[idx] = value


def gather_pages(pool: torch.Tensor, page_tables: torch.Tensor, layer=None):
    """Gather each slot's page window: ``[KV, B, n_pages, ps, hd]``.
    With ``layer`` the pool carries a leading [L] dim."""
    if layer is not None:
        pool = pool[layer]
    return pool[:, page_tables]


def copy_page_prefix(
    pool: torch.Tensor, src: int, dst: int, upto: int
) -> None:
    """Copy-on-write page copy IN PLACE: the first ``upto`` token slots
    of page ``src`` overwrite those of page ``dst`` in every layer and
    head of ``pool`` ([..., P, ps, hd]); the rest of ``dst`` is kept.
    The reference (vgate_tpu/ops/kv_quant.py ``copy_page_prefix``)
    takes a [ps] keep mask and returns an updated copy; a prefix of
    ``upto`` slots is the only mask its engine builds."""
    pool[..., dst, :upto, :] = pool[..., src, :upto, :]
