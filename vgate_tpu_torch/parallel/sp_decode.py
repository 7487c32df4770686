"""Sequence-parallel attention over a KV page pool sharded over ``sp``.

The port of vgate_tpu/parallel/sp_decode.py.  The pool's page axis
shards contiguously over the sp ranks: rank i holds global pages ``[i *
P/sp, (i+1) * P/sp)`` as its local pool ``[L, KV, P/sp, ps, hd]``
(runtime/kv_cache.py ``KVGeometry.shards``), so the KV capacity of the
group grows with sp.  The global pages ``{i * P/sp}`` (runtime/
kv_cache.py ``reserved_page_ids``) are never handed out
(``PageAllocator(num_shards=sp)``): each is a rank's local page 0, its
trash page.

Each layer's attention then runs per rank:

* the KV write lands on the rank that owns the page; every other write,
  on every rank, goes to its local page 0, which stays zeros
  (ops/kv_quant.py ``kv_write``);
* the rank computes the flash partials ``(acc, m, l)`` of its rows over
  the pages it owns, through the partial modes of the port's kernels:
  K1-sp for a decode step (ops/kernels/paged_decode.py
  ``paged_decode_partial``), K3-sp for a suffix, chunk or verify pass
  (ops/kernels/paged_multitok.py ``paged_multitok_partial``), their plain
  versions on the CPU;
* one all-gather of the partials over sp, then a local log-sum-exp merge
  in rank order (ops/attention.py ``merge_partials``), so every rank
  holds the same attention output.  The reference makes two collectives
  (``pmax`` of m, then ``psum`` of the rescaled acc and l); the merged
  function is the same.

Decode and suffix rows are replicated over sp: every rank runs every
row's projections and MLP (models/decoder.py), and only attention is
partial, as in the reference.  Int8 pools are refused under sp (the
reference's ``ValueError``, parallel/sharding.py ``check_mesh_config``).

An sp rank that is itself a tp group holds its tp rank's heads of every
row and of its pool shard, ``[L, KV/tp, P/sp, ps, hd]``: the partials
run on its ``H/tp`` query heads and merge within its sp group (the tp
ranks at its tp index), as the reference's shard bodies run per (sp,
tp) shard on local heads (``_tp_axis``) with no tp collective.
"""

from __future__ import annotations

from typing import Optional

import torch

from vgate_tpu_torch.ops.attention import local_pages, merge_partials
from vgate_tpu_torch.ops.kernels.paged_decode import paged_decode_partial
from vgate_tpu_torch.ops.kernels.paged_multitok import paged_multitok_partial
from vgate_tpu_torch.ops.kv_quant import kv_write


def shard_base(mesh, k_pool: torch.Tensor) -> int:
    """The first global page of this rank's pool shard."""
    return mesh.sp_rank * k_pool.shape[1]


def write_owned(k_pool, v_pool, k: torch.Tensor, v: torch.Tensor,
                page_ids: torch.Tensor, page_off: torch.Tensor,
                base: int) -> None:
    """Token rows ``k``/``v`` ``[*idx, KV, hd]`` into one layer's pool
    shard ``[KV, P/sp, ps, hd]`` at global pages ``page_ids`` and slots
    ``page_off`` (both of shape ``idx``): the pages this rank owns take
    their rows, every other row goes to local page 0 as zeros."""
    local, _ = local_pages(page_ids, base, k_pool.shape[1])
    n = page_ids.dim()
    perm = (n, *range(n), n + 1)  # [*idx, KV, hd] -> [KV, *idx, hd]
    kv_write(k_pool, (slice(None), local, page_off.long()), k.permute(*perm))
    kv_write(v_pool, (slice(None), local, page_off.long()), v.permute(*perm))


def merge_over_sp(mesh, acc: torch.Tensor, m: torch.Tensor,
                  l: torch.Tensor) -> torch.Tensor:
    """Every sp rank's partials, by one all-gather, merged in rank order
    into the attention over every rank's keys (fp32 ``acc``'s shape)."""
    n_acc, n_m = acc.numel(), m.numel()
    flat = torch.cat([acc.reshape(-1), m.reshape(-1), l.reshape(-1)])
    parts = mesh.sp_all_gather(flat)
    return merge_partials(parts[:, :n_acc].reshape(-1, *acc.shape),
                          parts[:, n_acc:n_acc + n_m].reshape(-1, *m.shape),
                          parts[:, n_acc + n_m:].reshape(-1, *l.shape))


def sp_decode_attention_and_write(
    q: torch.Tensor,  # [B, H, hd] roped queries
    k_t: torch.Tensor,  # [B, KV, hd] the step's roped keys
    v_t: torch.Tensor,
    k_pool: torch.Tensor,  # [KV, P/sp, ps, hd] this rank's, in place
    v_pool: torch.Tensor,
    page_ids: torch.Tensor,  # [B] GLOBAL page of the write (0: inactive)
    page_off: torch.Tensor,  # [B] slot in the page
    page_tables: torch.Tensor,  # [B, pages_per_seq] GLOBAL page ids
    seq_lens: torch.Tensor,  # [B]
    mesh,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One decode layer's KV write and attention, sequence-parallel: the
    reference's ``sp_decode_attention_and_write``.  Returns the attention
    ``[B, H, hd]`` in q's dtype, the same on every rank; the pool shard
    is written in place."""
    base = shard_base(mesh, k_pool)
    write_owned(k_pool, v_pool, k_t, v_t, page_ids, page_off, base)
    acc, m, l = paged_decode_partial(
        q.contiguous(), k_pool, v_pool, page_tables, seq_lens, base,
        softcap=softcap, window=window, scale=scale)
    return merge_over_sp(mesh, acc, m, l).to(q.dtype)


def _suffix_partials(q, k_pool, v_pool, ctx_page_tables, positions0,
                     total_lens, mesh, base, window, softcap, scale):
    """The suffix rows' attention over every rank's context pages: K3-sp
    partials over this rank's, merged over sp (the body the suffix and
    the verify pass share)."""
    acc, m, l = paged_multitok_partial(
        q.contiguous(), k_pool, v_pool, ctx_page_tables, positions0,
        total_lens - positions0, base, softcap=softcap, window=window,
        scale=scale)
    return merge_over_sp(mesh, acc, m, l).to(q.dtype)


def sp_suffix_attention_and_write(
    q: torch.Tensor,  # [B, S, H, hd] roped suffix queries
    k_s: torch.Tensor,  # [B, S, KV, hd] the suffix's roped keys
    v_s: torch.Tensor,
    k_pool: torch.Tensor,  # [KV, P/sp, ps, hd] this rank's, in place
    v_pool: torch.Tensor,
    suffix_page_tables: torch.Tensor,  # [B, S // ps] GLOBAL ids
    ctx_page_tables: torch.Tensor,  # [B, ctx_pages] GLOBAL ids
    prefix_lens: torch.Tensor,  # [B] position of q[:, 0] (page-aligned)
    total_lens: torch.Tensor,  # [B] prefix + real suffix
    mesh,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One suffix-pass layer (a prefix hit or a prefill chunk) on the
    sharded pool: the reference's ``sp_suffix_attention_and_write``.  The
    suffix pages this rank owns take their rows (every other page, the
    padding's included, goes to local page 0), then K3-sp partials over
    the owned context pages merge over sp.  Returns ``[B, S, H, hd]``."""
    B, S = q.shape[:2]
    ps = k_pool.shape[2]
    base = shard_base(mesh, k_pool)
    pos = torch.arange(S, device=q.device)
    pages = suffix_page_tables.long()[:, pos // ps]  # [B, S]
    write_owned(k_pool, v_pool, k_s, v_s, pages, (pos % ps).expand(B, S),
                base)
    return _suffix_partials(q, k_pool, v_pool, ctx_page_tables, prefix_lens,
                            total_lens, mesh, base, window, softcap, scale)


def sp_multitok_attention_and_write(
    q: torch.Tensor,  # [B, S, H, hd] roped candidate queries
    k_t: torch.Tensor,  # [B, S, KV, hd]
    v_t: torch.Tensor,
    k_pool: torch.Tensor,  # [KV, P/sp, ps, hd] this rank's, in place
    v_pool: torch.Tensor,
    page_ids: torch.Tensor,  # [B, S] GLOBAL page a candidate (0 = trash)
    page_off: torch.Tensor,  # [B, S]
    ctx_page_tables: torch.Tensor,  # [B, ctx_pages] GLOBAL ids
    positions0: torch.Tensor,  # [B] position of q[:, 0], any alignment
    total_lens: torch.Tensor,  # [B] positions0 + real candidates
    mesh,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One speculative-verify layer on the sharded pool: the reference's
    ``sp_multitok_attention_and_write``, which differs from the suffix's
    only in its per-token write.  Returns ``[B, S, H, hd]``."""
    base = shard_base(mesh, k_pool)
    write_owned(k_pool, v_pool, k_t, v_t, page_ids, page_off, base)
    return _suffix_partials(q, k_pool, v_pool, ctx_page_tables, positions0,
                            total_lens, mesh, base, window, softcap, scale)

