"""Ring attention: the sequence-parallel prompt pass over the ``sp`` axis.

The port of vgate_tpu/parallel/ring_attention.py.  Each sp rank holds
``S/sp`` consecutive rows of the prompt (rank r rows ``[r*S/sp,
(r+1)*S/sp)``) through the whole layer (models/decoder.py: norm, qkv,
rope, attention, MLP), and the K/V blocks rotate around the ring for sp
- 1 hops (parallel/mesh.py ``ring_shift``, posted in the pipeline
relay's fixed order, so NCCL cannot deadlock):

* at hop t rank r holds rank ``r - t``'s block.  A block from an earlier
  rank is attended whole (causal at its own block), through K2-ring
  (ops/kernels/flash_prefill.py ``flash_prefill_partial``: the query
  block against the held block with ``q_offsets = (r - src) * S/sp`` and
  key lengths ``clip(seq_len - src * S/sp, 0, S/sp)``), whose partials
  fold into the rank's running ``(acc, m, l)`` (ops/attention.py
  ``fold_partials``, elementwise, as the reference's
  ``_block_attention_update`` folds its step).  A block from a later
  rank is wholly masked by causality: it is not computed, only passed
  on.  So rank r launches K2-ring ``r + 1`` times a layer;
* the blocks travel unexpanded, ``[B, S/sp, KV, hd]`` each, K and V in
  one tensor: the reference expands GQA before sharding, which ships
  H/KV times the bytes for the same function;
* as each block passes, the rank writes the pages of it that it owns
  into its pool shard (parallel/sp_decode.py ``write_owned``), so no
  second gather of the prompt's KV is needed.

Under sp x tp the ring runs over the sp group at the rank's tp index, on
its tp rank's heads: ``[B, S/sp, KV/tp, hd]`` blocks between the
matching ranks of two sp indices (``sp_peer``), where the reference's
ring replicates the heads over tp.

Gemma-2's windows and softcap ride the same hops: the window masks
compose with the block positions (a block wholly outside every row's
window is computed and contributes nothing, as in the reference).
"""

from __future__ import annotations

from typing import Optional

import torch

from vgate_tpu_torch.ops.attention import fold_partials
from vgate_tpu_torch.ops.kernels.flash_prefill import flash_prefill_partial
from vgate_tpu_torch.parallel.sp_decode import shard_base, write_owned


def ring_prefill_attention(
    q: torch.Tensor,  # [B, S/sp, H, hd] this rank's roped query rows
    k: torch.Tensor,  # [B, S/sp, KV, hd] this rank's roped key rows
    v: torch.Tensor,
    seq_lens: torch.Tensor,  # [B] global real lengths
    mesh,
    window: int = 0,  # >0 => attend only to the last `window` keys
    softcap: float = 0.0,
    scale: Optional[float] = None,
    pools: Optional[tuple] = None,  # (k_pool, v_pool, page_tables)
) -> torch.Tensor:
    """Causal attention of this rank's query block over every rank's
    keys: the reference's ``ring_prefill_attention`` for one rank's rows.
    With ``pools`` (this layer's pool shard ``[KV, P/sp, ps, hd]`` and
    the prompt's global ``[B, S // ps]`` page tables) every block's owned
    pages are written as it passes.  Returns ``[B, S/sp, H, hd]`` in q's
    dtype."""
    B, n = q.shape[:2]
    r, sp = mesh.sp_rank, mesh.sp
    dev = q.device
    lens = seq_lens.to(device=dev, dtype=torch.int32)
    pos = torch.arange(n, device=dev)
    block = torch.stack([k, v]).contiguous()  # [2, B, n, KV, hd]
    state = None
    for hop in range(sp):
        src = (r - hop) % sp
        if src <= r:  # a later rank's keys are all in every row's future
            part = flash_prefill_partial(
                q, block[0], block[1],
                torch.clamp(lens - src * n, 0, n).to(torch.int32),
                torch.full((B,), (r - src) * n, dtype=torch.int32,
                           device=dev),
                softcap=softcap, window=window, scale=scale)
            state = part if state is None else fold_partials(state, part)
        if pools is not None:
            k_pool, v_pool, page_tables = pools
            ps = k_pool.shape[2]
            at = src * n + pos
            write_owned(k_pool, v_pool, block[0], block[1],
                        page_tables.long()[:, at // ps],
                        (at % ps).expand(B, n), shard_base(mesh, k_pool))
        if hop < sp - 1:
            block = mesh.ring_shift(block)
    acc, _, l = state
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
