"""Attention in plain PyTorch: the semantic spec of the CUDA kernels.

These functions carry the reference's jnp twins (vgate_tpu/ops/
attention.py) over to torch, with the same layouts and the same masking
sentinels (``-1e30`` scores, ``max(l, 1e-30)`` denominators).  The CPU
tests hold them against the JAX functions; ``chip_smoke.py`` holds each
kernel (ops/kernels/) against them on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from vgate_tpu_torch.ops.kv_quant import KVPool, gather_pages

NEG = -1e30  # masked-score sentinel, as in the reference kernels


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Broadcast KV heads across query-head groups (GQA). x: [..., KV, hd]."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=-2)


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style tanh soft-capping of scores (fp32)."""
    if not cap:
        return scores
    return torch.tanh(scores / cap) * cap


def _window_ok(dist: torch.Tensor, window) -> torch.Tensor:
    """``dist < window`` where window > 0, everything otherwise."""
    if window is None:
        return torch.ones_like(dist, dtype=torch.bool)
    window = torch.as_tensor(window, device=dist.device)
    return (window <= 0) | (dist < window)


def causal_prefill_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, KV, hd]
    v: torch.Tensor,  # [B, S, KV, hd]
    seq_lens: torch.Tensor,  # [B] real lengths (tokens beyond are padding)
    softcap: float = 0.0,
    window=None,  # >0 => attend only to the last `window` keys
    scale: Optional[float] = None,  # query scale; default hd**-0.5
) -> torch.Tensor:
    """Causal self-attention over a padded prompt batch with the full
    [B, H, S, S] score matrix (the test oracle).  Returns [B, S, H, hd]."""
    B, S, H, hd = q.shape
    n_rep = H // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    scores = _softcap(scores, softcap)
    pos = torch.arange(S, device=q.device)
    causal = pos[None, :] <= pos[:, None]
    key_valid = pos[None, :] < seq_lens[:, None]
    mask = causal[None, None] & key_valid[:, None, None, :]
    mask = mask & _window_ok(pos[:, None] - pos[None, :], window)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG))
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def flash_prefill_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, Sk, KV, hd]
    v: torch.Tensor,  # [B, Sk, KV, hd]
    seq_lens: torch.Tensor,  # [B] real key lengths
    block_k: int = 256,
    q_offset: Optional[torch.Tensor] = None,  # [B] global pos of q[:, 0]
    softcap: float = 0.0,
    window=None,  # >0 => attend only to the last `window` keys
    scale: Optional[float] = None,  # query scale; default hd**-0.5
) -> torch.Tensor:
    """Blockwise causal attention with an online softmax over key blocks
    of ``block_k`` (the last may be shorter), so no [S, Sk] score matrix
    per head exists.  Returns [B, S, H, hd].

    With ``q_offset`` the queries are a chunk starting at a nonzero
    global position attending to keys laid out from position 0."""
    B, S, H, hd = q.shape
    Sk = k.shape[1]
    n_rep = H // k.shape[2]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    q32 = q.float() * scale
    dev = q.device
    q_pos = torch.arange(S, device=dev)[None, :]  # [1, S]
    if q_offset is not None:
        q_pos = q_pos + q_offset[:, None]  # [B, S]
    acc = torch.zeros((B, S, H, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, S, H), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, S, H), dtype=torch.float32, device=dev)
    for start in range(0, Sk, block_k):
        k_blk = repeat_kv(k[:, start : start + block_k], n_rep).float()
        v_blk = repeat_kv(v[:, start : start + block_k], n_rep).float()
        k_pos = start + torch.arange(k_blk.shape[1], device=dev)
        mask = (k_pos[None, None, :] <= q_pos[:, :, None]) & (
            k_pos[None, None, :] < seq_lens[:, None, None]
        )  # [B, S, block_k]
        mask = mask & _window_ok(
            q_pos[:, :, None] - k_pos[None, None, :], window
        )
        scores = torch.einsum("bshd,bthd->bsth", q32, k_blk)
        scores = _softcap(scores, softcap)
        scores = torch.where(
            mask[..., None], scores, torch.full_like(scores, NEG)
        )
        m_new = torch.maximum(m, scores.amax(dim=2))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[:, :, None, :])
        l = alpha * l + p.sum(dim=2)
        acc = acc * alpha[..., None] + torch.einsum("bsth,bthd->bshd", p, v_blk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,  # [B, H, hd] one query token per slot
    k_pages: KVPool,  # [KV, P, ps, hd] (head-major, kv_cache.py)
    v_pages: KVPool,
    page_tables: torch.Tensor,  # [B, pages_per_seq] int32
    seq_lens: torch.Tensor,  # [B] context length (incl. current token)
    softcap: float = 0.0,
    window=None,  # >0 => attend only to the last `window` keys
    scale: Optional[float] = None,  # query scale; default hd**-0.5
    layer=None,  # pool layer index: k/v_pages then carry a leading [L]
) -> torch.Tensor:
    """Decode-step attention over the paged KV cache. Returns [B, H, hd].

    Gathers each slot's whole page window (dequantized to f32 for int8
    ``QuantPages`` pools: the plain version of K1's int8 mode), masks
    positions >= seq_len (and below the window), and runs an fp32
    softmax.  Unlike the
    reference's jnp twin, the probabilities stay fp32 through the PV
    product — as in every kernel version — so the plain version is the
    precise yardstick the kernel is held to."""
    B, H, hd = q.shape
    k_sel = gather_pages(k_pages, page_tables, layer=layer)
    v_sel = gather_pages(v_pages, page_tables, layer=layer)
    KV = k_sel.shape[0]
    ctx = page_tables.shape[1] * k_sel.shape[-2]
    n_rep = H // KV
    # [KV, B, n, ps, hd] -> [B, ctx, KV, hd]
    k = repeat_kv(k_sel.reshape(KV, B, ctx, hd).movedim(0, 2), n_rep)
    v = repeat_kv(v_sel.reshape(KV, B, ctx, hd).movedim(0, 2), n_rep)
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    scores = torch.einsum("bhd,bthd->bht", q.float(), k.float()) * scale
    scores = _softcap(scores, softcap)
    t = torch.arange(ctx, device=q.device)[None, :]
    valid = t < seq_lens[:, None]
    if window is not None:
        # the query sits at seq_len-1: its window is (seq_len-1-window, ..]
        window = torch.as_tensor(window, device=q.device)
        valid = valid & ((window <= 0) | (t > seq_lens[:, None] - 1 - window))
    scores = torch.where(valid[:, None, :], scores, torch.full_like(scores, NEG))
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bht,bthd->bhd", probs, v.float())
    return out.to(q.dtype)


def paged_suffix_attention(
    q: torch.Tensor,  # [B, S, H, hd] suffix queries
    k_pages: KVPool,  # [KV, P, ps, hd] (head-major)
    v_pages: KVPool,
    page_tables: torch.Tensor,  # [B, ctx_pages] int32 context window row
    prefix_lens: torch.Tensor,  # [B] global position of q[:, 0]
    seq_lens: torch.Tensor,  # [B] total context (prefix + real suffix)
    softcap: float = 0.0,
    window=None,  # >0 => attend only to the last `window` keys
    scale: Optional[float] = None,  # query scale; default hd**-0.5
) -> torch.Tensor:
    """Prompt-suffix attention over resident paged KV (prefix caching):
    the semantic spec of the multi-token kernel (ops/kernels/
    paged_multitok.py, K3, and of its int8 mode).  The suffix KV is
    already in the pool; this gathers each slot's ``ctx_pages`` window
    (dequantized to f32 for int8 pools) and runs the blockwise
    online softmax of :func:`flash_prefill_attention`, whose
    ``q_offset`` mask IS the suffix mask (``k_pos <= prefix + s`` and
    ``k_pos < seq_len``).  Returns [B, S, H, hd]."""
    B = q.shape[0]
    KV, _, ps, hd = k_pages.shape
    ctx = page_tables.shape[1] * ps
    k = gather_pages(k_pages, page_tables).reshape(KV, B, ctx, hd)
    v = gather_pages(v_pages, page_tables).reshape(KV, B, ctx, hd)
    # key blocks divide the window, as in the reference's twin
    block_k = 256 if ctx % 256 == 0 else ps
    return flash_prefill_attention(
        q, k.movedim(0, 2), v.movedim(0, 2), seq_lens, block_k=block_k,
        q_offset=prefix_lens, softcap=softcap, window=window, scale=scale,
    )


# ------------------------------------------------- sequence-parallel partials
#
# Under sp (parallel/ring_attention.py, parallel/sp_decode.py) each rank
# attends a part of the keys and emits the unnormalised flash partials
# ``(acc [.., hd], m, l)`` in fp32, which merge by log-sum-exp into the
# attention over every key.  A row that sees no key of its part yields
# ``acc = 0``, ``m = -1e30``, ``l = 0``: it merges as nothing, never NaN.


def local_pages(pages: torch.Tensor, base: int, shard: int):
    """``(local ids, owned)`` of global page ids on the sp rank whose pool
    shard holds global pages ``[base, base + shard)``: an owned page's
    index in the shard, 0 (the rank's trash page) for every other."""
    pages = pages.long()
    owned = (pages >= base) & (pages < base + shard)
    return torch.where(owned, pages - base, torch.zeros_like(pages)), owned


def block_attention_update(
    q: torch.Tensor,  # [B, Sq, H, hd] fp32, scaled
    k: torch.Tensor,  # [B, Sk, H, hd]
    v: torch.Tensor,
    mask: torch.Tensor,  # [B, Sq, Sk] bool
    acc: torch.Tensor,  # [B, Sq, H, hd] fp32
    m: torch.Tensor,  # [B, Sq, H] running max
    l: torch.Tensor,  # [B, Sq, H] running denominator
    softcap: float = 0.0,
):
    """One online-softmax step over a key block: the reference's
    ``_block_attention_update`` (vgate_tpu/parallel/ring_attention.py),
    its sentinels included (a row masked throughout takes ``p = 1`` while
    its max is the sentinel, as there).  Returns the new ``(acc, m,
    l)``."""
    scores = torch.einsum("bshd,bthd->bsth", q, k.float())
    scores = _softcap(scores, softcap)
    scores = torch.where(mask[..., None], scores,
                         torch.full_like(scores, NEG))
    m_new = torch.maximum(m, scores.amax(dim=2))
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[:, :, None, :])
    l_new = alpha * l + p.sum(dim=2)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bsth,bthd->bshd", p, v.float())
    return acc_new, m_new, l_new


def empty_partials(shape, device) -> tuple:
    """The partials ``(acc [*shape], m, l [*shape[:-1]])`` of rows that
    saw no key."""
    return (torch.zeros(shape, dtype=torch.float32, device=device),
            torch.full(shape[:-1], NEG, dtype=torch.float32, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device))


def prefill_partial_attention(
    q: torch.Tensor,  # [B, S, H, hd] this rank's query rows
    k: torch.Tensor,  # [B, Sk, KV, hd] one block of keys, unexpanded
    v: torch.Tensor,
    key_lens: torch.Tensor,  # [B] int32 real keys of the block (0..Sk)
    q_offsets: torch.Tensor,  # [B] int32 position of q[:, 0] from key 0
    softcap: float = 0.0,
    window: int = 0,  # >0 => attend only to the last `window` keys
    scale: Optional[float] = None,  # query scale; default hd**-0.5
):
    """One hop of the ring prompt pass (the plain version of K2-ring,
    ops/kernels/flash_prefill.py ``flash_prefill_partial``): the query
    rows against one K/V block, causal from ``q_offsets``, as
    :func:`block_attention_update` from the empty state, with the rows
    that see no key of the block emptied.  Returns fp32 ``(acc [B, S, H,
    hd], m [B, S, H], l [B, S, H])``."""
    B, S, H, hd = q.shape
    Sk = k.shape[1]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    dev = q.device
    q_pos = q_offsets.long()[:, None] + torch.arange(S, device=dev)
    k_pos = torch.arange(Sk, device=dev)
    mask = (k_pos[None, None, :] <= q_pos[:, :, None]) & (
        k_pos[None, None, :] < key_lens.long()[:, None, None])
    mask = mask & _window_ok(q_pos[:, :, None] - k_pos[None, None, :],
                             window if window else None)
    n_rep = H // k.shape[2]
    acc, m, l = block_attention_update(
        q.float() * scale, repeat_kv(k, n_rep), repeat_kv(v, n_rep), mask,
        *empty_partials((B, S, H, hd), dev), softcap=softcap)
    seen = mask.any(dim=2)[..., None]  # [B, S, 1]
    return (torch.where(seen[..., None], acc, torch.zeros_like(acc)),
            torch.where(seen, m, torch.full_like(m, NEG)),
            torch.where(seen, l, torch.zeros_like(l)))


def partial_paged_attention(
    q: torch.Tensor,  # [B, H, hd]
    k_local: torch.Tensor,  # [KV, P/sp, ps, hd] this rank's page block
    v_local: torch.Tensor,
    local_pt: torch.Tensor,  # [B, pages_per_seq] local page (0: not mine)
    owned: torch.Tensor,  # [B, pages_per_seq] bool: the page is mine
    seq_lens: torch.Tensor,  # [B]
    window=0,  # >0 => only the last `window` positions
    softcap: float = 0.0,
    scale: Optional[float] = None,
):
    """Decode partials over the pages this rank owns: the reference's
    ``_partial_paged_attention`` (vgate_tpu/parallel/sp_decode.py), the
    plain version of K1-sp (ops/kernels/paged_decode.py
    ``paged_decode_partial``).  Returns fp32 ``(acc [B, H, hd], m [B, H],
    l [B, H])``."""
    B, H, hd = q.shape
    KV, _, ps, _ = k_local.shape
    ctx = local_pt.shape[1] * ps
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    pt = local_pt.long()
    k = repeat_kv(k_local[:, pt].reshape(KV, B, ctx, hd).movedim(0, 2),
                  H // KV)
    v = repeat_kv(v_local[:, pt].reshape(KV, B, ctx, hd).movedim(0, 2),
                  H // KV)
    scores = torch.einsum("bhd,bthd->bht", q.float() * scale, k.float())
    scores = _softcap(scores, softcap)
    t = torch.arange(ctx, device=q.device)[None, :]
    sl = seq_lens.long()[:, None]
    valid = (t < sl) & torch.repeat_interleave(owned, ps, dim=1)
    window = torch.as_tensor(window, device=q.device)
    valid = valid & ((window <= 0) | (t > sl - 1 - window))
    scores = torch.where(valid[:, None, :], scores,
                         torch.full_like(scores, NEG))
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    p = torch.where(valid[:, None, :], p, torch.zeros_like(p))
    return (torch.einsum("bht,bthd->bhd", p, v.float()), m, p.sum(dim=-1))


def partial_suffix_attention(
    q: torch.Tensor,  # [B, S, H, hd] roped queries (absolute positions)
    k_local: torch.Tensor,  # [KV, P/sp, ps, hd] this rank's page block
    v_local: torch.Tensor,
    local_ct: torch.Tensor,  # [B, ctx_pages] local page (0: not mine)
    owned: torch.Tensor,  # [B, ctx_pages] bool: the page is mine
    prefix_lens: torch.Tensor,  # [B] position of q[:, 0]
    total_lens: torch.Tensor,  # [B] prefix + real rows
    window=0,  # >0 => sliding window
    softcap: float = 0.0,
    scale: Optional[float] = None,
    block_pages: int = 16,
):
    """Suffix (and verify) partials over the context pages this rank
    owns, in blocks of ``block_pages`` pages: the reference's
    ``_partial_suffix_attention`` (vgate_tpu/parallel/sp_decode.py), the
    plain version of K3-sp (ops/kernels/paged_multitok.py
    ``paged_multitok_partial``).  Returns fp32 ``(acc [B, S, H, hd], m
    [B, S, H], l [B, S, H])``."""
    B, S, H, hd = q.shape
    KV, _, ps, _ = k_local.shape
    n_rep = H // KV
    ctx_pages = local_ct.shape[1]
    dev = q.device
    if ctx_pages == 0:
        return empty_partials((B, S, H, hd), dev)
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    block_pages = min(block_pages, ctx_pages)
    # padded entries are not owned, so they contribute nothing
    pad = (-ctx_pages) % block_pages
    local_ct = torch.nn.functional.pad(local_ct.long(), (0, pad))
    owned = torch.nn.functional.pad(owned, (0, pad))
    q32 = q.float() * scale
    q_pos = prefix_lens.long()[:, None] + torch.arange(S, device=dev)
    total = total_lens.long()[:, None, None]
    window = torch.as_tensor(window, device=dev)
    acc, m, l = empty_partials((B, S, H, hd), dev)
    bk = block_pages * ps
    for start in range(0, ctx_pages + pad, block_pages):
        pt = local_ct[:, start:start + block_pages]
        k = repeat_kv(k_local[:, pt].reshape(KV, B, bk, hd).movedim(0, 2),
                      n_rep).float()
        v = repeat_kv(v_local[:, pt].reshape(KV, B, bk, hd).movedim(0, 2),
                      n_rep).float()
        t = (start * ps + torch.arange(bk, device=dev))[None, None, :]
        valid = ((t <= q_pos[:, :, None]) & (t < total)
                 & torch.repeat_interleave(
                     owned[:, start:start + block_pages], ps, dim=1
                 )[:, None, :])
        valid = valid & ((window <= 0) | (q_pos[:, :, None] - t < window))
        scores = _softcap(torch.einsum("bshd,bthd->bsth", q32, k), softcap)
        scores = torch.where(valid[..., None], scores,
                             torch.full_like(scores, NEG))
        m_new = torch.maximum(m, scores.amax(dim=2))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[:, :, None, :])
        p = torch.where(valid[..., None], p, torch.zeros_like(p))
        l = alpha * l + p.sum(dim=2)
        acc = acc * alpha[..., None] + torch.einsum("bsth,bthd->bshd", p, v)
        m = m_new
    return acc, m, l


def merge_partials(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor):
    """The attention over every part from the parts' partials stacked on
    a leading axis (``acc [n, .., hd]``, ``m``/``l`` ``[n, ..]``): the
    reference's log-sum-exp merge over sp (``pmax`` of m, ``psum`` of
    the rescaled acc and l), summed in part order.  Returns fp32 ``[..,
    hd]``."""
    m_g = m.amax(dim=0)
    corr = torch.exp(m - m_g)
    acc_g = (acc * corr[..., None]).sum(dim=0)
    l_g = (l * corr).sum(dim=0)
    return acc_g / torch.clamp(l_g, min=1e-30)[..., None]


def fold_partials(state: tuple, part: tuple) -> tuple:
    """Two sets of partials ``(acc, m, l)`` as one (the running state of
    the ring and one hop's partials)."""
    acc, m, l = state
    acc_b, m_b, l_b = part
    m_new = torch.maximum(m, m_b)
    a, b = torch.exp(m - m_new), torch.exp(m_b - m_new)
    return (acc * a[..., None] + acc_b * b[..., None], m_new,
            l * a + l_b * b)
