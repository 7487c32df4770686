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

from vgate_tpu_torch.ops.kv_quant import gather_pages

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
    k_pages: torch.Tensor,  # [KV, P, ps, hd] (head-major, kv_cache.py)
    v_pages: torch.Tensor,
    page_tables: torch.Tensor,  # [B, pages_per_seq] int32
    seq_lens: torch.Tensor,  # [B] context length (incl. current token)
    softcap: float = 0.0,
    window=None,  # >0 => attend only to the last `window` keys
    scale: Optional[float] = None,  # query scale; default hd**-0.5
    layer=None,  # pool layer index: k/v_pages then carry a leading [L]
) -> torch.Tensor:
    """Decode-step attention over the paged KV cache. Returns [B, H, hd].

    Gathers each slot's whole page window, masks positions >= seq_len
    (and below the window), and runs an fp32 softmax.  Unlike the
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
    k_pages: torch.Tensor,  # [KV, P, ps, hd] (head-major)
    v_pages: torch.Tensor,
    page_tables: torch.Tensor,  # [B, ctx_pages] int32 context window row
    prefix_lens: torch.Tensor,  # [B] global position of q[:, 0]
    seq_lens: torch.Tensor,  # [B] total context (prefix + real suffix)
    softcap: float = 0.0,
    window=None,  # >0 => attend only to the last `window` keys
    scale: Optional[float] = None,  # query scale; default hd**-0.5
) -> torch.Tensor:
    """Prompt-suffix attention over resident paged KV (prefix caching):
    the semantic spec of the multi-token kernel (ops/kernels/
    paged_multitok.py, K3).  The suffix KV is already in the pool; this
    gathers each slot's ``ctx_pages`` window and runs the blockwise
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
