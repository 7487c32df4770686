"""Device-side token sampling with per-request parameters.

Every slot carries its own (temperature, top_p, top_k), applied on the
top ``TRUNC`` logits (``torch.topk``) rather than a full-vocab sort:
top-k is exact for k <= TRUNC, top-p whenever the top-TRUNC mass covers
``top_p``.  Sampling is Gumbel-max over the masked slice.

Noise cannot replay the reference's ``jax.random`` streams.  Unseeded
rows draw from the engine's ``torch.Generator``; rows with a request
``seed`` draw from a counter-based hash of (seed, token index, rank), so
the same seed reproduces the same tokens whatever the batch, as in the
reference.  Greedy rows are ``argmax`` (first index on ties).
"""

from __future__ import annotations

from typing import Optional

import torch

TRUNC = 256  # logits kept per slot for sampling
_GREEDY_EPS = 1e-4
_MASK32 = 0xFFFFFFFF


def _masked_scaled(
    logits: torch.Tensor,  # [B, V]
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] int, 0 => disabled
):
    """Truncate + scale + apply top-k/top-p masks.  Returns (raw
    top-trunc logits [B, trunc] sorted desc, their token ids, the
    temperature-scaled logits with ineligible entries at -1e30)."""
    B, V = logits.shape
    trunc = min(TRUNC, V)
    top_vals, top_idx = torch.topk(logits.float(), trunc, dim=-1)
    safe_temp = torch.clamp(temperature.float(), min=_GREEDY_EPS)[:, None]
    scaled = top_vals / safe_temp
    ranks = torch.arange(trunc, device=logits.device)[None, :]
    k = torch.where(top_k[:, None] > 0, top_k[:, None], trunc)
    k_mask = ranks < k
    # top-p: keep the smallest prefix whose mass >= top_p; the exclusive
    # cumsum keeps the argmax token always eligible
    probs = torch.softmax(scaled, dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    p_mask = cum_excl < torch.clamp(top_p.float(), 0.0, 1.0)[:, None]
    masked = torch.where(
        k_mask & p_mask, scaled, torch.full_like(scaled, -1e30)
    )
    return top_vals, top_idx, masked


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """One 32-bit avalanche round on int64 tensors holding uint32 values
    (constants stay below 2**31 so no product overflows int64)."""
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _MASK32
    x = x ^ (x >> 16)
    x = (x * 0x2C1B3C6D) & _MASK32
    return x ^ (x >> 16)


def _hash_uniform(
    seeds: torch.Tensor, steps: torch.Tensor, n: int
) -> torch.Tensor:
    """Uniform (0, 1) noise [B, n] as a pure function of (seed, step,
    rank): reproducible regardless of batch composition or engine step."""
    dev = seeds.device
    s = seeds.to(torch.int64) & _MASK32
    t = steps.to(torch.int64) & _MASK32
    r = torch.arange(n, device=dev, dtype=torch.int64)
    x = _mix32(s[:, None] ^ _mix32(t[:, None] + 0x3C6EF372))
    x = _mix32(x ^ _mix32(r[None, :] + 0x1B873593))
    return (x.to(torch.float64) + 0.5) / 4294967296.0


def _gumbel(
    shape, generator: Optional[torch.Generator], seeds, steps, device
) -> torch.Tensor:
    B, n = shape
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float64)
    if seeds is not None:
        seeded = (seeds >= 0)[:, None]
        steps = torch.zeros_like(seeds) if steps is None else steps
        u = torch.where(seeded, _hash_uniform(seeds, steps, n), u)
    u = torch.clamp(u, min=1e-300)
    return (-torch.log(-torch.log(u))).float()


def sample_tokens(
    logits: torch.Tensor,  # [B, V]
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] int, 0 => disabled
    generator: Optional[torch.Generator] = None,
    seeds: Optional[torch.Tensor] = None,  # [B] int, -1 => unseeded
    steps: Optional[torch.Tensor] = None,  # [B] per-seq sample index
    all_greedy: bool = False,  # every row is temperature 0
) -> torch.Tensor:
    """Sample one token per slot honoring per-slot params. Returns [B]
    int32.  ``all_greedy`` skips the top-TRUNC slice entirely."""
    if all_greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    _top_vals, top_idx, masked = _masked_scaled(
        logits, temperature, top_p, top_k
    )
    gumbel = _gumbel(
        masked.shape, generator, seeds, steps, logits.device
    )
    sampled_pos = torch.argmax(masked + gumbel, dim=-1)
    greedy = temperature <= _GREEDY_EPS
    pos = torch.where(greedy, torch.zeros_like(sampled_pos), sampled_pos)
    return torch.gather(top_idx, 1, pos[:, None])[:, 0].to(torch.int32)


def apply_penalties(
    logits: torch.Tensor,  # [B, V]
    counts: torch.Tensor,  # [B, V] per-slot generated-token counts
    frequency_penalty: torch.Tensor,  # [B]
    presence_penalty: torch.Tensor,  # [B]
) -> torch.Tensor:
    """OpenAI frequency/presence penalties over the full vocabulary:
    ``logits -= freq * counts + pres * (counts > 0)`` (fp32)."""
    c = counts.float()
    return (
        logits.float()
        - frequency_penalty[:, None] * c
        - presence_penalty[:, None] * (c > 0).float()
    )


def apply_logit_bias(
    logits: torch.Tensor,  # [B, V]
    bias_ids: torch.Tensor,  # [B, K] token ids; >= V entries pad
    bias_vals: torch.Tensor,  # [B, K] additive biases
) -> torch.Tensor:
    """OpenAI ``logit_bias``: add per-request biases to selected token
    logits.  Padding entries (out-of-vocab ids) are dropped, like the
    reference's out-of-bounds scatter."""
    V = logits.shape[1]
    out = logits.float().clone()
    ok = bias_ids < V
    ids = torch.where(ok, bias_ids, torch.zeros_like(bias_ids)).long()
    vals = torch.where(ok, bias_vals.float(), torch.zeros_like(bias_vals))
    return out.scatter_add_(1, ids, vals)


def suppress_stop_tokens(
    logits: torch.Tensor,  # [B, V]
    steps: torch.Tensor,  # [B] tokens generated so far
    min_tokens: torch.Tensor,  # [B] per-slot floor (0 = off)
    stop_ids: torch.Tensor,  # [B, K] stop ids; >= V entries are padding
) -> torch.Tensor:
    """min_tokens: slots below their floor cannot sample a stop token."""
    B, V = logits.shape
    # an extra scratch column absorbs the padding ids
    wide = torch.cat(
        [logits, torch.zeros((B, 1), dtype=logits.dtype,
                             device=logits.device)], dim=1
    )
    idx = torch.clamp(stop_ids, max=V).long()
    masked = wide.scatter(
        1, idx, torch.full(idx.shape, -1e30, dtype=logits.dtype,
                           device=logits.device)
    )[:, :V]
    suppress = (steps < min_tokens)[:, None]
    return torch.where(suppress, masked, logits)
