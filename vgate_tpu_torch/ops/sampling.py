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


def _uniform(
    shape, generator: Optional[torch.Generator], seeds, steps, device
) -> torch.Tensor:
    """Uniform noise [B, n] (float64): the engine generator's, and for
    rows with ``seeds >= 0`` the (seed, step) hash's."""
    B, n = shape
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float64)
    if seeds is not None:
        seeded = (seeds >= 0)[:, None]
        steps = torch.zeros_like(seeds) if steps is None else steps
        u = torch.where(seeded, _hash_uniform(seeds, steps, n), u)
    return u


def _to_gumbel(u: torch.Tensor) -> torch.Tensor:
    u = torch.clamp(u, min=1e-300)
    return (-torch.log(-torch.log(u))).float()


def _gumbel(
    shape, generator: Optional[torch.Generator], seeds, steps, device
) -> torch.Tensor:
    return _to_gumbel(_uniform(shape, generator, seeds, steps, device))


def _topk_and_pos(logits, temperature, top_p, top_k, generator, seeds,
                  steps):
    """Shared sampling core: returns (raw top-trunc logits [B, trunc]
    sorted desc, their token ids, the chosen position within them)."""
    top_vals, top_idx, masked = _masked_scaled(
        logits, temperature, top_p, top_k
    )
    gumbel = _gumbel(
        masked.shape, generator, seeds, steps, logits.device
    )
    sampled_pos = torch.argmax(masked + gumbel, dim=-1)
    greedy = temperature <= _GREEDY_EPS
    pos = torch.where(greedy, torch.zeros_like(sampled_pos), sampled_pos)
    return top_vals, top_idx, pos


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
    _top_vals, top_idx, pos = _topk_and_pos(
        logits, temperature, top_p, top_k, generator, seeds, steps
    )
    return torch.gather(top_idx, 1, pos[:, None])[:, 0].to(torch.int32)


def sample_tokens_with_logprobs(
    logits: torch.Tensor,  # [B, V]
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] int, 0 => disabled
    generator: Optional[torch.Generator] = None,
    seeds: Optional[torch.Tensor] = None,
    steps: Optional[torch.Tensor] = None,
    num_top: int = 8,
):
    """``sample_tokens`` plus OpenAI-style logprobs.

    Returns ``(tokens [B] int32, chosen_lp [B], top_ids [B, num_top]
    int32, top_lps [B, num_top])``: the log-softmax of ``logits`` as
    given (after the engine's penalties, bias and min-token suppression;
    temperature, top-k and top-p change only the draw, not the reported
    distribution).  The full-vocab logsumexp is the only work beyond
    plain sampling, and the drawn token is the one ``sample_tokens``
    draws from the same noise."""
    top_vals, top_idx, pos = _topk_and_pos(
        logits, temperature, top_p, top_k, generator, seeds, steps
    )
    lse = torch.logsumexp(logits.float(), dim=-1, keepdim=True)
    lps = top_vals - lse  # [B, trunc], sorted desc
    tokens = torch.gather(top_idx, 1, pos[:, None])[:, 0].to(torch.int32)
    chosen_lp = torch.gather(lps, 1, pos[:, None])[:, 0]
    return (
        tokens,
        chosen_lp,
        top_idx[:, :num_top].to(torch.int32),
        lps[:, :num_top],
    )


def verify_and_sample(
    logits: torch.Tensor,  # [R, V] processed (penalized/suppressed) logits
    draft_next: torch.Tensor,  # [R] draft token this row verifies
    is_bonus: torch.Tensor,  # [R] bool: no draft to verify at this row
    temperature: torch.Tensor,  # [R]
    top_p: torch.Tensor,  # [R]
    top_k: torch.Tensor,  # [R] int, 0 => disabled
    generator: Optional[torch.Generator] = None,
    seeds: Optional[torch.Tensor] = None,  # [R] int, -1 => unseeded
    steps: Optional[torch.Tensor] = None,  # [R] per-seq sample index
    num_top: int = 0,
    all_greedy: bool = False,  # every row is temperature 0
):
    """Distribution-preserving speculative verification (rejection
    sampling with a point-mass proposal at the draft ``t``), the
    reference's ``verify_and_sample``: accept ``t`` with probability
    p(t) under the row's own sampling distribution (temperature,
    top-k/top-p over the top-``TRUNC`` slice, as ``sample_tokens``
    draws), else resample from p with ``t`` excluded; the emitted token
    is p-distributed whatever was drafted.  Greedy rows accept iff ``t``
    is the argmax; ``is_bonus`` rows draw a plain sample and accept
    nothing.

    Each row takes one uniform for the acceptance test and ``trunc``
    Gumbels for the draw, from one [R, 1 + trunc] draw: the engine
    generator's, or for a seeded row the (seed, step) hash, so a seeded
    request repeats under speculation.  Returns ``(model_toks [R]
    int32, accept [R] bool, lp_data)``, ``lp_data`` the triple
    ``(chosen_lp [R], top_ids [R, num_top], top_lps [R, num_top])``
    when ``num_top`` > 0, else None."""
    if all_greedy and num_top == 0:
        am = torch.argmax(logits, dim=-1).to(torch.int32)
        return am, (am == draft_next) & ~is_bonus, None
    top_vals, top_idx, masked = _masked_scaled(
        logits, temperature, top_p, top_k
    )
    R, trunc = top_idx.shape
    noise = _uniform((R, 1 + trunc), generator, seeds, steps, logits.device)
    u, gumbel = noise[:, 0], _to_gumbel(noise[:, 1:])
    probs = torch.softmax(masked, dim=-1)  # ineligible entries ~0
    is_draft = top_idx == draft_next[:, None].to(top_idx.dtype)
    p_draft = torch.where(is_draft, probs, torch.zeros_like(probs)).sum(-1)
    greedy = temperature <= _GREEDY_EPS
    accept = torch.where(
        greedy, top_idx[:, 0] == draft_next.to(top_idx.dtype),
        u < p_draft.double(),
    ) & ~is_bonus
    # one Gumbel draw serves the resample (draft excluded: argmax over
    # the residual support renormalizes implicitly) and the bonus sample;
    # a rejected row always has another eligible entry (p(t) = 1 makes
    # rejection impossible)
    exclude = is_draft & ~is_bonus[:, None]
    pos_rs = torch.argmax(
        torch.where(exclude, torch.full_like(masked, -float("inf")), masked)
        + gumbel, dim=-1,
    )
    pos_draft = torch.argmax(is_draft.to(torch.int32), dim=-1)
    pos = torch.where(
        greedy, torch.zeros_like(pos_rs),
        torch.where(accept, pos_draft, pos_rs),
    )
    model_toks = torch.gather(top_idx, 1, pos[:, None])[:, 0].to(torch.int32)
    if num_top > 0:
        lse = torch.logsumexp(logits.float(), dim=-1, keepdim=True)
        lps = top_vals - lse
        chosen_lp = torch.gather(lps, 1, pos[:, None])[:, 0]
        return model_toks, accept, (
            chosen_lp,
            top_idx[:, :num_top].to(torch.int32),
            lps[:, :num_top],
        )
    return model_toks, accept, None


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
