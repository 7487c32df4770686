"""Rotary position embeddings (rotate-half formulation, the HF
Qwen2/Llama convention), including the Llama-3.1 long-context
frequency scaling."""

from __future__ import annotations

import math

import torch


def rope_frequencies(
    head_dim: int, theta: float = 10000.0, scaling=None, device=None
) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2], fp32.

    ``scaling`` is the Llama-3.1 rule as a tuple
    ``(factor, low_freq_factor, high_freq_factor, original_max_pos)``:
    low-frequency components are slowed by ``factor``, high-frequency
    ones kept, and the band in between interpolated.
    """
    exponent = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim
    )
    inv_freq = 1.0 / (theta ** exponent)
    if scaling is None:
        return inv_freq
    factor, low_f, high_f, orig_max = scaling
    low_wavelen = orig_max / low_f
    high_wavelen = orig_max / high_f
    wavelen = 2.0 * math.pi / inv_freq
    smooth = (orig_max / wavelen - low_f) / (high_f - low_f)
    mid = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    return torch.where(
        wavelen > low_wavelen,
        inv_freq / factor,
        torch.where(wavelen < high_wavelen, inv_freq, mid),
    )


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float = 10000.0,
    scaling=None,
) -> torch.Tensor:
    """Rotate ``x`` of shape [..., seq, heads, head_dim] by per-token
    angles; ``positions`` broadcasts to x.shape[:-2].  fp32 math,
    returned in the input dtype."""
    head_dim = x.shape[-1]
    inv_freq = rope_frequencies(head_dim, theta, scaling, device=x.device)
    angles = positions.float()[..., None] * inv_freq  # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
