"""Normalization layers."""

from __future__ import annotations

import torch


def rms_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    eps: float = 1e-6,
    unit_offset: bool = False,
) -> torch.Tensor:
    """RMSNorm with fp32 math, cast back to the input dtype (the HF
    Qwen2 convention).  ``unit_offset`` selects the Gemma convention
    where the stored weight is a delta around 1."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    w32 = weight.float()
    if unit_offset:
        w32 = w32 + 1.0
    return (normed * w32).to(x.dtype)
