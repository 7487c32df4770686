"""Shape math used across the engine (static-shape discipline for XLA)."""

from __future__ import annotations

from typing import Sequence


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, multiple: int) -> int:
    return cdiv(x, multiple) * multiple


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length; lengths beyond the last bucket raise.

    Buckets keep XLA shapes static: every prefill is padded up to one of a
    fixed set of sequence lengths so at most ``len(buckets)`` prefill programs
    are ever compiled (SURVEY.md section 7 'hard parts': recompile avoidance).
    """
    for bucket in sorted(buckets):
        if length <= bucket:
            return bucket
    raise ValueError(
        f"sequence length {length} exceeds the largest bucket "
        f"{max(buckets)}; raise model.max_model_len / tpu.prefill_buckets"
    )
