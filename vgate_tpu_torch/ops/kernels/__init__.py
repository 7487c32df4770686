"""Hand-written CUDA kernels and their wrappers."""

from typing import Dict


def launch_counts(reset: bool = False) -> Dict[str, int]:
    """Each kernel wrapper's launch count in this process, by wrapper
    name (``reset``: then set every count to 0).  The counts live in the
    wrappers of the process that launched them, so a pod worker reports
    its own."""
    from vgate_tpu_torch.ops.kernels.flash_prefill import (
        flash_prefill_attention,
        flash_prefill_partial,
    )
    from vgate_tpu_torch.ops.kernels.leaf_digest import leaf_digest
    from vgate_tpu_torch.ops.kernels.paged_decode import (
        paged_decode_attention,
        paged_decode_attention_blocked,
        paged_decode_attention_int8,
        paged_decode_partial,
    )
    from vgate_tpu_torch.ops.kernels.paged_multitok import (
        paged_multitok_attention,
        paged_multitok_attention_int8,
        paged_multitok_partial,
    )
    from vgate_tpu_torch.ops.kernels.quant_matmul import (
        int4_matmul,
        int8_matmul,
    )

    wrappers = (
        paged_decode_attention, flash_prefill_attention,
        paged_multitok_attention, paged_decode_attention_int8,
        paged_multitok_attention_int8, int8_matmul, int4_matmul,
        paged_decode_attention_blocked, leaf_digest, paged_decode_partial,
        flash_prefill_partial, paged_multitok_partial,
    )
    from vgate_tpu_torch.ops.kernels import _build

    with _build._count_lock:
        out = {w.__name__: int(w.launches) for w in wrappers}
        if reset:
            for w in wrappers:
                w.launches = 0
    return out
