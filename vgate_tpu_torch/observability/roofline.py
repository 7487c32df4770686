"""Device peak table + HBM roofline / MFU math, a copy of
vgate_tpu/observability/roofline.py for the port.

The engine's live gauges (observability/perf.py -> ``vgt_decode_mfu`` /
``vgt_decode_hbm_roofline_pct``) read their peaks here, and so will the
port's benchmark.  Peaks are per card; unknown device kinds return None
so callers omit the roofline fields rather than mislabel them.  The
table keeps the reference's TPU rows and adds the H100 under the name
``torch.cuda.get_device_name`` gives.  :func:`stream_weight_bytes`
walks the port's parameter tree of torch tensors.

Modeling conventions (shared by bench.py and the live gauges):

* one decode step streams the weights once (untied embedding tables are
  GATHERED row-wise, not streamed — callers exclude them via
  :func:`stream_weight_bytes`) plus reads every resident token's K+V;
* MFU charges 2 FLOPs per parameter per generated token;
* both are optimistic lower bounds on traffic/compute, which is exactly
  what a roofline denominator should be.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

# device_kind -> (bf16 FLOP/s, HBM GB/s) per chip
DEVICE_PEAKS = {
    "TPU v5 lite": (197e12, 819.0),
    "TPU v5e": (197e12, 819.0),
    "TPU v6 lite": (918e12, 1640.0),
    "TPU v6e": (918e12, 1640.0),
    "TPU v5p": (459e12, 2765.0),
    "TPU v5": (459e12, 2765.0),
    "TPU v4": (275e12, 1228.0),
    # the name torch.cuda.get_device_name gives: dense bf16 tensor-core
    # peak and HBM3 bandwidth of the SXM part (data sheet), the figures
    # chip_smoke.py bounds the kernels by
    "NVIDIA H100 80GB HBM3": (989e12, 3350.0),
}


def peaks_for(device_kind: str) -> Optional[Tuple[float, float]]:
    return DEVICE_PEAKS.get(device_kind)


def kv_bytes_per_token(
    num_layers: int,
    kv_heads: int,
    head_dim: int,
    dtype_bytes: int = 2,
    scale_bytes: int = 0,
) -> int:
    """HBM bytes one resident token's K+V occupies across all layers —
    what every later decode step must READ back per context token.
    ``scale_bytes`` is the int8-KV per-token-per-head overhead
    (runtime/kv_cache._page_bytes uses the identical formula per page)."""
    return 2 * num_layers * kv_heads * (head_dim * dtype_bytes + scale_bytes)


def decode_step_bytes(
    weight_bytes: int,
    batch: int,
    ctx_tokens: int,
    kv_token_bytes: int,
) -> int:
    """Approximate HBM traffic of ONE decode step: stream the weights
    once plus read every slot's live KV context (writes are one token
    per slot — noise).  An optimistic lower bound (no re-reads, perfect
    caching), which is exactly what a roofline denominator should be."""
    return weight_bytes + batch * ctx_tokens * kv_token_bytes


def roofline_row(
    ms_per_step: float,
    step_bytes: int,
    device_kind: str,
) -> dict:
    """The per-row roofline fields bench_decode_ablate attaches:
    achieved HBM GB/s over the step's modeled traffic, and the percent
    of the device's HBM peak that represents.  Empty for unknown
    devices or non-timed rows."""
    if ms_per_step <= 0:
        return {}
    peaks = peaks_for(device_kind)
    achieved_gbps = step_bytes / (ms_per_step / 1e3) / 1e9
    row = {"achieved_hbm_gbps": round(achieved_gbps, 1)}
    if peaks is not None:
        row["pct_of_hbm_roofline"] = round(
            100.0 * achieved_gbps / peaks[1], 1
        )
    return row


def _tensors(node: Any):
    """Every tensor of a parameter tree: dicts, lists and tuples (the
    quantized ``QTensor``/``PackedQTensor`` nodes among them) walked in
    order."""
    if isinstance(node, dict):
        for value in node.values():
            yield from _tensors(value)
    elif isinstance(node, (list, tuple)):
        for value in node:
            yield from _tensors(value)
    elif node is not None:
        yield node


def param_bytes(node: Any) -> int:
    """Bytes of every tensor of a parameter tree."""
    return sum(t.numel() * t.element_size() for t in _tensors(node))


def stream_weight_bytes(params: Any, tie_embeddings: bool) -> int:
    """Bytes of weights one decode step must STREAM from HBM: the full
    tree minus an untied embedding table (gathered one row per token,
    not read fully; tied models read it as lm_head so it stays in).
    Accepts the engine's parameter tree of torch tensors."""
    total = param_bytes(params)
    if not tie_embeddings and isinstance(params, dict) and "embed" in params:
        total -= param_bytes(params["embed"])
    return total


@dataclasses.dataclass(frozen=True)
class EngineRoofline:
    """The static geometry the live gauges need, captured once at engine
    build (observability/perf.py holds one; bench.py derives the same
    numbers ad hoc).  ``num_chips`` scales the per-chip peaks to the
    serving mesh; dp replicas each carry their own (their meshes are
    disjoint)."""

    device_kind: str
    num_chips: int
    num_params: int
    # weights streamed per decode step (stream_weight_bytes)
    weight_stream_bytes: int
    kv_token_bytes: int

    def peaks(self) -> Optional[Tuple[float, float]]:
        return peaks_for(self.device_kind)

    def step_bytes(self, ctx_tokens: int) -> int:
        """Modeled HBM traffic of one decode step over ``ctx_tokens``
        TOTAL resident context tokens (already summed over the batch)."""
        return decode_step_bytes(
            self.weight_stream_bytes, 1, ctx_tokens, self.kv_token_bytes
        )

    def mfu(self, tokens_per_s: float) -> Optional[float]:
        """Achieved FLOP/s over the mesh's peak at 2 FLOPs per param per
        generated token; None off the peak table."""
        peaks = self.peaks()
        if peaks is None or tokens_per_s <= 0:
            return None
        return (2.0 * self.num_params * tokens_per_s) / (
            peaks[0] * max(1, self.num_chips)
        )

    def hbm_roofline_pct(
        self, bytes_moved: float, device_s: float
    ) -> Optional[float]:
        """Percent of the mesh's HBM peak the modeled decode traffic
        achieved over ``device_s`` seconds of host-observed device time;
        None off the peak table or without timed device work."""
        peaks = self.peaks()
        if peaks is None or device_s <= 0 or bytes_moved <= 0:
            return None
        achieved_gbps = bytes_moved / device_s / 1e9
        return 100.0 * achieved_gbps / (
            peaks[1] * max(1, self.num_chips)
        )

    def to_dict(self) -> Dict[str, Any]:
        peaks = self.peaks()
        return {
            "device_kind": self.device_kind,
            "num_chips": self.num_chips,
            "num_params": self.num_params,
            "weight_stream_bytes": self.weight_stream_bytes,
            "kv_token_bytes": self.kv_token_bytes,
            "peak_flops": peaks[0] if peaks else None,
            "peak_hbm_gbps": peaks[1] if peaks else None,
        }
