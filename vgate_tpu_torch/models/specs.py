"""Architecture specs for the supported model families.

The reference serves whatever vLLM/SGLang can load (opaque to it); here the
architectures are first-party.  Presets cover the north-star configs in
BASELINE.json — Qwen2.5 dense chat models, Mixtral-8x7B (MoE / expert
parallel), bge-base-en-v1.5 (embeddings) — plus Llama-3, Mistral and
Gemma-2 (sliding-window + softcap attention, sandwich norms).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class ModelSpec:
    name: str
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    qkv_bias: bool = True
    tie_embeddings: bool = False
    eos_token_id: int = 151645
    bos_token_id: int = 151643
    # additional model-level stop ids (generation_config eos lists — e.g.
    # Llama-3.1's <|end_of_text|>/<|eom_id|>, Qwen's <|endoftext|>)
    extra_stop_ids: tuple = ()
    # MoE (0 experts => dense)
    num_experts: int = 0
    experts_per_token: int = 0
    # Encoder-only (embeddings) models
    is_encoder: bool = False
    max_position_embeddings: int = 32768
    # Gemma-2 family knobs (defaults reproduce the Qwen/Llama behavior)
    act: str = "silu"  # MLP activation: "silu" | "gelu_tanh"
    attn_softcap: float = 0.0  # tanh soft-capping of attention scores (0=off)
    final_softcap: float = 0.0  # tanh soft-capping of final logits (0=off)
    sliding_window: int = 0  # tokens; >0 => even layers use a local window
    query_scale: float = 0.0  # if >0: q scaled by query_scale**-0.5, not hd**-0.5
    embed_scale: bool = False  # multiply embeddings by sqrt(hidden_size)
    unit_offset_norm: bool = False  # RMSNorm weight convention (1 + w)
    ffn_sandwich: bool = False  # post-attn norm after o_proj + pre/post-FFN norms
    # Llama-3.1 rope scaling (0 = off): low-frequency components slowed by
    # `rope_scaling_factor`, interpolated between the low/high bands.
    rope_scaling_factor: float = 0.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_pos: int = 8192
    # Route 2D packed-int4 weights through the fused dequant Pallas
    # kernel (ops/pallas/quant_matmul.py).  Set per-ENGINE via
    # dataclasses.replace at EngineCore init — the spec rides every
    # forward as a static jit arg, so two engines with different
    # meshes in one process get separate compile caches instead of
    # fighting over a module global.
    quant_kernel: bool = False
    # W8A8/W4A8 (tpu.int8_native): dynamically quantize activations
    # per-token and run the projection GEMMs on the MXU's native
    # s8 x s8 -> s32 path (ops/quant.py int8_native_einsum).  Pure jnp —
    # auto-partitions under any mesh, no Pallas/Mosaic involvement.
    # Threaded per-engine like quant_kernel.
    int8_native: bool = False
    # >1: decode attention serves this many slots per Pallas program
    # (paged_attention.py _blocked_kernel) — cuts grid steps B/BS x and
    # per-program overhead; opt-in via tpu.decode_block_slots until the
    # win is measured on hardware (threaded on the spec like
    # quant_kernel so it reaches the jitted decode as a static arg)
    decode_block_slots: int = 1
    # tensor and expert parallelism (parallel/sharding.py local_spec):
    # the mesh of a rank whose heads and FFN channels above are its own
    # shard; the forwards issue their collectives on its device groups.
    # None = one device, no collective.
    mesh: Any = field(default=None, compare=False, repr=False)
    # expert parallelism (parallel/sharding.py local_spec): the first of
    # this rank's experts and how many it holds; None = every expert
    expert_range: Optional[Tuple[int, int]] = None
    # pipeline parallelism (parallel/sharding.py local_spec): a stage's
    # spec holds its ``num_layers`` layers, the first of them global
    # layer ``first_layer``, and the mesh its relay (parallel/
    # pipeline.py) sends the activations over; None = the whole stack
    first_layer: int = 0
    pipeline: Any = field(default=None, compare=False, repr=False)
    # sequence parallelism (parallel/sharding.py local_spec): the mesh
    # whose sp ranks split the prompt's rows (parallel/ring_attention.py)
    # and the pool's pages (parallel/sp_decode.py); None = no sp
    seq_parallel: Any = field(default=None, compare=False, repr=False)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def num_params(self) -> int:
        """Analytic parameter count (embeddings + decoder stack), used
        for MFU accounting in bench.py.  Matches init_params' layout:
        q/k/v/o (+bias), gate/up/down (per expert for MoE, + router),
        norms, embed, united or separate lm_head."""
        D, L, F = self.hidden_size, self.num_layers, self.intermediate_size
        q_dim = self.num_heads * self.head_dim
        kv_dim = self.num_kv_heads * self.head_dim
        attn = D * q_dim + 2 * D * kv_dim + q_dim * D
        if self.qkv_bias:
            attn += q_dim + 2 * kv_dim
        if self.is_moe:
            mlp = self.num_experts * 3 * D * F + D * self.num_experts
        else:
            mlp = 3 * D * F
        norms = 2 * D + (2 * D if self.ffn_sandwich else 0)
        embed = self.vocab_size * D
        head = 0 if self.tie_embeddings else self.vocab_size * D
        return L * (attn + mlp + norms) + embed + head + D

    @property
    def layer_windows(self) -> tuple:
        """Per-layer attention window (0 = global), indexed by this
        spec's layers.  Gemma-2 alternates: even-indexed layers are
        sliding-window, odd layers are global (HF
        ``Gemma2Config.layer_types``), counted on the global index, so a
        pipeline stage's layer ``l`` takes global layer ``first_layer +
        l``'s window."""
        if self.sliding_window <= 0:
            return tuple(0 for _ in range(self.num_layers))
        return tuple(
            self.sliding_window if i % 2 == 0 else 0
            for i in range(self.first_layer,
                           self.first_layer + self.num_layers)
        )

    @property
    def rope_scaling(self):
        """Tuple for ops/rope.py (None when scaling is off)."""
        if self.rope_scaling_factor <= 0:
            return None
        return (
            self.rope_scaling_factor,
            self.rope_low_freq_factor,
            self.rope_high_freq_factor,
            self.rope_original_max_pos,
        )

    @property
    def uses_local_attention(self) -> bool:
        """True when attention needs window/softcap/scale semantics.  The
        Pallas prefill+decode kernels and ring-attention sp prefill
        implement these natively; the one path that does NOT yet (the
        pipeline-parallel relay) rejects such specs at engine init."""
        return (
            self.sliding_window > 0
            or self.attn_softcap > 0
            or self.query_scale > 0
        )

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


# Dims follow the published HF configs for each model id.
_PRESETS: Dict[str, ModelSpec] = {}


def _register(spec: ModelSpec) -> ModelSpec:
    _PRESETS[spec.name.lower()] = spec
    return spec


QWEN25_05B = _register(
    ModelSpec(
        name="Qwen/Qwen2.5-0.5B-Instruct",
        extra_stop_ids=(151643,),  # <|endoftext|>
        vocab_size=151936,
        hidden_size=896,
        num_layers=24,
        num_heads=14,
        num_kv_heads=2,
        head_dim=64,
        intermediate_size=4864,
        tie_embeddings=True,
    )
)

QWEN25_15B = _register(
    ModelSpec(
        name="Qwen/Qwen2.5-1.5B-Instruct",
        extra_stop_ids=(151643,),  # <|endoftext|>
        vocab_size=151936,
        hidden_size=1536,
        num_layers=28,
        num_heads=12,
        num_kv_heads=2,
        head_dim=128,
        intermediate_size=8960,
        tie_embeddings=True,
    )
)

QWEN25_7B = _register(
    ModelSpec(
        name="Qwen/Qwen2.5-7B-Instruct",
        extra_stop_ids=(151643,),  # <|endoftext|>
        vocab_size=152064,
        hidden_size=3584,
        num_layers=28,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        intermediate_size=18944,
        tie_embeddings=False,
    )
)

MIXTRAL_8X7B = _register(
    ModelSpec(
        name="mistralai/Mixtral-8x7B-Instruct-v0.1",
        vocab_size=32000,
        hidden_size=4096,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        intermediate_size=14336,
        rope_theta=1_000_000.0,
        rms_eps=1e-5,
        qkv_bias=False,
        eos_token_id=2,
        bos_token_id=1,
        num_experts=8,
        experts_per_token=2,
    )
)

LLAMA3_8B = _register(
    ModelSpec(
        name="meta-llama/Meta-Llama-3-8B-Instruct",
        vocab_size=128256,
        hidden_size=4096,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        intermediate_size=14336,
        rope_theta=500_000.0,
        rms_eps=1e-5,
        qkv_bias=False,
        tie_embeddings=False,
        eos_token_id=128009,
        bos_token_id=128000,
        extra_stop_ids=(128001,),  # <|end_of_text|>
        max_position_embeddings=8192,
    )
)

LLAMA31_8B = _register(
    ModelSpec(
        name="meta-llama/Llama-3.1-8B-Instruct",
        vocab_size=128256,
        hidden_size=4096,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        intermediate_size=14336,
        rope_theta=500_000.0,
        rms_eps=1e-5,
        qkv_bias=False,
        tie_embeddings=False,
        eos_token_id=128009,
        bos_token_id=128000,
        extra_stop_ids=(128001, 128008),  # <|end_of_text|>, <|eom_id|>
        max_position_embeddings=131072,
        rope_scaling_factor=8.0,
        rope_low_freq_factor=1.0,
        rope_high_freq_factor=4.0,
        rope_original_max_pos=8192,
    )
)

LLAMA32_1B = _register(
    ModelSpec(
        name="meta-llama/Llama-3.2-1B-Instruct",
        vocab_size=128256,
        hidden_size=2048,
        num_layers=16,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        intermediate_size=8192,
        rope_theta=500_000.0,
        rms_eps=1e-5,
        qkv_bias=False,
        tie_embeddings=True,
        eos_token_id=128009,
        bos_token_id=128000,
        extra_stop_ids=(128001, 128008),  # <|end_of_text|>, <|eom_id|>
        max_position_embeddings=131072,
        rope_scaling_factor=32.0,
        rope_low_freq_factor=1.0,
        rope_high_freq_factor=4.0,
        rope_original_max_pos=8192,
    )
)

MISTRAL_7B = _register(
    ModelSpec(
        name="mistralai/Mistral-7B-Instruct-v0.3",
        vocab_size=32768,
        hidden_size=4096,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        intermediate_size=14336,
        rope_theta=1_000_000.0,
        rms_eps=1e-5,
        qkv_bias=False,
        tie_embeddings=False,
        eos_token_id=2,
        bos_token_id=1,
    )
)

GEMMA2_2B = _register(
    ModelSpec(
        name="google/gemma-2-2b-it",
        vocab_size=256000,
        hidden_size=2304,
        num_layers=26,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        intermediate_size=9216,
        rope_theta=10_000.0,
        rms_eps=1e-6,
        qkv_bias=False,
        tie_embeddings=True,
        eos_token_id=107,  # <end_of_turn> — the -it turn-end token
        bos_token_id=2,
        extra_stop_ids=(1,),  # <eos>
        max_position_embeddings=8192,
        act="gelu_tanh",
        attn_softcap=50.0,
        final_softcap=30.0,
        sliding_window=4096,
        query_scale=256.0,
        embed_scale=True,
        unit_offset_norm=True,
        ffn_sandwich=True,
    )
)

GEMMA2_9B = _register(
    ModelSpec(
        name="google/gemma-2-9b-it",
        vocab_size=256000,
        hidden_size=3584,
        num_layers=42,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        intermediate_size=14336,
        rope_theta=10_000.0,
        rms_eps=1e-6,
        qkv_bias=False,
        tie_embeddings=True,
        eos_token_id=107,  # <end_of_turn> — the -it turn-end token
        bos_token_id=2,
        extra_stop_ids=(1,),  # <eos>
        max_position_embeddings=8192,
        act="gelu_tanh",
        attn_softcap=50.0,
        final_softcap=30.0,
        sliding_window=4096,
        query_scale=256.0,
        embed_scale=True,
        unit_offset_norm=True,
        ffn_sandwich=True,
    )
)

BGE_BASE = _register(
    ModelSpec(
        name="BAAI/bge-base-en-v1.5",
        vocab_size=30522,
        hidden_size=768,
        num_layers=12,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        intermediate_size=3072,
        is_encoder=True,
        qkv_bias=True,
        eos_token_id=102,
        bos_token_id=101,
        max_position_embeddings=512,
    )
)

# Tiny variants for CPU tests and compile checks.
TINY_DENSE = _register(
    ModelSpec(
        name="tiny-dense",
        vocab_size=512,
        hidden_size=64,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        intermediate_size=128,
        rope_theta=10000.0,
        eos_token_id=0,
        bos_token_id=1,
        tie_embeddings=False,
    )
)

TINY_MOE = _register(
    replace(
        TINY_DENSE,
        name="tiny-moe",
        num_experts=4,
        experts_per_token=2,
        qkv_bias=False,  # mixtral-family attention has no qkv bias
        rms_eps=1e-5,
    )
)

TINY_GEMMA2 = _register(
    ModelSpec(
        name="tiny-gemma2",
        vocab_size=512,
        hidden_size=64,
        num_layers=2,  # layer 0 sliding, layer 1 global
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,  # q_dim 128 != hidden 64: exercises decoupled head_dim
        intermediate_size=128,
        rope_theta=10_000.0,
        rms_eps=1e-6,
        qkv_bias=False,
        tie_embeddings=True,
        eos_token_id=0,
        bos_token_id=1,
        act="gelu_tanh",
        attn_softcap=50.0,
        final_softcap=30.0,
        sliding_window=8,
        query_scale=16.0,  # != head_dim: exercises the custom q scale
        embed_scale=True,
        unit_offset_norm=True,
        ffn_sandwich=True,
    )
)

TINY_ENCODER = _register(
    replace(
        TINY_DENSE,
        name="tiny-encoder",
        is_encoder=True,
        num_kv_heads=4,
        max_position_embeddings=512,
    )
)


def spec_for_model_id(model_id: str) -> ModelSpec:
    """The preset of ``model_id``; ``<preset>@<n>`` names the preset cut
    to its first ``n`` layers at full width (every process of a mesh or
    a pod resolves it alike)."""
    key = model_id.lower()
    if key in _PRESETS:
        return _PRESETS[key]
    # Allow bare names ("qwen2.5-1.5b-instruct") without the org prefix.
    for name, spec in _PRESETS.items():
        if name.split("/")[-1] == key:
            return spec
    base, _, depth = model_id.rpartition("@")
    if base and depth.isdigit():
        spec = spec_for_model_id(base)
        if 0 < int(depth) <= spec.num_layers:
            return replace(spec, name=model_id, num_layers=int(depth))
    raise KeyError(
        f"no architecture preset for {model_id!r}; known: "
        f"{sorted(_PRESETS)}"
    )
