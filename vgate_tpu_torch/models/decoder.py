"""The dense decoder families (Qwen2.x / Llama-3 / Mistral, and Gemma-2
with its sliding windows, softcaps and sandwich norms) in PyTorch.

Parameters keep the reference's stacked layout (vgate_tpu/models/
decoder.py ``init_params``): one dict of ``[L, ...]`` tensors, weights
``[in, out]``, so ``runtime/weights.py`` carries a JAX tree over as is.
The forwards run a Python loop over the layers; each layer's pool slice
``k_pages[l]`` is a view, and the KV writes update the pools IN PLACE
(the reference donates them through its jitted calls instead).  Padded
positions and idle decode slots write the reserved trash page 0, which
is never read as live context.

Attention goes through the kernel wrappers (ops/kernels/): the CUDA
kernels for tensors on the card, their plain versions on the CPU.  The
projections, MLP and lm_head go through ``weighted_einsum``
(ops/quant.py): library matrix products for plain weights, as the
reference leaves them to XLA, and the dequant-matmul kernels (K4 int8,
K5 int4) for quantized ones.  int8 KV pools (``QuantPages``) quantize on
every write (``kv_write``) and reach the int8 modes of K1 and K3.  With
``spec.decode_block_slots > 1`` decode attention runs K6, the blocked
grid.  Speculative verification (``spec_verify_forward``) scores a
slot's current token and its drafts in one pass through K3.  Every
attention call takes the layer's window (``spec.layer_windows``, 0 =
global), the attention softcap and the query scale.  MoE is not ported
yet; the config rejects it.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch

from vgate_tpu_torch.models.specs import ModelSpec
from vgate_tpu_torch.ops.kernels.flash_prefill import flash_prefill_attention
from vgate_tpu_torch.ops.attention import _softcap
from vgate_tpu_torch.ops.kernels.paged_decode import (
    paged_decode_attention,
    paged_decode_attention_blocked,
)
from vgate_tpu_torch.ops.kernels.paged_multitok import paged_multitok_attention
from vgate_tpu_torch.ops.kv_quant import KVPool, kv_write
from vgate_tpu_torch.ops.norms import rms_norm
from vgate_tpu_torch.ops.quant import weighted_einsum
from vgate_tpu_torch.ops.rope import apply_rope

Params = Dict[str, Any]


def init_params(
    spec: ModelSpec,
    generator: torch.Generator,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cpu",
) -> Params:
    """Random-init the parameter dict (std 0.02 normal, drawn in fp32 on
    ``device`` from ``generator``); the zero-egress path benchmarks use —
    throughput does not depend on weight values."""
    if spec.is_moe:
        raise NotImplementedError("MoE init is not ported yet")
    D, L = spec.hidden_size, spec.num_layers
    H, KV, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    F, V = spec.intermediate_size, spec.vocab_size

    def normal(*shape):
        x = torch.randn(
            shape, generator=generator, dtype=torch.float32, device=device
        )
        return (x * 0.02).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    # Gemma's RMSNorm stores a delta around 1 (unit_offset_norm), so the
    # identity init is zeros there, ones elsewhere
    def norm_init(*shape):
        if spec.unit_offset_norm:
            return zeros(*shape)
        return torch.ones(shape, dtype=dtype, device=device)

    layers: Dict[str, Any] = {
        "input_norm": norm_init(L, D),
        "post_norm": norm_init(L, D),
        "q": {"w": normal(L, D, H * hd)},
        "k": {"w": normal(L, D, KV * hd)},
        "v": {"w": normal(L, D, KV * hd)},
        "o": {"w": normal(L, H * hd, D)},
        "gate": {"w": normal(L, D, F)},
        "up": {"w": normal(L, D, F)},
        "down": {"w": normal(L, F, D)},
    }
    if spec.qkv_bias:
        layers["q"]["b"] = zeros(L, H * hd)
        layers["k"]["b"] = zeros(L, KV * hd)
        layers["v"]["b"] = zeros(L, KV * hd)
    if spec.ffn_sandwich:
        layers["pre_ffn_norm"] = norm_init(L, D)
        layers["post_ffn_norm"] = norm_init(L, D)
    params: Params = {
        "embed": normal(V, D),
        "layers": layers,
        "final_norm": norm_init(D),
    }
    if not spec.tie_embeddings:
        params["lm_head"] = normal(D, V)
    return params


def _layer_slice(t, l: int):
    """Layer ``l`` of a stacked leaf: a view, or for a quantized weight
    the same kind of weight over views (2D values, [out] scale)."""
    if isinstance(t, tuple):  # QTensor / PackedQTensor
        return type(t)(*(part[l] for part in t))
    return t[l]


def layer_params(params: Params, l: int) -> Params:
    """Layer ``l``'s parameters: views into the stacked tensors."""
    return {
        name: (
            {k: _layer_slice(t, l) for k, t in val.items()}
            if isinstance(val, dict) else val[l]
        )
        for name, val in params["layers"].items()
    }


def _project_qkv(x: torch.Tensor, lp: Params, spec: ModelSpec):
    """x: [..., D] -> q [..., H, hd], k/v [..., KV, hd]."""
    q = weighted_einsum("...d,dh->...h", x, lp["q"]["w"])
    k = weighted_einsum("...d,dh->...h", x, lp["k"]["w"])
    v = weighted_einsum("...d,dh->...h", x, lp["v"]["w"])
    if spec.qkv_bias:
        q = q + lp["q"]["b"]
        k = k + lp["k"]["b"]
        v = v + lp["v"]["b"]
    q = q.reshape(*q.shape[:-1], spec.num_heads, spec.head_dim)
    k = k.reshape(*k.shape[:-1], spec.num_kv_heads, spec.head_dim)
    v = v.reshape(*v.shape[:-1], spec.num_kv_heads, spec.head_dim)
    return q, k, v


def _norm(x: torch.Tensor, w: torch.Tensor, spec: ModelSpec) -> torch.Tensor:
    return rms_norm(x, w, spec.rms_eps, spec.unit_offset_norm)


def _act(x32: torch.Tensor, spec: ModelSpec) -> torch.Tensor:
    """MLP activation in fp32: SiLU (Qwen/Llama) or tanh-approximate GELU
    (Gemma's ``gelu_pytorch_tanh``)."""
    if spec.act == "gelu_tanh":
        return torch.nn.functional.gelu(x32, approximate="tanh")
    return torch.nn.functional.silu(x32)


def _dense_mlp(x: torch.Tensor, lp: Params, spec: ModelSpec) -> torch.Tensor:
    gate = weighted_einsum("...d,df->...f", x, lp["gate"]["w"])
    up = weighted_einsum("...d,df->...f", x, lp["up"]["w"])
    act = _act(gate.float(), spec).to(x.dtype)
    return weighted_einsum("...f,fd->...d", act * up, lp["down"]["w"])


def _finish_layer(h, attn, lp: Params, spec: ModelSpec):
    """Layer back half: o-projection residual + post-norm MLP residual.
    With ``ffn_sandwich`` (Gemma-2) the post-attention norm applies to the
    attention OUTPUT before the residual add, and the MLP is wrapped in
    its own pre/post norms."""
    attn = attn.reshape(*h.shape[:-1], spec.q_dim)
    attn_out = weighted_einsum("...h,hd->...d", attn, lp["o"]["w"])
    if spec.ffn_sandwich:
        h = h + _norm(attn_out, lp["post_norm"], spec)
        mlp = _dense_mlp(_norm(h, lp["pre_ffn_norm"], spec), lp, spec)
        return h + _norm(mlp, lp["post_ffn_norm"], spec)
    h = h + attn_out
    return h + _dense_mlp(_norm(h, lp["post_norm"], spec), lp, spec)


def _logits(params: Params, spec: ModelSpec, x: torch.Tensor) -> torch.Tensor:
    """Final norm + lm_head: the fp32 accumulation, never rounded to the
    model dtype (the reference's ``preferred_element_type=jnp.float32``,
    which it passes through its quantized branch too), then the final
    softcap.  Tied embeddings are never quantized; their transpose is a
    view, which the fp32-out product takes as it is."""
    x = _norm(x, params["final_norm"], spec)
    w = params["embed"].t() if spec.tie_embeddings else params["lm_head"]
    logits = weighted_einsum(
        "...d,dv->...v", x, w, preferred_element_type=torch.float32
    )
    return _softcap(logits, spec.final_softcap)


def _query_scale(spec: ModelSpec) -> Optional[float]:
    """Gemma-2's ``query_pre_attn_scalar`` as a query scale; None selects
    the default hd**-0.5 inside the attention ops."""
    return spec.query_scale ** -0.5 if spec.query_scale > 0 else None


def attn_options(spec: ModelSpec, layer: int) -> Dict[str, Any]:
    """Layer ``layer``'s attention keywords: its window (0 = global), the
    attention softcap and the query scale."""
    return {"window": spec.layer_windows[layer],
            "softcap": spec.attn_softcap, "scale": _query_scale(spec)}


def _embed(params: Params, spec: ModelSpec, tokens: torch.Tensor):
    x = params["embed"][tokens.long()]
    if spec.embed_scale:
        # Gemma scales embeddings by sqrt(hidden), cast to the model dtype
        # BEFORE the multiply (the HF convention the reference keeps)
        x = x * torch.tensor(spec.hidden_size ** 0.5, dtype=x.dtype)
    return x


def _rope(x, positions, spec: ModelSpec):
    return apply_rope(x, positions, spec.rope_theta, spec.rope_scaling)


def qkv(h: torch.Tensor, lp: Params, spec: ModelSpec, positions):
    """Layer front half: input norm, qkv projection and rope at
    ``positions`` ([..., S] matching h's leading dims)."""
    q, k, v = _project_qkv(_norm(h, lp["input_norm"], spec), lp, spec)
    return _rope(q, positions, spec), _rope(k, positions, spec), v


def _prefill_qkv_write(
    h: torch.Tensor,  # [B, S, D]
    lp: Params,
    spec: ModelSpec,
    positions: torch.Tensor,  # [B, S] global positions
    page_tables: torch.Tensor,  # [B, S // ps (+1 with offsets)]
    k_pool: KVPool,  # [KV, P, ps, hd] one layer's pool, in place
    v_pool: KVPool,
    offsets: Optional[torch.Tensor] = None,  # [B] first token's page slot
):
    """Prompt-pass front half: norm, qkv projection and rope at
    ``positions``, then this layer's KV into its pages (trash page 0
    absorbs padding).  Returns q [B, S, H, hd] and the fresh k, v
    [B, S, KV, hd].

    Without ``offsets`` every row starts on a page boundary and whole
    pages are written: [B, S, KV, hd] -> [KV, B, n_pages, ps, hd], each
    head's pages contiguous.  With ``offsets`` (copy-on-write, the
    reference's unaligned write) row ``b``'s first token lands at slot
    ``offsets[b]`` of its first page, whose head holds copied shared KV
    that must not be clobbered, so the write is a per-token (page, slot)
    scatter and ``page_tables`` carries one extra column."""
    B, S = h.shape[:2]
    ps = k_pool.shape[-2]
    KV, hd = spec.num_kv_heads, spec.head_dim
    q, k, v = qkv(h, lp, spec, positions)
    if offsets is not None:
        idx = offsets.long()[:, None] + torch.arange(S, device=h.device)
        slot = idx % ps
        pages = torch.gather(page_tables.long(), 1, idx // ps)  # [B, S]
        # advanced indices (dims 1, 2) are adjacent: value [KV, B, S, hd]
        kv_write(k_pool, (slice(None), pages, slot), k.permute(2, 0, 1, 3))
        kv_write(v_pool, (slice(None), pages, slot), v.permute(2, 0, 1, 3))
        return q, k, v
    n_pages = S // ps
    pt = page_tables[:, :n_pages].long()
    kv_write(k_pool, (slice(None), pt),
             k.reshape(B, n_pages, ps, KV, hd).permute(3, 0, 1, 2, 4))
    kv_write(v_pool, (slice(None), pt),
             v.reshape(B, n_pages, ps, KV, hd).permute(3, 0, 1, 2, 4))
    return q, k, v


def _last_logits(params, spec, x, lens) -> torch.Tensor:
    """Logits of each row's last real token (``lens - 1``)."""
    B, S = x.shape[:2]
    last = torch.clamp(lens.long() - 1, 0, S - 1)
    return _logits(params, spec, x[torch.arange(B, device=x.device), last])


def prefill_forward(
    params: Params,
    spec: ModelSpec,
    tokens: torch.Tensor,  # [B, S] padded to a bucket; S % page_size == 0
    seq_lens: torch.Tensor,  # [B] int32
    k_pages: KVPool,  # [L, KV, P, ps, hd], updated in place
    v_pages: KVPool,
    page_tables: torch.Tensor,  # [B, S // ps] page ids for this prompt
) -> torch.Tensor:
    """The prompt pass: writes every layer's KV into the prompt's pages
    and returns the last real token's logits [B, V] (fp32)."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    x = _embed(params, spec, tokens)  # [B, S, D]
    for l in range(spec.num_layers):
        lp = layer_params(params, l)
        q, k, v = _prefill_qkv_write(x, lp, spec, positions, page_tables,
                                     k_pages[l], v_pages[l])
        attn = flash_prefill_attention(q, k, v, seq_lens,
                                       **attn_options(spec, l))
        x = _finish_layer(x, attn, lp, spec)
    return _last_logits(params, spec, x, seq_lens)


def decode_attn_inputs(positions, page_tables, active, page_size):
    """Per-slot KV write targets for one decode step; inactive slots
    write the reserved trash page 0."""
    B = positions.shape[0]
    seq_lens = (positions + 1).to(torch.int32)
    page_slot = (positions // page_size).long()
    page_off = (positions % page_size).long()
    page_ids = page_tables[torch.arange(B, device=positions.device), page_slot]
    if active is not None:
        page_ids = torch.where(active, page_ids, torch.zeros_like(page_ids))
    return seq_lens, page_ids.long(), page_off


def decode_forward(
    params: Params,
    spec: ModelSpec,
    tokens: torch.Tensor,  # [B] current token per slot
    positions: torch.Tensor,  # [B] 0-indexed position of `tokens`
    k_pages: KVPool,  # [L, KV, P, ps, hd], updated in place
    v_pages: KVPool,
    page_tables: torch.Tensor,  # [B, pages_per_seq] int32
    active: Optional[torch.Tensor] = None,  # [B] bool; inactive -> page 0
) -> torch.Tensor:
    """One continuous-batching decode step: returns logits [B, V] (fp32)
    after writing each layer's new K/V at ``positions``.  Attention runs
    K1, or K6 (``block_slots`` slots per CTA) when
    ``spec.decode_block_slots > 1``."""
    ps = k_pages.shape[3]
    seq_lens, page_ids, page_off = decode_attn_inputs(
        positions, page_tables, active, ps
    )
    if spec.decode_block_slots > 1:
        attention = functools.partial(paged_decode_attention_blocked,
                                      block_slots=spec.decode_block_slots)
    else:
        attention = paged_decode_attention
    x = _embed(params, spec, tokens)  # [B, D]
    pos = positions[:, None]
    for l in range(spec.num_layers):
        lp = layer_params(params, l)
        q, k, v = qkv(x[:, None], lp, spec, pos)
        q, k, v = q[:, 0], k[:, 0], v[:, 0]
        # [B, KV, hd] -> [KV, B, hd] at (page_ids, page_off)
        kv_write(k_pages[l], (slice(None), page_ids, page_off),
                 k.transpose(0, 1))
        kv_write(v_pages[l], (slice(None), page_ids, page_off),
                 v.transpose(0, 1))
        attn = attention(q.contiguous(), k_pages[l], v_pages[l], page_tables,
                         seq_lens, **attn_options(spec, l))
        x = _finish_layer(x, attn, lp, spec)
    return _logits(params, spec, x)


def prefill_suffix_forward(
    params: Params,
    spec: ModelSpec,
    tokens: torch.Tensor,  # [B, S] suffix tokens, S a bucket, S % ps == 0
    prefix_lens: torch.Tensor,  # [B] int32 tokens already resident
    suffix_lens: torch.Tensor,  # [B] int32 real suffix tokens (<= S)
    k_pages: KVPool,  # [L, KV, P, ps, hd], updated in place
    v_pages: KVPool,
    suffix_page_tables: torch.Tensor,  # [B, S // ps (+1 if unaligned)]
    ctx_page_tables: torch.Tensor,  # [B, ctx_pages] int32 prefix + suffix
    unaligned: bool = False,  # copy-on-write: prefix_lens % ps != 0
) -> torch.Tensor:
    """The prompt pass of only the uncached suffix of a prefix-cache hit,
    a copy-on-write hit or a prefill chunk: the first ``prefix_lens``
    tokens' KV is already in the pool.  Each layer writes the suffix KV
    into its own pages (the aligned whole-page write, or with
    ``unaligned`` the per-token scatter starting mid-page), then its
    suffix queries attend the context window through the multi-token
    kernel (K3; its plain version on the CPU).  Returns the last real
    token's logits [B, V] (fp32).

    The reference routes only page-aligned suffixes of at most 1024 rows
    through its TPU kernel (VMEM and DMA-alignment limits); the CUDA
    kernel tiles query rows over CTAs and masks by position, so every
    suffix pass on the card takes it."""
    B, S = tokens.shape
    ps = k_pages.shape[3]
    positions = prefix_lens.long()[:, None] + torch.arange(
        S, device=tokens.device
    )
    offsets = prefix_lens % ps if unaligned else None
    x = _embed(params, spec, tokens)  # [B, S, D]
    for l in range(spec.num_layers):
        lp = layer_params(params, l)
        q, _, _ = _prefill_qkv_write(
            x, lp, spec, positions, suffix_page_tables, k_pages[l],
            v_pages[l], offsets=offsets,
        )
        attn = paged_multitok_attention(
            q, k_pages[l], v_pages[l], ctx_page_tables, prefix_lens,
            suffix_lens, **attn_options(spec, l),
        )
        x = _finish_layer(x, attn, lp, spec)
    return _last_logits(params, spec, x, suffix_lens)


def spec_verify_forward(
    params: Params,
    spec: ModelSpec,
    tokens: torch.Tensor,  # [B, S]: [current, draft_1, ..., draft_{S-1}]
    positions0: torch.Tensor,  # [B] int32 global position of tokens[:, 0]
    input_lens: torch.Tensor,  # [B] int32 1 + real drafts this row (<= S)
    k_pages: KVPool,  # [L, KV, P, ps, hd], updated in place
    v_pages: KVPool,
    page_tables: torch.Tensor,  # [B, pages_per_seq] int32
    active: Optional[torch.Tensor] = None,  # [B] bool; inactive -> page 0
) -> torch.Tensor:
    """Speculative-decoding verification (runtime/speculative.py): score
    the ``S`` candidates of every slot in one pass over the paged pools.
    Each layer writes the candidates' KV at positions ``positions0 + j``
    (clamped into the table; rows past ``input_lens`` and inactive slots
    write trash page 0) by the per-token scatter, as ``positions0`` is
    arbitrary, then the rows attend their context through the
    multi-token kernel (K3, or K3-int8 on int8 pools) with
    ``input_lens`` as the row count.  Candidates past the accepted
    prefix leave KV beyond the sequence's new length, which later steps
    mask and overwrite.  Returns fp32 logits [B, S, V]."""
    B, S = tokens.shape
    ps = k_pages.shape[3]
    width = page_tables.shape[1]
    j = torch.arange(S, device=tokens.device)
    # overshoot rows stay in bounds (their writes are trashed anyway)
    positions = torch.clamp(positions0.long()[:, None] + j[None, :],
                            max=width * ps - 1)
    write_ok = j[None, :] < input_lens[:, None]
    if active is not None:
        write_ok = write_ok & active[:, None]
    page_ids = torch.gather(page_tables.long(), 1, positions // ps)
    page_ids = torch.where(write_ok, page_ids, torch.zeros_like(page_ids))
    page_off = positions % ps
    x = _embed(params, spec, tokens)  # [B, S, D]
    for l in range(spec.num_layers):
        lp = layer_params(params, l)
        q, k, v = qkv(x, lp, spec, positions)
        # advanced indices (dims 1, 2) are adjacent: value [KV, B, S, hd]
        kv_write(k_pages[l], (slice(None), page_ids, page_off),
                 k.permute(2, 0, 1, 3))
        kv_write(v_pages[l], (slice(None), page_ids, page_off),
                 v.permute(2, 0, 1, 3))
        attn = paged_multitok_attention(
            q.contiguous(), k_pages[l], v_pages[l], page_tables, positions0,
            input_lens, **attn_options(spec, l),
        )
        x = _finish_layer(x, attn, lp, spec)
    return _logits(params, spec, x)
