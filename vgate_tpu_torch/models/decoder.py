"""The decoder families (Qwen2.x / Llama-3 / Mistral dense, Mixtral MoE,
and Gemma-2 with its sliding windows, softcaps and sandwich norms) in
PyTorch.

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
global), the attention softcap and the query scale.

A MoE layer (``_moe_mlp``) routes each token to its top-k experts by
the reference's sort-based dispatch into per-expert ``[E, capacity, D]``
buffers, every step of it on the device without a host sync, so it runs
inside a decode graph.  Quantized experts run K4/K5 one expert at a time
on that expert's 2D weight; with ``spec.int8_native`` (W8A8/W4A8) every
eligible projection but the lm_head runs the int8 product instead.

Under tensor parallelism (``spec.mesh``, parallel/sharding.py
``local_spec``) the forwards run on a rank's shard: its query and kv
heads, its FFN channels and, when tp divides the vocab, its rows of the
embedding and columns of the lm_head.  Under expert parallelism a rank
holds ``spec.expert_range``'s experts of every MoE layer.  The
collectives are all here: the vocab-parallel lookup's all-reduce
(``_embed``), an all-reduce right after the o product and after a dense
down product (``_reduce``, over the tp group), a MoE layer's one
all-reduce over the expert group (``_moe_mlp``), and the fp32 logits'
all-gather before the final softcap (``_logits``).  With no mesh none is
issued, and at tp 1 no tp collective.  A pipeline stage or an sp rank
that is itself an ep x tp group issues the same collectives on its own
groups (parallel/mesh.py), besides the relay's sends or the sp ones.

The prompt pass and the decode step are each three parts: the embedding
(``_embed``), a run over the spec's layers that writes their pools
(``prefill_layers``, ``decode_layers``) and the logits (``_logits``).
Under pipeline parallelism a stage's spec (``spec.pipeline``,
parallel/sharding.py ``local_spec``) holds its own layers, and
``prefill_forward`` / ``decode_forward`` route through the relay
(parallel/pipeline.py), which runs those parts stage by stage, as the
reference routes a pp mesh.

Under sequence parallelism (``spec.seq_parallel``, parallel/sharding.py
``local_spec``) every rank holds the whole model and its shard of the
pool's pages.  The prompt pass (:func:`sp_prefill_forward`) runs the
rank's ``S/sp`` rows of the prompt through every layer, attention by the
ring (parallel/ring_attention.py), and brings each row's last hidden to
sp rank 0.  Decode, suffix and chunk rows are replicated over sp: every
rank runs each row's projections and MLP, and attention writes the KV on
the page's owner and merges the ranks' partials (parallel/sp_decode.py).
Rank 0 alone computes the logits; the other ranks' forwards return None.
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
from vgate_tpu_torch.ops.quant import (
    int8_native_experts,
    is_quantized_weight,
    stack_layers,
    weighted_einsum,
)
from vgate_tpu_torch.ops.rope import apply_rope

Params = Dict[str, Any]


def init_params(
    spec: ModelSpec,
    generator: torch.Generator,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cpu",
    quantization: Optional[str] = None,
    mesh=None,
) -> Params:
    """Random-init the parameter dict (std 0.02 normal, drawn in fp32 on
    ``device`` from ``generator``); the zero-egress path benchmarks use —
    throughput does not depend on weight values.

    Each leaf passes, as soon as it is drawn whole, through the keep
    hook (parallel/sharding.py ``leaf_keeper``): with ``quantization``
    (int8/int4) it is quantized, and on ``mesh`` (a rank's mesh of more
    than one rank) the rank keeps its shard.  The draws, and so the
    values and the quantization scales, stay those of the whole tree.

    A dense spec draws each stacked leaf whole.  A MoE spec draws its
    stacked weights one layer at a time, each layer quantized and cut to
    the rank's shard (its experts and F slice) as soon as it is drawn,
    into preallocated stacks, so the full-precision tree never sits
    whole on ``device`` (Mixtral-8x7B's experts are 90 GB in bf16, 45 GB
    in int8) and a rank never holds more of another rank's experts than
    the layer being drawn.  A pipeline stage keeps its layers of every
    stacked leaf (each MoE layer is still drawn, in order) and, past
    stage 0, no embedding, final norm or head."""
    from vgate_tpu_torch.parallel.sharding import leaf_keeper, stage_layers

    D, L = spec.hidden_size, spec.num_layers
    H, KV, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    F, V = spec.intermediate_size, spec.vocab_size
    keep = leaf_keeper(spec, mesh, quantization)
    kept = stage_layers(spec, mesh)

    def normal(*shape):
        x = torch.randn(
            shape, generator=generator, dtype=torch.float32, device=device
        )
        return x.mul_(0.02).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    # Gemma's RMSNorm stores a delta around 1 (unit_offset_norm), so the
    # identity init is zeros there, ones elsewhere
    def norm_init(*shape):
        if spec.unit_offset_norm:
            return zeros(*shape)
        return torch.ones(shape, dtype=dtype, device=device)

    layers: Dict[str, Any] = {
        name: keep(("layers", name), norm_init(L, D))
        for name in ("input_norm", "post_norm")
    }
    if spec.is_moe:
        E = spec.num_experts
        names = ("q", "k", "v", "o", "router", "gate", "up", "down")
        shapes = ((D, H * hd), (D, KV * hd), (D, KV * hd), (H * hd, D),
                  (D, E), (E, D, F), (E, D, F), (E, F, D))
        for name, shape in zip(names, shapes):
            router = name == "router"
            path = ("layers", name) if router else ("layers", name, "w")
            w = stack_layers(
                lambda l: keep(path, normal(*shape), lead=0), L, kept)
            layers[name] = w if router else {"w": w}
    else:
        # drawn in this order, each leaf whole
        for name, shape in (("q", (L, D, H * hd)), ("k", (L, D, KV * hd)),
                            ("v", (L, D, KV * hd)), ("o", (L, H * hd, D)),
                            ("gate", (L, D, F)), ("up", (L, D, F)),
                            ("down", (L, F, D))):
            layers[name] = {"w": keep(("layers", name, "w"), normal(*shape))}
    if spec.qkv_bias:
        for name, width in (("q", H * hd), ("k", KV * hd), ("v", KV * hd)):
            layers[name]["b"] = keep(("layers", name, "b"), zeros(L, width))
    if spec.ffn_sandwich:
        for name in ("pre_ffn_norm", "post_ffn_norm"):
            layers[name] = keep(("layers", name), norm_init(L, D))
    params: Params = {
        "embed": keep(("embed",), normal(V, D)),
        "layers": layers,
        "final_norm": keep(("final_norm",), norm_init(D)),
    }
    if not spec.tie_embeddings:
        params["lm_head"] = keep(("lm_head",), normal(D, V))
    return {k: v for k, v in params.items() if v is not None}


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
    i8 = spec.int8_native
    q = weighted_einsum("...d,dh->...h", x, lp["q"]["w"], int8_native=i8)
    k = weighted_einsum("...d,dh->...h", x, lp["k"]["w"], int8_native=i8)
    v = weighted_einsum("...d,dh->...h", x, lp["v"]["w"], int8_native=i8)
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
    """MLP activation in fp32: SiLU (Qwen/Llama/Mixtral) or
    tanh-approximate GELU (Gemma's ``gelu_pytorch_tanh``)."""
    if spec.act == "gelu_tanh":
        return torch.nn.functional.gelu(x32, approximate="tanh")
    return torch.nn.functional.silu(x32)


def _reduce(x: torch.Tensor, spec: ModelSpec) -> torch.Tensor:
    """Sum a row-parallel product's partial results over the rank's tp
    group (in place; no collective at tp 1)."""
    if spec.mesh is None or spec.mesh.tp == 1:
        return x
    return spec.mesh.all_reduce(x)


def _dense_mlp(x: torch.Tensor, lp: Params, spec: ModelSpec) -> torch.Tensor:
    """gate/up column-parallel over F, down row-parallel: under tp each
    rank's F/tp channels give a partial sum, reduced right after the
    down product."""
    i8 = spec.int8_native
    gate = weighted_einsum("...d,df->...f", x, lp["gate"]["w"],
                           int8_native=i8)
    up = weighted_einsum("...d,df->...f", x, lp["up"]["w"], int8_native=i8)
    act = _act(gate.float(), spec).to(x.dtype)
    return _reduce(weighted_einsum("...f,fd->...d", act * up,
                                   lp["down"]["w"], int8_native=i8), spec)


# each expert einsum's one-expert form: a 2D [in, out] contraction
_EXPERT_MATMUL = {"ecd,edf->ecf": "...d,df->...f",
                  "ecf,efd->ecd": "...f,fd->...d"}


def _expert_einsum(subscripts: str, x: torch.Tensor, w,
                   int8_native: bool = False) -> torch.Tensor:
    """Per-expert einsum over ``x [E, C, in]`` with plain or quantized
    expert weights ``[E, in, out]`` (under ep a rank's ``E/ep`` experts
    and their rows of ``x``).  Plain weights are one batched
    product.  A quantized weight runs one expert at a time on that
    expert's 2D weight and ``[out]`` scale: through ``weighted_einsum``
    (K4/K5 on the card, their plain versions on the CPU), or with
    ``int8_native`` the W8A8/W4A8 int8 products
    (``int8_native_experts``)."""
    if not is_quantized_weight(w):
        return torch.einsum(subscripts, x, w)
    one = _EXPERT_MATMUL[subscripts]
    if int8_native:
        return int8_native_experts(one, x, w)
    return torch.stack([
        weighted_einsum(one, x[e], type(w)(*(part[e] for part in w)))
        for e in range(x.shape[0])
    ])


def _route(xt: torch.Tensor, router: torch.Tensor, k: int):
    """Each token row's top-``k`` experts: the router's softmax in fp32,
    the ``k`` largest probabilities (the lower expert first on a tie, as
    ``lax.top_k``) renormalized to sum to one.  Returns ``(gate_vals
    f32 [T, k], gate_idx [T, k])``."""
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[:, :k], gate_idx[:, :k]
    return gate_vals / gate_vals.sum(dim=-1, keepdim=True), gate_idx


def _moe_mlp(x: torch.Tensor, lp: Params, spec: ModelSpec,
             capacity_factor: float = 2.0) -> torch.Tensor:
    """Top-k expert routing with the reference's sort-based dispatch.

    The ``T*K`` (token, expert) assignments are stably sorted by expert
    and scattered into per-expert ``[E, capacity + 1 trash, D]`` buffers
    at their place in the expert's group; an assignment past an expert's
    capacity lands in the trash column and is dropped (its residual
    passes through).  The capacity comes from the flat ``T`` of the
    call, pad rows included, as in the reference, so callers pass the
    reference's padded shapes.  The router (:func:`_route`) runs in
    fp32.  No step reads the
    device from the host (counts by ``scatter_add_``, masks by
    ``torch.where``), so a decode graph captures it; the combine adds
    the K = 2 contributions of a token in the activation dtype, in
    either order exactly.

    On a mesh (``spec.mesh``) every rank holds every token (the KV pool
    and the attention are replicated over ep), so each builds the whole
    dispatch and no token all-to-all is needed; the rank runs only its
    experts' rows (``spec.expert_range``) over its F slice, combines only
    their contributions, and one all-reduce over the expert group sums the
    other experts and the tp ranks' F partials.  With K = 2 a token's
    output is at most two non-zero partials plus zeros, so at tp 1 the
    reduce gives the one-rank sum exactly.  Under pp and sp the expert
    group is that of the rank's stage or sp index.

    The capacity counts the call's rows: under sp a ring pass's are the
    rank's ``S/sp`` rows of the prompt, where the reference's counts the
    whole prompt's (a deliberate difference, equal wherever no expert
    overflows, as on ``tiny-moe``)."""
    orig_shape = x.shape
    D = orig_shape[-1]
    xt = x.reshape(-1, D)
    T, dev = xt.shape[0], x.device
    E, K = spec.num_experts, spec.experts_per_token
    capacity = max(4, int((T * K / E) * capacity_factor + 0.5))

    gate_vals, gate_idx = _route(xt, lp["router"], K)

    TK = T * K
    sorted_expert, order = torch.sort(gate_idx.reshape(TK), stable=True)
    sorted_token = torch.div(order, K, rounding_mode="floor")
    sorted_gate = gate_vals.reshape(TK)[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, sorted_expert, torch.ones_like(sorted_expert)
    )
    starts = torch.cumsum(counts, 0) - counts  # first sorted index
    pos = torch.arange(TK, device=dev) - starts[sorted_expert]
    within = pos < capacity

    buf = torch.zeros((E, capacity + 1, D), dtype=xt.dtype, device=dev)
    buf[sorted_expert, torch.clamp(pos, max=capacity)] = xt[sorted_token]
    expert_in = buf[:, :capacity]  # [E, C, D]
    first, n = spec.expert_range or (0, E)
    if n != E:
        # this rank's experts; the others' assignments contribute zeros
        expert_in = expert_in[first:first + n]
        within = within & (sorted_expert >= first) & (
            sorted_expert < first + n)
    i8 = spec.int8_native
    gate_h = _expert_einsum("ecd,edf->ecf", expert_in, lp["gate"]["w"], i8)
    up_h = _expert_einsum("ecd,edf->ecf", expert_in, lp["up"]["w"], i8)
    act = _act(gate_h.float(), spec).to(xt.dtype) * up_h
    expert_out = _expert_einsum("ecf,efd->ecd", act, lp["down"]["w"], i8)

    local = torch.clamp(sorted_expert - first, 0, n - 1)
    contrib = expert_out[local, torch.clamp(pos, max=capacity - 1)]
    contrib = torch.where(within[:, None], contrib,
                          torch.zeros_like(contrib))
    out = torch.zeros((T, D), dtype=xt.dtype, device=dev).index_add_(
        0, sorted_token, contrib * sorted_gate[:, None].to(xt.dtype)
    )
    if spec.mesh is not None:
        out = spec.mesh.all_reduce(out, experts=True)
    return out.reshape(orig_shape)


def _mlp(x: torch.Tensor, lp: Params, spec: ModelSpec) -> torch.Tensor:
    return _moe_mlp(x, lp, spec) if spec.is_moe else _dense_mlp(x, lp, spec)


def _finish_layer(h, attn, lp: Params, spec: ModelSpec):
    """Layer back half: o-projection residual + post-norm MLP residual.
    With ``ffn_sandwich`` (Gemma-2) the post-attention norm applies to the
    attention OUTPUT before the residual add, and the MLP is wrapped in
    its own pre/post norms.  Under tp the o product's partial sums are
    reduced right after it, before Gemma-2's post-attention norm, which
    is not linear."""
    attn = attn.reshape(*h.shape[:-1], spec.q_dim)
    attn_out = _reduce(weighted_einsum("...h,hd->...d", attn, lp["o"]["w"],
                                       int8_native=spec.int8_native), spec)
    if spec.ffn_sandwich:
        h = h + _norm(attn_out, lp["post_norm"], spec)
        mlp = _mlp(_norm(h, lp["pre_ffn_norm"], spec), lp, spec)
        return h + _norm(mlp, lp["post_ffn_norm"], spec)
    h = h + attn_out
    return h + _mlp(_norm(h, lp["post_norm"], spec), lp, spec)


def _logits(params: Params, spec: ModelSpec, x: torch.Tensor) -> torch.Tensor:
    """Final norm + lm_head: the fp32 accumulation, never rounded to the
    model dtype (the reference's ``preferred_element_type=jnp.float32``,
    which it passes through its quantized branch too), then the final
    softcap.  Tied embeddings are never quantized; their transpose is a
    view, which the fp32-out product takes as it is.  The lm_head never
    takes W8A8 (``int8_native``), as in the reference: per-token
    activation rounding could flip a greedy argmax between near-tied
    logits.  A vocab-sharded head (tp > 1 dividing V) gives each rank its
    columns of the fp32 logits, all-gathered before the final softcap."""
    x = _norm(x, params["final_norm"], spec)
    w = params["embed"].t() if spec.tie_embeddings else params["lm_head"]
    logits = weighted_einsum(
        "...d,dv->...v", x, w, preferred_element_type=torch.float32
    )
    if spec.mesh is not None and logits.shape[-1] != spec.vocab_size:
        logits = spec.mesh.all_gather_last(logits)
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
    """The embedding lookup.  A vocab-sharded table (tp > 1 dividing V)
    holds rows ``rank*V/tp ..``: each rank looks up the tokens it holds,
    zeroes the others, and the all-reduce sums the one nonzero row of
    each token, exactly.  Gemma's scale comes after the reduce."""
    table = params["embed"]
    ids = tokens.long()
    if spec.mesh is not None and table.shape[0] != spec.vocab_size:
        rows = table.shape[0]
        ids = ids - spec.mesh.tp_rank * rows
        held = (ids >= 0) & (ids < rows)
        x = table[torch.clamp(ids, 0, rows - 1)]
        x = spec.mesh.all_reduce(
            torch.where(held[..., None], x, torch.zeros_like(x))
        )
    else:
        x = table[ids]
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


def prefill_layers(
    params: Params,
    spec: ModelSpec,
    x: torch.Tensor,  # [B, S, D] the prompt's activations
    seq_lens: torch.Tensor,  # [B] int32
    k_pages: KVPool,  # [L, KV, P, ps, hd], updated in place
    v_pages: KVPool,
    page_tables: torch.Tensor,  # [B, S // ps] page ids for this prompt
) -> torch.Tensor:
    """Every layer of ``spec`` (a pipeline stage's own) over the prompt's
    activations: writes each layer's KV into the prompt's pages and
    returns the activations after the last layer."""
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    for l in range(spec.num_layers):
        lp = layer_params(params, l)
        q, k, v = _prefill_qkv_write(x, lp, spec, positions, page_tables,
                                     k_pages[l], v_pages[l])
        attn = flash_prefill_attention(q, k, v, seq_lens,
                                       **attn_options(spec, l))
        x = _finish_layer(x, attn, lp, spec)
    return x


def prefill_forward(
    params: Params,
    spec: ModelSpec,
    tokens: torch.Tensor,  # [B, S] padded to a bucket; S % page_size == 0
    seq_lens: torch.Tensor,  # [B] int32
    k_pages: KVPool,  # [L, KV, P, ps, hd], updated in place
    v_pages: KVPool,
    page_tables: torch.Tensor,  # [B, S // ps] page ids for this prompt
) -> Optional[torch.Tensor]:
    """The prompt pass: writes every layer's KV into the prompt's pages
    and returns the last real token's logits [B, V] (fp32).  A pipeline
    stage's spec (``spec.pipeline``) routes it through the relay
    (parallel/pipeline.py), as the reference routes a pp mesh: stage 0
    returns the logits, the other stages None."""
    if spec.pipeline is not None:
        from vgate_tpu_torch.parallel.pipeline import pp_prefill_forward

        return pp_prefill_forward(params, spec, tokens, seq_lens, k_pages,
                                  v_pages, page_tables)
    if spec.seq_parallel is not None:
        return sp_prefill_forward(params, spec, tokens, seq_lens, k_pages,
                                  v_pages, page_tables)
    x = _embed(params, spec, tokens)  # [B, S, D]
    x = prefill_layers(params, spec, x, seq_lens, k_pages, v_pages,
                       page_tables)
    return _last_logits(params, spec, x, seq_lens)


def _sp_logits(params: Params, spec: ModelSpec,
               x: torch.Tensor) -> Optional[torch.Tensor]:
    """The logits on sp rank 0 (it alone samples), None on the others."""
    if spec.seq_parallel.sp_rank != 0:
        return None
    return _logits(params, spec, x)


def sp_prefill_forward(
    params: Params,
    spec: ModelSpec,
    tokens: torch.Tensor,  # [B, S] the whole prompt batch, S % sp == 0
    seq_lens: torch.Tensor,  # [B] int32
    k_pages: KVPool,  # [L, KV, P/sp, ps, hd] this rank's shard, in place
    v_pages: KVPool,
    page_tables: torch.Tensor,  # [B, S // ps] GLOBAL page ids
) -> Optional[torch.Tensor]:
    """The prompt pass under sp: the reference's ring route of
    ``prefill_forward``.  Sp rank r runs rows ``[r*S/sp, (r+1)*S/sp)``
    through every layer (their positions global), attention by the ring,
    which also writes the pages of every block this rank owns
    (parallel/ring_attention.py).  Each row's last real token lives on
    one rank: its hidden reaches rank 0 by a sum over sp of every rank's
    (zeros where the rank does not hold it, so the sum is exact), and
    rank 0 returns the fp32 logits [B, V]; the other ranks None."""
    from vgate_tpu_torch.parallel.ring_attention import (
        ring_prefill_attention,
    )

    mesh = spec.seq_parallel
    B, S = tokens.shape
    if S % mesh.sp:
        raise ValueError(f"sequence {S} not divisible by sp={mesh.sp}")
    n = S // mesh.sp
    first = mesh.sp_rank * n
    dev = tokens.device
    x = _embed(params, spec, tokens[:, first:first + n])  # [B, n, D]
    positions = (first + torch.arange(n, device=dev))[None, :].expand(B, n)
    for l in range(spec.num_layers):
        lp = layer_params(params, l)
        q, k, v = qkv(x, lp, spec, positions)
        attn = ring_prefill_attention(
            q, k, v, seq_lens, mesh, pools=(k_pages[l], v_pages[l],
                                            page_tables),
            **attn_options(spec, l))
        x = _finish_layer(x, attn, lp, spec)
    at = torch.clamp(seq_lens.long() - 1, 0, S - 1) - first
    held = (at >= 0) & (at < n)
    last = x[torch.arange(B, device=dev), torch.clamp(at, 0, n - 1)]
    # over the sp group: a tp rank holds the whole hidden (its group
    # reduced it after o and down)
    last = mesh.sp_all_reduce(
        torch.where(held[:, None], last, torch.zeros_like(last)))
    return _sp_logits(params, spec, last)


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


def decode_layers(
    params: Params,
    spec: ModelSpec,
    x: torch.Tensor,  # [B, D] the step's activations
    positions: torch.Tensor,  # [B] 0-indexed position of the step's token
    k_pages: KVPool,  # [L, KV, P, ps, hd], updated in place
    v_pages: KVPool,
    page_tables: torch.Tensor,  # [B, pages_per_seq] int32
    attn_inputs,  # decode_attn_inputs' (seq_lens, page_ids, page_off)
) -> torch.Tensor:
    """Every layer of ``spec`` (a pipeline stage's own) over one decode
    step's activations: writes each layer's new K/V at ``positions`` and
    returns the activations after the last layer.  Attention runs K1, or
    K6 (``block_slots`` slots per CTA) when ``spec.decode_block_slots``
    > 1; under sp the write and K1-sp's partials over the rank's pages,
    merged over sp (parallel/sp_decode.py; ``decode_block_slots`` is not
    used there, as in the reference)."""
    seq_lens, page_ids, page_off = attn_inputs
    sp_mesh = spec.seq_parallel
    if sp_mesh is not None:
        from vgate_tpu_torch.parallel.sp_decode import (
            sp_decode_attention_and_write,
        )
    if spec.decode_block_slots > 1:
        attention = functools.partial(paged_decode_attention_blocked,
                                      block_slots=spec.decode_block_slots)
    else:
        attention = paged_decode_attention
    pos = positions[:, None]
    for l in range(spec.num_layers):
        lp = layer_params(params, l)
        q, k, v = qkv(x[:, None], lp, spec, pos)
        q, k, v = q[:, 0], k[:, 0], v[:, 0]
        if sp_mesh is not None:
            attn = sp_decode_attention_and_write(
                q, k, v, k_pages[l], v_pages[l], page_ids, page_off,
                page_tables, seq_lens, sp_mesh, **attn_options(spec, l))
            x = _finish_layer(x, attn, lp, spec)
            continue
        # [B, KV, hd] -> [KV, B, hd] at (page_ids, page_off)
        kv_write(k_pages[l], (slice(None), page_ids, page_off),
                 k.transpose(0, 1))
        kv_write(v_pages[l], (slice(None), page_ids, page_off),
                 v.transpose(0, 1))
        attn = attention(q.contiguous(), k_pages[l], v_pages[l], page_tables,
                         seq_lens, **attn_options(spec, l))
        x = _finish_layer(x, attn, lp, spec)
    return x


def decode_forward(
    params: Params,
    spec: ModelSpec,
    tokens: torch.Tensor,  # [B] current token per slot
    positions: torch.Tensor,  # [B] 0-indexed position of `tokens`
    k_pages: KVPool,  # [L, KV, P, ps, hd], updated in place
    v_pages: KVPool,
    page_tables: torch.Tensor,  # [B, pages_per_seq] int32
    active: Optional[torch.Tensor] = None,  # [B] bool; inactive -> page 0
) -> Optional[torch.Tensor]:
    """One continuous-batching decode step: returns logits [B, V] (fp32)
    after writing each layer's new K/V at ``positions``
    (:func:`decode_layers`).  A pipeline stage's spec routes it through
    the relay, as :func:`prefill_forward` does."""
    if spec.pipeline is not None:
        from vgate_tpu_torch.parallel.pipeline import pp_decode_forward

        return pp_decode_forward(params, spec, tokens, positions, k_pages,
                                 v_pages, page_tables, active)
    attn_inputs = decode_attn_inputs(positions, page_tables, active,
                                     k_pages.shape[3])
    x = _embed(params, spec, tokens)  # [B, D]
    x = decode_layers(params, spec, x, positions, k_pages, v_pages,
                      page_tables, attn_inputs)
    if spec.seq_parallel is not None:
        return _sp_logits(params, spec, x)
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
    suffix pass on the card takes it.

    Under sp each layer writes the suffix pages this rank owns and
    merges K3-sp's partials over the ranks' context pages (parallel/
    sp_decode.py ``sp_suffix_attention_and_write``); copy-on-write is off
    there, so the suffix is page-aligned.  Rank 0 returns the logits, the
    other ranks None."""
    B, S = tokens.shape
    ps = k_pages.shape[3]
    positions = prefix_lens.long()[:, None] + torch.arange(
        S, device=tokens.device
    )
    offsets = prefix_lens % ps if unaligned else None
    x = _embed(params, spec, tokens)  # [B, S, D]
    sp_mesh = spec.seq_parallel
    if sp_mesh is not None:
        from vgate_tpu_torch.parallel.sp_decode import (
            sp_suffix_attention_and_write,
        )

        if unaligned:
            raise ValueError("copy-on-write is off under sp: the suffix "
                             "pass is page-aligned")
        total_lens = prefix_lens + suffix_lens
        for l in range(spec.num_layers):
            lp = layer_params(params, l)
            q, k, v = qkv(x, lp, spec, positions)
            attn = sp_suffix_attention_and_write(
                q, k, v, k_pages[l], v_pages[l], suffix_page_tables,
                ctx_page_tables, prefix_lens, total_lens, sp_mesh,
                **attn_options(spec, l))
            x = _finish_layer(x, attn, lp, spec)
        at = torch.clamp(suffix_lens.long() - 1, 0, S - 1)
        return _sp_logits(params, spec,
                          x[torch.arange(B, device=x.device), at])
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
