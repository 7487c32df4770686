"""Weights: carry a parameter tree over, load a checkpoint, or init.

The port keeps the reference's stacked parameter layout (``[L, in, out]``
weights, vgate_tpu/models/decoder.py ``init_params``), so a JAX tree
converted to numpy maps leaf for leaf (:func:`params_from_jax`).  HF
state dicts (``[out, in]`` linear weights) are transposed into the same
layout (:func:`params_from_torch_state_dict`, the HF ``Qwen2ForCausalLM``,
``MixtralForCausalLM`` and ``Gemma2ForCausalLM`` names of the reference's
runtime/weights.py).  ``model.quantization`` (int8/int4) quantizes a
checkpoint and a random init a leaf at a time as it loads or is drawn,
a MoE model's experts a layer at a time, because Mixtral-8x7B's experts
do not fit the card in bf16; :func:`quantize_params` quantizes a tree
that was handed in already built (a tree from the reference), one leaf
at a time (ops/quant.py ``quantize_decoder_params``).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from vgate_tpu_torch.logging_config import get_logger
from vgate_tpu_torch.models.specs import ModelSpec
from vgate_tpu_torch.ops.quant import (
    BITS,
    PackedQTensor,
    QTensor,
    quantize_decoder_params,
    stack_layers,
)

logger = get_logger(__name__)

Params = Dict[str, Any]
TensorGetter = Callable[[str], torch.Tensor]


def _to_tensor(x, device, dtype=None) -> torch.Tensor:
    """A numpy leaf on ``device``, cast to ``dtype`` (None keeps it)."""
    arr = np.asarray(x)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)  # ml_dtypes bfloat16 from JAX
    return torch.from_numpy(np.array(arr, copy=True)).to(
        device=device, dtype=dtype
    )


def params_from_jax(
    np_tree: Params,
    spec: ModelSpec,
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
) -> Params:
    """The reference's params pytree (leaves as numpy, e.g. via
    ``jax.tree.map(np.asarray, params)``) as the port's parameters.  A
    quantized tree's ``QTensor``/``PackedQTensor`` nodes (NamedTuples
    there) carry over as the port's, their int8 ``q``, uint8
    ``q_packed`` and f32 scales kept as they are, never cast to
    ``dtype``.  A Gemma-2 tree carries its sandwich norms
    (``pre_ffn_norm``, ``post_ffn_norm``) and, with tied embeddings, no
    ``lm_head``.  A MoE tree carries its ``router`` [L, D, E] and its
    expert stacks [L, E, in, out] (quantized: ``[L, E, out]`` scales).
    The encoder's tree (models/encoder.py, ``spec`` an encoder) carries
    over leaf for leaf the same way."""

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        fields = getattr(node, "_fields", None)
        if fields in (QTensor._fields, PackedQTensor._fields):
            kind = QTensor if fields == QTensor._fields else PackedQTensor
            return kind(*(_to_tensor(part, device) for part in node))
        return _to_tensor(node, device, dtype)

    return conv(np_tree)


def params_from_getter(
    spec: ModelSpec,
    getter: TensorGetter,
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.bfloat16,
    quantization: Optional[str] = None,
    mesh=None,
) -> Params:
    """Assemble the stacked parameter dict from HF-named tensors, one
    layer at a time.  A Mixtral tree maps ``block_sparse_moe.gate`` to
    the router and experts ``w1``/``w3``/``w2`` to gate/up/down, each
    transposed to ``[in, out]``.  Each layer (and each whole leaf)
    passes through the keep hook as it loads (parallel/sharding.py
    ``leaf_keeper``): with ``quantization`` (int8/int4) it is quantized,
    equal to quantizing the whole tree afterwards, and on ``mesh`` (a
    rank's mesh of more than one rank) the rank keeps its shard: a
    pipeline stage reads only its own layers, and past stage 0 no
    embedding, final norm or head."""
    from vgate_tpu_torch.parallel.sharding import leaf_keeper, stage_layers

    L = spec.num_layers
    pre = "model.layers.{}."
    keep = leaf_keeper(spec, mesh, quantization)
    kept = stage_layers(spec, mesh)
    stage0 = kept.start == 0

    def get(name):
        return getter(name).to(device=device, dtype=dtype)

    def stack(template: str, path, transpose: bool = False):
        def layer(i):
            if i not in kept:
                return None
            w = get(template.format(i))
            return keep(path, w.t() if transpose else w, lead=0)
        return stack_layers(layer, L, kept)

    def proj(name: str, key: str):
        return stack(pre + name + ".weight", ("layers", key, "w"), True)

    layers: Dict[str, Any] = {
        "input_norm": stack(pre + "input_layernorm.weight",
                            ("layers", "input_norm")),
        "post_norm": stack(pre + "post_attention_layernorm.weight",
                           ("layers", "post_norm")),
        "q": {"w": proj("self_attn.q_proj", "q")},
        "k": {"w": proj("self_attn.k_proj", "k")},
        "v": {"w": proj("self_attn.v_proj", "v")},
        "o": {"w": proj("self_attn.o_proj", "o")},
    }
    if spec.is_moe:
        moe = pre + "block_sparse_moe."
        layers["router"] = stack(moe + "gate.weight", ("layers", "router"),
                                 transpose=True)

        def experts(w_name: str, key: str):
            def layer(i):
                if i not in kept:
                    return None
                return keep(("layers", key, "w"), torch.stack([
                    get(f"{moe}experts.{e}.{w_name}.weight".format(i)).t()
                    for e in range(spec.num_experts)
                ]), lead=0)
            return stack_layers(layer, L, kept)

        layers["gate"] = {"w": experts("w1", "gate")}
        layers["up"] = {"w": experts("w3", "up")}
        layers["down"] = {"w": experts("w2", "down")}
    else:
        layers["gate"] = {"w": proj("mlp.gate_proj", "gate")}
        layers["up"] = {"w": proj("mlp.up_proj", "up")}
        layers["down"] = {"w": proj("mlp.down_proj", "down")}
    if spec.qkv_bias:
        for key in ("q", "k", "v"):
            layers[key]["b"] = stack(pre + f"self_attn.{key}_proj.bias",
                                     ("layers", key, "b"))
    if spec.ffn_sandwich:
        # Gemma-2 sandwich norms (HF Gemma2ForCausalLM names)
        for key, name in (("pre_ffn_norm", "pre_feedforward_layernorm"),
                          ("post_ffn_norm", "post_feedforward_layernorm")):
            layers[key] = stack(pre + name + ".weight", ("layers", key))
    if not stage0:
        return {"layers": layers}
    params: Params = {
        "embed": keep(("embed",),
                      get("model.embed_tokens.weight").contiguous()),
        "layers": layers,
        "final_norm": get("model.norm.weight").contiguous(),
    }
    if not spec.tie_embeddings:
        params["lm_head"] = keep(("lm_head",),
                                 get("lm_head.weight").t().contiguous())
    return params


def params_from_torch_state_dict(
    spec: ModelSpec,
    state_dict,
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
) -> Params:
    """Build params from an in-memory HF torch state dict."""
    return params_from_getter(
        spec, lambda name: state_dict[name].detach(), device, dtype
    )


def params_from_safetensors(
    spec: ModelSpec,
    checkpoint_path: str,
    device: torch.device | str,
    dtype: torch.dtype,
    quantization: Optional[str] = None,
    mesh=None,
) -> Params:
    """Load a local directory of ``*.safetensors`` shards (``mesh`` as
    in :func:`params_from_getter`).  Needs the ``safetensors`` package,
    imported here so the port runs without it."""
    try:
        from safetensors import safe_open
    except ImportError as exc:
        raise RuntimeError(
            f"loading {checkpoint_path} needs the safetensors package"
        ) from exc
    files = sorted(
        os.path.join(checkpoint_path, f)
        for f in os.listdir(checkpoint_path)
        if f.endswith(".safetensors")
    )
    if not files:
        raise FileNotFoundError(
            f"no .safetensors files under {checkpoint_path}"
        )
    handles = [safe_open(f, framework="pt") for f in files]
    index = {name: h for h in handles for name in h.keys()}

    def getter(name: str) -> torch.Tensor:
        if name not in index and "model." + name in index:
            name = "model." + name
        if name not in index:
            raise KeyError(f"tensor {name} missing from checkpoint")
        return index[name].get_tensor(name)

    params = params_from_getter(spec, getter, device, dtype, quantization,
                                mesh)
    logger.info(
        "checkpoint loaded",
        extra={"extra_data": {"path": checkpoint_path, "files": len(files)}},
    )
    return params


def load_digests(params: Params) -> Dict[str, Any]:
    """Per-leaf digests of a loaded tree, summarized for the load log:
    weight provenance, so a later checksum-mismatch report can tell
    "wrong on disk" from "flipped on the card".  The serving baseline is
    recorded after quantization by ``EngineIntegrity``; these describe
    the tree as loaded.  The reference copies each leaf to the host
    (``host_leaf_digest``); here a leaf on the card reduces there, with
    the same value bit for bit (integrity.py ``leaf_digest``), so a 7B
    tree is not walked by numpy at every engine start."""
    from vgate_tpu_torch.integrity import digest_summary, tree_digests

    return digest_summary(tree_digests(params))


def load_or_init_params(
    spec: ModelSpec,
    checkpoint_path: Optional[str],
    device: torch.device,
    dtype: torch.dtype,
    seed: int = 0,
    log_digests: bool = False,
    quantization: Optional[str] = None,
    shard: Optional[Any] = None,
) -> Params:
    """Checkpoint when one exists on disk, random init from ``seed``
    otherwise (the zero-egress path; the init runs on ``device``).
    ``quantization`` quantizes each leaf (a MoE model's expert leaves,
    each layer) as it is read or drawn, whole, so its scales are the
    whole tree's; ``shard`` (a mesh rank's mesh) then keeps only that
    rank's shard of it (parallel/sharding.py ``leaf_keeper``), so a rank
    holds at most one full leaf (layer) at a time and its values equal a
    one-rank engine's.

    ``log_digests`` (``integrity.enabled`` callers) logs the load-time
    digest summary (:func:`load_digests`) — one host pass over the tree,
    paid once at load."""
    from vgate_tpu_torch import faults

    faults.check("weight_load", payload=checkpoint_path)
    if checkpoint_path and os.path.isdir(checkpoint_path):
        params = params_from_safetensors(spec, checkpoint_path, device, dtype,
                                         quantization, shard)
    else:
        from vgate_tpu_torch.models.decoder import init_params

        logger.warning(
            "no checkpoint found; using random-init weights",
            extra={"extra_data": {"model": spec.name,
                                  "path": checkpoint_path}},
        )
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = init_params(spec, gen, dtype=dtype, device=device,
                             quantization=quantization, mesh=shard)
    if log_digests:
        try:
            logger.info(
                "load-time weight digests",
                extra={"extra_data": load_digests(params)},
            )
        except Exception:  # digest provenance must never block a load
            logger.warning("load-time digest pass failed", exc_info=True)
    return params


def quantize_params(params: Params, spec: ModelSpec, quantization: str):
    """``model.quantization`` (``int8``/``int4``) right after loading, as
    the reference's engine_core does it: the dict's projection weights
    and lm_head quantized IN PLACE, one leaf at a time, so a 7B bf16
    tree and its quantized twin never both sit whole on the card.  A
    tree whose weights are quantized already (carried from the
    reference, or quantized as it loaded) is returned as it is."""
    if isinstance(params["layers"]["q"]["w"], (QTensor, PackedQTensor)):
        return params
    params = quantize_decoder_params(params, spec, bits=BITS[quantization])
    logger.info(
        "weights quantized",
        extra={"extra_data": {"model": spec.name,
                              "quantization": quantization}},
    )
    return params
