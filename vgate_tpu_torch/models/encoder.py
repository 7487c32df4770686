"""BERT-family encoder for the embeddings path (bge-base-en-v1.5), the
reference's vgate_tpu/models/encoder.py in PyTorch.

CLS pooling and L2 normalization, as the bge family is used.  The
attention and the products are plain tensor ops: the reference runs
them as plain ``jnp.einsum`` outside any Pallas kernel, so there is no
TPU kernel here to port.  Parameters keep the reference's layout
(``[in, out]`` weights, per-layer leaves stacked on a leading ``L``
axis), so a JAX tree carries over leaf for leaf
(runtime/weights.py ``params_from_jax``).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict

import numpy as np
import torch

from vgate_tpu_torch.models.specs import ModelSpec
from vgate_tpu_torch.ops.norms import layer_norm

Params = Dict[str, Any]


def init_encoder_params(
    spec: ModelSpec,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> Params:
    """Random-init the encoder tree (std 0.02 normal drawn in fp32 on
    ``device`` from ``generator``; unit LayerNorm weights, zero biases)."""
    D, L = spec.hidden_size, spec.num_layers
    F, V = spec.intermediate_size, spec.vocab_size
    P = spec.max_position_embeddings

    def normal(*shape):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * 0.02).to(dtype)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    def dense(n_in, n_out):
        return {"w": normal(L, n_in, n_out), "b": full(0.0, L, n_out)}

    def ln(*lead):
        return {"w": full(1.0, *lead, D), "b": full(0.0, *lead, D)}

    return {
        "word_embed": normal(V, D),
        "pos_embed": normal(P, D),
        "type_embed": normal(2, D),
        "embed_ln": ln(),
        "layers": {
            "q": dense(D, D),
            "k": dense(D, D),
            "v": dense(D, D),
            "o": dense(D, D),
            "attn_ln": ln(L),
            "ffn_in": dense(D, F),
            "ffn_out": dense(F, D),
            "ffn_ln": ln(L),
        },
    }


def encode_forward(
    params: Params,
    spec: ModelSpec,
    tokens: torch.Tensor,  # [B, S]
    mask: torch.Tensor,  # [B, S] 1 for real tokens
    normalize: bool = True,
) -> torch.Tensor:
    """Pooled sentence embeddings [B, D] (the CLS token's): L2-normalized
    in fp32 (and returned in fp32), or with ``normalize`` False in the
    model dtype.  Scores accumulate in fp32 and the
    softmax weights are cast to the model dtype before the product with
    V, as in the reference; GELU (exact erf) in fp32."""
    B, S = tokens.shape
    H, hd = spec.num_heads, spec.head_dim
    eps = 1e-12
    lay = params["layers"]
    tok = tokens.long()
    x = (
        params["word_embed"][tok]
        + params["pos_embed"][torch.arange(S, device=tokens.device)][None]
        + params["type_embed"][torch.zeros_like(tok)]
    )
    x = layer_norm(x, params["embed_ln"]["w"], params["embed_ln"]["b"], eps)
    bias = torch.where(
        mask[:, None, None, :] > 0, 0.0, -1e30
    ).to(torch.float32)  # [B, 1, 1, S]

    def dense(h, p, l):
        return h @ p["w"][l] + p["b"][l]

    for l in range(spec.num_layers):
        def heads(p):
            return dense(x, p, l).reshape(B, S, H, hd)

        q, k, v = heads(lay["q"]), heads(lay["k"]), heads(lay["v"])
        scores = torch.einsum(
            "bshd,bthd->bhst", q.float(), k.float()
        ) / (hd ** 0.5) + bias
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        attn = torch.einsum("bhst,bthd->bshd", probs, v).reshape(B, S, H * hd)
        h = layer_norm(x + dense(attn, lay["o"], l), lay["attn_ln"]["w"][l],
                       lay["attn_ln"]["b"][l], eps)
        ffn = torch.nn.functional.gelu(
            dense(h, lay["ffn_in"], l).float()
        ).to(h.dtype)
        x = layer_norm(h + dense(ffn, lay["ffn_out"], l),
                       lay["ffn_ln"]["w"][l], lay["ffn_ln"]["b"][l], eps)
    pooled = x[:, 0]  # CLS token
    if normalize:
        # in fp32, and returned in fp32: the reference divides by the
        # norm cast to the model dtype, and in bf16 that rounding (and
        # the output's) moves a vector's norm by up to ~2**-8
        p32 = pooled.float()
        norm = torch.linalg.vector_norm(p32, dim=-1, keepdim=True)
        pooled = p32 / torch.clamp(norm, min=1e-9)
    return pooled


def encoder_params_from_getter(
    spec: ModelSpec,
    get: Callable[[str], Any],
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
) -> Params:
    """Assemble the encoder tree from HF ``BertModel``-named tensors
    (linear weights ``[out, in]`` transposed to ``[in, out]``)."""

    def host(name: str) -> np.ndarray:
        x = get(name)
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", torch.float32).numpy()
        return np.asarray(x, np.float32)

    def leaf(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device=device, dtype=dtype
        )

    def stack(template: str, transpose: bool = False):
        arrs = [host(template.format(i)) for i in range(spec.num_layers)]
        return leaf(np.stack([a.T if transpose else a for a in arrs]))

    pre = "encoder.layer.{}."

    def dense(name):
        return {"w": stack(pre + name + ".weight", True),
                "b": stack(pre + name + ".bias")}

    def ln(name):
        return {"w": stack(pre + name + ".weight"),
                "b": stack(pre + name + ".bias")}

    return {
        "word_embed": leaf(host("embeddings.word_embeddings.weight")),
        "pos_embed": leaf(host("embeddings.position_embeddings.weight")),
        "type_embed": leaf(host("embeddings.token_type_embeddings.weight")),
        "embed_ln": {"w": leaf(host("embeddings.LayerNorm.weight")),
                     "b": leaf(host("embeddings.LayerNorm.bias"))},
        "layers": {
            "q": dense("attention.self.query"),
            "k": dense("attention.self.key"),
            "v": dense("attention.self.value"),
            "o": dense("attention.output.dense"),
            "attn_ln": ln("attention.output.LayerNorm"),
            "ffn_in": dense("intermediate.dense"),
            "ffn_out": dense("output.dense"),
            "ffn_ln": ln("output.LayerNorm"),
        },
    }


def encoder_params_from_torch_state_dict(
    spec: ModelSpec,
    state_dict,
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
) -> Params:
    """The encoder tree from an in-memory HF ``BertModel`` state dict."""
    return encoder_params_from_getter(
        spec, lambda name: state_dict[name], device, dtype
    )


def encoder_params_from_safetensors(
    spec: ModelSpec,
    checkpoint_path: str,
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
) -> Params:
    """Load a local ``BertModel``-family (bge) safetensors checkpoint
    directory.  Needs the ``safetensors`` package, imported here so the
    port runs without it (as runtime/weights.py
    ``params_from_safetensors``); a ``bert.``-prefixed checkpoint is read
    as well."""
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
        if name not in index and "bert." + name in index:
            name = "bert." + name
        if name not in index:
            raise KeyError(f"tensor {name} missing from checkpoint")
        return index[name].get_tensor(name)

    return encoder_params_from_getter(spec, getter, device, dtype)
