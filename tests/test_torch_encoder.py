"""The port's encoder (models/encoder.py, ops/norms.py ``layer_norm``)
and its ``Embedder`` (backends/torch_backend.py) vs the JAX package's.

Inputs come from a numpy seed; the encoder tree goes across with
``params_from_jax``.  Tolerance: 1e-5 in float32 on the pooled vectors
(twelve fp32 products and norms in two frameworks' orders, two layers
deep), 1e-6 on one LayerNorm.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vgate_tpu.backends.jax_backend import Embedder as JEmbedder
from vgate_tpu.models import encoder as jenc
from vgate_tpu.models.specs import TINY_ENCODER as J_SPEC
from vgate_tpu.ops.norms import layer_norm as j_layer_norm
from vgate_tpu_torch.backends.torch_backend import Embedder, TorchCUDABackend
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.engine import VGTEngine
from vgate_tpu_torch.models import encoder as tenc
from vgate_tpu_torch.models.specs import TINY_ENCODER as SPEC
from vgate_tpu_torch.ops.norms import layer_norm
from vgate_tpu_torch.runtime.weights import params_from_jax

TOL = 1e-5


@pytest.fixture(scope="module")
def trees():
    jparams = jenc.init_encoder_params(J_SPEC, jax.random.PRNGKey(0),
                                       jnp.float32)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), SPEC)


@pytest.mark.parametrize("shape", [(4, 32), (2, 3, 64)])
def test_layer_norm_matches_reference(shape):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    w = rng.normal(size=shape[-1]).astype(np.float32)
    b = rng.normal(size=shape[-1]).astype(np.float32)
    got = layer_norm(*map(torch.from_numpy, (x, w, b)))
    want = j_layer_norm(*map(jnp.asarray, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    bf = layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                    torch.from_numpy(b))
    assert bf.dtype == torch.bfloat16


def test_params_from_jax_carries_the_encoder_tree(trees):
    jparams, tparams = trees
    jl, _ = jax.tree_util.tree_flatten_with_path(jparams)
    for path, leaf in jl:
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("normalize", [True, False])
def test_encode_forward_matches_reference(trees, normalize):
    jparams, tparams = trees
    rng = np.random.default_rng(0)
    B, S = 3, 24
    tokens = rng.integers(3, SPEC.vocab_size, size=(B, S)).astype(np.int32)
    mask = np.zeros((B, S), np.int32)
    for b, n in enumerate((24, 9, 2)):
        mask[b, :n] = 1
    want = jenc.encode_forward(jparams, J_SPEC, jnp.asarray(tokens),
                               jnp.asarray(mask), normalize=normalize)
    got = tenc.encode_forward(tparams, SPEC, torch.from_numpy(tokens),
                              torch.from_numpy(mask), normalize=normalize)
    assert got.shape == (B, SPEC.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    if normalize:
        np.testing.assert_allclose(
            np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-6
        )


def test_encoder_padding_invariance(trees):
    """More padding must not change the real tokens' pooled vector."""
    _, tparams = trees
    ids = torch.tensor([[7, 8, 9, 0, 0, 0, 0, 0]], dtype=torch.int32)
    mask = torch.tensor([[1, 1, 1, 0, 0, 0, 0, 0]], dtype=torch.int32)
    short = tenc.encode_forward(tparams, SPEC, ids[:, :4], mask[:, :4])
    long = tenc.encode_forward(tparams, SPEC, ids, mask)
    np.testing.assert_allclose(short.numpy(), long.numpy(), atol=TOL)


def _hf_state_dict(rng):
    """Random HF ``BertModel``-named tensors for tiny-encoder."""
    D, F = SPEC.hidden_size, SPEC.intermediate_size

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.05

    sd = {
        "embeddings.word_embeddings.weight": r(SPEC.vocab_size, D),
        "embeddings.position_embeddings.weight":
            r(SPEC.max_position_embeddings, D),
        "embeddings.token_type_embeddings.weight": r(2, D),
        "embeddings.LayerNorm.weight": 1 + r(D),
        "embeddings.LayerNorm.bias": r(D),
    }
    for i in range(SPEC.num_layers):
        pre = f"encoder.layer.{i}."
        for name, (o, n) in {
            "attention.self.query": (D, D), "attention.self.key": (D, D),
            "attention.self.value": (D, D),
            "attention.output.dense": (D, D),
            "intermediate.dense": (F, D), "output.dense": (D, F),
        }.items():
            sd[pre + name + ".weight"] = r(o, n)
            sd[pre + name + ".bias"] = r(o)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[pre + name + ".weight"] = 1 + r(D)
            sd[pre + name + ".bias"] = r(D)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def test_state_dict_mapping_matches_reference():
    """HF names map to the same tree as the reference maps them, and the
    forward over it agrees."""
    sd = _hf_state_dict(np.random.default_rng(5))
    jparams = jenc.encoder_params_from_torch_state_dict(J_SPEC, sd)
    tparams = tenc.encoder_params_from_torch_state_dict(SPEC, sd)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        node = tparams
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    tokens = np.array([[2, 50, 60, 70, 3]], np.int32)
    mask = np.ones_like(tokens)
    np.testing.assert_allclose(
        tenc.encode_forward(tparams, SPEC, torch.from_numpy(tokens),
                            torch.from_numpy(mask)).numpy(),
        np.asarray(jenc.encode_forward(jparams, J_SPEC, jnp.asarray(tokens),
                                       jnp.asarray(mask))),
        atol=TOL,
    )


def test_init_encoder_params_shapes_and_seed():
    a = tenc.init_encoder_params(SPEC, torch.Generator().manual_seed(0))
    b = tenc.init_encoder_params(SPEC, torch.Generator().manual_seed(0))
    jparams = jenc.init_encoder_params(J_SPEC, jax.random.PRNGKey(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        na, nb = a, b
        for key in path:
            na, nb = na[key.key], nb[key.key]
        assert tuple(na.shape) == leaf.shape, path
        assert torch.equal(na, nb)


# inputs over all three buckets (32, 128 and 512 tokens with BOS/EOS)
BUCKET_INPUTS = [
    ["a", "short one", "x" * 20],
    ["medium " * 12, "y"],
    ["long text " * 45, "z" * 300, "q"],
]


@pytest.mark.parametrize("inputs", BUCKET_INPUTS,
                         ids=["bucket32", "bucket128", "bucket512"])
def test_embedder_matches_reference(trees, inputs):
    """The same framing, buckets and batches as the reference's
    Embedder: the vectors within 1e-5."""
    ref = JEmbedder("tiny-encoder", None, jnp.float32)
    port = Embedder("tiny-encoder", None, torch.float32,
                    params=params_from_jax(
                        jax.tree.map(np.asarray, ref.params), SPEC))
    got, want = port.embed(inputs), ref.embed(inputs)
    assert len(got) == len(inputs)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL)


def test_embedder_batches_past_64_rows(trees):
    """More than 64 inputs run as several batches of 64, in order."""
    _, tparams = trees
    port = Embedder("tiny-encoder", None, torch.float32, params=tparams)
    inputs = [f"input number {i}" for i in range(70)]
    many = port.embed(inputs)
    assert len(many) == 70
    np.testing.assert_allclose(np.asarray(many[66]),
                               np.asarray(port.embed([inputs[66]])[0]),
                               atol=TOL)


def test_embedder_refuses_a_decoder():
    with pytest.raises(ValueError, match="not an encoder"):
        Embedder("tiny-dense", None)


def test_backend_and_engine_embed_on_the_cpu():
    """``TorchCUDABackend.embed`` builds the configured encoder at its
    first call (random init, logged) and ``VGTEngine.embeddings`` serves
    it; the dry-run backend keeps the reference's mock."""
    cfg = load_config(
        model={"model_id": "tiny-dense", "dtype": "float32",
               "embedding_model_id": "tiny-encoder"},
        device={"device": "cpu"},
    )
    backend = TorchCUDABackend()
    backend._config = cfg
    vecs = backend.embed(["hello", "world of words"])
    assert len(vecs) == 2 and len(vecs[0]) == SPEC.hidden_size
    np.testing.assert_allclose(np.linalg.norm(vecs, axis=-1), 1.0, atol=1e-5)
    assert backend._embedder.device == torch.device("cpu")
    dry = load_config(model={"model_id": "tiny-dense",
                             "engine_type": "dry_run"})
    engine = VGTEngine(dry)
    out = engine.embeddings(["one two", "three"])
    assert out["usage"] == {"prompt_tokens": 3, "total_tokens": 3}
    assert len(out["embeddings"][0]) == 768
