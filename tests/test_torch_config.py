"""The port's config: the reference's section dicts, strict keys, and a
loud NotPortedError for every feature the port does not have yet."""

import dataclasses

import pytest

from vgate_tpu.config import PrefixCacheConfig as JPrefixCacheConfig
from vgate_tpu_torch.config import (
    NotPortedError,
    PrefixCacheConfig,
    load_config,
)


def test_defaults_and_sections():
    cfg = load_config(
        model={"model_id": "tiny-dense", "max_model_len": 64},
        device={"kv_page_size": 4, "prefill_buckets": [8, 16],
                "prefix_cache": False},
    )
    assert cfg.model.engine_type == "torch_cuda"
    assert cfg.device.device == "cuda"
    assert (cfg.device.decode_chunk, cfg.device.decode_pipeline) == (8, 2)
    assert cfg.device.kv_page_size == 4


@pytest.mark.parametrize(
    "sections",
    [
        {"device": {"tp": 2}},
        {"device": {"dp": 2}},
        {"device": {"sp": 2}},
        {"device": {"pp": 2}},
        {"device": {"ep": 2}},
        {"model": {"model_id": "tiny-moe"}, "device": {"ep": 2}},
    ],
    ids=lambda s: next(iter(s.values())).__repr__()[:40],
)
def test_unported_switches_raise(sections):
    sections = {"model": {"model_id": "tiny-dense"}, **sections}
    if "model_id" not in sections["model"]:
        sections["model"] = {"model_id": "tiny-dense", **sections["model"]}
    with pytest.raises(NotPortedError, match="not ported yet"):
        load_config(**sections)


@pytest.mark.parametrize(
    "sections",
    [
        {"model": {"model_id": "tiny-moe"}},
        {"device": {"int8_native": True}},
        {"model": {"model_id": "tiny-moe", "quantization": "int8"}},
        {"model": {"model_id": "mistralai/Mixtral-8x7B-Instruct-v0.1",
                   "quantization": "int8"}},
        {"model": {"model_id": "mistralai/Mixtral-8x7B-Instruct-v0.1",
                   "quantization": "int4"}, "device": {"int8_native": True}},
    ],
    ids=lambda s: next(iter(s.values())).__repr__()[:40],
)
def test_moe_and_w8a8_switches_load(sections):
    """MoE models (quantized or not) and ``device.int8_native`` (W8A8)
    load since they were ported; expert parallelism stays refused
    (above)."""
    sections = {"model": {"model_id": "tiny-dense"}, **sections}
    cfg = load_config(**sections)
    assert cfg.model.model_id == sections["model"]["model_id"]
    assert cfg.device.int8_native == sections.get("device", {}).get(
        "int8_native", False)


@pytest.mark.parametrize(
    "sections",
    [
        {"device": {"speculative_k": 2, "speculative_ngram": 3,
                    "draft_window": 64}},
        {"model": {"model_id": "tiny-dense", "draft_model_id": "tiny-dense"},
         "device": {"speculative_k": 4}},
        {"model": {"model_id": "tiny-encoder"}},
    ],
    ids=["speculative_k", "draft_model_id", "tiny-encoder"],
)
def test_item8_switches(sections):
    """Speculative decoding and draft-model drafting load (ROADMAP queue
    1, item 8); an encoder named as the generation model raises a plain
    ValueError pointing at model.embedding_model_id, since the reference
    has no decoder for it either."""
    sections = {"model": {"model_id": "tiny-dense"}, **sections}
    if sections["model"]["model_id"] == "tiny-encoder":
        with pytest.raises(ValueError, match="embedding_model_id") as info:
            load_config(**sections)
        assert not isinstance(info.value, NotPortedError)
        return
    cfg = load_config(**sections)
    assert cfg.device.speculative_k == sections["device"]["speculative_k"]
    assert cfg.model.draft_model_id == sections["model"].get(
        "draft_model_id")


def test_host_swap_bytes_accepted():
    """The host-RAM swap tier is served (ROADMAP queue 1, item 5)."""
    cfg = load_config(model={"model_id": "tiny-dense"},
                      kv_cache={"host_swap_bytes": 1 << 20})
    assert cfg.kv_cache.host_swap_bytes == 1 << 20


def test_negative_host_swap_bytes_raises():
    """The reference's validator: 0 disables, below 0 is an error."""
    with pytest.raises(ValueError, match="host_swap_bytes must be >= 0"):
        load_config(model={"model_id": "tiny-dense"},
                    kv_cache={"host_swap_bytes": -1})


@pytest.mark.parametrize(
    "sections",
    [
        {"device": {"prefix_cache": True}},
        {"device": {"prefix_cache": {"enabled": True}}},
        {"device": {"prefill_chunk": 512}},
    ],
    ids=lambda s: next(iter(s.values())).__repr__()[:40],
)
def test_ported_switches_accepted(sections):
    cfg = load_config(model={"model_id": "tiny-dense"}, **sections)
    pc = cfg.device.prefix_cache
    assert isinstance(pc, PrefixCacheConfig)
    assert pc.enabled and pc.radix and pc.cow
    assert cfg.device.prefill_chunk == sections["device"].get(
        "prefill_chunk", 0
    )


@pytest.mark.parametrize(
    "sections",
    [
        {"model": {"quantization": "int8"}},
        {"kv_cache": {"dtype": "int8"}},
        {"kv_cache": {"dtype": "bf16"}},
        {"model": {"quantization": "int4"}, "kv_cache": {"dtype": "int8"}},
    ],
    ids=lambda s: next(iter(s.values())).__repr__()[:40],
)
def test_quantized_serving_switches_accepted(sections):
    """Quantized serving (int8/int4 weights, int8 or bf16 pools) is
    ported: the config takes the reference's values as they are."""
    model = {"model_id": "tiny-dense", **sections.get("model", {})}
    cfg = load_config(model=model, kv_cache=sections.get("kv_cache", {}))
    assert cfg.model.quantization == model.get("quantization")
    assert cfg.kv_cache.dtype == sections.get("kv_cache", {}).get(
        "dtype", "auto"
    )
    assert cfg.device.int8_native is False


def test_prefix_cache_defaults_match_the_reference():
    """The port's default is the reference's: prefix cache on, radix +
    COW, the same knobs; a bare False is the master switch."""
    ours = dataclasses.asdict(PrefixCacheConfig())
    theirs = JPrefixCacheConfig().model_dump()
    assert ours == theirs
    assert load_config().device.prefix_cache == PrefixCacheConfig()
    off = load_config(device={"prefix_cache": False}).device.prefix_cache
    assert off == PrefixCacheConfig(enabled=False)


@pytest.mark.parametrize(
    "prefix_cache",
    [{"min_share_pages": 0}, {"evict_watermark": 1.0}, {"radx": True}, 3],
)
def test_prefix_cache_fields_are_validated(prefix_cache):
    with pytest.raises((TypeError, ValueError)):
        load_config(device={"prefix_cache": prefix_cache})


@pytest.mark.parametrize(
    "sections",
    [
        {"device": {"use_pallas": False}},  # a reference key it lacks
        {"tpu": {"kv_page_size": 4}},  # the reference's section name
        {"model": {"engine_type": "jax_tpu"}},
        {"model": {"dtype": "float16"}},
        {"model": {"quantization": "int3"}},
        {"kv_cache": {"dtype": "fp8"}},
    ],
)
def test_unknown_keys_and_values_raise(sections):
    with pytest.raises((TypeError, ValueError)):
        load_config(**sections)


@pytest.mark.parametrize(
    "sections",
    [
        {"model": {"model_id": "tiny-gemma2"}},
        {"model": {"model_id": "google/gemma-2-9b-it",
                   "max_model_len": 8192}},
        {"model": {"model_id": "tiny-gemma2", "quantization": "int8"},
         "kv_cache": {"dtype": "int8"}},
        {"model": {"model_id": "tiny-gemma2", "quantization": "int4"},
         "kv_cache": {"dtype": "int8"}},
    ],
    ids=["tiny-gemma2", "gemma-2-9b-it", "int8_weights_int8_kv",
         "int4_weights_int8_kv"],
)
def test_gemma2_family_accepted(sections):
    """The Gemma-2 family is ported: its specs load, quantized or not,
    as the reference accepts them (tests/test_quant.py)."""
    cfg = load_config(**sections)
    assert cfg.model.model_id == sections["model"]["model_id"]


@pytest.mark.parametrize("slots", [1, 8])
def test_decode_block_slots_accepted(slots):
    cfg = load_config(model={"model_id": "tiny-dense"},
                      device={"decode_block_slots": slots})
    assert cfg.device.decode_block_slots == slots
    assert load_config().device.decode_block_slots == 1  # the reference's


def test_decode_block_slots_below_one_raise():
    with pytest.raises(ValueError, match="decode_block_slots"):
        load_config(device={"decode_block_slots": 0})
