"""The port's config: the reference's section dicts, strict keys, and a
loud NotPortedError for every feature the port does not have yet."""

import pytest

from vgate_tpu_torch.config import NotPortedError, load_config


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
        {"device": {"prefix_cache": True}},
        {"device": {"prefix_cache": {"enabled": True}}},
        {"device": {"prefill_chunk": 512}},
        {"device": {"speculative_k": 2}},
        {"device": {"tp": 2}},
        {"device": {"dp": 2}},
        {"device": {"sp": 2}},
        {"device": {"pp": 2}},
        {"device": {"ep": 2}},
        {"model": {"quantization": "int8"}},
        {"model": {"draft_model_id": "tiny-dense"}},
        {"kv_cache": {"dtype": "int8"}},
        {"kv_cache": {"dtype": "bf16"}},
        {"kv_cache": {"host_swap_bytes": 1 << 20}},
        {"model": {"model_id": "tiny-moe"}},
        {"model": {"model_id": "tiny-gemma2"}},
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
        {"device": {"use_pallas": False}},  # a reference key it lacks
        {"tpu": {"kv_page_size": 4}},  # the reference's section name
        {"model": {"engine_type": "jax_tpu"}},
        {"model": {"dtype": "float16"}},
    ],
)
def test_unknown_keys_and_values_raise(sections):
    with pytest.raises((TypeError, ValueError)):
        load_config(**sections)
