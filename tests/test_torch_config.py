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
        # tp and ep serve since items 10a and 10c, MoE and quantized
        # weights under them too, dp since item 10b; the pod and
        # speculation on such a mesh, and a dp replica that is itself a
        # mesh, still refuse
        {"device": {"tp": 2}, "pod": {"workers": 2}},
        pytest.param({"device": {"dp": 2, "tp": 2}}, id="{'dp': 2}"),
        # sp and pp serve since item 10d, with tp and ep too since its
        # rest's second part (test_composed_meshes_load)
        {"device": {"ep": 2}, "pod": {"workers": 2}},
        {"model": {"model_id": "tiny-moe"},
         "device": {"ep": 2, "speculative_k": 2}},
    ],
    ids=lambda s: next(iter(s.values())).__repr__()[:40],
)
def test_unported_switches_raise(sections):
    sections = {"model": {"model_id": "tiny-dense"}, **sections}
    if "model_id" not in sections["model"]:
        sections["model"] = {"model_id": "tiny-dense", **sections["model"]}
    with pytest.raises(NotPortedError, match="not ported yet"):
        load_config(**sections)


PP_REFUSALS = [
    # the reference's permanent exclusions and its pp rules, its words
    ({"device": {"pp": 2, "sp": 2}}, ValueError,
     r"sp=2 and pp=2 cannot combine: .* a permanent design exclusion"),
    ({"device": {"pp": 2, "speculative_k": 2}}, ValueError,
     r"speculative decoding cannot combine with pp>1: .* permanent"),
    ({"device": {"pp": 2, "prefill_chunk": 8}}, ValueError,
     r"prefill_chunk \(chunked prefill\) requires pp == 1"),
    ({"device": {"pp": 2}, "kv_cache": {"dtype": "int8"}}, ValueError,
     r"kv_cache.dtype=int8 requires a plain mesh, got \{'pp': 2\}"),
    ({"device": {"pp": 2}, "kv_cache": {"host_swap_bytes": 1 << 20}},
     ValueError,
     r"kv_cache.host_swap_bytes requires a plain mesh, got \{'pp': 2\}"),
    ({"device": {"pp": 3}}, ValueError, r"^2 layers not divisible by pp=3$"),
    # the port's own: dp replicas as meshes, the pod
    ({"device": {"pp": 2, "dp": 2}}, NotPortedError,
     r"device.dp>1 with .*device.pp .* item 10b \(rest\)"),
    ({"device": {"pp": 2}, "pod": {"workers": 2}}, NotPortedError,
     r"pod.workers>0 under a model-parallel mesh .*device.pp"),
    # composed with tp the reference's rules hold all the same
    ({"device": {"pp": 2, "tp": 2, "sp": 2}}, ValueError,
     r"sp=2 and pp=2 cannot combine: .* a permanent design exclusion"),
    ({"device": {"pp": 2, "tp": 2, "speculative_k": 2}}, ValueError,
     r"speculative decoding cannot combine with pp>1: .* permanent"),
    ({"device": {"pp": 2, "tp": 2, "prefill_chunk": 8}}, ValueError,
     r"prefill_chunk \(chunked prefill\) requires pp == 1"),
    ({"device": {"sp": 2, "tp": 2, "speculative_k": 2}}, NotPortedError,
     r"speculative decoding under a model-parallel mesh .* 10d \(rest\)"),
    ({"device": {"pp": 2, "tp": 3}}, NotPortedError,
     r"num_heads=4 is not divisible by device.tp=3;.* item 10a \(rest\)"),
]


@pytest.mark.parametrize(
    "sections,error,match", PP_REFUSALS,
    ids=["pp_x_sp", "speculation", "prefill_chunk", "int8_kv", "host_swap",
         "layers", "dp_x_pp", "pod", "pp_x_sp_x_tp", "speculation_pp_x_tp",
         "prefill_chunk_pp_x_tp", "speculation_sp_x_tp", "pp_x_tp3"])
def test_pipeline_refusals(sections, error, match):
    """Every rule the reference enforces under pp raises its
    ``ValueError`` with its words, with tp too; dp x pp raises
    ``NotPortedError`` citing 10b (rest), speculation under sp x tp 10d
    (rest), a tp that does not divide the heads 10a (rest)."""
    model = {"model_id": "tiny-dense", **sections.pop("model", {})}
    with pytest.raises(error, match=match):
        load_config(model=model, **sections)


COMPOSED = [
    ("tiny-dense", {"pp": 2, "tp": 2}),
    ("tiny-moe", {"pp": 2, "ep": 2}),
    ("tiny-dense", {"sp": 2, "tp": 2}),
    ("tiny-moe", {"sp": 2, "ep": 2}),
    ("tiny-moe", {"pp": 2, "ep": 2, "tp": 2}),
    ("tiny-moe", {"ep": 2, "sp": 2, "tp": 2}),
    ("tiny-gemma2", {"pp": 2, "tp": 2}),
    ("tiny-dense", {"sp": 2, "tp": 0}),
]


@pytest.mark.parametrize(
    "model,device", COMPOSED,
    ids=["pp_x_tp", "pp_x_ep", "sp_x_tp", "sp_x_ep", "pp_x_ep_x_tp",
         "ep_x_sp_x_tp", "gemma2_pp_x_tp", "sp_x_tp_auto"])
def test_composed_meshes_load(model, device):
    """pp and sp compose with tp and ep (item 10d (rest), part 2),
    three axes too: the config loads as it is given, with the prefix
    cache and chunking under sp, int8 weights under pp."""
    extra = ({"prefill_chunk": 512, "prefix_cache": True}
             if "sp" in device else {"prefix_cache": True})
    cfg = load_config(model={"model_id": model, "quantization": "int8"},
                      device={**device, **extra})
    for axis, n in device.items():
        assert getattr(cfg.device, axis) == n


def test_pipeline_loads_at_tp_ep_one():
    """pp > 1 at tp = ep = 1 loads, and pp 0 (every device) with it."""
    for model in ("tiny-dense", "tiny-gemma2", "tiny-moe"):
        cfg = load_config(model={"model_id": model, "quantization": "int8"},
                          device={"pp": 2, "prefix_cache": True})
        assert cfg.device.pp == 2
    assert load_config(device={"pp": 0}).device.pp == 0


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
    load since they were ported."""
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


def test_a_cut_depth_model_id_names_the_preset_cut():
    """``<preset>@<n>`` is the preset cut to its first n layers, at full
    width, in any process (a follower or a pod worker resolves it from
    the config); a depth past the preset's raises."""
    from vgate_tpu_torch.models.specs import spec_for_model_id

    whole = spec_for_model_id("Qwen/Qwen2.5-7B-Instruct")
    cut = spec_for_model_id("Qwen/Qwen2.5-7B-Instruct@14")
    assert (cut.num_layers, cut.name) == (14, "Qwen/Qwen2.5-7B-Instruct@14")
    assert cut.hidden_size == whole.hidden_size and cut.num_heads == 28
    for bad in ("Qwen/Qwen2.5-7B-Instruct@29", "tiny-dense@0",
                "tiny-dense@x"):
        with pytest.raises(KeyError):
            spec_for_model_id(bad)
    assert load_config(model={"model_id": "tiny-dense@1"},
                       device={"pp": 1}).model.model_id == "tiny-dense@1"
