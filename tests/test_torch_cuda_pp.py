"""Pipeline parallelism on the card (parallel/pipeline.py).

Every test is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is false (the two-card test also where one card is visible).  The file
imports neither JAX nor ``vgate_tpu``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_pp.py

A small model with a preset (Qwen2.5-0.5B: 24 layers, hd 64, random
weights from seed 0, bf16), since a follower process builds its spec from
the model id:

* a pp = 2 group with both stages on one card (a gloo device group,
  eager chunks): its prompt-pass and decode-step logits equal a pp = 1
  core's within bf16 rounding; over a wave, each stage's K1 launches are
  ``L/2 x M`` a decode step and its K2 ``L/2 x M(B)`` a prompt pass of B
  rows, exactly; trash page 0 is still zeros on both stages;
* where two cards are visible, the same group one stage a card (NCCL):
  every decode chunk a graph replay on both stages, and the same
  logits and launches.
"""

import numpy as np
import pytest
import torch

from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.ops.kernels import launch_counts

MODEL = "Qwen/Qwen2.5-0.5B-Instruct"
K1, K2 = "paged_decode_attention", "flash_prefill_attention"
SLOTS = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _core(devices):
    from vgate_tpu_torch.config import load_config
    from vgate_tpu_torch.runtime.engine_core import EngineCore

    cfg = load_config(
        model={"model_id": MODEL, "dtype": "bfloat16", "max_model_len": 256},
        device={"device": "cuda", "kv_page_size": 16, "kv_num_pages": 128,
                "max_batch_slots": SLOTS, "prefill_buckets": [32, 64, 128],
                "prefix_cache": False, "pp": len(devices),
                "devices": devices if len(devices) > 1 else []},
        logging={"level": "WARNING"},
    )
    return EngineCore(cfg)


def _logits(core, ids):
    """A prompt pass of ``ids`` (one row) and one decode step (every slot,
    slot 0 active), each named to the followers as the engine names its
    own, on pages taken from the allocator and given back: rank 0's
    logits of each, fp32 on the host."""
    from vgate_tpu_torch.models.decoder import decode_forward, prefill_forward

    dev, ps = core.device, core.geometry.page_size
    n, S = len(ids), 32
    pages = core.allocator.allocate(S // ps + 1)

    def up(a):
        return torch.from_numpy(a).to(dev)

    try:
        tok = np.zeros((1, S), np.int32)
        tok[0, :n] = ids
        sl = np.asarray([n], np.int32)
        pt = np.asarray([pages[:S // ps]], np.int32)
        with torch.no_grad(), core._program("prefill", tokens=tok,
                                            seq_lens=sl, page_tables=pt):
            prompt = prefill_forward(core.params, core.spec, up(tok), up(sl),
                                     core.k_pages, core.v_pages, up(pt))
        tokens = np.zeros(SLOTS, np.int32)
        tokens[0] = int(prompt[0].argmax())
        positions = np.zeros(SLOTS, np.int32)
        positions[0] = n
        active = np.arange(SLOTS) == 0
        table = np.zeros((SLOTS, core.geometry.pages_per_seq), np.int32)
        table[0, :len(pages)] = pages
        with core._program("decode_state", tokens=tokens,
                           positions=positions, active=active,
                           page_tables=table):
            pass
        with torch.no_grad(), core._program(
                "decode", key=None, num_steps=1, max_position=255,
                graphs=False):
            step = decode_forward(core.params, core.spec, up(tokens),
                                  up(positions), core.k_pages, core.v_pages,
                                  up(table), active=up(active))
        torch.cuda.synchronize()
    finally:
        core.allocator.release(pages)
    return prompt[0].float().cpu(), step[0].float().cpu()


def _wave(core, prompts, tokens=8):
    """``prompts`` served greedy by the engine thread, with the batch of
    every prompt pass the relay ran."""
    from vgate_tpu_torch.parallel import pipeline

    real, passes = pipeline.pp_prefill_forward, []

    def recorded(params, spec, tok, *args, **kwargs):
        passes.append(int(tok.shape[0]))
        return real(params, spec, tok, *args, **kwargs)

    pipeline.pp_prefill_forward = recorded
    try:
        core.start()
        seqs = [core.submit_tokens(p, SamplingParams(
            max_tokens=tokens, temperature=0.0)) for p in prompts]
        for s in seqs:
            assert s.done_event.wait(300), "a stream never finished"
        core.stop()
    finally:
        pipeline.pp_prefill_forward = real
    assert all(s.error is None for s in seqs), [s.error for s in seqs]
    return [list(s.generated_ids) for s in seqs], passes


def _close(got, want, what):
    """Within 4 bf16 steps of the largest logit."""
    scale = float(want.abs().max())
    tol = 4 * 2.0 ** (np.floor(np.log2(scale)) - 7)
    err = float((got - want).abs().max())
    assert err <= tol, f"{what}: {err} off pp=1's (tolerance {tol})"


def _check_group(devices, graphs):
    from vgate_tpu_torch.observability.roofline import param_bytes
    from vgate_tpu_torch.parallel.pipeline import microbatches

    rng = np.random.default_rng(7)
    ids = rng.integers(3, 5000, size=21).tolist()
    prompts = [rng.integers(3, 5000, size=n).tolist() for n in (9, 17, 30)]
    want = None
    ref = _core(["cuda:0"])
    try:
        want = _logits(ref, ids)
    finally:
        ref.close()
        del ref
        torch.cuda.empty_cache()
    core = _core(devices)
    try:
        assert core.mesh.pp == 2 and core.decode_graphs is graphs
        assert core.spec.num_layers == 12 and core.spec.first_layer == 0
        assert not core.prefix_cache_enabled
        for got, w, what in zip(_logits(core, ids), want,
                                ("prompt pass", "decode step")):
            _close(got, w, what)
        launch_counts(reset=True)
        core.reset_follower_launches()
        s0 = core.get_stats()
        [f0] = core.follower_stats()
        streams, passes = _wave(core, prompts)
        assert all(len(s) == 8 for s in streams)
        s1 = core.get_stats()
        [f1] = core.follower_stats()
        steps = s1["steps"] - s0["steps"]
        assert passes and s1["prompt_passes"] - s0["prompt_passes"] == len(
            passes)
        k1 = 12 * microbatches(SLOTS, 2) * steps
        k2 = 12 * sum(microbatches(B, 2) for B in passes)
        for n in (launch_counts(), f1["kernel_launches"]):
            assert (n[K1], n[K2]) == (k1, k2)
        assert f1["steps"] - f0["steps"] == steps
        if graphs:
            chunks = s1["chunks"] - s0["chunks"]
            assert (s1["decode_graphs"]["replays"]
                    - s0["decode_graphs"]["replays"]) == chunks > 0
            assert (f1["decode_graphs"]["replays"]
                    - f0["decode_graphs"]["replays"]) == chunks
        torch.cuda.synchronize()
        assert not core.k_pages[:, :, 0].any()
        assert not core.v_pages[:, :, 0].any()
        assert f1["memory"]["trash_page_zero"]
        # stage 1 holds its 12 layers and no embedding (the tied head)
        embed = core.params["embed"]
        assert "embed" not in f1["memory"]["leaves"]
        assert f1["memory"]["weights_bytes"] == param_bytes(
            core.params) - embed.numel() * embed.element_size() - param_bytes(
            core.params["final_norm"])
    finally:
        core.close()


@pytest.mark.cuda
def test_pp2_on_one_card_matches_pp1_with_exact_launches(cuda):
    _check_group(["cuda:0", "cuda:0"], graphs=False)


@pytest.mark.cuda
def test_pp2_on_two_cards_replays_graphs(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card")
    _check_group(["cuda:0", "cuda:1"], graphs=True)
