"""Several engine cores in one process on a card: the hazards of data
parallelism (runtime/dp_engine.py), and the inactive decode slots'
trash page.

Every test is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is false (or, for the second card's test, where one card is visible).
The file imports neither JAX nor ``vgate_tpu``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_dp.py

* Two cores on one card, each with its own engine thread, stream, capture
  stream and pool (``shared_process``): one is torn down and rebuilt
  (``rebuild_core``, its decode graphs captured again) while the other's
  graphs replay a long burst.  The survivor's streams equal its
  undisturbed streams, and the rebuilt core serves as before.
* A core on ``cuda:1`` built and served from threads whose current
  device is 0: K1, K2 and K3 launch on its own device, and its streams
  equal a ``cuda:0`` core's over the same seed-0 weights.
* The inactive decode slots' trash page: two cores with the same weights
  and the same history stand in for two ranks of a mesh (each rank runs
  the same program on its own pool, the ranks on one card at once).
  Slots that served and went inactive keep their stale page tables and
  decode garbage each step, every inactive slot writing its K/V to page
  0 at offset 0, and slots never used read that page.  After each wave,
  served concurrently on both, the two cores' trash pages and every row
  of their last graphed chunk (active and inactive) must be equal.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.ops.kernels import launch_counts

CARD_SPEC = dict(hidden_size=256, num_heads=4, num_kv_heads=2,
                 head_dim=64, intermediate_size=256)
K1, K2, K3 = ("paged_decode_attention", "flash_prefill_attention",
              "paged_multitok_attention")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _core(device="cuda:0", model="tiny-dense", slots=4, prefix=False,
          **spec):
    from vgate_tpu_torch.config import load_config
    from vgate_tpu_torch.models.specs import spec_for_model_id
    from vgate_tpu_torch.runtime.engine_core import EngineCore

    cfg = load_config(
        model={"model_id": model, "dtype": "bfloat16",
               "max_model_len": 256},
        device={"device": "cuda", "kv_page_size": 16, "kv_num_pages": 128,
                "max_batch_slots": slots, "prefill_buckets": [32, 64, 128],
                "prefix_cache": prefix},
        logging={"level": "WARNING"},
    )
    base = spec_for_model_id(model)
    return EngineCore(cfg, spec=dataclasses.replace(base, **CARD_SPEC,
                                                    **spec),
                      devices=[device], shared_process=True)


def _prompts(seed, n, lo=5, hi=60):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 500, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _serve(core, prompts, tokens, timeout=300):
    seqs = [core.submit_tokens(p, SamplingParams(
        max_tokens=t, min_tokens=t, temperature=0.0))
        for p, t in zip(prompts, tokens)]
    for s in seqs:
        assert s.done_event.wait(timeout), "a stream never finished"
        assert s.error is None, s.error
    return [list(s.generated_ids) for s in seqs]


@pytest.mark.cuda
def test_a_core_rebuilt_while_its_sibling_replays_on_one_card(cuda):
    from vgate_tpu_torch.runtime import engine_core

    a, b = _core(), _core()
    try:
        a.start()
        b.start()
        prompts = _prompts(1, 4)
        a_clean = _serve(a, prompts, [96] * 4)
        b_clean = _serve(b, prompts, [12] * 4)
        assert a._graphs.replays == a.total_chunks > 0
        b.warmup()
        # a long burst on ``a`` while ``b`` is torn down and rebuilt:
        # rebuild_core's teardown must leave cuBLAS's workspaces and the
        # kernels' scratch that a's graphs use, and the successor's
        # captures (its warm-up) run beside a's replays
        seqs = [a.submit_tokens(p, SamplingParams(
            max_tokens=96, min_tokens=96, temperature=0.0))
            for p in prompts]
        replays0 = a._graphs.replays
        b2 = engine_core.rebuild_core(b, b.config, devices=["cuda:0"])
        assert b2.shared_process and b2._graphs.graphs
        b2.start()
        for s in seqs:
            assert s.done_event.wait(300) and s.error is None, s.error
        assert a._graphs.replays > replays0
        assert [list(s.generated_ids) for s in seqs] == a_clean
        assert _serve(b2, prompts, [12] * 4) == b_clean
        assert a._graphs.replays == a.total_chunks
        assert b2._graphs.replays == b2.total_chunks
        b2.stop()
    finally:
        a.stop()
        b.stop()


@pytest.mark.cuda
def test_a_core_on_another_card_launches_on_its_own_device(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card")
    torch.cuda.set_device(0)
    prompts = _prompts(2, 3, 20, 40)
    streams = {}
    for device in ("cuda:0", "cuda:1"):
        core = _core(device, prefix=True)
        try:
            assert core.device == torch.device(device)
            assert core.k_pages.device == torch.device(device)
            core.start()
            launch_counts(reset=True)
            first = _serve(core, prompts, [16] * 3)
            again = _serve(core, prompts[:1], [16])  # a prefix hit: K3
            n = launch_counts()
            L = core.spec.num_layers
            assert n[K1] == L * core.total_steps > 0
            assert n[K2] + n[K3] == L * core.total_prompt_passes
            assert n[K3] > 0
            assert again[0] == first[0]
            assert torch.cuda.current_device() == 0
            streams[device] = first
        finally:
            core.stop()
    assert streams["cuda:1"] == streams["cuda:0"]


def _drive_both(cores, prompts, tokens):
    """The same wave on each core, both served at once (each core's
    engine thread on its own stream), as the ranks of a mesh on one
    card run."""
    out = [None] * len(cores)

    def run(i):
        out[i] = _serve(cores[i], prompts, tokens)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(cores))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("model,spec", [
    ("tiny-dense", {}),
    ("tiny-moe", {"num_experts": 8}),
], ids=["dense", "moe-8-experts"])
def test_stale_inactive_slots_rows_agree_between_two_ranks_on_card(
        cuda, model, spec):
    cores = [_core(model=model, slots=16, **spec) for _ in range(2)]
    try:
        for name, leaf in (("embed", cores[0].params["embed"]),):
            assert torch.equal(leaf, cores[1].params[name])
        for core in cores:
            core.start()
        waves = [
            # 8 of 16 slots, finishing apart: they go inactive with their
            # stale page tables; the other 8 are never used
            (_prompts(3, 8), [3, 5, 7, 9, 11, 13, 15, 17]),
            # one stream beside 15 inactive slots, then three
            (_prompts(4, 1), [40]),
            (_prompts(5, 3), [9, 21, 33]),
        ]
        mismatches = []
        for i, (prompts, tokens) in enumerate(waves):
            got = _drive_both(cores, prompts, tokens)
            assert got[0] == got[1], f"wave {i}: active streams differ"
            torch.cuda.synchronize()
            trash = [c.k_pages[:, :, 0].float() for c in cores]
            vtrash = [c.v_pages[:, :, 0].float() for c in cores]
            rows = [c._dec_state.out_tokens.clone() for c in cores]
            if not (torch.equal(trash[0], trash[1])
                    and torch.equal(vtrash[0], vtrash[1])
                    and torch.equal(rows[0], rows[1])):
                mismatches.append({
                    "wave": i,
                    "trash_k_max_abs": float((trash[0] - trash[1]).abs()
                                             .max()),
                    "trash_v_max_abs": float((vtrash[0] - vtrash[1]).abs()
                                             .max()),
                    "rows_differ": int((rows[0] != rows[1]).sum()),
                })
        for core in cores:
            assert core._graphs.replays == core.total_chunks > 0
        assert mismatches == []
    finally:
        for core in cores:
            core.stop()
