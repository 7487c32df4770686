"""The port's integrity layer (integrity.py, the digest's plain version,
the engine's sentinel and sweep hooks) against the reference's, on the
CPU.

* ``logit_guard`` on crafted ``[B, V]`` rows (NaN, +-Inf, all zero,
  saturated, clean, and -inf written after the guard by min-token
  suppression) gives the reference's flag words.
* The digest's plain version equals the reference's ``leaf_digest`` and
  ``host_leaf_digest`` on the same seeded arrays — fp32, bf16, int8,
  packed uint8, odd lengths, chunk edges — bit for bit; a whole tree's
  digests (dense, int8 and int4 quantized) equal the reference tree's
  key for key; the bit flip and the summary equal the reference's.
* The sentinel scanner's trips, the verifier's budgeted sweep, the hard
  and soft verdicts and the canary helpers, as the reference's.
* On a tiny-dense engine: a ``logit_corrupt`` trip discards its chunk
  (no token of it is appended or streamed), a ``weight_corrupt`` flip is
  found by the idle sweep, the guard words of clean chunks are 0, and the
  canary records then verifies.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vgate_tpu import integrity as ref
from vgate_tpu.config import load_config as j_load_config
from vgate_tpu.models.specs import TINY_DENSE as J_TINY
from vgate_tpu.ops.quant import quantize_decoder_params
from vgate_tpu.runtime.weights import load_or_init_params as j_init
from vgate_tpu_torch import config as config_mod
from vgate_tpu_torch import faults, integrity
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.errors import IntegrityError
from vgate_tpu_torch.models.specs import TINY_DENSE
from vgate_tpu_torch.ops.kernels import leaf_digest as ld
from vgate_tpu_torch.runtime.engine_core import EngineCore
from vgate_tpu_torch.runtime.sequence import Sequence
from vgate_tpu_torch.runtime.weights import params_from_jax


@pytest.fixture(autouse=True)
def _reset_port_state():
    config_mod.reset_config()
    faults.reset()
    yield
    faults.reset()
    config_mod.reset_config()


# ------------------------------------------------------------ logit guard

V = 50
THRESHOLD = 1.0e4


def _rows(case: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, V)).astype(np.float32) * 3
    if case == "nan":
        x[1, 4] = np.nan
    elif case == "inf":
        x[2, 0] = np.inf
        x[3, 9] = -np.inf
    elif case == "zero":
        x[0] = 0.0
        x[5] = -0.0
    elif case == "saturated":
        x[4, 7] = THRESHOLD
        x[1, 3] = -2 * THRESHOLD
    elif case == "mixed":
        x[0] = 0.0
        x[1, 1] = np.nan
        x[2, 2] = 3 * THRESHOLD
        x[3, 3] = -np.inf
        x[4, 4] = np.nan
        x[4, 5] = np.inf
    return x


@pytest.mark.parametrize("case", ["clean", "nan", "inf", "zero",
                                  "saturated", "mixed"])
def test_logit_guard_matches_the_reference(case):
    x = _rows(case)
    got = integrity.logit_guard(torch.from_numpy(x), THRESHOLD)
    want = np.asarray(ref.logit_guard(jnp.asarray(x), THRESHOLD))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).any() == (case != "clean")


def test_guard_runs_on_the_raw_logits_before_suppression():
    """The chunk body writes the guard over the raw logits: the huge
    negative values min-token suppression writes afterwards (-1e30 here,
    -inf in the reference) would trip the guard, and do not reach it."""
    from vgate_tpu_torch.ops.sampling import suppress_stop_tokens

    x = torch.from_numpy(_rows("clean"))
    words = integrity.logit_guard(x, THRESHOLD)
    suppressed = suppress_stop_tokens(
        x, torch.zeros(6, dtype=torch.int32),
        torch.full((6,), 4, dtype=torch.int32),
        torch.tensor([[0, 1]] * 6),
    )
    assert (suppressed.abs() >= THRESHOLD).any()
    assert not words.any()
    assert integrity.logit_guard(suppressed, THRESHOLD).any()
    # the chunk body itself: penalties, bias and min-token floors on
    # every row, and the guard words of its steps are still 0
    core = _engine()
    seq = core.submit_tokens([5, 9, 13], SamplingParams(
        max_tokens=12, min_tokens=12, temperature=0.0,
        frequency_penalty=0.5, logit_bias={3: -100.0}))
    _until(core, lambda: seq.done_event.is_set())
    assert core._dec_state.stop_width and core._dec_state.bias_width
    assert not core._dec_state.out_flags.any()
    assert core.get_stats()["integrity"]["sentinel_trips"] == {}


# ---------------------------------------------------------------- digests

DIGEST_CASES = {
    "fp32": lambda r: r.standard_normal(1001).astype(np.float32),
    "fp32-2d": lambda r: r.standard_normal((7, 129)).astype(np.float32),
    "bf16": lambda r: r.standard_normal(70001).astype(ml_dtypes.bfloat16),
    "bf16-odd": lambda r: r.standard_normal(3).astype(ml_dtypes.bfloat16),
    "int8": lambda r: r.integers(-128, 128, (33, 65), dtype=np.int8),
    "packed-uint8": lambda r: r.integers(0, 256, (17, 31), dtype=np.uint8),
    "scale-f32": lambda r: r.random((5, 65521 * 2 + 3)).astype(np.float32),
    "one": lambda r: np.asarray([1.5], np.float32),
}


def _torch(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


@pytest.mark.parametrize("case", sorted(DIGEST_CASES))
def test_plain_digest_equals_the_reference(case):
    arr = DIGEST_CASES[case](np.random.default_rng(len(case)))
    t = _torch(arr)
    want = ref.host_leaf_digest(arr)
    assert want == ref.leaf_digest(jnp.asarray(arr))
    assert ld.leaf_digest_plain(t) == want
    assert integrity.leaf_digest(t) == want  # a CPU tensor: the plain one
    assert integrity.host_leaf_digest(t) == want
    assert integrity.leaf_digest(arr) == want  # numpy: the host formula


def test_plain_digest_chunking_is_invisible(monkeypatch):
    """The plain version's int64 chunks (bounded temporaries) do not
    change the sum: a chunk size that splits the positional weights'
    period mid-way gives the reference's digest."""
    arr = np.random.default_rng(3).standard_normal(200_003).astype(
        np.float32)
    monkeypatch.setattr(ld, "PLAIN_CHUNK", 65521 + 17)
    assert ld.leaf_digest_plain(_torch(arr)) == ref.host_leaf_digest(arr)


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_tree_digests_equal_the_reference_tree(bits):
    tree = j_init(J_TINY, None, np.float32)
    if bits:
        tree = quantize_decoder_params(tree, J_TINY, bits=bits)
    want = ref.tree_digests(tree)
    port = params_from_jax(jax.tree.map(np.asarray, tree), TINY_DENSE)
    got = integrity.tree_digests(port)
    assert got == want
    assert integrity.digest_summary(got) == ref.digest_summary(want)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16, np.int8,
                                   np.uint8])
def test_bitflip_matches_the_reference(dtype):
    arr = (np.random.default_rng(1).standard_normal(37) * 50).astype(dtype)
    want = np.asarray(ref._bitflip_leaf(jnp.asarray(arr)))
    t = _torch(arr)
    ptr = t.data_ptr()
    integrity._bitflip_leaf(t)
    assert t.data_ptr() == ptr  # in place: captured graphs see it
    got = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16) \
        if dtype == ml_dtypes.bfloat16 else t.numpy()
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


# -------------------------------------------------- scanner and verifier


class _Seq:
    def __init__(self, temperature=0.0, output_ids=()):
        self.params = SamplingParams(max_tokens=64, temperature=temperature)
        self.output_ids = list(output_ids)


@pytest.mark.parametrize("scenario", ["clean", "flags", "range", "entropy",
                                      "greedy-loop"])
def test_sentinel_scanner_matches_the_reference(scenario):
    cfg = load_config().integrity
    j_cfg = j_load_config().integrity
    chunk, B = 4, 3
    sampled = np.tile(np.arange(B, dtype=np.int32), (chunk, 1)) + 5
    flags = np.zeros(B, np.uint8)
    seqs = [_Seq(), _Seq(), _Seq()]
    if scenario == "flags":
        flags[1] = 5
    elif scenario == "range":
        sampled[2, 2] = TINY_DENSE.vocab_size
    elif scenario == "entropy":
        seqs[0] = _Seq(temperature=0.9, output_ids=[5] * 62)
    elif scenario == "greedy-loop":
        seqs[0] = _Seq(temperature=0.0, output_ids=[5] * 62)
    rows = [(s, slot) for slot, s in enumerate(seqs)]
    got = integrity.SentinelScanner(cfg, TINY_DENSE.vocab_size).scan_decode(
        sampled, flags, rows, chunk)
    want = ref.SentinelScanner(j_cfg, J_TINY.vocab_size).scan_decode(
        sampled, flags, rows, chunk)
    assert [(k, id(s)) for k, s in got] == [(k, id(s)) for k, s in want]
    assert bool(got) == (scenario not in ("clean", "greedy-loop"))


def test_hard_trips_raise_and_soft_trips_fail_one_sequence():
    eng = integrity.EngineIntegrity(load_config().integrity,
                                    TINY_DENSE.vocab_size)
    seq = Sequence(prompt_ids=[1, 2, 3], params=SamplingParams(
        max_tokens=64, temperature=0.9))
    seq.output_ids = [5] * 62
    sampled = np.full((4, 1), 5, np.int32)
    [(kind, who, exc)] = eng.scan_decode(sampled, np.zeros(1, np.uint8),
                                         [(seq, 0)], 4)
    assert kind == "entropy_collapse" and who is seq
    assert isinstance(exc, IntegrityError)
    with pytest.raises(IntegrityError) as info:
        eng.scan_decode(sampled,
                        np.asarray([integrity.FLAG_NONFINITE], np.uint8),
                        [(seq, 0)], 4)
    assert info.value.integrity_kind == "logit_nonfinite"
    assert info.value.sequences[0]["fingerprint"] == faults.fingerprint(
        [1, 2, 3])


def test_weight_verifier_sweeps_a_budget_a_tick():
    cfg = load_config(integrity={"sweep_leaves_per_tick": 4,
                                 "sweep_interval_s": 60.0}).integrity
    tree = params_from_jax(
        jax.tree.map(np.asarray, j_init(J_TINY, None, np.float32)),
        TINY_DENSE)
    v = integrity.WeightVerifier(cfg)
    summary = v.record(tree)
    assert summary["leaves"] == len(v.baseline) == 15
    assert v.verify_chunk(tree) is None  # between passes
    v._next_pass_t = 0.0
    for _ in range(3):
        assert v.verify_chunk(tree, now=1.0) is None
    assert v.leaves_verified == 12
    target = v.next_path()
    integrity._bitflip_leaf(dict(integrity.leaves_with_path(tree))[target])
    mismatch = v.verify_chunk(tree, now=1.0)
    assert mismatch["leaf"] == target
    assert mismatch["got"] != mismatch["expected"]
    assert v.verify_all(tree)["leaf"] == target


def test_canary_prompt_and_fingerprint_match_the_reference():
    for vocab, n in ((256, 8), (151936, 8), (2, 3)):
        assert integrity.canary_prompt_ids(vocab, n) == \
            ref.canary_prompt_ids(vocab, n)
    ids = [5, 17, 99, 3]
    assert integrity.canary_fingerprint(ids) == ref.canary_fingerprint(ids)


# ----------------------------------------------------- tiny-dense engine


def _engine(**integrity_cfg):
    cfg = load_config(
        model={"model_id": "tiny-dense", "dtype": "float32",
               "max_model_len": 64},
        device={"device": "cpu", "kv_num_pages": 64, "kv_page_size": 4,
                "max_batch_slots": 4, "prefill_buckets": [8, 16, 32],
                "prefix_cache": False, "decode_chunk": 4},
        integrity=integrity_cfg,
        logging={"level": "ERROR"},
    )
    return EngineCore(cfg)


def _until(core, cond):
    """Drive the engine's tick (no thread) until ``cond()``; the core is
    marked running, as its loop would have it (a fault probe's early
    return reads that flag)."""
    core._running = True
    for _ in range(2000):
        if cond():
            return
        core._tick()
    raise AssertionError("the engine did not get there")


def test_a_tripped_guard_discards_its_chunk():
    """``logit_corrupt`` flips the chunk's guard words at readback: the
    scan raises before any append, so no token of that chunk reaches a
    sequence or its stream; clean chunks before it carried words of 0."""
    core = _engine()
    streamed = []
    seqs = [core.submit_tokens([5, 9, 13, i], SamplingParams(
        max_tokens=20, temperature=0.0), stream_cb=streamed.append)
        for i in (1, 2)]
    _until(core, lambda: all(s.num_generated >= 3 for s in seqs))
    assert core.get_stats()["integrity"]["sentinel_trips"] == {}
    counts = [s.num_generated for s in seqs]
    n_streamed = len(streamed)
    steps = core.total_steps
    faults.arm("logit_corrupt", mode="corrupt", times=1)
    with pytest.raises(IntegrityError) as info:
        _until(core, lambda: False)
    assert info.value.integrity_kind.startswith("logit_")
    assert {s["seq_id"] for s in info.value.sequences} == {
        s.seq_id for s in seqs}
    # the first readback after arming trips: nothing of it was appended,
    # streamed or counted as decode steps
    assert [s.num_generated for s in seqs] == counts
    assert len(streamed) == n_streamed and core.total_steps == steps
    assert core.integrity.sentinels.trips


def test_the_idle_sweep_finds_a_flipped_weight():
    core = _engine(sweep_interval_s=0.0, sweep_leaves_per_tick=64)
    faults.arm("weight_corrupt", mode="corrupt", times=1)
    with pytest.raises(IntegrityError) as info:
        _until(core, lambda: False)
    assert info.value.integrity_kind == "checksum_mismatch"
    stats = core.get_stats()["integrity"]
    assert stats["sweep"]["mismatches"] == 1


def test_integrity_off_writes_no_guard_and_sweeps_nothing():
    core = _engine(enabled=False)
    seq = core.submit_tokens([5, 9], SamplingParams(max_tokens=6,
                                                    temperature=0.0))
    _until(core, lambda: seq.done_event.is_set())
    assert core.integrity is None and "integrity" not in core.get_stats()
    assert not core._dec_state.out_flags.any()


def test_canary_records_then_verifies_and_catches_a_flip():
    core = _engine()
    core.start()
    try:
        keeper = integrity.CanaryKeeper(core.config.integrity)
        first = keeper.check(core, context="boot")
        assert first["ok"] and first["recorded"]
        again = keeper.check(core, context="probe")
        assert again["ok"] and not again["recorded"]
        assert again["fingerprint"] == first["fingerprint"]
        # a flipped high mantissa bit in every embedding row: the
        # greedy output changes, no logit saturates
        embed = dict(integrity.leaves_with_path(core.params))["['embed']"]
        integrity._bitflip_leaf(embed, mask=0x00400000)
        bad = keeper.check(core, context="probe")
        assert not bad["ok"] and bad["expected"] == first["fingerprint"]
        assert keeper.stats()["failures"] == 1
    finally:
        core.stop()
