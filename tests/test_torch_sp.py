"""Sequence parallelism in the port (item 10d (rest), part 1) vs the JAX
package, on the CPU.

The port's sp group is processes (vgate_tpu_torch/parallel/): at tp =
ep = pp = 1 rank r is sp index r, holding the whole model, its ``S/sp``
rows of each prompt (parallel/ring_attention.py) and its shard of the
KV pool's pages (parallel/sp_decode.py).  The JAX side is the
reference's sp mesh over the conftest's host devices, its Pallas off as
its own tests run it.  Held here, in f32, within tests/
test_ring_attention.py's 2e-5:

* ``_block_attention_update``, ``_partial_paged_attention`` and
  ``_partial_suffix_attention`` against their torch twins, as ``(acc, m,
  l)``, with a slot that owns no page and a padded block; the ring hop's
  plain version (K2-ring's) empties a row that sees no key;
* ``ring_prefill_attention`` at sp 2 and 4 with GQA, a window, a softcap
  and a scale, over spawned gloo ranks (tests/sp_ranks.py), and the pages
  each rank wrote as the blocks passed;
* the three ``*_attention_and_write`` functions over spawned ranks: the
  outputs, and every pool shard but its trash page 0, which stays zeros
  in the port (the reference leaves whichever write landed last there);
* engines greedy token-identical to the JAX engine at the same sp:
  tiny-dense at sp 2 (ring passes, prefix hits and a chunked prompt) and
  sp 4 (the allocator reserves {0, 16, 32, 48} of 64 pages, decode
  crosses shards), tiny-gemma2 at sp 2 (prompts past its window of 8);
* the rank order and each rank's pool: sized against its own budget, a
  deliberate difference from the reference;
* the refusals: the reference's words, and ``NotPortedError`` citing
  its item for speculation and the pod; sp with tp or ep loads.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reference_uploads import private_uploads
from sp_ranks import run_ranks
from test_torch_pp import SPECS, _hf_state_dict, _jtree
from vgate_tpu.backends.base import SamplingParams as JSamplingParams
from vgate_tpu.config import load_config as j_load_config
from vgate_tpu.parallel.mesh import build_mesh as j_build_mesh
from vgate_tpu.parallel.ring_attention import (
    _block_attention_update as j_block_update,
)
from vgate_tpu.parallel.ring_attention import ring_prefill_attention as j_ring
from vgate_tpu.parallel.sp_decode import (
    _partial_paged_attention as j_partial_paged,
)
from vgate_tpu.parallel.sp_decode import (
    _partial_suffix_attention as j_partial_suffix,
)
from vgate_tpu.parallel.sp_decode import reserved_page_ids as j_reserved
from vgate_tpu.runtime.engine_core import EngineCore as JEngineCore
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import NotPortedError, load_config
from vgate_tpu_torch.models.specs import TINY_DENSE
from vgate_tpu_torch.ops import attention
from vgate_tpu_torch.parallel.mesh import Mesh, MeshPlan
from vgate_tpu_torch.runtime.engine_core import EngineCore, kv_layout
from vgate_tpu_torch.runtime.kv_cache import auto_num_pages
from vgate_tpu_torch.runtime.weights import params_from_jax

TOL = 2e-5  # tests/test_ring_attention.py's
NEG = -1e30


def _close(got, want, what=""):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=what)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module", autouse=True)
def reference_shard_map():
    """The reference's sp functions pass ``check_rep`` to
    ``vgate_tpu.parallel._compat.shard_map``, which is ``jax.shard_map``
    on this JAX (0.9) and takes that keyword as ``check_vma`` (a
    reference caveat, ROADMAP queue 3).  They import the name at each
    call, so for this module it takes the keyword by its new name; the
    JAX package is not edited."""
    from vgate_tpu.parallel import _compat

    real = _compat.shard_map

    def shard_map(f, *, check_rep=None, **kwargs):
        if check_rep is not None:
            kwargs.setdefault("check_vma", check_rep)
        return real(f, **kwargs)

    _compat.shard_map = shard_map
    yield
    _compat.shard_map = real


def j_sp_mesh(sp):
    """tests/test_ring_attention.py ``sp_mesh``."""
    return j_build_mesh(j_load_config(
        tpu={"dp": 1, "ep": 1, "sp": sp, "tp": 1, "num_devices": sp}).tpu)


# ------------------------------------------------------ the shard bodies


BLOCK_CASES = ["fresh", "warm", "padded_block", "softcap"]


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_block_attention_update_matches_reference(case):
    """One ring step's online-softmax update from the empty state, from a
    warm state, over a padded block (a batch row with no real key, so
    its rows see nothing: the reference's sentinels taken as they are)
    and with a softcap."""
    rng = np.random.default_rng(BLOCK_CASES.index(case))
    B, Sq, Sk, H, hd = 2, 8, 8, 4, 16
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32) * 0.25
    k, v = (rng.normal(size=(B, Sk, H, hd)).astype(np.float32)
            for _ in range(2))
    q_pos = np.arange(Sq)[:, None] + 4
    mask = np.broadcast_to(np.arange(Sk)[None, :] <= q_pos, (B, Sq, Sk))
    if case == "padded_block":
        mask = mask & (np.arange(Sk)[None, None, :] < np.array([5, 0])[
            :, None, None])
    acc = np.zeros((B, Sq, H, hd), np.float32)
    m = np.full((B, Sq, H), NEG, np.float32)
    l = np.zeros((B, Sq, H), np.float32)
    if case == "warm":
        acc = rng.normal(size=acc.shape).astype(np.float32)
        m = rng.normal(size=m.shape).astype(np.float32)
        l = rng.uniform(1, 3, size=l.shape).astype(np.float32)
    softcap = 20.0 if case == "softcap" else 0.0
    mask = np.ascontiguousarray(mask)
    want = j_block_update(*(jnp.asarray(a) for a in (q, k, v, mask, acc, m,
                                                     l)), softcap=softcap)
    got = attention.block_attention_update(
        *(_t(a) for a in (q, k, v, mask, acc, m, l)), softcap=softcap)
    _close(got, want, case)


def _paged_case(rng, B=3, H=4, KV=2, hd=16, shard=8, ps=4, pages=6):
    k = rng.normal(size=(KV, shard, ps, hd)).astype(np.float32)
    v = rng.normal(size=(KV, shard, ps, hd)).astype(np.float32)
    owned = rng.uniform(size=(B, pages)) < 0.5
    owned[1] = False  # a slot with no page on this shard
    local = np.where(owned, rng.integers(1, shard, size=(B, pages)), 0)
    return k, v, local.astype(np.int32), owned


PARTIAL_KW = [dict(window=0, softcap=0.0, scale=0.25),
              dict(window=5, softcap=20.0, scale=0.3)]


@pytest.mark.parametrize("kw", PARTIAL_KW, ids=["plain", "window_softcap"])
def test_partial_paged_attention_matches_reference(kw):
    """Decode partials over one shard's pages, a slot with no owned page
    (acc 0, m -1e30, l 0) among them."""
    rng = np.random.default_rng(3)
    k, v, local, owned = _paged_case(rng)
    q = rng.normal(size=(3, 4, 16)).astype(np.float32)
    sl = np.array([20, 13, 24], np.int32)
    want = j_partial_paged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(local), jnp.asarray(owned),
                           jnp.asarray(sl), jnp.asarray(kw["window"]),
                           kw["softcap"], kw["scale"])
    got = attention.partial_paged_attention(
        _t(q), _t(k), _t(v), _t(local), _t(owned), _t(sl), **kw)
    _close(got, want)
    assert (got[2][1] == 0).all() and (got[1][1] == NEG).all()
    assert not any(torch.isnan(t).any() for t in got)


@pytest.mark.parametrize("kw", PARTIAL_KW, ids=["plain", "window_softcap"])
def test_partial_suffix_attention_matches_reference(kw):
    """Suffix partials in blocks of 4 pages over 6 context pages (the
    last block padded with pages nobody owns), a row with no owned
    page."""
    rng = np.random.default_rng(4)
    k, v, local, owned = _paged_case(rng)
    q = rng.normal(size=(3, 5, 4, 16)).astype(np.float32)
    pre = np.array([8, 12, 16], np.int32)
    total = pre + np.array([5, 3, 5], np.int32)
    want = j_partial_suffix(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(local), jnp.asarray(owned),
                            jnp.asarray(pre), jnp.asarray(total),
                            jnp.asarray(kw["window"]), kw["softcap"],
                            kw["scale"], block_pages=4)
    got = attention.partial_suffix_attention(
        _t(q), _t(k), _t(v), _t(local), _t(owned), _t(pre), _t(total),
        block_pages=4, **kw)
    _close(got, want)
    assert (got[2][1] == 0).all() and (got[1][1] == NEG).all()


def test_ring_hop_plain_version_empties_rows_that_see_no_key():
    """K2-ring's plain version: the reference's block update from the
    empty state where a row sees a key, and (0, -1e30, 0) where it sees
    none (a padded block; a window past the block), never NaN."""
    rng = np.random.default_rng(5)
    B, n, H, KV, hd = 2, 8, 4, 2, 16
    q = rng.normal(size=(B, n, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, n, KV, hd)).astype(np.float32)
            for _ in range(2))
    key_lens = np.array([8, 0], np.int32)
    q_off = np.array([8, 0], np.int32)
    acc, m, l = attention.prefill_partial_attention(
        _t(q), _t(k), _t(v), _t(key_lens), _t(q_off), window=12,
        scale=0.25)
    q_pos = q_off[:, None] + np.arange(n)
    mask = ((np.arange(n)[None, None, :] <= q_pos[:, :, None])
            & (np.arange(n)[None, None, :] < key_lens[:, None, None])
            & (q_pos[:, :, None] - np.arange(n)[None, None, :] < 12))
    kx, vx = (np.repeat(a, H // KV, axis=2) for a in (k, v))
    want = j_block_update(
        jnp.asarray(q * 0.25), jnp.asarray(kx), jnp.asarray(vx),
        jnp.asarray(mask), jnp.zeros((B, n, H, hd)),
        jnp.full((B, n, H), NEG), jnp.zeros((B, n, H)))
    seen = mask.any(axis=2)
    assert seen[0].all() and not seen[1].any()
    _close((acc[0], m[0], l[0]), (w[0] for w in want))
    assert (acc[1] == 0).all() and (m[1] == NEG).all() and (l[1] == 0).all()


# ------------------------------------------------------------- the ring


RING_CASES = [(2, 8, 0.0, None), (4, 8, 50.0, 16.0 ** -0.5)]


@pytest.mark.parametrize("sp,window,softcap,scale", RING_CASES,
                         ids=["sp2_window", "sp4_window_softcap_scale"])
def test_ring_prefill_attention_matches_reference(sp, window, softcap,
                                                  scale):
    """Each rank's rows of the port's ring (GQA blocks rotated
    unexpanded, later ranks' blocks skipped) equal the reference's ring,
    real rows compared; every page of the prompt lands on its owner, the
    rest of each shard stays zeros."""
    rng = np.random.default_rng(sp)
    B, S, H, KV, hd, ps, P = 2, 32, 8, 2, 16, 4, 32
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, KV, hd)).astype(np.float32)
            for _ in range(2))
    lens = np.array([32, 19], np.int32)
    reserved = set(j_reserved(P, sp))
    free = [p for p in range(1, P) if p not in reserved]
    pt = np.asarray(rng.permutation(free)[:B * S // ps],
                    np.int32).reshape(B, S // ps)
    want = j_ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jnp.asarray(lens), j_sp_mesh(sp),
                  window=jnp.asarray(window, jnp.int32), softcap=softcap,
                  scale=scale)
    case = {"q": q, "k": k, "v": v, "lens": lens, "window": window,
            "softcap": softcap, "scale": scale, "page_tables": pt,
            "pool_shape": (KV, P, ps, hd)}
    ranks = run_ranks(sp, "ring", [case])
    got = np.concatenate([r[0][0] for r in ranks], axis=1)
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n], np.asarray(want)[b, :n],
                                   rtol=TOL, atol=TOL)
    shard = P // sp
    k_pool = np.zeros((KV, P, ps, hd), np.float32)
    v_pool = np.zeros_like(k_pool)
    for b in range(B):
        for s in range(S):
            k_pool[:, pt[b, s // ps], s % ps] = k[b, s]
            v_pool[:, pt[b, s // ps], s % ps] = v[b, s]
    for r, [(_, kr, vr)] in enumerate(ranks):
        np.testing.assert_array_equal(kr, k_pool[:, r * shard:(r + 1) * shard])
        np.testing.assert_array_equal(vr, v_pool[:, r * shard:(r + 1) * shard])


# ------------------------------------------- the write-and-attend bodies


def _and_write_cases(rng, P, sp, kw, mesh=None):
    """(port case, JAX call) for each of the three functions over one
    global pool ``[KV, P, ps, hd]``, page tables spread over every shard
    (a slot whose pages are all on shard 0), inactive and padding writes
    to page 0; the JAX calls over ``mesh`` (default: the sp mesh)."""
    H, KV, hd, ps = 4, 2, 16, 4
    kp = rng.normal(size=(KV, P, ps, hd)).astype(np.float32)
    vp = rng.normal(size=(KV, P, ps, hd)).astype(np.float32)
    shard = P // sp
    reserved = set(j_reserved(P, sp))
    for p in reserved:  # the trash pages start zeros, as an engine's
        kp[:, p] = 0
        vp[:, p] = 0
    # slot 1 of the decode case takes pages 1..5 (all on shard 0)
    free = [p for p in range(6, P) if p not in reserved]
    perm = [int(p) for p in rng.permutation(free)]
    mesh = mesh or j_sp_mesh(sp)
    out = []
    # decode: 3 slots of 5 pages; slot 1 on shard 0 only; slot 2 inactive
    pt = np.asarray(perm[:15], np.int32).reshape(3, 5)
    pt[1] = [1, 2, 3, 4, 5]
    pos = np.array([17, 9, 0], np.int32)
    page_ids = pt[np.arange(3), pos // ps].copy()
    page_ids[2] = 0
    args = [rng.normal(size=(3, H, hd)).astype(np.float32),
            rng.normal(size=(3, KV, hd)).astype(np.float32),
            rng.normal(size=(3, KV, hd)).astype(np.float32),
            page_ids, pos % ps, pt, pos + 1]
    out.append(("decode", args))
    # suffix: 2 slots, 8 rows from a page-aligned prefix, 7 context pages
    ctx = np.asarray(perm[15:29], np.int32).reshape(2, 7)
    pre = np.array([8, 4], np.int32)
    spt = np.stack([ctx[b, pre[b] // ps:pre[b] // ps + 2] for b in range(2)])
    spt[1, 1] = 0  # the suffix's padding page
    args = [rng.normal(size=(2, 8, H, hd)).astype(np.float32),
            rng.normal(size=(2, 8, KV, hd)).astype(np.float32),
            rng.normal(size=(2, 8, KV, hd)).astype(np.float32),
            spt, ctx, pre, pre + np.array([8, 3], np.int32)]
    out.append(("suffix", args))
    # multitok: 3 candidates from unaligned positions
    p0 = np.array([10, 5], np.int32)
    j = np.arange(3)
    cand = np.minimum(p0[:, None] + j, 7 * ps - 1)
    ids = np.take_along_axis(ctx, cand // ps, axis=1)
    ids[1, 2] = 0  # a rejected overshoot writes the trash page
    args = [rng.normal(size=(2, 3, H, hd)).astype(np.float32),
            rng.normal(size=(2, 3, KV, hd)).astype(np.float32),
            rng.normal(size=(2, 3, KV, hd)).astype(np.float32),
            ids.astype(np.int32), (cand % ps).astype(np.int32), ctx, p0,
            p0 + np.array([3, 2], np.int32)]
    out.append(("multitok", args))
    # read at the call, so a test module's patch of one takes effect
    from vgate_tpu.parallel import sp_decode as j_sp

    jfn = {"decode": j_sp.sp_decode_attention_and_write,
           "suffix": j_sp.sp_suffix_attention_and_write,
           "multitok": j_sp.sp_multitok_attention_and_write}
    cases, wants = [], []
    for name, args in out:
        cases.append({"fn": name, "k_pages": kp, "v_pages": vp,
                      "args": args, **kw})
        ja = [jnp.asarray(a) for a in args]
        wants.append(jfn[name](*ja[:3], jnp.asarray(kp), jnp.asarray(vp),
                               *ja[3:], mesh,
                               window=jnp.asarray(kw["window"], jnp.int32),
                               softcap=kw["softcap"], scale=kw["scale"]))
    return cases, wants


@pytest.mark.parametrize("sp,kw", [
    (4, dict(window=6, softcap=30.0, scale=0.3)),
], ids=["sp4_window_softcap_scale"])
def test_and_write_functions_match_reference(sp, kw):
    """``sp_decode_attention_and_write``, ``sp_suffix_attention_and_write``
    and ``sp_multitok_attention_and_write`` over spawned ranks: each
    rank's output equals the reference's, and each pool shard equals the
    reference's shard on every page but its trash page 0, which the port
    keeps zeros."""
    P = 64
    cases, wants = _and_write_cases(np.random.default_rng(sp + 10), P, sp,
                                    kw)
    ranks = run_ranks(sp, "and_write", cases)
    shard = P // sp
    for i, (case, (w_out, w_k, w_v)) in enumerate(zip(cases, wants)):
        for r, results in enumerate(ranks):
            out, kr, vr = results[i]
            np.testing.assert_allclose(out, np.asarray(w_out), rtol=TOL,
                                       atol=TOL, err_msg=case["fn"])
            for got, want in ((kr, w_k), (vr, w_v)):
                want = np.asarray(want)[:, r * shard:(r + 1) * shard]
                np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
                assert not got[:, 0].any(), (case["fn"], r)


# --------------------------------------------------- rank order, pools


@pytest.mark.parametrize("pp,ep,sp,tp", [(1, 1, 2, 1), (1, 1, 4, 1),
                                         (1, 2, 2, 2)],
                         ids=["sp2", "sp4", "ep2xsp2xtp2"])
def test_rank_order_is_the_reference_device_order(pp, ep, sp, tp):
    """Rank r sits at the reference mesh's position of its r-th device
    (axis order dp, pp, ep, sp, tp), its sp index and ring neighbours
    included."""
    n = pp * ep * sp * tp
    jcfg = j_load_config(tpu={"dp": 1, "pp": pp, "ep": ep, "sp": sp,
                              "tp": tp, "num_devices": n}).tpu
    jmesh = j_build_mesh(jcfg, devices=jax.devices()[:n])
    plan = MeshPlan(1, pp, ep, sp, tp)
    for rank in range(n):
        mesh = Mesh(plan, ["cpu"] * n, rank)
        [where] = np.argwhere(jmesh.devices == jax.devices()[rank])
        assert (mesh.pp_rank, mesh.ep_rank, mesh.sp_rank, mesh.tp_rank) == (
            where[1], where[2], where[3], where[4])
        nxt = Mesh(plan, ["cpu"] * n, mesh.sp_peer(mesh.sp_rank + 1))
        assert nxt.sp_rank == (mesh.sp_rank + 1) % sp
        assert (nxt.tp_rank, nxt.ep_rank) == (mesh.tp_rank, mesh.ep_rank)


def _fake_mesh(sp):
    return SimpleNamespace(sp=sp, card_share=1, all_min=lambda v: v)


def test_each_rank_sizes_its_shard_against_its_own_budget():
    """The pool under sp: each rank sizes its shard against its own
    budget and the group holds sp x the smallest shard, where the
    reference sizes the whole pool against one device and shards it (a
    deliberate difference); the reference's cap (one trash page a
    shard) and its rounding to a multiple of sp hold, and
    ``kv_num_pages`` fixes the global count, page ids as the
    reference's."""
    spec = TINY_DENSE
    budget = 3 << 20
    cfg = load_config(model={"model_id": "tiny-dense",
                             "max_model_len": 4096},
                      device={"device": "cpu", "kv_budget_bytes": budget,
                              "kv_page_size": 4, "max_batch_slots": 32})
    one = auto_num_pages(spec, 4, 0.9, torch.device("cpu"), dtype_bytes=4,
                         budget_bytes=budget)
    for sp in (2, 4):
        geo, _ = kv_layout(cfg, spec, torch.device("cpu"), torch.float32,
                           _fake_mesh(sp))
        assert geo.num_pages == sp * one and geo.local_pages == one
        assert geo.num_reserved == sp and geo.shards == sp
    # the reference's cap, rounded up to a multiple of sp
    small = dataclasses.replace(cfg.device, max_batch_slots=1,
                                kv_budget_bytes=budget)
    capped = dataclasses.replace(cfg, device=small)
    geo, _ = kv_layout(capped, spec, torch.device("cpu"), torch.float32,
                       _fake_mesh(4))
    useful = 4096 // 4 + 4
    assert geo.num_pages == useful + (-useful) % 4 and geo.shards == 4
    fixed = dataclasses.replace(cfg, device=dataclasses.replace(
        cfg.device, kv_num_pages=64))
    geo, _ = kv_layout(fixed, spec, torch.device("cpu"), torch.float32,
                       _fake_mesh(4))
    assert (geo.num_pages, geo.local_pages) == (64, 16)


# --------------------------------------------------------------- engines


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{name: (JAX tree, numpy tree, checkpoint dir)} for tiny-dense and
    tiny-gemma2, each from one draw."""
    from safetensors.torch import save_file

    from pp_ranks import np_copy

    out = {}
    for name in ("tiny-dense", "tiny-gemma2"):
        jspec, spec = SPECS[name]
        jtree = _jtree(jspec)
        np_tree = np_copy(jax.tree.map(np.asarray, jtree))
        path = tmp_path_factory.mktemp(name)
        save_file(_hf_state_dict(np_tree, spec),
                  str(path / "model.safetensors"))
        out[name] = (jtree, np_tree, str(path))
    return out


SHAPES = {"kv_num_pages": 64, "kv_page_size": 4, "max_batch_slots": 4,
          "prefill_buckets": [8, 16, 32]}


def _pair(models, name, sp, chunk):
    jtree, np_tree, ckpt = models[name]
    j = JEngineCore(
        j_load_config(
            model={"model_id": name, "engine_type": "jax_tpu",
                   "dtype": "float32", "max_model_len": 96},
            tpu={"dp": 1, "pp": 1, "tp": 1, "ep": 1, "sp": sp,
                 "num_devices": sp, "use_pallas": False,
                 "prefill_chunk": chunk, **SHAPES},
            scheduler={"max_queue_size": 32}, integrity={"enabled": False},
            logging={"level": "ERROR"},
        ),
        params=jtree, devices=jax.devices()[:sp],
    )
    t = EngineCore(
        load_config(
            model={"model_id": name, "engine_type": "torch_cuda",
                   "dtype": "float32", "max_model_len": 96,
                   "checkpoint_path": ckpt},
            device={"device": "cpu", "sp": sp, "prefill_chunk": chunk,
                    **SHAPES},
            scheduler={"max_queue_size": 32},
            recovery={"backoff_base_s": 0.05, "backoff_cap_s": 0.5},
            logging={"level": "ERROR"},
        ),
        params=params_from_jax(np_tree, SPECS[name][1]),
    )
    return j, t


def _ticked(core, prompts, params):
    seqs = [core.submit_tokens(list(p), params) for p in prompts]
    for _ in range(20_000):
        if all(s.done_event.is_set() for s in seqs):
            break
        core._tick()
    assert all(s.done_event.is_set() for s in seqs)
    assert all(s.error is None for s in seqs), [s.error for s in seqs]
    return [list(s.generated_ids) for s in seqs]


ENGINE_CASES = [("tiny-dense", 2, 32), ("tiny-dense", 4, 0),
                ("tiny-gemma2", 2, 0)]


@pytest.mark.parametrize("name,sp,chunk", ENGINE_CASES,
                         ids=["dense-sp2-hits-chunks", "dense-sp4",
                              "gemma2-sp2"])
def test_engine_token_identical_to_jax(models, name, sp, chunk):
    """Greedy waves, the same on both engines at the same sp: cold
    prompts (ring passes), the same prompts again (prefix hits through
    the sp suffix pass) and, with ``chunk``, a prompt past it (chunked
    prefill); 20 tokens cross several 4-token pages, so decode writes
    and reads pages on several shards.  The port's allocator reserves
    the reference's trash pages; copy-on-write is off on both; every
    rank keeps its page 0 zeros and ran every step and pass."""
    jspec, spec = SPECS[name]
    j, t = _pair(models, name, sp, chunk)
    try:
        assert t.allocator.reserved == j.allocator.reserved == frozenset(
            j_reserved(64, sp))
        assert t.radix_cache is not None and not t.radix_cache.cow
        assert t.k_pages.shape[2] == 64 // sp
        rng = np.random.default_rng(21 + sp)
        greedy = dict(max_tokens=20, temperature=0.0)
        cold = [rng.integers(3, spec.vocab_size, size=n).tolist()
                for n in (5, 14, 27)]
        waves = [cold, cold[1:]]
        if chunk:
            waves.append([rng.integers(3, spec.vocab_size,
                                       size=50).tolist()])
        for prompts in waves:
            with private_uploads():
                want = _ticked(j, prompts, JSamplingParams(**greedy))
            got = _ticked(t, prompts, SamplingParams(**greedy))
            assert got == want
        ts = t.get_stats()
        assert ts["prefix_cache"]["hit_tokens"] > 0
        if chunk:
            assert ts["prefix_cache"]["chunk_passes"] > 0
        mesh = dict(ts["mesh"])
        assert mesh.pop("backend") == "gloo"
        assert mesh == j.get_stats()["mesh"]
        assert ts["running"] == 0
        assert not t.k_pages[:, :, 0].any()
        for f in t.follower_stats():
            assert (f["steps"], f["prompt_passes"]) == (
                ts["steps"], ts["prompt_passes"])
            assert f["memory"]["trash_page_zero"]
            assert f["memory"]["pool_pages"] == 64
    finally:
        j.stop()
        t.close()


# -------------------------------------------------------------- refusals


def test_bucket_divisibility_is_the_reference_error():
    """The reference's engine error, word for word, on the scheduler's
    bucket ladder (6 stays 6 at pages of 2; the top bucket 60 divides)."""
    with pytest.raises(ValueError) as err:
        load_config(model={"model_id": "tiny-dense", "max_model_len": 60},
                    device={"device": "cpu", "sp": 4, "kv_page_size": 2,
                            "kv_num_pages": 64, "prefill_buckets": [6]})
    assert str(err.value) == (
        "prefill buckets [6] not divisible by sp=4; ring-attention prefill "
        "shards the sequence axis evenly")


SP_REFUSALS = [
    ({"device": {"sp": 2, "speculative_k": 2}}, NotPortedError,
     r"speculative decoding under a model-parallel mesh .* 10d \(rest\)"),
    ({"device": {"sp": 2}, "pod": {"workers": 2}}, NotPortedError,
     r"pod.workers>0 under a model-parallel mesh .*device.sp"),
    ({"device": {"sp": 2, "dp": 2}}, NotPortedError,
     r"device.dp>1 with .*device.sp .* item 10b \(rest\)"),
    ({"device": {"sp": 2}, "kv_cache": {"dtype": "int8"}}, ValueError,
     r"kv_cache.dtype=int8 requires a plain mesh, got \{'sp': 2\}"),
    ({"device": {"sp": 2}, "kv_cache": {"host_swap_bytes": 1 << 20}},
     ValueError,
     r"kv_cache.host_swap_bytes requires a plain mesh, got \{'sp': 2\}"),
]


@pytest.mark.parametrize(
    "sections,error,match", SP_REFUSALS,
    ids=["speculation", "pod", "dp_x_sp", "int8_kv", "host_swap"])
def test_sp_refusals(sections, error, match):
    """Under sp the reference's own errors keep its words; speculation
    and the pod raise ``NotPortedError`` citing their queue-1 items."""
    model = {"model_id": "tiny-dense", **sections.pop("model", {})}
    with pytest.raises(error, match=match):
        load_config(model=model, **sections)


@pytest.mark.parametrize("model,device", [
    ("tiny-dense", {"sp": 2, "tp": 2}),
    ("tiny-moe", {"sp": 2, "ep": 2}),
], ids=["sp_x_tp", "sp_x_ep"])
def test_sp_composes_with_tp_and_ep(model, device):
    """sp with tp or ep loads (item 10d (rest), part 2), with the prefix
    cache and chunked prefill, whose bucket ladder sp still divides."""
    cfg = load_config(model={"model_id": model},
                      device={**device, "prefill_chunk": 512,
                              "prefix_cache": True})
    assert (cfg.device.sp, cfg.device.tp, cfg.device.ep) == (
        2, device.get("tp", 1), device.get("ep", 1))


def test_sp_loads_and_serves_its_config():
    """``device.sp: 2`` loads (with the prefix cache and chunked prefill:
    the reference serves both under sp)."""
    cfg = load_config(model={"model_id": "tiny-gemma2"},
                      device={"sp": 2, "prefill_chunk": 512,
                              "prefix_cache": True})
    assert cfg.device.sp == 2
